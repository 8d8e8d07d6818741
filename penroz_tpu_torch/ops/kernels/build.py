"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface.  At first use it is
compiled with nvcc for ``sm_90a`` into a shared library under the package's
``_build/`` directory (listed in .gitignore) and loaded with ctypes.  The
library name carries a hash of the source, the local headers it includes
(``#include "<name>.cuh"`` from ``csrc/``) and the flags, so an edited
source or header never loads a stale build.  Nothing here runs at import
time: the CPU tests import every module on a host without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading

import torch

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(PACKAGE_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# dtype codes of the kernels' C interfaces
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_LOCAL_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.M)
_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
# ptxas report (registers, shared memory, spills) of each build, by name
BUILD_LOGS: dict[str, str] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card (CUDA toolkit on PATH or "
                       "under /usr/local/cuda)")


def _source_bytes(path: str, seen: set) -> bytes:
    """``path`` followed by the local headers it includes, depth first,
    each once."""
    with open(path, "rb") as f:
        text = f.read()
    seen.add(path)
    for inc in _LOCAL_INCLUDE.findall(text):
        header = os.path.join(os.path.dirname(path), inc.decode())
        if header not in seen:
            text += _source_bytes(header, seen)
    return text


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` if needed; return the library path."""
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    digest = hashlib.sha256(_source_bytes(src, set()) +
                            " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
    BUILD_LOGS[name] = proc.stderr
    os.replace(tmp, lib)
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built at first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = _LIBS[name] = ctypes.CDLL(build(name))
            lib.penroz_cuda_error_string.argtypes = [ctypes.c_int]
            lib.penroz_cuda_error_string.restype = ctypes.c_char_p
        return lib


def check(lib: ctypes.CDLL, err: int, what: str):
    """Raise if a launcher returned a CUDA error."""
    if err != 0:
        msg = lib.penroz_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")


def function(lib: ctypes.CDLL, name: str, argtypes: list):
    """``lib.<name>`` with its argument types declared (pointers and the
    stream as ``c_void_p``) and an int (cudaError_t) result."""
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


class RunCounter:
    """A device counter, one a device, that a kernel adds one to each time
    a launch of it runs (csrc/decode_core.cuh ``count_run``): a replay of
    a captured launch too, which the wrapper's ``launches`` (what it
    launched) does not see."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: dict = {}

    def pointer(self, device) -> int:
        """The counter's address on ``device``, made (zero) at first use,
        which must not be under a graph capture.  It is made outside
        inference mode even when the first launch runs in it, so that
        :meth:`reset` may zero it anywhere."""
        with self._lock:
            t = self._counts.get(device)
            if t is None:
                if torch.cuda.is_current_stream_capturing():
                    raise RuntimeError("a run counter's first use is under "
                                       "a graph capture")
                with torch.inference_mode(False):
                    t = self._counts[device] = torch.zeros(
                        (), dtype=torch.int64, device=device)
        return t.data_ptr()

    def read(self) -> int:
        """Runs counted on every device so far (after a synchronize)."""
        with self._lock:
            for device in self._counts:
                torch.cuda.synchronize(device)
            return sum(int(t) for t in self._counts.values())

    def reset(self):
        with self._lock:
            for t in self._counts.values():
                t.zero_()


def stream(t) -> int:
    """PyTorch's current CUDA stream on ``t``'s device, as a pointer."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_operand(kernel: str, name: str, t, device, dtype, shape):
    """Raise ValueError unless ``t`` is a contiguous, 16-byte aligned
    ``dtype`` tensor of ``shape`` on ``device``."""
    if t.device != device:
        raise ValueError(f"{kernel}: {name} is on {t.device}, not {device}")
    if t.dtype != dtype:
        raise ValueError(f"{kernel}: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {name} shape {tuple(t.shape)} != "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{kernel}: {name} must be 16-byte aligned")
