"""g++ builds of the repository's CPython extension cores (``native/*.cpp``),
the port's own copy of penroz_tpu/utils/native_build.py.

Each core is compiled at first use into ``penroz_tpu_torch/_build/native/``
and rebuilt when its source is newer than the library: plain CPython API
extensions, no setuptools, no pybind11.  The sources are read in place,
as ops/kernels/build.py reads ``csrc/``.  A build or import that fails
makes the core unavailable, and the caller runs its Python version (the
same output, slower); :func:`loaded` says which cores loaded.
"""

from __future__ import annotations

import importlib.util
import logging
import os
import subprocess
import sysconfig
import threading

log = logging.getLogger(__name__)

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE_DIR = os.path.join(os.path.dirname(_PKG), "native")
OUT_DIR = os.path.join(_PKG, "_build", "native")

_lock = threading.Lock()
_modules: dict[str, object] = {}
_failed: set[str] = set()


def build_extension(name: str, out_dir: str = OUT_DIR) -> str:
    """Compile ``native/{name}.cpp`` into ``{out_dir}/{name}{EXT_SUFFIX}``
    unless a library at least as new as the source is there."""
    src = os.path.join(SOURCE_DIR, f"{name}.cpp")
    os.makedirs(out_dir, exist_ok=True)
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    so_path = os.path.join(out_dir, f"{name}{suffix}")
    if (os.path.exists(so_path)
            and os.path.getmtime(so_path) >= os.path.getmtime(src)):
        return so_path
    include = sysconfig.get_paths()["include"]
    # A unique temporary output renamed into place: another process
    # building the same core at once must never load a half-written file.
    tmp_path = f"{so_path}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", f"-I{include}",
           src, "-o", tmp_path]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp_path, so_path)
    finally:
        if os.path.exists(tmp_path):
            os.remove(tmp_path)
    return so_path


def load_extension(name: str):
    """The built and imported core ``name``, or None (logged once) when
    the toolchain or the build fails."""
    with _lock:
        if name in _modules:
            return _modules[name]
        if name in _failed:
            return None
        try:
            so_path = build_extension(name)
            spec = importlib.util.spec_from_file_location(name, so_path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
        except Exception as e:  # noqa: BLE001 — the Python version runs
            log.warning("Native core %s unavailable (%s); using the Python "
                        "version", name, e)
            _failed.add(name)
            return None
        _modules[name] = module
        return module


def loaded() -> dict[str, bool]:
    """Each core this process tried to load, and whether it loaded."""
    with _lock:
        return {**{n: True for n in _modules}, **{n: False for n in _failed}}
