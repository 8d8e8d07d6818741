"""Model checkpoint I/O: the port's own copy of the ``PENROZC1`` container
(penroz_tpu/utils/checkpoint.py) with its shm write-through cache.

Container layout (``MAGIC`` = ``b"PENROZC1"``)::

    MAGIC | uint64-LE header_len | header JSON (utf-8) | array payload

The header's ``tree`` is the checkpoint's JSON structure with every array
leaf replaced by ``{"__array__": i}`` and every dict encoded as
``{"__dict__": [[key, value], ...]}`` (preserving int keys); ``arrays[i]``
records dtype/shape/offset/nbytes/crc32 into the 64-byte-aligned payload.
Loading is pure JSON + buffer views, never pickle.

Arrays are written from torch tensors or numpy arrays and read back as CPU
torch tensors.  ``bfloat16`` needs no ``ml_dtypes``: its 16-bit payload is
viewed as ``uint16`` and reinterpreted as ``torch.bfloat16``.  Files are
byte-compatible with the JAX package's in both directions.

Write path: atomically into the shared-memory dir (``PENROZ_SHM_PATH``, else
/dev/shm, else the temp dir), then a background flush to the durable
``models/`` dir relative to the working directory.  A failed write (an
armed ``ckpt.write`` fault of utils/faults.py too) removes its temporary
file and leaves the previous checkpoint in place.
"""

from __future__ import annotations

import json
import logging
import mmap
import os
import platform
import re
import shutil
import struct
import tempfile
import threading
import uuid
import zlib

import numpy as np
import torch

from penroz_tpu_torch.utils import faults

log = logging.getLogger(__name__)

MODELS_FOLDER = "models"
MAGIC = b"PENROZC1"
_ALIGN = 64
_BF16 = "bfloat16"
_TORCH_NAMES = {torch.bfloat16: _BF16, torch.float32: "float32",
                torch.float64: "float64", torch.float16: "float16",
                torch.int64: "int64", torch.int32: "int32",
                torch.int16: "int16", torch.int8: "int8",
                torch.uint8: "uint8", torch.bool: "bool"}


def dtype_name(t: torch.Tensor) -> str:
    """The container's name of a tensor's dtype (numpy's; ``bfloat16``)."""
    name = _TORCH_NAMES.get(t.dtype)
    if name is None:
        raise TypeError(f"cannot checkpoint dtype {t.dtype}")
    return name


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a container dtype name."""
    for dtype, known in _TORCH_NAMES.items():
        if known == name:
            return dtype
    raise TypeError(f"unknown checkpoint dtype {name!r}")


def _array_bytes(a) -> tuple[str, list, bytes]:
    """(dtype name, shape, raw bytes) of a tensor or numpy array."""
    if isinstance(a, torch.Tensor):
        t = a.detach().to("cpu").contiguous()
        name = dtype_name(t)
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return name, list(a.shape), t.numpy().tobytes()
    arr = np.ascontiguousarray(a)
    return str(arr.dtype), list(arr.shape), arr.tobytes()


def _tensor_from(raw, dtype: str, shape) -> torch.Tensor:
    """A CPU tensor copied out of a payload slice."""
    if dtype == _BF16:
        arr = np.frombuffer(raw, dtype=np.int16).reshape(shape).copy()
        return torch.from_numpy(arr).view(torch.bfloat16)
    try:
        np_dtype = np.dtype(dtype)
    except TypeError:
        raise TypeError(f"unknown checkpoint dtype {dtype!r}")
    return torch.from_numpy(np.frombuffer(raw, dtype=np_dtype)
                            .reshape(shape).copy())


def _encode_parts(data):
    """Split a JSON-able tree with array leaves into (header bytes, raw
    array bytes)."""
    blobs: list[bytes] = []
    meta: list[dict] = []

    def enc(x):
        if isinstance(x, (torch.Tensor, np.ndarray)):
            dtype, shape, raw = _array_bytes(x)
            blobs.append(raw)
            meta.append({"dtype": dtype, "shape": shape})
            return {"__array__": len(blobs) - 1}
        if isinstance(x, np.generic):
            return x.item()
        if isinstance(x, dict):
            return {"__dict__": [[k, enc(v)] for k, v in x.items()]}
        if isinstance(x, (list, tuple)):
            return [enc(v) for v in x]
        return x

    tree = enc(data)
    offset = 0
    for m, raw in zip(meta, blobs):
        offset = -(-offset // _ALIGN) * _ALIGN
        m.update(offset=offset, nbytes=len(raw),
                 crc32=zlib.crc32(raw) & 0xFFFFFFFF)
        offset += len(raw)
    header = json.dumps({"tree": tree, "arrays": meta},
                        separators=(",", ":")).encode("utf-8")
    return header, blobs, meta


def _write_stream(f, data):
    header, blobs, meta = _encode_parts(data)
    f.write(MAGIC)
    f.write(struct.pack("<Q", len(header)))
    f.write(header)
    written = 0
    for raw, m in zip(blobs, meta):
        f.write(b"\0" * (m["offset"] - written))
        f.write(raw)
        written = m["offset"] + m["nbytes"]


def _encode(data) -> bytes:
    """Container bytes in memory (tests / small blobs)."""
    import io
    buf = io.BytesIO()
    _write_stream(buf, data)
    return buf.getvalue()


def _decode_tree(tree, array_leaf):
    def dec(x):
        if isinstance(x, dict):
            if "__array__" in x and len(x) == 1:
                return array_leaf(x["__array__"])
            return {k: dec(v) for k, v in x["__dict__"]}
        if isinstance(x, list):
            return [dec(v) for v in x]
        return x
    return dec(tree)


def _wanted_arrays(tree, sections) -> set[int]:
    """Indices of the arrays under the top-level keys ``sections``; a
    ``(key, suffix)`` pair takes only the entries of that key's dict whose
    names end with ``suffix`` (or, for a callable, whose names it
    accepts)."""
    found: set[int] = set()

    def walk(x):
        if isinstance(x, dict):
            if "__array__" in x and len(x) == 1:
                found.add(x["__array__"])
                return
            for _, v in x["__dict__"]:
                walk(v)
        elif isinstance(x, list):
            for v in x:
                walk(v)

    for key, value in tree["__dict__"]:
        if key in sections:
            walk(value)
        for section in sections:
            if isinstance(section, tuple) and section[0] == key \
                    and isinstance(value, dict) and "__dict__" in value:
                accept = (section[1] if callable(section[1])
                          else lambda n, s=section[1]: n.endswith(s))
                for name, leaf in value["__dict__"]:
                    if isinstance(name, str) and accept(name):
                        walk(leaf)
    return found


def _decode(buf, source: str = "<bytes>", sections=None):
    """Decode container bytes back into the tree; truncation and CRC
    mismatches raise ValueError naming the file and the stream.  With
    ``sections`` (top-level keys), only the arrays under those keys are
    read and checked; every other array leaf decodes to None."""
    if buf[:8] != MAGIC:
        raise ValueError("not a penroz checkpoint (bad magic)")
    if len(buf) < 16:
        raise ValueError(f"checkpoint corrupt (truncated header) in "
                         f"{source}")
    (header_len,) = struct.unpack("<Q", buf[8:16])
    if len(buf) < 16 + header_len:
        raise ValueError(f"checkpoint corrupt (truncated header) in "
                         f"{source}")
    header = json.loads(bytes(buf[16:16 + header_len]).decode("utf-8"))
    wanted = (None if sections is None
              else _wanted_arrays(header["tree"], sections))
    payload = memoryview(buf)[16 + header_len:]
    arrays = []
    try:
        for i, m in enumerate(header["arrays"]):
            if wanted is not None and i not in wanted:
                arrays.append(None)
                continue
            end = m["offset"] + m["nbytes"]
            if end > len(payload):
                raise ValueError(
                    f"checkpoint corrupt (truncated payload) in {source}: "
                    f"array stream {i} needs bytes [{m['offset']}, {end}) "
                    f"of {len(payload)}")
            raw = payload[m["offset"]:end]
            expect = m.get("crc32")
            if expect is not None and (zlib.crc32(raw) & 0xFFFFFFFF) != expect:
                raw.release()   # the caller's mmap must close
                raise ValueError(
                    f"checkpoint corrupt (CRC32 mismatch) in {source}: "
                    f"array stream {i} (dtype {m['dtype']}, shape "
                    f"{tuple(m['shape'])})")
            arrays.append(_tensor_from(raw, m["dtype"], m["shape"]))
            raw.release()
    finally:
        payload.release()
    return _decode_tree(header["tree"], arrays.__getitem__)


def _read(path: str, sections=None):
    with open(path, "rb") as f:
        try:
            mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        except ValueError:  # zero-length file
            raise ValueError("not a penroz checkpoint (bad magic)")
        try:
            return _decode(mm, source=path, sections=sections)
        finally:
            mm.close()


def detect_shm_path() -> str:
    """Shared-memory directory (``PENROZ_SHM_PATH`` overrides)."""
    override = os.environ.get("PENROZ_SHM_PATH")
    if override:
        return override
    if (platform.system() == "Linux" and os.path.isdir("/dev/shm")
            and os.access("/dev/shm", os.W_OK)):
        return "/dev/shm"
    return tempfile.gettempdir()


SHM_PATH = detect_shm_path()


def model_path(model_id: str) -> str:
    return os.path.join(MODELS_FOLDER, f"model_{model_id}.ckpt")


def shm_model_path(model_id: str) -> str:
    return os.path.join(SHM_PATH, model_path(model_id))


def source_path(model_id: str) -> str:
    """The file :func:`load` reads: the shm copy, else the durable one."""
    shm_path = shm_model_path(model_id)
    return shm_path if os.path.exists(shm_path) else model_path(model_id)


def _mkstemp_for(path: str):
    """Unique temp sibling of ``path`` (umask-respecting permissions)."""
    directory = os.path.dirname(path) or "."
    base = os.path.basename(path)
    while True:
        tmp_path = os.path.join(directory, f"{base}.{uuid.uuid4().hex[:12]}")
        try:
            fd = os.open(tmp_path, os.O_CREAT | os.O_EXCL | os.O_WRONLY
                         | os.O_CLOEXEC, 0o666)
            return fd, tmp_path
        except FileExistsError:
            continue


def _atomic_write(path: str, data: dict):
    fd, tmp_path = _mkstemp_for(path)
    try:
        with os.fdopen(fd, "wb") as f:
            faults.check("ckpt.write")
            _write_stream(f, data)
        os.replace(tmp_path, path)
    except BaseException:
        if os.path.exists(tmp_path):
            os.remove(tmp_path)
        raise


_FLUSH_THREADS: list = []


def _spawn_flush(shm_path: str, durable_path: str):
    _FLUSH_THREADS[:] = [t for t in _FLUSH_THREADS if t.is_alive()]
    t = threading.Thread(target=_flush, args=(shm_path, durable_path),
                         daemon=True)
    _FLUSH_THREADS.append(t)
    t.start()


def join_flushes(timeout: float = 10.0):
    """Wait for in-flight background flushes (per-thread timeout)."""
    for t in list(_FLUSH_THREADS):
        t.join(timeout)
    _FLUSH_THREADS[:] = [t for t in _FLUSH_THREADS if t.is_alive()]


def _flush(shm_path: str, durable_path: str):
    tmp_path = None
    try:
        fd, tmp_path = _mkstemp_for(durable_path)
        os.close(fd)
        shutil.copyfile(shm_path, tmp_path)
        os.replace(tmp_path, durable_path)
        if not os.path.exists(shm_path):
            # delete() ran mid-flush: don't resurrect the durable copy
            os.remove(durable_path)
    except FileNotFoundError:
        log.warning("Flush skipped, source vanished: %s", shm_path)
    finally:
        if tmp_path is not None and os.path.exists(tmp_path):
            os.remove(tmp_path)


def save(model_id: str, data: dict, sync_flush: bool = False):
    """Write the checkpoint to shm and flush it to ``models/`` (in the
    background unless ``sync_flush``)."""
    os.makedirs(MODELS_FOLDER, exist_ok=True)
    os.makedirs(os.path.join(SHM_PATH, MODELS_FOLDER), exist_ok=True)
    shm_path = shm_model_path(model_id)
    _atomic_write(shm_path, data)
    if sync_flush:
        _flush(shm_path, model_path(model_id))
    else:
        _spawn_flush(shm_path, model_path(model_id))


def load(model_id: str, arrays=None) -> dict:
    """Read a checkpoint, repopulating the shm cache on a miss.

    ``arrays``: top-level keys (e.g. ``("params", "buffers")``) whose arrays
    are read, or ``(key, suffix)`` pairs for the entries of that key's dict
    whose names end with ``suffix`` (``/stats/`` reads the MoE
    ``router_fraction`` buffers so); the others come back as None leaves
    without being read.  An empty tuple reads the metadata alone
    (``/progress/``).  None reads all.

    :raises KeyError: if the model was never created (→ HTTP 404).
    """
    shm_path = shm_model_path(model_id)
    try:
        if not os.path.exists(shm_path):
            os.makedirs(os.path.join(SHM_PATH, MODELS_FOLDER), exist_ok=True)
            shutil.copyfile(model_path(model_id), shm_path)
        return _read(shm_path, sections=arrays)
    except FileNotFoundError:
        raise KeyError(f"Model {model_id} not created yet.")


def list_model_ids() -> list[str]:
    """Model ids with a main checkpoint (durable or shm copy), sorted; a
    shard file's ``.shard<i>`` suffix is not an id."""
    ids = set()
    for base in (MODELS_FOLDER, os.path.join(SHM_PATH, MODELS_FOLDER)):
        try:
            names = os.listdir(base)
        except FileNotFoundError:
            continue
        for name in names:
            m = re.match(r"model_(.+?)\.ckpt$", name)
            if m and not re.search(r"\.shard\d+$", m.group(1)):
                ids.add(m.group(1))
    return sorted(ids)


def _read_header(f):
    """The container's header dict and the payload's offset in the file."""
    prefix = f.read(16)
    if prefix[:8] != MAGIC or len(prefix) < 16:
        raise ValueError("not a penroz checkpoint (bad magic)")
    (header_len,) = struct.unpack("<Q", prefix[8:16])
    return json.loads(f.read(header_len).decode("utf-8")), 16 + header_len


def peek_tree(model_id: str) -> dict:
    """A checkpoint's metadata tree with every array leaf None, read from
    the header alone.  :raises KeyError: the model was never created."""
    try:
        with open(source_path(model_id), "rb") as f:
            header, _ = _read_header(f)
    except FileNotFoundError:
        raise KeyError(f"Model {model_id} not created yet.")
    return _decode_tree(header["tree"], lambda i: None)


def patch_meta(model_id: str, updates: dict):
    """Rewrite top-level metadata fields (status, progress, ...) of both
    copies, shm and durable, synchronously: a new header is written and the
    array payload streamed through verbatim (its offsets are relative to
    the payload, so a header of another length does not move them).
    ``updates`` must hold no arrays.  :raises KeyError: the model was never
    created."""
    try:
        f = open(source_path(model_id), "rb")
    except FileNotFoundError:
        raise KeyError(f"Model {model_id} not created yet.")
    with f:
        header, payload_off = _read_header(f)
        pairs = dict(header["tree"]["__dict__"])
        for key, value in updates.items():
            enc_header, arrays, _ = _encode_parts(value)
            if arrays:
                raise ValueError("patch_meta values must be array-free")
            pairs[key] = json.loads(enc_header)["tree"]
        header["tree"]["__dict__"] = [[k, v] for k, v in pairs.items()]
        new_header = json.dumps(header, separators=(",", ":")
                                ).encode("utf-8")
        for dest in (shm_model_path(model_id), model_path(model_id)):
            os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)
            fd, tmp_path = _mkstemp_for(dest)
            try:
                with os.fdopen(fd, "wb") as out:
                    out.write(MAGIC)
                    out.write(struct.pack("<Q", len(new_header)))
                    out.write(new_header)
                    f.seek(payload_off)
                    shutil.copyfileobj(f, out)
                os.replace(tmp_path, dest)
            except BaseException:
                if os.path.exists(tmp_path):
                    os.remove(tmp_path)
                raise


def _remove_quietly(path: str) -> bool:
    try:
        os.remove(path)
        return True
    except FileNotFoundError:
        return False


def delete(model_id: str):
    """Remove the shm copy and the durable checkpoint, each independently,
    and every rank's shard files."""
    _remove_quietly(shm_model_path(model_id))
    _remove_quietly(model_path(model_id))
    for idx in _shard_indices(model_id):
        _remove_shard_files(model_id, idx)


# ---------------------------------------------------------------------------
# Per-rank shard files (JAX ``shard_file_path`` ... ``load_shards``)
# ---------------------------------------------------------------------------
#
# A checkpoint whose arrays are sharded over ranks (``PENROZ_WUS``'s
# optimizer moments, ``PENROZ_FSDP``'s parameters too) keeps its metadata
# and every replicated array in the main blob, and each rank's pieces in
# ``model_<id>.shard<rank>.ckpt``: ``{"tag": step, "pieces": {name:
# [(((start, stop), ...), array), ...]}}``, ``(None, None)`` on a dim that
# is not cut.  The JAX package reads and writes the same files.

def shard_file_path(model_id: str, process_index: int) -> str:
    return os.path.join(MODELS_FOLDER,
                        f"model_{model_id}.shard{process_index}.ckpt")


def _shard_indices(model_id: str) -> list[int]:
    """Ranks with a shard file (shm or durable), found by glob, so stale
    non-contiguous leftovers are found too."""
    import glob
    pattern = f"model_{glob.escape(model_id)}.shard*.ckpt"
    indices = set()
    for base in (os.path.join(SHM_PATH, MODELS_FOLDER), MODELS_FOLDER):
        for path in glob.glob(os.path.join(base, pattern)):
            m = re.search(r"\.shard(\d+)\.ckpt$", path)
            if m:
                indices.add(int(m.group(1)))
    return sorted(indices)


def save_shard(model_id: str, process_index: int, data: dict,
               sync_flush: bool = False, world: int | None = None):
    """Write one rank's pieces with the main blob's shm write-through and
    flush.  Rank 0 also removes the shard files of ranks >= ``world``:
    leftovers of an earlier run over more ranks would otherwise be
    reassembled over fresh weights."""
    os.makedirs(MODELS_FOLDER, exist_ok=True)
    os.makedirs(os.path.join(SHM_PATH, MODELS_FOLDER), exist_ok=True)
    rel = shard_file_path(model_id, process_index)
    shm_path = os.path.join(SHM_PATH, rel)
    _atomic_write(shm_path, data)
    if sync_flush:
        _flush(shm_path, rel)
    else:
        _spawn_flush(shm_path, rel)
    if process_index == 0 and world is not None:
        for idx in _shard_indices(model_id):
            if idx >= world:
                _remove_shard_files(model_id, idx)


def _remove_shard_files(model_id: str, idx: int):
    rel = shard_file_path(model_id, idx)
    for path in (os.path.join(SHM_PATH, rel), rel):
        _remove_quietly(path)


def load_shards(model_id: str, pieces=None) -> list[dict]:
    """Every shard file of ``model_id`` (the shm copy, else the durable
    one) in rank order; [] when there is none.  ``pieces``, a predicate on
    a piece's name, reads only those pieces' arrays (the others decode to
    None leaves)."""
    sections = None if pieces is None else (("pieces", pieces),)
    shards = []
    for idx in _shard_indices(model_id):
        rel = shard_file_path(model_id, idx)
        shm_path = os.path.join(SHM_PATH, rel)
        path = shm_path if os.path.exists(shm_path) else rel
        shards.append(_read(path, sections=sections))
    return shards


# ---------------------------------------------------------------------------
# LoRA adapter checkpoints (models/lora.py, serve/adapters.py)
# ---------------------------------------------------------------------------
#
# The same container under the JAX package's ``adapter_<id>.ckpt`` name, so
# an adapter written by either package loads in the other; the family never
# matches a ``model_*`` name.

def adapter_path(adapter_id: str) -> str:
    return os.path.join(MODELS_FOLDER, f"adapter_{adapter_id}.ckpt")


def shm_adapter_path(adapter_id: str) -> str:
    return os.path.join(SHM_PATH, adapter_path(adapter_id))


def list_adapter_ids() -> list[str]:
    """Adapter ids with a checkpoint (durable or shm copy), sorted."""
    ids = set()
    for base in (MODELS_FOLDER, os.path.join(SHM_PATH, MODELS_FOLDER)):
        try:
            names = os.listdir(base)
        except FileNotFoundError:
            continue
        for name in names:
            if name.startswith("adapter_") and name.endswith(".ckpt"):
                ids.add(name[len("adapter_"):-len(".ckpt")])
    return sorted(ids)


def save_adapter(adapter_id: str, data: dict, sync_flush: bool = False):
    """Write one adapter checkpoint to shm and flush it to ``models/`` (in
    the background unless ``sync_flush``)."""
    os.makedirs(MODELS_FOLDER, exist_ok=True)
    os.makedirs(os.path.join(SHM_PATH, MODELS_FOLDER), exist_ok=True)
    shm_path = shm_adapter_path(adapter_id)
    _atomic_write(shm_path, data)
    if sync_flush:
        _flush(shm_path, adapter_path(adapter_id))
    else:
        _spawn_flush(shm_path, adapter_path(adapter_id))


def load_adapter(adapter_id: str) -> dict:
    """Read an adapter checkpoint (CRC-verified), repopulating the shm copy
    on a miss.  :raises KeyError: the adapter was never created."""
    shm_path = shm_adapter_path(adapter_id)
    try:
        if not os.path.exists(shm_path):
            os.makedirs(os.path.join(SHM_PATH, MODELS_FOLDER), exist_ok=True)
            shutil.copyfile(adapter_path(adapter_id), shm_path)
        return _read(shm_path)
    except FileNotFoundError:
        raise KeyError(f"Adapter {adapter_id} not created yet.")


def peek_adapter_tree(adapter_id: str) -> dict:
    """An adapter checkpoint's metadata (status, config, model id) with
    every array leaf None, read from the header alone.  :raises KeyError:
    unknown adapter."""
    path = shm_adapter_path(adapter_id)
    if not os.path.exists(path):
        path = adapter_path(adapter_id)
    try:
        return _read(path, sections=())
    except FileNotFoundError:
        raise KeyError(f"Adapter {adapter_id} not created yet.")


def delete_adapter(adapter_id: str):
    """Remove both adapter copies (shm and durable), each independently."""
    _remove_quietly(shm_adapter_path(adapter_id))
    _remove_quietly(adapter_path(adapter_id))


# ---------------------------------------------------------------------------
# KV page blobs (disaggregated prefill's host transport,
# serve/decode_scheduler.py)
# ---------------------------------------------------------------------------
#
# The same container (a CRC32 per array stream) under the JAX package's
# ``pageblob_<id>.ckpt`` name, so a blob staged by either package loads in
# the other.  Shm only: a blob lives for one hand-off, so there is no
# durable flush; the family never matches a ``model_*`` or ``adapter_*``
# name.

def page_blob_path(blob_id: str) -> str:
    return os.path.join(SHM_PATH, MODELS_FOLDER, f"pageblob_{blob_id}.ckpt")


def save_page_blob(blob_id: str, data: dict):
    """Stage one hand-off blob in shm (atomic write, a CRC per stream).
    Page planes may live on the card: they are copied to the host here."""
    os.makedirs(os.path.join(SHM_PATH, MODELS_FOLDER), exist_ok=True)
    _atomic_write(page_blob_path(blob_id), data)


def load_page_blob(blob_id: str) -> dict:
    """Read a staged hand-off blob (CRC-verified; planes as CPU tensors).
    :raises KeyError: the blob was never staged or is already consumed."""
    try:
        return _read(page_blob_path(blob_id))
    except FileNotFoundError:
        raise KeyError(f"Page blob {blob_id} not staged.")


def delete_page_blob(blob_id: str) -> bool:
    """Reclaim a consumed (or abandoned) hand-off blob."""
    return _remove_quietly(page_blob_path(blob_id))


def page_blob_nbytes(blob: dict) -> int:
    """Payload bytes of a hand-off blob: its K/V page planes and int8 scale
    planes, summed over layers, for host and device planes alike (the
    ``penroz_disagg_handoff_bytes`` histogram observes both transports
    through here), and the constant-size recurrent state of a hybrid or
    pure-SSM row, one plane an ``ssm`` layer."""
    total = 0
    for key in ("k", "v", "k_scale", "v_scale"):
        for plane in blob.get(key, ()):
            total += int(plane.nbytes)
    ssm = blob.get("ssm")
    if ssm is not None:
        for plane in ssm.get("state", ()):
            total += int(plane.nbytes)
    return total


# ---------------------------------------------------------------------------
# Tier blobs (the disk tier of session hibernation, serve/tierstore.py)
# ---------------------------------------------------------------------------
#
# The same container under the JAX package's ``tierblob_<id>.ckpt`` name, so
# a blob written by either package loads in the other.  A tier blob is a
# hibernated session's KV, meant to outlive engine resets and restarts, so
# the family lives in a directory of its own (``PENROZ_TIER_DISK_PATH``,
# default ``tier/`` under the shm models dir) that no other glob touches.

TIER_DISK_ENV = "PENROZ_TIER_DISK_PATH"
_TIER_RE = re.compile(r"tierblob_(.+?)\.ckpt$")
_TIER_TEMP_RE = re.compile(r"\.ckpt\.[0-9a-f]{12}$")


def tier_dir() -> str:
    override = os.environ.get(TIER_DISK_ENV)
    if override:
        return override
    return os.path.join(SHM_PATH, MODELS_FOLDER, "tier")


def tier_blob_path(blob_id: str) -> str:
    return os.path.join(tier_dir(), f"tierblob_{blob_id}.ckpt")


def save_tier_blob(blob_id: str, data: dict):
    """Persist one hibernated session's blob (atomic write, a CRC per
    stream)."""
    os.makedirs(tier_dir(), exist_ok=True)
    _atomic_write(tier_blob_path(blob_id), data)


def load_tier_blob(blob_id: str) -> dict:
    """Read a hibernated session's blob.  :raises KeyError: never saved or
    already reclaimed; :raises ValueError: a CRC or container corruption
    (the tier store counts it and recomputes)."""
    try:
        return _read(tier_blob_path(blob_id))
    except FileNotFoundError:
        raise KeyError(f"Tier blob {blob_id} not saved.")


def delete_tier_blob(blob_id: str) -> bool:
    return _remove_quietly(tier_blob_path(blob_id))


def tier_blob_nbytes(blob_id: str) -> int:
    """On-disk size of a stored tier blob (0 when missing): the disk tier's
    accounting reads the container's size, as ``du`` would."""
    try:
        return os.path.getsize(tier_blob_path(blob_id))
    except OSError:
        return 0


def list_tier_blob_ids() -> list[str]:
    """Session ids with a finished tier blob on disk, sorted (a torn
    write's temporary sibling does not match)."""
    try:
        names = os.listdir(tier_dir())
    except FileNotFoundError:
        return []
    return sorted(m.group(1) for m in map(_TIER_RE.fullmatch, names) if m)


def validate_tier_blob(blob_id: str) -> bool:
    """Header check (magic and a parseable header) for the restart scan;
    the per-stream CRCs are checked when the blob is loaded."""
    try:
        _read(tier_blob_path(blob_id), sections=())
        return True
    except (OSError, ValueError, KeyError, struct.error):
        return False


def sweep_tier_orphans(referenced_ids) -> dict:
    """The restart sweep of the tier dir: remove the temporary siblings a
    crash left mid-write (``tierblob_*.ckpt.<12 hex>``) and the finished
    blobs no recovered or live session references.  ``referenced_ids=None``
    means the reference set is unknown (the journal's replay failed): the
    temporaries still go, no finished blob does.  Returns the counts."""
    d = tier_dir()
    try:
        names = os.listdir(d)
    except FileNotFoundError:
        return {"temp_files_swept": 0, "blobs_swept": 0}
    referenced = None if referenced_ids is None else set(referenced_ids)
    temps = blobs = 0
    for name in names:
        path = os.path.join(d, name)
        if not name.startswith("tierblob_"):
            continue
        if _TIER_TEMP_RE.search(name):
            temps += _remove_quietly(path)
            continue
        m = _TIER_RE.fullmatch(name)
        if m and referenced is not None and m.group(1) not in referenced:
            blobs += _remove_quietly(path)
    if temps or blobs:
        log.info("tier sweep: removed %d orphan temporary file(s) and %d "
                 "unreferenced blob(s) from %s", temps, blobs, d)
    return {"temp_files_swept": temps, "blobs_swept": blobs}
