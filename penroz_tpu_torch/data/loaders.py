"""Datasets: download and sharding, and rank-strided shard loading for
training (counterpart of penroz_tpu/data/loaders.py).

``Downloader`` tokenizes a HuggingFace ``datasets`` split with the port's
tokenizer (data/tokenizers.py) into fixed-size uint16 ``.npy`` shards
named ``{dataset_id}_{idx:06d}``, byte for byte the JAX package's shards
of the same source.  ``Loader.list``/``delete`` back ``GET``/``DELETE
/dataset/``, and ``Loader.next_batch`` walks the sorted
``data/{dataset_id}_*.npy`` shards with the JAX package's ``(shard,
idx)`` state: a window of ``buffer_size + target_offset`` tokens starting
at ``idx`` (concatenated across the following shards, wrapping to the
first), then ``idx`` advances by ``idx_offset``.

Where every shard is a 1-D uint16 array, the window is gathered from the
native mmap stream (``native/penroz_loader.cpp``, built by
utils/native_build.py) straight into an int32 buffer, and the next one is
prefetched; ``PENROZ_NATIVE_LOADER=0``, a missing toolchain or another
dtype takes the numpy path, which reads the same windows.
"""

from __future__ import annotations

import glob
import logging
import os

import numpy as np

from penroz_tpu_torch.data.tokenizers import Tokenizer
from penroz_tpu_torch.utils import faults

log = logging.getLogger(__name__)

DATA_FOLDER = "data"
NATIVE_LOADER_ENV = "PENROZ_NATIVE_LOADER"


def _native_loader_module():
    if os.environ.get(NATIVE_LOADER_ENV, "1") == "0":
        return None
    from penroz_tpu_torch.utils import native_build
    return native_build.load_extension("penroz_loader")


def _npy_payload(path: str):
    """(byte offset, token count) of a uint16 1-D .npy payload, or None."""
    m = np.load(path, mmap_mode="r")
    if m.dtype != np.uint16 or m.ndim != 1:
        return None
    return int(m.offset), int(m.shape[0])


class Loader:
    def __init__(self, dataset_id: str, begin_shard: int = 0,
                 begin_idx: int = 0, buffer_size: int = 1024,
                 idx_offset: int | None = None):
        self.dataset_id = dataset_id
        self.shard = begin_shard
        self.idx = begin_idx
        self.buffer_size = int(buffer_size)
        self.idx_offset = int(idx_offset if idx_offset is not None
                              else buffer_size)
        self._cache: dict[int, np.ndarray] = {}
        self._stream = None          # native mmap stream (penroz_loader)
        self._stream_sig: list[tuple] = []   # (name, size, mtime_ns) a shard
        self._prefix: list[int] = []

    def _files(self) -> list[str]:
        pattern = os.path.join(DATA_FOLDER, f"{self.dataset_id}_*.npy")
        return sorted(os.path.basename(p) for p in glob.glob(pattern))

    def list(self) -> list[str]:
        return self._files()

    def delete(self):
        for name in self._files():
            os.remove(os.path.join(DATA_FOLDER, name))
        self._cache.clear()
        # a re-download under the same shard names must not read the
        # deleted files' mapped pages
        self._stream, self._stream_sig, self._prefix = None, [], []

    def _shard_data(self, files: list[str], shard_idx: int) -> np.ndarray:
        shard_idx %= len(files)
        data = self._cache.get(shard_idx)
        if data is None:
            # keep at most two shards resident (current + wraparound peek)
            if len(self._cache) > 1:
                self._cache.clear()
            data = np.load(os.path.join(DATA_FOLDER, files[shard_idx]))
            self._cache[shard_idx] = data
        return data

    def _native_stream(self, files: list[str]):
        """The mmap-backed token stream over ``files``, or None (numpy
        path).  Rebuilt whenever a shard's (name, size, mtime) changes:
        new shards from a concurrent download, or a same-name rewrite
        after a delete and a new download."""
        try:
            sig = [(name, st.st_size, st.st_mtime_ns) for name, st in
                   ((n, os.stat(os.path.join(DATA_FOLDER, n)))
                    for n in files)]
        except OSError:
            return None
        if sig == self._stream_sig:
            return self._stream
        self._stream, self._stream_sig = None, sig
        module = _native_loader_module()
        if module is None:
            return None
        shards, prefix, total = [], [], 0
        try:
            for name in files:
                path = os.path.join(DATA_FOLDER, name)
                payload = _npy_payload(path)
                if payload is None:
                    return None  # not uint16: the numpy path reads it
                prefix.append(total)
                total += payload[1]
                shards.append((path, payload[0], payload[1]))
            self._stream = module.Stream(shards)
            self._prefix = prefix
        except Exception as e:  # noqa: BLE001 — the numpy path reads it
            log.warning("Native loader failed (%s); using the numpy path", e)
            self._stream = None
        return self._stream

    def next_batch(self, target_offset: int = 1):
        """(input, target) flat int32 arrays of ``buffer_size`` tokens;
        target is input shifted by ``target_offset`` (None when 0)."""
        files = self._files()
        if not files:
            raise ValueError(f"Dataset {self.dataset_id} has no shards")
        need = self.buffer_size + target_offset
        stream = self._native_stream(files)
        if stream is not None:
            # (shard, idx) to a position in the stream, then back to the
            # normalized (shard, idx) the numpy path's walk would hold, so
            # that a switch of path or a new shard never moves the window
            pos = (self._prefix[self.shard % len(files)]
                   + self.idx) % stream.total_tokens
            self.shard = max(i for i, p in enumerate(self._prefix)
                             if p <= pos)
            self.idx = pos - self._prefix[self.shard]
            buf = np.empty(need, np.int32)
            stream.gather_into(buf, pos, need)
            x = buf[:self.buffer_size]
            # y is a copy: x and y are independent arrays on both paths
            y = (buf[target_offset:target_offset + self.buffer_size].copy()
                 if target_offset else None)
            self.idx += self.idx_offset
            stream.prefetch(pos + self.idx_offset, need)
            return x, y
        self.shard %= len(files)
        data = self._shard_data(files, self.shard)
        while self.idx >= len(data):
            self.idx -= len(data)
            self.shard = (self.shard + 1) % len(files)
            data = self._shard_data(files, self.shard)
        buf = data[self.idx:self.idx + need]
        peek = self.shard
        while len(buf) < need:
            peek = (peek + 1) % len(files)
            extra = self._shard_data(files, peek)
            buf = np.concatenate([buf, extra[:need - len(buf)]])
        x = buf[:self.buffer_size].astype(np.int32)
        y = (buf[target_offset:target_offset + self.buffer_size]
             .astype(np.int32) if target_offset else None)
        self.idx += self.idx_offset
        return x, y


class Downloader:
    def __init__(self, dataset_id: str, shard_size: int = 2 ** 24,
                 encoding: str = "byte"):
        self.dataset_id = dataset_id
        self.shard_size = int(shard_size)
        self.tokenizer = Tokenizer(encoding)

    def download(self, path: str, name: str | None = None,
                 split: str = "train"):
        """Load the split with ``datasets`` (imported here: the port does
        not depend on it, and without it a download fails with
        ModuleNotFoundError), tokenize each ``text`` row and write
        fixed-size uint16 shards, the final partial one too.  Each shard
        is written under a temporary name and published with
        ``os.replace``, so a reader never sees a half-written shard.  One
        attempt: the API layer retries (serve/app.py).  The rows are
        tokenized one after another; the JAX package's thread pool gains
        nothing for the pure-Python byte tokenizer.  An armed
        ``data.download`` fault (utils/faults.py) fails the attempt before
        it starts."""
        faults.check("data.download")
        import datasets
        ds = datasets.load_dataset(path, name, split=split)
        os.makedirs(DATA_FOLDER, exist_ok=True)
        buffer = np.empty(self.shard_size, np.uint16)
        fill = 0
        shard_idx = 0

        def flush(upto: int):
            nonlocal shard_idx
            final = os.path.join(DATA_FOLDER,
                                 f"{self.dataset_id}_{shard_idx:06d}.npy")
            tmp = final + ".tmp"
            with open(tmp, "wb") as f:  # a file object: no .npy appended
                np.save(f, buffer[:upto])
            os.replace(tmp, final)
            shard_idx += 1

        for text in ds["text"]:
            arr = np.asarray(self.tokenizer.tokenize(text), np.uint16)
            pos = 0
            while pos < len(arr):
                take = min(len(arr) - pos, self.shard_size - fill)
                buffer[fill:fill + take] = arr[pos:pos + take]
                fill += take
                pos += take
                if fill == self.shard_size:
                    flush(fill)
                    fill = 0
        if fill:
            flush(fill)
