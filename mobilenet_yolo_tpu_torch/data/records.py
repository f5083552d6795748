"""Record-shard store: the LMDB replacement (port of
``mobilenet_yolo_tpu/data/records.py``).

Same role as ``ImageFolderLMDB``'s storage layer (reference
folder2lmdb.py:56-110, 319-353) — random access to per-sample blobs — but
as a flat mmap'd (offset, length) index over a payload file, read through
the C++ store (``csrc/recordstore.cc``, the port's copy of
``runtime/recordstore.cc``) with a pure-Python reader of the identical
on-disk format beside it (``force_python=True``).

The C++ store is compiled with ``g++`` at first use into
``build/recordstore/`` at the repository root, under a name that carries
a hash of the source and flags (as ``kernels/_build.py`` builds the CUDA
kernels), and loaded with ``ctypes``. If it cannot be built or loaded,
readers and writers use the Python route instead; :func:`route` says
which one loaded (and why the native one did not).

Record payload schema (little-endian, explicit rather than pickled):

    u32 magic 0x59524544, u32 n_labels,
    u64 img_len, u64 seg_len,
    f32 labels[n_labels, 6]   (label, cx, cy, w, h, difficult) normalized,
    u8  img_bytes[img_len]    (encoded JPEG),
    u8  seg_bytes[seg_len]    (encoded PNG, optional)

The per-box ``difficult`` flag carries the VOC annotation attribute so the
11-point AP's difficult-skip protocol (reference eval_mAP.py:8-67) works
against real shards. v1 shards (magic 0x59524543, 5-col rows) still read —
they decode with difficult=0 everywhere.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import json
import os
import struct
import subprocess
import tempfile
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np

_MAGIC_V1 = 0x59524543   # 5-col rows (label, cx, cy, w, h)
_MAGIC = 0x59524544      # 6-col rows (+ difficult)
_HEADER = struct.Struct("<IIQQ")

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE = PACKAGE_DIR / "csrc" / "recordstore.cc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "recordstore"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")


def library_path() -> Path:
    """Where the store for the current source lives (built or not)."""
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode() + SOURCE.read_bytes())
    return BUILD_DIR / f"librecordstore_{digest.hexdigest()[:16]}.so"


def _build() -> Path:
    """Compile ``csrc/recordstore.cc`` unless the library for this source
    exists; a private directory and a rename keep a concurrent build from
    loading a half-written library."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        lib = Path(tmp) / out.name
        subprocess.run(["g++", *GXX_FLAGS, "-o", str(lib), str(SOURCE)],
                       check=True, capture_output=True, text=True)
        os.replace(lib, out)
    return out


@functools.cache
def _native() -> tuple[Optional[ctypes.CDLL], str]:
    """Build (once) and load the C++ store: ``(library, "native")``, or
    ``(None, "python (<why>)")`` when it cannot be built or loaded."""
    try:
        lib = ctypes.CDLL(str(_build()))
    except subprocess.CalledProcessError as exc:
        return None, f"python (g++ failed: {exc.stderr.strip()[:200]})"
    except OSError as exc:  # no g++, or the library does not load
        return None, f"python ({exc})"
    lib.rs_open.restype = ctypes.c_void_p
    lib.rs_open.argtypes = [ctypes.c_char_p]
    lib.rs_len.restype = ctypes.c_uint64
    lib.rs_len.argtypes = [ctypes.c_void_p]
    lib.rs_get.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.rs_get.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                           ctypes.POINTER(ctypes.c_uint64)]
    lib.rs_close.argtypes = [ctypes.c_void_p]
    lib.rsw_create.restype = ctypes.c_void_p
    lib.rsw_create.argtypes = [ctypes.c_char_p]
    lib.rsw_append.restype = ctypes.c_int
    lib.rsw_append.argtypes = [ctypes.c_void_p,
                               ctypes.POINTER(ctypes.c_uint8),
                               ctypes.c_uint64]
    lib.rsw_finish.restype = ctypes.c_int
    lib.rsw_finish.argtypes = [ctypes.c_void_p]
    return lib, "native"


def _load_native() -> Optional[ctypes.CDLL]:
    """The C++ store, or None if it is unavailable."""
    return _native()[0]


def native_loaded() -> bool:
    """Whether readers and writers of this process use the C++ store."""
    return _load_native() is not None


def route() -> str:
    """``"native"``, or ``"python (<why the C++ store did not load>)"``."""
    return _native()[1]


class Record(NamedTuple):
    image_bytes: bytes
    labels: np.ndarray            # (N, 6) f32 (label, cx, cy, w, h, difficult)
    seg_bytes: Optional[bytes]    # encoded PNG or None


def encode_record(image_bytes: bytes, labels: np.ndarray,
                  seg_bytes: Optional[bytes] = None) -> bytes:
    """labels: (N, 5) or (N, 6) rows; 5-col input gets difficult=0."""
    labels = np.ascontiguousarray(labels, dtype=np.float32)
    if labels.size == 0:
        labels = labels.reshape(0, 6)
    elif labels.shape[-1] == 5:
        labels = np.concatenate(
            [labels.reshape(-1, 5),
             np.zeros((labels.reshape(-1, 5).shape[0], 1), np.float32)], -1)
    else:
        labels = labels.reshape(-1, 6)
    seg = seg_bytes or b""
    header = _HEADER.pack(_MAGIC, labels.shape[0], len(image_bytes), len(seg))
    return header + labels.tobytes() + image_bytes + seg


def decode_record(buf: bytes) -> Record:
    magic, n_labels, img_len, seg_len = _HEADER.unpack_from(buf, 0)
    if magic == _MAGIC:
        cols = 6
    elif magic == _MAGIC_V1:
        cols = 5
    else:
        raise ValueError("bad record magic")
    off = _HEADER.size
    labels = np.frombuffer(buf, np.float32,
                           n_labels * cols, off).reshape(-1, cols)
    if cols == 5:  # v1 shard: difficult flag was never stored
        labels = np.concatenate(
            [labels, np.zeros((labels.shape[0], 1), np.float32)], -1)
    off += n_labels * cols * 4
    img = bytes(buf[off:off + img_len])
    off += img_len
    seg = bytes(buf[off:off + seg_len]) if seg_len else None
    return Record(img, labels.copy(), seg)


class RecordWriter:
    """Appends encoded records into a shard directory."""

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self._count = 0
        self._closed = False
        self._lib = _load_native()
        if self._lib is not None:
            self._w = self._lib.rsw_create(directory.encode())
            if not self._w:
                raise OSError(f"cannot create record shard at {directory}")
        else:
            self._data = open(os.path.join(directory, "data.bin"), "wb")
            self._index = open(os.path.join(directory, "index.bin"), "wb")
            self._offset = 0

    def append(self, payload: bytes):
        if self._lib is not None:
            buf = (ctypes.c_uint8 * len(payload)).from_buffer_copy(payload)
            rc = self._lib.rsw_append(self._w, buf, len(payload))
            if rc != 0:
                raise OSError("record append failed")
        else:
            self._data.write(payload)
            self._index.write(struct.pack("<QQ", self._offset, len(payload)))
            self._offset += len(payload)
        self._count += 1

    def append_record(self, image_bytes: bytes, labels: np.ndarray,
                      seg_bytes: Optional[bytes] = None):
        self.append(encode_record(image_bytes, labels, seg_bytes))

    def close(self, meta: Optional[dict] = None):
        """Finish the shard and write its ``meta.json`` (``meta`` merged in).
        Only the first call writes: the ``with`` block's own ``close`` after
        a builder's ``close(meta)`` keeps the builder's keys."""
        if self._closed:
            return
        self._closed = True
        if self._lib is not None:
            self._lib.rsw_finish(self._w)
            self._w = None
        else:
            self._data.close()
            self._index.close()
        m = {"num_records": self._count, "format": "recordstore-v1"}
        if meta:
            m.update(meta)
        with open(os.path.join(self.directory, "meta.json"), "w") as f:
            json.dump(m, f)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class RecordReader:
    """Random access over a shard directory (native mmap or numpy fallback)."""

    def __init__(self, directory: str, force_python: bool = False):
        self.directory = directory
        self._force_python = force_python
        self._lib = None if force_python else _load_native()
        if self._lib is not None:
            self._rs = self._lib.rs_open(directory.encode())
            if not self._rs:
                raise OSError(f"cannot open record shard at {directory}")
            self._len = int(self._lib.rs_len(self._rs))
        else:
            idx = np.fromfile(os.path.join(directory, "index.bin"), np.uint64)
            self._index = idx.reshape(-1, 2)
            self._len = self._index.shape[0]
            self._data = np.memmap(os.path.join(directory, "data.bin"),
                                   dtype=np.uint8, mode="r")
        meta_path = os.path.join(directory, "meta.json")
        self.meta = {}
        if os.path.isfile(meta_path):
            with open(meta_path) as f:
                self.meta = json.load(f)

    def __len__(self):
        return self._len

    def get_bytes(self, i: int) -> bytes:
        if not 0 <= i < self._len:
            raise IndexError(i)
        if self._lib is not None:
            n = ctypes.c_uint64()
            ptr = self._lib.rs_get(self._rs, i, ctypes.byref(n))
            if not ptr:
                raise OSError(f"record {i} unreadable")
            return ctypes.string_at(ptr, n.value)
        off, length = map(int, self._index[i])
        return bytes(self._data[off:off + length])

    def __getitem__(self, i: int) -> Record:
        return decode_record(self.get_bytes(i))

    def close(self):
        if self._lib is not None and getattr(self, "_rs", None):
            self._lib.rs_close(self._rs)
            self._rs = None

    # ------------------------------------------------------------ pickling
    # ctypes CDLL handles and mmap pointers cannot cross a process
    # boundary; serialize only (directory, mode) and reopen the shard in
    # the worker. This is what makes WorkerLoader's num_workers>0 (and any other
    # multiprocess consumer) safe.
    def __getstate__(self):
        return {"directory": self.directory,
                "force_python": self._force_python}

    def __setstate__(self, state):
        self.__init__(state["directory"],
                      force_python=state["force_python"])

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
