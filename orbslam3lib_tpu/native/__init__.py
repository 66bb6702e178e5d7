"""Native (C++) host runtime: build-on-import ctypes bindings.

The reference keeps its host runtime native (DBoW2, KeyFrameDatabase — C++
on the ARM side); this package mirrors that for the host-side, latency-bound
pieces where a pointer-chase beats a dense device pass (SURVEY.md §7 "BoW
tree descent ... candidate for host CPU"). The JAX implementations in
models/vocabulary.py remain the oracle and the on-device option.

The shared library is compiled with g++ at first use, from the committed
source only, into a file named by a hash of the source, the flags and the
host architecture, so a stale or foreign build is never loaded. Build
failures (no compiler) degrade gracefully: `load_library()` returns
None and callers fall back to the JAX path.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "bow.cpp")
# portable flags: the library may be built on one host and loaded on another
# of the same architecture (no -march=native)
_FLAGS = ("-O3", "-shared", "-fPIC")


def _lib_path() -> str:
    with open(_SRC, "rb") as f:
        h = hashlib.sha256(f.read())
    h.update(" ".join(_FLAGS + (platform.machine(),)).encode())
    return os.path.join(_DIR, f"_bow-{h.hexdigest()[:16]}.so")


_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build(lib_path: str) -> bool:
    if os.path.exists(lib_path):
        return True
    try:
        # build to a temp name and rename: concurrent importers (test
        # workers) never see a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_DIR)
        os.close(fd)
        r = subprocess.run(["g++", *_FLAGS, "-o", tmp, _SRC],
                           capture_output=True, text=True, timeout=120)
        if r.returncode != 0:
            os.unlink(tmp)
            return False
        os.replace(tmp, lib_path)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def load_library() -> Optional[ctypes.CDLL]:
    """Build (if needed) and load the native library; None on failure."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    lib_path = _lib_path()
    if not _build(lib_path):
        return None
    try:
        lib = ctypes.CDLL(lib_path)
    except OSError:
        return None
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.bow_descend.argtypes = [u64p, i64p, ctypes.c_int, ctypes.c_int,
                                u64p, ctypes.c_int, i32p]
    lib.bowdb_create.argtypes = [ctypes.c_int, ctypes.c_int, f32p]
    lib.bowdb_create.restype = ctypes.c_void_p
    lib.bowdb_destroy.argtypes = [ctypes.c_void_p]
    lib.bowdb_add.argtypes = [ctypes.c_void_p, ctypes.c_int, i32p, u8p,
                              ctypes.c_int]
    lib.bowdb_query.argtypes = [ctypes.c_void_p, i32p, u8p, ctypes.c_int, f32p]
    lib.bowdb_n_active.argtypes = [ctypes.c_void_p]
    lib.bowdb_n_active.restype = ctypes.c_int
    _lib = lib
    return _lib


def pack_descriptors(desc_bits: np.ndarray) -> np.ndarray:
    """(N, 256) 0/1 -> (N, 4) uint64 packed little-endian-bit-in-byte."""
    b = np.packbits(np.asarray(desc_bits, np.uint8), axis=1, bitorder="little")
    return b.view(np.uint64)


class NativeVocabulary:
    """Packed flat tree for the native descent (mirrors models.vocabulary)."""

    def __init__(self, voc):
        self.k = voc.k
        self.depth = voc.depth
        self.n_words = voc.n_words
        self.idf = np.asarray(voc.idf, np.float32)
        packed, offsets = [], []
        off = 0
        for c in voc.centroids:
            offsets.append(off)
            p = pack_descriptors(np.asarray(c))
            packed.append(p)
            off += p.shape[0]
        self._levels = np.ascontiguousarray(np.concatenate(packed))
        self._offsets = np.asarray(offsets, np.int64)

    def word_ids(self, desc_bits: np.ndarray) -> np.ndarray:
        lib = load_library()
        d = np.ascontiguousarray(pack_descriptors(desc_bits))
        out = np.empty(d.shape[0], np.int32)
        lib.bow_descend(
            self._levels.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            self._offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            self.k, self.depth,
            d.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            d.shape[0],
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return out


class NativeBowDatabase:
    """Inverted-file keyframe database (KeyFrameDatabase.cc equivalent)."""

    def __init__(self, voc, max_kf: int):
        self.nvoc = voc if isinstance(voc, NativeVocabulary) else NativeVocabulary(voc)
        self.max_kf = max_kf
        lib = load_library()
        if lib is None:
            raise RuntimeError("native bow library unavailable")
        self._lib = lib
        idf = np.ascontiguousarray(self.nvoc.idf)
        self._h = lib.bowdb_create(
            self.nvoc.n_words, max_kf,
            idf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.bowdb_destroy(self._h)
                self._h = None
        except Exception:
            pass

    def _wv(self, desc_bits, valid):
        words = self.nvoc.word_ids(np.asarray(desc_bits))
        v = np.ascontiguousarray(np.asarray(valid, np.uint8))
        return np.ascontiguousarray(words), v

    def add(self, kf_id: int, desc_bits, valid):
        words, v = self._wv(desc_bits, valid)
        self._lib.bowdb_add(
            self._h, int(kf_id),
            words.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            v.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(words))

    def query_scores(self, desc_bits, valid) -> np.ndarray:
        """(max_kf,) L1 similarity per keyframe; -1 at inactive slots."""
        words, v = self._wv(desc_bits, valid)
        out = np.empty(self.max_kf, np.float32)
        self._lib.bowdb_query(
            self._h, words.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            v.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(words),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        return out

    def query(self, desc_bits, valid, exclude_mask=None, n_best: int = 3):
        """Same contract as reloc.PlaceRecognition.query: (ids, scores)."""
        s = self.query_scores(desc_bits, valid)
        if exclude_mask is not None:
            s = np.where(np.asarray(exclude_mask, bool), -1.0, s)
        top = np.argsort(-s, kind="stable")[:n_best]
        return top.astype(np.int32), s[top]

    @property
    def n_active(self) -> int:
        return int(self._lib.bowdb_n_active(self._h))
