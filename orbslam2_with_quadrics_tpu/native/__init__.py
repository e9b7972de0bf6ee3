"""ctypes bindings for the native runtime pieces (async image loader,
DBoW2 vocabulary text parser).

Builds lazily with make on first use; falls back to a pure-Python decoder
(cv2/imageio) when a toolchain is unavailable, so the package never hard-
fails.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_LIB_PATH = os.path.join(_DIR, "libslamnative.so")
_lock = threading.Lock()
_lib = None


def _build():
    """Build the library from source unless another process just did:
    the file lock serializes concurrent first uses (test workers)."""
    import fcntl

    with open(os.path.join(_DIR, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _stale():
            subprocess.run(
                ["make", "-C", _DIR, "-s"], check=True, capture_output=True
            )


def _stale() -> bool:
    if not os.path.exists(_LIB_PATH):
        return True
    so_mtime = os.path.getmtime(_LIB_PATH)
    return any(
        os.path.getmtime(os.path.join(_DIR, f)) > so_mtime
        for f in os.listdir(_DIR)
        if f.endswith(".cpp")
    )


def get_lib():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if _stale():
            _build()
        lib = ctypes.CDLL(_LIB_PATH)
        lib.slam_loader_create.restype = ctypes.c_void_p
        lib.slam_loader_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int,
        ]
        lib.slam_loader_peek.restype = ctypes.c_int
        lib.slam_loader_peek.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        lib.slam_loader_next.restype = ctypes.c_int
        lib.slam_loader_next.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
            ctypes.c_void_p,
        ]
        lib.slam_loader_destroy.argtypes = [ctypes.c_void_p]
        lib.slam_vocab_scan.restype = ctypes.c_long
        lib.slam_vocab_scan.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)
        ]
        lib.slam_vocab_parse.restype = ctypes.c_long
        lib.slam_vocab_parse.argtypes = [
            ctypes.c_char_p, ctypes.c_long,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_ubyte),
            ctypes.POINTER(ctypes.c_ubyte), ctypes.POINTER(ctypes.c_double),
        ]
        _lib = lib
        return lib


def parse_vocab_text(path: str):
    """Parse a DBoW2 text vocabulary with the native scanner.

    Returns (k, L, scoring, weighting, parent [M] int64, is_leaf [M] bool,
    desc [M,32] uint8, weight [M] f64) — same contract as the numpy
    fallback in ops/vocab._parse_dbow2_text.
    """
    lib = get_lib()
    header = (ctypes.c_int * 4)()
    n = lib.slam_vocab_scan(path.encode(), header)
    if n < 0:
        raise ValueError(f"not a DBoW2 text vocabulary: {path}")
    parent = np.empty(n, np.int32)
    is_leaf = np.empty(n, np.uint8)
    desc = np.empty((n, 32), np.uint8)
    weight = np.empty(n, np.float64)
    got = lib.slam_vocab_parse(
        path.encode(), n,
        parent.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        is_leaf.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        desc.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        weight.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    if got != n:
        raise ValueError(f"vocabulary parse mismatch: {got} != {n}")
    return (
        int(header[0]), int(header[1]), int(header[2]), int(header[3]),
        parent.astype(np.int64), is_leaf.astype(bool), desc, weight,
    )


class AsyncImageLoader:
    """In-order prefetching decoder over a list of image paths.

    Usage:
        with AsyncImageLoader(paths, n_threads=2) as it:
            for img in it:  # float32 [H,W] grayscale (or raw counts for
                ...         # 16-bit depth PNGs)
    """

    def __init__(self, paths, n_threads: int = 2, capacity: int = 8):
        self.paths = [os.fspath(p) for p in paths]
        lib = get_lib()
        arr = (ctypes.c_char_p * len(self.paths))(
            *[p.encode() for p in self.paths]
        )
        self._h = lib.slam_loader_create(arr, len(self.paths), n_threads, capacity)
        self._lib = lib
        self._n = len(self.paths)
        self._i = 0

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    def close(self):
        if self._h:
            self._lib.slam_loader_destroy(self._h)
            self._h = None

    def __iter__(self):
        return self

    def __next__(self):
        if self._i >= self._n:
            raise StopIteration
        h = ctypes.c_int()
        w = ctypes.c_int()
        is16 = ctypes.c_int()
        ok = self._lib.slam_loader_peek(
            self._h, ctypes.byref(h), ctypes.byref(w), ctypes.byref(is16)
        )
        if not ok:
            raise StopIteration
        out = np.empty((h.value, w.value), np.float32)
        raw16 = (
            np.empty((h.value, w.value), np.uint16) if is16.value else None
        )
        ok = self._lib.slam_loader_next(
            self._h,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            raw16.ctypes.data_as(ctypes.c_void_p) if raw16 is not None else None,
        )
        if not ok:
            raise StopIteration
        self._i += 1
        return (out, raw16) if raw16 is not None else (out, None)
