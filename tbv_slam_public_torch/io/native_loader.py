"""ctypes bridge to the native C++ radar sequence loader.

Wraps ``native/radar_loader`` (threaded libpng decode + in-order prefetch
ring — the reference's radar_driver/rosbag ingestion + SafeQueue rebuilt for
a TPU host loop).  Builds the shared library on first use with the checked-in
Makefile; falls back cleanly (raises ImportError) when the toolchain is
unavailable so the PIL path in io.oxford keeps working.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native",
                           "radar_loader")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libradar_loader.so")
_lib = None


def _build() -> None:
    subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                   capture_output=True, text=True)


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        try:
            _build()
        except (subprocess.CalledProcessError, FileNotFoundError) as e:
            raise ImportError(f"native radar loader unavailable: {e}") from e
    lib = ctypes.CDLL(_LIB_PATH)
    lib.rl_open.restype = ctypes.c_void_p
    lib.rl_open.argtypes = [ctypes.c_char_p,
                            ctypes.POINTER(ctypes.c_double), ctypes.c_int,
                            ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.rl_next.restype = ctypes.c_int
    lib.rl_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
                            ctypes.POINTER(ctypes.c_int),
                            ctypes.POINTER(ctypes.c_double),
                            ctypes.POINTER(ctypes.c_int)]
    lib.rl_copy.argtypes = [ctypes.c_void_p,
                            ctypes.POINTER(ctypes.c_uint8)]
    lib.rl_close.argtypes = [ctypes.c_void_p]
    lib.rl_decode.restype = ctypes.c_int
    lib.rl_decode.argtypes = [ctypes.c_char_p, ctypes.c_int,
                              ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
                              ctypes.POINTER(ctypes.c_int),
                              ctypes.POINTER(ctypes.c_int)]
    _lib = lib
    return lib


def available() -> bool:
    try:
        _load()
        return True
    except ImportError:
        return False


def decode_png(path: str, strip_cols: int = 0,
               max_shape: Tuple[int, int] = (1024, 8192)) -> np.ndarray:
    """One-shot native PNG decode -> [rows, cols] uint8."""
    lib = _load()
    buf = np.empty(max_shape[0] * max_shape[1], np.uint8)
    rows = ctypes.c_int()
    cols = ctypes.c_int()
    ok = lib.rl_decode(
        path.encode(), strip_cols,
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), buf.size,
        ctypes.byref(rows), ctypes.byref(cols))
    if not ok:
        raise IOError(f"native decode failed: {path}")
    return buf[: rows.value * cols.value].reshape(rows.value, cols.value).copy()


class NativeSequenceReader:
    """In-order prefetching reader over a list of (stamp, path) scans."""

    def __init__(self, files: Sequence[Tuple[float, str]], strip_cols: int = 0,
                 num_threads: int = 4, prefetch_depth: int = 16):
        self._lib = _load()
        stamps = (ctypes.c_double * len(files))(*[s for s, _ in files])
        joined = "\n".join(p for _, p in files).encode()
        self._h = self._lib.rl_open(joined, stamps, len(files), strip_cols,
                                    num_threads, prefetch_depth)
        self._n = len(files)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, float]]:
        rows = ctypes.c_int()
        cols = ctypes.c_int()
        stamp = ctypes.c_double()
        ok = ctypes.c_int()
        while self._lib.rl_next(self._h, ctypes.byref(rows),
                                ctypes.byref(cols), ctypes.byref(stamp),
                                ctypes.byref(ok)):
            if not ok.value:
                continue
            img = np.empty((rows.value, cols.value), np.uint8)
            self._lib.rl_copy(
                self._h, img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
            yield img, stamp.value

    def close(self) -> None:
        if self._h:
            self._lib.rl_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
