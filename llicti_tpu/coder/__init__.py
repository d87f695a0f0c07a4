"""Host-side arithmetic (range) coder: C++ kernel + ctypes binding.

The build is automatic-on-import (cached .so under this package dir).
API mirrors what the codec needs:

  encode_lohi(lo_u16, hi_u16) -> bytes           # device-gathered 2 vals/pixel
  encode_cdf(cdf_u16[N, Lp], syms_i16) -> bytes  # torchac-style
  decode_cdf(cdf_u16[N, Lp], data) -> syms_i16

All functions accept numpy arrays; calls release the GIL so independent
streams can be coded concurrently from a Python thread pool
(see SURVEY.md §2.3.4: host-side coder parallelism).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "src", "rangecoder.cpp")
_LIB_PATH = os.path.join(_HERE, "_rangecoder.so")

_lock = threading.Lock()
_lib = None


def _build() -> None:
    cmd = [
        "g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
        _SRC, "-o", _LIB_PATH + ".tmp",
    ]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(_LIB_PATH + ".tmp", _LIB_PATH)


def _load():
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        if (not os.path.exists(_LIB_PATH)
                or os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SRC)):
            _build()
        lib = ctypes.CDLL(_LIB_PATH)
        u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
        i16p = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.rc_encode_lohi.restype = ctypes.c_int64
        lib.rc_encode_lohi.argtypes = [u16p, u16p, ctypes.c_int64, u8p,
                                       ctypes.c_int64]
        lib.rc_encode_cdf.restype = ctypes.c_int64
        lib.rc_encode_cdf.argtypes = [u16p, ctypes.c_int32, i16p,
                                      ctypes.c_int64, u8p, ctypes.c_int64]
        lib.rc_decode_cdf.restype = ctypes.c_int64
        lib.rc_decode_cdf.argtypes = [u16p, ctypes.c_int32, ctypes.c_int64,
                                      u8p, ctypes.c_int64, i16p]
        lib.rc_decode_shared_cdf.restype = ctypes.c_int64
        lib.rc_decode_shared_cdf.argtypes = [u16p, ctypes.c_int32,
                                             ctypes.c_int64, u8p,
                                             ctypes.c_int64, i16p]
        _lib = lib
        return lib


def _as(arr, dtype):
    return np.ascontiguousarray(arr, dtype=dtype)


def encode_lohi(lo: np.ndarray, hi: np.ndarray) -> bytes:
    """Encode symbols given per-symbol cumulative bounds (hi==0 means 2^16)."""
    lib = _load()
    lo = _as(lo.reshape(-1), np.uint16)
    hi = _as(hi.reshape(-1), np.uint16)
    n = lo.size
    cap = 2 * n + 1024
    while True:
        out = np.empty(cap, np.uint8)
        ln = lib.rc_encode_lohi(lo, hi, n, out, cap)
        if ln >= 0:
            return out[:ln].tobytes()
        cap *= 4


def encode_cdf(cdf: np.ndarray, syms: np.ndarray) -> bytes:
    """torchac-style encode: cdf [N, Lp] uint16 rows, syms [N] int16."""
    lib = _load()
    Lp = cdf.shape[-1]
    cdf = _as(cdf.reshape(-1, Lp), np.uint16)
    syms = _as(syms.reshape(-1), np.int16)
    n = syms.size
    assert cdf.shape[0] == n
    cap = 2 * n + 1024
    while True:
        out = np.empty(cap, np.uint8)
        ln = lib.rc_encode_cdf(cdf, Lp, syms, n, out, cap)
        if ln >= 0:
            return out[:ln].tobytes()
        cap *= 4


def decode_cdf(cdf: np.ndarray, data: bytes, n: int | None = None) -> np.ndarray:
    """Decode n symbols from per-symbol CDF rows [N, Lp]."""
    lib = _load()
    Lp = cdf.shape[-1]
    cdf = _as(cdf.reshape(-1, Lp), np.uint16)
    if n is None:
        n = cdf.shape[0]
    buf = np.frombuffer(data, np.uint8)
    out = np.empty(n, np.int16)
    rc = lib.rc_decode_cdf(cdf, Lp, n, _as(buf, np.uint8), buf.size, out)
    assert rc == 0
    return out


def decode_shared_cdf(cdf_row: np.ndarray, n: int, data: bytes) -> np.ndarray:
    lib = _load()
    Lp = cdf_row.size
    buf = np.frombuffer(data, np.uint8)
    out = np.empty(n, np.int16)
    rc = lib.rc_decode_shared_cdf(_as(cdf_row, np.uint16), Lp, n,
                                  _as(buf, np.uint8), buf.size, out)
    assert rc == 0
    return out
