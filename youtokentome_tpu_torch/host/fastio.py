"""ctypes loader for the native host helpers (fastio.cpp), with pure
Python fallbacks.  The extension is compiled on first use into the
package's build directory; failures silently fall back."""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

from .._build import build_library

_HERE = Path(__file__).resolve().parent
_lock = threading.Lock()
_lib = None
_tried = False


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            so = build_library(
                _HERE / "fastio.cpp", "libfastio.so",
                ["g++", "-O3", "-shared", "-fPIC", "-std=c++11"],
            )
            lib = ctypes.CDLL(str(so))
            lib.yttm_format_ids.restype = ctypes.c_long
            lib.yttm_format_ids.argtypes = [
                ctypes.c_void_p, ctypes.c_long, ctypes.c_int32, ctypes.c_void_p,
            ]
            lib.yttm_format_ids_u16.restype = ctypes.c_long
            lib.yttm_format_ids_u16.argtypes = [
                ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p,
            ]
            lib.yttm_parse_ids.restype = ctypes.c_long
            lib.yttm_parse_ids.argtypes = [
                ctypes.c_void_p, ctypes.c_long, ctypes.c_int32, ctypes.c_void_p,
            ]
            _lib = lib
        except Exception:
            _lib = None
        return _lib


def format_ids(flat: np.ndarray, sentinel: int) -> bytes:
    """Flat id stream -> reference CLI text ("id id \n" per sentence)."""
    lib = _load()
    n = flat.size
    if lib is not None:
        if flat.dtype == np.uint16:
            buf = np.empty(8 * n + 16, dtype=np.uint8)
            k = lib.yttm_format_ids_u16(
                flat.ctypes.data_as(ctypes.c_void_p), n,
                buf.ctypes.data_as(ctypes.c_void_p),
            )
            return buf[:k].tobytes()
        flat32 = np.ascontiguousarray(flat, dtype=np.int32)
        buf = np.empty(13 * n + 16, dtype=np.uint8)
        k = lib.yttm_format_ids(
            flat32.ctypes.data_as(ctypes.c_void_p), n, sentinel,
            buf.ctypes.data_as(ctypes.c_void_p),
        )
        return buf[:k].tobytes()
    # fallback
    out = []
    line: list = []
    sent = 0xFFFF if flat.dtype == np.uint16 else sentinel
    for v in flat.tolist():
        if v == sent:
            out.append("".join(f"{t} " for t in line))
            out.append("\n")
            line = []
        else:
            line.append(v)
    if line:
        out.append("".join(f"{t} " for t in line))
    return "".join(out).encode()


def parse_ids(text: bytes, sentinel: int) -> np.ndarray:
    """Whitespace-separated decimal ids -> int32 array with sentinel at
    each newline."""
    lib = _load()
    n = len(text)
    if lib is not None:
        out = np.empty(n // 2 + 2, dtype=np.int32)
        k = lib.yttm_parse_ids(
            ctypes.cast(ctypes.c_char_p(text), ctypes.c_void_p),
            n,
            sentinel,
            out.ctypes.data_as(ctypes.c_void_p),
        )
        return out[:k]
    vals = []
    for line in text.decode().split("\n")[:-1]:
        vals.extend(int(x) for x in line.split())
        vals.append(sentinel)
    return np.asarray(vals, dtype=np.int32)
