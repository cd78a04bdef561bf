"""Vectorized UTF-8 codec (host side, numpy).

Behaviourally equivalent to the reference byte-at-a-time codec
(reference: youtokentome/cpp/utf8.cpp) but restructured as flat array ops
so a 1 GB corpus decodes at memory bandwidth instead of a scalar loop:

* invalid sequences yield one INVALID_UNICODE sentinel per consumed byte
  (utf8.cpp:72-73 consumes exactly 1 byte on failure),
* overlong encodings are rejected via minimum-codepoint checks
  (utf8.cpp:47,56,66),
* surrogates and codepoints > U+10FFFF are rejected (utf8.cpp:16-18).

Vectorization argument (why no sequential scan is needed): the reference
iterator only accepts a multi-byte char when every tail byte is a
continuation byte (utf8.cpp:44-66), so valid chars cover *only*
continuation bytes; char starts are therefore exactly (a) every
non-continuation byte and (b) every continuation byte not covered by a
valid char starting at a non-continuation byte.  Both sets are computable
with elementwise ops plus one cumulative sum.
"""

from __future__ import annotations

import numpy as np

from ..models.state import INVALID_UNICODE


def _check_codepoint(cp: np.ndarray) -> np.ndarray:
    """Valid scalar values: < 0xD800 or in (0xDFFF, 0x110000) (utf8.cpp:16-18)."""
    return (cp < 0xD800) | ((0xDFFF < cp) & (cp < 0x110000))


def decode_utf8_bytes(data: bytes | np.ndarray, keep_invalid: bool = True) -> np.ndarray:
    """Decode a UTF-8 byte stream into uint32 codepoints.

    Invalid input produces one INVALID_UNICODE entry per bad byte when
    ``keep_invalid``; otherwise bad bytes are dropped (like the reference's
    ``decode_utf8`` which skips them, utf8.cpp:117-121).
    """
    b = np.frombuffer(data, dtype=np.uint8) if isinstance(data, (bytes, bytearray)) else np.asarray(data, dtype=np.uint8)
    n = b.size
    if n == 0:
        return np.empty(0, dtype=np.uint32)

    # pure-ASCII shortcut: one comparison pass instead of the ~10
    # full-width temporaries of the general path (a 100 MB English
    # corpus spent ~half its preprocessing here)
    if not np.any(b >= 0x80):
        return b.astype(np.uint32)

    b32 = b.astype(np.uint32)
    is_cont = (b & 0xC0) == 0x80

    # Tail bytes with zero padding past the end (padding never validates:
    # 0 is not a continuation byte).
    b1 = np.zeros(n, dtype=np.uint32)
    b2 = np.zeros(n, dtype=np.uint32)
    b3 = np.zeros(n, dtype=np.uint32)
    b1[: max(n - 1, 0)] = b32[1:]
    b2[: max(n - 2, 0)] = b32[2:]
    b3[: max(n - 3, 0)] = b32[3:]
    c1 = np.zeros(n, dtype=bool)
    c2 = np.zeros(n, dtype=bool)
    c3 = np.zeros(n, dtype=bool)
    c1[: max(n - 1, 0)] = is_cont[1:]
    c2[: max(n - 2, 0)] = is_cont[2:]
    c3[: max(n - 3, 0)] = is_cont[3:]

    ascii_ = b < 0x80
    lead2 = (b & 0xE0) == 0xC0
    lead3 = (b & 0xF0) == 0xE0
    lead4 = (b & 0xF8) == 0xF0

    cp2 = ((b32 & 0x1F) << 6) | (b1 & 0x3F)
    cp3 = ((b32 & 0x0F) << 12) | ((b1 & 0x3F) << 6) | (b2 & 0x3F)
    cp4 = ((b32 & 0x07) << 18) | ((b1 & 0x3F) << 12) | ((b2 & 0x3F) << 6) | (b3 & 0x3F)

    ok2 = lead2 & c1 & (cp2 >= 0x80) & _check_codepoint(cp2)
    ok3 = lead3 & c1 & c2 & (cp3 >= 0x800) & _check_codepoint(cp3)
    ok4 = lead4 & c1 & c2 & c3 & (cp4 >= 0x10000) & _check_codepoint(cp4)

    length = np.ones(n, dtype=np.int64)
    length[ok2] = 2
    length[ok3] = 3
    length[ok4] = 4

    valid_multi = ok2 | ok3 | ok4

    # Coverage of tail bytes by valid multi-byte chars: +1 at start+1,
    # -1 at start+length, then positive prefix sums mark covered bytes.
    diff = np.zeros(n + 4, dtype=np.int64)
    starts_multi = np.nonzero(valid_multi)[0]
    np.add.at(diff, starts_multi + 1, 1)
    np.add.at(diff, starts_multi + length[starts_multi], -1)
    covered = np.cumsum(diff[:n]) > 0

    is_start = ~covered
    cp = np.full(n, INVALID_UNICODE, dtype=np.uint32)
    cp[ascii_] = b32[ascii_]
    cp[ok2] = cp2[ok2]
    cp[ok3] = cp3[ok3]
    cp[ok4] = cp4[ok4]
    # Uncovered continuation / bad-lead bytes keep the INVALID sentinel.

    out = cp[is_start]
    if not keep_invalid:
        out = out[out != INVALID_UNICODE]
    return out


def encode_utf8_array(cps: np.ndarray) -> bytes:
    """Encode uint32 codepoints to UTF-8 bytes (utf8.cpp:76-109)."""
    cps = np.asarray(cps, dtype=np.uint32)
    if cps.size == 0:
        return b""
    if not bool(np.all(_check_codepoint(cps))):
        raise ValueError("invalid unicode codepoint")
    length = np.where(cps <= 0x7F, 1, np.where(cps <= 0x7FF, 2, np.where(cps <= 0xFFFF, 3, 4))).astype(np.int64)
    offs = np.concatenate([[0], np.cumsum(length)])
    total = int(offs[-1])
    out = np.zeros(total, dtype=np.uint32)
    start = offs[:-1]

    m1 = length == 1
    out[start[m1]] = cps[m1]

    m2 = length == 2
    s2 = start[m2]
    v2 = cps[m2]
    out[s2] = 0xC0 | (v2 >> 6)
    out[s2 + 1] = 0x80 | (v2 & 0x3F)

    m3 = length == 3
    s3 = start[m3]
    v3 = cps[m3]
    out[s3] = 0xE0 | (v3 >> 12)
    out[s3 + 1] = 0x80 | ((v3 >> 6) & 0x3F)
    out[s3 + 2] = 0x80 | (v3 & 0x3F)

    m4 = length == 4
    s4 = start[m4]
    v4 = cps[m4]
    out[s4] = 0xF0 | (v4 >> 18)
    out[s4 + 1] = 0x80 | ((v4 >> 12) & 0x3F)
    out[s4 + 2] = 0x80 | ((v4 >> 6) & 0x3F)
    out[s4 + 3] = 0x80 | (v4 & 0x3F)

    return out.astype(np.uint8).tobytes()


def encode_utf8(cps) -> str:
    """Codepoint list -> Python str (for piece rendering)."""
    return "".join(chr(int(c)) for c in cps)


def str_to_codepoints(s: str) -> np.ndarray:
    """Python str -> uint32 codepoint array (no invalid bytes possible)."""
    return np.frombuffer(s.encode("utf-32-le"), dtype=np.uint32).copy()
