"""ctypes wrapper for the native tokenizer (fasttok.cpp).

Compiled on demand into the package's build directory; ``available()``
reports whether the native path can be used (callers fall back to the
pure array pipeline otherwise).
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Tuple

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
                _HERE / "fasttok.cpp", "libfasttok.so",
                ["g++", "-O3", "-shared", "-fPIC", "-std=c++11"],
            )
            lib = ctypes.CDLL(str(so))
            lib.yttm_tokenize.restype = None
            lib.yttm_tokenize.argtypes = [
                ctypes.c_void_p, ctypes.c_long,           # data, n
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,  # alphabet
                ctypes.c_int32,                            # space_id
                ctypes.c_void_p, ctypes.c_long,            # words_flat
                ctypes.c_void_p, ctypes.c_long,            # word_off / uniq_cap
                ctypes.c_void_p, ctypes.c_long,            # occ_stream
                ctypes.c_void_p,                           # uid_counts
                ctypes.c_void_p,                           # out
            ]
            lib.yttm_expand_format.restype = ctypes.c_long
            lib.yttm_expand_format.argtypes = [
                ctypes.c_void_p, ctypes.c_long,
                ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_long,
            ]
            lib.yttm_expand_ids.restype = ctypes.c_long
            lib.yttm_expand_ids.argtypes = [
                ctypes.c_void_p, ctypes.c_long,
                ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_long,
            ]
            lib.yttm_ctx_new.restype = ctypes.c_void_p
            lib.yttm_ctx_new.argtypes = []
            lib.yttm_ctx_free.restype = None
            lib.yttm_ctx_free.argtypes = [ctypes.c_void_p]
            lib.yttm_ctx_reset.restype = None
            lib.yttm_ctx_reset.argtypes = [ctypes.c_void_p]
            lib.yttm_ctx_n_words.restype = ctypes.c_long
            lib.yttm_ctx_n_words.argtypes = [ctypes.c_void_p]
            lib.yttm_ctx_tokenize.restype = None
            lib.yttm_ctx_tokenize.argtypes = [
                ctypes.c_void_p,                           # ctx
                ctypes.c_void_p, ctypes.c_long,            # data, n
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,  # alphabet
                ctypes.c_int32,                            # space_id
                ctypes.c_void_p, ctypes.c_long,            # words_flat
                ctypes.c_void_p, ctypes.c_long,            # word_off / uniq_cap
                ctypes.c_void_p, ctypes.c_long,            # occ_stream
                ctypes.c_void_p,                           # out
            ]
            lib.yttm_ctx_add_results.restype = None
            lib.yttm_ctx_add_results.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_long, ctypes.c_long,
            ]
            lib.yttm_ctx_format.restype = ctypes.c_long
            lib.yttm_ctx_format.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
                ctypes.c_void_p, ctypes.c_long,
            ]
            lib.yttm_ctx_expand_ids.restype = ctypes.c_long
            lib.yttm_ctx_expand_ids.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
                ctypes.c_void_p, ctypes.c_long,
            ]
            lib.yttm_ctx_out_bound.restype = ctypes.c_long
            lib.yttm_ctx_out_bound.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
                ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long),
            ]
            lib.yttm_ruletab_new.restype = ctypes.c_void_p
            lib.yttm_ruletab_new.argtypes = [ctypes.c_void_p, ctypes.c_long]
            lib.yttm_ruletab_free.restype = None
            lib.yttm_ruletab_free.argtypes = [ctypes.c_void_p]
            lib.yttm_merge_words.restype = None
            lib.yttm_merge_words.argtypes = [
                ctypes.c_void_p,                 # tab
                ctypes.c_void_p, ctypes.c_void_p,  # flat, off
                ctypes.c_long,                   # n_words
                ctypes.c_void_p, ctypes.c_void_p,  # out_flat, out_off
            ]
            lib.yttm_merge_occurrences_dropout.restype = ctypes.c_long
            lib.yttm_merge_occurrences_dropout.argtypes = [
                ctypes.c_void_p,                 # tab
                ctypes.c_void_p, ctypes.c_void_p,  # flat, off
                ctypes.c_void_p, ctypes.c_long,  # occ, n_occ
                ctypes.c_double, ctypes.c_uint64,  # p, seed
                ctypes.c_void_p, ctypes.c_long,  # out_flat, out_cap
            ]
            _lib = lib
        except Exception:
            _lib = None
        return _lib


def available() -> bool:
    return _load() is not None


def tokenize(
    data: bytes, alpha_cps: np.ndarray, alpha_ids: np.ndarray, space_id: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Returns (words_flat, word_off [U+1], occ_stream, uid_counts)."""
    lib = _load()
    assert lib is not None
    n = len(data)
    words_cap = (3 * n) // 2 + 16
    uniq_cap = n // 2 + 4
    occ_cap = n + 4
    words_flat = np.empty(words_cap, np.int32)
    word_off = np.empty(uniq_cap + 1, np.int32)
    occ = np.empty(occ_cap, np.int32)
    counts = np.empty(uniq_cap, np.int64)
    out = np.zeros(4, np.int64)
    cps = np.ascontiguousarray(alpha_cps, dtype=np.uint32)
    ids = np.ascontiguousarray(alpha_ids, dtype=np.int32)
    lib.yttm_tokenize(
        ctypes.cast(ctypes.c_char_p(data), ctypes.c_void_p), n,
        cps.ctypes.data_as(ctypes.c_void_p),
        ids.ctypes.data_as(ctypes.c_void_p), cps.size,
        space_id,
        words_flat.ctypes.data_as(ctypes.c_void_p), words_cap,
        word_off.ctypes.data_as(ctypes.c_void_p), uniq_cap,
        occ.ctypes.data_as(ctypes.c_void_p), occ_cap,
        counts.ctypes.data_as(ctypes.c_void_p),
        out.ctypes.data_as(ctypes.c_void_p),
    )
    if out[3] != 0:
        raise RuntimeError("fasttok capacity exceeded")
    n_flat, n_uniq, n_occ = int(out[0]), int(out[1]), int(out[2])
    return (
        words_flat[:n_flat],
        word_off[: n_uniq + 1],
        occ[:n_occ],
        counts[:n_uniq],
    )


def expand_format(
    occ: np.ndarray, results_flat: np.ndarray, res_off: np.ndarray
) -> bytes:
    lib = _load()
    assert lib is not None
    occ = np.ascontiguousarray(occ, np.int32)
    rf = np.ascontiguousarray(results_flat, np.int32)
    ro = np.ascontiguousarray(res_off, np.int32)
    # bound: every token prints <= 12 bytes + separator
    lens = np.diff(ro.astype(np.int64))
    cap = 13 * int(lens[occ[occ >= 0]].sum()) + occ.size + 64
    buf = np.empty(cap, dtype=np.uint8)  # no zeroing, unlike create_string_buffer
    k = lib.yttm_expand_format(
        occ.ctypes.data_as(ctypes.c_void_p), occ.size,
        rf.ctypes.data_as(ctypes.c_void_p), ro.ctypes.data_as(ctypes.c_void_p),
        buf.ctypes.data_as(ctypes.c_void_p), cap,
    )
    if k < 0:
        raise RuntimeError("expand_format capacity")
    return buf[:k].tobytes()


class WordCache:
    """Persistent cross-batch word cache (C++ context).

    Unique words keep stable uids across batches; merge results (ids +
    pre-formatted CLI text) are cached per uid, so later batches only
    device-encode words never seen before.  ``max_words`` bounds memory
    via epoch eviction (full reset), like the encoder's Python cache.
    """

    def __init__(self, max_words: int = 1 << 22):
        lib = _load()
        assert lib is not None
        self._lib = lib
        self._ctx = lib.yttm_ctx_new()
        self.max_words = max_words

    def __del__(self):
        try:
            if self._ctx:
                self._lib.yttm_ctx_free(self._ctx)
                self._ctx = None
        except Exception:
            pass

    @property
    def n_words(self) -> int:
        return int(self._lib.yttm_ctx_n_words(self._ctx))

    def maybe_evict(self) -> None:
        if self.n_words > self.max_words:
            self._lib.yttm_ctx_reset(self._ctx)

    def tokenize(
        self, data: bytes, alpha_cps: np.ndarray, alpha_ids: np.ndarray,
        space_id: int,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
        """Returns (new_words_flat, new_word_off [n_new+1],
        occ_stream with global uids, base_uid)."""
        self.maybe_evict()
        n = len(data)
        words_cap = (3 * n) // 2 + 16
        uniq_cap = n // 2 + 4
        occ_cap = n + 4
        words_flat = np.empty(words_cap, np.int32)
        word_off = np.empty(uniq_cap + 1, np.int32)
        occ = np.empty(occ_cap, np.int32)
        out = np.zeros(8, np.int64)
        cps = np.ascontiguousarray(alpha_cps, dtype=np.uint32)
        ids = np.ascontiguousarray(alpha_ids, dtype=np.int32)
        self._lib.yttm_ctx_tokenize(
            self._ctx,
            ctypes.cast(ctypes.c_char_p(data), ctypes.c_void_p), n,
            cps.ctypes.data_as(ctypes.c_void_p),
            ids.ctypes.data_as(ctypes.c_void_p), cps.size,
            space_id,
            words_flat.ctypes.data_as(ctypes.c_void_p), words_cap,
            word_off.ctypes.data_as(ctypes.c_void_p), uniq_cap,
            occ.ctypes.data_as(ctypes.c_void_p), occ_cap,
            out.ctypes.data_as(ctypes.c_void_p),
        )
        if out[3] != 0:
            # the C side may have inserted words into the persistent map
            # before hitting capacity; without a reset those uids would
            # later read result vectors that were never registered
            self._lib.yttm_ctx_reset(self._ctx)
            raise RuntimeError("fasttok ctx capacity exceeded")
        n_flat, n_new, n_occ, _, base = (int(x) for x in out[:5])
        return (
            words_flat[:n_flat],
            word_off[: n_new + 1],
            occ[:n_occ],
            base,
        )

    def add_results(
        self, results_flat: np.ndarray, res_off: np.ndarray, base_uid: int
    ) -> None:
        rf = np.ascontiguousarray(results_flat, np.int32)
        ro = np.ascontiguousarray(res_off, np.int32)
        self._lib.yttm_ctx_add_results(
            self._ctx,
            rf.ctypes.data_as(ctypes.c_void_p),
            ro.ctypes.data_as(ctypes.c_void_p),
            base_uid, ro.size - 1,
        )

    def _bounds(self, occ: np.ndarray) -> Tuple[int, int]:
        n_ids = ctypes.c_long(0)
        n_text = ctypes.c_long(0)
        self._lib.yttm_ctx_out_bound(
            self._ctx, occ.ctypes.data_as(ctypes.c_void_p), occ.size,
            ctypes.byref(n_ids), ctypes.byref(n_text),
        )
        return n_ids.value, n_text.value

    def format(self, occ: np.ndarray) -> bytes:
        occ = np.ascontiguousarray(occ, np.int32)
        _, cap = self._bounds(occ)
        buf = np.empty(cap + 64, dtype=np.uint8)
        k = self._lib.yttm_ctx_format(
            self._ctx, occ.ctypes.data_as(ctypes.c_void_p), occ.size,
            buf.ctypes.data_as(ctypes.c_void_p), cap + 64,
        )
        if k < 0:
            raise RuntimeError("ctx format capacity")
        return buf[:k].tobytes()

    def expand_ids(self, occ: np.ndarray) -> np.ndarray:
        occ = np.ascontiguousarray(occ, np.int32)
        cap, _ = self._bounds(occ)
        out = np.empty(cap + 4, np.int32)
        k = self._lib.yttm_ctx_expand_ids(
            self._ctx, occ.ctypes.data_as(ctypes.c_void_p), occ.size,
            out.ctypes.data_as(ctypes.c_void_p), cap + 4,
        )
        if k < 0:
            raise RuntimeError("ctx expand capacity")
        return out[:k]


class RuleTable:
    """Persistent (x, y) -> (rank, z) rule hash for the host-side greedy
    merge — the latency arm of the encode dispatch crossover (small
    novel-word batches are round-trip-bound on remote devices)."""

    def __init__(self, rules):
        lib = _load()
        assert lib is not None
        self._lib = lib
        r = np.ascontiguousarray(np.asarray(rules, np.int32).reshape(-1, 3))
        self._tab = lib.yttm_ruletab_new(
            r.ctypes.data_as(ctypes.c_void_p), r.shape[0]
        )

    def __del__(self):
        try:
            if self._tab:
                self._lib.yttm_ruletab_free(self._tab)
                self._tab = None
        except Exception:
            pass

    def merge_words(
        self, words_flat: np.ndarray, word_off: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Greedy-merge every word of the ragged batch; returns
        (results_flat, res_off) in word order."""
        flat = np.ascontiguousarray(words_flat, np.int32)
        off = np.ascontiguousarray(word_off, np.int64)
        n_words = off.size - 1
        out_flat = np.empty(flat.size, np.int32)
        out_off = np.empty(n_words + 1, np.int64)
        self._lib.yttm_merge_words(
            self._tab,
            flat.ctypes.data_as(ctypes.c_void_p),
            off.ctypes.data_as(ctypes.c_void_p),
            n_words,
            out_flat.ctypes.data_as(ctypes.c_void_p),
            out_off.ctypes.data_as(ctypes.c_void_p),
        )
        return out_flat[: out_off[-1]], out_off

    def merge_occurrences_dropout(
        self,
        words_flat: np.ndarray,
        word_off: np.ndarray,
        occ: np.ndarray,
        p: float,
        seed: int,
    ) -> np.ndarray:
        """BPE-dropout merge of every occurrence in the occ stream (uid
        entries sample independently; -1 sentinels pass through).
        Returns the flat id stream with -1 line marks."""
        flat = np.ascontiguousarray(words_flat, np.int32)
        off = np.ascontiguousarray(word_off, np.int64)
        occ = np.ascontiguousarray(occ, np.int32)
        lens = np.diff(off)
        cap = int(lens[occ[occ >= 0]].sum()) + occ.size + 4
        out = np.empty(cap, np.int32)
        k = self._lib.yttm_merge_occurrences_dropout(
            self._tab,
            flat.ctypes.data_as(ctypes.c_void_p),
            off.ctypes.data_as(ctypes.c_void_p),
            occ.ctypes.data_as(ctypes.c_void_p), occ.size,
            float(p), seed & 0xFFFFFFFFFFFFFFFF,
            out.ctypes.data_as(ctypes.c_void_p), cap,
        )
        if k < 0:
            raise RuntimeError("dropout merge capacity")
        return out[:k]


def expand_ids(
    occ: np.ndarray, results_flat: np.ndarray, res_off: np.ndarray
) -> np.ndarray:
    lib = _load()
    assert lib is not None
    occ = np.ascontiguousarray(occ, np.int32)
    rf = np.ascontiguousarray(results_flat, np.int32)
    ro = np.ascontiguousarray(res_off, np.int32)
    lens = np.diff(ro)
    cap = int(lens[occ[occ >= 0]].sum()) + occ.size + 4
    out = np.empty(cap, np.int32)
    k = lib.yttm_expand_ids(
        occ.ctypes.data_as(ctypes.c_void_p), occ.size,
        rf.ctypes.data_as(ctypes.c_void_p), ro.ctypes.data_as(ctypes.c_void_p),
        out.ctypes.data_as(ctypes.c_void_p), cap,
    )
    if k < 0:
        raise RuntimeError("expand_ids capacity")
    return out[:k]
