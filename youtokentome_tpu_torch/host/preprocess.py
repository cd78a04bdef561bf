"""Vectorized host-side corpus preprocessing (numpy).

TPU-native replacement for the reference's per-byte C++ loops
(compute_char_count bpe.cpp:839-857, compute_alphabet_helper
bpe.cpp:316-355, remove_rare_chars bpe.cpp:357-380, compute_word_count
bpe.cpp:388-418): everything is flat array ops over the decoded
codepoint stream so the host keeps up with the device.

Dedup note: the reference hashes raw word bytes with a polynomial hash
but falls back to a full compare (bpe.cpp:28-54), i.e. dedup is exact.
Here words are grouped by length and deduplicated with ``np.unique`` on
fixed-width rows — also exact, no hash collisions possible.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..models.state import INVALID_UNICODE, SPACE_TOKEN

SPACE_CPS = np.array([9, 10, 11, 12, 13, 32, SPACE_TOKEN], dtype=np.uint32)

ROW_PAD = np.uint32(0xFFFFFFFF)  # per-row padding for word matrices


_ASCII_SPACE_LUT = np.zeros(256, dtype=bool)
_ASCII_SPACE_LUT[[9, 10, 11, 12, 13, 32]] = True


def space_mask(cps: np.ndarray) -> np.ndarray:
    """is_space over an array (utils.cpp:99-101), via a 256-entry LUT for
    the ASCII range plus one compare for U+2581 — much faster than isin."""
    return (_ASCII_SPACE_LUT[np.minimum(cps, 255)] & (cps < 256)) | (
        cps == SPACE_TOKEN
    )


def char_frequencies(cps: np.ndarray) -> Tuple[np.ndarray, np.ndarray, int]:
    """(unique_chars, counts, data_len).  data_len counts every decoded
    item including spaces and invalid sentinels (bpe.cpp:839-857)."""
    data_len = int(cps.size)
    if cps.size and int(cps.max()) < (1 << 16):
        # BMP-ish corpora: one bincount pass over the RAW stream, then
        # zero the known space bins — both the np.unique sort and the
        # boolean-mask copy it needed are gone (numpy's fancy indexing
        # on 32-bit dtypes is pathologically slow on this host)
        counts = np.bincount(cps)
        for sp in (9, 10, 11, 12, 13, 32, SPACE_TOKEN):
            if sp < counts.size:
                counts[sp] = 0
        uniq = np.nonzero(counts)[0].astype(cps.dtype)
        return uniq, counts[uniq].astype(np.int64), data_len
    m = ~space_mask(cps) & (cps != INVALID_UNICODE)
    sel = cps[m]
    uniq, cnt = np.unique(sel, return_counts=True)
    return uniq, cnt.astype(np.int64), data_len


@dataclasses.dataclass
class Alphabet:
    char2id: Dict[int, int]          # codepoint -> pre-rename id
    removed: np.ndarray              # removed codepoints (ascending)
    sorted_cps: np.ndarray           # alphabet codepoints ascending (incl. space)
    sorted_ids: np.ndarray           # ids aligned with sorted_cps
    space_id: int
    n_specials: int

    def lookup_ids(self, chars: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Vectorized codepoint -> id; returns (ids, known_mask)."""
        pos = np.searchsorted(self.sorted_cps, chars)
        pos_c = np.minimum(pos, self.sorted_cps.size - 1)
        known = self.sorted_cps[pos_c] == chars
        ids = np.where(known, self.sorted_ids[pos_c], -1).astype(np.int32)
        return ids, known


def build_alphabet(
    uniq: np.ndarray, cnt: np.ndarray, data_len: int, coverage: float, n_specials: int
) -> Alphabet:
    """Coverage cutoff + id assignment (bpe.cpp:316-355).

    Chars sorted by (count, codepoint) ascending; the removal loop takes
    the longest prefix where (data_len - removed - freq) > data_len *
    coverage (evaluated left to right, stopping at the first failure —
    since the running removal total only grows, this equals the prefix of
    positions that pass given the cumulative sum of their predecessors).
    Ids are then assigned from the back of the sort: specials, space
    meta-symbol, then descending (count, codepoint).
    """
    order = np.lexsort((uniq.astype(np.int64), cnt))
    f = cnt[order]
    ch = uniq[order]
    removed_before = np.cumsum(f) - f
    cond = (data_len - removed_before - f) > data_len * float(coverage)
    if cond.size and cond.all():
        cut = cond.size
    else:
        cut = int(np.argmin(cond)) if cond.size else 0
    removed = np.sort(ch[:cut]).astype(np.uint32)

    kept_desc = ch[cut:][::-1]  # descending (count, codepoint)
    char2id: Dict[int, int] = {}
    used = n_specials
    char2id[SPACE_TOKEN] = used
    used += 1
    # is_space chars never appear in char_cnt, so no filtering needed here.
    ids_desc = np.arange(used, used + kept_desc.size, dtype=np.int64)
    for c, i in zip(kept_desc.tolist(), ids_desc.tolist()):
        char2id[int(c)] = int(i)

    sorted_cps = np.sort(np.fromiter(char2id.keys(), dtype=np.uint32, count=len(char2id)))
    id_arr = np.fromiter(
        (char2id[int(c)] for c in sorted_cps), dtype=np.int32, count=sorted_cps.size
    )
    return Alphabet(
        char2id=char2id,
        removed=removed,
        sorted_cps=sorted_cps,
        sorted_ids=id_arr,
        space_id=char2id[SPACE_TOKEN],
        n_specials=n_specials,
    )


def word_spans(cps: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(start, length) of every maximal non-space run, in order."""
    sm = space_mask(cps)
    nonspace = ~sm
    if cps.size == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z
    prev_space = np.concatenate([[True], sm[:-1]])
    starts = np.nonzero(nonspace & prev_space)[0]
    next_space = np.concatenate([sm[1:], [True]])
    ends = np.nonzero(nonspace & next_space)[0] + 1
    return starts, ends - starts


@dataclasses.dataclass
class DedupWords:
    """Unique words grouped by length.

    ``group_rows[g]`` is a ``[k_g, L_g]`` uint32 codepoint matrix of the
    unique words of length ``group_lens[g]``; ``group_counts[g]`` their
    occurrence counts; ``occurrence_uid`` maps every original word
    occurrence (in corpus order) to its global unique-word index;
    ``uid_group``/``uid_row`` locate a unique word inside its group.
    """

    group_lens: List[int]
    group_rows: List[np.ndarray]
    group_counts: List[np.ndarray]
    occurrence_uid: np.ndarray
    n_unique: int
    uid_group: np.ndarray
    uid_row: np.ndarray


def dedup_words(cps: np.ndarray, starts: np.ndarray, lengths: np.ndarray) -> DedupWords:
    """Exact dedup of word occurrences, vectorized per length group."""
    n_occ = starts.size
    occurrence_uid = np.zeros(n_occ, dtype=np.int64)
    group_lens: List[int] = []
    group_rows: List[np.ndarray] = []
    group_counts: List[np.ndarray] = []
    uid_group: List[np.ndarray] = []
    uid_row: List[np.ndarray] = []
    base = 0
    uniq_lens = np.unique(lengths)
    for li, length in enumerate(uniq_lens.tolist()):
        sel = np.nonzero(lengths == length)[0]
        s = starts[sel]
        rows = cps[s[:, None] + np.arange(length)[None, :]]
        rows = np.ascontiguousarray(rows)
        keys = rows.view(np.dtype((np.void, rows.dtype.itemsize * length))).ravel()
        _, index, inverse, counts = np.unique(
            keys, return_index=True, return_inverse=True, return_counts=True
        )
        occurrence_uid[sel] = base + inverse
        k = index.size
        group_lens.append(int(length))
        group_rows.append(rows[index])
        group_counts.append(counts.astype(np.int64))
        uid_group.append(np.full(k, li, dtype=np.int32))
        uid_row.append(np.arange(k, dtype=np.int64))
        base += k
    return DedupWords(
        group_lens=group_lens,
        group_rows=group_rows,
        group_counts=group_counts,
        occurrence_uid=occurrence_uid,
        n_unique=base,
        uid_group=np.concatenate(uid_group) if uid_group else np.zeros(0, np.int32),
        uid_row=np.concatenate(uid_row) if uid_row else np.zeros(0, np.int64),
    )


def _native_word_buckets(cps, alphabet, bucket_caps):
    """C++ split+dedup for training preprocessing (np.unique over byte
    rows was ~12 s at 100 MB; the persistent-hash tokenizer does the
    same work in ~2 s).  Applicable only when no character was removed
    and the stream has no invalid codepoints — rare-char removal
    REJOINS the surrounding word halves (bpe.cpp:357-380) while the
    encode tokenizer would emit placeholder runs, so those corpora take
    the exact numpy path.  Returns None when not applicable."""
    if alphabet.removed.size:
        return None
    from .utf8 import INVALID_UNICODE as INV
    from . import fasttok

    if not fasttok.available():
        return None
    if cps.size and int(cps.max()) >= INV:
        return None
    # encode the codepoint stream back to bytes: the tokenizer is
    # byte-level.  For pure-ASCII corpora this is one astype.
    if not cps.size:
        return []
    if int(cps.max()) < 0x80:
        data = cps.astype(np.uint8).tobytes()
    else:
        try:
            data = "".join(map(chr, cps.tolist())).encode("utf-8")
        except (UnicodeEncodeError, ValueError):
            # API callers may pass unencodable codepoints (e.g. lone
            # surrogates); the numpy path handles them as ordinary ids
            return None
    words_flat, word_off, _occ, counts = fasttok.tokenize(
        data, alphabet.sorted_cps, alphabet.sorted_ids,
        alphabet.space_id,
    )
    if words_flat.size and int(words_flat.max()) >= 10**9:
        return None  # placeholder: some char missed the alphabet map
    lens = np.diff(word_off)  # includes the space prefix
    groups: Dict[int, List[Tuple[np.ndarray, np.ndarray]]] = {}
    off64 = word_off.astype(np.int64)
    for padded_len in np.unique(lens):
        sel = np.nonzero(lens == padded_len)[0]
        idx2d = off64[sel][:, None] + np.arange(int(padded_len))[None, :]
        mat = words_flat[idx2d].astype(np.int32)
        cap = next(
            (c for c in bucket_caps if c >= padded_len), int(padded_len)
        )
        if cap != padded_len:
            pad = np.full((sel.size, cap - int(padded_len)), -1, np.int32)
            mat = np.concatenate([mat, pad], axis=1)
        groups.setdefault(int(cap), []).append(
            (mat, counts[sel].astype(np.int32))
        )
    # same cap-grouping and pow-2 word-count padding as the numpy path
    out: List[Tuple[np.ndarray, np.ndarray]] = []
    for cap in sorted(groups):
        mats, cnts = zip(*groups[cap])
        mat = np.concatenate(mats, axis=0)
        cnt = np.concatenate(cnts)
        w = mat.shape[0]
        wp = max(8, 1 << int(np.ceil(np.log2(w))))
        if wp != w:
            mat = np.concatenate(
                [mat, np.full((wp - w, mat.shape[1]), -1, dtype=mat.dtype)]
            )
            cnt = np.concatenate([cnt, np.zeros(wp - w, dtype=cnt.dtype)])
        out.append((mat, cnt))
    return out


def training_word_buckets(
    cps: np.ndarray,
    alphabet: Alphabet,
    bucket_caps: Tuple[int, ...] = (8, 16, 32, 64, 128, 256, 512, 1024),
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Corpus codepoints -> length-bucketed, deduplicated id tensors.

    Mirrors remove_rare_chars + compute_word_count (bpe.cpp:357-418):
    rare and invalid codepoints are dropped from the stream first (spaces
    are never rare, so word boundaries are preserved), then words are
    split, deduplicated, mapped through char2id, and prefixed with the
    space-meta-symbol id.  Returns [(tokens [W, L], freq [W]), ...] with
    PAD = -1, one entry per occupied length bucket.
    """
    native = _native_word_buckets(cps, alphabet, bucket_caps)
    if native is not None:
        return native

    keep = cps != INVALID_UNICODE
    if alphabet.removed.size:
        keep &= ~np.isin(cps, alphabet.removed)
    stream = cps[keep]
    starts, lengths = word_spans(stream)
    dd = dedup_words(stream, starts, lengths)

    buckets: Dict[int, List[Tuple[np.ndarray, np.ndarray]]] = {}
    for length, rows, counts in zip(dd.group_lens, dd.group_rows, dd.group_counts):
        ids, known = alphabet.lookup_ids(rows)
        assert bool(known.all()), "rare chars must have been removed"
        padded_len = length + 1  # space prefix
        cap = next((c for c in bucket_caps if c >= padded_len), None)
        if cap is None:
            cap = padded_len
        k = rows.shape[0]
        mat = np.full((k, cap), -1, dtype=np.int32)
        mat[:, 0] = alphabet.space_id
        mat[:, 1 : 1 + length] = ids
        buckets.setdefault(cap, []).append((mat, counts.astype(np.int32)))

    out: List[Tuple[np.ndarray, np.ndarray]] = []
    for cap in sorted(buckets):
        mats, cnts = zip(*buckets[cap])
        mat = np.concatenate(mats, axis=0)
        cnt = np.concatenate(cnts)
        # Pad word count to a power of two: bounds the number of distinct
        # compiled shapes of the training while_loop (pad rows are all-PAD
        # with zero frequency, contributing nothing).
        w = mat.shape[0]
        wp = max(8, 1 << int(np.ceil(np.log2(w))))
        if wp != w:
            mat = np.concatenate(
                [mat, np.full((wp - w, mat.shape[1]), -1, dtype=mat.dtype)]
            )
            cnt = np.concatenate([cnt, np.zeros(wp - w, dtype=cnt.dtype)])
        out.append((mat, cnt))
    return out
