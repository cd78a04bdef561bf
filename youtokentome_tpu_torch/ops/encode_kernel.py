"""Batched BPE merge of padded word rows: greedy and BPE-dropout.

PyTorch counterpart of ``youtokentome_tpu/ops/encode_kernel.py``.  A
padded ``[rows, L]`` batch of words is merged to its fixed point:

  round:  rank[b,i] = rule rank of pair (t[b,i], t[b,i+1])   (hash lookup)
          m[b]      = min_i rank[b,i]
          merge all leftmost-non-overlapping occurrences of the rank-m
          pair in row b; compact the row

Merging the minimum-rank rule only creates pairs containing the new
token z, and every rule mentioning z has a larger rank, so this equals
the reference's (rank, pos)-ordered queue (see the JAX module's note).

BPE-dropout (bpe.cpp:1415-1453) merges one pair per row per round: each
candidate is skipped with probability p, the surviving candidate of
least (rank, position) merges, and a row with no survivor is frozen.
The JAX package draws its coins from ``jax.random``; the port draws a
counter-based hash of (seed, global row, round, column) (``coin_hash``),
the same bits in the CUDA kernel and in the plain version.

``encode_greedy``, ``encode_greedy_u16`` and ``encode_dropout`` are the
entry points.  On a CUDA tensor they launch the hand-written kernels
``csrc/encode_greedy.cu`` and ``csrc/encode_dropout.cu`` (and count the
launch); on a CPU tensor they run the plain torch versions
``encode_greedy_plain`` and ``encode_dropout_plain``.  Rows must be
front-packed: PAD only after a row's last token, as the encoder always
builds them.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from ..models.state import BPEState
from . import _cuda
from .hashmap import MISS, PairTable, _mulmod32, build_pair_table
from .segment import PAD, compact_rows, select_leftmost_nonoverlapping

PLACEHOLDER_START = 10**9  # unknown-run placeholder ids (bpe.cpp:1503-1527)

# uint16 wire format of the id-mode merge: real ids stay as they are, PAD
# packs to 0xFFFF and the per-word unknown-run placeholder ph packs to
# 0xFFFE - ph (word length <= 512 bounds ph, so 0xF000 is a safe floor).
# Only models with vocab_size < 0xF000 use it.  It halves the bytes that
# cross PCIe and device memory.
U16_PAD = 0xFFFF
U16_PH_TOP = 0xFFFE
U16_PH_FLOOR = 0xF000

MAX_KERNEL_LEN = 512  # the kernel keeps a row in shared memory


class EncoderTables:
    """A model's rule hash table (pair -> rank) and the merged token of
    each rank (``rules_z``), on one device."""

    def __init__(self, table: PairTable, rules_z: torch.Tensor, n_rules: int):
        self.table = table
        self.rules_z = rules_z
        self.n_rules = n_rules

    @classmethod
    def from_state(cls, state: BPEState, device) -> "EncoderTables":
        rules = state.rules
        n = len(rules)
        kx = np.fromiter((r[0] for r in rules), dtype=np.uint32, count=n)
        ky = np.fromiter((r[1] for r in rules), dtype=np.uint32, count=n)
        table = build_pair_table(kx, ky, np.arange(n, dtype=np.int32), device)
        z = (
            np.fromiter((r[2] for r in rules), dtype=np.int32, count=n)
            if n
            else np.zeros(1, dtype=np.int32)
        )
        return cls(table, torch.from_numpy(z).to(device), n)


# -- plain torch version ----------------------------------------------------


def _rank_lookup(table: PairTable, tokens: torch.Tensor) -> torch.Tensor:
    left = tokens[:, :-1]
    right = tokens[:, 1:]
    valid = (left != PAD) & (right != PAD)
    ranks = table.lookup(left, right)
    return torch.where(valid, ranks, torch.full_like(ranks, int(MISS)))


def merge_round(tables: EncoderTables, toks: torch.Tensor):
    """One round over every row: merge the occurrences of each row's
    minimum-rank rule and front-compact.  Returns (new rows, [B, 1] mask
    of the rows that had a rule)."""
    b = toks.shape[0]
    no_col = torch.zeros((b, 1), dtype=torch.bool, device=toks.device)
    ranks = _rank_lookup(tables.table, toks)
    m = ranks.min(dim=1, keepdim=True).values
    active = m < int(MISS)
    hit = (ranks == m) & active
    sel = select_leftmost_nonoverlapping(hit)
    z = tables.rules_z[m.clamp(0, tables.n_rules - 1).long()]
    sel_l = torch.cat([sel, no_col], dim=1)
    sel_r = torch.cat([no_col, sel], dim=1)
    merged = torch.where(sel_l, z.expand_as(toks), toks)
    keep = ~sel_r & (toks != PAD)
    return compact_rows(merged, keep), active


def encode_greedy_plain(tables: EncoderTables, tokens: torch.Tensor) -> torch.Tensor:
    """Plain torch merge loop on int32 ``[B, L]`` rows, on any device;
    the same rounds as the JAX ``_encode_greedy``."""
    if tables.n_rules == 0 or tokens.shape[1] < 2:
        return tokens.clone()
    toks = tokens
    for _ in range(tokens.shape[1]):
        toks, active = merge_round(tables, toks)
        if not bool(active.any()):
            break
    return toks


def pack_tokens_u16(mat: np.ndarray) -> np.ndarray:
    """Host-side [B, L] int32 -> uint16 wire format (see layout note)."""
    ph = mat >= PLACEHOLDER_START
    out = np.where(
        mat < 0,
        U16_PAD,
        np.where(ph, U16_PH_TOP - (mat - PLACEHOLDER_START), mat),
    )
    return out.astype(np.uint16)


def _unpack_u16(toks_u16: torch.Tensor) -> torch.Tensor:
    u = toks_u16.to(torch.int32)
    return torch.where(
        u == U16_PAD,
        torch.full_like(u, PAD),
        torch.where(u >= U16_PH_FLOOR, PLACEHOLDER_START + (U16_PH_TOP - u), u),
    )


def encode_greedy_u16_plain(
    tables: EncoderTables, toks_u16: torch.Tensor, unk_id: int
) -> torch.Tensor:
    """Plain torch uint16-wire merge: unpack, merge, map placeholders to
    ``unk_id`` and PAD to 0xFFFF, pack."""
    out = encode_greedy_plain(tables, _unpack_u16(toks_u16))
    o = torch.where(out >= PLACEHOLDER_START, torch.full_like(out, unk_id), out)
    return torch.where(out == PAD, torch.full_like(out, U16_PAD), o).to(torch.uint16)


# -- wrappers ---------------------------------------------------------------


def _check(tables: EncoderTables, toks: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Refuse what the kernels do not take; returns the output buffer."""
    if toks.dtype != dtype or toks.dim() != 2 or not toks.is_contiguous():
        raise ValueError(
            f"expected a contiguous 2-D {dtype} tensor, got {toks.dtype} "
            f"{tuple(toks.shape)}"
        )
    if toks.shape[1] > MAX_KERNEL_LEN:
        raise ValueError(f"row length {toks.shape[1]} exceeds the kernel's {MAX_KERNEL_LEN}")
    t = tables.table
    for name, x in (("kx", t.kx), ("ky", t.ky), ("val", t.val), ("rules_z", tables.rules_z)):
        if x.device != toks.device or not x.is_contiguous():
            raise ValueError(f"table {name} is not a contiguous tensor on {toks.device}")
    return torch.empty_like(toks)


def _launch(tables: EncoderTables, toks: torch.Tensor, dtype: torch.dtype, unk_id, wrapper):
    out = _check(tables, toks, dtype)
    r, n_len = toks.shape
    if r == 0 or n_len == 0:
        return out
    t = tables.table
    lib = _cuda.load()
    with torch.cuda.device(toks.device):
        stream = torch.cuda.current_stream(toks.device).cuda_stream
        args = [
            toks.data_ptr(), out.data_ptr(), r, n_len,
            t.kx.data_ptr(), t.ky.data_ptr(), t.val.data_ptr(), t.cap, t.max_probes,
            tables.rules_z.data_ptr(), tables.n_rules,
        ]
        if unk_id is None:
            err = lib.yttm_encode_greedy_i32(*args, stream)
        else:
            err = lib.yttm_encode_greedy_u16(*args, int(unk_id), stream)
    if err != 0:
        raise RuntimeError(f"encode_greedy kernel launch failed: CUDA error {err}")
    wrapper.launches += 1
    return out


def encode_greedy(tables: EncoderTables, toks: torch.Tensor) -> torch.Tensor:
    """Merge int32 ``[B, L]`` rows (PAD -1, placeholders kept) to their
    fixed point: the CUDA kernel on a CUDA tensor, the plain version on
    a CPU tensor."""
    if toks.device.type == "cpu":
        return encode_greedy_plain(tables, toks)
    if toks.device.type != "cuda":
        raise ValueError(f"encode_greedy runs on cuda or cpu, not {toks.device}")
    return _launch(tables, toks, torch.int32, None, encode_greedy)


def encode_greedy_u16(
    tables: EncoderTables, toks_u16: torch.Tensor, unk_id: int
) -> torch.Tensor:
    """uint16-wire variant of ``encode_greedy``: placeholders leave as
    ``unk_id`` and PAD as 0xFFFF."""
    if toks_u16.device.type == "cpu":
        return encode_greedy_u16_plain(tables, toks_u16, unk_id)
    if toks_u16.device.type != "cuda":
        raise ValueError(f"encode_greedy_u16 runs on cuda or cpu, not {toks_u16.device}")
    return _launch(tables, toks_u16, torch.uint16, unk_id, encode_greedy_u16)


# -- BPE-dropout -------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _M32) | (x >> (32 - r))


def _coin_step(h: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    k = _rotl32(_mulmod32(k, 0xCC9E2D51), 15)
    h = _rotl32(h ^ _mulmod32(k, 0x1B873593), 13)
    return (h * 5 + 0xE6546B64) & _M32


def _coin_rows(seed: int, rows: torch.Tensor) -> torch.Tensor:
    """The part of ``coin_hash`` that depends on the seed and row only."""
    h = _coin_step(torch.full_like(rows, seed & _M32), rows & _M32)
    return _coin_step(h, torch.full_like(rows, (seed >> 32) & _M32))


def _coin_finish(h: torch.Tensor, rnd: int, cols: torch.Tensor) -> torch.Tensor:
    h = _coin_step(h, ((rnd << 16) | cols) & _M32)
    h = h ^ (h >> 16)
    h = _mulmod32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mulmod32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def coin_hash(seed: int, rows: torch.Tensor, rnd: int, cols: torch.Tensor) -> torch.Tensor:
    """The coins of round ``rnd``: a 32-bit hash of (seed, row, round,
    column) for int64 ``rows`` [R, 1] and ``cols`` [1, C], in int64 with
    every product and shift kept to 32 bits (torch on the CPU has no
    ``>>`` on uint32).  ``csrc/encode_common.cuh:coin_hash`` computes the
    same bits."""
    return _coin_finish(_coin_rows(seed, rows), rnd, cols)


def drop_threshold(p: float) -> int:
    """A coin drops its candidate when ``(coin >> 8) < drop_threshold(p)``:
    a uniform draw k / 2**24 below the float32 ``p``."""
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"dropout probability {p} is not in [0, 1]")
    return math.ceil(float(np.float32(p)) * (1 << 24))


def dropout_round(tables: EncoderTables, toks: torch.Tensor, frozen: torch.Tensor,
                  drop: torch.Tensor):
    """One round of the JAX ``_encode_dropout`` loop body: ``drop`` [B, L-1]
    marks the candidates skipped this round.  Returns (new rows, new
    frozen [B])."""
    b, n_len = toks.shape
    miss = int(MISS)
    no_col = torch.zeros((b, 1), dtype=torch.bool, device=toks.device)
    col = torch.arange(n_len - 1, device=toks.device)[None, :]
    ranks = _rank_lookup(tables.table, toks)
    has_candidate = (ranks < miss).any(dim=1)
    surv = torch.where(drop, torch.full_like(ranks, miss), ranks)
    m = surv.min(dim=1, keepdim=True).values
    active = (m < miss) & ~frozen[:, None]
    # the leftmost surviving occurrence of the least surviving rank
    is_min = (surv == m) & active
    first = is_min.to(torch.int8).argmax(dim=1, keepdim=True)
    sel = is_min & (col == first)
    z = tables.rules_z[m.clamp(0, tables.n_rules - 1).long()]
    merged = torch.where(torch.cat([sel, no_col], dim=1), z.expand_as(toks), toks)
    keep = ~torch.cat([no_col, sel], dim=1) & (toks != PAD)
    new_frozen = frozen | (has_candidate & ~active[:, 0]) | ~has_candidate
    return compact_rows(merged, keep), new_frozen


def encode_dropout_plain(tables: EncoderTables, tokens: torch.Tensor, p: float, seed: int,
                         row0: int = 0, draws=None) -> torch.Tensor:
    """Plain torch BPE-dropout loop on int32 ``[B, L]`` rows, on any device:
    the rounds of the JAX ``_encode_dropout``.  The coins of row r come
    from ``coin_hash(seed, row0 + r, round, column)``; ``draws``, when
    given, replaces them: a callable ``round -> bool [B, L-1]`` numpy drop
    mask (the tests feed it the JAX package's own coins)."""
    if tables.n_rules == 0 or tokens.shape[1] < 2:
        return tokens.clone()
    b, n_len = tokens.shape
    dev = tokens.device
    thr = drop_threshold(p)
    rows = _coin_rows(seed, (row0 + torch.arange(b, device=dev, dtype=torch.int64))[:, None])
    cols = torch.arange(n_len - 1, device=dev, dtype=torch.int64)[None, :]
    toks = tokens
    frozen = torch.zeros(b, dtype=torch.bool, device=dev)
    for rnd in range(n_len):
        if bool(frozen.all()):
            break
        if draws is not None:
            drop = torch.from_numpy(np.array(draws(rnd), dtype=bool)).to(dev)
        else:
            drop = (_coin_finish(rows, rnd, cols) >> 8) < thr
        toks, frozen = dropout_round(tables, toks, frozen, drop)
    return toks


def encode_dropout(tables: EncoderTables, toks: torch.Tensor, p: float, seed: int,
                   row0: int = 0, work=None) -> torch.Tensor:
    """BPE-dropout of int32 ``[B, L]`` rows (PAD -1, placeholders kept)
    with probability ``p``; row r draws the coins of global row
    ``row0 + r`` under the 64-bit ``seed``.  The CUDA kernel on a CUDA
    tensor, the plain version on a CPU tensor.  ``work``, an int64 [3]
    tensor on the card, gets the kernel's coins, merges and initial pair
    lookups added (for bounds; the kernel only)."""
    if toks.device.type == "cpu":
        if work is not None:
            raise ValueError("encode_dropout counts its work on the card only")
        return encode_dropout_plain(tables, toks, p, seed, row0)
    if toks.device.type != "cuda":
        raise ValueError(f"encode_dropout runs on cuda or cpu, not {toks.device}")
    thr = drop_threshold(p)
    out = _check(tables, toks, torch.int32)
    if work is not None and (work.dtype != torch.int64 or work.numel() != 3
                             or work.device != toks.device or not work.is_contiguous()):
        raise ValueError("work must be a contiguous int64 [3] tensor on the rows' device")
    r, n_len = toks.shape
    if r == 0 or n_len == 0:
        return out
    t = tables.table
    lib = _cuda.load_dropout()
    with torch.cuda.device(toks.device):
        stream = torch.cuda.current_stream(toks.device).cuda_stream
        err = lib.yttm_encode_dropout(
            toks.data_ptr(), out.data_ptr(), r, n_len,
            t.kx.data_ptr(), t.ky.data_ptr(), t.val.data_ptr(), t.cap, t.max_probes,
            tables.rules_z.data_ptr(), tables.n_rules,
            seed & _M32, (seed >> 32) & _M32, row0 & _M32, thr,
            None if work is None else work.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"encode_dropout kernel launch failed: CUDA error {err}")
    encode_dropout.launches += 1
    return out


def encode_batch(tables: EncoderTables, tokens: np.ndarray, dropout_prob: float = 0.0,
                 seed=None) -> np.ndarray:
    """Encode a padded [B, L] int32 word batch on the tables' device;
    returns the merged [B, L].  With ``dropout_prob`` > 0 and no ``seed``
    the seed comes from ``os.urandom``."""
    toks = torch.from_numpy(np.ascontiguousarray(tokens, dtype=np.int32)).to(tables.rules_z.device)
    if dropout_prob == 0.0:
        out = encode_greedy(tables, toks)
    else:
        if seed is None:
            seed = int.from_bytes(os.urandom(8), "little")
        out = encode_dropout(tables, toks, dropout_prob, seed)
    return out.cpu().numpy()


# launches of the CUDA kernel through each wrapper (plain calls not counted)
encode_greedy.launches = 0
encode_greedy_u16.launches = 0
encode_dropout.launches = 0
