"""Batched greedy BPE merge of padded word rows.

PyTorch counterpart of ``youtokentome_tpu/ops/encode_kernel.py`` (the
dropout variant comes in a later slice).  A padded ``[rows, L]`` batch
of words is merged to its fixed point:

  round:  rank[b,i] = rule rank of pair (t[b,i], t[b,i+1])   (hash lookup)
          m[b]      = min_i rank[b,i]
          merge all leftmost-non-overlapping occurrences of the rank-m
          pair in row b; compact the row

Merging the minimum-rank rule only creates pairs containing the new
token z, and every rule mentioning z has a larger rank, so this equals
the reference's (rank, pos)-ordered queue (see the JAX module's note).

``encode_greedy`` and ``encode_greedy_u16`` are the entry points.  On a
CUDA tensor they launch the hand-written kernel ``csrc/encode_greedy.cu``
(and count the launch); on a CPU tensor they run the plain torch version
``encode_greedy_plain``.  Rows must be front-packed: PAD only after a
row's last token, as the encoder always builds them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.state import BPEState
from . import _cuda
from .hashmap import MISS, PairTable, build_pair_table
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


def _launch(tables: EncoderTables, toks: torch.Tensor, dtype: torch.dtype, unk_id, wrapper):
    if toks.dtype != dtype or toks.dim() != 2 or not toks.is_contiguous():
        raise ValueError(
            f"expected a contiguous 2-D {dtype} tensor, got {toks.dtype} "
            f"{tuple(toks.shape)}"
        )
    r, n_len = toks.shape
    if n_len > MAX_KERNEL_LEN:
        raise ValueError(f"row length {n_len} exceeds the kernel's {MAX_KERNEL_LEN}")
    t = tables.table
    for name, x in (("kx", t.kx), ("ky", t.ky), ("val", t.val), ("rules_z", tables.rules_z)):
        if x.device != toks.device or not x.is_contiguous():
            raise ValueError(f"table {name} is not a contiguous tensor on {toks.device}")
    out = torch.empty_like(toks)
    if r == 0 or n_len == 0:
        return out
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


# launches of the CUDA kernel through each wrapper (plain calls not counted)
encode_greedy.launches = 0
encode_greedy_u16.launches = 0
