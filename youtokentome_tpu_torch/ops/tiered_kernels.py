"""The v5 tiered trainer's round as four kernels, and the loop that drives them.

The JAX program ``youtokentome_tpu/ops/train_tiered.py:193
train_rounds_tiered`` keeps a frozen cold table and a pending buffer and
gathers the affected blocks into static ``[KB, B]`` mini streams, because a
TPU cannot scatter into a table without a sort and needs static shapes.  On
a card the round is four hand-written CUDA kernels (``csrc/train_tiered.cu``)
over a state that needs neither:

  * the JAX package's block stream ``[NB, B]`` with its signatures (int32
    words with the JAX package's uint32 bits), so the stream equals the JAX
    trainer's at every segment end;
  * the FULL pair-count table, exact after every round: open addressing,
    int64 keys ``x << 32 | y``, int32 counts, as in ``train_kernels.py``;
  * the HOT table (2 * hcap slots): every key whose count exceeds ``T``,
    exact.  A round's deltas go into it only when the key is there already
    or holds one of the round's new ids: every other key was at or below
    ``T`` at the last resplit and has only fallen since.

  tier_select   top-16 of the hot table with the floor T; a refresh round
                (hot top count <= T, hot overflow, or the first round after
                a count) takes the full table's top-16 with no floor
  apply_blocks  signature test of every row and the rows with a candidate
                pair listed; those merged and compacted, the tables moved by
                the hit words' net deltas, the rows' signatures; the round's
                stats.  In count mode every row's pairs go into an empty
                full table
  resplit       after a refresh round that merged: T = the count at rank
                hcap/2 of the full table, the hot table rebuilt from it
  fold_rows     the row fold of the JAX host loop, at a segment end where
                ``fold_wanted`` holds: the plan (fills, stable order by fill,
                pair check) in one launch, then concat and compact

``ctl`` (int32 [24]) holds the round control on the device, so the host
enqueues rounds in batches and reads ``ctl`` once per batch.  It keeps the
live tokens too (``ctl[LIVE]``, as the JAX program returns ``n_stream``):
a count sets it from the stream and every round's apply subtracts the
tokens its merges removed, so the fold's trigger needs no pass over the
stream.  Each wrapper
launches its kernels on a CUDA state (and counts the launch) and runs its
plain torch version on a CPU state; the two leave the same stream,
signatures, ``ctl`` and tables as multisets of (key, count) slots (but for
a table that overflows: its entries are then rebuilt before use).

The engine runs a batch of rounds through ``tier_rounds``: on a CUDA state
one call replays a CUDA graph of the round n times (tier_select's and
apply_blocks' kernels, then resplit's under an IF node that the apply's last
block sets on the card, so only the rounds where a resplit is due launch it);
on a CPU state the plain versions, resplit's only on those rounds.  The
resplit kernel counts its runs on the card (``sel[SEL_RUNS]``);
``count_resplits`` adds them to ``resplit.launches`` where the engine reads
the card anyway, at a segment's end.  ``rounds_per_call`` is the same batch
through the three per-call wrappers, resplit's on every round.
"""

from __future__ import annotations

import ctypes
import math
import sys

import numpy as np
import torch

from . import _cuda
from .train_block import _apply_rowwise
from .train_delta import _next_pow2
from .train_kernels import select_blocks, select_scratch
from .train_stream import (
    _topk_candidates,
    accept_prefix,
    pair_hits,
    pair_keys_and_weights_fw,
    store_rules,
)
from .train_tiered import (
    SIG_W,
    _fills,
    _fold_rows,
    fold_wanted,
    sig_build,
    sig_prefilter,
    tier_sizes,
)

(USED, DONE, OVERFLOW, ROUND, NACC, NBAFF, OCC, ERROR, REFRESH, HOT_OVF, HOCC, THRESH, ZLO,
 ACTIVE, ST_ROUNDS, ST_REFRESH, ST_MID, ST_FULL, LIVE, FOLD_MAX) = range(20)
CTL_N = 24
EMPTY = -1  # int64 all ones: the key of an empty slot
K_MAX = 16  # the kernels' candidates per round
# the fold plan's grid: a block per FOLD_BLOCK_ROWS rows, at most
# FOLD_MAX_BLOCKS (csrc/train_tiered.cu kFoldRowsPerBlock, kFoldMaxBlocks)
FOLD_BLOCK_ROWS, FOLD_MAX_BLOCKS = 256, 1024
# the resplit's scratch (csrc/train_tiered.cu SEL_*): four histograms of 2048
# bins, then its state: the grid barrier's generation and the kernel's runs
SEL_GEN, SEL_RUNS, SEL_N = 4 * 2048 + 6, 4 * 2048 + 8, 4 * 2048 + 16


class TieredState:
    """The kernel trainer's state on one device (see the module note)."""

    def __init__(self, t, wid, freq, rules, used: int, B: int, cap: int, hslots: int, device):
        dev = torch.device(device)
        self.device, self.B = dev, B
        # copies: the kernels update the stream in place
        self.tok = torch.from_numpy(np.array(t, np.int32)).to(dev)
        self.wid = torch.from_numpy(np.array(wid, np.int32)).to(dev)
        self.freq = torch.from_numpy(np.ascontiguousarray(freq, np.int32)).to(dev)
        self.sig = torch.zeros((self.NB, SIG_W), dtype=torch.int32, device=dev)
        self.rules = torch.from_numpy(np.array(rules, np.int32)).to(dev)  # a copy
        self.ctl = torch.zeros(CTL_N, dtype=torch.int32, device=dev)
        self.ctl[USED] = used
        self.cand = torch.zeros((K_MAX, 4), dtype=torch.int32, device=dev)
        # apply_blocks' list of the rows with a candidate pair; hits[0] their
        # number, hits[2:4] the apply's 64-bit ticket (csrc kHitsN)
        self.rows = torch.zeros(self.NB, dtype=torch.int32, device=dev)
        self.hits = torch.zeros(4, dtype=torch.int32, device=dev)
        self.sel = torch.zeros(SEL_N, dtype=torch.int32, device=dev)
        self.runs_seen = 0  # sel[SEL_RUNS] when count_resplits last read it
        self.round_graph = None  # the round graph (_RoundGraph) of a CUDA state
        self.resize(cap, hslots)

    @property
    def NB(self) -> int:
        return self.tok.shape[0] // self.B

    def resize(self, cap: int, hslots: int):
        """Empty full and hot tables of ``cap`` and ``hslots`` slots (powers
        of two)."""
        self.cap, self.hslots = cap, hslots
        self.keys = torch.full((cap,), EMPTY, dtype=torch.int64, device=self.device)
        self.cnts = torch.zeros(cap, dtype=torch.int32, device=self.device)
        self.hkeys = torch.full((hslots,), EMPTY, dtype=torch.int64, device=self.device)
        self.hcnts = torch.zeros(hslots, dtype=torch.int32, device=self.device)
        # the resplit's list of the slots in its last pass's range (past
        # cap / 16 it reads the table again instead)
        self.slots = torch.empty(cap // 16, dtype=torch.int32, device=self.device)
        n_blk = max(select_blocks(cap, self.device), select_blocks(hslots, self.device))
        self.blk_hi, self.blk_lo, self.ticket = select_scratch(n_blk, self.device)

    def set_stream(self, tok, wid, sig):
        self.tok, self.wid, self.sig = tok, wid, sig

    @staticmethod
    def _slots(keys, cnts):
        keys = keys.cpu().numpy()
        cnts = cnts.cpu().numpy()
        used = keys != EMPTY
        order = np.argsort(keys[used], kind="stable")
        return keys[used][order], cnts[used][order]

    def table(self):
        """The full table's slots as a sorted (key, count) multiset (numpy),
        count-0 slots included."""
        return self._slots(self.keys, self.cnts)

    def hot_table(self):
        return self._slots(self.hkeys, self.hcnts)


# -- plain torch versions -----------------------------------------------------


def _hash_update(keys, cnts, ctl, occ_i, ovf_i, dk, dv, insertable=None, err_i=None):
    """Add the net dv of each key: a present key adds, a missing key takes a
    free slot when ``insertable`` (all when None; else it is skipped), and
    with ``err_i`` a missing key whose net is not positive is an error;
    occupancy and overflow as the kernels set them (more than half the
    slots claimed, or no free one)."""
    if dk.numel() == 0:
        return
    uk, inv = torch.unique(dk, sorted=True, return_inverse=True)
    ud = torch.zeros(uk.shape[0], dtype=torch.int64, device=dk.device).index_add_(0, inv, dv.long())
    ins = torch.ones(uk.shape[0], dtype=torch.bool, device=dk.device)
    if insertable is not None:
        ins = torch.zeros_like(ins).index_fill_(0, inv[insertable], True)
    slots = torch.nonzero(keys != EMPTY).flatten()
    present = torch.zeros(uk.shape[0], dtype=torch.bool, device=dk.device)
    if slots.numel():
        sk, order = torch.sort(keys[slots])
        slots = slots[order]
        where = torch.searchsorted(sk, uk).clamp(max=sk.numel() - 1)
        present = sk[where] == uk
        cnts.index_add_(0, slots[where[present]], ud[present].to(torch.int32))
    new = ~present & ins
    if err_i is not None and bool((ud[new] <= 0).any()):
        ctl[err_i] = 1  # a subtraction from a pair the table lacks
    new_k, new_d = uk[new], ud[new]
    free = torch.nonzero(keys == EMPTY).flatten()
    fit = min(free.numel(), new_k.numel())
    keys[free[:fit]] = new_k[:fit]
    cnts[free[:fit]] = new_d[:fit].to(torch.int32)
    occ = int(ctl[occ_i]) + fit
    ctl[occ_i] = occ
    if fit < new_k.numel() or 2 * occ > keys.shape[0]:
        ctl[ovf_i] = 1


def _top(keys, cnts, k):
    live = keys != EMPTY
    zero = torch.zeros_like(keys)
    xs = torch.where(live, keys >> 32, zero).to(torch.int32)
    ys = torch.where(live, keys & 0xFFFFFFFF, zero).to(torch.int32)
    return _topk_candidates(cnts, xs, ys, k)


def tier_select_plain(st: TieredState, limit: int, vocab_size: int, used_ids0: int, k: int):
    ctl = st.ctl
    used, done, overflow = (int(v) for v in ctl[[USED, DONE, OVERFLOW]].tolist())
    if done or overflow or used >= min(vocab_size, limit):
        ctl[[NACC, ACTIVE, REFRESH]] = 0
        return
    ctl[ACTIVE] = 1
    T = int(ctl[THRESH])
    cc, cx, cy = _top(st.hkeys, st.hcnts, k)
    refresh = bool(ctl[HOT_OVF]) or int(cc[0]) <= T
    ctl[REFRESH] = int(refresh)
    if refresh:
        cc, cx, cy = _top(st.keys, st.cnts, k)
    acc, zs, n_acc = accept_prefix(cc, cx, cy, used, vocab_size, k, min_count=0 if refresh else T)
    store_rules(st.rules, acc, cx, cy, cc, zs, used_ids0, vocab_size)
    st.cand[:n_acc] = torch.stack([cx, cy, zs, cc], dim=1)[:n_acc].to(torch.int32)
    ctl[USED] = used + n_acc
    ctl[NACC] = n_acc
    if refresh:
        ctl[DONE] = int(n_acc == 0)
    ctl[ROUND] += 1
    ctl[NBAFF] = 0
    ctl[ZLO] = used


def _word_pairs(t, wid, freq, sel):
    """Keys and weights of the counted pairs at positions where ``sel``."""
    fw = (freq[wid.clamp(min=0).long()] * (wid >= 0)).to(torch.int32)
    kx, ky, w = pair_keys_and_weights_fw(t, wid, fw)
    on = (w > 0) & sel
    return (kx[on].long() << 32) | ky[on].long(), w[on]


def apply_blocks_plain(st: TieredState, count_mode: bool, kb1: int, kb2: int):
    ctl, B = st.ctl, st.B
    if count_mode:
        keys, w = _word_pairs(st.tok, st.wid, st.freq, st.tok >= 0)
        _hash_update(st.keys, st.cnts, ctl, OCC, OVERFLOW, keys, w)
        st.sig.copy_(sig_build(st.tok.reshape(-1, B)))
        ctl[LIVE] = int((st.tok >= 0).sum())
        return
    n = int(ctl[NACC])
    if n:
        cx, cy, zs = st.cand[:n, 0], st.cand[:n, 1], st.cand[:n, 2]
        acc = torch.ones(n, dtype=torch.bool, device=st.device)
        rows = torch.nonzero(sig_prefilter(st.sig, acc, cx, cy)).flatten()
        ctl[NBAFF] = rows.numel()
        t2d, w2d = st.tok.reshape(-1, B), st.wid.reshape(-1, B)
        mt, mw = t2d[rows].reshape(-1), w2d[rows].reshape(-1)
        hit, rix = pair_hits(mt, mw, acc, cx, cy)
        affw = torch.zeros(st.freq.shape[0], dtype=torch.bool, device=st.device)
        affw[mw[hit].long()] = True
        old_k, old_w = _word_pairs(mt, mw, st.freq, (mw >= 0) & affw[mw.clamp(min=0).long()])
        mt2, mw2, _ = _apply_rowwise(mt, mw, torch.zeros_like(mt), hit, rix, zs, B)
        new_k, new_w = _word_pairs(mt2, mw2, st.freq, (mw2 >= 0) & affw[mw2.clamp(min=0).long()])
        dk, dv = torch.cat([old_k, new_k]), torch.cat([-old_w, new_w])
        _hash_update(st.keys, st.cnts, ctl, OCC, OVERFLOW, dk, dv, err_i=ERROR)
        if not int(ctl[REFRESH]):
            zlo = int(ctl[ZLO])
            has_z = ((dk >> 32) >= zlo) | ((dk & 0xFFFFFFFF) >= zlo)
            _hash_update(st.hkeys, st.hcnts, ctl, HOCC, HOT_OVF, dk, dv, has_z)
        t2d[rows] = mt2.reshape(-1, B)
        w2d[rows] = mw2.reshape(-1, B)
        st.sig[rows] = sig_build(mt2.reshape(-1, B))
        ctl[LIVE] -= int((mt >= 0).sum() - (mt2 >= 0).sum())
    if int(ctl[ACTIVE]):
        nb = int(ctl[NBAFF])
        ctl[ST_ROUNDS] += 1
        ctl[ST_REFRESH] += ctl[REFRESH]
        ctl[ST_MID] += int(kb1 < nb <= kb2)
        ctl[ST_FULL] += int(nb > kb2)
        ctl[ACTIVE] = 0


def resplit_threshold(cnts: torch.Tensor, boundary: int) -> int:
    """The boundary-th largest count among counts > 0, 0 with fewer."""
    live = cnts[cnts > 0]
    if live.numel() < boundary:
        return 0
    return int(torch.sort(live, descending=True).values[boundary - 1])


def resplit_due(st: TieredState) -> bool:
    """A refresh round merged and did not overflow: T and the hot table are
    rebuilt (the kernels' ``resplit_due``)."""
    refresh, n_acc, overflow = (int(v) for v in st.ctl[[REFRESH, NACC, OVERFLOW]].tolist())
    return bool(refresh and n_acc > 0 and not overflow)


def resplit_plain(st: TieredState, boundary: int):
    ctl = st.ctl
    if not resplit_due(st):
        return
    T = resplit_threshold(st.cnts, boundary)
    ctl[THRESH] = T
    ctl[HOCC] = 0
    ctl[HOT_OVF] = 0
    st.hkeys.fill_(EMPTY)
    st.hcnts.zero_()
    sel = st.cnts > T
    _hash_update(st.hkeys, st.hcnts, ctl, HOCC, HOT_OVF, st.keys[sel], st.cnts[sel])


def fold_plan_plain(st: TieredState):
    """The fold's plan: the rows' fills, their stable order by fill (the
    JAX fold's), and ctl[FOLD_MAX], the largest fill of a pair of the i-th
    emptiest and i-th fullest rows.  Returns (fills, order) as int32."""
    fills = _fills(st.tok, st.B).to(torch.int32)
    fs, order = torch.sort(fills, stable=True)
    half = fs.shape[0] // 2
    st.ctl[FOLD_MAX] = int((fs[:half] + fs.flip(0)[:half]).max())
    return fills, order.to(torch.int32)


# -- wrappers -----------------------------------------------------------------


def _stream_ptr(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _check(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _on(st: TieredState, name: str) -> bool:
    """True for a CUDA state (launch), False for a CPU one (plain)."""
    if st.device.type == "cpu":
        return False
    if st.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {st.device}")
    return True


def tier_select(st: TieredState, limit: int, vocab_size: int, used_ids0: int, k: int = K_MAX):
    """One round's selection: the hot table's candidates above T, or on a
    refresh round the full table's; accept_prefix and store_rules.  A no-op
    once the round loop stopped (done, overflow, or ``used`` at
    ``min(vocab_size, limit)``)."""
    if not 0 < k <= K_MAX:
        raise ValueError(f"batch_k must be in 1..{K_MAX}, got {k}")
    if not _on(st, "tier_select"):
        return tier_select_plain(st, limit, vocab_size, used_ids0, k)
    lib = _cuda.load_tiered()
    with torch.cuda.device(st.device):
        err = lib.yttm_tiered_select(
            st.keys.data_ptr(), st.cnts.data_ptr(), st.cap, st.hkeys.data_ptr(),
            st.hcnts.data_ptr(), st.hslots, st.blk_hi.data_ptr(), st.blk_lo.data_ptr(),
            select_blocks(st.hslots, st.device), select_blocks(st.cap, st.device), st.ticket.data_ptr(),
            st.ctl.data_ptr(), st.cand.data_ptr(),
            st.rules.data_ptr(), int(limit), int(vocab_size), int(used_ids0), int(k),
            _stream_ptr(st.device),
        )
    _check(err, "tier_select")
    tier_select.launches += 1


def apply_blocks(st: TieredState, kb1: int = 0, kb2: int = 0, count_mode: bool = False):
    """Merge the round's accepted candidates into the rows that may hold
    them, with both tables' deltas and the rows' signatures; count the
    round's stats against the tier sizes ``kb1``/``kb2``; ``ctl[LIVE]`` less
    the tokens the merges removed.  ``count_mode``: count every row's pairs
    into the (emptied) full table instead, rebuild every signature and set
    ``ctl[LIVE]`` to the stream's live tokens."""
    if count_mode:
        st.keys.fill_(EMPTY)
        st.cnts.zero_()
        st.ctl[[OCC, OVERFLOW, LIVE]] = 0
    if not _on(st, "apply_blocks"):
        return apply_blocks_plain(st, count_mode, kb1, kb2)
    lib = _cuda.load_tiered()
    with torch.cuda.device(st.device):
        err = lib.yttm_tiered_apply(
            st.tok.data_ptr(), st.wid.data_ptr(), st.freq.data_ptr(), st.sig.data_ptr(), st.B,
            st.NB, st.rows.data_ptr(), st.hits.data_ptr(), st.ctl.data_ptr(), st.cand.data_ptr(),
            st.keys.data_ptr(), st.cnts.data_ptr(), st.cap, st.hkeys.data_ptr(),
            st.hcnts.data_ptr(), st.hslots, int(count_mode), int(kb1), int(kb2),
            _stream_ptr(st.device),
        )
    _check(err, "apply_blocks")
    apply_blocks.launches += 1


def resplit(st: TieredState, hcap: int):
    """After a refresh round that merged: T at rank hcap/2 of the full
    table and the hot table rebuilt from the keys above it (a no-op after
    any other round).  The kernel counts its runs on the card
    (``count_resplits``), not this call."""
    if not _on(st, "resplit"):
        return resplit_plain(st, hcap // 2)
    lib = _cuda.load_tiered()
    with torch.cuda.device(st.device):
        err = lib.yttm_tiered_resplit(
            st.keys.data_ptr(), st.cnts.data_ptr(), st.cap, st.hkeys.data_ptr(),
            st.hcnts.data_ptr(), st.hslots, st.ctl.data_ptr(), st.sel.data_ptr(),
            st.slots.data_ptr(), st.slots.numel(), st.cand.data_ptr(), hcap // 2,
            _stream_ptr(st.device),
        )
    _check(err, "resplit")


def count_resplits(st: TieredState) -> int:
    """Add the resplit kernel's runs on the card since the last call to
    ``resplit.launches`` (a read of the card: call it where the host waits
    anyway).  Returns the state's runs so far; 0 on a CPU state."""
    if st.device.type != "cuda":
        return 0
    runs = int(st.sel[SEL_RUNS])
    resplit.launches += runs - st.runs_seen
    st.runs_seen = runs
    return runs


class _RoundGraph:
    """An instantiated round graph (``yttm_tiered_graph``) and the state's
    buffers and sizes it was built over."""

    def __init__(self, lib, handle: int, key: tuple):
        self.lib, self.handle, self.key = lib, handle, key

    def __del__(self):
        self.lib.yttm_tiered_graph_free(self.handle)


def _round_graph(st: TieredState, limit, vocab_size, used_ids0, k, hcap, kb1, kb2):
    """The state's round graph, built anew when a buffer or size changed."""
    hn_blk, fn_blk = select_blocks(st.hslots, st.device), select_blocks(st.cap, st.device)
    args = (
        st.keys.data_ptr(), st.cnts.data_ptr(), st.cap, st.hkeys.data_ptr(), st.hcnts.data_ptr(),
        st.hslots, st.blk_hi.data_ptr(), st.blk_lo.data_ptr(), hn_blk, fn_blk,
        st.ticket.data_ptr(), st.ctl.data_ptr(), st.cand.data_ptr(), st.rules.data_ptr(),
        int(limit), int(vocab_size), int(used_ids0), int(k), st.tok.data_ptr(),
        st.wid.data_ptr(), st.freq.data_ptr(), st.sig.data_ptr(), st.B, st.NB,
        st.rows.data_ptr(), st.hits.data_ptr(), int(kb1), int(kb2), st.sel.data_ptr(),
        st.slots.data_ptr(), st.slots.numel(), hcap // 2,
    )
    key = args[:14] + args[15:]  # all but limit, which a replay sets
    if st.round_graph is None or st.round_graph.key != key:
        lib = _cuda.load_tiered()
        handle = ctypes.c_void_p()
        _check(lib.yttm_tiered_graph(ctypes.byref(handle), *args), "tier_rounds graph")
        st.round_graph = _RoundGraph(lib, handle.value, key)
    return st.round_graph


def tier_rounds(st: TieredState, n: int, limit: int, vocab_size: int, used_ids0: int, k: int,
                hcap: int, kb1: int, kb2: int):
    """n rounds: on a CUDA state the round graph replayed n times (one call;
    a round after the loop stopped is a no-op), counted as n launches of
    tier_select's and apply_blocks' kernels; on a CPU state the plain
    versions, resplit's only on the rounds where it is due."""
    if not 0 < k <= K_MAX:
        raise ValueError(f"batch_k must be in 1..{K_MAX}, got {k}")
    if not _on(st, "tier_rounds"):
        for _ in range(n):
            tier_select_plain(st, limit, vocab_size, used_ids0, k)
            apply_blocks_plain(st, False, kb1, kb2)
            if resplit_due(st):
                resplit_plain(st, hcap // 2)
        return
    with torch.cuda.device(st.device):
        g = _round_graph(st, limit, vocab_size, used_ids0, k, hcap, kb1, kb2)
        err = g.lib.yttm_tiered_graph_launch(g.handle, int(n), int(limit), _stream_ptr(st.device))
    _check(err, "tier_rounds")
    tier_select.launches += n
    apply_blocks.launches += n


def rounds_per_call(st: TieredState, n: int, limit: int, vocab_size: int, used_ids0: int, k: int,
                    hcap: int, kb1: int, kb2: int):
    """``tier_rounds`` through the per-call wrappers: tier_select,
    apply_blocks and resplit each round (resplit a no-op where not due)."""
    for _ in range(n):
        tier_select(st, limit, vocab_size, used_ids0, k)
        apply_blocks(st, kb1, kb2)
        resplit(st, hcap)


def fold_due(st: TieredState, live: int) -> bool:
    """The JAX host loop's fold trigger (``fold_wanted``) at a segment end
    with ``live`` tokens (``ctl[LIVE]``): more rows than
    ``YTTM_TRAIN_FOLD_MIN`` and the live tokens under 45 % of the slots.
    Only then does the fold's plan run."""
    return st.NB >= 2 and fold_wanted(st.NB * st.B, st.B, live)


def fold_plan(st: TieredState):
    """The fold's plan (``fold_plan_plain``'s function) in one cooperative
    launch on a CUDA state, its plain version on a CPU one.  Returns
    (fills, order)."""
    if not _on(st, "fold_rows"):
        return fold_plan_plain(st)
    lib = _cuda.load_tiered()
    B, NB, dev = st.B, st.NB, st.device
    fills = torch.empty(NB, dtype=torch.int32, device=dev)
    order = torch.empty(NB, dtype=torch.int32, device=dev)
    blocks = min(-(-NB // FOLD_BLOCK_ROWS), FOLD_MAX_BLOCKS)
    ghist = torch.empty((B + 1) * (blocks + 1), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.yttm_tiered_fold_plan(
            st.tok.data_ptr(), B, NB, fills.data_ptr(), ghist.data_ptr(), order.data_ptr(),
            st.ctl.data_ptr(), st.sel.data_ptr(), _stream_ptr(dev),
        )
    _check(err, "fold_rows")
    fold_rows.launches += 1
    return fills, order


def fold_rows_plain(st: TieredState, live: int) -> bool:
    if not fold_due(st, live):
        return False
    fold_plan_plain(st)
    if int(st.ctl[FOLD_MAX]) > st.B:
        return False
    st.set_stream(*_fold_rows(st.tok, st.wid, st.B))
    return True


def fold_rows(st: TieredState, live: int) -> bool:
    """The JAX host loop's row fold at a segment end with ``live`` tokens:
    when ``fold_due`` holds, the plan; when the emptiest/fullest row pairs
    fit a row, the rows folded into half as many.  Returns whether it
    folded.  ``fold_rows.launches`` counts the plan's launches."""
    if not _on(st, "fold_rows"):
        return fold_rows_plain(st, live)
    if not fold_due(st, live):
        return False
    fills, order = fold_plan(st)
    if int(st.ctl[FOLD_MAX]) > st.B:
        return False
    B, NB, dev = st.B, st.NB, st.device
    tok2 = torch.empty(NB // 2 * B, dtype=torch.int32, device=dev)
    wid2 = torch.empty(NB // 2 * B, dtype=torch.int32, device=dev)
    sig2 = torch.empty((NB // 2, SIG_W), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _cuda.load_tiered().yttm_tiered_fold_write(
            st.tok.data_ptr(), st.wid.data_ptr(), fills.data_ptr(), order.data_ptr(), B, NB,
            tok2.data_ptr(), wid2.data_ptr(), sig2.data_ptr(), _stream_ptr(dev),
        )
    _check(err, "fold_rows")
    st.set_stream(tok2, wid2, sig2)
    return True


# launches of the CUDA kernels through each wrapper (plain calls not counted)
tier_select.launches = 0
apply_blocks.launches = 0
resplit.launches = 0  # runs on the card (count_resplits), not calls
fold_rows.launches = 0


# -- host loop ----------------------------------------------------------------


class TieredKernelEngine:
    """Segments of rounds through the four kernels, for
    ``train_tiered.run_training_tiered``.  The full table has 2 * pcap slots
    (the JAX host loop's pcap, ``YTTM_TRAIN_PCAP`` included) and is rebuilt
    from the stream when more than half of them are taken (``regrow``);
    the hot table has 2 * hcap slots.  KB1/KB2 only class the rounds in
    the stats, as the JAX program's tiers do.  ``graph`` picks the route of
    a batch of rounds: ``tier_rounds`` (the round graph; on the CPU, resplit
    only where due) or ``rounds_per_call``."""

    def __init__(self, t, wid, freq, rules, used_ids0, vocab_size, batch_k, B, device):
        self.vocab_size, self.used_ids0, self.batch_k = vocab_size, used_ids0, batch_k
        m, merges = int(np.asarray(t).shape[0]), vocab_size - used_ids0
        used = int(np.count_nonzero(np.asarray(rules)[:, 2] >= 0)) + used_ids0
        # the JAX host loop sizes pcap from the initial pair kinds, counted on
        # the host; here the first count gives them: size for none, count,
        # and count again only when they call for larger tables
        self.sizes = tier_sizes(m // B, B, 0, m, merges)
        self.st = TieredState(t, wid, freq, rules, used, B, *self._slots(), device)
        self.rebuilds = 0
        self.folds = 0
        self.graph = True
        self._count()
        sizes = tier_sizes(m // B, B, int(self.st.ctl[OCC]), m, merges)
        if sizes != self.sizes:
            self.sizes = sizes
            cap, hslots = self._slots()
            self.st.resize(max(cap, self.st.cap), hslots)
            self._count()
        self.hcap = self.sizes["hcap"]

    def _slots(self):
        return _next_pow2(2 * self.sizes["pcap"]), _next_pow2(2 * self.sizes["hcap"])

    @property
    def rules(self):
        return self.st.rules

    @property
    def stats(self):
        return [int(v) for v in self.st.ctl[ST_ROUNDS : ST_FULL + 1].tolist()]

    def _kb(self):
        NB = self.st.NB
        kb1 = min(self.sizes["KB1"], NB)
        kbm = min(max(self.sizes["KBm"], kb1), NB)
        return kb1, min(max(self.sizes["KB2"], kbm), NB)

    def _count(self):
        """Count the stream into an empty full table (doubling it until the
        count fits in half of it); the next round refreshes."""
        while True:
            apply_blocks(self.st, count_mode=True)
            if not int(self.st.ctl[OVERFLOW]):
                break
            self.st.resize(self.st.cap * 2, self.st.hslots)
        self.st.ctl[HOT_OVF] = 1

    def segment(self, used: int, limit: int):
        st = self.st
        on_card = st.device.type == "cuda"
        st.ctl[ST_ROUNDS : ST_FULL + 1] = 0
        kb1, kb2 = self._kb()
        rounds = tier_rounds if self.graph else rounds_per_call
        while True:
            # each round that merges accepts at most batch_k ids, so this
            # many rounds never run past the segment's end
            n = max(1, math.ceil((limit - used) / self.batch_k)) if on_card else 1
            rounds(st, n, limit, self.vocab_size, self.used_ids0, self.batch_k, self.hcap, kb1, kb2)
            used, done, overflow, error, live = (
                int(v) for v in st.ctl[[USED, DONE, OVERFLOW, ERROR, LIVE]].tolist()
            )
            if error:
                raise RuntimeError("training table lost a pair: subtracted a missing key")
            if done or overflow or used >= min(limit, self.vocab_size):
                break
        count_resplits(st)
        if not overflow and fold_rows(st, live):
            self.folds += 1
        return used, bool(done), bool(overflow)

    def regrow(self):
        """After an overflow: rebuild the full table from the stream (which
        drops the count-0 slots), at twice the size when the live pairs
        fill more than a quarter of it; the next round refreshes."""
        self.rebuilds += 1
        n_live = int((self.st.cnts > 0).sum())
        self.st.resize(self.st.cap * 2 if 4 * n_live > self.st.cap else self.st.cap, self.st.hslots)
        # the JAX host loop's line; pcap is half the slots
        print(f"pair-count table overflow: retrying with pcap={self.st.cap // 2}", file=sys.stderr)
        self.st.ctl[OVERFLOW] = 0
        self._count()

    def stream(self):
        return self.st.tok, self.st.wid, self.st.freq
