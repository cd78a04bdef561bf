"""The v2 delta trainer's round as hand-written kernels, and the loop that drives them.

The JAX program ``youtokentome_tpu/ops/train_delta.py:210
train_rounds_delta`` sorts the whole stream and the whole table every
round, because scatters serialise on a TPU.  On a card the round is
hand-written CUDA (``csrc/train_delta.cu``, and the top-k of
``csrc/train_topk.cu`` that every trainer but v5 shares) over a state that
needs no sort:

  * a word-laid stream: word w owns ``tok[off[w], off[w+1]-1)``, live
    tokens first, PAD after them, and one PAD separator at the end.  A
    merge compacts inside its word; words never move;
  * an open-addressing pair-count table, int64 keys ``x << 32 | y`` and
    int32 counts; a key keeps its slot when its count falls to 0 (the
    top-k takes counts > 0 only) until the next rebuild, which comes when
    more than half the slots are taken.

  pair_count   count every pair into an empty table (start, and rebuild
               after an overflow): a flat walk of the stream, each block
               counting into a table of its own in shared memory first
  topk_accept  top-16 live entries in the reference order, accept_prefix,
               store_rules; writes ``cand``, ``rules``, ``ctl`` and ``work``
               (v1, v3, v4 and v0, with k = 1, call it too)
  apply_delta  one launch: the words with a hit found, merged and
               compacted in place, the table moved by their net deltas
  relay        at a segment end where the live tokens fill less than half
               the stream's slots: the stream laid out again over them (the
               JAX host loop slices its stream there)

``ctl`` (int32 [8]) holds the round control on the device, so the host
enqueues rounds in batches and reads ``ctl`` once per batch.  Every
trainer's ``ctl`` but v5's opens with the slots USED .. ERROR below
(``csrc/train_common.cuh``); its own follow from CTL_OWN.  ``work`` (int64)
sums what the rounds' data gives the kernels, for the bounds.  Each wrapper
launches its kernel on a CUDA tensor (and counts the launch) and runs its
plain torch version on a CPU tensor; the plain versions compute the same
function, so the kernel and its plain version leave the same multiset of
table entries, the same stream and the same ``ctl`` (but for a
``pair_count`` that overflows: its table is left unfinished, to be
counted again at twice the size).
"""

from __future__ import annotations

import functools
import math
import os

import numpy as np
import torch

from . import _cuda
from .train_delta import _next_pow2
from .train_stream import (
    PAD,
    _last_index,
    _shift_left,
    _topk_candidates,
    accept_prefix,
    store_rules,
)

USED, DONE, OVERFLOW, ROUND, NACC, OCC, ERROR, CTL_OWN = range(8)
NAFF = CTL_OWN  # v2's own slot: the round's listed words
# work: summed over the active rounds by the top-k; a trainer's own from W_OWN
W_ROUNDS, W_OCC, W_SLOTS, W_OWN = range(4)
EMPTY = -1  # int64 all ones: the key of an empty slot
K_MAX = 16  # the kernels' candidates per round
BATCH = 1024  # rounds an engine enqueues between two reads of ctl
# the selection's grid (csrc/train_common.cuh grid_topk): a 256-thread block
# per 1024 slots, at most SEL_BLOCKS_PER_SM on each SM (the kernels'
# __launch_bounds__: two blocks an SM fit their registers), and at most
# SEL_MAX_BLOCKS (kSelMaxBlocks: the lists the last block can pick from)
SEL_SLOTS, SEL_BLOCKS_PER_SM, SEL_MAX_BLOCKS = 1024, 2, 512


@functools.lru_cache(maxsize=None)
def _sel_max_blocks(device: torch.device) -> int:
    """The selection's most blocks on ``device``: two an SM of a card,
    SEL_MAX_BLOCKS on the CPU (where the plain versions use no scratch)."""
    if device.type != "cuda":
        return SEL_MAX_BLOCKS
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return min(SEL_MAX_BLOCKS, SEL_BLOCKS_PER_SM * sms)


def select_blocks(slots: int, device) -> int:
    """Blocks of the selection over a table of ``slots`` on ``device``: the
    number of lists of K_MAX words its scratch holds."""
    return max(1, min(_sel_max_blocks(torch.device(device)), -(-slots // SEL_SLOTS)))


def select_scratch(n_blk: int, device):
    """The selection's scratch for ``n_blk`` blocks: each block's K_MAX
    words (hi int64, lo int32) and the ticket of the last block (0 between
    launches)."""
    return (torch.empty(n_blk * K_MAX, dtype=torch.int64, device=device),
            torch.empty(n_blk * K_MAX, dtype=torch.int32, device=device),
            torch.zeros(1, dtype=torch.int32, device=device))


class TableState:
    """The open-addressing pair-count table of a kernel trainer's state:
    ``keys`` (int64, EMPTY when free) and ``cnts`` (int32) of ``cap``
    slots, with the top-k's scratch, and the round control.  The
    state sets ``device``; ``n_own`` of its ``ctl`` slots from CTL_OWN start
    every round at 0."""

    n_own = 0

    def control(self, rules, used: int, ctl_n: int = 8):
        """``rules`` (a copy), ``ctl``, ``cand`` and ``work`` on the device."""
        dev = self.device
        self.rules = torch.from_numpy(np.array(rules, np.int32)).to(dev)
        self.ctl = torch.zeros(ctl_n, dtype=torch.int32, device=dev)
        self.ctl[USED] = used
        self.cand = torch.zeros((K_MAX, 4), dtype=torch.int32, device=dev)
        self.work = torch.zeros(8, dtype=torch.int64, device=dev)

    def resize(self, cap: int):
        """An empty table of ``cap`` slots (a power of two)."""
        self.cap = cap
        self.keys = torch.full((cap,), EMPTY, dtype=torch.int64, device=self.device)
        self.cnts = torch.zeros(cap, dtype=torch.int32, device=self.device)
        self.n_blk = select_blocks(cap, self.device)
        self.blk_hi, self.blk_lo, self.ticket = select_scratch(self.n_blk, self.device)

    def table(self):
        """The table's slots as a sorted (key, count) multiset (numpy),
        count-0 slots included."""
        keys = self.keys.cpu().numpy()
        cnts = self.cnts.cpu().numpy()
        used = keys != EMPTY
        order = np.argsort(keys[used], kind="stable")
        return keys[used][order], cnts[used][order]


def initial_cap(m: int) -> int:
    """A kernel engine's first table: twice ``YTTM_TRAIN_PCAP`` slots when
    it is set, else a 32nd of the stream's ``m`` slots (at least 2^14)."""
    pcap = int(os.environ.get("YTTM_TRAIN_PCAP", "0"))
    return _next_pow2(2 * pcap) if pcap else _next_pow2(max(1 << 14, m >> 5))


def rules_used(rules, used_ids0: int) -> int:
    """The ids a (possibly resumed) rule array already holds."""
    return int(np.count_nonzero(np.asarray(rules)[:, 2] >= 0)) + used_ids0


class TrainState(TableState):
    """The kernel trainer's state on one device (see the module note)."""

    n_own = 1  # NAFF

    def __init__(self, t, wid, freq, rules, used: int, cap: int, device):
        t = np.asarray(t)
        wid = np.asarray(wid)
        live = wid >= 0
        tl = t[live].astype(np.int32)
        wl = wid[live].astype(np.int64)
        starts = np.flatnonzero(np.concatenate([[True], wl[1:] != wl[:-1]])) if wl.size else (
            np.zeros(0, np.int64)
        )
        lens = np.diff(np.append(starts, wl.size))
        n_words = starts.size
        off = np.zeros(n_words + 1, np.int64)
        np.cumsum(lens + 1, out=off[1:])
        word_of = np.repeat(np.arange(n_words), lens)
        pos = off[word_of] + (np.arange(wl.size) - starts[word_of])
        mw = int(off[-1])
        tok = np.full(max(mw, 2), PAD, np.int32)
        tok[pos] = tl
        pwid = np.full(max(mw, 2), -1, np.int32)
        pwid[pos] = word_of
        self.wids = wl[starts].astype(np.int32)  # the stream's word id of each word
        freq = np.asarray(freq, np.int32)

        dev = torch.device(device)
        self.device = dev
        self.n_words = n_words
        self.freq = torch.from_numpy(freq).to(dev)
        self.tok = torch.from_numpy(tok).to(dev)
        self.pwid = torch.from_numpy(pwid).to(dev)
        self.off = torch.from_numpy(off.astype(np.int32)).to(dev)
        self.fw = torch.from_numpy(freq[self.wids]).to(dev)
        self.control(rules, used)
        self.wmark = torch.zeros(max(n_words, 1), dtype=torch.int32, device=dev)
        self.resize(cap)

    def stream(self):
        """The live stream, front-compacted as the JAX trainer keeps it:
        (t, wid) with the stream's own word ids."""
        live = self.tok >= 0
        wids = torch.from_numpy(self.wids).to(self.device)
        return self.tok[live], wids[self.pwid[live].long()]


# -- plain torch versions -----------------------------------------------------


def _counted_pairs(tok: torch.Tensor):
    """Per position: int64 key of (tok[i], tok[i+1]) and whether the pair
    counts (both live, run parity inside runs of equal tokens)."""
    m = tok.shape[0]
    idx = torch.arange(m, device=tok.device)
    nxt = _shift_left(tok, PAD)
    valid = (tok >= 0) & (nxt >= 0)
    eq = valid & (tok == nxt)
    counted = valid & (~eq | ((idx - _last_index(~eq) - 1) % 2 == 0))
    return (tok.long() << 32) | nxt.long().clamp(min=0), counted


def _table_add(keys, cnts, ctl, dk: torch.Tensor, dv: torch.Tensor, occ_slot=OCC, ovf_slot=OVERFLOW):
    """Add dv per key into the table ``keys``/``cnts``: present keys add,
    missing keys (net delta > 0) take empty slots and count toward the
    occupancy ``ctl[occ_slot]``; ``ctl[ovf_slot]`` set as the kernel sets
    it (occupancy above half the table, or full)."""
    if dk.numel() == 0:
        return
    uk, inv = torch.unique(dk, sorted=True, return_inverse=True)
    ud = torch.zeros(uk.shape[0], dtype=torch.int64, device=dk.device).index_add_(0, inv, dv.long())
    slots = torch.nonzero(keys != EMPTY).flatten()
    present = torch.zeros(uk.shape[0], dtype=torch.bool, device=dk.device)
    if slots.numel():
        sk, order = torch.sort(keys[slots])
        slots = slots[order]
        where = torch.searchsorted(sk, uk).clamp(max=sk.numel() - 1)
        present = sk[where] == uk
        cnts.index_add_(0, slots[where[present]], ud[present].to(torch.int32))
    new_k, new_d = uk[~present], ud[~present]
    if bool((new_d <= 0).any()):
        ctl[ERROR] = 1  # a subtraction from a pair the table lacks
    free = torch.nonzero(keys == EMPTY).flatten()
    fit = min(free.numel(), new_k.numel())
    keys[free[:fit]] = new_k[:fit]
    cnts[free[:fit]] = new_d[:fit].to(torch.int32)
    occ = int(ctl[occ_slot]) + fit
    ctl[occ_slot] = occ
    if fit < new_k.numel() or 2 * occ > keys.shape[0]:
        ctl[ovf_slot] = 1


def _table_update(st: TrainState, dk: torch.Tensor, dv: torch.Tensor):
    """``_table_add`` into the state's table."""
    _table_add(st.keys, st.cnts, st.ctl, dk, dv)


def pair_count_plain(st: TrainState):
    counted_keys, counted = _counted_pairs(st.tok)
    w = st.fw[st.pwid.clamp(min=0).long()]
    _table_update(st, counted_keys[counted], w[counted])


def round_active(st, limit: int, vocab_size: int) -> bool:
    """The round loop of a kernel state still runs: not done, no overflow,
    and ``used`` below ``min(vocab_size, limit)``."""
    used, done, overflow = (int(v) for v in st.ctl[[USED, DONE, OVERFLOW]].tolist())
    return not done and not overflow and used < min(vocab_size, limit)


def topk_accept_plain(st: TableState, limit: int, vocab_size: int, used_ids0: int, k: int):
    st.ctl[CTL_OWN : CTL_OWN + st.n_own] = 0
    if not round_active(st, limit, vocab_size):
        st.ctl[NACC] = 0
        return
    used = int(st.ctl[USED])
    live = st.keys != EMPTY
    xs = torch.where(live, st.keys >> 32, torch.zeros_like(st.keys)).to(torch.int32)
    ys = torch.where(live, st.keys & 0xFFFFFFFF, torch.zeros_like(st.keys)).to(torch.int32)
    cc, cx, cy = _topk_candidates(st.cnts, xs, ys, k)
    acc, zs, n_acc = accept_prefix(cc, cx, cy, used, vocab_size, k)
    store_rules(st.rules, acc, cx, cy, cc, zs, used_ids0, vocab_size)
    st.cand[:n_acc] = torch.stack([cx, cy, zs, cc], dim=1)[:n_acc].to(torch.int32)
    st.ctl[USED] = used + n_acc
    st.ctl[DONE] = int(n_acc == 0)
    st.ctl[NACC] = n_acc
    st.ctl[ROUND] += 1
    st.work[W_ROUNDS] += 1
    st.work[W_OCC] += int(st.ctl[OCC])
    st.work[W_SLOTS] += st.cap


def order_words(cnt: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor, wide: bool = False):
    """The selection kernels' words for the reference order
    (``csrc/train_common.cuh`` NarrowOrder, WideOrder): a larger word ranks
    first, a dead entry (count <= 0) is the smallest.  Narrow, for ids below
    65536: the unsigned 64-bit word ``count << 33 | (0xFFFF - max) << 17 |
    (0xFFFF - min) << 1 | (x == max)`` (0 when dead), returned as one int64
    tensor less 2**63, which keeps its order.  Wide: (hi, lo) int64 tensors,
    ``count << 31 | (2**31 - 1 - max)`` and ``(2**31 - 1 - min) << 1 | (x ==
    max)``, compared hi first."""
    live = cnt > 0
    c = torch.where(live, cnt, torch.zeros_like(cnt)).long()
    x, y = xs.long(), ys.long()
    mx, mn = torch.maximum(x, y), torch.minimum(x, y)
    xbit = (x == mx).long()
    zero = torch.zeros_like(c)
    if not wide:
        rest = torch.where(live, ((0xFFFF - mx) << 17) | ((0xFFFF - mn) << 1) | xbit, zero)
        return (c - (1 << 30)) * (1 << 33) + rest
    hi = torch.where(live, (c << 31) | (0x7FFFFFFF - mx), zero)
    lo = torch.where(live, ((0x7FFFFFFF - mn) << 1) | xbit, zero)
    return hi, lo


def words_decode(words, wide: bool = False):
    """(cc, cx, cy) int32 of ``order_words``' words; a dead word gives count
    0 (and ids that mean nothing)."""
    if not wide:
        c = (words >> 33) + (1 << 30)
        mx = 0xFFFF - ((words >> 17) & 0xFFFF)
        mn = 0xFFFF - ((words >> 1) & 0xFFFF)
        xbit = (words & 1).bool()
    else:
        hi, lo = words
        c = hi >> 31
        mx = 0x7FFFFFFF - (hi & 0x7FFFFFFF)
        mn = 0x7FFFFFFF - (lo >> 1)
        xbit = (lo & 1).bool()
    cx = torch.where(xbit, mx, mn)
    cy = torch.where(xbit, mn, mx)
    return c.to(torch.int32), cx.to(torch.int32), cy.to(torch.int32)


def merge_listed_plain(st: TrainState):
    """apply_delta's merge, plain: lists the words with an accepted pair
    (``ctl[NAFF]``), merges and compacts them in ``st.tok``.  Returns the
    stream before and after, the listed words' positions and each
    position's word weight, for the caller's contributions."""
    n_acc = int(st.ctl[NACC])
    cx, cy, zs = st.cand[:n_acc, 0], st.cand[:n_acc, 1], st.cand[:n_acc, 2]
    t = st.tok.clone()
    m = t.shape[0]
    idx = torch.arange(m, device=t.device)
    nxt = _shift_left(t, PAD)
    valid = (t >= 0) & (nxt >= 0)
    hitk = valid[:, None] & (t[:, None] == cx[None, :]) & (nxt[:, None] == cy[None, :])
    hit = hitk.any(dim=1)
    rix = hitk.to(torch.int8).argmax(dim=1)
    pw = st.pwid.long()
    aff_w = torch.zeros(st.n_words, dtype=torch.bool, device=t.device)
    aff_w[pw[hit]] = True
    aff = (pw >= 0) & aff_w[pw.clamp(min=0)]
    st.ctl[NAFF] = int(aff_w.sum())
    w = st.fw[pw.clamp(min=0)]
    # merge: even offsets inside runs of hits take z, their right
    # neighbours drop, and each word front-compacts in its own slots
    sel = hit & ((idx - _last_index(~hit) - 1) % 2 == 0)
    new_t = torch.where(sel, zs[rix], t)
    kill = torch.cat([torch.zeros(1, dtype=torch.bool, device=t.device), sel[:-1]])
    keep = ~kill & (t >= 0)
    excl = torch.cumsum(keep.long(), 0) - keep.long()
    word_base = excl[st.off[:-1].long()]
    dst = st.off[:-1].long()[pw[keep]] + (excl[keep] - word_base[pw[keep]])
    t2 = torch.full_like(t, PAD)
    t2[dst] = new_t[keep]
    st.tok.copy_(t2)
    return t, t2, aff, w


def apply_delta_plain(st: TrainState):
    if int(st.ctl[NACC]) == 0:
        return
    t, t2, aff, w = merge_listed_plain(st)
    old_keys, old_counted = _counted_pairs(t)
    old = old_counted & aff
    new_keys, new_counted = _counted_pairs(t2)
    new = new_counted & aff
    _table_update(
        st,
        torch.cat([old_keys[old], new_keys[new]]),
        torch.cat([-w[old], w[new]]),
    )


def relay_plain(st: TrainState):
    live = st.tok >= 0
    pw = st.pwid.long()
    dev = st.device
    lens = torch.zeros(st.n_words, dtype=torch.int64, device=dev).index_add_(
        0, pw[live], torch.ones(int(live.sum()), dtype=torch.int64, device=dev)
    ) + 1
    new_off = torch.cumsum(lens, 0) - lens
    mw2 = int(lens.sum())
    tok2 = torch.full((mw2,), PAD, dtype=torch.int32, device=dev)
    pwid2 = torch.full((mw2,), PAD, dtype=torch.int32, device=dev)
    # live tokens are front-packed in their words: a token's rank in its
    # word is its distance from the word's first slot
    pos = torch.nonzero(live).flatten()
    wm = pw[pos]
    dst = new_off[wm] + (pos - st.off[wm].long())
    tok2[dst] = st.tok[pos]
    pwid2[dst] = wm.to(torch.int32)
    off2 = torch.cat([new_off, torch.tensor([mw2], device=dev)]).to(torch.int32)
    st.tok, st.pwid, st.off = tok2, pwid2, off2


# -- wrappers -----------------------------------------------------------------


def _stream_ptr(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _check(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _on(st: TrainState, name: str) -> bool:
    """True for a CUDA state (launch), False for a CPU one (plain)."""
    if st.device.type == "cpu":
        return False
    if st.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {st.device}")
    return True


def pair_count(st: TrainState):
    """Empty the table and count every pair of the stream into it; sets
    ``ctl[OVERFLOW]`` when the table holds more than half its slots."""
    st.keys.fill_(EMPTY)
    st.cnts.zero_()
    st.ctl[OCC] = 0
    st.ctl[OVERFLOW] = 0
    if st.n_words == 0:
        return
    if not _on(st, "pair_count"):
        return pair_count_plain(st)
    lib = _cuda.load_train()
    with torch.cuda.device(st.device):
        err = lib.yttm_train_pair_count(
            st.tok.data_ptr(), st.pwid.data_ptr(), st.fw.data_ptr(), st.tok.shape[0],
            st.keys.data_ptr(), st.cnts.data_ptr(), st.cap, st.ctl.data_ptr(),
            _stream_ptr(st.device),
        )
    _check(err, "pair_count")
    pair_count.launches += 1


def topk_accept(st: TableState, limit: int, vocab_size: int, used_ids0: int, k: int = K_MAX):
    """One round's candidates and acceptance, for every trainer but v5 (a
    no-op once the round loop stopped: done, overflow, or ``used`` at
    ``min(vocab_size, limit)``); zeroes the state's own ``n_own`` slots."""
    if not 0 < k <= K_MAX:
        raise ValueError(f"batch_k must be in 1..{K_MAX}, got {k}")
    if not _on(st, "topk_accept"):
        return topk_accept_plain(st, limit, vocab_size, used_ids0, k)
    lib = _cuda.load_topk()
    with torch.cuda.device(st.device):
        err = lib.yttm_topk_accept(
            st.keys.data_ptr(), st.cnts.data_ptr(), st.cap, st.blk_hi.data_ptr(),
            st.blk_lo.data_ptr(), st.n_blk, st.ticket.data_ptr(), st.ctl.data_ptr(), st.cand.data_ptr(),
            st.rules.data_ptr(), int(limit), int(vocab_size), int(used_ids0), int(k),
            st.n_own, st.work.data_ptr(), _stream_ptr(st.device),
        )
    _check(err, "topk_accept")
    topk_accept.launches += 1


def apply_delta(st: TrainState):
    """Merge the round's accepted candidates into the stream and move the
    table by the affected words' deltas; ``ctl[NAFF]`` counts those words."""
    if not _on(st, "apply_delta"):
        return apply_delta_plain(st)
    lib = _cuda.load_train()
    with torch.cuda.device(st.device):
        err = lib.yttm_train_apply_delta(
            st.tok.data_ptr(), st.pwid.data_ptr(), st.tok.shape[0], st.off.data_ptr(),
            st.fw.data_ptr(), st.keys.data_ptr(), st.cnts.data_ptr(), st.cap, st.ctl.data_ptr(),
            st.cand.data_ptr(), st.wmark.data_ptr(), _stream_ptr(st.device),
        )
    _check(err, "apply_delta")
    apply_delta.launches += 1


def relay(st: TrainState):
    """Lay the stream out again over its live tokens: every word keeps its
    live tokens and a separator, in order.  Reads the new size back (the
    host is at a segment end)."""
    if not _on(st, "relay"):
        return relay_plain(st)
    lib = _cuda.load_train()
    dev, w = st.device, st.n_words
    i32 = dict(dtype=torch.int32, device=dev)
    lens, new_off = torch.empty(w, **i32), torch.empty(w, **i32)
    scratch = torch.empty(lib.yttm_train_relay_scratch(w), **i32)
    totals = torch.zeros(1, **i32)
    stream = _stream_ptr(dev)
    with torch.cuda.device(dev):
        err = lib.yttm_train_relay_plan(
            st.tok.data_ptr(), st.pwid.data_ptr(), st.off.data_ptr(), st.tok.shape[0], w,
            lens.data_ptr(), new_off.data_ptr(), scratch.data_ptr(), totals.data_ptr(), stream,
        )
        _check(err, "relay")
        mw2 = int(totals[0])
        # the scatter writes every slot
        tok2 = torch.empty(mw2, **i32)
        pwid2 = torch.empty(mw2, **i32)
        off2 = torch.empty(w + 1, **i32)
        fw2 = torch.empty(w, **i32)
        err = lib.yttm_train_relay_write(
            st.tok.data_ptr(), st.pwid.data_ptr(), st.tok.shape[0], st.off.data_ptr(),
            st.fw.data_ptr(), w, lens.data_ptr(), new_off.data_ptr(), tok2.data_ptr(),
            pwid2.data_ptr(), off2.data_ptr(), fw2.data_ptr(), mw2, stream,
        )
    _check(err, "relay")
    relay.launches += 1
    st.tok, st.pwid, st.off, st.fw = tok2, pwid2, off2, fw2


# launches of the CUDA kernels through each wrapper (plain calls not counted)
pair_count.launches = 0
topk_accept.launches = 0
apply_delta.launches = 0
relay.launches = 0


# -- host loop ----------------------------------------------------------------


class TableEngine:
    """The host loop of a kernel engine that keeps its exact table across
    rounds (v2 here, v3 in ``sparse_kernels``, v4 in ``block_kernels``):
    the first count doubles the table until it fits in half of it,
    rounds are enqueued in batches with ``ctl`` read once a batch, and an
    overflow rebuilds the table.  A subclass sets ``st``, ``vocab_size``,
    ``used_ids0`` and ``batch_k`` and defines ``count()`` (empty the table
    and count the stream into it) and ``round(limit)``."""

    rebuilds = 0

    @property
    def rules(self):
        return self.st.rules

    def _count(self):
        while True:
            self.count()
            if not int(self.st.ctl[OVERFLOW]):
                return
            self.st.resize(self.st.cap * 2)

    def segment(self, used: int, limit: int):
        st = self.st
        on_card = st.device.type == "cuda"
        while True:
            # each active round accepts at most batch_k ids, so this many
            # rounds never run past the segment's end
            n = max(1, math.ceil((limit - used) / self.batch_k)) if on_card else 1
            for _ in range(n):
                self.round(limit)
            used, done, overflow, error = (
                int(v) for v in st.ctl[[USED, DONE, OVERFLOW, ERROR]].tolist()
            )
            if error:
                raise RuntimeError("training table lost a pair: subtracted a missing key")
            if done or overflow or used >= min(limit, self.vocab_size):
                return used, bool(done), bool(overflow)

    def regrow(self):
        """After an overflow: rebuild the table from the stream, which
        drops the count-0 slots; at twice the size when the live pairs
        fill more than a quarter of it, so that a rebuilt table keeps at
        least a quarter of its slots free for new pairs."""
        self.rebuilds += 1
        n_live = int((self.st.cnts > 0).sum())
        self.st.resize(self.st.cap * 2 if 4 * n_live > self.st.cap else self.st.cap)
        self._count()


class KernelEngine(TableEngine):
    """Segments of rounds through the kernels, for
    ``train_delta.run_training_delta``.  The table starts at
    ``initial_cap`` slots; it is rebuilt when an insert finds it more than
    half full (``regrow``); the stream is relaid at segment ends
    (``segment``)."""

    def __init__(self, t, wid, freq, rules, used_ids0, vocab_size, batch_k, device):
        self.vocab_size = vocab_size
        self.used_ids0 = used_ids0
        self.batch_k = batch_k
        cap = initial_cap(int(np.asarray(t).shape[0]))
        self.st = TrainState(t, wid, freq, rules, rules_used(rules, used_ids0), cap, device)
        self.relaid = []  # (slots before, slots after) of each relay
        self._count()

    def count(self):
        pair_count(self.st)

    def round(self, limit: int):
        topk_accept(self.st, limit, self.vocab_size, self.used_ids0, self.batch_k)
        apply_delta(self.st)

    def segment(self, used: int, limit: int):
        """A segment of rounds; then, when the live tokens fill less than
        half the stream's slots, the stream laid out again over them
        (``relay``): a round reads every slot of the stream, live or not."""
        used, done, overflow = super().segment(used, limit)
        st = self.st
        if not overflow and st.n_words and 2 * int((st.tok >= 0).sum()) < st.tok.shape[0]:
            m = st.tok.shape[0]
            relay(st)
            self.relaid.append((m, st.tok.shape[0]))
        return used, done, overflow

    def stream(self):
        t, wid = self.st.stream()
        return t, wid, self.st.freq
