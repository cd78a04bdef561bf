"""The recounting trainers' count and partitioned fold on the CPU (their
plain torch versions): v1's count against the JAX package's
``_segment_counts_flat(*pair_keys_and_weights(...))`` on the edge stream
that chip_smoke.py feeds the kernel (runs across the flat walk's chunk and
block edges), the sharded counts' part lists, the fold reading only those
lists, and the overflows that the fold must still raise."""

import functools

import chip_smoke
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from youtokentome_tpu.ops.train_stream import _segment_counts_flat as j_segment_counts
from youtokentome_tpu.ops.train_stream import pair_keys_and_weights as j_pair_keys
from youtokentome_tpu_torch.ops import delta_sharded_kernels as dsk
from youtokentome_tpu_torch.ops import recount_sharded_kernels as rsk
from youtokentome_tpu_torch.ops import stream_train_kernels as stk
from youtokentome_tpu_torch.ops import train_kernels as tk
from youtokentome_tpu_torch.ops.train_delta import _next_pow2

BASES = (5, 70000)  # ids from 70000: keys past 16 bits
_JAX_SLOTS, _JAX_WORDS = 1 << 13, 1 << 12  # the JAX count's shape (_jax_count)


@functools.lru_cache(maxsize=None)
def _edge_stream(base):
    return chip_smoke.stream_edge_streams(base, np.random.default_rng(base + 3))[0]


@functools.lru_cache(maxsize=None)
def _word_rows(base):
    """The edge stream's words as v0's rows, a row a word."""
    _, t, wid, freq = _edge_stream(base)
    live = t >= 0
    t, wid = t[live], wid[live]
    cuts = np.searchsorted(wid, np.arange(freq.size + 1))
    return [(t[a:b][None, :], np.asarray([f], np.int32))
            for a, b, f in zip(cuts[:-1], cuts[1:], freq)]


def _jax_count(t, wid, freq):
    """The JAX count of a flat stream, its keys (x << 32 | y) and counts in
    key order.  Every stream is padded (PAD slots after the live end, words
    of frequency 0 no slot names) to one shape, so that JAX compiles once."""
    pad = _JAX_SLOTS - t.size
    t, wid = np.r_[t, np.full(pad, -1, np.int32)], np.r_[wid, np.full(pad, wid[-1], np.int32)]
    freq = np.r_[freq, np.zeros(_JAX_WORDS - freq.size, np.int32)]
    cnt, kx, ky = (np.asarray(a) for a in j_segment_counts(*j_pair_keys(
        jnp.asarray(t), jnp.asarray(wid), jnp.asarray(freq))))
    on = cnt > 0
    keys = (kx[on].astype(np.int64) << 32) | ky[on].astype(np.int64)
    order = np.argsort(keys)
    return keys[order], cnt[on][order]


def _rules(vocab):
    return np.full((vocab, 4), -1, np.int32)


def _stream_shard(t, wid, freq, cap, n):
    return chip_smoke.stream_shard_of(t, wid, freq, "cpu", cap, n)


def _count_all(shards, kernel="stream"):
    count = rsk.stream_shard_count_plain if kernel == "stream" else rsk.bucket_shard_count_plain
    for st in shards:
        count(st, 1 << 30, 1 << 30)


def _clone(st):
    import copy

    c = copy.copy(st)
    for k, v in vars(st).items():
        if isinstance(v, torch.Tensor):
            setattr(c, k, v.clone())
    c._links = None
    return c


@pytest.mark.parametrize("entry", ["recount", "stream_shard_count"])
@pytest.mark.parametrize("base", BASES)
def test_stream_count_matches_jax(entry, base):
    """recount_plain and stream_shard_count_plain fill their tables with the
    JAX package's count of the same flat stream: runs of equal tokens across
    every 128-slot chunk edge of the first 48 (a block's edge every 8th),
    an id equal across a word boundary, one-token words, words of frequency
    0, long runs and a word that ends at the live end, PAD after it."""
    what, t, wid, freq = _edge_stream(base)
    want_k, want_c = _jax_count(t, wid, freq)
    cap = _next_pow2(4 * want_k.size)
    if entry == "recount":
        vocab = int(np.max(t)) + 16
        st = stk.StreamState(t, wid, freq, _rules(vocab), vocab - 8, cap, "cpu")
        stk.recount_plain(st, vocab, vocab)
        keys, cnts = st.table()
        occ, ovf = st.ctl[tk.OCC], st.ctl[tk.OVERFLOW]
    else:
        st = _stream_shard(t, wid, freq, cap, 3)
        _count_all([st])
        keys, cnts = (a.numpy() for a in (st.rkeys, st.rcnts))
        used = keys != tk.EMPTY
        order = np.argsort(keys[used])
        keys, cnts = keys[used][order], cnts[used][order]
        occ, ovf = st.ctl[rsk.ROCC], st.ctl[rsk.ROVF]
    assert int(st.ctl[stk.LIVE]) == int((t >= 0).sum()), what
    np.testing.assert_array_equal(keys, want_k, what)
    np.testing.assert_array_equal(cnts, want_c, what)
    assert int(occ) == want_k.size and int(ovf) == 0


@pytest.mark.parametrize("kernel", ["stream", "bucketed"])
@pytest.mark.parametrize("n", [2, 3, 8])
def test_counts_list_each_entry_in_its_part(kernel, n):
    """After a sharded count (v1's and v0's plain versions), every filled
    scratch slot stands once in the list of its key's part, and nothing
    else does; pcnt counts each part's entries and ROCC their sum."""
    _, t, wid, freq = _edge_stream(70000)
    if kernel == "stream":
        st = _stream_shard(t, wid, freq, 1 << 12, n)
    else:
        st = rsk.BucketedShardState(_word_rows(70000), _rules(70100), 70090, 1 << 12, "cpu", n)
    _count_all([st], kernel)
    filled = torch.nonzero(st.rkeys != tk.EMPTY).flatten()
    assert filled.numel() == int(st.ctl[rsk.ROCC]) > 100
    listed = []
    for p in range(n):
        slots = st.part_list(p)
        assert slots.numel() == int(st.pcnt[p])
        assert bool((dsk.key_part(st.rkeys[slots], n) == p).all())
        listed.append(slots)
    listed = torch.sort(torch.cat(listed)).values
    assert torch.equal(listed, filled)


@pytest.mark.parametrize("n", [3, 8])
def test_fold_reads_only_the_listed_entries(n):
    """shard_part_fold_plain on replica r reads nothing but the entries of
    the shards' part-r lists: with every other scratch slot poisoned (empty
    slots and other parts' slots given keys of part r and large counts), the
    replica comes out as from the clean scratch tables, and equal to the
    whole stream's count once shard_gather has run."""
    _, t, wid, freq = _edge_stream(5)
    live = int((t >= 0).sum())
    cuts = np.searchsorted(wid[:live], np.linspace(0, wid[live - 1] + 1, n + 1)[1:-1])
    shards = []
    for a, b in zip(np.r_[0, cuts], np.r_[cuts, live]):
        shards.append(_stream_shard(np.r_[t[a:b], -1], np.r_[wid[a:b], -1], freq, 1 << 12, n))
    _count_all(shards)
    poison = [chip_smoke.pairs_of_part(n, r, 64, r) for r in range(n)]
    for r in range(n):
        clean = [_clone(s) for s in shards]
        dirty = [_clone(s) for s in shards]
        for s in dirty:
            keep = torch.zeros(s.cap, dtype=torch.bool)
            keep[s.part_list(r)] = True
            bad = torch.nonzero(~keep).flatten()
            xy = torch.from_numpy(poison[r][np.arange(bad.numel()) % len(poison[r])])
            s.rkeys[bad] = (xy[:, 0] << 32) | xy[:, 1]
            s.rcnts[bad] = 1000
        dsk.shard_part_fold_plain(clean[r], clean)
        dsk.shard_part_fold_plain(dirty[r], dirty)
        assert torch.equal(dirty[r].keys, clean[r].keys) and torch.equal(dirty[r].cnts, clean[r].cnts)
        assert torch.equal(dirty[r].ctl, clean[r].ctl)
    for st in shards:
        dsk.shard_part_fold_plain(st, shards)
    for st in shards:
        dsk.shard_gather_plain(st, shards)
    whole = _stream_shard(t, wid, freq, 1 << 12, n)
    _count_all([whole])
    for st in shards:
        assert int(st.ctl[tk.OVERFLOW]) == 0
        live_k = st.keys != tk.EMPTY
        got = sorted(zip(st.keys[live_k].tolist(), st.cnts[live_k].tolist()))
        want_k = whole.rkeys != tk.EMPTY
        assert got == sorted(zip(whole.rkeys[want_k].tolist(), whole.rcnts[want_k].tolist()))


def _fold(shards):
    for st in shards:
        dsk.shard_part_fold_plain(st, shards)
    for st in shards:
        dsk.shard_gather_plain(st, shards)


@pytest.mark.parametrize("case", chip_smoke.FOLD_CASES)
def test_fold_overflows(case):
    """The fold raises OVERFLOW on every replica for a shard whose scratch
    table passed half full (ROVF), for a part that the shards' keys
    together overfill (parts of 21-22 slots, 3 disjoint shards of 8 keys a
    part), and for a list that dropped claims (one shard's 30 keys, all of
    part 0, against 21 slots); in the last case the next count still
    empties every scratch slot, those no list names too."""
    n, cap = chip_smoke.FOLD_PARTS, chip_smoke.FOLD_CAP
    streams = chip_smoke.fold_case_pairs(case)
    shards = [_stream_shard(*chip_smoke.pair_words(s), cap, n) for s in streams]
    _count_all(shards)
    rocc = [int(s.ctl[rsk.ROCC]) for s in shards]
    if case == "scratch overflow":
        assert int(shards[0].ctl[rsk.ROVF]) == 1 and rocc[0] == 36
    else:
        assert not any(int(s.ctl[rsk.ROVF]) for s in shards) and max(rocc) <= cap // 2
    if case == "parts union":
        union = set()
        for s in shards:
            union |= set(s.rkeys[s.rkeys != tk.EMPTY].tolist())
        keys = torch.tensor(sorted(union))
        sizes = [dsk.part_lo(p + 1, cap, n) - dsk.part_lo(p, cap, n) for p in range(n)]
        assert any(int((dsk.key_part(keys, n) == p).sum()) > sizes[p] for p in range(n))
    if case == "list drops claims":
        assert int(shards[0].pcnt[0]) == 30 > dsk.part_lo(1, cap, n)
    _fold(shards)
    for st in shards:
        assert int(st.ctl[tk.OVERFLOW]) == 1, case
    if case == "list drops claims":
        st = shards[0]
        st.ctl[tk.OVERFLOW] = 0
        st.rkeys[st.rkeys == tk.EMPTY] = 7  # slots no list names
        rsk.stream_shard_count_plain(st, 1 << 30, 1 << 30)
        fresh = _stream_shard(*chip_smoke.pair_words(streams[0]), cap, n)
        _count_all([fresh])
        assert torch.equal(torch.sort(st.rkeys).values, torch.sort(fresh.rkeys).values)
