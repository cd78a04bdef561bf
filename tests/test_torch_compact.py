"""v1's apply and v0's count on the CPU (their plain torch versions) against
the JAX package, on the edge inputs that chip_smoke.py feeds the kernels:
the apply round after round into the other of the stream's two buffers,
against ``apply_accepted`` (runs of hits across the flat pass's chunk, warp
and tile edges, 16 candidates, a hit at the live end, an odd number of
rounds); v0's count and the sharded count's tables and lists against
``_segment_counts(*_pair_arrays(...))`` (rows that fill their width, runs of
equal ids, padding rows of frequency 0, buckets of odd width past 1024), and
the bucket table that the count kernel reads its rows from."""

import functools

import chip_smoke
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from youtokentome_tpu.ops.train_kernel import _pair_arrays as j_pair_arrays
from youtokentome_tpu.ops.train_kernel import _segment_counts as j_segment_counts
from youtokentome_tpu.ops.train_stream import apply_accepted as j_apply_accepted
from youtokentome_tpu_torch.ops import bucketed_kernels as bk
from youtokentome_tpu_torch.ops import delta_sharded_kernels as dsk
from youtokentome_tpu_torch.ops import recount_sharded_kernels as rsk
from youtokentome_tpu_torch.ops import stream_train_kernels as stk
from youtokentome_tpu_torch.ops import train_kernels as tk
from youtokentome_tpu_torch.parallel.train_sharded import shard_rows

BASES = (5, 70000)  # ids from 70000: keys past 16 bits


def _rules(vocab):
    return np.full((vocab, 4), -1, np.int32)


@pytest.mark.parametrize("base", BASES)
def test_apply_rounds_match_jax(base):
    """apply_compact's plain version, COMPACT_ROUNDS rounds on the edge
    stream, each round's candidates set as a selection leaves them and the
    buffers turned as the count turns them: after every round the buffer it
    wrote (``t``, ``wid``) equals the JAX ``apply_accepted`` of the JAX
    stream, PAD tail included, the other buffer keeps the round's input, and
    ctl holds the new live count; after the odd last round the stream is
    the second buffer."""
    t, wid, freq, cands = chip_smoke.compact_edge_stream(base, np.random.default_rng(base + 5))
    used = base + chip_smoke.COMPACT_USED
    vocab = used + 16 * chip_smoke.COMPACT_ROUNDS
    st = stk.StreamState(t, wid, freq, _rules(vocab), used, 1 << 14, "cpu")
    jt, jw = jnp.asarray(t), jnp.asarray(wid)
    for r in range(chip_smoke.COMPACT_ROUNDS):
        if r:
            cands = chip_smoke.compact_cands(np.asarray(jt), np.asarray(jw))
        assert len(cands) == 16
        stk.turn(st)
        before = [x.clone() for x in st.stream_of(int(st.ctl[stk.BUF]))]
        chip_smoke.set_round(st, cands, used)
        stk.apply_compact([st])
        c = np.asarray(cands, np.int32)
        zs = jnp.asarray(used + np.arange(16, dtype=np.int32))
        jt, jw = j_apply_accepted(jt, jw, jnp.ones(16, bool), jnp.asarray(c[:, 0]),
                                  jnp.asarray(c[:, 1]), zs)
        np.testing.assert_array_equal(st.t.numpy(), np.asarray(jt), f"round {r}")
        np.testing.assert_array_equal(st.wid.numpy(), np.asarray(jw), f"round {r}")
        assert int(st.ctl[stk.NEXT_LIVE]) == int((np.asarray(jt) >= 0).sum())
        assert int(st.ctl[stk.NEXT_BUF]) == (r + 1) % 2
        kept = st.stream_of(int(st.ctl[stk.BUF]))
        assert all(torch.equal(a, b) for a, b in zip(kept, before)), f"round {r}: input changed"
        used += 16
    assert chip_smoke.COMPACT_ROUNDS % 2 == 1 and st.t.data_ptr() == st.t1.data_ptr()


def test_apply_edge_stream_crosses_every_edge():
    """The edge stream's first round has runs of hits across chunk and warp
    edges and across a tile edge, a pair split by a tile edge, a word
    boundary inside a run at a tile edge, a run from a tile edge, odd and
    even runs, a run of 4,500, and a hit at the live end."""
    t, wid, _, cands = chip_smoke.compact_edge_stream(5, np.random.default_rng(10))
    live = int((t >= 0).sum())
    same = wid[:-1] == wid[1:]
    pairs = set(map(tuple, cands))
    hit = np.array([same[i] and (int(t[i]), int(t[i + 1])) in pairs for i in range(live - 1)]
                   + [False])
    tile = chip_smoke.COMPACT_TILE
    across = [e for e in range(128, live, 128) if hit[e - 1] and hit[e]]
    assert sum(e % 512 != 0 for e in across) > 5 and sum(e % 512 == 0 for e in across) > 5
    assert hit[tile - 1] and not hit[tile] and not hit[tile - 2]  # a pair split by the edge
    assert hit[2 * tile - 2] and not hit[2 * tile - 1] and hit[2 * tile]  # a word boundary
    assert not hit[3 * tile - 1] and hit[3 * tile]  # a run from the edge
    assert 4 * tile in across and hit[live - 2]
    runs = np.diff(np.flatnonzero(np.diff(np.r_[0, hit.astype(int), 0])))[::2]
    assert {r % 2 for r in runs} == {0, 1} and runs.max() >= 4000


@functools.lru_cache(maxsize=None)
def _buckets(base):
    return chip_smoke.row_edge_buckets(base, np.random.default_rng(base + 7))


_j_pairs, _j_counts = jax.jit(j_pair_arrays), jax.jit(j_segment_counts)


def _jax_rows_count(buckets):
    """The JAX count of buckets' rows: keys (x << 32 | y) and counts in key
    order."""
    parts = [_j_pairs(jnp.asarray(m), jnp.asarray(f)) for m, f in buckets]
    cnt, kx, ky = (np.asarray(a) for a in _j_counts(
        *(jnp.concatenate([p[i] for p in parts]) for i in range(3))))
    on = cnt > 0
    keys = (kx[on].astype(np.int64) << 32) | ky[on].astype(np.int64)
    order = np.argsort(keys)
    return keys[order], cnt[on][order]


def _sorted_table(keys, cnts):
    keys, cnts = keys.numpy(), cnts.numpy()
    used = keys != tk.EMPTY
    order = np.argsort(keys[used])
    return keys[used][order], cnts[used][order]


@pytest.mark.parametrize("base", BASES)
def test_bucket_count_matches_jax(base):
    """bucket_count_plain fills its table with the JAX count of the edge
    rows."""
    buckets = _buckets(base)
    want_k, want_c = _jax_rows_count(buckets)
    st = bk.BucketedState(buckets, _rules(base + 40), base + 30, 1 << 12, "cpu")
    bk.bucket_count_plain(st, base + 40, base + 40)
    keys, cnts = _sorted_table(st.keys, st.cnts)
    np.testing.assert_array_equal(keys, want_k)
    np.testing.assert_array_equal(cnts, want_c)
    assert int(st.ctl[tk.OCC]) == want_k.size > 30 and not int(st.ctl[tk.OVERFLOW])


@pytest.mark.parametrize("n", [3, 4])
@pytest.mark.parametrize("base", BASES)
def test_bucket_shard_count_matches_jax(base, n):
    """bucket_shard_count_plain on each of n shards of the edge rows (odd
    slot counts a bucket at 3 shards): its scratch table is the JAX count of
    its rows, and its lists name every filled slot once, in its key's
    part."""
    shards = shard_rows(_buckets(base), n)
    for d, rows in enumerate(shards):
        want_k, want_c = _jax_rows_count(rows)
        st = rsk.BucketedShardState(rows, _rules(base + 40), base + 30, 1 << 12, "cpu", n)
        rsk.bucket_shard_count_plain(st, base + 40, base + 40)
        keys, cnts = _sorted_table(st.rkeys, st.rcnts)
        np.testing.assert_array_equal(keys, want_k, f"shard {d}")
        np.testing.assert_array_equal(cnts, want_c, f"shard {d}")
        listed = []
        for p in range(n):
            slots = st.part_list(p)
            assert slots.numel() == int(st.pcnt[p])
            assert bool((dsk.key_part(st.rkeys[slots], n) == p).all())
            listed.append(slots)
        assert torch.equal(torch.sort(torch.cat(listed)).values,
                           torch.nonzero(st.rkeys != tk.EMPTY).flatten())


@pytest.mark.parametrize("n", [1, 3])
def test_bucket_table_names_each_slot_row(n):
    """The bucket table (RowBucket rows) gives every slot the row that the
    rows' offsets (each bucket's width, row after row) give it, and marks a
    slot last of its row exactly where the row ends: the kernel's walk,
    emulated on the host, shift and division as it takes them."""
    st = rsk.BucketedShardState(shard_rows(_buckets(5), n)[0], _rules(50), 40, 1 << 12, "cpu", n)
    tab = st.bk.numpy()
    S = st.tok.shape[0]
    assert tab[-1, 0] == S and tab[-1, 1] == st.n_rows
    slot = np.arange(S)
    b = np.searchsorted(tab[:, 0], slot, side="right") - 1
    off, row0, width, shift = (tab[b, k].astype(np.int64) for k in range(4))
    d = slot - off
    q = np.where(shift >= 0, d >> np.maximum(shift, 0), d // width)
    roff = np.r_[0, np.cumsum([l for w, l in st.shapes for _ in range(w)])]
    want_row = np.searchsorted(roff, slot, side="right") - 1
    np.testing.assert_array_equal(row0 + q, want_row)
    np.testing.assert_array_equal(d - q * width == width - 1, np.isin(slot + 1, roff))
