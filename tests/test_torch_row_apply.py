"""v0's per-card apply and the partitioned fold's listed gather on the CPU
(their plain torch versions): the apply over the states of a card against
the JAX package's ``apply_merge_rows`` on every bucket matrix, round after
round, on the edge rows that chip_smoke.py feeds the kernel; the gather,
which copies only the slots of the owners' fill lists, against a copy of
every other part whole, over rounds whose keys leave and join, with a
regrow between them and a full part at the end."""

import chip_smoke
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from youtokentome_tpu.ops.segment import apply_merge_rows as j_apply_merge_rows
from youtokentome_tpu_torch.ops import bucketed_kernels as bk
from youtokentome_tpu_torch.ops import delta_sharded_kernels as dsk
from youtokentome_tpu_torch.ops import recount_sharded_kernels as rsk
from youtokentome_tpu_torch.ops import train_kernels as tk
from youtokentome_tpu_torch.parallel.train_sharded import shard_rows

_j_apply = jax.jit(j_apply_merge_rows)  # one compilation a matrix shape


def _apply_states(base):
    """The edge rows cut in two shards, and a third shard without a hit."""
    rng = np.random.default_rng(base + 11)
    buckets = chip_smoke.apply_edge_buckets(base, rng)
    quiet = chip_smoke.apply_quiet_rows(base, rng)
    rules = np.full((base + 64, 4), -1, np.int32)
    return [bk.BucketedState(b, rules, base + 54, 1 << 10, "cpu")
            for b in shard_rows(buckets, 2) + [quiet]]


@pytest.mark.parametrize("base", [5, 70000])
def test_card_apply_matches_jax_rows(base):
    """bucket_apply over 3 states of one card (its plain version on the
    CPU) leaves every bucket matrix as the JAX apply_merge_rows does, round
    after round of apply_edge_cands: widths 8, 16, 128, 1024 and 1029, runs
    of equal ids of odd and even length, hits at rows' last pairs, full
    rows, padding rows, and a state that holds no hit; W_WRITES counts the
    slots that changed."""
    states = _apply_states(base)
    changed = [0] * len(states)
    for x, y, z in chip_smoke.apply_edge_cands(base):
        before = [[m.numpy().copy() for m in st.buckets()] for st in states]
        for st in states:
            st.cand[0, :3] = torch.tensor([x, y, z], dtype=torch.int32)
            st.ctl[tk.NACC] = 1
        bk.bucket_apply(states)
        for i, (st, mats) in enumerate(zip(states, before)):
            for m, got in zip(mats, st.buckets()):
                want = np.asarray(_j_apply(jnp.asarray(m), x, y, z))
                np.testing.assert_array_equal(got.numpy(), want, f"state {i}, pair {x, y}")
                changed[i] += int((want != m).sum())
    assert [int(st.work[bk.W_WRITES]) for st in states] == changed
    assert changed[0] > 0 and changed[1] > 0 and changed[2] == 0


def _fresh_scratch(st, fresh):
    """Shard ``st``'s scratch table and part lists as ``fresh`` counted
    them (the replica's table and fill lists stay)."""
    for k in ("rkeys", "rcnts", "plist", "pcnt"):
        getattr(st, k).copy_(getattr(fresh, k))
    st.ctl[rsk.ROCC] = fresh.ctl[rsk.ROCC]
    st.ctl[rsk.ROVF] = fresh.ctl[rsk.ROVF]


def _gather_round(shards, r, cap):
    """Round r of chip_smoke.gather_round_pairs: each shard's scratch table
    counted afresh, then every replica's fold; returns the whole-part copy
    of the folded tables."""
    pairs = chip_smoke.gather_round_pairs(r)
    for st, q in zip(shards, pairs):
        fresh = chip_smoke.stream_shard_of(*chip_smoke.pair_words(q), "cpu", cap)
        rsk.stream_shard_count_plain(fresh, 1 << 30, 1 << 30)
        _fresh_scratch(st, fresh)
    for st in shards:
        dsk.shard_part_fold_plain(st, shards)
    return chip_smoke.whole_part_copy(shards)


def _gather_mesh():
    n, cap = chip_smoke.FOLD_PARTS, chip_smoke.FOLD_CAP
    pairs = chip_smoke.gather_round_pairs(0)
    return [chip_smoke.stream_shard_of(*chip_smoke.pair_words(q), "cpu", cap, n) for q in pairs]


def test_listed_gather_matches_whole_part_copy():
    """shard_gather over a 3-part mesh (the card's wrapper, each replica
    through its plain version) for 5 rounds whose keys leave and join, the
    tables regrown before round 2 as the engine's regrow does: after every
    gather each replica equals, slot for slot, the folded tables with every
    other part copied whole; the full part of the last round sets OVERFLOW
    on every replica, and no earlier round does."""
    shards = _gather_mesh()
    n, cap = len(shards), shards[0].cap
    moved = False
    for r in range(chip_smoke.GATHER_ROUNDS):
        if r == 2:
            cap *= 2
            for st in shards:
                st.resize(cap)
                st.ctl[tk.OVERFLOW] = 0
                st.ctl[rsk.ROVF] = 0
        filled = shards[0].keys != tk.EMPTY
        want = _gather_round(shards, r, cap)
        dsk.shard_gather(shards, shards)
        for i, (st, (keys, cnts)) in enumerate(zip(shards, want)):
            assert torch.equal(st.keys, keys) and torch.equal(st.cnts, cnts), f"round {r}, {i}"
        assert [int(st.ctl[tk.OVERFLOW]) for st in shards] == [int(r == 4)] * n, f"round {r}"
        moved |= r == 1 and not torch.equal(filled, shards[0].keys != tk.EMPTY)
    assert moved


def test_gather_writes_only_listed_slots():
    """The gather touches no slot of another part outside its owner's two
    fill lists: slots there that a poisoned replica holds stay as they
    are, and the listed ones are copied."""
    shards = _gather_mesh()
    cap = shards[0].cap
    _gather_round(shards, 0, cap)
    dsk.shard_gather(shards, shards)
    want = _gather_round(shards, 1, cap)
    dest, owner = shards[0], shards[1]
    lo, hi = cap // 3, 2 * cap // 3
    listed = torch.zeros(cap, dtype=torch.bool)
    listed[torch.cat([owner.fill_list(0, 1), owner.fill_list(1, 1)])] = True
    unlisted = torch.nonzero(~listed[lo:hi]).flatten() + lo
    assert unlisted.numel() > 0 and int(listed[lo:hi].sum()) > 0
    dest.keys[unlisted] = 12345
    dest.cnts[unlisted] = 7
    dsk.shard_gather(shards, shards)
    assert bool((dest.keys[unlisted] == 12345).all() and (dest.cnts[unlisted] == 7).all())
    on = listed.clone()
    on[:lo] = on[hi:] = False
    assert torch.equal(dest.keys[on], want[0][0][on]) and torch.equal(dest.cnts[on], want[0][1][on])
