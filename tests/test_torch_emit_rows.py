"""The plain versions of sharded v3's ``sparse_emit`` and v4's
``block_apply`` against the JAX package, on the CPU, on the edge inputs that
chip_smoke.py feeds the kernels (``sparse_emit_groups``, ``block_edge_rows``):
the JAX round body of ``parallel/train_sparse_sharded.py:86
_train_sparse_sharded`` (the merged stream, n_aff, both buffer sides and the
overflow flag at dcap = n_aff and one less) and one round of
``ops/train_block.py:130 train_rounds_block`` at KB = the rows with a hit
(the block path) and one less (the full path); and the rows' live extents
that the v4 kernels keep, against the rows after every round.  All values
are integers: equality is exact (tolerance 0)."""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from youtokentome_tpu.ops import train_block as jtb
from youtokentome_tpu.ops import train_delta as jtd
from youtokentome_tpu.ops import train_sparse as jsp
from youtokentome_tpu_torch.ops import block_kernels as bk
from youtokentome_tpu_torch.ops import delta_sharded_kernels as dsk
from youtokentome_tpu_torch.ops import sparse_sharded_kernels as ssk
from youtokentome_tpu_torch.ops import train_kernels as tk

BASES = (5, 70000)
CRAFTED = 84  # sparse_emit_groups' crafted groups (split pairs, split runs)
SLOTS = 1 << 15  # the tombstoned streams' length


def _tombstoned(base):
    """The crafted tombstoned groups and a few of the tombstoned random
    words, laid at chip_smoke's 256-position warp steps, then positions of
    no word up to SLOTS (one shape for every case: the JAX functions
    compile once)."""
    rng = np.random.default_rng(base)
    groups = chip_smoke.sparse_emit_groups(base, rng)
    groups = groups[:CRAFTED] + groups[CRAFTED + 500 : CRAFTED + 560] + groups[-3:-2]
    t, wid, freq = chip_smoke.tomb_lay(groups, base, rng, chip_smoke.SPARSE_EMIT_SPAN)
    tail = np.full(SLOTS - t.size, -1, np.int32)
    return np.concatenate([t, tail]), np.concatenate([wid, tail]), freq


def _sides(keys, w, sign):
    out = collections.Counter()
    xs, ys = (np.asarray(v) for v in jtd._unpack_key(keys))
    for x, y, c in zip(xs, ys, np.asarray(w)):
        if c > 0:
            out[(int(x), int(y))] += sign * int(c)
    return out


def _jax_emit(t, wid, freq, cand):
    """The JAX round body's shard-local half on one shard: the merged
    stream, n_aff, the words with a hit, and the old and new contributions
    of every affected position ({(x, y): weight} and the number of entries
    of weight > 0 a side)."""
    t, wid = jnp.asarray(t), jnp.asarray(wid)
    fw = jnp.asarray(freq, jnp.int32)[jnp.maximum(wid, 0)] * (wid >= 0)
    wide = int(jnp.max(t)) > 65535 or max(c[2] for c in cand) > 65535
    rows = np.zeros((16, 3), np.int32)  # 16 candidates, the round's accepted first
    rows[: len(cand)] = cand
    cx, cy, zs = (jnp.asarray(rows[:, i]) for i in range(3))
    acc = jnp.arange(16) < len(cand)
    keys, w, live, d = jsp._pairs_tomb(t, wid, fw, wide)
    t2, hit = jsp._apply_tomb(t, keys, live, d, acc, cx, cy, zs, 16)
    cs = jnp.cumsum(jtd._affected_positions(t, wid, hit).astype(jnp.int32))
    n_aff = int(cs[-1])
    pos, valid = jsp._gather_affected(cs, SLOTS)
    posc = jnp.minimum(pos, t2.shape[0] - 1)
    ko = tuple(jnp.where(valid, k[posc], jtd.PADKEY) for k in keys)
    wo = jnp.where(valid, w[posc], 0)
    kn, wn, _, _ = jsp._pairs_tomb(
        jnp.where(valid, t2[posc], -1), jnp.where(valid, wid[posc], -1),
        jnp.where(valid, fw[posc], 0), wide,
    )
    words = np.unique(np.asarray(wid)[np.asarray(hit)]).size
    return (np.asarray(t2), n_aff, words, _sides(ko, wo, -1), _sides(kn, wn, 1),
            int((wo > 0).sum()), int((wn > 0).sum()))


def _buffer(st, side):
    k, v = st.buffer(side)
    out = collections.Counter()
    for key, c in zip(k.tolist(), v.tolist()):
        out[(key >> 32, key & 0xFFFFFFFF)] += c
    return out


@pytest.mark.parametrize("base", BASES)
@pytest.mark.parametrize("rnd", range(4))
def test_sparse_emit_matches_jax_round(base, rnd):
    """sparse_emit (its plain version, which the CPU wrapper runs) on the
    tombstoned edge words: the merged stream, NPOS = n_aff (every position
    of a word with a hit, tombstones included), NAFF, DN_OLD and DN_NEW,
    each side of the buffer as a multiset, and DOVF at dcap = n_aff (clear)
    and n_aff - 1 (set, the entries past dcap dropped)."""
    t, wid, freq = _tombstoned(base)
    what, pairs = (chip_smoke.edge_rounds(base)
                   + [("split pairs", [(base, base + 1), (base, base)])])[rnd]
    cand = [(x, y, base + 100 + j) for j, (x, y) in enumerate(pairs)]
    t2, n_aff, words, old, new, n_old, n_new = _jax_emit(t, wid, freq, cand)
    for dcap in (max(n_aff, 1), n_aff - 1):
        if dcap < 1:
            continue
        st = ssk.SparseShardState(t, wid, freq, np.full((base + 200, 4), -1, np.int32), 0,
                                  1 << 12, dcap, "cpu")
        chip_smoke.set_round(st, pairs, base + 100)
        ssk.sparse_emit([st])
        np.testing.assert_array_equal(st.t.numpy(), t2)
        got = [int(st.ctl[s]) for s in (ssk.NPOS, dsk.NAFF, dsk.DN_OLD, dsk.DN_NEW, dsk.DOVF)]
        assert got == [n_aff, words, n_old, n_new, int(n_aff > dcap)], what
        assert st.ctl.numel() == ssk.EMIT_DONE + 1 and ssk.NPOS_RUN == dsk.POCC + 1
        assert int(st.ctl[ssk.NPOS_RUN]) == int(st.ctl[ssk.EMIT_DONE]) == 0
        if n_aff <= dcap:
            assert _buffer(st, 0) == old and _buffer(st, 1) == new
    assert rnd == 2 or n_aff > 0


def _jax_table(tk_, tc):
    xs, ys = (np.asarray(v).astype(np.int64) for v in jtd._unpack_key(tk_))
    tc = np.asarray(tc)
    keys = (xs[tc > 0] << 32) | ys[tc > 0]
    order = np.argsort(keys)
    return keys[order], tc[tc > 0][order]


def _extents(tok, B):
    """Each row's last live slot + 1 (numpy)."""
    live = tok.reshape(-1, B) >= 0
    return np.where(live.any(axis=1), B - np.argmax(live[:, ::-1], axis=1), 0)


@pytest.mark.parametrize("path", ["block", "full"])
def test_block_apply_matches_jax_round(path):
    """One v4 round, the port's top-k and block_apply (their plain
    versions) against the JAX train_rounds_block, on block_edge_rows (ids
    from 70000), at KB = the rows with a hit and one less: the rows, rules,
    used and the live table, the path taken (the full path front-packs the
    rows without a hit too), and the extents the rows'."""
    B, base = 128, 70000
    t, wid, freq = chip_smoke.block_edge_rows(B, base, np.random.default_rng(base + B))
    vocab, used0 = base + 200, base + 100
    rules = np.full((vocab, 4), -1, np.int32)
    uk, uc = jtd.host_count_table(t, wid, freq)
    pcap = jtd._next_pow2(4 * uk.size)

    def port(kb):
        st = bk.BlockState(t, wid, freq, rules, used0, B, 1 << 12, "cpu")
        bk.block_count(st)
        tk.topk_accept_plain(st, used0 + 1, vocab, used0, 16)
        bk.block_apply_plain(st, kb)
        return st

    n_rows = int(port(1 << 20).ctl[bk.NBAFF])
    kb = n_rows if path == "block" else n_rows - 1
    st = port(kb)
    jk, jc = jtd._fit_table(uk, uc, pcap, wide=True)
    jt, jw, jk, jc, jr, jused, *_ = jtb.train_rounds_block(
        jnp.asarray(t), jnp.asarray(wid), jnp.asarray(freq), jk, jc, jnp.asarray(rules),
        jnp.asarray(used0, jnp.int32), jnp.asarray(used0, jnp.int32),
        jnp.asarray(used0 + 1, jnp.int32), vocab, 16, pcap, B, kb,
    )
    np.testing.assert_array_equal(st.tok.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(st.wid.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(st.rules.numpy(), np.asarray(jr))
    assert int(st.ctl[tk.USED]) == int(jused)
    keys, cnts = st.table()
    jkeys, jcnts = _jax_table(jk, jc)
    np.testing.assert_array_equal(keys[cnts > 0], jkeys)
    np.testing.assert_array_equal(cnts[cnts > 0], jcnts)
    assert int(st.work[bk.W_FULL]) == (path == "full")
    assert int(st.work[bk.W_ROWS]) == (n_rows if path == "block" else 0)
    np.testing.assert_array_equal(st.ext.numpy(), _extents(np.asarray(jt), B))
    # the full path front-packed rows that held no hit: the two paths differ
    packed = np.asarray(jt).reshape(-1, B)
    gaps = ((packed[:, :-1] < 0) & (packed[:, 1:] >= 0)).any(axis=1)
    assert gaps.any() == (path == "block")


@pytest.mark.parametrize("B", [128, 512])
def test_block_extents_follow_the_rows(B):
    """The rows' live extents and the filled-row count that block_apply
    keeps (the flag walk reads each row below its extent, and no row past
    NL): after every round, on both paths, each extent is the row's last
    live slot + 1, the rows past NL hold PAD, and the walk's and the
    apply's bytes grow by what their rows give them."""
    base = 5
    rng = np.random.default_rng(B)
    t, wid, freq = chip_smoke.block_edge_rows(B, base, rng)
    st = bk.BlockState(t, wid, freq, np.full((base + 400, 4), -1, np.int32), base + 100, B,
                       1 << 12, "cpu")
    bk.block_count(st)
    assert st.NL < st.NB and (st.tok[st.NL * B :] == -1).all()
    np.testing.assert_array_equal(st.ext.numpy(), _extents(t, B))
    for r in range(8):
        ext0 = st.ext.numpy().copy()
        read0, apply0 = int(st.work[bk.W_READ]), int(st.work[bk.W_APPLY])
        tk.topk_accept_plain(st, base + 400, base + 400, base + 100, 16)
        n = int(st.ctl[tk.NACC])
        bk.block_apply(st, 4 if r % 2 else st.NB)  # the full path, then the block path
        tok = st.tok.numpy()
        np.testing.assert_array_equal(st.ext.numpy(), _extents(tok, B))
        assert (tok[st.NL * B :] == -1).all()
        if n:
            assert int(st.work[bk.W_READ]) - read0 >= 4 * st.NL + 4 * int(ext0[: st.NL].sum())
            assert int(st.work[bk.W_APPLY]) > apply0 or int(st.ctl[bk.NBAFF]) == 0
