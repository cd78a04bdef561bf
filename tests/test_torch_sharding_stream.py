"""The torch port's sharded v1 (flat stream) and v0 (bucketed) trainers
against the JAX package's, on the CPU: each one's plain round loop and
kernel engine (whose kernels run their plain torch versions here) against
``run_training_stream_sharded`` and ``run_training_sharded`` at 1, 2 and 8
shards (8 CPU shards against the JAX package's 8 virtual CPU devices,
``tests/conftest.py``), v0's row split against the JAX layout, and the
kernel engines in lockstep with the plain loops.  Rules, streams, rows
and tables must be identical."""

import functools
import random

import numpy as np
import pytest
import torch

from youtokentome_tpu.host import preprocess as j_pre
from youtokentome_tpu.ops.train_kernel import run_training as j_v0
from youtokentome_tpu.ops.train_stream import flatten_word_buckets as j_flatten
from youtokentome_tpu.ops.train_stream import run_training_stream as j_v1
from youtokentome_tpu.parallel import train_sharded as j_shv0
from youtokentome_tpu.parallel.mesh import data_mesh as j_mesh
from youtokentome_tpu.parallel.train_stream_sharded import run_training_stream_sharded as j_shv1
from youtokentome_tpu_torch.ops import recount_sharded_kernels as rsk
from youtokentome_tpu_torch.ops import train_kernels as tk
from youtokentome_tpu_torch.ops.train_kernel import run_training
from youtokentome_tpu_torch.ops.train_stream import run_training_stream
from youtokentome_tpu_torch.parallel.mesh import DataMesh
from youtokentome_tpu_torch.parallel.train_delta_sharded import _shard_stream
from youtokentome_tpu_torch.parallel.train_sharded import (
    PlainBucketedShardedEngine,
    run_training_sharded,
    shard_rows,
)
from youtokentome_tpu_torch.parallel.train_stream_sharded import (
    PlainStreamShardedEngine,
    run_training_stream_sharded,
)

SHARDS = [1, 2, 8]
VOCAB = 30
LONG = 400  # past the corpus's last pair: the run ends done


@functools.lru_cache(maxsize=None)
def _corpus():
    """``tests/test_sharding.py``'s 400-char corpus: (buckets, used0)."""
    rng = random.Random(0)
    text = "".join(
        rng.choice("abc ") if rng.randrange(2) else rng.choice("abc") * rng.randint(2, 5)
        for _ in range(400)
    )
    cps = np.array([ord(c) for c in text], dtype=np.uint32)
    uniq, cnt, dl = j_pre.char_frequencies(cps)
    alpha = j_pre.build_alphabet(uniq, cnt, dl, 1.0, 4)
    return j_pre.training_word_buckets(cps, alpha), len(alpha.char2id) + 4


def _cpu(n):
    return DataMesh(["cpu"] * n)


@pytest.mark.parametrize("n", SHARDS)
def test_stream_rules_match_jax(n):
    """v1: rules equal the JAX sharded and one-device trainers' and the
    port's one-device trainer's, in both engines."""
    buckets, used0 = _corpus()
    want = j_shv1(buckets, used0, VOCAB, j_mesh(n))
    assert want == j_v1(buckets, used0, VOCAB)
    assert run_training_stream(buckets, used0, VOCAB, device="cpu") == want
    for plain in (True, False):
        assert run_training_stream_sharded(buckets, used0, VOCAB, _cpu(n), plain=plain) == want


@pytest.mark.parametrize("n", SHARDS)
def test_bucketed_rules_match_jax(n):
    """v0: rules equal the JAX sharded and one-device trainers' and the
    port's one-device trainer's, in both engines."""
    buckets, used0 = _corpus()
    want = j_shv0.run_training_sharded(buckets, used0, VOCAB, j_mesh(n))
    assert want == j_v0(buckets, used0, VOCAB)
    assert run_training(buckets, used0, VOCAB, device="cpu") == want
    for plain in (True, False):
        assert run_training_sharded(buckets, used0, VOCAB, _cpu(n), plain=plain) == want


@pytest.mark.parametrize("n", [2, 8])
def test_row_split_matches_jax(n, monkeypatch):
    """v0's shards hold the JAX layout's rows: each bucket padded with PAD
    rows of frequency 0 to a multiple of n, cut into n contiguous blocks
    (read from the JAX arrays' per-device shards); at 8 shards some shard
    holds only padding rows in some bucket."""
    buckets, used0 = _corpus()
    seen = []
    orig = j_shv0._train_rounds_sharded

    def spy(bks, *a, **k):
        seen.append(bks)
        return orig(bks, *a, **k)

    monkeypatch.setattr(j_shv0, "_train_rounds_sharded", spy)
    j_shv0.run_training_sharded(buckets, used0, used0 + 1, j_mesh(n))
    got = shard_rows(buckets, n)
    for b, (toks, freq) in enumerate(seen[0]):
        for arr, i in ((toks, 0), (freq, 1)):
            blocks = sorted(arr.addressable_shards, key=lambda s: s.device.id)
            assert len(blocks) == n
            for d, blk in enumerate(blocks):
                np.testing.assert_array_equal(np.asarray(blk.data), got[d][b][i])
    if n == 8:
        assert any((f == 0).all() for bks in got for _, f in bks)


def _live_table(st):
    keys, cnts = st.table()
    return keys[cnts > 0], cnts[cnts > 0]


def _count_table(count):
    cnt, xs, ys = count
    on = cnt > 0
    keys = (xs[on].long() << 32) | ys[on].long()
    order = torch.argsort(keys)
    return keys[order].numpy(), cnt[on][order].numpy()


def _lockstep(kern, plain, used0, streams, vocab=VOCAB):
    """Both engines segment by segment (2 ids a segment); at every end the
    shards' streams or rows, every replica's live table (the last round's
    count) and the rules agree.  Returns (the segments run, whether at some
    segment end a shard had no pair left while another had)."""

    def complete(eng, used, limit):
        while True:
            used, done, overflow = eng.segment(used, limit)
            if not overflow:
                return used, done
            eng.regrow()

    used, segs, idle = used0, 0, False
    while used < vocab:
        limit = min(vocab, used + 2)
        got = complete(kern, used, limit)
        assert got == complete(plain, used, limit)
        used, segs = got[0], segs + 1
        keys, cnts = _count_table(plain.count)
        for st in kern.shards:
            k, c = _live_table(st)
            np.testing.assert_array_equal(k, keys)
            np.testing.assert_array_equal(c, cnts)
        assert torch.equal(kern.rules, plain.rules)
        counted = [int(st.ctl[rsk.ROCC]) for st in kern.shards]
        idle |= min(counted) == 0 < max(counted)
        for st, want in zip(kern.shards, streams(plain)):
            for a, b in zip((st.t, st.wid) if hasattr(st, "wid") else (st.tok,), want):
                assert torch.equal(a, b)
        if got[1]:
            break
    return segs, idle


def test_stream_kernel_engine_lockstep(monkeypatch):
    """v1 on 8 shards with small tables (a count overflows, the tables
    double), run until no pair is left: each shard's front-compacted
    stream, the replicas and the rules equal the plain loop's at every
    segment end; shards whose words are all merged run on as no-ops."""
    monkeypatch.setenv("YTTM_TRAIN_PCAP", "8")  # the kernel tables: 16 slots
    buckets, used0 = _corpus()
    t, wid, freq = (np.asarray(x) for x in j_flatten(buckets))
    seg_t, seg_w, _ = _shard_stream(t, wid, 8)
    rules = np.full((LONG, 4), -1, np.int32)
    kern = rsk.StreamShardedKernelEngine(seg_t, seg_w, freq, rules, used0, LONG, 16, _cpu(8),
                                         t.shape[0])
    plain = PlainStreamShardedEngine(seg_t, seg_w, freq, rules, used0, LONG, 16, _cpu(8))
    segs, idle = _lockstep(kern, plain, used0, lambda p: zip(p.ts, p.ws), LONG)
    assert segs > 3 and idle
    assert int(kern.shards[0].ctl[tk.DONE]) == 1
    assert kern.rebuilds > 0 or kern.shards[0].cap > 16


def test_bucketed_kernel_engine_lockstep(monkeypatch):
    """v0 on 8 shards (some of only padding rows) with small tables: each
    shard's rows, the replicas and the rules equal the plain loop's at every
    segment end."""
    monkeypatch.setenv("YTTM_TRAIN_PCAP", "8")
    buckets, used0 = _corpus()
    shard_buckets = shard_rows(buckets, 8)
    rules = np.full((VOCAB, 4), -1, np.int32)
    kern = rsk.BucketedShardedKernelEngine(shard_buckets, rules, used0, VOCAB, _cpu(8))
    plain = PlainBucketedShardedEngine(shard_buckets, rules, used0, VOCAB, _cpu(8))

    def rows(p):
        return [(torch.cat([t.reshape(-1) for t, _ in bks]),) for bks in p.shards]

    assert _lockstep(kern, plain, used0, rows)[0] > 3
    assert kern.rebuilds > 0 or kern.shards[0].cap > 16


def test_shard_counts_fill_the_scratch_table():
    """stream_shard_count and bucket_shard_count (their plain versions) fill
    the scratch table, not the replica, and each replica's fold holds the
    sum of the shards' counts."""
    buckets, used0 = _corpus()
    t, wid, freq = (np.asarray(x) for x in j_flatten(buckets))
    from youtokentome_tpu_torch.ops.train_delta import host_count_table

    uk, uc = host_count_table(t, wid, freq)
    seg_t, seg_w, _ = _shard_stream(t, wid, 2)
    rules = np.full((VOCAB, 4), -1, np.int32)
    engines = [
        rsk.StreamShardedKernelEngine(seg_t, seg_w, freq, rules, used0, VOCAB, 16, _cpu(2),
                                      t.shape[0]),
        rsk.BucketedShardedKernelEngine(shard_rows(buckets, 2), rules, used0, VOCAB, _cpu(2)),
    ]
    for eng in engines:
        for st in eng.shards:
            st.keys.fill_(rsk.EMPTY)
            st.cnts.zero_()
        eng._exchange(VOCAB)
        for st in eng.shards:
            keys, cnts = _live_table(st)
            np.testing.assert_array_equal(keys, np.asarray(uk, np.int64))
            np.testing.assert_array_equal(cnts, uc)
            assert int(st.ctl[rsk.ROCC]) == int((st.rkeys != rsk.EMPTY).sum()) > 0
        assert sum(int(st.rcnts.sum()) for st in eng.shards) == int(uc.sum())


@pytest.mark.parametrize("n", [3, 8])
def test_part_fold_lays_each_key_in_its_part(n):
    """shard_part_fold and shard_gather (their plain versions): every
    replica is the same table of the shards' summed counts, part p of it
    (the slots [p*cap/n, (p+1)*cap/n)) holds exactly the keys whose
    key_part is p, and the occupancy is the parts' counts summed; with an
    odd shard count, the parts are not all of one size."""
    from youtokentome_tpu_torch.ops import delta_sharded_kernels as dsk
    from youtokentome_tpu_torch.ops.train_delta import host_count_table

    buckets, used0 = _corpus()
    t, wid, freq = (np.asarray(x) for x in j_flatten(buckets))
    uk, uc = host_count_table(t, wid, freq)
    seg_t, seg_w, _ = _shard_stream(t, wid, n)
    rules = np.full((VOCAB, 4), -1, np.int32)
    eng = rsk.StreamShardedKernelEngine(seg_t, seg_w, freq, rules, used0, VOCAB, 16, _cpu(n),
                                        t.shape[0])
    head = eng.shards[0]
    for st in eng.shards:
        assert torch.equal(st.keys, head.keys) and torch.equal(st.cnts, head.cnts)
        keys, cnts = _live_table(st)
        np.testing.assert_array_equal(keys, np.asarray(uk, np.int64))
        np.testing.assert_array_equal(cnts, uc)
        assert int(st.ctl[tk.OCC]) == len(uk) == sum(int(s.ctl[dsk.POCC]) for s in eng.shards)
    for p in range(n):
        lo, hi = dsk.part_lo(p, head.cap, n), dsk.part_lo(p + 1, head.cap, n)
        part = head.keys[lo:hi]
        part = part[part != tk.EMPTY]
        assert bool((dsk.key_part(part, n) == p).all())
        assert part.numel() == int(eng.shards[p].ctl[dsk.POCC])
