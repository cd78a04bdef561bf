"""The torch port's sharded v3 trainer against the JAX package's, on the
CPU: its plain round loop and its kernel engine (whose kernels run their
plain torch versions here) against ``run_training_sparse_sharded`` at 1, 2
and 8 shards (8 CPU shards against the JAX package's 8 virtual CPU
devices, ``tests/conftest.py``), the dispatch of ``YTTM_TRAIN_IMPL=sparse``
onto a mesh, and one round of the shard-local kernels against the JAX
functions they replace.  Rules, progress lines, checkpoints and buffers
must be identical."""

import collections
import functools
import random
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from youtokentome_tpu.host import preprocess as j_pre
from youtokentome_tpu.models.state import BpeConfig as JConfig
from youtokentome_tpu.models.state import SpecialTokens as JSpecial
from youtokentome_tpu.ops import train_delta as j_td
from youtokentome_tpu.ops import train_sparse as j_sp
from youtokentome_tpu.ops.train_stream import flatten_word_buckets as j_flatten
from youtokentome_tpu.parallel import train_sparse_sharded as j_sps
from youtokentome_tpu.parallel.mesh import data_mesh as j_mesh
from youtokentome_tpu.train import train_from_codepoints as j_train
from youtokentome_tpu_torch import train as port
from youtokentome_tpu_torch.models.state import BpeConfig, SpecialTokens
from youtokentome_tpu_torch.ops import sparse_sharded_kernels as ssk
from youtokentome_tpu_torch.ops import train_kernels as tk
from youtokentome_tpu_torch.ops.train_sparse import run_training_sparse
from youtokentome_tpu_torch.parallel import mesh as mesh_mod
from youtokentome_tpu_torch.parallel.mesh import DataMesh
from youtokentome_tpu_torch.parallel.train_delta_sharded import shard_plan
from youtokentome_tpu_torch.parallel.train_sparse_sharded import (
    PlainSparseShardedEngine,
    run_training_sparse_sharded,
)

SHARDS = [1, 2, 8]
VOCAB = 30


def _buckets(text):
    cps = np.array([ord(c) for c in text], dtype=np.uint32)
    uniq, cnt, dl = j_pre.char_frequencies(cps)
    alpha = j_pre.build_alphabet(uniq, cnt, dl, 1.0, 4)
    return cps, j_pre.training_word_buckets(cps, alpha), len(alpha.char2id) + 4


@functools.lru_cache(maxsize=None)
def _corpus():
    """``tests/test_sharding.py``'s 400-char corpus: (cps, buckets, used0)."""
    rng = random.Random(0)
    return _buckets("".join(
        rng.choice("abc ") if rng.randrange(2) else rng.choice("abc") * rng.randint(2, 5)
        for _ in range(400)
    ))


@pytest.fixture(autouse=True)
def _quiet(monkeypatch):
    monkeypatch.setenv("YTTM_TRAIN_LOG", "0")


@functools.lru_cache(maxsize=None)
def _single():
    """The JAX package's one-device v3 rules (no knob changes them)."""
    _, buckets, used0 = _corpus()
    return j_sp.run_training_sparse(buckets, used0, VOCAB)


def _cpu(n):
    return DataMesh(["cpu"] * n)


def _port(n, plain, vocab=VOCAB, buckets=None, used0=None, **kw):
    if buckets is None:
        _, buckets, used0 = _corpus()
    return run_training_sparse_sharded(buckets, used0, vocab, _cpu(n), plain=plain, **kw)


def _untimed(err):
    """The progress lines of a run, with their time fields blanked."""
    return [
        re.sub(r"\([0-9.]+s, [0-9]+ merges/s", "(T)", line)
        for line in err.splitlines()
        if "merges:" in line
    ]


def _recounts(lines):
    return sum(int(re.search(r"; ([0-9]+) recount rounds", x).group(1)) for x in lines)


@pytest.mark.parametrize("n", SHARDS)
def test_rules_and_progress_lines_match_jax(n, capsys):
    """Rules equal the JAX sharded and one-device trainers' in both engines;
    the plain loop's progress lines equal the JAX host loop's (recount
    rounds and exchange sizes included), the kernel engine's but for its
    recount keys (half its table's slots)."""
    _, buckets, used0 = _corpus()
    want = j_sps.run_training_sparse_sharded(buckets, used0, VOCAB, j_mesh(n), progress_every=1)
    jlines = _untimed(capsys.readouterr().err)
    assert want == _single()
    assert run_training_sparse(buckets, used0, VOCAB, device="cpu") == want
    assert _port(n, True, progress_every=1) == want
    assert _untimed(capsys.readouterr().err) == jlines
    assert _port(n, False, progress_every=1) == want
    keys = r"x[0-9]+ recount keys"
    assert [re.sub(keys, "", x) for x in _untimed(capsys.readouterr().err)] == [
        re.sub(keys, "", x) for x in jlines
    ]
    assert len(jlines) > 5  # a line a round: up to 16 ids each


@pytest.mark.parametrize("dcap", [None, "64"])
def test_split_and_dcap_like_jax(dcap, monkeypatch):
    """The word-boundary split, shard for shard, and dcap (the JAX host
    loop's formula, or YTTM_TRAIN_DCAP)."""
    if dcap:
        monkeypatch.setenv("YTTM_TRAIN_DCAP", dcap)
    t, wid, _ = j_flatten(_corpus()[1])
    t, wid = np.asarray(t), np.asarray(wid)
    for n in SHARDS:
        seg_t, seg_w, per, got = shard_plan(t, wid, n)
        jt, jw, jper = j_sps._shard_stream(t, wid, n)
        np.testing.assert_array_equal(seg_t, jt)
        np.testing.assert_array_equal(seg_w, jw)
        assert per == jper
        assert got == (int(dcap) if dcap else j_td._next_pow2(min(max(1 << 12, per >> 6), 1 << 17)))


KNOBS = {
    "dcap": {"YTTM_TRAIN_DCAP": "8"},
    "pcap": {"YTTM_TRAIN_PCAP": "64"},
    "both": {"YTTM_TRAIN_DCAP": "8", "YTTM_TRAIN_PCAP": "64"},
}


# both knobs at every shard count; each knob alone at 2 shards
@pytest.mark.parametrize("knobs,n", [("dcap", 2), ("pcap", 2)] + [("both", n) for n in SHARDS])
def test_tiny_buffers_force_recount_and_rebuild(n, knobs, monkeypatch, capsys):
    """A tiny dcap drives rounds through the recount fold, a tiny pcap
    overflows the table (the JAX host loop doubles it and regrows from the
    tombstoned streams; the kernel engine rebuilds its replicas).  The plain
    loop's rules and progress lines stay the JAX package's, the kernel
    engine's rules the one-device trainer's.  These agree but on one shard
    with both knobs: there the JAX recount fold drops the keys past pcap of
    its one local count (the local count's n_live is not checked) and
    learns other rules, and the plain loop follows it."""
    _, buckets, used0 = _corpus()
    single = _single()
    for k, v in KNOBS[knobs].items():
        monkeypatch.setenv(k, v)
    want = j_sps.run_training_sparse_sharded(buckets, used0, VOCAB, j_mesh(n), progress_every=4)
    jlines = _untimed(capsys.readouterr().err)
    assert (_recounts(jlines) > 0) == (knobs != "pcap")
    assert (want == single) == (knobs != "both" or n > 1)
    assert _port(n, True, progress_every=4) == want
    assert _untimed(capsys.readouterr().err) == jlines
    rebuilds = []
    orig = ssk.SparseShardedKernelEngine.regrow
    monkeypatch.setattr(ssk.SparseShardedKernelEngine, "regrow",
                        lambda self: rebuilds.append(1) or orig(self))
    assert _port(n, False, progress_every=4) == single
    lines = _untimed(capsys.readouterr().err)
    assert (_recounts(lines) > 0) == (knobs != "pcap")
    assert bool(rebuilds) == (knobs != "dcap")  # a 128-slot replica table overflows


def test_kernel_engine_lockstep_with_plain_loop(monkeypatch):
    """Segment by segment, through recount rounds and rebuilds: the kernel
    engine's tombstoned streams equal the plain loop's, every replica holds
    the plain loop's live table, and the rules agree."""
    monkeypatch.setenv("YTTM_TRAIN_PCAP", "16")  # the kernel tables: 32 slots
    _, buckets, used0 = _corpus()
    t, wid, freq = (np.asarray(x) for x in j_flatten(buckets))
    seg_t, seg_w, per, _ = shard_plan(t, wid, 4)
    rules = np.full((VOCAB, 4), -1, np.int32)
    plain = PlainSparseShardedEngine(seg_t, seg_w, per, freq, rules, used0, VOCAB, 16, _cpu(4),
                                     64, 8, j_sp._host_table_tomb(t, wid, freq))
    kern = ssk.SparseShardedKernelEngine(seg_t, seg_w, freq, rules, used0, VOCAB, 16, _cpu(4), 8,
                                         t.shape[0])

    def complete(eng, used, limit):
        while True:
            used, done, overflow = eng.segment(used, limit)
            if not overflow:
                return used, done
            eng.regrow()

    used, nrec = used0, 0
    while used < VOCAB:
        limit = min(VOCAB, used + 2)
        got = complete(kern, used, limit)
        assert got == complete(plain, used, limit)
        used, nrec = got[0], nrec + kern.nrec
        live = plain.tc > 0
        for st in kern.shards:
            keys, cnts = st.table()
            np.testing.assert_array_equal(keys[cnts > 0], plain.tk[live].numpy())
            np.testing.assert_array_equal(cnts[cnts > 0], plain.tc[live].numpy())
        assert torch.equal(kern.rules, plain.rules)
        for st, pt in zip(kern.shards, plain.ts):
            assert torch.equal(st.t, pt)
        if got[1]:
            break
    assert kern.rebuilds > 0 and nrec > 0


def _jax_round(t, wid, freq, cand, dcap):
    """One round's shard-local half of the JAX program on one shard: the
    merged stream, n_aff, and the old and new contributions of the delta
    fold's buffers as {(x, y): weight} (zero weights dropped)."""
    t, wid = jnp.asarray(t), jnp.asarray(wid)
    fw = jnp.asarray(freq)[jnp.maximum(wid, 0)] * (wid >= 0)
    kb = len(cand)
    cx = jnp.array([c[0] for c in cand], jnp.int32)
    cy = jnp.array([c[1] for c in cand], jnp.int32)
    zs = jnp.array([c[2] for c in cand], jnp.int32)
    acc = jnp.ones(kb, bool)
    keys, w, live, d = j_sp._pairs_tomb(t, wid, fw)
    t2, hit = j_sp._apply_tomb(t, keys, live, d, acc, cx, cy, zs, kb)
    cs = jnp.cumsum(j_td._affected_positions(t, wid, hit).astype(jnp.int32))
    pos, valid = j_sp._gather_affected(cs, dcap)
    posc = jnp.minimum(pos, t2.shape[0] - 1)
    ko = tuple(jnp.where(valid, k[posc], j_td.PADKEY) for k in keys)
    wo = jnp.where(valid, w[posc], 0)
    kn, wn, _, _ = j_sp._pairs_tomb(
        jnp.where(valid, t2[posc], -1), jnp.where(valid, wid[posc], -1),
        jnp.where(valid, fw[posc], 0),
    )

    def sides(k, v, sign):
        xs, ys = j_td._unpack_key(k)
        out = collections.Counter()
        for x, y, c in zip(np.asarray(xs), np.asarray(ys), np.asarray(v)):
            if c:
                out[(int(x), int(y))] += sign * int(c)
        return out

    return np.asarray(t2), int(cs[-1]), sides(ko, wo, -1), sides(kn, wn, 1)


def _buffer(st, side):
    k, v = st.buffer(side)
    out = collections.Counter()
    for key, c in zip(k.tolist(), v.tolist()):
        out[(key >> 32, key & 0xFFFFFFFF)] += c
    return out


# a shard of three words with tombstones (-1) inside them, padding after
T = [4, 5, -1, 5, 6, 5, 5, -1, 6, 4, 7, 6, -1, -1, 5, 5, 5, 5, -1, -1]
WID = [0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, -1, -1]
FREQ = [3, 2, 5]
CAND = [(5, 6, 9), (4, 7, 10)]  # two candidates accept_prefix would take


@pytest.mark.parametrize("dcap", [64, 8])
def test_one_round_buffers_match_jax(dcap):
    """sparse_emit (its plain version, which the CPU wrapper runs) on a
    crafted shard with tombstones against the JAX round's
    _pairs_tomb/_apply_tomb, _affected_positions and _gather_affected: the
    merged stream, NPOS = n_aff (every position of an affected word,
    tombstones included), DOVF = n_aff > dcap, and each side of the buffer
    as a multiset of contributions."""
    t2, n_aff, old, new = _jax_round(T, WID, FREQ, CAND, dcap)
    st = ssk.SparseShardState(np.array(T, np.int32), np.array(WID, np.int32),
                              np.array(FREQ, np.int32), np.full((20, 4), -1, np.int32), 8, 64,
                              dcap, "cpu")
    st.cand[: len(CAND), :3] = torch.tensor(CAND, dtype=torch.int32)
    st.ctl[tk.NACC] = len(CAND)
    ssk.sparse_emit(st)
    np.testing.assert_array_equal(st.t.numpy(), t2)
    assert int(st.ctl[ssk.NPOS]) == n_aff and n_aff == 18
    assert int(st.ctl[ssk.DOVF]) == int(n_aff > dcap)
    assert int(st.ctl[ssk.NAFF]) == 3
    if n_aff <= dcap:
        assert _buffer(st, 0) == old and _buffer(st, 1) == new
        assert int(st.work[ssk.W_ENTRIES]) == len(st.buffer(0)[0]) + len(st.buffer(1)[0])


def test_shard_recount_counts_the_tombstoned_stream():
    """sparse_shard_recount (its plain version) fills the scratch table with
    the host count of the live tokens when some shard's DOVF is set, and
    leaves it alone otherwise."""
    st = ssk.SparseShardState(np.array(T, np.int32), np.array(WID, np.int32),
                              np.array(FREQ, np.int32), np.full((20, 4), -1, np.int32), 8, 64, 8,
                              "cpu")
    other = ssk.SparseShardState(np.array(T, np.int32), np.array(WID, np.int32),
                                 np.array(FREQ, np.int32), np.full((20, 4), -1, np.int32), 8, 64,
                                 8, "cpu")
    ssk.sparse_shard_recount(st, [st, other])
    assert int((st.rkeys != tk.EMPTY).sum()) == 0
    other.ctl[ssk.DOVF] = 1
    ssk.sparse_shard_recount(st, [st, other])
    uk, uc = j_sp._host_table_tomb(np.array(T), np.array(WID), np.array(FREQ))
    used = st.rkeys != tk.EMPTY
    order = torch.argsort(st.rkeys[used])
    np.testing.assert_array_equal(st.rkeys[used][order].numpy(), np.asarray(uk, np.int64))
    np.testing.assert_array_equal(st.rcnts[used][order].numpy(), uc)
    assert int(st.ctl[ssk.ROCC]) == uk.size and int(st.ctl[ssk.ROVF]) == 0


def test_wide_vocab_on_four_shards():
    """Ids above 65535 (the JAX package's two-part keys; the port's keys are
    int64): ``tests/test_train_sparse.py``'s wide-vocab corpus on 4 shards."""
    rng = random.Random(6)
    _, buckets, used0 = _buckets("".join(rng.choice("abc ") for _ in range(400)))
    want = j_sp.run_training_sparse(buckets, used0, 70000)
    assert j_sps.run_training_sparse_sharded(buckets, used0, 70000, j_mesh(4)) == want
    for plain in (True, False):
        assert _port(4, plain, 70000, buckets, used0) == want


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_resumes_in_both_packages(writer, tmp_path):
    """A checkpoint of a sharded v3 run (the shards' live tokens) resumes to
    the same rules under the JAX package's sharded trainer and the port's
    one-device and sharded trainers."""
    _, buckets, used0 = _corpus()
    ck = str(tmp_path / "ck.npz")
    if writer == "port":
        _port(2, False, checkpoint_path=ck, checkpoint_every=8)
        plain_ck = str(tmp_path / "plain.npz")
        _port(2, True, checkpoint_path=plain_ck, checkpoint_every=8)
        for k in ("t", "wid", "freq", "rules", "used"):
            np.testing.assert_array_equal(np.load(ck)[k], np.load(plain_ck)[k])
    else:
        j_sps.run_training_sparse_sharded(buckets, used0, VOCAB, j_mesh(2), checkpoint_path=ck,
                                          checkpoint_every=8)
    assert used0 < int(np.load(ck)["used"]) < VOCAB
    want = _single()
    assert j_sps.run_training_sparse_sharded(buckets, used0, VOCAB, j_mesh(8),
                                             resume_path=ck) == want
    assert run_training_sparse(buckets, used0, VOCAB, resume_path=ck, device="cpu") == want
    for plain in (True, False):
        assert _port(8, plain, resume_path=ck) == want


def test_sparse_on_a_mesh_trains_sharded_v3(monkeypatch):
    """``YTTM_TRAIN_IMPL=sparse`` with 8 visible devices dispatches the
    sharded v3 trainer; rules and char2id equal the JAX package's on its 8
    devices."""
    cps = _corpus()[0]
    monkeypatch.setenv("YTTM_TRAIN_IMPL", "sparse")
    monkeypatch.setenv("YTTM_SHARD_MIN_TOKENS", "1")
    monkeypatch.setattr(mesh_mod, "visible_devices", lambda dev: [torch.device("cpu")] * 8)
    seen = []
    orig = port.run_training_sparse_sharded
    monkeypatch.setattr(port, "run_training_sparse_sharded",
                        lambda b, u, v, mesh, **kw: seen.append(mesh.size) or orig(b, u, v, mesh, **kw))
    got = port.train_from_codepoints(cps, VOCAB, BpeConfig(1.0, -1, SpecialTokens(0, 1, 2, 3)),
                                     "cpu")
    assert seen == [8]
    want = j_train(cps, VOCAB, JConfig(1.0, -1, JSpecial(0, 1, 2, 3)))
    assert got.rules == want.rules and got.char2id == want.char2id
