"""The torch port's data-mesh slice against the JAX package's, on the CPU:
the sharded v2 trainer (its plain round loop and its kernel engine, whose
kernels run their plain torch versions here) against
``run_training_delta_sharded``, the dispatch of ``auto`` onto a mesh, and
the sharded greedy encode, at 1, 2 and 8 shards (8 CPU shards against the
JAX package's 8 virtual CPU devices, ``tests/conftest.py``).  Rules,
progress lines, ids and checkpoints must be identical."""

import functools
import random
import re

import numpy as np
import pytest
import torch

from youtokentome_tpu.encoder import Encoder as JEncoder
from youtokentome_tpu.host import preprocess as j_pre
from youtokentome_tpu.models.state import BpeConfig as JConfig
from youtokentome_tpu.models.state import SpecialTokens as JSpecial
from youtokentome_tpu.ops.encode_kernel import encode_batch as j_encode_batch
from youtokentome_tpu.ops.train_delta import run_training_delta as j_delta
from youtokentome_tpu.parallel.encode_sharded import encode_batch_sharded as j_encode_sharded
from youtokentome_tpu.parallel.mesh import data_mesh as j_mesh
from youtokentome_tpu.parallel.train_delta_sharded import run_training_delta_sharded as j_sharded
from youtokentome_tpu.train import train_from_codepoints as j_train
from youtokentome_tpu_torch import train as port
from youtokentome_tpu_torch.encoder import Encoder
from youtokentome_tpu_torch.models.state import BPEState, BpeConfig, SpecialTokens
from youtokentome_tpu_torch.ops import delta_sharded_kernels as dsk
from youtokentome_tpu_torch.ops.train_delta import run_training_delta
from youtokentome_tpu_torch.parallel import encode_sharded as es
from youtokentome_tpu_torch.parallel import mesh as mesh_mod
from youtokentome_tpu_torch.parallel.mesh import DataMesh
from youtokentome_tpu_torch.parallel.train_delta_sharded import (
    _shard_stream,
    run_training_delta_sharded,
)

SHARDS = [1, 2, 8]
VOCAB = 30


@pytest.fixture(scope="module")
def corpus():
    return _corpus()


@functools.lru_cache(maxsize=None)
def _corpus():
    """``tests/test_sharding.py``'s 400-char corpus."""
    rng = random.Random(0)
    text = "".join(
        rng.choice("abc ") if rng.randrange(2) else rng.choice("abc") * rng.randint(2, 5)
        for _ in range(400)
    )
    cps = np.array([ord(c) for c in text], dtype=np.uint32)
    uniq, cnt, dl = j_pre.char_frequencies(cps)
    alpha = j_pre.build_alphabet(uniq, cnt, dl, 1.0, 4)
    buckets = j_pre.training_word_buckets(cps, alpha)
    return cps, alpha, buckets, len(alpha.char2id) + 4


@pytest.fixture(autouse=True)
def _quiet(monkeypatch):
    monkeypatch.setenv("YTTM_TRAIN_LOG", "0")


@functools.lru_cache(maxsize=None)
def _single():
    """The JAX package's one-device v2 rules on the corpus (no knob changes
    them), computed once for the module."""
    _, _, buckets, used0 = _corpus()
    return j_delta(buckets, used0, VOCAB)


def _cpu(n):
    return DataMesh(["cpu"] * n)


def _port(buckets, used0, n, plain, **kw):
    return run_training_delta_sharded(buckets, used0, VOCAB, _cpu(n), plain=plain, **kw)


def _untimed(err):
    """The progress lines of a run, with their time fields blanked."""
    return [
        re.sub(r"\([0-9.]+s, [0-9]+ merges/s", "(T)", line)
        for line in err.splitlines()
        if "merges:" in line
    ]


@pytest.mark.parametrize("n", SHARDS)
def test_rules_match_jax(corpus, n):
    _, _, buckets, used0 = corpus
    want = j_sharded(buckets, used0, VOCAB, j_mesh(n))
    assert want == _single()
    assert run_training_delta(buckets, used0, VOCAB, device="cpu") == want
    for plain in (True, False):
        assert _port(buckets, used0, n, plain) == want, f"plain={plain}"


def test_shards_split_like_jax(corpus):
    """The word-boundary split, shard for shard."""
    from youtokentome_tpu.ops.train_stream import flatten_word_buckets
    from youtokentome_tpu.parallel.train_sparse_sharded import _shard_stream as j_split

    t, wid, _ = flatten_word_buckets(corpus[2])
    for n in SHARDS:
        got, want = _shard_stream(np.asarray(t), np.asarray(wid), n), j_split(
            np.asarray(t), np.asarray(wid), n
        )
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", SHARDS)
def test_progress_lines_match_jax(corpus, n, capsys):
    """Every field of the JAX host loop's progress line but the times, the
    recount rounds and the exchange sizes included; the kernel engine's
    lines differ only in its recount keys (half its table's slots)."""
    _, _, buckets, used0 = corpus
    j_sharded(buckets, used0, VOCAB, j_mesh(n), progress_every=1)
    want = _untimed(capsys.readouterr().err)
    _port(buckets, used0, n, True, progress_every=1)
    assert _untimed(capsys.readouterr().err) == want
    _port(buckets, used0, n, False, progress_every=1)
    keys = r"x[0-9]+ recount keys"
    assert [re.sub(keys, "", x) for x in _untimed(capsys.readouterr().err)] == [
        re.sub(keys, "", x) for x in want
    ]
    assert len(want) > 5  # a line a round: up to 16 ids each


def _recounts(lines):
    return sum(int(re.search(r"; ([0-9]+) recount rounds", x).group(1)) for x in lines)


KNOBS = {
    "dcap": {"YTTM_TRAIN_DCAP": "8"},
    "pcap": {"YTTM_TRAIN_PCAP": "64"},
    "both": {"YTTM_TRAIN_DCAP": "8", "YTTM_TRAIN_PCAP": "64"},
}


# both knobs at every shard count; each knob alone at 2 shards
@pytest.mark.parametrize(
    "knobs,n", [("dcap", 2), ("pcap", 2)] + [("both", n) for n in SHARDS]
)
def test_tiny_buffers_force_recount_and_rebuild(corpus, n, knobs, monkeypatch, capsys):
    """A tiny dcap drives rounds through the recount fold, a tiny pcap
    overflows the table (the JAX host loop doubles it; the kernel engine
    rebuilds its replicas), and a small re-pack floor relays the streams.
    The plain loop's rules and progress lines stay the JAX package's, the
    kernel engine's rules the one-device trainer's.  These equal the JAX
    package's but on one shard with both knobs: there the JAX recount fold
    drops the keys past pcap of its one local count (``_full_recount``'s
    n_live is not checked) and learns other rules, and the plain loop
    follows it."""
    _, _, buckets, used0 = corpus
    single = _single()
    for k, v in KNOBS[knobs].items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("YTTM_TRAIN_REPACK_MIN", "16")
    want = j_sharded(buckets, used0, VOCAB, j_mesh(n), progress_every=4)
    jlines = _untimed(capsys.readouterr().err)
    assert (_recounts(jlines) > 0) == (knobs != "pcap")
    assert ("x64 recount keys" in jlines[-1]) == (knobs == "both" and n == 1)
    assert (want == single) == (knobs != "both" or n > 1)
    relays = []
    orig = dsk.shard_relay
    monkeypatch.setattr(dsk, "shard_relay", lambda st: relays.append(1) or orig(st))
    assert _port(buckets, used0, n, True, progress_every=4) == want
    assert _untimed(capsys.readouterr().err) == jlines
    assert _port(buckets, used0, n, False, progress_every=4) == single
    lines = _untimed(capsys.readouterr().err)
    assert (_recounts(lines) > 0) == (knobs != "pcap")
    assert relays  # the kernel engine relaid its shards


def test_kernel_engine_replicas_agree(corpus, monkeypatch):
    """Through a run with recount rounds, rebuilds and relays every replica
    holds the same table multiset, equal to the live table of the plain
    loop at every segment end."""
    from youtokentome_tpu_torch.parallel.train_delta_sharded import PlainShardedEngine
    from youtokentome_tpu_torch.ops.train_stream import flatten_word_buckets

    monkeypatch.setenv("YTTM_TRAIN_REPACK_MIN", "16")
    monkeypatch.setenv("YTTM_TRAIN_PCAP", "16")  # the kernel tables: 32 slots
    _, _, buckets, used0 = corpus
    t, wid, freq = (np.asarray(x) for x in flatten_word_buckets(buckets))
    seg_t, seg_w, per = _shard_stream(t, wid, 4)
    rules = np.full((VOCAB, 4), -1, np.int32)
    from youtokentome_tpu_torch.ops.train_delta import host_count_table

    plain = PlainShardedEngine(seg_t, seg_w, per, freq, rules, used0, VOCAB, 16, _cpu(4), 64, 8,
                               host_count_table(t, wid, freq))
    kern = dsk.ShardedKernelEngine(seg_t, seg_w, per, freq, rules, used0, VOCAB, 16, _cpu(4), 8,
                                   t.shape[0])

    def complete(eng, used, limit):
        while True:
            used, done, overflow = eng.segment(used, limit)
            if not overflow:
                return used, done
            eng.regrow()

    used = used0
    while used < VOCAB:
        limit = min(VOCAB, used + 2)
        got = complete(kern, used, limit)
        assert got == complete(plain, used, limit)
        used = got[0]
        live_k = np.asarray(plain.tk[: int((plain.tc > 0).sum())])
        for st in kern.shards:
            keys, cnts = st.table()
            np.testing.assert_array_equal(keys[cnts > 0], live_k)
            np.testing.assert_array_equal(cnts[cnts > 0], np.asarray(plain.tc[plain.tc > 0]))
        assert torch.equal(kern.rules, plain.rules)
        kt, kw, _ = kern.stream()
        pt, pw, _ = plain.stream()
        live = pt >= 0
        # the relaid streams hold the plain loop's words, in order, but for
        # words that had fewer than two live tokens at a relay
        pl = pw[live].numpy()
        kept = np.isin(pl, kw.numpy())
        assert torch.equal(kt, pt[live][torch.from_numpy(kept)])
        assert torch.equal(kw, pw[live][torch.from_numpy(kept)])
        assert (np.bincount(pl)[np.unique(pl[~kept])] < 2).all()
        if got[1]:
            break
    assert kern.relays > 0 and kern.rebuilds > 0


FOLD_CASES = ("delta", "rebuild", "rovf", "missing")


def _fold_shards(n: int, case: str):
    """n hand-made CPU shards (dcap 8, tables of 128 slots) whose replicas
    hold the same count of every shard's stream, with the exchange of one
    round laid out for ``case``: "delta" buffers with entries of both signs
    (the last shard's empty), "missing" the same with a subtraction from a
    key no replica holds, "rebuild" DOVF set on one shard and every
    shard's stream recounted into its scratch table, "rovf" that with one
    scratch table's overflow flag set."""
    rng = np.random.default_rng(10 + n)
    shards = []
    for s in range(n):
        lens = rng.integers(2, 5, size=6)
        t = rng.integers(4, 10, size=int(lens.sum())).astype(np.int32)
        wid = np.repeat(np.arange(6, dtype=np.int32), lens)
        freq = rng.integers(1, 4, size=6).astype(np.int32)
        rules = np.full((VOCAB, 4), -1, np.int32)
        shards.append(dsk.ShardState(t, wid, freq, rules, 10, 128, 8, "cpu"))
    # every replica from every shard's count: the recount branch, forced
    for st in shards:
        st.ctl[dsk.DOVF] = 1
    for st in shards:
        dsk.shard_recount_plain(st, shards)
    for st in shards:
        dsk.shard_fold_plain(st, shards)
    for st in shards:
        st.ctl[dsk.DOVF] = st.ctl[dsk.NREC] = 0
    if case in ("rebuild", "rovf"):
        shards[n // 2].ctl[dsk.DOVF] = 1
        for st in shards:
            dsk.shard_recount_plain(st, shards)
        if case == "rovf":
            shards[-1].ctl[dsk.ROVF] = 1
        return shards
    keys, cnts = shards[0].table()
    live = keys[cnts > 1]
    for s, st in enumerate(shards[:-1]):
        old = live[rng.choice(live.size, size=min(3, live.size), replace=False)]
        new = np.array([(20 + s) << 32 | y for y in range(4, 4 + 2 * s + 1)], np.int64)
        if case == "missing" and s == 0:
            old = np.append(old, np.int64(60 << 32 | 61))
        for side, ks, v in ((0, old, -1), (1, new, 2)):
            st.ctl[dsk.DN_OLD + side] = ks.size
            st.dk[side * 8 : side * 8 + ks.size] = torch.from_numpy(ks)
            st.dv[side * 8 : side * 8 + ks.size] = v
    return shards


@pytest.mark.parametrize("case", FOLD_CASES)
@pytest.mark.parametrize("n", [2, 4])
def test_fold_entries_match_shard_fold_plain(n, case):
    """The fold's entries (their plain versions, all of a device's replicas
    in one call, the branch picked by the shards' flags or given) against
    ``shard_fold_plain`` replica by replica: the same table multiset, ctl
    (OCC, NREC, OVERFLOW, ERROR among it) and work."""
    import copy

    base = _fold_shards(n, case)
    want = copy.deepcopy(base)
    for st in want:
        dsk.shard_fold_plain(st, want)
    rebuild = case in ("rebuild", "rovf")
    assert int(want[0].ctl[dsk.NREC]) == int(rebuild)
    assert int(want[0].ctl[dsk.OVERFLOW]) == (case == "rovf")
    assert int(want[0].ctl[dsk.ERROR]) == (case == "missing")
    for route in (None, rebuild):
        got = copy.deepcopy(base)
        dsk.shard_fold(got, got, route)
        for i, (a, b) in enumerate(zip(got, want)):
            for x, y in zip(a.table(), b.table()):
                np.testing.assert_array_equal(x, y, err_msg=f"replica {i}, route {route}")
            assert torch.equal(a.ctl, b.ctl), (i, route, a.ctl.tolist(), b.ctl.tolist())
            assert torch.equal(a.work, b.work), (i, route)


def _state_pair(corpus):
    from youtokentome_tpu.models.state import BPEState as JState
    from youtokentome_tpu.oracle import rename_tokens

    _, alpha, _, _ = corpus
    rules = _single()
    char2id, renamed = rename_tokens(alpha.char2id, rules, JSpecial(0, 1, 2, 3), VOCAB)
    js = JState(char2id=char2id, rules=renamed, special_tokens=JSpecial(0, 1, 2, 3))
    return js, BPEState.loads(js.dumps())


def test_dispatch(corpus, monkeypatch):
    """``auto`` on a mesh of 8 visible devices takes the sharded trainer;
    YTTM_DEVICES=1 takes none; rules and char2id equal each other and the
    JAX package's; ``sparse`` on the mesh takes the sharded v3 trainer, with
    the JAX package's rules and char2id."""
    cps = corpus[0]
    cfg = BpeConfig(1.0, -1, SpecialTokens(0, 1, 2, 3))
    monkeypatch.setenv("YTTM_SHARD_MIN_TOKENS", "1")
    monkeypatch.setattr(mesh_mod, "visible_devices", lambda dev: [torch.device("cpu")] * 8)
    seen = []
    orig = port.run_training_delta_sharded

    def spy(buckets, used0, vocab, mesh, **kw):
        seen.append(mesh.size)
        return orig(buckets, used0, vocab, mesh, **kw)

    monkeypatch.setattr(port, "run_training_delta_sharded", spy)
    sharded = port.train_from_codepoints(cps, VOCAB, cfg, "cpu")
    assert seen == [8]
    want = j_train(cps, VOCAB, JConfig(1.0, -1, JSpecial(0, 1, 2, 3)))
    monkeypatch.setenv("YTTM_DEVICES", "1")
    single = port.train_from_codepoints(cps, VOCAB, cfg, "cpu")
    assert seen == [8]
    for st in (sharded, single):
        assert st.rules == want.rules and st.char2id == want.char2id
    monkeypatch.delenv("YTTM_DEVICES")
    monkeypatch.setenv("YTTM_SHARD_MIN_TOKENS", str(10**9))
    port.train_from_codepoints(cps, VOCAB, cfg, "cpu")
    assert seen == [8]  # below the serial cutoff
    monkeypatch.setenv("YTTM_SHARD_MIN_TOKENS", "1")
    monkeypatch.setenv("YTTM_TRAIN_IMPL", "sparse")
    orig_sparse = port.run_training_sparse_sharded

    def spy_sparse(buckets, used0, vocab, mesh, **kw):
        seen.append(("sparse", mesh.size))
        return orig_sparse(buckets, used0, vocab, mesh, **kw)

    monkeypatch.setattr(port, "run_training_sparse_sharded", spy_sparse)
    sparse = port.train_from_codepoints(cps, VOCAB, cfg, "cpu")
    assert seen == [8, ("sparse", 8)]
    want = j_train(cps, VOCAB, JConfig(1.0, -1, JSpecial(0, 1, 2, 3)))
    assert sparse.rules == want.rules and sparse.char2id == want.char2id


@pytest.mark.parametrize("n", SHARDS)
def test_encode_batch_sharded_matches_jax(corpus, n):
    js, ts = _state_pair(corpus)
    jenc, enc = JEncoder(js), Encoder(ts, device="cpu")
    rng = np.random.default_rng(1)
    ids = np.asarray(enc._sorted_ids)
    tokens = np.full((63, 12), -1, dtype=np.int32)  # 63 rows: PAD rows added
    for i in range(63):
        ln = int(rng.integers(1, 11))
        tokens[i, 0] = enc.space_id
        tokens[i, 1 : 1 + ln] = rng.choice(ids, size=ln)
    want = j_encode_sharded(jenc.tables, tokens, j_mesh(n))
    np.testing.assert_array_equal(want, j_encode_batch(jenc.tables, tokens))
    np.testing.assert_array_equal(es.encode_batch_sharded(enc.tables, tokens, _cpu(n)), want)


@pytest.mark.parametrize("backend", ["native", "stream"])
def test_encoder_on_a_mesh(corpus, backend, monkeypatch):
    """An Encoder on a mesh (explicit, or the default over 8 visible
    devices) gives the ids of one without and of the JAX Encoder on its 8
    devices; the native path's merges go through the sharded route."""
    js, ts = _state_pair(corpus)
    monkeypatch.setenv("YTTM_ENCODE_BACKEND", backend)
    monkeypatch.setenv("YTTM_ENCODE_MERGE", "device")
    rng = random.Random(7)
    sents = ["".join(rng.choice("abc ") for _ in range(40)) for _ in range(50)]
    calls = []
    orig = es.encode_greedy_sharded
    monkeypatch.setattr(es, "encode_greedy_sharded", lambda *a: calls.append(1) or orig(*a))
    jenc = JEncoder(js)
    assert jenc._get_mesh() is not None
    want = jenc.encode(sents, "id")
    assert Encoder(ts, device="cpu")._get_mesh() is None  # one CPU device
    assert Encoder(ts, device="cpu").encode(sents, "id") == want
    assert Encoder(ts, device="cpu", mesh=_cpu(8)).encode(sents, "id") == want
    monkeypatch.setattr(mesh_mod, "visible_devices", lambda dev: [torch.device("cpu")] * 8)
    enc = Encoder(ts, device="cpu")
    assert enc._get_mesh().size == 8
    assert enc.encode(sents, "id") == want
    monkeypatch.setenv("YTTM_DEVICES", "1")
    assert Encoder(ts, device="cpu")._get_mesh() is None
    assert bool(calls) == (backend == "native")


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_resumes_in_both_packages(corpus, writer, tmp_path, monkeypatch):
    """A checkpoint of a sharded run (the port's written after its streams
    were relaid) resumes to the same rules under the JAX package's sharded
    trainer and the port's one-device and sharded trainers."""
    _, _, buckets, used0 = corpus
    monkeypatch.setenv("YTTM_TRAIN_REPACK_MIN", "16")
    want = _single()
    ck = str(tmp_path / "ck.npz")
    if writer == "port":
        relays = []
        orig = dsk.shard_relay
        monkeypatch.setattr(dsk, "shard_relay", lambda st: relays.append(1) or orig(st))
        _port(buckets, used0, 2, False, checkpoint_path=ck, checkpoint_every=8)
        assert relays
    else:
        j_sharded(buckets, used0, VOCAB, j_mesh(2), checkpoint_path=ck, checkpoint_every=8)
    assert used0 < int(np.load(ck)["used"]) < VOCAB
    assert j_sharded(buckets, used0, VOCAB, j_mesh(2), resume_path=ck) == want
    assert run_training_delta(buckets, used0, VOCAB, resume_path=ck, device="cpu") == want
    for plain in (True, False):
        assert _port(buckets, used0, 8, plain, resume_path=ck) == want


# delta_emit's layout edges: words of these slot counts (a warp's pack of
# 32 lanes, its edges, and words that take the warp alone)
EMIT_WORD_LENS = (1, 2, 31, 32, 33, 40)
EMIT_CANDS = ([(4, 4), (5, 6)], [(6, 7), (5, 5), (7, 4)])
EMIT_SLOTS = 1024  # the JAX stream's slots


def _emit_stream(seed: int):
    """(t, wid, freq) of words of EMIT_WORD_LENS slots over ids 4-7, each
    length several times, with runs of one id of 2-9 tokens (run parity)
    at random offsets; weights 1-5, and one word of weight 0."""
    rng = np.random.default_rng(seed)
    words = []
    for n in EMIT_WORD_LENS * 3:
        w = rng.integers(4, 8, n)
        r = int(rng.integers(2, 10))
        if n > r:
            at = int(rng.integers(0, n - r + 1))
            w[at : at + r] = int(rng.integers(4, 8))
        words.append(w.astype(np.int32))
    t = np.concatenate(words)
    wid = np.repeat(np.arange(len(words), dtype=np.int32), [w.size for w in words])
    freq = rng.integers(1, 6, len(words)).astype(np.int32)
    freq[3] = 0
    return t, wid, freq


def _set_round(st, cands, used: int):
    """Make ``cands`` the accepted rows of a new round of shard ``st``, as
    its top-k leaves them (the candidates' ids from ``used`` on)."""
    from youtokentome_tpu_torch.ops import train_kernels as tk

    rows = [[x, y, used + j, 1] for j, (x, y) in enumerate(cands)]
    st.cand.zero_()
    st.cand[: len(cands)] = torch.tensor(rows, dtype=torch.int32)
    st.ctl[tk.NACC] = len(cands)
    st.ctl[tk.ROUND] += 1
    st.ctl[[dsk.NAFF, dsk.DN_OLD, dsk.DN_NEW, dsk.DOVF]] = 0


def _jax_counts(t, wid, freq, cands, used: int, dcap: int):
    """The JAX round body's old and new contribution counts and overflow
    flags (``pair_hits``, ``_affected_positions``, ``_delta_contributions``
    and ``apply_accepted``) on the stream, with ``cands`` accepted; and the
    stream after the merge."""
    import jax.numpy as jnp

    from youtokentome_tpu.ops.train_delta import _affected_positions, _delta_contributions
    from youtokentome_tpu.ops.train_stream import apply_accepted, pair_hits

    # one length for every stream, so that JAX compiles each function once
    pad = np.full(EMIT_SLOTS - t.size, -1, np.int32)
    tj, wj = jnp.asarray(np.concatenate([t, pad])), jnp.asarray(np.concatenate([wid, pad]))
    fw = jnp.asarray(np.concatenate([freq[wid], np.zeros(pad.size, np.int32)]))
    cx = np.zeros(16, np.int32)
    cy = np.zeros(16, np.int32)
    acc = np.zeros(16, bool)
    for j, (x, y) in enumerate(cands):
        cx[j], cy[j], acc[j] = x, y, True
    cx, cy, acc = jnp.asarray(cx), jnp.asarray(cy), jnp.asarray(acc)
    zs = jnp.asarray(used + np.arange(16, dtype=np.int32))
    hit, rix = pair_hits(tj, wj, acc, cx, cy)
    aff = _affected_positions(tj, wj, hit)
    _, _, n_old, of_old = _delta_contributions(tj, wj, fw, aff, dcap, np.int32(-1), False)
    t2, w2, fw2, aff2 = apply_accepted(tj, wj, acc, cx, cy, zs, extra=(fw, aff.astype(jnp.int32)),
                                       hit=hit, rix=rix)
    _, _, n_new, of_new = _delta_contributions(t2, w2, fw2, aff2 != 0, dcap, np.int32(1), False)
    return int(n_old), int(n_new), bool(of_old | of_new), np.asarray(t2)


@pytest.mark.parametrize("tight", [0, 1])
@pytest.mark.parametrize("seed", [0, 1])
def test_delta_emit_counts_match_jax(seed, tight):
    """delta_emit's DN_OLD, DN_NEW (the full counts, past dcap too) and DOVF
    equal the JAX round body's contribution counts and overflow flags, over
    two rounds on words of 1, 2, 31, 32, 33 and 40 slots with runs of equal
    tokens, with dcap at the round's larger count and at one less; the
    merged stream equals JAX's."""
    t, wid, freq = _emit_stream(seed)
    rules = np.full((VOCAB, 4), -1, np.int32)
    used = 8
    jt, jw = t, wid
    st = dsk.ShardState(t, wid, freq, rules, used, 256, 1, "cpu")
    for cands in EMIT_CANDS:
        n_old, n_new, _, t2 = _jax_counts(jt, jw, freq, cands, used, 1 << 20)
        dcap = max(n_old, n_new) - tight
        want = _jax_counts(jt, jw, freq, cands, used, dcap)
        assert want[2] == bool(tight)
        st.buffers(dcap)
        _set_round(st, cands, used)
        dsk.delta_emit([st])
        got = (int(st.ctl[dsk.DN_OLD]), int(st.ctl[dsk.DN_NEW]), bool(st.ctl[dsk.DOVF]))
        assert got == want[:3], cands
        live_t, live_w = st.stream()
        keep = t2 >= 0
        np.testing.assert_array_equal(live_t.numpy(), t2[keep])
        jt, jw = t2[keep], live_w.numpy()
        used += len(cands)


def _emit_shards(n: int):
    """n CPU shards of ``_emit_stream``'s words (shard 1 with none when n >
    1), on a kernel engine over ``DataMesh(["cpu"] * n)``, after one top-k
    each."""
    from youtokentome_tpu_torch.ops import train_kernels as tk

    t, wid, freq = _emit_stream(5)
    cut = np.array_split(np.unique(wid), max(n - 1, 1))
    parts = [wid[np.isin(wid, c)] for c in cut]
    if n > 1:
        parts.insert(1, wid[:0])
    per = 1024
    seg_t = np.full((n, per), -1, np.int32)
    seg_w = np.full((n, per), -1, np.int32)
    o = 0
    for d, p in enumerate(parts):
        seg_t[d, : p.size] = t[o : o + p.size]
        seg_w[d, : p.size] = p
        o += p.size
    rules = np.full((VOCAB, 4), -1, np.int32)
    eng = dsk.ShardedKernelEngine(seg_t, seg_w, per, freq, rules, 8, VOCAB, 16, _cpu(n), 64,
                                  t.size)
    for st in eng.shards:
        tk.topk_accept(st, VOCAB, VOCAB, 8)
    return eng


@pytest.mark.parametrize("n", [1, 2, 4])
def test_delta_emit_card_matches_plain(n):
    """The per-card wrapper over a CPU mesh's n shards (one with no words
    for n > 1) equals delta_emit_plain shard by shard: streams, ctl, work,
    and each side of the buffer as a multiset; the empty shard untouched."""
    import copy

    eng = _emit_shards(n)
    shards = eng.shards
    assert [st.n_words == 0 for st in shards] == [n > 1 and i == 1 for i in range(n)]
    want = copy.deepcopy(shards)
    for st in want:
        if st.n_words:
            dsk.delta_emit_plain(st)
    dsk.delta_emit(shards)
    assert int(shards[0].ctl[dsk.NACC]) > 0
    for a, b in zip(shards, want):
        assert torch.equal(a.tok, b.tok) and torch.equal(a.ctl, b.ctl)
        assert torch.equal(a.work, b.work)
        for side in (0, 1):
            (ka, va), (kb, vb) = a.buffer(side), b.buffer(side)
            assert sorted(zip(ka.tolist(), va.tolist())) == sorted(zip(kb.tolist(), vb.tolist()))
    assert all(int(st.ctl[dsk.DN_OLD]) > 0 for st in shards if st.n_words)
