"""The torch port's v5 tiered trainer against the JAX package's, on the CPU:
the plain round loop field for field against ``train_rounds_tiered`` in
every forced branch, and the host loop (the kernels' plain versions, and the
plain round loop) against the JAX v5 and v2 trainers: rules, progress
lines, checkpoints across packages, ``.yttm`` bytes and training stderr.
All values are integers: equality is exact (tolerance 0)."""

import random
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import youtokentome_tpu as jyttm
import youtokentome_tpu_torch as yttm
from youtokentome_tpu.host import preprocess as j_pre
from youtokentome_tpu.ops import train_delta as jtd
from youtokentome_tpu.ops import train_tiered as jtt
from youtokentome_tpu_torch import train as port
from youtokentome_tpu_torch.ops import tiered_kernels as tk
from youtokentome_tpu_torch.ops import train_tiered as tt
from youtokentome_tpu_torch.ops.train_delta import PADKEY


_DELTA = {}


def _jax_delta(name, buckets, u0, vocab):
    """The JAX v2 rules, once per corpus for all the cases that share it."""
    if name not in _DELTA:
        _DELTA[name] = jtd.run_training_delta(buckets, u0, vocab)
    return _DELTA[name]


@pytest.fixture(autouse=True)
def _quiet(monkeypatch):
    monkeypatch.setenv("YTTM_TRAIN_LOG", "0")


def _buckets(seed, n_words=300, n=2000, letters="abcde", max_len=8):
    rng = random.Random(seed)
    words = ["".join(rng.choice(letters) for _ in range(rng.randint(2, max_len))) for _ in range(n_words)]
    text = " ".join(rng.choice(words) for _ in range(n))
    cps = np.array([ord(c) for c in text], dtype=np.uint32)
    uniq, cnt, dl = j_pre.char_frequencies(cps)
    al = j_pre.build_alphabet(uniq, cnt, dl, 1.0, 4)
    return j_pre.training_word_buckets(cps, al), len(al.char2id) + 4


# -- the plain round loop against train_rounds_tiered -------------------------

B_LOOP = 16
BASE = dict(pcap=1024, hcap=64, dcap=4096, qcap=16384, KB1=256, KBm=1024, KB2=4096)
CASES = {
    "tiers": dict(KB1=2, KBm=4, KB2=8),  # mini at KB1 and KBm, mid and full tiers
    "refresh": dict(hcap=16),  # a hot tier of 16: refresh rounds
    "pending": dict(dcap=64, qcap=128),  # the pending buffer fills; deltas overflow dcap
    "overflow": dict(pcap=None),  # pcap just above the initial pairs
}


def _jax_keys(keys, vals) -> list:
    """A JAX key tuple (narrow) and values -> sorted (x, y, v), pads dropped."""
    k = np.asarray(keys[0]).astype(np.int64)
    v = np.asarray(vals)
    live = k != 0xFFFFFFFF
    return sorted(zip((k[live] >> 16).tolist(), (k[live] & 0xFFFF).tolist(), v[live].tolist()))


def _port_keys(keys, vals) -> list:
    k, v = keys.numpy(), vals.numpy()
    live = k != PADKEY
    return sorted(zip((k[live] >> 32).tolist(), (k[live] & 0xFFFFFFFF).tolist(), v[live].tolist()))


@pytest.mark.parametrize("case", list(CASES))
def test_round_loop_matches_jax(case):
    buckets, u0 = _buckets(5)
    V = u0 + 200
    t, wid, freq = jtt.flatten_word_buckets_blocked_snug(buckets, B_LOOP)
    uk, uc = jtd.host_count_table(t, wid, freq)
    cfg = {**BASE, **CASES[case]}
    if cfg["pcap"] is None:
        cfg["pcap"] = uk.size + 2
    ck, cc = jtd._fit_table(uk, uc, cfg["pcap"], False)
    hk, hc, T = jtt.host_resplit(uk, uc, cfg["hcap"], False)
    qk = (jnp.full((cfg["qcap"],), jtd.PADKEY, jnp.uint32),)
    qv = jnp.zeros((cfg["qcap"],), jnp.int32)
    sig = jtt.sig_build_host(t.reshape(-1, B_LOOP))
    rules = np.full((V, 4), -1, np.int32)
    want = jtt.train_rounds_tiered(
        jnp.asarray(t), jnp.asarray(wid), jnp.asarray(freq), jnp.asarray(sig), hk, hc,
        jnp.asarray(T, jnp.int32), ck, cc, qk, qv, jnp.asarray(0, jnp.int32), jnp.asarray(rules),
        jnp.asarray(u0, jnp.int32), jnp.asarray(u0, jnp.int32), jnp.asarray(V, jnp.int32),
        vocab_size=V, batch_k=16, B=B_LOOP, **cfg,
    )
    pck, pcc = tt._fit_table(uk, uc, cfg["pcap"], "cpu")
    phk, phc, pT = tt.host_resplit(uk, uc, cfg["hcap"], "cpu")
    P = torch.from_numpy
    got = tt.train_rounds_tiered(
        P(t), P(wid), P(freq), tt.sig_build_host(t.reshape(-1, B_LOOP)), phk, phc, pT, pck, pcc,
        torch.full((cfg["qcap"],), PADKEY, dtype=torch.int64),
        torch.zeros(cfg["qcap"], dtype=torch.int32), 0, P(rules.copy()), u0, u0, V,
        vocab_size=V, batch_k=16, B=B_LOOP, **cfg,
    )
    (wt, ww, wsig, (whk, whc, wT), (wck, wcc), (wqk, wqv, wqn), wrules, wused, wdone, wovf,
     wns, wstats) = want
    (gt, gw, gsig, (ghk, ghc, gT), (gck, gcc), (gqk, gqv, gqn), grules, gused, gdone, govf,
     gns, gstats) = got
    assert np.array_equal(gt.numpy(), np.asarray(wt))
    assert np.array_equal(gw.numpy(), np.asarray(ww))
    assert np.array_equal(gsig.numpy().view(np.uint32), np.asarray(wsig))
    assert gT == int(wT)
    assert _port_keys(ghk, ghc) == _jax_keys(whk, whc)
    assert _port_keys(gck, gcc) == _jax_keys(wck, wcc)
    assert gqn == int(wqn) and _port_keys(gqk, gqv) == _jax_keys(wqk, wqv)
    assert np.array_equal(grules.numpy(), np.asarray(wrules))
    assert (gused, gdone, govf, gns) == (int(wused), bool(wdone), bool(wovf), int(wns))
    assert gstats == np.asarray(wstats).tolist()
    # the case reached its branch
    st = gstats
    if case == "tiers":
        assert st[2] > 0 and st[3] > 0
    elif case == "refresh":
        assert st[1] > 1
    elif case == "pending":
        assert st[1] > 1 and gused == V
    else:
        assert govf


# -- the host loop ------------------------------------------------------------


@pytest.fixture(params=["kernels", "plain"])
def plain(request):
    """The kernels' plain versions, or the plain round loop."""
    return request.param == "plain"


def _fold_buckets():
    """The JAX package's row-fold case (test_train_sparse.py), smaller."""
    rng = random.Random(77)
    words = ["".join(rng.choice("abcd") for _ in range(rng.randint(3, 10))) for _ in range(800)]
    text = " ".join(rng.choice(words) for _ in range(3000))
    cps = np.array([ord(c) for c in text], dtype=np.uint32)
    uniq, cnt, dl = j_pre.char_frequencies(cps)
    al = j_pre.build_alphabet(uniq, cnt, dl, 1.0, 4)
    return j_pre.training_word_buckets(cps, al), len(al.char2id) + 4


_JAX_FOLD_ERR = []  # the JAX v5 trainer's stderr on the fold case, once


def test_row_fold(plain, monkeypatch, capsys):
    """The row fold (YTTM_TRAIN_FOLD_MIN=16, YTTM_TRAIN_B=16) halves m in
    the progress lines and changes no rule; the plain round loop's lines
    equal the JAX trainer's, stats included, but for the time and rate.
    The kernel engine (plain versions) keeps ctl[LIVE] equal to the stream's
    live tokens at every segment end, runs the fold's plan exactly at the
    segment ends where ``fold_wanted`` holds, and folds at the same
    segments as the JAX trainer (its m= values)."""
    buckets, u0 = _fold_buckets()
    want = _jax_delta("fold", buckets, u0, 600)
    monkeypatch.setenv("YTTM_TRAIN_FOLD_MIN", "16")
    monkeypatch.setenv("YTTM_TRAIN_B", "16")
    ends = []  # (planned, fold_wanted on the stream) at each kernel segment end
    if not plain:
        seg, fold, plan = tk.TieredKernelEngine.segment, tk.fold_rows, tk.fold_plan_plain
        plans = []

        def segment(self, used, limit):
            out = seg(self, used, limit)
            live = int((self.st.tok >= 0).sum())
            assert int(self.st.ctl[tk.LIVE]) == live, "ctl[LIVE] != the stream's live tokens"
            return out

        def fold_rows(st, live):
            assert live == int((st.tok >= 0).sum())
            plans.clear()
            wanted = tt.fold_wanted(st.NB * st.B, st.B, live)
            out = fold(st, live)
            ends.append((bool(plans), wanted))
            return out

        monkeypatch.setattr(tk.TieredKernelEngine, "segment", segment)
        monkeypatch.setattr(tk, "fold_rows", fold_rows)
        monkeypatch.setattr(tk, "fold_plan_plain", lambda st: plans.append(1) or plan(st))
    capsys.readouterr()
    got = tt.run_training_tiered(buckets, u0, 600, progress_every=200, plain=plain)
    assert got == want
    err = capsys.readouterr().err
    ms = [int(x) for x in re.findall(r"m=(\d+)", err)]
    assert ms and min(ms) < max(ms), f"row fold never fired: {ms}"
    if not _JAX_FOLD_ERR:
        jtt.run_training_tiered(buckets, u0, 600, progress_every=200)
        _JAX_FOLD_ERR.append(capsys.readouterr().err)
    jerr = _JAX_FOLD_ERR[0]
    assert ms == [int(x) for x in re.findall(r"m=(\d+)", jerr)]
    if plain:  # the plain round loop is the JAX program: the same lines
        strip = lambda s: re.sub(r"\(.*?merges/s\)", "", s)  # noqa: E731
        assert strip(err) == strip(jerr)
    else:
        assert ends and all(p == w for p, w in ends), ends
        assert any(w for _, w in ends) and not all(w for _, w in ends), ends


def test_wide_vocab(plain):
    """Merge ids cross 65535 (a ~65k-character alphabet)."""
    rng = random.Random(41)
    pool = [cp for r in (range(0x2000, 0xD7FF), range(0x10000, 0x18000)) for cp in r if cp != 0x2581]
    singles = " ".join(chr(cp) for cp in pool[:65400])
    words = [
        "".join(chr(rng.choice(pool[65400:65500])) for _ in range(rng.randint(2, 5)))
        for _ in range(300)
    ]
    text = singles + " " + " ".join(rng.choice(words) for _ in range(3000))
    cps = np.array([ord(c) for c in text], dtype=np.uint32)
    uniq, cnt, dl = j_pre.char_frequencies(cps)
    al = j_pre.build_alphabet(uniq, cnt, dl, 1.0, 4)
    buckets, u0 = j_pre.training_word_buckets(cps, al), len(al.char2id) + 4
    assert 65400 < u0 < 65536
    vocab = u0 + 120
    want = _jax_delta("wide", buckets, u0, vocab)
    assert max(z for _, _, z in want) >= 65536
    assert tt.run_training_tiered(buckets, u0, vocab, plain=plain) == want


def test_long_word_falls_back_to_delta(plain, monkeypatch):
    """A word longer than 512 tokens: the delta trainer runs instead."""
    rng = random.Random(3)
    text = "ab" * 300 + " " + " ".join(
        "".join(rng.choice("abc") for _ in range(rng.randint(2, 6))) for _ in range(300)
    )
    cps = np.array([ord(c) for c in text], dtype=np.uint32)
    uniq, cnt, dl = j_pre.char_frequencies(cps)
    al = j_pre.build_alphabet(uniq, cnt, dl, 1.0, 4)
    buckets, u0 = j_pre.training_word_buckets(cps, al), len(al.char2id) + 4
    calls = []
    orig = tt.run_training_delta
    monkeypatch.setattr(tt, "run_training_delta", lambda *a, **k: calls.append(k) or orig(*a, **k))
    want = _jax_delta("long", buckets, u0, u0 + 60)
    assert tt.run_training_tiered(buckets, u0, u0 + 60, plain=plain) == want
    assert calls and calls[0]["plain"] == plain


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """The checkpoint tests' corpus, the JAX tiered run's rules and the
    checkpoint it wrote, computed once for both writers."""
    buckets, u0 = _buckets(9)
    vocab = u0 + 150
    ck_j = str(tmp_path_factory.mktemp("jax_checkpoint") / "j.npz")
    want = jtt.run_training_tiered(buckets, u0, vocab, checkpoint_path=ck_j, checkpoint_every=40)
    return buckets, u0, vocab, ck_j, want


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_resumes_across_packages(writer, tmp_path, jax_checkpoint):
    """A checkpoint written by one package resumes in the other; the two
    packages' checkpoints at the same id are byte for byte the same arrays."""
    buckets, u0, vocab, ck_j, want = jax_checkpoint
    ck_p = str(tmp_path / "p.npz")
    tt.run_training_tiered(buckets, u0, vocab, checkpoint_path=ck_p, checkpoint_every=40)
    j, p = np.load(ck_j), np.load(ck_p)
    assert u0 < int(j["used"]) < vocab
    for name in j.files:
        assert np.array_equal(j[name], p[name]), name
    if writer == "jax":
        got = tt.run_training_tiered(buckets, u0, vocab, resume_path=ck_j)
    else:
        got = jtt.run_training_tiered(buckets, u0, vocab, resume_path=ck_p)
    assert got == want == _jax_delta("checkpoint", buckets, u0, vocab)


def test_stats_follow_kbm(plain, monkeypatch, capsys):
    """YTTM_TRAIN_KBM reaches the tiers (the JAX host loop's wiring dropped it):
    a small KBm keeps KB2 small, and rounds that list more rows than KB2
    count as full; a large one makes none full.  Rules do not move."""
    buckets, u0 = _buckets(11, n_words=600, n=4000)
    vocab = u0 + 120
    want = _jax_delta("kbm", buckets, u0, vocab)
    monkeypatch.setenv("YTTM_TRAIN_KB1", "2")
    full = {}
    for kbm in ("2", "65536"):
        monkeypatch.setenv("YTTM_TRAIN_KBM", kbm)
        capsys.readouterr()
        assert tt.run_training_tiered(buckets, u0, vocab, progress_every=vocab, plain=plain) == want
        full[kbm] = sum(int(x) for x in re.findall(r"full=(\d+)", capsys.readouterr().err))
    assert full["2"] > 0 and full["65536"] == 0


def _corpus(tmp_path, seed=5, n=2500):
    p = tmp_path / "corpus.txt"
    rng = np.random.default_rng(seed)
    words = ["".join(rng.choice(list("abcdefghijklmnopqrst"), int(l))) for l in rng.integers(2, 9, 2500)]
    probs = 1.0 / np.arange(1, 2501)
    probs /= probs.sum()
    sel = np.array(words, object)[rng.choice(2500, n * 6, p=probs)]
    p.write_text("\n".join(" ".join(sel[i : i + 6]) for i in range(0, sel.size, 6)) + "\n")
    return str(p)


def test_auto_takes_tiered(tmp_path, capsys, monkeypatch):
    """BPE.train with ``auto`` at or above the (lowered) threshold takes the
    tiered trainer; the model bytes and the default stderr equal the JAX
    package's."""
    monkeypatch.setenv("YTTM_TRAIN_LOG", "1")
    monkeypatch.delenv("YTTM_TRAIN_IMPL", raising=False)
    data = _corpus(tmp_path)
    jyttm.BPE.train(data=data, model=str(tmp_path / "j.yttm"), vocab_size=1100)
    want = capsys.readouterr().err
    calls = []
    orig = port.run_training_tiered
    monkeypatch.setattr(port, "run_training_tiered", lambda *a, **k: calls.append(1) or orig(*a, **k))
    monkeypatch.setattr(port, "TIERED_MIN_TOKENS", 1000)
    yttm.BPE.train(data=data, model=str(tmp_path / "p.yttm"), vocab_size=1100, device="cpu")
    got = capsys.readouterr().err
    assert calls
    assert open(tmp_path / "p.yttm", "rb").read() == open(tmp_path / "j.yttm", "rb").read()
    assert got.replace("p.yttm", "j.yttm") == want


def test_tiered_impl_and_threshold(monkeypatch):
    """YTTM_TRAIN_IMPL=tiered trains; auto stays on delta below the
    threshold."""
    from youtokentome_tpu_torch.models.state import BpeConfig, SpecialTokens

    cps = np.array([ord(c) for c in "abab abba baab aabb " * 30], dtype=np.uint32)
    cfg = BpeConfig(1.0, 1, SpecialTokens(0, 1, 2, 3))
    used = []
    for name in ("run_training_tiered", "run_training_delta"):
        orig = getattr(port, name)
        monkeypatch.setattr(port, name, lambda *a, _o=orig, _n=name, **k: used.append(_n) or _o(*a, **k))
    monkeypatch.setenv("YTTM_TRAIN_IMPL", "tiered")
    a = port.train_from_codepoints(cps, 20, cfg, "cpu")
    monkeypatch.setenv("YTTM_TRAIN_IMPL", "auto")
    b = port.train_from_codepoints(cps, 20, cfg, "cpu")
    assert used == ["run_training_tiered", "run_training_delta"]
    assert a.rules == b.rules


def test_kernel_state_copies_its_inputs():
    """The kernels update the stream in place; the caller's arrays stay."""
    buckets, u0 = _buckets(2)
    t, wid, freq = tt.flatten_word_buckets_blocked_snug(buckets, 64)
    t0 = t.copy()
    eng = tk.TieredKernelEngine(t, wid, freq, np.full((u0 + 30, 4), -1, np.int32), u0, u0 + 30, 16, 64, "cpu")
    eng.segment(u0, u0 + 30)
    assert np.array_equal(t, t0) and not torch.equal(eng.st.tok, torch.from_numpy(t0))


def _complete(eng, used, limit):
    while True:
        used, done, overflow = eng.segment(used, limit)
        if not overflow:
            return used, done
        eng.regrow()


def test_resplit_only_on_due_rounds(monkeypatch):
    """The kernel engine's batch route on the CPU (``tier_rounds``: the
    plain versions, resplit's only on the rounds where one is due, as the
    card's round graph runs it) against the per-call route (resplit's every
    round, a no-op where not due) and the JAX trainer's rules (v2's, which
    the JAX v5 trainer's equal), at a hot tier of 16 so that refresh rounds
    set T > 0: stream, signatures, ctl (T and the stats among it), both
    tables and rules equal at every segment end, the rules a prefix of the
    JAX trainer's."""
    monkeypatch.setenv("YTTM_TRAIN_HCAP", "16")
    buckets, u0 = _buckets(5)
    vocab = u0 + 160
    want = _jax_delta("resplit", buckets, u0, vocab)
    t, wid, freq = tt.flatten_word_buckets_blocked_snug(buckets, B_LOOP)
    rules = np.full((vocab, 4), -1, np.int32)
    engines = {r: tk.TieredKernelEngine(t, wid, freq, rules, u0, vocab, 16, B_LOOP, "cpu")
               for r in ("graph", "calls")}
    engines["calls"].graph = False
    seen = {r: [0, 0] for r in engines}  # resplit_plain calls, and those that were due
    route = ["graph"]
    orig = tk.resplit_plain

    def counted(st, boundary):
        seen[route[0]][0] += 1
        seen[route[0]][1] += tk.resplit_due(st)
        return orig(st, boundary)

    monkeypatch.setattr(tk, "resplit_plain", counted)
    used, t_above = u0, 0
    while used < vocab:
        limit = min(vocab, used + 20)
        ends = {}
        for r, eng in engines.items():
            route[0] = r
            ends[r] = _complete(eng, used, limit)
        a, b = engines["graph"].st, engines["calls"].st
        assert ends["graph"] == ends["calls"]
        assert engines["graph"].stats == engines["calls"].stats
        for name in ("tok", "wid", "sig", "ctl", "rules"):
            assert torch.equal(getattr(a, name), getattr(b, name)), name
        for tab in ("table", "hot_table"):
            (ka, ca), (kb, cb) = getattr(a, tab)(), getattr(b, tab)()
            assert np.array_equal(ka, kb) and np.array_equal(ca, cb), tab
        used, done = ends["graph"]
        got = [tuple(r) for r in a.rules[: used - u0, :3].tolist()]
        assert got == [tuple(r) for r in want[: used - u0]]
        t_above += int(a.ctl[tk.THRESH]) > 0
        if done:
            break
    assert used == vocab and t_above > 0
    (g_calls, g_due), (c_calls, c_due) = seen["graph"], seen["calls"]
    assert g_calls == g_due == c_due >= 2
    assert c_calls > c_due
