"""The torch port's v1 stream trainer and v0 bucketed trainer against the
JAX package's, on the CPU, from inputs made from a seed: the plain round
loops against the JAX programs (v1: the stream, rules, used and done at
every segment end; v0: rules), the kernels' plain versions against the
plain round loops, every trainer with ids above 65535, and the trainers' rules, char2id, ``.yttm`` bytes,
stderr and checkpoints against the JAX package's through
``train_from_codepoints``, ``BPE.train`` and ``cli bpe``.  All values are
integers: equality is exact (tolerance 0)."""

import functools
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from click.testing import CliRunner

import youtokentome_tpu as jyttm
from youtokentome_tpu import cli as jcli
from youtokentome_tpu.host import preprocess as j_pre
from youtokentome_tpu.models.state import BpeConfig as JConfig
from youtokentome_tpu.models.state import SpecialTokens as JSpecial
from youtokentome_tpu.ops import train_delta as jtd
from youtokentome_tpu.ops import train_kernel as jtk0
from youtokentome_tpu.ops import train_sparse as jsp
from youtokentome_tpu.ops import train_stream as jts
from youtokentome_tpu.train import train_from_codepoints as jax_train
import youtokentome_tpu_torch as yttm
from youtokentome_tpu_torch import cli
from youtokentome_tpu_torch import train as port
from youtokentome_tpu_torch.models.state import BpeConfig, SpecialTokens
from youtokentome_tpu_torch.ops import bucketed_kernels as bk
from youtokentome_tpu_torch.ops import train_block as tb
from youtokentome_tpu_torch.ops import stream_train_kernels as sk
from youtokentome_tpu_torch.ops import train_kernel as tk0
from youtokentome_tpu_torch.ops import train_sparse as sp
from youtokentome_tpu_torch.ops import train_stream as ts


def _cps(text):
    return np.array([ord(c) for c in text], dtype=np.uint32)


@pytest.fixture(autouse=True)
def _quiet(monkeypatch):
    monkeypatch.setenv("YTTM_TRAIN_LOG", "0")


def _run_heavy(seed, n=1500, alphabet="abcd "):
    """Text with many runs of equal characters (the parity cases)."""
    rng = random.Random(seed)
    out = []
    while len(out) < n:
        if rng.randrange(2):
            out.append(rng.choice(alphabet))
        else:
            out.extend([rng.choice(alphabet)] * rng.randint(2, 7))
    return "".join(out)


def _buckets(text):
    cps = _cps(text)
    uniq, cnt, n = j_pre.char_frequencies(cps)
    al = j_pre.build_alphabet(uniq, cnt, n, 1.0, 4)
    return j_pre.training_word_buckets(cps, al), len(al.char2id) + 4


BUCKETS, USED0 = _buckets(_run_heavy(0) + " " + "a" * 41 + " " + "ab" * 30)
VOCAB = USED0 + 70


def _complete(eng, used, limit):
    """Rounds up to ``limit`` (or done), regrowing the table on overflow."""
    while True:
        used, done, overflow = eng.segment(used, limit)
        if not overflow:
            return used, done
        eng.regrow()


# -- v1: the plain round loop against the JAX program -------------------------


def test_stream_round_loop_matches_jax_at_every_segment():
    t, wid, freq = ts.flatten_word_buckets(BUCKETS)
    rules = np.full((VOCAB, 4), -1, np.int32)
    jt, jw, jr, ju = jnp.asarray(t), jnp.asarray(wid), jnp.asarray(rules), USED0
    pt, pw, pr, pu = torch.from_numpy(t), torch.from_numpy(wid), torch.from_numpy(rules.copy()), USED0
    pf = torch.from_numpy(freq)
    for limit in (USED0 + 7, USED0 + 30, VOCAB):
        jt, jw, jr, jused, jdone = jts.train_rounds_resumable(
            jt, jw, jnp.asarray(freq), jr, jnp.asarray(ju, jnp.int32), jnp.asarray(USED0, jnp.int32),
            jnp.asarray(limit, jnp.int32), VOCAB,
        )
        ju = int(jused)
        pt, pw, pr, pu, pdone = ts.train_rounds_resumable(pt, pw, pf, pr, pu, USED0, limit, VOCAB)
        assert np.array_equal(np.asarray(jt), pt.numpy()) and np.array_equal(np.asarray(jw), pw.numpy())
        assert np.array_equal(np.asarray(jr), pr.numpy())
        assert (ju, bool(jdone)) == (pu, pdone)
    assert pu == VOCAB


def test_segment_counts_flat_matches_jax():
    rng = np.random.default_rng(3)
    kx = rng.integers(0, 9, 300).astype(np.int32)
    ky = rng.integers(0, 9, 300).astype(np.int32)
    kx[rng.random(300) < 0.2] = jts.BIG
    ky[kx == jts.BIG] = jts.BIG
    wf = rng.integers(0, 5, 300).astype(np.int32)
    jc, jx, jy = jts._segment_counts_flat(jnp.asarray(kx), jnp.asarray(ky), jnp.asarray(wf))
    pc, px, py = ts._segment_counts_flat(torch.from_numpy(kx), torch.from_numpy(ky), torch.from_numpy(wf))
    assert np.array_equal(np.asarray(jc), pc.numpy())
    assert np.array_equal(np.asarray(jx), px.numpy()) and np.array_equal(np.asarray(jy), py.numpy())


# -- v1: the kernels' plain versions against the plain round loop --------------


@pytest.mark.parametrize("pcap", [0, 8])
def test_stream_kernels_match_round_loop(pcap, monkeypatch):
    """Segment by segment, the kernel engine's stream and rules equal the
    plain round loop's; a tiny table (pcap 8, 16 slots) overflows and is
    counted again at twice the size."""
    monkeypatch.setenv("YTTM_TRAIN_PCAP", str(pcap))
    t, wid, freq = ts.flatten_word_buckets(BUCKETS)
    rules = np.full((VOCAB, 4), -1, np.int32)
    kern = sk.StreamKernelEngine(t, wid, freq, rules, USED0, VOCAB, 16, "cpu")
    plain = ts.PlainStreamEngine(t, wid, freq, rules, USED0, VOCAB, 16, "cpu")
    used = USED0
    while used < VOCAB:
        limit = min(VOCAB, used + 9)
        ku, kd = _complete(kern, used, limit)
        pu, pd = _complete(plain, used, limit)
        assert (ku, kd) == (pu, pd)
        assert torch.equal(kern.st.t, plain.t) and torch.equal(kern.st.wid, plain.wid)
        assert torch.equal(kern.rules, plain.rules)
        used = ku
    assert (kern.rebuilds > 0) == (pcap > 0)


# -- v0: the plain round loop and the kernels ---------------------------------


def test_bucketed_round_loop_matches_jax():
    jb = tuple((jnp.asarray(m), jnp.asarray(f)) for m, f in BUCKETS)
    jrules, n = jtk0.train_rounds(jb, jnp.asarray(USED0, jnp.int32), VOCAB)
    pb = [(torch.from_numpy(m.astype(np.int32)), torch.from_numpy(f.astype(np.int32))) for m, f in BUCKETS]
    rules = torch.full((VOCAB, 4), -1, dtype=torch.int32)
    _, rules, used, done = tk0.train_rounds(pb, rules, USED0, USED0, VOCAB, VOCAB)
    assert used - USED0 == int(n) and not done
    assert np.array_equal(np.asarray(jrules), rules.numpy())


def test_apply_merge_rows_and_mask_match_jax():
    from youtokentome_tpu.ops import segment as jseg

    from youtokentome_tpu_torch.ops import segment as pseg

    rng = np.random.default_rng(5)
    rows = rng.integers(0, 3, (40, 12)).astype(np.int32)
    rows[rng.random((40, 12)) < 0.15] = -1
    want = np.asarray(jseg.apply_merge_rows(jnp.asarray(rows), 1, 1, 9))
    assert np.array_equal(pseg.apply_merge_rows(torch.from_numpy(rows), 1, 1, 9).numpy(), want)
    left, right = rows[:, :-1], rows[:, 1:]
    valid = (left >= 0) & (right >= 0)
    want = np.asarray(jseg.pair_count_mask(jnp.asarray(left), jnp.asarray(right), jnp.asarray(valid)))
    got = pseg.pair_count_mask(torch.from_numpy(left), torch.from_numpy(right), torch.from_numpy(valid))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("pcap", [0, 8])
def test_bucketed_kernels_match_round_loop(pcap, monkeypatch):
    """Segment by segment, the kernel engine's rows and rules equal the
    plain round loop's; a tiny table overflows and is regrown."""
    monkeypatch.setenv("YTTM_TRAIN_PCAP", str(pcap))
    rules = np.full((VOCAB, 4), -1, np.int32)
    kern = bk.BucketedKernelEngine(BUCKETS, rules, USED0, VOCAB, "cpu")
    plain = tk0.PlainBucketedEngine(BUCKETS, rules, USED0, VOCAB, "cpu")
    used = USED0
    while used < VOCAB:
        limit = min(VOCAB, used + 11)
        ku, kd = _complete(kern, used, limit)
        pu, pd = _complete(plain, used, limit)
        assert (ku, kd) == (pu, pd)
        flat = torch.cat([t.reshape(-1) for t, _ in plain.buckets])
        assert torch.equal(kern.st.tok, flat)
        assert torch.equal(kern.rules, plain.rules)
        used = ku
    assert (kern.rebuilds > 0) == (pcap > 0)


@pytest.mark.parametrize("plain", [False, True])
def test_run_training_matches_jax(plain, capsys):
    """v0's entry point: rules and the early-stop warning equal the JAX
    package's (the corpus runs out of pairs before vocab 400)."""
    buckets, used0 = _buckets("abab abba baab aabb caba bcab " * 10)
    want = jtk0.run_training(buckets, used0, 400)
    want_err = capsys.readouterr().err
    got = tk0.run_training(buckets, used0, 400, device="cpu", plain=plain)
    assert got == want
    assert capsys.readouterr().err == want_err and want_err.startswith("WARNING merged only")
    assert tk0.run_training(BUCKETS, USED0, VOCAB, device="cpu", plain=plain) == jtk0.run_training(
        BUCKETS, USED0, VOCAB
    )


def test_run_training_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tk0.run_training(BUCKETS, USED0, VOCAB)


# -- the v1 trainer, end to end -------------------------------------------------


@pytest.mark.parametrize("plain", [False, True])
def test_stream_trainer_matches_jax(plain):
    want = jts.run_training_stream(BUCKETS, USED0, VOCAB)
    assert ts.run_training_stream(BUCKETS, USED0, VOCAB, plain=plain) == want
    assert want == jtd.run_training_delta(BUCKETS, USED0, VOCAB)


@pytest.mark.parametrize("impl", ["stream", "bogus"])
def test_impl_through_train_from_codepoints(impl, monkeypatch):
    """``YTTM_TRAIN_IMPL=stream`` trains with v1; an unknown name trains
    with v2, in both packages."""
    monkeypatch.setenv("YTTM_TRAIN_IMPL", impl)
    text = _run_heavy(7, n=900)
    cfg = (1.0, 1, (0, 1, 2, 3))
    a = jax_train(_cps(text), 60, JConfig(cfg[0], cfg[1], JSpecial(*cfg[2])))
    b = port.train_from_codepoints(_cps(text), 60, BpeConfig(cfg[0], cfg[1], SpecialTokens(*cfg[2])), "cpu")
    assert a.rules == b.rules and a.char2id == b.char2id


def _corpus(tmp_path, seed=5, n=600):
    p = tmp_path / "corpus.txt"
    rng = np.random.default_rng(seed)
    words = ["".join(rng.choice(list("abcdefghijklmnopqrst"), int(l))) for l in rng.integers(2, 9, 2500)]
    probs = 1.0 / np.arange(1, 2501)
    probs /= probs.sum()
    sel = np.array(words, object)[rng.choice(2500, n * 6, p=probs)]
    p.write_text("\n".join(" ".join(sel[i : i + 6]) for i in range(0, sel.size, 6)) + "\n")
    return str(p)


def test_stream_yttm_bytes_api_cli_and_stderr(tmp_path, capsys, monkeypatch):
    """BPE.train and cli bpe with ``YTTM_TRAIN_IMPL=stream``: the model
    bytes and the training stderr (config block, preprocessing lines, the
    per-1000 merge log) equal the JAX package's."""
    monkeypatch.setenv("YTTM_TRAIN_IMPL", "stream")
    monkeypatch.setenv("YTTM_TRAIN_LOG", "1")
    data = _corpus(tmp_path, n=1500)
    jm, pm = str(tmp_path / "j.yttm"), str(tmp_path / "p.yttm")
    jyttm.BPE.train(data=data, model=jm, vocab_size=1050, coverage=0.999)
    want = capsys.readouterr().err
    yttm.BPE.train(data=data, model=pm, vocab_size=1050, coverage=0.999, device="cpu")
    got = capsys.readouterr().err
    assert open(pm, "rb").read() == open(jm, "rb").read()
    assert got.replace("p.yttm", "j.yttm") == want
    assert sum(l.startswith("id: 1000=") for l in got.splitlines()) == 1
    monkeypatch.setenv("YTTM_TRAIN_LOG", "0")
    cm, jcm = str(tmp_path / "c.yttm"), str(tmp_path / "jc.yttm")
    args = ["bpe", "--data", data, "--vocab_size", "300", "--bos_id", "9"]
    res = CliRunner().invoke(cli.main, args + ["--model", cm, "--device", "cpu"])
    assert res.exit_code == 0, res.output
    res = CliRunner().invoke(jcli.main, args + ["--model", jcm])
    assert res.exit_code == 0, res.output
    assert open(cm, "rb").read() == open(jcm, "rb").read()


def test_stream_progress_lines(capsys, monkeypatch):
    """``YTTM_TRAIN_PROGRESS``: both packages print a progress line at the
    same ids (the merges/s figures differ)."""
    monkeypatch.setenv("YTTM_TRAIN_LOG", "0")
    jts.run_training_stream(BUCKETS, USED0, VOCAB, progress_every=25)
    want = [l.split("(")[0] for l in capsys.readouterr().err.splitlines()]
    ts.run_training_stream(BUCKETS, USED0, VOCAB, progress_every=25)
    got = [l.split("(")[0] for l in capsys.readouterr().err.splitlines()]
    assert got == want and len(got) == 3


@functools.lru_cache(maxsize=None)
def _wide():
    """The run-heavy buckets with every id moved past 65535 (the JAX wide
    key layout): (buckets, used0, vocab, the JAX v2 rules)."""
    shift = 70000
    buckets = [(np.where(m >= 0, m + shift, m).astype(np.int32), f) for m, f in BUCKETS]
    used0 = USED0 + shift
    vocab = used0 + 60
    return buckets, used0, vocab, jtd.run_training_delta(buckets, used0, vocab)


@pytest.mark.parametrize("impl", ["stream", "sparse", "block", "bucketed"])
def test_wide_vocab(impl):
    """Ids above 65535: every port trainer's rules (through the kernels'
    plain versions) equal the JAX package's v2 rules."""
    buckets, used0, vocab, want = _wide()
    assert min(min(x, y) for x, y, _ in want) >= 65536
    run = {"stream": ts.run_training_stream, "sparse": sp.run_training_sparse,
           "block": tb.run_training_block}.get(impl)
    if run is None:
        got = tk0.run_training(buckets, used0, vocab, device="cpu")
    else:
        got = run(buckets, used0, vocab)
    assert got == want


# -- checkpoints across packages and trainers ----------------------------------


@pytest.mark.parametrize("writer", ["jax-stream", "port-stream", "port-sparse"])
def test_stream_checkpoints_resume_across_packages_and_trainers(writer, tmp_path):
    """A snapshot written by either package's v1 trainer (or the port's v3
    trainer, whose tombstones are compacted on save) resumes in the other
    package's v1 trainer and in the port's v1 engines, to the uninterrupted
    rules."""
    want = jts.run_training_stream(BUCKETS, USED0, VOCAB)
    ck = str(tmp_path / "ck.npz")
    write = {"jax-stream": jts.run_training_stream, "port-stream": ts.run_training_stream,
             "port-sparse": sp.run_training_sparse}[writer]
    write(BUCKETS, USED0, USED0 + 30, checkpoint_path=ck, checkpoint_every=12)
    assert USED0 < int(np.load(ck)["used"]) < USED0 + 30
    if writer != "jax-stream":
        assert jts.run_training_stream(BUCKETS, USED0, VOCAB, resume_path=ck) == want
    for plain in (False, True):
        assert ts.run_training_stream(BUCKETS, USED0, VOCAB, resume_path=ck, plain=plain) == want
    assert jsp.run_training_sparse(BUCKETS, USED0, VOCAB, resume_path=ck) == want
