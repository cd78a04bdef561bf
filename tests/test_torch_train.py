"""The torch port's training, end to end, against the JAX package's v2
delta trainer (``YTTM_TRAIN_IMPL=delta``) and the oracle, on the CPU
(``device="cpu"``: the kernels' plain torch versions run the rounds, or
with ``plain=True`` the plain round loop).  Rules, char2id, ``.yttm``
bytes, checkpoints and training stderr must be identical."""

import random

import numpy as np
import pytest
from click.testing import CliRunner

import youtokentome_tpu as jyttm
import youtokentome_tpu_torch as yttm
from youtokentome_tpu import cli as jcli
from youtokentome_tpu.host import preprocess as j_pre
from youtokentome_tpu.models.state import BpeConfig as JConfig
from youtokentome_tpu.models.state import SpecialTokens as JSpecial
from youtokentome_tpu.ops import train_delta as jtd
from youtokentome_tpu.oracle import train_from_codepoints as oracle_train
from youtokentome_tpu.train import train_from_codepoints as jax_train
from youtokentome_tpu_torch import cli
from youtokentome_tpu_torch import train as port
from youtokentome_tpu_torch.models.state import BpeConfig, SpecialTokens
from youtokentome_tpu_torch.ops import train_delta as td


def _cps(text):
    return np.array([ord(c) for c in text], dtype=np.uint32)


@pytest.fixture(autouse=True)
def _delta(monkeypatch):
    monkeypatch.setenv("YTTM_TRAIN_IMPL", "delta")
    monkeypatch.setenv("YTTM_TRAIN_LOG", "0")


@pytest.fixture(params=["kernels", "plain"])
def engine(request, monkeypatch):
    """Run the port's rounds through the kernels' plain versions, or the
    plain round loop."""
    if request.param == "plain":
        orig = td.run_training_delta
        monkeypatch.setattr(port, "run_training_delta", lambda *a, **k: orig(*a, **k, plain=True))
    return request.param


def _both(cps, vocab, specials=(0, 1, 2, 3), coverage=1.0):
    a = jax_train(cps, vocab, JConfig(coverage, 1, JSpecial(*specials)))
    b = port.train_from_codepoints(cps, vocab, BpeConfig(coverage, 1, SpecialTokens(*specials)), "cpu")
    return a, b


def _assert_same(a, b):
    assert a.rules == b.rules
    assert a.char2id == b.char2id


def _run_heavy(seed, n=1200, alphabet="abc "):
    rng = random.Random(seed)
    out = []
    while len(out) < n:
        if rng.randrange(2):
            out.append(rng.choice(alphabet))
        else:
            out.extend([rng.choice(alphabet)] * rng.randint(2, 6))
    return "".join(out)


@pytest.mark.parametrize("seed", range(4))
def test_run_heavy_random(seed, engine):
    text = _run_heavy(seed)
    a, b = _both(_cps(text), 10 + random.Random(seed).randrange(40))
    _assert_same(a, b)


def _zipf_text(seed, n_words=300, n=3000, letters="abcdefgh"):
    rng = np.random.default_rng(seed)
    words = [
        "".join(rng.choice(list(letters), size=l))
        for l in np.clip(rng.poisson(5, n_words), 2, 10)
    ]
    probs = 1.0 / np.arange(1, n_words + 1)
    probs /= probs.sum()
    return " ".join(np.array(words, object)[rng.choice(n_words, n, p=probs)])


def test_matches_oracle_zipf(engine):
    text = _zipf_text(7)
    cfg = JConfig(1.0, 1, JSpecial(0, 1, 2, 3))
    a = oracle_train(_cps(text), 120, cfg)
    b = port.train_from_codepoints(_cps(text), 120, BpeConfig(1.0, 1, SpecialTokens(0, 1, 2, 3)), "cpu")
    _assert_same(a, b)


def _buckets(text, vocab):
    cps = _cps(text)
    uniq, cnt, n = j_pre.char_frequencies(cps)
    al = j_pre.build_alphabet(uniq, cnt, n, 1.0, 4)
    return j_pre.training_word_buckets(cps, al), len(al.char2id) + 4


@pytest.mark.parametrize("knob", ["YTTM_TRAIN_DCAP", "YTTM_TRAIN_PCAP"])
def test_tiny_capacities(knob, engine, monkeypatch):
    """A delta buffer that overflows every round (recount path), and a
    table just above the initial live pairs, which overflows as merges
    mint new pairs (the doubling retry; the kernels' table rebuild)."""
    from youtokentome_tpu_torch.ops import train_kernels as tk

    if knob == "YTTM_TRAIN_PCAP":
        text, vocab = _zipf_text(3, n=1500), 150
    else:
        text, vocab = "abab abba baab aabb abab abba " * 20, 20
    buckets, used0 = _buckets(text, vocab)
    t, wid, freq = td.flatten_word_buckets(buckets)
    value = td.host_count_table(t, wid, freq)[0].size + 4 if knob == "YTTM_TRAIN_PCAP" else 16
    monkeypatch.setenv(knob, str(value))
    regrows = []
    monkeypatch.setattr(tk.KernelEngine, "regrow", lambda self, f=tk.KernelEngine.regrow: (
        regrows.append(1), f(self)))
    want = jtd.run_training_delta(buckets, used0, vocab)
    got = td.run_training_delta(buckets, used0, vocab, plain=engine == "plain")
    assert got == want
    if knob == "YTTM_TRAIN_PCAP" and engine == "kernels":
        assert regrows


def test_repack_invariance(engine, monkeypatch):
    """Laying the stream out again changes nothing: the plain engines'
    re-packing (halving the padded stream), forced often, and the kernel
    engines' relay (once the live tokens fill less than half the word-laid
    stream), each equal the JAX run without re-packing, in both layouts:
    v2's (every word kept) and the sharded v2 trainer's on two CPU shards
    (the words left with fewer than two live tokens dropped).  Words of 1
    and 2 letters hold one or two live tokens after a merge or two, words
    of 33-40 letters more than a warp's lanes (no word ever holds none: a
    merge leaves a token)."""
    from youtokentome_tpu_torch.ops import delta_sharded_kernels as dsk
    from youtokentome_tpu_torch.ops import train_kernels as tk
    from youtokentome_tpu_torch.parallel.mesh import DataMesh
    from youtokentome_tpu_torch.parallel.train_delta_sharded import run_training_delta_sharded

    rng = random.Random(11)
    lens = [rng.randint(2, 9) for _ in range(300)] + [1, 2] * 40
    lens += [rng.randint(33, 40) for _ in range(6)]
    rng.shuffle(lens)
    text = " ".join("".join(rng.choice("abcd") for _ in range(n)) for n in lens)
    buckets, used0 = _buckets(text, 120)
    monkeypatch.setenv("YTTM_TRAIN_REPACK", "0")
    want = jtd.run_training_delta(buckets, used0, 120)
    monkeypatch.setenv("YTTM_TRAIN_REPACK", "1")
    monkeypatch.setenv("YTTM_TRAIN_REPACK_MIN", "16")
    monkeypatch.setenv("YTTM_TRAIN_PROGRESS", "8")
    relays = []
    monkeypatch.setattr(tk, "relay", lambda st, f=tk.relay: (relays.append("v2"), f(st)))
    monkeypatch.setattr(dsk, "shard_relay", lambda st, f=dsk.shard_relay: (relays.append("sharded"), f(st)))
    assert td.run_training_delta(buckets, used0, 120, plain=engine == "plain") == want
    got = run_training_delta_sharded(buckets, used0, 120, DataMesh(["cpu"] * 2),
                                     plain=engine == "plain")
    assert got == want
    assert sorted(set(relays)) == (["sharded", "v2"] if engine == "kernels" else [])


def _text(seed, n=600, alphabet="abc "):
    rng = random.Random(seed)
    out = [alphabet[0]]
    while len(out) < n:
        if rng.randrange(2):
            out.append(rng.choice(alphabet))
        else:
            seg = [rng.choice(alphabet) for _ in range(rng.randint(1, 4))]
            out.extend(seg * rng.randint(2, 5))
    return "".join(out[:n])


@pytest.mark.parametrize("seed", range(3))
def test_matches_jax_with_coverage(seed):
    rng = random.Random(seed + 1000)
    text = _text(seed, alphabet="abcdefg ")
    vocab = len(set(text)) + 4 + rng.randrange(30)
    coverage = 1.0 if seed == 0 else 1 - rng.random() * 0.4
    a, b = _both(_cps(text), vocab, coverage=coverage)
    _assert_same(a, b)


def test_custom_special_ids():
    a, b = _both(_cps(_text(42)), 30, specials=(0, 7, 5, 11))
    _assert_same(a, b)


def test_early_stop_warning(capsys):
    a, b = _both(_cps("ab ab ab"), 500)
    _assert_same(a, b)
    err = capsys.readouterr().err.splitlines()
    warn = [l for l in err if l.startswith("WARNING merged only")]
    assert len(warn) == 2 and warn[0] == warn[1]


def test_vocab_too_small_raises():
    with pytest.raises(ValueError, match="vocab_size"):
        port.train_from_codepoints(
            _cps("abcdefgh abcdefgh"), 5, BpeConfig(1.0, 1, SpecialTokens(0, 1, 2, 3)), "cpu"
        )


def test_run_heavy_equal_pairs(engine):
    a, b = _both(_cps("aaaa aaaaaa aa aaa bbbb abab aabb"), 12)
    _assert_same(a, b)


def test_long_words():
    """Words longer than 512 and 4096 tokens (a run, and an alternation)."""
    rng = random.Random(3)
    text = "a" * 5000 + " " + "ab" * 2100 + " " + " ".join(
        "".join(rng.choice("abc") for _ in range(rng.randint(2, 6))) for _ in range(200)
    ) + " " + "abc" * 200
    a, b = _both(_cps(text), 200)
    _assert_same(a, b)


def test_wide_vocab():
    """Ids above 65535: a ~65k-character alphabet pushes the merge ids
    past 65536 (the JAX wide key layout); both engines."""
    rng = random.Random(41)
    pool = [cp for r in (range(0x2000, 0xD7FF), range(0x10000, 0x18000)) for cp in r if cp != 0x2581]
    singles = "".join(chr(cp) for cp in pool[:65400])
    words = [
        "".join(chr(rng.choice(pool[65400:65500])) for _ in range(rng.randint(2, 5)))
        for _ in range(300)
    ]
    text = " ".join(singles) + " " + " ".join(rng.choice(words) for _ in range(3000))
    buckets, used0 = _buckets(text, 0)
    assert 65400 < used0 < 65536
    vocab = used0 + 120
    want = jtd.run_training_delta(buckets, used0, vocab)
    assert max(z for _, _, z in want) >= 65536
    assert any(max(x, y) >= 65536 for x, y, _ in want)
    for plain in (False, True):
        assert td.run_training_delta(buckets, used0, vocab, plain=plain) == want


@pytest.fixture(scope="module")
def checkpoint_case():
    """The checkpoint tests' corpus and the JAX rules, computed once for both
    writers."""
    buckets, used0 = _buckets(_zipf_text(9, n=2000), 0)
    vocab = used0 + 150
    return buckets, used0, vocab, jtd.run_training_delta(buckets, used0, vocab)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_resumes_across_packages(writer, tmp_path, checkpoint_case):
    buckets, used0, vocab, want = checkpoint_case
    ck = str(tmp_path / "ck.npz")
    if writer == "jax":
        jtd.run_training_delta(buckets, used0, vocab, checkpoint_path=ck, checkpoint_every=40)
        snap_used = int(np.load(ck)["used"])
        got = td.run_training_delta(buckets, used0, vocab, resume_path=ck)
    else:
        td.run_training_delta(buckets, used0, vocab, checkpoint_path=ck, checkpoint_every=40)
        snap_used = int(np.load(ck)["used"])
        got = jtd.run_training_delta(buckets, used0, vocab, resume_path=ck)
    assert used0 < snap_used < vocab
    assert got == want


def _corpus(tmp_path, seed=5, n=4000):
    p = tmp_path / "corpus.txt"
    rng = np.random.default_rng(seed)
    words = ["".join(rng.choice(list("abcdefghijklmnopqrst"), int(l)))
             for l in rng.integers(2, 9, 2500)]
    probs = 1.0 / np.arange(1, 2501)
    probs /= probs.sum()
    sel = np.array(words, object)[rng.choice(2500, n * 6, p=probs)]
    p.write_text("\n".join(" ".join(sel[i : i + 6]) for i in range(0, sel.size, 6)) + "\n")
    return str(p)


def test_yttm_bytes_api_and_cli(tmp_path):
    data = _corpus(tmp_path, n=600)
    jm, pm, cm, jcm = (str(tmp_path / f"{n}.yttm") for n in ("jax", "port", "cli", "jcli"))
    jyttm.BPE.train(data=data, model=jm, vocab_size=300, coverage=0.999, unk_id=5)
    bpe = yttm.BPE.train(data=data, model=pm, vocab_size=300, coverage=0.999, unk_id=5, device="cpu")
    assert open(pm, "rb").read() == open(jm, "rb").read()
    assert bpe.device.type == "cpu" and bpe.vocab_size() == 300
    args = ["bpe", "--data", data, "--vocab_size", "300", "--bos_id", "9"]
    res = CliRunner().invoke(cli.main, args + ["--model", cm, "--device", "cpu"])
    assert res.exit_code == 0, res.output
    res = CliRunner().invoke(jcli.main, args + ["--model", jcm])
    assert res.exit_code == 0, res.output
    assert open(cm, "rb").read() == open(jcm, "rb").read()


def test_training_stderr_matches(tmp_path, capsys, monkeypatch):
    """Config block, preprocessing lines and the per-1000 merge log."""
    monkeypatch.setenv("YTTM_TRAIN_LOG", "1")
    data = _corpus(tmp_path)
    jyttm.BPE.train(data=data, model=str(tmp_path / "j.yttm"), vocab_size=1100)
    want = capsys.readouterr().err
    yttm.BPE.train(data=data, model=str(tmp_path / "p.yttm"), vocab_size=1100, device="cpu")
    got = capsys.readouterr().err
    assert got.replace("p.yttm", "j.yttm") == want
    assert sum(l.startswith("id: 1000=") for l in got.splitlines()) == 1


def test_unported_trainers_and_default_device(monkeypatch):
    """The differential trainers (v3 sparse, v4 block, v1 stream) train on
    the CPU with the JAX package's rules; with no device, training takes
    cuda and raises without a card."""
    import torch

    cfg = BpeConfig(1.0, 1, SpecialTokens(0, 1, 2, 3))
    text = _run_heavy(5, n=600)
    for impl in ("sparse", "block", "stream"):
        monkeypatch.setenv("YTTM_TRAIN_IMPL", impl)
        a = jax_train(_cps(text), 40, JConfig(1.0, 1, JSpecial(0, 1, 2, 3)))
        b = port.train_from_codepoints(_cps(text), 40, cfg, "cpu")
        _assert_same(a, b)
    monkeypatch.setenv("YTTM_TRAIN_IMPL", "auto")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.train_from_codepoints(_cps("ab ab"), 10, cfg)
