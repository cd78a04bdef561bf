"""BPE-dropout in the torch port against the JAX package, on the CPU
(``device="cpu"``: the dropout kernel's plain torch version merges).

The two packages draw different coins (``jax.random`` against the port's
counter-based hash), so samples are compared exactly where the coins are
shared (the plain loop fed JAX's own coins) or do not matter (p = 0 and
p = 1), and by their decode round trip otherwise."""

import os
import random
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import youtokentome_tpu_torch as yttm
from test_torch_encode_kernel import _hand_rules, _port_tables, _rows, _states
from test_torch_encoder import _train
from youtokentome_tpu.encoder import Encoder as JEncoder
from youtokentome_tpu.ops import encode_kernel as jek
from youtokentome_tpu_torch.encoder import Encoder
from youtokentome_tpu_torch.models.state import BPEState
from youtokentome_tpu_torch.models.vocab import Vocabulary
from youtokentome_tpu_torch.ops import encode_kernel as ek

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def hand():
    js, ts = _states(_hand_rules())
    jt = jek.EncoderTables(js)
    return jt, _port_tables(jt)


@pytest.fixture(scope="module")
def models():
    out = {}
    for name, specials in (("base", (0, 1, 2, 3)), ("zero_real", (3, 1, 2, 4))):
        js = _train(5, specials)
        out[name] = (js, BPEState.loads(js.dumps()))
    return out


def _sentences(seed, n=24):
    """Short words only: words over 512 tokens merge greedily on the
    matrix path (as in the JAX package), so they would tell the routes
    apart at p = 1; words under 16 chars keep the JAX package's padded
    buckets to two shapes."""
    rng = random.Random(seed)
    out = [
        "".join(rng.choice("abcd XYZ") for _ in range(rng.randint(0, 24)))
        for _ in range(n)
    ]
    return out + ["", " ", "a", "XYZ", "aXbXc QQc", "dd d  ddd", "ab" * 7]


def _jax_coins(key, p, shape):
    """The coins ``_encode_dropout`` draws: a key split every round."""
    coins = []
    for _ in range(shape[1]):
        key, sub = jax.random.split(key)
        coins.append(np.asarray(jax.random.uniform(sub, (shape[0], shape[1] - 1)) < p))
    return coins


@pytest.mark.parametrize("key_seed", [0, 1])
@pytest.mark.parametrize("p", [0.1, 0.5, 0.9])
def test_dropout_plain_matches_jax_on_its_coins(hand, p, key_seed):
    """Fed the JAX program's coins, the plain loop equals ``_encode_dropout``
    row for row (rows with runs, empties and unknown placeholders)."""
    jt, tt = hand
    for cap, seed in ((16, 3), (32, 4)):
        mat = _rows(seed, 48, cap)
        key = jax.random.PRNGKey(key_seed)
        want = np.asarray(jek._encode_dropout(jt, jnp.asarray(mat), key, jnp.float32(p)))
        coins = _jax_coins(key, p, mat.shape)
        got = ek.encode_dropout_plain(tt, torch.from_numpy(mat), p, 0, draws=lambda r: coins[r])
        np.testing.assert_array_equal(got.numpy(), want)
        assert (want >= 0).sum() < (mat >= 0).sum()  # the rows did merge


def _coin_reference(seed, row, rnd, col):
    """coin_hash in plain Python integers modulo 2**32."""
    m = 0xFFFFFFFF

    def rotl(x, r):
        return ((x << r) | (x >> (32 - r))) & m

    def step(h, k):
        k = rotl((k * 0xCC9E2D51) & m, 15)
        h = rotl(h ^ ((k * 0x1B873593) & m), 13)
        return (h * 5 + 0xE6546B64) & m

    h = step(step(step(seed & m, row & m), seed >> 32), (rnd << 16) | col)
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & m
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & m
    return h ^ (h >> 16)


def test_coin_hash_bits():
    """The plain version's coins are the 32-bit hash the CUDA kernel
    computes (``csrc/encode_common.cuh:coin_hash``)."""
    seed = 0x0123456789ABCDEF
    rows = torch.tensor([[0], [1], [8191], [2**32 - 1]], dtype=torch.int64)
    cols = torch.arange(5, dtype=torch.int64)[None, :]
    got = ek.coin_hash(seed, rows, 7, cols)
    want = [[_coin_reference(seed, r, 7, c) for c in range(5)] for r in (0, 1, 8191, 2**32 - 1)]
    assert got.tolist() == want
    assert ek.drop_threshold(0.0) == 0 and ek.drop_threshold(1.0) == 1 << 24
    assert ek.drop_threshold(0.5) == 1 << 23


def test_dropout_p0_is_greedy_and_p1_keeps_rows(hand):
    jt, tt = hand
    mat = _rows(9, 64, 32)
    x = torch.from_numpy(mat)
    np.testing.assert_array_equal(
        ek.encode_dropout(tt, x, 0.0, 11).numpy(), np.asarray(jek._encode_greedy(jt, jnp.asarray(mat)))
    )
    assert torch.equal(ek.encode_dropout(tt, x, 1.0, 11), x)
    # the coins follow the seed and the global row
    a = ek.encode_dropout(tt, x, 0.5, 11)
    assert torch.equal(a, ek.encode_dropout(tt, x, 0.5, 11))
    assert not torch.equal(a, ek.encode_dropout(tt, x, 0.5, 12))
    assert not torch.equal(a, ek.encode_dropout(tt, x, 0.5, 11, row0=64))
    # encode_batch, as the JAX package's
    np.testing.assert_array_equal(ek.encode_batch(tt, mat), jek.encode_batch(jt, mat))
    np.testing.assert_array_equal(ek.encode_batch(tt, mat, 1.0), jek.encode_batch(jt, mat, 1.0))


def test_dropout_wrapper_uses_plain_version_only_on_cpu(hand):
    _, tt = hand
    x = torch.from_numpy(_rows(2, 8, 8))
    before = ek.encode_dropout.launches
    assert torch.equal(ek.encode_dropout(tt, x, 0.3, 5), ek.encode_dropout_plain(tt, x, 0.3, 5))
    assert ek.encode_dropout.launches == before
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        ek.encode_dropout(tt, torch.empty((2, 8), dtype=torch.int32, device="meta"), 0.3, 5)
    with pytest.raises(ValueError, match="not in"):
        ek.drop_threshold(1.5)
    with pytest.raises(ValueError, match="on the card only"):
        ek.encode_dropout(tt, x, 0.3, 5, work=torch.zeros(3, dtype=torch.int64))


@pytest.mark.parametrize("native", ["1", "0"])
@pytest.mark.parametrize("name", ["base", "zero_real"])
def test_p0_and_p1_equal_jax(models, name, native, monkeypatch):
    """p = 1 gives the character split and p = 0 greedy, on both routes
    (the native C++ merge and, with YTTM_DROPOUT_NATIVE=0 or a zero-is-real
    model, the matrix path with the dropout kernel), as in the JAX package."""
    monkeypatch.setenv("YTTM_DROPOUT_NATIVE", native)
    js, ts = models[name]
    ours, theirs = Encoder(ts, device="cpu"), JEncoder(js)
    s = _sentences(1)
    for ot in ("id", "subword"):
        assert ours.encode(s, ot, dropout_prob=1.0) == theirs.encode(s, ot, dropout_prob=1.0)
        assert ours.encode(s, ot, True, True, True, dropout_prob=1.0) == theirs.encode(
            s, ot, True, True, True, dropout_prob=1.0
        )
    assert ours.encode(s, "id", dropout_prob=0.0) == theirs.encode(s, "id")
    if name == "base":
        out = ours.encode(["abc ab a"], "id", dropout_prob=1.0)
        assert len(out[0]) == sum(len(w) + 1 for w in "abc ab a".split())
        assert out[0][0] == ts.char2id[9601]


def test_native_off_at_p1_equals_native(models, monkeypatch):
    _, ts = models["base"]
    enc = Encoder(ts, device="cpu")
    s = _sentences(2)
    p1 = enc.encode(s, "id", dropout_prob=1.0)
    monkeypatch.setenv("YTTM_DROPOUT_NATIVE", "0")
    assert enc.encode(s, "id", dropout_prob=1.0) == p1


@pytest.mark.parametrize("native", ["1", "0"])
def test_same_generator_seed_reproduces(models, native, monkeypatch):
    monkeypatch.setenv("YTTM_DROPOUT_NATIVE", native)
    _, ts = models["base"]
    enc = Encoder(ts, device="cpu")
    s = _sentences(3)

    def sample(seed):
        return enc.encode(s, "id", dropout_prob=0.4, generator=torch.Generator().manual_seed(seed))

    a = sample(7)
    assert a == sample(7)
    assert a != sample(8)
    assert enc.encode(s, "id", dropout_prob=0.4) != enc.encode(s, "id", dropout_prob=0.4)


@pytest.mark.parametrize("native", ["1", "0"])
def test_samples_decode_back(models, native, monkeypatch):
    """Merging or not never changes the surface string: every sampled id
    row decodes to the greedy row's text, every subword row joins back to
    the sentence."""
    monkeypatch.setenv("YTTM_DROPOUT_NATIVE", native)
    js, ts = models["base"]
    enc = Encoder(ts, device="cpu")
    v = Vocabulary(ts)
    s = _sentences(4)
    greedy = JEncoder(js).encode(s, "id")
    g = torch.Generator().manual_seed(1)
    for p in (0.1, 0.5, 0.9):
        ids = enc.encode(s, "id", dropout_prob=p, generator=g)
        assert [v.decode_ids(r) for r in ids] == [v.decode_ids(r) for r in greedy]
        subs = enc.encode(s, "subword", dropout_prob=p, generator=g)
        assert ["".join(r).replace("▁", " ").strip() for r in subs] == [
            " ".join(x.split()) for x in s
        ]


def test_chunks_of_a_bucket_draw_their_own_coins(models, monkeypatch):
    """With one key, the JAX matrix path hands every 8192-row chunk of a
    bucket the same coins, so occurrence i and i + 8192 of one word come
    out alike; the port keys its coins by the global row."""
    monkeypatch.setenv("YTTM_DROPOUT_NATIVE", "0")
    js, ts = models["base"]
    s = ["aabbcd abcdab"] * 9000
    theirs = JEncoder(js).encode(s, "id", dropout_prob=0.5, key=jax.random.PRNGKey(0))
    assert theirs[: 9000 - 8192] == theirs[8192:]  # the reference's shared coins
    ours = Encoder(ts, device="cpu").encode(s, "id", dropout_prob=0.5,
                                            generator=torch.Generator().manual_seed(0))
    assert ours[: 9000 - 8192] != ours[8192:]
    assert len({tuple(r) for r in ours}) > 1


def test_bpe_api_and_cli_dropout(models, tmp_path):
    js, _ = models["base"]
    model = str(tmp_path / "m.yttm")
    js.dump(model)
    bpe = yttm.BPE(model, device="cpu")
    s = _sentences(5, n=6)
    g = torch.Generator().manual_seed(2)
    a = bpe.encode(s, dropout_prob=0.3, generator=g)
    assert a == bpe.encode(s, dropout_prob=0.3, generator=torch.Generator().manual_seed(2))
    assert bpe.encode("abc cab", dropout_prob=0.3, generator=g)
    text = "\n".join(s) + "\n"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    jax_cli = ("import jax; jax.config.update('jax_platforms', 'cpu');"
               "from youtokentome_tpu.cli import main; main()")
    args = ["encode", f"--model={model}", "--output_type=id", "--dropout_prob=1.0"]
    outs = [
        subprocess.run(cmd + args + extra, input=text.encode(), capture_output=True,
                       env=env, cwd=str(REPO), timeout=120)
        for cmd, extra in (
            ([sys.executable, "-m", "youtokentome_tpu_torch.cli"], ["--device", "cpu"]),
            ([sys.executable, "-c", jax_cli], []),
        )
    ]
    for r in outs:
        assert r.returncode == 0, r.stderr.decode()
    assert outs[0].stdout == outs[1].stdout and outs[0].stdout
