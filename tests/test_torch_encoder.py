"""The torch port's Encoder, BPE API and CLI against the JAX package, on
the CPU (``device="cpu"``: the kernel's plain torch version merges).
Ids, subwords and CLI bytes must be identical, on both merge arms."""

import os
import pickle
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import youtokentome_tpu as jyttm
import youtokentome_tpu_torch as yttm
from youtokentome_tpu.encoder import Encoder as JEncoder
from youtokentome_tpu.models.state import BpeConfig, SpecialTokens
from youtokentome_tpu.oracle import train_from_codepoints
from youtokentome_tpu_torch.encoder import Encoder
from youtokentome_tpu_torch.models.state import BPEState

REPO = Path(__file__).resolve().parent.parent


def _train(seed, specials, vocab_extra=40):
    rng = random.Random(seed)
    text = "".join(
        rng.choice("aabbcd  ") if rng.randrange(3) else rng.choice("abcd") * rng.randint(2, 6)
        for _ in range(450)
    )
    cps = np.array([ord(c) for c in text], dtype=np.uint32)
    cfg = BpeConfig(1.0, 1, SpecialTokens(*specials))
    return train_from_codepoints(cps, len(set(text)) + 4 + vocab_extra, cfg)


@pytest.fixture(scope="module")
def models():
    """(JAX state, port state): the default specials, and all special ids
    >= 1 so that id 0 is a real token (the id-0 head quirk)."""
    out = {}
    for name, specials in (("base", (0, 1, 2, 3)), ("zero_real", (3, 1, 2, 4))):
        js = _train(5, specials)
        out[name] = (js, BPEState.loads(js.dumps()))
    return out


def _sentences(seed, n=30):
    rng = random.Random(seed)
    out = [
        "".join(rng.choice("abcd XYZ") for _ in range(rng.randint(0, 50)))
        for _ in range(n)
    ]
    # edge rows: empties, single chars, unknown-only, runs, long words
    out += ["", " ", "a", "XYZ", "Q", "a" * 40, "dd d  ddd", "aXbXc QQc"]
    out += ["a" * 700 + " " + "ab" * 300, "b" * 513 + "X" + "c" * 20]
    return out


@pytest.mark.parametrize("arm", ["device", "host"])
@pytest.mark.parametrize("name", ["base", "zero_real"])
def test_encode_matches_jax(models, name, arm, monkeypatch):
    monkeypatch.setenv("YTTM_ENCODE_MERGE", arm)
    js, ts = models[name]
    ours, theirs = Encoder(ts, device="cpu"), JEncoder(js)
    for seed in (0, 1):
        s = _sentences(seed)
        assert ours.encode(s, "id") == theirs.encode(s, "id")
    s = _sentences(2, n=8)
    for bos, eos, rev in [(1, 0, 0), (0, 1, 0), (1, 1, 1), (0, 0, 1)]:
        args = (s, "id", bool(bos), bool(eos), bool(rev))
        assert ours.encode(*args) == theirs.encode(*args)
    assert ours.encode(s, "subword", True, True, True) == theirs.encode(s, "subword", True, True, True)
    # second pass: every word comes from the caches
    assert ours.encode(s, "id") == theirs.encode(s, "id")
    assert ours.encode(s, "subword") == theirs.encode(s, "subword")


def test_matrix_backend_and_newlines_match_jax(models, monkeypatch):
    js, ts = models["base"]
    s = _sentences(3) + ["ab\ncd"]
    want = JEncoder(js).encode(s, "id")
    monkeypatch.setenv("YTTM_ENCODE_BACKEND", "matrix")
    assert Encoder(ts, device="cpu").encode(s, "id") == want


def test_native_unavailable_takes_matrix_path(models, monkeypatch):
    from youtokentome_tpu_torch.host import fasttok

    js, ts = models["zero_real"]
    s = _sentences(4)
    want = JEncoder(js).encode(s, "id")
    monkeypatch.setattr(fasttok, "available", lambda: False)
    assert Encoder(ts, device="cpu").encode(s, "id") == want


@pytest.mark.parametrize("arm", ["device", "host"])
def test_encode_stream_cli_matches_jax(models, arm, monkeypatch):
    monkeypatch.setenv("YTTM_ENCODE_MERGE", arm)
    js, ts = models["base"]
    blob = ("\n".join(_sentences(9, 40)) + "\n").encode()
    chunks, start = [], 0
    while start < len(blob):  # small chunks: several pipeline stages
        end = min(start + 97, len(blob))
        nl = blob.rfind(b"\n", start, end)
        end = nl + 1 if nl >= start and end < len(blob) else end
        chunks.append(blob[start:end])
        start = end
    want = b"".join(JEncoder(js).encode_stream_cli(iter(chunks)))
    assert b"".join(Encoder(ts, device="cpu").encode_stream_cli(iter(chunks))) == want
    monkeypatch.setenv("YTTM_WORD_CACHE", "8")  # evictions mid-stream
    assert b"".join(Encoder(ts, device="cpu").encode_stream_cli(iter(chunks))) == want


def test_device_default_is_cuda_and_raises_without_it(models, monkeypatch):
    _, ts = models["base"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Encoder(ts)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Encoder(ts, device="cuda")
    with pytest.raises(ValueError, match="cuda or cpu"):
        Encoder(ts, device="meta")
    assert Encoder(ts, device="cpu").device == torch.device("cpu")


def test_later_slices_raise(models, monkeypatch):
    """Dropout and the stream backend, which the first slice refused, now
    give the JAX package's results; an out-of-range dropout_prob still
    raises."""
    js, ts = models["base"]
    enc, theirs = Encoder(ts, device="cpu"), JEncoder(js)
    s = ["ab", "abc cab dd", ""]
    assert enc.encode(s, "id", dropout_prob=1.0) == theirs.encode(s, "id", dropout_prob=1.0)
    assert len(enc.encode(s, "id", dropout_prob=0.5)) == len(s)
    with pytest.raises(ValueError, match="dropout_prob"):
        enc.encode(["ab"], "id", dropout_prob=1.5)
    monkeypatch.setenv("YTTM_ENCODE_BACKEND", "stream")
    assert enc.encode(s, "id") == theirs.encode(s, "id")


def test_bpe_api_matches_jax(models, tmp_path):
    js, _ = models["base"]
    path = str(tmp_path / "m.yttm")
    js.dump(path)
    ours, theirs = yttm.BPE(path, device="cpu"), jyttm.BPE(path)
    s = _sentences(6, n=10)
    for ot_ours, ot_theirs in (
        (yttm.OutputType.ID, jyttm.OutputType.ID),
        (yttm.OutputType.SUBWORD, jyttm.OutputType.SUBWORD),
    ):
        assert ours.encode(s, ot_ours, bos=True) == theirs.encode(s, ot_theirs, bos=True)
        assert ours.encode("abc cab", ot_ours) == theirs.encode("abc cab", ot_theirs)
    assert ours.vocab() == theirs.vocab() and ours.vocab_size() == theirs.vocab_size()
    assert ours.subword_to_id("ab") == theirs.subword_to_id("ab")
    assert ours.id_to_subword(5) == theirs.id_to_subword(5)
    ids = ours.encode(s)
    assert ours.decode(ids, ignore_ids=[1]) == theirs.decode(ids, ignore_ids=[1])
    again = pickle.loads(pickle.dumps(ours))
    assert again.device == torch.device("cpu") and again.encode(s) == ids


# -- CLI ----------------------------------------------------------------------


_JAX_CLI = (
    "import jax; jax.config.update('jax_platforms', 'cpu');"
    "from youtokentome_tpu.cli import main; main()"
)


def _start(args, stdin, port, env_extra):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **env_extra)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    cmd = (
        [sys.executable, "-m", "youtokentome_tpu_torch.cli", *args]
        if port
        else [sys.executable, "-c", _JAX_CLI, *args]
    )
    proc = subprocess.Popen(
        cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env=env, cwd=str(REPO),
    )
    proc.stdin.write(stdin.encode())
    proc.stdin.close()
    return proc


def test_cli_bytes_match_jax(models, tmp_path):
    js, _ = models["zero_real"]
    model = str(tmp_path / "m.yttm")
    js.dump(model)
    text = "\n".join(_sentences(8, n=12)) + "\nunterminated abc"
    ids = "5 6 7 \n\n1 8 9 10 \n"
    cases = [
        (["encode", f"--model={model}", "--output_type=id"], text, {"YTTM_ENCODE_MERGE": "device"}),
        (["encode", f"--model={model}", "--output_type=id"], text, {"YTTM_ENCODE_MERGE": "host"}),
        (["encode", f"--model={model}", "--output_type=subword", "--bos", "--eos"], text, {}),
        (["encode", f"--model={model}", "--output_type=id", "--reverse", "--stream"], text, {}),
        (["decode", f"--model={model}", "--ignore_ids=1"], ids, {}),
        (["vocab", f"--model={model}", "--verbose"], "", {}),
    ]
    procs = []
    for args, stdin, env in cases:
        port_args = args + ["--device", "cpu"] if args[0] == "encode" else args
        procs.append(
            (args, _start(port_args, stdin, True, env), _start(args, stdin, False, env))
        )
    for args, ours, theirs in procs:
        out_ours, err_ours = ours.stdout.read(), ours.stderr.read()
        out_theirs, err_theirs = theirs.stdout.read(), theirs.stderr.read()
        assert ours.wait(timeout=120) == 0, err_ours.decode()
        assert theirs.wait(timeout=120) == 0, err_theirs.decode()
        assert out_ours == out_theirs, args
        assert out_ours, args
