"""The flat stream backend of the torch port against the JAX package, on
the CPU (``device="cpu"``: the stream kernels' plain torch versions).
Every stage, the encoder's ids, ``encode_bytes_flat`` and the CLI's bytes
must be identical."""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_encoder import _sentences, _train
from youtokentome_tpu.encoder import Encoder as JEncoder
from youtokentome_tpu.ops import encode_kernel as jek
from youtokentome_tpu.ops import stream_kernel as jsk
from youtokentome_tpu_torch import convert
from youtokentome_tpu_torch.encoder import Encoder
from youtokentome_tpu_torch.models.state import BPEState
from youtokentome_tpu_torch.ops import stream_kernel as sk

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def models():
    out = {}
    for name, specials in (("base", (0, 1, 2, 3)), ("zero_real", (3, 1, 2, 4))):
        js = _train(5, specials)
        out[name] = (js, BPEState.loads(js.dumps()))
    return out


def _chunk(seed: int) -> bytes:
    """Lines from a numpy seed: known letters, unknown chars (runs of 2-,
    3- and 4-byte chars), every whitespace kind, U+2581, empty lines,
    invalid bytes, and one word of several thousand chars."""
    rng = np.random.default_rng(seed)
    alphabet = list("abcd") * 4 + list("XYZ") + ["é", "€", "😀", "▁", " ", "\t", "\r", "\v", "\f"]
    lines = []
    for _ in range(80):
        r = rng.random()
        if r < 0.1:
            lines.append("")
        elif r < 0.3:
            lines.append(" ".join("ab" * int(k) for k in rng.integers(1, 9, 5)))
        else:
            lines.append("".join(rng.choice(alphabet, int(rng.integers(0, 50)))))
    lines.insert(40, "".join(rng.choice(list("abcd"), 3000)) + " cab")
    raw = [line.encode() for line in lines]
    # a lone continuation byte, an invalid lead, a truncated 3-byte char, a
    # surrogate and an overlong 2-byte char inside line 10; the chunk ends
    # mid-char
    cut = len(raw[10]) // 2
    raw[10] = raw[10][:cut] + b"\x80\xffab\xe2\x82 \xed\xa0\x80\xc0\xaf" + raw[10][cut:]
    return b"\n".join(raw) + b"\n\xf0\x9f"


def _tables(js, jt):
    t = jt.table
    return convert.tables_from_numpy(
        np.asarray(t.kx), np.asarray(t.ky), np.asarray(t.val), t.max_probes, t.cap,
        np.asarray(jt.rules_z), jt.n_rules, "cpu",
    )


@pytest.mark.parametrize("seed", [0, 1])
def test_stages_match_jax(models, seed):
    js, _ = models["base"]
    jt = jek.EncoderTables(js)
    tt = _tables(js, jt)
    cps = np.sort(np.array(list(js.char2id), np.uint32))
    ids = np.array([js.char2id[int(c)] for c in cps], np.int32)
    blob = _chunk(seed)
    n = len(blob)
    padded = np.full(1 << int(np.ceil(np.log2(n))), 32, np.uint8)  # JAX pads with spaces
    padded[:n] = np.frombuffer(blob, np.uint8)
    x = torch.frombuffer(bytearray(blob), dtype=torch.uint8)
    space = js.char2id[9601]

    cp, start = sk.utf8_decode(x)
    jcp, jstart = jsk._utf8_decode_device(jnp.asarray(padded))
    np.testing.assert_array_equal(cp.numpy(), np.asarray(jcp)[:n])
    np.testing.assert_array_equal(start.numpy(), np.asarray(jstart)[:n])

    jt_, jw_, jn = jsk._build_stream(jnp.asarray(padded), jnp.int32(n), jnp.asarray(cps),
                                     jnp.asarray(ids), jnp.int32(space))
    t, wid, n_tok = sk.build_stream(x, torch.from_numpy(cps.astype(np.int32)),
                                    torch.from_numpy(ids), space)
    k = int(jn)
    assert int(n_tok) == k and t.numel() == sk.stream_capacity(n)
    np.testing.assert_array_equal(t[:k].numpy(), np.asarray(jt_)[:k])
    np.testing.assert_array_equal(wid[:k].numpy(), np.asarray(jw_)[:k])
    assert (t[k:] == sk.PAD).all() and (wid[k:] == sk.PAD).all()
    assert (t[:k] >= jek.PLACEHOLDER_START).any() and (t[:k] == sk.NEWLINE).any()

    ju = jsk._dedup_words(jt_, jw_, jn)
    w = sk.dedup_words(t, wid, n_tok)
    un, nw = int(ju[2]), int(ju[4])
    assert (int(w.n_tokens), int(w.n_words)) == (un, nw)
    np.testing.assert_array_equal(w.ut[:un].numpy(), np.asarray(ju[0])[:un])
    np.testing.assert_array_equal(w.uwid[:un].numpy(), np.asarray(ju[1])[:un])
    np.testing.assert_array_equal(w.occ_uid[:nw].numpy(), np.asarray(ju[3])[:nw])
    nu = int(w.n_unique)
    assert nu < nw and int(w.ulen[:nu].sum()) == un and int(w.ulen[:nu].max()) > 3000
    assert (w.ustart[1:nu] == (w.ustart + w.ulen)[: nu - 1]).all()

    jm = jsk._merge_fixed_point(jt, ju[0], ju[1], ju[2])
    mt, mw, mn = sk.merge_fixed_point(tt, w.ut, w.uwid, w.n_tokens)
    k = int(jm[2])
    assert int(mn) == k < un
    np.testing.assert_array_equal(mt[:k].numpy(), np.asarray(jm[0])[:k])
    np.testing.assert_array_equal(mw[:k].numpy(), np.asarray(jm[1])[:k])

    je, jtot = jsk._expand_occurrences(jm[0], jm[1], ju[3], ju[4], jm[0].shape[0])
    out, tot = sk.expand_occurrences(mt, mw, w.occ_uid, w.n_words, mt.numel())
    k = int(jtot)
    assert int(tot) == k
    np.testing.assert_array_equal(out[:k].numpy(), np.asarray(je)[:k])

    jp = np.asarray(jsk._pack_u16(je, jnp.int32(1)))
    np.testing.assert_array_equal(sk.pack_u16(out, 1)[:k].numpy(), jp[:k])
    for unk in (None, 1):
        got, gtot = sk.stream_merge(tt, w, unk)
        assert int(gtot) == k
        want = np.asarray(je) if unk is None else jp
        np.testing.assert_array_equal(got[:k].numpy(), want[:k])


@pytest.mark.parametrize("name", ["base", "zero_real"])
def test_encoder_stream_backend_matches_jax(models, name, monkeypatch):
    """Zero-is-real models take the matrix path on both sides."""
    monkeypatch.setenv("YTTM_ENCODE_BACKEND", "stream")
    js, ts = models[name]
    ours, theirs = Encoder(ts, device="cpu"), JEncoder(js)
    s = _sentences(0)
    assert ours.encode(s, "id") == theirs.encode(s, "id")
    for bos, eos, rev in [(1, 0, 0), (1, 1, 1)]:
        args = (s[:12], "id", bool(bos), bool(eos), bool(rev))
        assert ours.encode(*args) == theirs.encode(*args)


def test_native_unavailable_takes_the_stream(models, monkeypatch):
    from youtokentome_tpu.host import fasttok as jfasttok
    from youtokentome_tpu_torch.host import fasttok

    js, ts = models["base"]
    s = _sentences(5) + ["ab\ncd"]  # an embedded newline: the matrix path
    monkeypatch.setattr(fasttok, "available", lambda: False)
    monkeypatch.setattr(jfasttok, "available", lambda: False)
    enc = Encoder(ts, device="cpu")
    calls = []
    monkeypatch.setattr(enc, "_encode_ids_stream",
                        lambda *a: calls.append(1) or Encoder._encode_ids_stream(enc, *a))
    assert enc.encode(s[:-1], "id") == JEncoder(js).encode(s[:-1], "id") and calls
    assert enc.encode(s, "id") == JEncoder(js).encode(s, "id")


def test_encode_bytes_flat_matches_jax(models, monkeypatch):
    js, ts = models["base"]
    ours, theirs = Encoder(ts, device="cpu"), JEncoder(js)
    data = _chunk(2)
    a, sa = ours.encode_bytes_flat(data)
    b, sb = theirs.encode_bytes_flat(data)
    assert sa == sb and a.dtype == b.dtype == np.uint16
    np.testing.assert_array_equal(a, b)
    # the int32 wire format (models with vocab >= 0xFFFE)
    np.testing.assert_array_equal(ours._stream.encode_bytes(data), theirs._stream.encode_bytes(data))
    # chunks of 64 bytes (every line is shorter) give the same ids
    monkeypatch.setenv("YTTM_STREAM_CHUNK", "64")
    lines = b"".join(line + b"\n" for line in data.split(b"\n") if len(line) < 60)
    np.testing.assert_array_equal(ours.encode_bytes_flat(lines)[0], theirs.encode_bytes_flat(lines)[0])
    assert ours.encode_bytes_flat(b"")[0].size == 0


def test_stream_wrappers_use_plain_versions_only_on_cpu(models):
    js, ts = models["base"]
    enc = Encoder(ts, device="cpu")
    before = (sk.stream_build.launches, sk.stream_dedup.launches, sk.stream_merge.launches)
    x = torch.frombuffer(bytearray(b"ab cab\nab\n"), dtype=torch.uint8)
    out, n = sk.encode_stream(enc.tables, x, enc._stream.alpha_cps, enc._stream.alpha_ids,
                              enc.space_id)
    assert out[: int(n)].tolist() == enc._stream.encode_bytes(b"ab cab\nab\n").tolist()
    assert (sk.stream_build.launches, sk.stream_dedup.launches, sk.stream_merge.launches) == before
    meta = torch.empty(4, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        sk.stream_build(meta, enc._stream.alpha_cps, enc._stream.alpha_ids, enc.space_id)


_NO_NATIVE = (
    "import sys; sys.path.insert(0, {repo!r});"
    "import jax; jax.config.update('jax_platforms', 'cpu');"
    "from youtokentome_tpu{port}.host import fasttok; fasttok.available = lambda: False;"
    "from youtokentome_tpu{port}.cli import main; main()"
)


@pytest.mark.parametrize("name", ["base", "zero_real"])
def test_cli_without_native_tokenizer_matches_jax(models, name, tmp_path):
    """Without the C++ tokenizer the CLI's id mode runs through
    ``encode_bytes_flat`` (zero-is-real models through the batch path)."""
    js, _ = models[name]
    model = str(tmp_path / "m.yttm")
    js.dump(model)
    text = ("\n".join(_sentences(8, n=20)) + "\nunterminated abc").encode()
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    args = ["encode", f"--model={model}", "--output_type=id"]
    outs = []
    for port, extra in (("_torch", ["--device", "cpu"]), ("", [])):
        code = _NO_NATIVE.format(repo=str(REPO), port=port)
        outs.append(subprocess.run([sys.executable, "-c", code, *args, *extra], input=text,
                                   capture_output=True, env=env, cwd=str(REPO), timeout=120))
    for r in outs:
        assert r.returncode == 0, r.stderr.decode()
    assert outs[0].stdout == outs[1].stdout and outs[0].stdout
