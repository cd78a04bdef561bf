"""The torch port's host layer against the JAX package: import
isolation, the .yttm codec, UTF-8 and word preprocessing, the native
helpers, and the pair-table hash and lookup.  All comparisons are exact."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import youtokentome_tpu.host.fastio as j_fastio
import youtokentome_tpu.host.fasttok as j_fasttok
import youtokentome_tpu.host.preprocess as j_pre
import youtokentome_tpu.ops.hashmap as j_hashmap
import youtokentome_tpu.ops.utf8 as j_utf8
from youtokentome_tpu.models.state import BPEState as JState
from youtokentome_tpu.models.state import SpecialTokens as JSpecial
from youtokentome_tpu_torch.host import fastio, fasttok, preprocess, utf8
from youtokentome_tpu_torch.models.state import BPEState, SpecialTokens
from youtokentome_tpu_torch.ops import hashmap

from jax_native import ensure_jax_native


@pytest.fixture(autouse=True, scope="module")
def _jax_native():
    """The JAX package's native helpers, built and loaded once in this
    worker before any test calls them (tests/jax_native.py)."""
    ensure_jax_native()


REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "youtokentome_tpu_torch"


def _port_modules():
    return sorted(
        "youtokentome_tpu_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
        for p in PORT.rglob("*.py")
        if p.name != "__init__.py" and "build" not in p.parts
    )


def test_port_imports_without_jax():
    code = (
        "import sys, importlib\n"
        f"for m in {_port_modules()!r}: importlib.import_module(m)\n"
        "import youtokentome_tpu_torch\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'youtokentome_tpu' or m.startswith('youtokentome_tpu.'))\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=str(REPO), capture_output=True, text=True
    )
    assert res.returncode == 0, res.stderr


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize(
    "path",
    sorted(p for p in PORT.rglob("*.py") if "build" not in p.parts)
    + [REPO / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(REPO)),
)
def test_no_jax_import_in_port_sources(path):
    for name in _imported_roots(path):
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "youtokentome_tpu"), (path, name)
    if path.name == "chip_smoke.py":
        assert not any(n.split(".")[0] in ("click", "bench") for n in _imported_roots(path))


def test_cpu_training_run_leaves_jax_and_click_out(tmp_path):
    """A whole CPU training run through ``train.train`` imports neither
    jax nor the JAX package, and the training path none of click (the
    card's machine has no click)."""
    data = tmp_path / "c.txt"
    data.write_text("abab abba baab aabb cab " * 50)
    code = (
        "import sys\n"
        "from youtokentome_tpu_torch.train import train\n"
        "from youtokentome_tpu_torch.models.state import BpeConfig, SpecialTokens\n"
        "import youtokentome_tpu_torch.api, youtokentome_tpu_torch.ops.train_kernels\n"
        "cfg = BpeConfig(1.0, 1, SpecialTokens(0, 1, 2, 3))\n"
        f"state = train({str(data)!r}, {str(tmp_path / 'm.yttm')!r}, 30, cfg, device='cpu')\n"
        "assert len(state.rules) > 10, state.rules\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'youtokentome_tpu', 'click'))\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=str(REPO), capture_output=True, text=True
    )
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize(
    "name",
    ["train.py", "api.py", "progress.py", "ops/train_stream.py", "ops/train_delta.py",
     "ops/train_kernels.py"],
)
def test_training_modules_import_no_click(name):
    assert not any(n.split(".")[0] == "click" for n in _imported_roots(PORT / name))


# -- .yttm codec (mirrors test_state_codec.py) ------------------------------


def _pair(char2id, rules, st):
    return (
        BPEState(char2id=char2id, rules=rules, special_tokens=SpecialTokens(*st)),
        JState(char2id=char2id, rules=rules, special_tokens=JSpecial(*st)),
    )


@pytest.mark.parametrize(
    "char2id,rules,st",
    [
        ({9601: 4, 97: 5, 98: 6}, [(5, 6, 7), (4, 7, 8)], (0, 1, 2, 3)),
        ({9601: 4}, [], (10, 11, 12, 13)),
        ({9601: 0, 120: 5, 1103: 6}, [(0, 5, 7)], (1, 2, 3, 4)),
    ],
)
def test_codec_dumps_identical(char2id, rules, st, tmp_path):
    ours, theirs = _pair(char2id, rules, st)
    assert ours.dumps() == theirs.dumps()
    p = tmp_path / "m.yttm"
    theirs.dump(str(p))
    loaded = BPEState.load(str(p))
    assert loaded.char2id == theirs.char2id
    assert loaded.rules == theirs.rules
    assert loaded.special_tokens == ours.special_tokens
    assert loaded.vocab_size() == theirs.vocab_size()
    ours.dump(str(p))
    assert JState.load(str(p)).dumps() == ours.dumps()


def test_codec_loads_any_whitespace_and_order():
    text = "2 1\n97 5\n9601 4\n4 5 6\n1 0 2 3\n"
    ours, theirs = BPEState.loads(text), JState.loads(text)
    assert ours.char2id == theirs.char2id == {97: 5, 9601: 4}
    assert ours.rules == theirs.rules == [(4, 5, 6)]
    assert ours.special_tokens == SpecialTokens(pad_id=0, unk_id=1, bos_id=2, eos_id=3)


def test_codec_missing_file_raises_valueerror():
    with pytest.raises(ValueError, match="Can not open file with model"):
        BPEState.load("/nonexistent/path.yttm")


# -- utf8, word spans, dedup --------------------------------------------------


_TEXTS = [
    "abc  dca\tbbb\nxyz",
    "привет мир ▁▁ a▁b",
    "",
    "   ",
    "emoji 😀😀 x",
]


@pytest.mark.parametrize("text", _TEXTS)
def test_utf8_and_words_match(text):
    raw = text.encode() + b"\xff\xc3(ok"
    for keep in (True, False):
        np.testing.assert_array_equal(
            utf8.decode_utf8_bytes(raw, keep), j_utf8.decode_utf8_bytes(raw, keep)
        )
    cps = utf8.str_to_codepoints(text)
    assert utf8.encode_utf8_array(cps) == j_utf8.encode_utf8_array(cps)
    s0, l0 = preprocess.word_spans(cps)
    s1, l1 = j_pre.word_spans(cps)
    np.testing.assert_array_equal(s0, s1)
    np.testing.assert_array_equal(l0, l1)
    d0 = preprocess.dedup_words(cps, s0, l0)
    d1 = j_pre.dedup_words(cps, s1, l1)
    assert d0.group_lens == d1.group_lens
    np.testing.assert_array_equal(d0.occurrence_uid, d1.occurrence_uid)
    for a, b in zip(d0.group_rows, d1.group_rows):
        np.testing.assert_array_equal(a, b)


# -- native helpers ---------------------------------------------------------


def test_native_helpers_build_into_port_build_dir():
    assert fasttok.available()
    assert fastio._load() is not None
    assert (PORT / "build" / "libfasttok.so").exists()
    assert (PORT / "build" / "libfastio.so").exists()
    assert not (PORT / "host" / "_fasttok.so").exists()


def test_tokenize_and_io_match():
    data = "ab ab cX\nXYZ abc\n\n".encode()
    cps = np.array([97, 98, 99, 9601], np.uint32)
    ids = np.array([5, 6, 7, 4], np.int32)
    ours = fasttok.tokenize(data, cps, ids, 4)
    theirs = j_fasttok.tokenize(data, cps, ids, 4)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    rules = [(5, 6, 8), (4, 8, 9), (7, 7, 10)]
    wf, wo = ours[0], ours[1].astype(np.int64)
    for a, b in zip(
        fasttok.RuleTable(rules).merge_words(wf, wo),
        j_fasttok.RuleTable(rules).merge_words(wf, wo),
    ):
        np.testing.assert_array_equal(a, b)
    flat = np.array([5, 6, -(2**31), 7, 123456, -(2**31)], np.int32)
    assert fastio.format_ids(flat, -(2**31)) == j_fastio.format_ids(flat, -(2**31))
    text = b"1 2 3 \n\n44 5\n"
    np.testing.assert_array_equal(fastio.parse_ids(text, -1), j_fastio.parse_ids(text, -1))


# -- pair table: _mix and lookup -------------------------------------------


def _keys(seed, n):
    rng = np.random.default_rng(seed)
    kx = rng.integers(0, 40000, n).astype(np.uint32)
    ky = rng.integers(0, 40000, n).astype(np.uint32)
    _, uniq = np.unique(kx.astype(np.uint64) << 32 | ky, return_index=True)
    return kx[uniq], ky[uniq]


def test_mix_matches_numpy_uint32():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 2**32, 20000, dtype=np.uint64).astype(np.uint32)
    y = rng.integers(0, 2**32, 20000, dtype=np.uint64).astype(np.uint32)
    x[:4] = [0, 0xFFFFFFFF, 0x80000000, 1]
    y[:4] = [0xFFFFFFFF, 0xFFFFFFFF, 0, 0x7FFFFFFF]
    want = j_hashmap._mix(x, y, xp=np)
    got = hashmap.mix_torch(torch.from_numpy(x.astype(np.int64)), torch.from_numpy(y.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(hashmap._mix(x, y), want)


@pytest.mark.parametrize("n", [0, 1, 37, 3000])
def test_pair_table_and_lookup_match_jax(n):
    kx, ky = _keys(n, n)
    vals = np.arange(kx.size, dtype=np.int32)
    jt = j_hashmap.build_pair_table(kx, ky, vals)
    t = hashmap.build_pair_table(kx, ky, vals, "cpu")
    assert (t.cap, t.max_probes) == (jt.cap, jt.max_probes)
    np.testing.assert_array_equal(t.kx.numpy().view(np.uint32), np.asarray(jt.kx))
    np.testing.assert_array_equal(t.ky.numpy().view(np.uint32), np.asarray(jt.ky))
    np.testing.assert_array_equal(t.val.numpy(), np.asarray(jt.val))
    # present keys, absent keys, negatives and PAD, in a 2-D query
    rng = np.random.default_rng(n + 1)
    qx = np.concatenate([kx.astype(np.int32), rng.integers(-2, 40000, 500).astype(np.int32), [-1, 10**9]])
    qy = np.concatenate([ky.astype(np.int32), rng.integers(-2, 40000, 500).astype(np.int32), [-1, 10**9]])
    if qx.size % 2:
        qx, qy = qx[:-1], qy[:-1]
    qx, qy = qx.reshape(2, -1), qy.reshape(2, -1)
    want = np.asarray(jt.lookup(qx, qy))
    got = t.lookup(torch.from_numpy(qx), torch.from_numpy(qy)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got.ravel()[: kx.size], vals)
