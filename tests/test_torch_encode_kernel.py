"""The torch port's encode merge (plain torch version of the CUDA kernel)
against the JAX package's ``_encode_greedy`` / ``_encode_greedy_u16``,
on the identical table carried over with ``convert.tables_from_numpy``
(mirrors test_device_encode.py:126-162).  All comparisons are exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from youtokentome_tpu.models.state import BPEState as JState
from youtokentome_tpu.models.state import SpecialTokens as JSpecial
from youtokentome_tpu.ops import encode_kernel as jek
from youtokentome_tpu.ops import segment as jseg
from youtokentome_tpu_torch import convert
from youtokentome_tpu_torch.models.state import BPEState
from youtokentome_tpu_torch.ops import encode_kernel as ek
from youtokentome_tpu_torch.ops import segment

LETTERS = [5, 6, 7, 8]


def _hand_rules(seed=0, n_extra=40):
    """Every letter pair including the equal ones (run parity), then
    rules over merged tokens, some of them equal pairs."""
    rng = np.random.default_rng(seed)
    pairs = [(x, y) for x in LETTERS for y in LETTERS]
    rng.shuffle(pairs)
    rules, seen, z = [], set(), 9
    for x, y in pairs:
        rules.append((int(x), int(y), z))
        seen.add((x, y))
        z += 1
    while len(rules) < len(pairs) + n_extra:
        ids = [4] + LETTERS + [r[2] for r in rules]
        x, y = (int(v) for v in rng.choice(ids, 2))
        if rng.random() < 0.2:
            y = x
        if (x, y) not in seen:
            rules.append((x, y, z))
            seen.add((x, y))
            z += 1
    return rules


def _states(rules):
    char2id = {9601: 4, 97: 5, 98: 6, 99: 7, 100: 8}
    return (
        JState(char2id=char2id, rules=rules, special_tokens=JSpecial(0, 1, 2, 3)),
        BPEState.loads(
            JState(char2id=char2id, rules=rules, special_tokens=JSpecial(0, 1, 2, 3)).dumps()
        ),
    )


def _rows(seed, n_rows, cap):
    """Front-packed rows: runs of equal letters (long enough for the run
    parity), unknown-run placeholders numbered per row, empty rows."""
    rng = np.random.default_rng(seed)
    mat = np.full((n_rows, cap), -1, np.int32)
    for i in range(n_rows):
        n = 0 if i % 11 == 0 else int(rng.integers(1, cap + 1))
        if n == 0:
            continue
        toks = np.repeat(rng.choice(LETTERS, n), rng.geometric(0.35, n))[: n - 1]
        ph = rng.random(toks.size) < 0.06
        toks[ph] = jek.PLACEHOLDER_START + np.arange(int(ph.sum()))
        mat[i, 0] = 4
        mat[i, 1:n] = toks
    return mat


def _port_tables(jt):
    t = jt.table
    return convert.tables_from_numpy(
        np.asarray(t.kx), np.asarray(t.ky), np.asarray(t.val), t.max_probes, t.cap,
        np.asarray(jt.rules_z), jt.n_rules, "cpu",
    )


@pytest.fixture(scope="module")
def model():
    js, ts = _states(_hand_rules())
    jt = jek.EncoderTables(js)
    return js, ts, jt, _port_tables(jt)


def test_tables_from_state_match_jax(model):
    _, ts, jt, carried = model
    own = ek.EncoderTables.from_state(ts, "cpu")
    for t in (own, carried):
        assert (t.table.cap, t.table.max_probes, t.n_rules) == (
            jt.table.cap, jt.table.max_probes, jt.n_rules
        )
        np.testing.assert_array_equal(t.table.kx.numpy().view(np.uint32), np.asarray(jt.table.kx))
        np.testing.assert_array_equal(t.table.ky.numpy().view(np.uint32), np.asarray(jt.table.ky))
        np.testing.assert_array_equal(t.table.val.numpy(), np.asarray(jt.table.val))
        np.testing.assert_array_equal(t.rules_z.numpy(), np.asarray(jt.rules_z))


@pytest.mark.parametrize("cap", [8, 16, 32, 64])
def test_encode_greedy_matches_jax(model, cap):
    _, _, jt, tt = model
    mat = _rows(cap, 96, cap)
    want = np.asarray(jek._encode_greedy(jt, jnp.asarray(mat)))
    got = ek.encode_greedy(tt, torch.from_numpy(mat))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (mat >= 0).sum() > (want >= 0).sum()  # the rows did merge


@pytest.mark.parametrize("cap", [8, 16, 32, 64])
def test_encode_greedy_u16_matches_jax(model, cap):
    _, _, jt, tt = model
    mat = _rows(100 + cap, 96, cap)
    m16 = jek.pack_tokens_u16(mat)
    np.testing.assert_array_equal(ek.pack_tokens_u16(mat), m16)
    unk = 1
    want = np.asarray(jek._encode_greedy_u16(jt, jnp.asarray(m16), np.int32(unk)))
    got = ek.encode_greedy_u16(tt, torch.from_numpy(m16), unk)
    assert got.dtype == torch.uint16
    np.testing.assert_array_equal(got.numpy(), want)


def test_trained_model_rows_match_jax():
    """A model trained by the oracle (rules in training order)."""
    from youtokentome_tpu.models.state import BpeConfig
    from youtokentome_tpu.oracle import train_from_codepoints

    rng = np.random.default_rng(7)
    text = "".join(
        "abcd"[int(c)] * int(k) + (" " if s else "")
        for c, k, s in zip(rng.integers(0, 4, 600), rng.integers(1, 5, 600), rng.random(600) < 0.3)
    )
    cps = np.array([ord(c) for c in text], dtype=np.uint32)
    js = train_from_codepoints(cps, 4 + 5 + 60, BpeConfig(1.0, 1, JSpecial(0, 1, 2, 3)))
    jt = jek.EncoderTables(js)
    mat = _rows(3, 64, 32)
    ids = np.array(sorted(v for k, v in js.char2id.items() if k != 9601), np.int32)
    mat = np.where(np.isin(mat, LETTERS), ids[(mat - 5) % ids.size], mat)
    mat[mat == 4] = js.char2id[9601]
    want = np.asarray(jek._encode_greedy(jt, jnp.asarray(mat)))
    np.testing.assert_array_equal(ek.encode_greedy(_port_tables(jt), torch.from_numpy(mat)).numpy(), want)


def test_no_rules_returns_rows_unchanged():
    js, ts = _states([])
    jt = jek.EncoderTables(js)
    tt = ek.EncoderTables.from_state(ts, "cpu")
    mat = _rows(5, 16, 16)
    np.testing.assert_array_equal(ek.encode_greedy(tt, torch.from_numpy(mat)).numpy(), mat)
    m16 = jek.pack_tokens_u16(mat)
    want = np.asarray(jek._encode_greedy_u16(jt, jnp.asarray(m16), np.int32(1)))
    np.testing.assert_array_equal(ek.encode_greedy_u16(tt, torch.from_numpy(m16), 1).numpy(), want)


def test_segment_primitives_match_jax():
    rng = np.random.default_rng(1)
    hit = rng.random((40, 33)) < 0.6
    np.testing.assert_array_equal(
        segment.select_leftmost_nonoverlapping(torch.from_numpy(hit)).numpy(),
        np.asarray(jseg.select_leftmost_nonoverlapping(jnp.asarray(hit))),
    )
    vals = rng.integers(0, 100, (40, 33)).astype(np.int32)
    keep = rng.random((40, 33)) < 0.5
    np.testing.assert_array_equal(
        segment.compact_rows(torch.from_numpy(vals), torch.from_numpy(keep)).numpy(),
        np.asarray(jseg.compact_rows(jnp.asarray(vals), jnp.asarray(keep))),
    )


def test_wrappers_use_plain_version_only_on_cpu(model):
    _, _, _, tt = model
    mat = torch.from_numpy(_rows(9, 8, 8))
    before = (ek.encode_greedy.launches, ek.encode_greedy_u16.launches)
    assert torch.equal(ek.encode_greedy(tt, mat), ek.encode_greedy_plain(tt, mat))
    m16 = torch.from_numpy(ek.pack_tokens_u16(mat.numpy()))
    assert torch.equal(ek.encode_greedy_u16(tt, m16, 1), ek.encode_greedy_u16_plain(tt, m16, 1))
    # plain runs are not kernel launches
    assert (ek.encode_greedy.launches, ek.encode_greedy_u16.launches) == before
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        ek.encode_greedy(tt, torch.empty((2, 8), dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        ek.encode_greedy_u16(tt, torch.empty((2, 8), dtype=torch.uint16, device="meta"), 1)
