"""The torch port's training pieces against the JAX package's, module by
module, on the CPU: the flat-stream primitives (ops/train_stream.py), the
delta trainer's table and delta helpers and one segment of its round loop
(ops/train_delta.py), and the plain versions of the CUDA kernels
(ops/train_kernels.py).  Inputs are made from seeds with numpy; every
comparison is exact."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from youtokentome_tpu.host import preprocess as j_pre
from youtokentome_tpu.ops import train_delta as jtd
from youtokentome_tpu.ops import train_stream as jts
from youtokentome_tpu_torch import convert
from youtokentome_tpu_torch.host import preprocess
from youtokentome_tpu_torch.ops import train_delta as td
from youtokentome_tpu_torch.ops import train_kernels as tk
from youtokentome_tpu_torch.ops import train_stream as ts

WIDE_BASE = 70000  # token ids above 65535: the JAX wide key layout


def _stream(seed, n_words=80, base=0, alphabet=6):
    """A PAD-padded flat stream of run-heavy words: (t, wid, freq) numpy."""
    rng = np.random.default_rng(seed)
    toks, wids = [], []
    for w in range(n_words):
        n = int(rng.integers(1, 9))
        word = np.repeat(rng.integers(0, alphabet, n), rng.integers(1, 5, n))
        toks.append(word + base)
        wids.append(np.full(word.size, w))
    t = np.concatenate(toks).astype(np.int32)
    wid = np.concatenate(wids).astype(np.int32)
    m = 1 << int(np.ceil(np.log2(t.size + 1)))
    tp = np.full(m, -1, np.int32)
    wp = np.full(m, -1, np.int32)
    tp[: t.size] = t
    wp[: t.size] = wid
    return tp, wp, rng.integers(1, 9, n_words).astype(np.int32)


def _fw(t, wid, freq):
    return (freq[np.maximum(wid, 0)] * (wid >= 0)).astype(np.int32)


def _T(a):
    return torch.from_numpy(np.array(a, copy=True))


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.numpy() if isinstance(b, torch.Tensor) else b)


@pytest.mark.parametrize("seed,base", [(0, 0), (1, 0), (2, WIDE_BASE)])
def test_pair_keys_and_weights(seed, base):
    t, wid, freq = _stream(seed, base=base)
    fw = _fw(t, wid, freq)
    want = jts.pair_keys_and_weights_fw(jnp.asarray(t), jnp.asarray(wid), jnp.asarray(fw))
    got = ts.pair_keys_and_weights_fw(_T(t), _T(wid), _T(fw))
    for a, b in zip(want, got):
        _eq(a, b)


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("cap", [16, 4096])
def test_reduce_by_key_table(wide, cap):
    """Table + signed deltas, summed per key: the same (x, y, count) set
    in the same order, the same live count (which may exceed cap)."""
    t, wid, freq = _stream(3, n_words=120, base=WIDE_BASE if wide else 0)
    fw = _fw(t, wid, freq)
    kx, ky, w = (np.asarray(a) for a in jts.pair_keys_and_weights_fw(
        jnp.asarray(t), jnp.asarray(wid), jnp.asarray(fw)))
    rng = np.random.default_rng(4)
    vals = np.where(rng.random(w.size) < 0.3, -w, w).astype(np.int32)
    kx = np.where(w > 0, kx, jts.BIG)
    jkeys = jtd._pack_keys(jnp.asarray(kx), jnp.asarray(ky), wide)
    jk, jv, jn = jtd._reduce_by_key(jkeys, jnp.asarray(vals), cap)
    pk, pv, pn = td._reduce_by_key(td._pack_keys(_T(kx), _T(ky)), _T(vals), cap)
    assert int(jn) == pn
    _eq(convert.table_keys_from_numpy(*(np.asarray(k) for k in jk)), pk)
    _eq(jv, pv)


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_topk_candidates_with_ties(wide, seed):
    rng = np.random.default_rng(10 + seed)
    n = 600
    base = WIDE_BASE if wide else 0
    pairs = np.unique(rng.integers(0, 40, (n, 2)) + base, axis=0)
    xs, ys = pairs[:, 0].astype(np.int32), pairs[:, 1].astype(np.int32)
    cnt = rng.integers(-1, 4, xs.size).astype(np.int32)  # many ties, dead entries
    cnt[: 3] = 50  # a tie at the top
    for k in (1, 16, 64):
        jc, jx, jy = jts._topk_candidates(
            jnp.asarray(cnt), jnp.asarray(xs), jnp.asarray(ys), k, narrow=not wide
        )
        pc, px, py = ts._topk_candidates(_T(cnt), _T(xs), _T(ys), k)
        n_live = min(k, int((cnt > 0).sum()))
        for a, b in ((jc, pc), (jx, px), (jy, py)):
            _eq(np.asarray(a)[:n_live], b[:n_live])
        assert bool((pc[n_live:] <= 0).all())


def _words_topk(cnt, xs, ys, k, wide):
    """The top ``k`` entries by the selection kernels' words: (cc, cx, cy)."""
    words = tk.order_words(_T(cnt), _T(xs), _T(ys), wide)
    if not wide:
        return tk.words_decode(torch.sort(words, descending=True).values[:k])
    hi, lo = words
    order = torch.sort(lo, descending=True, stable=True).indices
    order = order[torch.sort(hi[order], descending=True, stable=True).indices][:k]
    return tk.words_decode((hi[order], lo[order]), True)


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_packed_order_with_ties(wide, seed):
    """The selection kernels' words (``order_words``, the twin of
    ``csrc/train_common.cuh``'s NarrowOrder and WideOrder) rank a tie-heavy
    table with dead entries as the JAX ``_topk_candidates`` does, in narrow
    form (ids up to 65535) and wide form, and decode back to its entries."""
    rng = np.random.default_rng(30 + seed)
    base = WIDE_BASE if wide else (0, 65535 - 39, 0)[seed]
    pairs = np.unique(rng.integers(0, 40, (600, 2)) + base, axis=0)
    xs, ys = pairs[:, 0].astype(np.int32), pairs[:, 1].astype(np.int32)
    cnt = rng.integers(-1, 4, xs.size).astype(np.int32)  # many ties, dead entries
    cnt[:3] = 50  # a tie at the top
    cnt[3] = 2**31 - 1  # the largest count a word holds
    forms = (True,) if wide else (False, True)  # narrow ids rank alike in wide form
    n_all = int((cnt > 0).sum())
    for k in (1, 16, 64):
        jc, jx, jy = jts._topk_candidates(
            jnp.asarray(cnt), jnp.asarray(xs), jnp.asarray(ys), k, narrow=not wide
        )
        n_live = min(k, n_all)
        for form in forms:
            pc, px, py = _words_topk(cnt, xs, ys, k, form)
            for a, b in ((jc, pc), (jx, px), (jy, py)):
                _eq(np.asarray(a)[:n_live], b[:n_live])
            assert bool((pc[n_live:] == 0).all())
    live = cnt > 0
    for form in forms:
        c, x, y = tk.words_decode(tk.order_words(_T(cnt), _T(xs), _T(ys), form), form)
        _eq(c.numpy()[live], cnt[live])
        _eq(x.numpy()[live], xs[live])
        _eq(y.numpy()[live], ys[live])
        assert bool((c[torch.from_numpy(~live)] == 0).all())


@pytest.mark.parametrize("seed", range(6))
def test_accept_prefix_guard_floor_budget(seed):
    rng = np.random.default_rng(20 + seed)
    kb = 16
    for trial in range(40):
        cc = np.sort(rng.integers(0, 12, kb))[::-1].astype(np.int32)
        cx = rng.integers(0, 6, kb).astype(np.int32)
        cy = np.where(rng.random(kb) < 0.3, cx, rng.integers(0, 6, kb)).astype(np.int32)
        used = int(rng.integers(10, 40))
        vocab = used + int(rng.integers(0, 20))
        floor = None if trial % 3 else int(rng.integers(0, 6))
        ja, jz, jn = jts.accept_prefix(
            jnp.asarray(cc), jnp.asarray(cx), jnp.asarray(cy), used, vocab, kb, floor
        )
        pa, pz, pn = ts.accept_prefix(_T(cc), _T(cx), _T(cy), used, vocab, kb, floor)
        assert int(jn) == pn
        _eq(ja, pa)
        _eq(np.asarray(jz)[np.asarray(ja)], pz[pa])


def _candidates(t, wid, freq, used, vocab):
    """The round's candidates and acceptance, from the JAX package."""
    uk, uc = jtd.host_count_table(t, wid, freq)
    xs = (uk >> np.uint64(32)).astype(np.int32)
    ys = (uk & np.uint64(0xFFFFFFFF)).astype(np.int32)
    cc, cx, cy = jts._topk_candidates(jnp.asarray(uc), jnp.asarray(xs), jnp.asarray(ys), 16)
    acc, zs, _ = jts.accept_prefix(cc, cx, cy, used, vocab, 16)
    return [np.asarray(a) for a in (acc, cx, cy, zs, cc)]


@pytest.mark.parametrize("seed,base", [(5, 0), (6, 0), (7, WIDE_BASE)])
def test_hits_apply_affected_and_deltas(seed, base):
    t, wid, freq = _stream(seed, base=base)
    fw = _fw(t, wid, freq)
    used = base + 10
    acc, cx, cy, zs, _ = _candidates(t, wid, freq, used, used + 100)
    J = jnp.asarray
    jh, jr = jts.pair_hits(J(t), J(wid), J(acc), J(cx), J(cy))
    ph, pr = ts.pair_hits(_T(t), _T(wid), _T(acc), _T(cx), _T(cy))
    _eq(jh, ph)
    _eq(jr, pr)
    jaff = jtd._affected_positions(J(t), J(wid), jh)
    paff = td._affected_positions(_T(t), _T(wid), ph)
    _eq(jaff, paff)
    for sign, dcap in ((-1, 8), (-1, 1024), (1, 1024)):
        jd = jtd._delta_contributions(J(t), J(wid), J(fw), jaff, dcap, np.int32(sign), base > 0)
        pd = td._delta_contributions(_T(t), _T(wid), _T(fw), paff, dcap, sign)
        _eq(convert.table_keys_from_numpy(*(np.asarray(k) for k in jd[0])), pd[0])
        _eq(jd[1], pd[1])
        assert (int(jd[2]), bool(jd[3])) == (pd[2], pd[3])
    jo = jts.apply_accepted(J(t), J(wid), J(acc), J(cx), J(cy), J(zs), extra=(J(fw),))
    po = ts.apply_accepted(_T(t), _T(wid), _T(acc), _T(cx), _T(cy), _T(zs), extra=(_T(fw),))
    for a, b in zip(jo, po):
        _eq(a, b)


def _buckets(seed, n_words=400, vocab_extra=0):
    rng = np.random.default_rng(seed)
    words = [
        "".join(rng.choice(list("abcdef"), int(n)))
        for n in np.clip(rng.poisson(5, 120), 1, 12)
    ]
    text = " ".join(np.array(words, object)[rng.integers(0, 120, n_words)])
    cps = np.array([ord(c) for c in text], np.uint32)
    uniq, cnt, n = j_pre.char_frequencies(cps)
    al = j_pre.build_alphabet(uniq, cnt, n, 1.0, 4)
    return j_pre.training_word_buckets(cps, al), len(al.char2id) + 4


@pytest.mark.parametrize("vocab,dcap", [(120, 1 << 14), (70000, 1 << 14), (120, 16)])
def test_one_segment_from_identical_state(vocab, dcap):
    """One segment of train_rounds_delta in both packages from the JAX
    state carried across by convert: stream, table, rules and flags equal
    (vocab 70000 takes the JAX wide layout; dcap 16 the recount path)."""
    buckets, used0 = _buckets(1)
    t, wid, freq = jts.flatten_word_buckets(buckets)
    uk, uc = jtd.host_count_table(t, wid, freq)
    pcap = 1 << 12
    rules = np.full((vocab, 4), -1, np.int32)
    jk, jc = jtd._fit_table(uk, uc, pcap, vocab > 65535)
    limit = used0 + 60
    jout = jtd.train_rounds_delta(
        jnp.asarray(t), jnp.asarray(wid), jnp.asarray(freq), jk, jc, jnp.asarray(rules),
        jnp.asarray(used0, jnp.int32), jnp.asarray(used0, jnp.int32),
        jnp.asarray(limit, jnp.int32), vocab, 16, pcap, dcap,
    )
    state = convert.train_state_from_numpy(t, wid, freq, uk, uc, rules, pcap, "cpu")
    pt, pw, pf, ptk, ptc, prules = state
    pout = td.train_rounds_delta(
        pt, pw, pf, ptk, ptc, prules, used0, used0, limit, vocab, 16, pcap, dcap
    )
    j_t, j_w, j_tk, j_tc, j_rules, j_used, j_done, j_of, j_ns = jout
    p_t, p_w, p_tk, p_tc, p_rules, p_used, p_done, p_of, p_ns = pout
    _eq(j_t, p_t)
    _eq(j_w, p_w)
    _eq(convert.table_keys_from_numpy(*(np.asarray(k) for k in j_tk)), p_tk)
    _eq(j_tc, p_tc)
    _eq(j_rules, p_rules)
    assert (int(j_used), bool(j_done), bool(j_of), int(j_ns)) == (p_used, p_done, p_of, p_ns)
    assert p_used > used0 + 30


# -- the kernels' plain versions ----------------------------------------------


def _live_table(st):
    keys, cnts = st.table()
    live = cnts > 0
    return keys[live], cnts[live]


@pytest.mark.parametrize("seed", range(2))
def test_pair_count_plain_equals_host_table(seed):
    t, wid, freq = _stream(seed + 30, n_words=150)
    st = tk.TrainState(t, wid, freq, np.full((64, 4), -1, np.int32), 40, 1 << 12, "cpu")
    tk.pair_count(st)
    uk, uc = jtd.host_count_table(t, wid, freq)
    keys, cnts = st.table()
    np.testing.assert_array_equal(keys, uk.astype(np.int64))
    np.testing.assert_array_equal(cnts, uc)
    assert int(st.ctl[tk.OCC]) == uk.size and not int(st.ctl[tk.OVERFLOW])
    # a table too small for half its slots overflows, as the kernel does
    small = tk.TrainState(t, wid, freq, np.full((64, 4), -1, np.int32), 40, 16, "cpu")
    tk.pair_count(small)
    assert int(small.ctl[tk.OVERFLOW]) == int(2 * uk.size > 16)


@pytest.mark.parametrize("vocab", [200, 70000])
def test_kernel_rounds_equal_plain_rounds(vocab):
    """Segments of topk_accept + apply_delta (plain versions, word-laid
    state) against train_rounds_delta: the same live stream, live table,
    rules and flags at every segment boundary."""
    buckets, used0 = _buckets(2, n_words=600)
    t, wid, freq = ts.flatten_word_buckets(buckets)
    rules = np.full((vocab, 4), -1, np.int32)
    kern = tk.KernelEngine(t, wid, freq, rules, used0, vocab, 16, torch.device("cpu"))
    plain = td.PlainEngine(t, wid, freq, rules, used0, vocab, 16, torch.device("cpu"))
    used = used0
    for _ in range(6):
        limit = min(vocab, used + 25)
        ku = kern.segment(used, limit)
        pu = plain.segment(used, limit)
        assert ku == pu
        used = ku[0]
        kt, kw = kern.st.stream()
        live = plain.t >= 0
        _eq(plain.t[live], kt)
        _eq(plain.wid[live], kw)
        keys, cnts = _live_table(kern.st)
        n = int((plain.tc > 0).sum())
        _eq(plain.tk[:n], keys)
        _eq(plain.tc[:n], cnts)
        _eq(plain.rules, kern.rules)
        assert int(kern.st.cnts.min()) >= 0 and not int(kern.st.ctl[tk.ERROR])
        if ku[1]:
            break
    assert (rules == -1).all(), "an engine wrote into the caller's rules"


def test_kernel_wrappers_reject_other_devices():
    t, wid, freq = _stream(0, n_words=5)
    st = tk.TrainState(t, wid, freq, np.full((8, 4), -1, np.int32), 10, 64, "cpu")
    st.device = torch.device("meta")
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        tk.apply_delta(st)
    with pytest.raises(ValueError, match="batch_k"):
        tk.topk_accept(st, 20, 20, 10, k=17)


@pytest.mark.parametrize("slots,want", [(1, 1), (1 << 14, 16), ((1 << 14) + 1, 17),
                                        (1 << 22, tk.SEL_MAX_BLOCKS)])
def test_select_blocks_and_scratch(slots, want):
    """The selection's grid: a block per SEL_SLOTS slots, at least one, at
    most SEL_MAX_BLOCKS, which is the kernels' kSelMaxBlocks (the lists
    their last block can pick from; on a card, two blocks an SM below it);
    the scratch holds K_MAX words a block and a zero ticket."""
    src = (Path(tk.__file__).resolve().parent.parent / "csrc" / "train_common.cuh").read_text()
    threads = int(re.search(r"kSelThreads = (\d+);", src).group(1))
    assert "kSelMaxBlocks = 2 * kSelThreads;" in src and tk.SEL_MAX_BLOCKS == 2 * threads
    assert tk.select_blocks(slots, "cpu") == want
    hi, lo, ticket = tk.select_scratch(want, "cpu")
    assert hi.shape == lo.shape == (want * tk.K_MAX,) and int(ticket.sum()) == 0


# -- host preprocessing of the training corpus (the JAX package's) -----------


@pytest.mark.parametrize(
    "text,coverage",
    [
        ("abc  dca\tbbb\nxyz " * 30 + "aaaa" * 300, 1.0),
        ("привет мир ▁▁ a▁b 😀😀 x " * 40 + "qq zz", 0.99),
        ("ab" * 2000 + " " + "c" * 5000, 1.0),
    ],
)
def test_training_preprocess_matches(text, coverage):
    cps = np.array([ord(c) for c in text] + [0xFFFFFFFF] * 3, np.uint32)
    ours = preprocess.char_frequencies(cps)
    theirs = j_pre.char_frequencies(cps)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    pa = preprocess.build_alphabet(*ours, coverage, 4)
    ja = j_pre.build_alphabet(*theirs, coverage, 4)
    assert pa.char2id == ja.char2id
    np.testing.assert_array_equal(pa.removed, ja.removed)
    pb = preprocess.training_word_buckets(cps, pa)
    jb = j_pre.training_word_buckets(cps, ja)
    assert len(pb) == len(jb)
    for (pm, pc), (jm, jc) in zip(pb, jb):
        np.testing.assert_array_equal(pm, jm)
        np.testing.assert_array_equal(pc, jc)
