"""The pieces of the torch port's v5 tiered trainer against the JAX
package's, on the CPU, from numpy inputs made from a seed: signatures,
the prefilter, T and the hot set, the signed reduce, the row-wise apply,
the row fold and the block layouts.  All values are integers: equality is
exact (tolerance 0)."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from youtokentome_tpu.host import preprocess as j_pre
from youtokentome_tpu.ops import train_block as jtb
from youtokentome_tpu.ops import train_delta as jtd
from youtokentome_tpu.ops import train_stream as jts
from youtokentome_tpu.ops import train_tiered as jtt
from youtokentome_tpu_torch.ops import tiered_kernels as tk
from youtokentome_tpu_torch.ops import train_block as tb
from youtokentome_tpu_torch.ops import train_stream as ts
from youtokentome_tpu_torch.ops import train_tiered as tt
from youtokentome_tpu_torch.ops.train_delta import _pack_keys


def _u32(sig) -> np.ndarray:
    return np.asarray(sig.numpy() if isinstance(sig, torch.Tensor) else sig).view(np.uint32)


def _rows(seed, n_rows=64, B=16, hi=200):
    """Block rows of whole words, live tokens first: (t, wid) [n_rows * B]."""
    rng = np.random.default_rng(seed)
    t = np.full((n_rows, B), -1, np.int32)
    w = np.full((n_rows, B), -1, np.int32)
    wid = 0
    for r in range(n_rows):
        pos = 0
        while True:
            L = int(rng.integers(1, 6))
            if pos + L > B or rng.random() < 0.1:
                break
            run = rng.integers(0, 4, L) if rng.random() < 0.3 else rng.integers(0, hi, L)
            t[r, pos : pos + L] = run
            w[r, pos : pos + L] = wid
            wid += 1
            pos += L
    return t.reshape(-1), w.reshape(-1), wid


@pytest.mark.parametrize("base", [0, 65500, 1 << 20])
def test_signatures(base):
    """sig_build / sig_build_host equal the JAX package's bits, ids above
    65535 included; PAD sets nothing."""
    t, _, _ = _rows(1, hi=3000)
    t = np.where(t >= 0, t + base, -1).astype(np.int32)
    t2d = t.reshape(-1, 16)
    want = _u32(jtt.sig_build(jnp.asarray(t2d)))
    assert np.array_equal(want, jtt.sig_build_host(t2d))
    assert np.array_equal(_u32(tt.sig_build(torch.from_numpy(t2d))), want)
    assert np.array_equal(_u32(tt.sig_build_host(t2d)), want)
    ids = np.concatenate([np.arange(0, 70000, 7), [2**31 - 2, -1]]).astype(np.int32)
    assert np.array_equal(
        tt._sig_pos(torch.from_numpy(ids)).numpy(), np.asarray(jtt._sig_pos(jnp.asarray(ids)))
    )


@pytest.mark.parametrize("seed", range(3))
def test_prefilter(seed):
    rng = np.random.default_rng(seed)
    t, _, _ = _rows(seed, n_rows=128, hi=90000 if seed == 2 else 300)
    sig = jtt.sig_build_host(t.reshape(-1, 16))
    live = t[t >= 0]
    cx = rng.choice(live, 16).astype(np.int32)
    cy = rng.choice(live, 16).astype(np.int32)
    acc = np.arange(16) < rng.integers(1, 17)
    want = np.asarray(jtt.sig_prefilter(jnp.asarray(sig), jnp.asarray(acc), jnp.asarray(cx), jnp.asarray(cy)))
    got = tt.sig_prefilter(
        torch.from_numpy(sig.view(np.int32)), torch.from_numpy(acc), torch.from_numpy(cx),
        torch.from_numpy(cy),
    ).numpy()
    assert want.any() and not want.all()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("n_live,hcap", [(40, 256), (500, 256), (3000, 1024), (600, 64)])
def test_threshold_and_hot_set(n_live, hcap):
    """T from the sorted table with its zeros (_resplit), from the live
    entries (host_resplit) and from the kernels' radix select
    (resplit_threshold) agree with the JAX functions; the hot set is the
    keys above T."""
    rng = np.random.default_rng(n_live)
    keys = np.unique(rng.integers(0, 1 << 40, n_live * 2).astype(np.uint64))[:n_live]
    keys = (keys >> np.uint64(24) << np.uint64(32)) | (keys & np.uint64(0xFFFF))
    keys = np.unique(keys)
    cnts = rng.integers(1, 30, keys.size).astype(np.int32)
    pcap = 4096
    jk, jc = jtd._fit_table(keys, cnts, pcap, wide=True)
    jhk, jhc, jT = jtt._resplit(jk, jc, hcap)
    _, _, jT_host = jtt.host_resplit(keys, cnts, hcap, True)
    pk, pc = tt._fit_table(keys, cnts, pcap, "cpu")
    hk, hc, T = tt._resplit(pk, pc, hcap)
    _, _, T_host = tt.host_resplit(keys, cnts, hcap, "cpu")
    assert int(jT) == T == T_host == int(jT_host) == tk.resplit_threshold(pc, hcap // 2)
    n = int((np.asarray(jhc) > 0).sum())
    want = sorted(zip(np.asarray(jhk[0])[:n].tolist(), np.asarray(jhk[1])[:n].tolist(),
                      np.asarray(jhc)[:n].tolist()))
    m = int((hc > 0).sum())
    got = sorted(zip((hk[:m] >> 32).tolist(), (hk[:m] & 0xFFFFFFFF).tolist(), hc[:m].tolist()))
    assert got == want
    assert all(c > T for *_, c in got) and len(got) == int((cnts > T).sum())


@pytest.mark.parametrize("seed", range(3))
def test_reduce_by_key_signed(seed):
    rng = np.random.default_rng(seed)
    n = 400
    x = rng.integers(0, 20, n).astype(np.int32)
    y = rng.integers(0, 20, n).astype(np.int32)
    v = rng.integers(-5, 6, n).astype(np.int32)
    x[rng.random(n) < 0.1] = jts.BIG  # invalid entries
    jk, jv, jn = jtt._reduce_by_key_signed(jtd._pack_keys(jnp.asarray(x), jnp.asarray(y), True),
                                           jnp.asarray(v), 512)
    pk, pv, pn = tt._reduce_by_key_signed(
        _pack_keys(torch.from_numpy(x), torch.from_numpy(y)), torch.from_numpy(v), 512
    )
    assert int(jn) == pn
    want = sorted(zip(np.asarray(jk[0])[:pn].tolist(), np.asarray(jk[1])[:pn].tolist(),
                      np.asarray(jv)[:pn].tolist()))
    got = sorted(zip((pk[:pn] >> 32).tolist(), (pk[:pn] & 0xFFFFFFFF).tolist(), pv[:pn].tolist()))
    assert got == want
    assert any(c < 0 for *_, c in got) and all(c != 0 for *_, c in got)


@pytest.mark.parametrize("seed", range(3))
def test_apply_rowwise_and_mini_contribs(seed):
    rng = np.random.default_rng(seed)
    t, wid, n_words = _rows(seed + 10, hi=6)
    fw = np.where(wid >= 0, rng.integers(1, 9, t.size), 0).astype(np.int32)
    cx = np.array([1, 3, 0, 2, 5, 4], np.int32)
    cy = np.array([2, 3, 1, 0, 5, 1], np.int32)
    acc = np.array([True, True, False, True, True, False])
    zs = np.arange(100, 106, dtype=np.int32)
    jt_, jw = jnp.asarray(t), jnp.asarray(wid)
    hit, rix = jts.pair_hits(jt_, jw, jnp.asarray(acc), jnp.asarray(cx), jnp.asarray(cy))
    want = jtb._apply_rowwise(jt_, jw, jnp.asarray(fw), hit, rix, jnp.asarray(zs), 16)
    P = torch.from_numpy
    phit, prix = ts.pair_hits(P(t), P(wid), P(acc), P(cx), P(cy))
    got = tb._apply_rowwise(P(t), P(wid), P(fw), phit, prix, P(zs), 16)
    assert bool(np.asarray(hit).any())
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    for a, b in ((t, wid), (got[0].numpy(), got[1].numpy())):
        fwa = np.where(b >= 0, 3, 0).astype(np.int32)
        jk, jv = jtb._mini_contribs(jnp.asarray(a), jnp.asarray(b), jnp.asarray(fwa), True)
        pk, pv = tb._mini_contribs(P(a), P(b), P(fwa))
        jx = np.asarray(jk[0]).astype(np.int64)
        jy = np.asarray(jk[1]).astype(np.int64)
        pad = jx == 0xFFFFFFFF
        assert np.array_equal(pv.numpy(), np.asarray(jv))
        assert np.array_equal(pk.numpy()[~pad], (jx << 32 | jy)[~pad])
        assert (pk.numpy()[pad] == tt.PADKEY).all()


@pytest.mark.parametrize("seed", range(3))
def test_fold_check_and_rows(seed, monkeypatch):
    """The fold's row order (a stable sort of the fills), the pair check
    and the folded rows with their signatures, row for row; the kernels'
    plain fold agrees, under the host loop's trigger."""
    t, wid, _ = _rows(seed + 20, n_rows=32)
    rng = np.random.default_rng(seed)
    t2d, w2d = t.reshape(32, 16).copy(), wid.reshape(32, 16).copy()
    for r in range(32):  # cut rows at a word boundary, ties in the fills
        if rng.random() < 0.6:
            starts = np.nonzero(np.diff(np.concatenate([[-2], w2d[r]])) != 0)[0]
            cut = int(starts[min(int(rng.integers(1, 3)), starts.size - 1)])
            t2d[r, cut:] = -1
            w2d[r, cut:] = -1
    t, wid = t2d.reshape(-1), w2d.reshape(-1)
    ok = bool(jtt._fold_check(jnp.asarray(t), 16))
    assert tt._fold_check(torch.from_numpy(t), 16) == ok
    wt, ww, ws = jtt._fold_rows(jnp.asarray(t), jnp.asarray(wid), 16)
    gt, gw, gs = tt._fold_rows(torch.from_numpy(t), torch.from_numpy(wid), 16)
    if ok:  # the fold is lossless
        assert (np.asarray(wt) >= 0).sum() == (t >= 0).sum()
    assert np.array_equal(gt.numpy(), np.asarray(wt))
    assert np.array_equal(gw.numpy(), np.asarray(ww))
    assert np.array_equal(_u32(gs), _u32(ws))
    st = tk.TieredState(t, wid, np.ones(200, np.int32), np.full((8, 4), -1, np.int32), 0, 16, 64, 32, "cpu")
    monkeypatch.setenv("YTTM_TRAIN_FOLD_MIN", "16")
    wanted = tt.fold_wanted(t.size, 16, int((t >= 0).sum()))
    assert tk.fold_rows_plain(st) == (ok and wanted)
    if ok and wanted:
        assert np.array_equal(st.tok.numpy(), np.asarray(wt))


def _buckets(seed, n_words=400, max_len=9):
    rng = random.Random(seed)
    words = ["".join(rng.choice("abcdef") for _ in range(rng.randint(1, max_len))) for _ in range(n_words)]
    text = " ".join(rng.choice(words) for _ in range(3000))
    cps = np.array([ord(c) for c in text], dtype=np.uint32)
    uniq, cnt, n = j_pre.char_frequencies(cps)
    al = j_pre.build_alphabet(uniq, cnt, n, 1.0, 4)
    return j_pre.training_word_buckets(cps, al)


@pytest.mark.parametrize("B", [16, 64])
def test_block_layouts(B):
    """The snug flatten, _reblock_flat, block_size_for and _max_word_len,
    array for array."""
    buckets = _buckets(B)
    assert tb.block_size_for(buckets) == jtb.block_size_for(buckets)
    assert tt._max_word_len(buckets) == jtt._max_word_len(buckets)
    want = jtt.flatten_word_buckets_blocked_snug(buckets, B)
    got = tt.flatten_word_buckets_blocked_snug(buckets, B)
    for g, w in zip(got, want):
        assert np.array_equal(g, np.asarray(w))
    flat_t, flat_w, _ = jts.flatten_word_buckets(buckets)
    for g, w in zip(tb._reblock_flat(flat_t, flat_w, B), jtb._reblock_flat(flat_t, flat_w, B)):
        assert np.array_equal(g, w)
    # the host loop's B: 64 unless YTTM_TRAIN_B lowers the floor
    assert tt.tiered_block_size(buckets) == 64


def test_library_rebuilds_when_a_header_changes(tmp_path, monkeypatch):
    """A kernel library is rebuilt when its source or a header it includes
    (the shared ``csrc/train_common.cuh``) is newer than the library."""
    import os
    import sys

    from youtokentome_tpu_torch import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    src, hdr = tmp_path / "k.cu", tmp_path / "common.cuh"
    src.write_text("source")
    hdr.write_text("header")
    builds = tmp_path / "builds.txt"
    # a stand-in compiler: copies the source to the output, logs the build
    cmd = [sys.executable, "-c",
           f"import shutil, sys; shutil.copy(sys.argv[1], sys.argv[3]); open({str(builds)!r}, 'a').write('x')"]
    out = _build.build_library(src, "libk.so", cmd, [hdr])
    assert out.read_text() == "source"
    _build.build_library(src, "libk.so", cmd, [hdr])
    assert builds.read_text() == "x"  # up to date: not rebuilt
    later = out.stat().st_mtime + 10
    os.utime(hdr, (later, later))
    _build.build_library(src, "libk.so", cmd, [hdr])
    assert builds.read_text() == "xx"
