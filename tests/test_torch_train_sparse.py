"""The torch port's v3 sparse trainer and v4 block trainer against the JAX
package's, on the CPU, from inputs made from a seed: the plain round loops
against the JAX programs (v3: the tombstoned stream and the live (key,
count) multiset; v4: the rows and the multiset; with rules, used, done and
overflow), every forced branch (tiny site buffers, tiny pcap, tiny KB, a
word over 512 tokens), the kernels' plain versions against
the plain round loops, and the trainers' rules, char2id, ``.yttm`` bytes,
stderr and checkpoints against the JAX package's.  All values are
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
from youtokentome_tpu.ops import train_block as jtb
from youtokentome_tpu.ops import train_delta as jtd
from youtokentome_tpu.ops import train_sparse as jsp
from youtokentome_tpu.ops import train_stream as jts
from youtokentome_tpu.train import train_from_codepoints as jax_train
import youtokentome_tpu_torch as yttm
from youtokentome_tpu_torch import cli
from youtokentome_tpu_torch import train as port
from youtokentome_tpu_torch.models.state import BpeConfig, SpecialTokens
from youtokentome_tpu_torch.ops import block_kernels as blk
from youtokentome_tpu_torch.ops import sparse_kernels as spk
from youtokentome_tpu_torch.ops import train_block as tb
from youtokentome_tpu_torch.ops import train_delta as td
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


BUCKETS, USED0 = _buckets(_run_heavy(1) + " " + "a" * 41 + " " + "ab" * 30)
VOCAB = USED0 + 70


def _jax_table(tk, tc):
    """The JAX table's live entries as sorted (x << 32 | y, count) (numpy)."""
    xs, ys = (np.asarray(v).astype(np.int64) for v in jtd._unpack_key(tk))
    tc = np.asarray(tc)
    live = tc > 0
    keys = (xs[live] << 32) | ys[live]
    order = np.argsort(keys)
    return keys[order], tc[live][order]


def _port_table(tk, tc):
    live = (tc > 0).numpy()
    keys, cnts = tk.numpy()[live], tc.numpy()[live]
    order = np.argsort(keys)
    return keys[order], cnts[order]


def _same_tables(a, b):
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


@functools.lru_cache(maxsize=None)
def _jax_rules(impl):
    """The JAX trainer ``impl``'s rules on BUCKETS to VOCAB, run once a
    test process (the tests compare, and never change, them)."""
    run = {"sparse": jsp.run_training_sparse, "block": jtb.run_training_block,
           "delta": jtd.run_training_delta}[impl]
    return run(BUCKETS, USED0, VOCAB)


# -- v3: the plain round loop against the JAX program -------------------------


@pytest.mark.parametrize("case", ["tiers", "recount", "overflow"])
def test_sparse_round_loop_matches_jax(case):
    """Segment by segment: the tombstoned stream, the live table, rules,
    used, done and overflow equal the JAX program's, with the site buffers
    that hold every round (tiers), that hold none (recount), and a table
    that overflows (pcap just above the initial pairs)."""
    t, wid, freq = ts.flatten_word_buckets(BUCKETS)
    uk, uc = jtd.host_count_table(t, wid, freq)
    pcap = {"overflow": td._next_pow2(uk.size + 1)}.get(case, 1024)
    dcap0, dcap1 = (16, 32) if case == "recount" else (1024, 2048)
    jk, jc = jtd._fit_table(uk, uc, pcap)
    pk, pc = td._fit_table(uk, uc, pcap, "cpu")
    rules = np.full((VOCAB, 4), -1, np.int32)
    jt, jr, ju = jnp.asarray(t), jnp.asarray(rules), USED0
    pt, pr, pu = torch.from_numpy(t), torch.from_numpy(rules.copy()), USED0
    for limit in (USED0 + 9, VOCAB):
        jt, jk, jc, jr, jused, jdone, jover = jsp.train_rounds_sparse(
            jt, jnp.asarray(wid), jnp.asarray(freq), jk, jc, jr, jnp.asarray(ju, jnp.int32),
            jnp.asarray(USED0, jnp.int32), jnp.asarray(limit, jnp.int32), VOCAB, 16, pcap, dcap0,
            dcap1,
        )
        ju = int(jused)
        pt, pk, pc, pr, pu, pdone, pover = sp.train_rounds_sparse(
            pt, torch.from_numpy(wid), torch.from_numpy(freq), pk, pc, pr, pu, USED0, limit,
            VOCAB, 16, pcap, dcap0, dcap1,
        )
        assert np.array_equal(np.asarray(jt), pt.numpy())
        assert np.array_equal(np.asarray(jr), pr.numpy())
        assert (ju, bool(jdone), bool(jover)) == (pu, pdone, pover)
        _same_tables(_jax_table(jk, jc), _port_table(pk, pc))
        if pover:
            break
    assert pover == (case == "overflow")
    assert (pt < 0).sum() > (torch.from_numpy(t) < 0).sum()  # tombstones


def test_sparse_pieces_match_jax():
    """_pairs_tomb and _apply_tomb on a tombstoned stream, and the site
    gather, equal the JAX functions."""
    rng = np.random.default_rng(4)
    t, wid, freq = ts.flatten_word_buckets(BUCKETS)
    t = t.copy()
    t[(rng.random(t.size) < 0.2) & (t >= 0)] = -1
    fw = (freq[np.maximum(wid, 0)] * (wid >= 0)).astype(np.int32)
    jkeys, jw, jlive, jd = jsp._pairs_tomb(jnp.asarray(t), jnp.asarray(wid), jnp.asarray(fw))
    pkeys, pw, plive, pd = sp._pairs_tomb(torch.from_numpy(t), torch.from_numpy(wid), torch.from_numpy(fw))
    assert np.array_equal(np.asarray(jw), pw.numpy()) and np.array_equal(np.asarray(jd), pd.numpy())
    jx, jy = (np.asarray(v).astype(np.int64) for v in jtd._unpack_key(jkeys))
    px, py = td._unpack_key(pkeys)
    assert np.array_equal(jx, px.numpy()) and np.array_equal(jy, py.numpy())
    cx = np.array([5, 6, 7, 8], np.int32)
    cy = np.array([5, 5, 6, 9], np.int32)
    acc = np.array([True, True, False, True])
    zs = np.array([100, 101, 102, 103], np.int32)
    jt2, jhit = jsp._apply_tomb(jnp.asarray(t), jkeys, jlive, jd, jnp.asarray(acc), jnp.asarray(cx),
                                jnp.asarray(cy), jnp.asarray(zs), 4)
    pt2, phit = sp._apply_tomb(torch.from_numpy(t), pkeys, plive, pd, torch.from_numpy(acc),
                               torch.from_numpy(cx), torch.from_numpy(cy), torch.from_numpy(zs))
    assert np.array_equal(np.asarray(jt2), pt2.numpy()) and np.array_equal(np.asarray(jhit), phit.numpy())
    cs = np.cumsum(rng.random(200) < 0.3).astype(np.int32)
    jpos, jval = jsp._gather_affected(jnp.asarray(cs), 64)
    ppos, pval = sp._gather_affected(torch.from_numpy(cs), 64)
    assert np.array_equal(np.asarray(jpos), ppos.numpy()) and np.array_equal(np.asarray(jval), pval.numpy())


# -- v4: the plain round loop against the JAX program -------------------------


@pytest.mark.parametrize("case", ["block", "full", "overflow"])
def test_block_round_loop_matches_jax(case):
    """Segment by segment: the rows, the live table, rules, used, done and
    overflow equal the JAX program's, on the block path (KB holds every
    round's rows), the full path (KB 1) and with a table that overflows."""
    B = jtb.block_size_for(BUCKETS)
    t, wid, freq = jtb.flatten_word_buckets_blocked(BUCKETS, B)
    pt0, pw0, pf0 = tb.flatten_word_buckets_blocked(BUCKETS, B)
    assert np.array_equal(t, pt0) and np.array_equal(wid, pw0) and np.array_equal(freq, pf0)
    uk, uc = jtd.host_count_table(t, wid, freq)
    pcap = {"overflow": td._next_pow2(uk.size + 1)}.get(case, 1024)
    KB = 1 if case == "full" else 64
    jk, jc = jtd._fit_table(uk, uc, pcap)
    pk, pc = td._fit_table(uk, uc, pcap, "cpu")
    rules = np.full((VOCAB, 4), -1, np.int32)
    jt, jw, jr, ju = jnp.asarray(t), jnp.asarray(wid), jnp.asarray(rules), USED0
    pt, pw, pr, pu = torch.from_numpy(t), torch.from_numpy(wid), torch.from_numpy(rules.copy()), USED0
    for limit in (USED0 + 9, VOCAB):
        jt, jw, jk, jc, jr, jused, jdone, jover, _ = jtb.train_rounds_block(
            jt, jw, jnp.asarray(freq), jk, jc, jr, jnp.asarray(ju, jnp.int32),
            jnp.asarray(USED0, jnp.int32), jnp.asarray(limit, jnp.int32), VOCAB, 16, pcap, B, KB,
        )
        ju = int(jused)
        pt, pw, pk, pc, pr, pu, pdone, pover, _ = tb.train_rounds_block(
            pt, pw, torch.from_numpy(freq), pk, pc, pr, pu, USED0, limit, VOCAB, 16, pcap, B, KB,
        )
        assert np.array_equal(np.asarray(jt), pt.numpy()) and np.array_equal(np.asarray(jw), pw.numpy())
        assert np.array_equal(np.asarray(jr), pr.numpy())
        assert (ju, bool(jdone), bool(jover)) == (pu, pdone, pover)
        _same_tables(_jax_table(jk, jc), _port_table(pk, pc))
        if pover:
            break
    assert pover == (case == "overflow")


# -- the kernels' plain versions against the plain round loops ----------------


def _complete(eng, used, limit):
    """Rounds up to ``limit`` (or done), regrowing the table on overflow."""
    while True:
        used, done, overflow = eng.segment(used, limit)
        if not overflow:
            return used, done
        eng.regrow()


def _lockstep(kern, plain, rows, tables, seg=9):
    used = USED0
    while used < VOCAB:
        limit = min(VOCAB, used + seg)
        ku, kd = _complete(kern, used, limit)
        pu, pd = _complete(plain, used, limit)
        assert (ku, kd) == (pu, pd)
        for a, b in rows():
            assert torch.equal(a, b)
        assert torch.equal(kern.rules, plain.rules)
        keys, cnts = kern.st.table()
        assert cnts.min(initial=0) >= 0
        _same_tables((keys[cnts > 0], cnts[cnts > 0]), _port_table(*tables()))
        used = ku


@pytest.mark.parametrize("pcap", [0, 24])
def test_sparse_kernels_match_round_loop(pcap, monkeypatch):
    """The v3 kernel engine's tombstoned stream, live table and rules equal
    the plain round loop's at every segment end; with pcap 24 both tables
    overflow (the kernel table is rebuilt, the plain one doubled)."""
    monkeypatch.setenv("YTTM_TRAIN_PCAP", str(pcap))
    t, wid, freq = ts.flatten_word_buckets(BUCKETS)
    rules = np.full((VOCAB, 4), -1, np.int32)
    kern = spk.SparseKernelEngine(t, wid, freq, rules, USED0, VOCAB, 16, "cpu")
    plain = sp.PlainSparseEngine(t, wid, freq, rules, USED0, VOCAB, 16, "cpu")
    _lockstep(kern, plain, lambda: [(kern.st.t, plain.t)], lambda: (plain.tk, plain.tc))
    assert (kern.rebuilds > 0) == (pcap > 0)


@pytest.mark.parametrize("pcap,kb", [(0, 0), (24, 8)])
def test_block_kernels_match_round_loop(pcap, kb, monkeypatch):
    """The v4 kernel engine's rows, live table and rules equal the plain
    round loop's at every segment end; KB 8 sends the first rounds down
    the full path, pcap 24 overflows both tables."""
    monkeypatch.setenv("YTTM_TRAIN_PCAP", str(pcap))
    monkeypatch.setenv("YTTM_TRAIN_KB", str(kb))
    B = tb.block_size_for(BUCKETS)
    t, wid, freq = tb.flatten_word_buckets_blocked(BUCKETS, B)
    rules = np.full((VOCAB, 4), -1, np.int32)
    kern = blk.BlockKernelEngine(t, wid, freq, rules, USED0, VOCAB, 16, B, "cpu")
    plain = tb.PlainBlockEngine(t, wid, freq, rules, USED0, VOCAB, 16, B, "cpu")
    _lockstep(kern, plain, lambda: [(kern.st.tok, plain.t), (kern.st.wid, plain.wid)],
              lambda: (plain.tk, plain.tc))
    work = kern.st.work.tolist()
    assert work[blk.W_ROWS] > 0 and (work[blk.W_FULL] > 0) == (kb > 0)
    assert (kern.rebuilds > 0) == (pcap > 0)


# -- the trainers, end to end ---------------------------------------------------


@pytest.mark.parametrize("impl", ["sparse", "block"])
@pytest.mark.parametrize("plain", [False, True])
def test_trainers_match_jax(impl, plain):
    prun = {"sparse": sp.run_training_sparse, "block": tb.run_training_block}[impl]
    assert prun(BUCKETS, USED0, VOCAB, plain=plain) == _jax_rules(impl)


@pytest.mark.parametrize("impl,knobs", [
    ("sparse", {"YTTM_TRAIN_DCAP0": "16", "YTTM_TRAIN_DCAP1": "32"}),
    ("sparse", {"YTTM_TRAIN_PCAP": "24"}),
    ("block", {"YTTM_TRAIN_KB": "1"}),
    ("block", {"YTTM_TRAIN_PCAP": "24"}),
])
def test_forced_branches_through_train_from_codepoints(impl, knobs, monkeypatch):
    """Tiny site buffers (v3's recount), a tiny pcap (the overflow retry
    and the kernel table's rebuild) and a tiny KB (v4's full path): rules
    and char2id equal the JAX package's under the same knobs."""
    monkeypatch.setenv("YTTM_TRAIN_IMPL", impl)
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    text = _run_heavy(9, n=900)
    a = jax_train(_cps(text), 60, JConfig(1.0, 1, JSpecial(0, 1, 2, 3)))
    b = port.train_from_codepoints(_cps(text), 60, BpeConfig(1.0, 1, SpecialTokens(0, 1, 2, 3)), "cpu")
    assert a.rules == b.rules and a.char2id == b.char2id


def test_block_long_word_falls_back_to_delta():
    """A word over 512 tokens: v4 trains with v2 in both packages, called
    (as the JAX host loop calls it) without the merge log's callback."""
    rng = random.Random(3)
    text = "ab" * 300 + " " + " ".join(
        "".join(rng.choice("abcdef") for _ in range(rng.randint(2, 9))) for _ in range(300))
    buckets, used0 = _buckets(text)
    assert tb.block_size_for(buckets) == 0
    calls = {"jax": 0, "port": 0}

    def log(who):
        def cb(rules, used):
            calls[who] += 1
        return cb

    want = jtb.run_training_block(buckets, used0, used0 + 40, progress_cb=log("jax"))
    for plain in (False, True):
        got = tb.run_training_block(buckets, used0, used0 + 40, progress_cb=log("port"), plain=plain)
        assert got == want
    assert want == jtd.run_training_delta(buckets, used0, used0 + 40)
    assert calls == {"jax": 0, "port": 0}


def _corpus(tmp_path, seed=5, n=600):
    p = tmp_path / "corpus.txt"
    rng = np.random.default_rng(seed)
    words = ["".join(rng.choice(list("abcdefghijklmnopqrst"), int(l))) for l in rng.integers(2, 9, 2500)]
    probs = 1.0 / np.arange(1, 2501)
    probs /= probs.sum()
    sel = np.array(words, object)[rng.choice(2500, n * 6, p=probs)]
    p.write_text("\n".join(" ".join(sel[i : i + 6]) for i in range(0, sel.size, 6)) + "\n")
    return str(p)


def test_sparse_yttm_bytes_and_stderr(tmp_path, capsys, monkeypatch):
    """BPE.train with ``YTTM_TRAIN_IMPL=sparse``: the model bytes and the
    default training stderr (with the per-1000 merge log) equal the JAX
    package's."""
    monkeypatch.setenv("YTTM_TRAIN_IMPL", "sparse")
    monkeypatch.setenv("YTTM_TRAIN_LOG", "1")
    data = _corpus(tmp_path, n=300)
    jm, pm = str(tmp_path / "j.yttm"), str(tmp_path / "p.yttm")
    jyttm.BPE.train(data=data, model=jm, vocab_size=1050, unk_id=5)
    want = capsys.readouterr().err
    yttm.BPE.train(data=data, model=pm, vocab_size=1050, unk_id=5, device="cpu")
    got = capsys.readouterr().err
    assert open(pm, "rb").read() == open(jm, "rb").read()
    assert got.replace("p.yttm", "j.yttm") == want
    assert sum(l.startswith("id: 1000=") for l in got.splitlines()) == 1


@pytest.mark.parametrize("impl", ["sparse", "block"])
def test_cli_bpe_bytes(impl, tmp_path, monkeypatch):
    """cli bpe with ``YTTM_TRAIN_IMPL=sparse|block``: the model bytes equal
    the JAX CLI's."""
    monkeypatch.setenv("YTTM_TRAIN_IMPL", impl)
    data = _corpus(tmp_path, n=200)
    cm, jcm = str(tmp_path / "c.yttm"), str(tmp_path / "jc.yttm")
    args = ["bpe", "--data", data, "--vocab_size", "200", "--coverage", "0.999"]
    res = CliRunner().invoke(cli.main, args + ["--model", cm, "--device", "cpu"])
    assert res.exit_code == 0, res.output
    res = CliRunner().invoke(jcli.main, args + ["--model", jcm])
    assert res.exit_code == 0, res.output
    assert open(cm, "rb").read() == open(jcm, "rb").read()


def test_sparse_progress_lines_with_the_plain_loop(capsys):
    """v3's progress line carries the live pair kinds and pcap: the plain
    round loop's equal the JAX host loop's (but for the merges/s figures)."""
    jsp.run_training_sparse(BUCKETS, USED0, VOCAB, progress_every=25)
    want = capsys.readouterr().err.splitlines()
    sp.run_training_sparse(BUCKETS, USED0, VOCAB, progress_every=25, plain=True)
    got = capsys.readouterr().err.splitlines()

    def strip(lines):
        return [(l.split("(")[0], l.split("merges/s")[-1]) for l in lines]

    assert strip(got) == strip(want) and len(got) == 3


# -- checkpoints across packages and trainers ----------------------------------


@pytest.mark.parametrize("writer,reader", [
    ("jax-sparse", "port-block"),
    ("port-sparse", "jax-stream"),
    ("port-block", "jax-sparse"),
    ("jax-block", "port-sparse"),
    ("port-block", "port-delta"),
])
def test_checkpoints_resume_across_packages_and_trainers(writer, reader, tmp_path):
    """A snapshot of any package's v3 or v4 trainer resumes in another
    package's or trainer's, to the uninterrupted rules (both port engines)."""
    runs = {
        "jax-sparse": jsp.run_training_sparse, "jax-block": jtb.run_training_block,
        "jax-stream": jts.run_training_stream, "port-sparse": sp.run_training_sparse,
        "port-block": tb.run_training_block, "port-delta": td.run_training_delta,
    }
    want = _jax_rules("delta")
    ck = str(tmp_path / "ck.npz")
    runs[writer](BUCKETS, USED0, USED0 + 30, checkpoint_path=ck, checkpoint_every=12)
    assert USED0 < int(np.load(ck)["used"]) < USED0 + 30
    if reader.startswith("jax"):
        assert runs[reader](BUCKETS, USED0, VOCAB, resume_path=ck) == want
    else:
        for plain in (False, True):
            assert runs[reader](BUCKETS, USED0, VOCAB, resume_path=ck, plain=plain) == want
