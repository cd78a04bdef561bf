#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``youtokentome_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card.  It
builds the port's kernels from the sources, holds every kernel against
its plain torch version and the C++ host merger, drives the encode path
at the full width of a vocab-30000 model over a 100 MB corpus, and
prints timings.  Phases, in order (any failure exits nonzero):

  1. device and build: the card's name and power limit; nvcc/g++ builds
  2. kernel vs plain version: random rows for every cap 8..512 at
     R = 8192, int32 and uint16 wire, exact equality with the plain torch
     version (on the card) and with the C++ ``RuleTable.merge_words``
  3. main path: ``BPE(model).encode(lines)`` with no knob set takes the
     device arm (novel tokens > 2**22); ids equal the host arm's; a
     subword encode (matrix path); ``Encoder.encode_stream_cli`` over
     10 MiB chunks equal to the host arm's bytes; a decode round trip
  4. times: MB/s of both arms, the kernel's per-launch time for each
     (R, cap) with CUDA events, and the plain version's time

The second-to-last line is a JSON ``kernels`` record, the line before
it the card; the last line is ``{"ok": true, "device": {...}}``.  It
exits nonzero without printing a result when no CUDA card is present or
the port is not importable.  Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
# Integer operations outside the tensor cores issue on the CUDA cores:
# the data sheet's float32 rate (67 TFLOP/s) is the peak used for them.
OPS_PER_S = 67e12
# Integer instructions the kernel needs per ranked pair and round: the
# hash (9), one probe (4), the min, selection and compaction (7).
OPS_PER_PAIR = 20
# ~0.1 s of card time at the H100's clocks: longer than the host takes to
# enqueue any timed batch of launches below
SLEEP_CYCLES = 200_000_000
CAPS = (8, 16, 32, 64, 128, 256, 512)
TIERS = (512, 2048, 8192)
SEED = 0
VOCAB = 30000
CORPUS_MB = 100
WORD_LIST = 2_000_000
WORDS_PER_LINE = 12
CLI_CHUNK = 10 * 1024 * 1024


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError("check failed: " + msg)


# -- phase 1 ----------------------------------------------------------------


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return res.stdout.strip()


def phase_device_and_build() -> dict:
    from youtokentome_tpu_torch.host import fastio, fasttok
    from youtokentome_tpu_torch.ops import _cuda

    card = card_line()
    log(f"[1] card: {card}")
    t0 = time.perf_counter()
    # one compiler per source, all started together
    with ThreadPoolExecutor(3) as ex:
        futs = [ex.submit(f) for f in (_cuda.load, fasttok._load, fastio._load)]
        for f in futs:
            f.result()
    build_s = time.perf_counter() - t0
    check(fasttok.available(), "the C++ tokenizer did not build")
    check(fastio._load() is not None, "the C++ formatter did not build")
    log(f"[1] kernels and host helpers built in {build_s:.2f} s")
    return {"card": card, "build_s": build_s}


# -- phase 2 ----------------------------------------------------------------


def hand_model():
    """A small model whose rules include every equal pair of letters (run
    parity) and merged-token pairs; placeholders come from the rows."""
    from youtokentome_tpu_torch.models.state import BPEState, SpecialTokens

    rng = np.random.default_rng(SEED)
    letters = list(range(5, 13))  # a..h; 4 is the space meta-symbol
    char2id = {9601: 4, **{97 + i: t for i, t in enumerate(letters)}}
    pairs = [(x, y) for x in letters for y in letters]
    rng.shuffle(pairs)
    rules, seen, z = [], set(), 13
    for x, y in pairs:
        rules.append((x, y, z)); seen.add((x, y)); z += 1
    while len(rules) < 400:
        ids = [4] + letters + [r[2] for r in rules]
        x, y = (int(v) for v in rng.choice(ids, 2))
        if rng.random() < 0.1:
            y = x  # equal pairs of merged tokens
        if (x, y) in seen:
            continue
        rules.append((x, y, z)); seen.add((x, y)); z += 1
    return BPEState(char2id, rules, SpecialTokens(0, 1, 2, 3))


def random_rows(rng, n_rows: int, cap: int, letters) -> np.ndarray:
    """Front-packed rows for bucket ``cap``: a space token, then runs of
    equal letters with unknown-run placeholders (numbered per row) mixed
    in; one row in 16 is empty."""
    lo = 2 if cap == 8 else cap // 2 + 1
    mat = np.full((n_rows, cap), -1, np.int32)
    lens = rng.integers(lo, cap + 1, n_rows)
    lens[rng.random(n_rows) < 1 / 16] = 0
    for i, n in enumerate(lens.tolist()):
        if n == 0:
            continue
        runs = np.repeat(rng.choice(letters, n), rng.geometric(0.5, n))[: n - 1]
        ph = rng.random(runs.size) < 0.04
        runs[ph] = 10**9 + np.arange(int(ph.sum()))
        mat[i, 0] = 4
        mat[i, 1:n] = runs
    return mat


def host_merge_rows(rtab, mat: np.ndarray) -> np.ndarray:
    """The C++ greedy merger on the rows' non-PAD prefixes, re-padded."""
    lens = (mat >= 0).sum(axis=1)
    off = np.zeros(mat.shape[0] + 1, np.int64)
    np.cumsum(lens, out=off[1:])
    rf, ro = rtab.merge_words(mat[mat >= 0], off)
    out = np.full_like(mat, -1)
    rl = np.diff(ro)
    cols = np.arange(mat.shape[1])[None, :] < rl[:, None]
    out[cols] = rf
    return out


def phase_kernel_checks(caps=CAPS, n_rows=TIERS[-1], dev="cuda:0") -> dict:
    import torch

    from youtokentome_tpu_torch.host import fasttok
    from youtokentome_tpu_torch.ops import encode_kernel as ek

    state = hand_model()
    tables = ek.EncoderTables.from_state(state, dev)
    rtab = fasttok.RuleTable(state.rules)
    unk = state.special_tokens.unk_id
    rng = np.random.default_rng(SEED + 1)
    letters = list(range(5, 13))
    rows_by_cap, max_err = {}, 0
    for cap in caps:
        mat = random_rows(rng, n_rows, cap, letters)
        rows_by_cap[cap] = mat
        want = host_merge_rows(rtab, mat)
        x = torch.from_numpy(mat).to(dev)
        got = ek.encode_greedy(tables, x)
        plain = ek.encode_greedy_plain(tables, x)
        got_np = got.cpu().numpy()
        max_err = max(max_err, int(np.abs(got_np.astype(np.int64) - plain.cpu().numpy()).max()))
        check(torch.equal(got, plain), f"int32 kernel != plain version at cap {cap}")
        check(np.array_equal(got_np, want), f"int32 kernel != C++ merger at cap {cap}")

        x16 = torch.from_numpy(ek.pack_tokens_u16(mat)).to(dev)
        got16 = ek.encode_greedy_u16(tables, x16, unk)
        plain16 = ek.encode_greedy_u16_plain(tables, x16, unk)
        want16 = np.where(want < 0, ek.U16_PAD, np.where(want >= ek.PLACEHOLDER_START, unk, want))
        g16 = got16.cpu().numpy().astype(np.int64)
        max_err = max(max_err, int(np.abs(g16 - plain16.cpu().numpy().astype(np.int64)).max()))
        check(np.array_equal(g16, plain16.cpu().numpy().astype(np.int64)),
              f"u16 kernel != plain version at cap {cap}")
        check(np.array_equal(g16, want16), f"u16 kernel != C++ merger at cap {cap}")
        merged = int((mat >= 0).sum() - (want >= 0).sum())
        log(f"[2] cap {cap:3d} R {n_rows}: int32 and u16 kernels == plain == C++ "
            f"merger ({merged} merges)")
    return {"tables": tables, "rows": rows_by_cap, "max_err": max_err, "unk": unk}


# -- phase 3 ----------------------------------------------------------------


def build_corpus(seed: int = SEED):
    """Zipf 1/r over a seeded list of random a-z words, lengths Poisson(6)
    clipped to 2-14, WORDS_PER_LINE words a line (the recipe of the
    repo's bench.py).  Returns (word list, lines)."""
    rng = np.random.default_rng(seed)
    lens = np.clip(rng.poisson(6, WORD_LIST), 2, 14)
    letters = (rng.integers(0, 26, int(lens.sum())) + 97).astype(np.uint8).tobytes().decode()
    ends = np.cumsum(lens).tolist()
    starts = [0] + ends[:-1]
    words = [letters[a:b] for a, b in zip(starts, ends)]
    probs = 1.0 / np.arange(1, WORD_LIST + 1)
    probs /= probs.sum()
    n_words = int(CORPUS_MB * 1_000_000 / (float(lens.mean()) + 1.0))
    idx = rng.choice(WORD_LIST, size=n_words, p=probs)
    sel = np.asarray(words, dtype=object)[idx].tolist()
    lines = [" ".join(sel[i : i + WORDS_PER_LINE]) for i in range(0, n_words, WORDS_PER_LINE)]
    return words, lines


def build_model(words, vocab_size: int = VOCAB):
    """A vocab-``vocab_size`` model from a seed: all letter pairs (equal
    pairs included), then, for the most frequent words in order, chain
    rules merging the word's current tokens (C++ merger over the rules so
    far, refreshed every 16 words) into one token.  Every z is new and
    increasing, so the model is valid."""
    from youtokentome_tpu_torch.host import fasttok
    from youtokentome_tpu_torch.models.state import BPEState, SpecialTokens

    rng = np.random.default_rng(SEED + 2)
    space, a = 4, 5
    char2id = {9601: space, **{97 + i: a + i for i in range(26)}}
    st = SpecialTokens(pad_id=0, unk_id=1, bos_id=2, eos_id=3)
    n_rules = vocab_size - len(char2id) - st.n_special_tokens()
    pairs = [(a + i, a + j) for i in range(26) for j in range(26)]
    rng.shuffle(pairs)
    rules = np.zeros((n_rules, 3), np.int32)
    rule_of = {}
    z = a + 26
    for x, y in pairs:
        rules[len(rule_of)] = (x, y, z); rule_of[(x, y)] = z; z += 1
    wi = 0
    while len(rule_of) < n_rules:
        batch = words[wi : wi + 16]
        wi += 16
        toks = [[space] + [a + ord(c) - 97 for c in w] for w in batch]
        off = np.zeros(len(toks) + 1, np.int64)
        np.cumsum([len(t) for t in toks], out=off[1:])
        rf, ro = fasttok.RuleTable(rules[: len(rule_of)]).merge_words(
            np.concatenate(toks).astype(np.int32), off
        )
        for u in range(len(toks)):
            cur = rf[ro[u] : ro[u + 1]].tolist()
            acc = cur[0]
            for t in cur[1:]:
                if (acc, t) not in rule_of:
                    if len(rule_of) == n_rules:
                        break
                    rules[len(rule_of)] = (acc, t, z); rule_of[(acc, t)] = z; z += 1
                acc = rule_of[(acc, t)]
    state = BPEState(char2id, [tuple(r) for r in rules.tolist()], st)
    check(state.vocab_size() == vocab_size, "model vocab size")
    return state, wi


def cli_chunks(blob: bytes):
    """Newline-aligned chunks of at most 10 MiB, as the CLI reads them."""
    start = 0
    while start < len(blob):
        end = min(start + CLI_CHUNK, len(blob))
        if end < len(blob):
            nl = blob.rfind(b"\n", start, end)
            if nl > start:
                end = nl + 1
        yield blob[start:end]
        start = end


class merge_arm:
    """Force YTTM_ENCODE_MERGE for a block (None: the default policy)."""

    def __init__(self, mode):
        self.mode = mode

    def __enter__(self):
        self.old = os.environ.pop("YTTM_ENCODE_MERGE", None)
        if self.mode is not None:
            os.environ["YTTM_ENCODE_MERGE"] = self.mode

    def __exit__(self, *exc):
        os.environ.pop("YTTM_ENCODE_MERGE", None)
        if self.old is not None:
            os.environ["YTTM_ENCODE_MERGE"] = self.old


def timed(fn):
    """(fn(), host seconds): every call here ends in a host copy of its
    result, so the host clock covers the device work."""
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def phase_main_path(work: Path, device=None) -> dict:
    import youtokentome_tpu_torch as yttm
    from youtokentome_tpu_torch.encoder import Encoder
    from youtokentome_tpu_torch.host import fasttok
    from youtokentome_tpu_torch.models.state import BPEState
    from youtokentome_tpu_torch.ops import encode_kernel as ek

    t0 = time.perf_counter()
    words, lines = build_corpus()
    log(f"[3] corpus: {len(lines)} lines, {len(words)}-word list "
        f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    state, n_model_words = build_model(words)
    model_path = work / "vocab30k.yttm"
    state.dump(str(model_path))
    check(BPEState.load(str(model_path)) == state, "model codec round trip")
    log(f"[3] model: vocab {state.vocab_size()}, {len(state.rules)} rules from the "
        f"{n_model_words} most frequent words ({time.perf_counter() - t0:.1f} s)")

    blob = ("\n".join(lines) + "\n").encode()
    n_bytes = len(blob)
    alpha_cps = np.sort(np.array(list(state.char2id), np.uint32))
    alpha_ids = np.array([state.char2id[int(c)] for c in alpha_cps], np.int32)
    (wf, wo, _, _), tokenize_s = timed(lambda: fasttok.tokenize(blob, alpha_cps, alpha_ids, 4))
    novel = int(wf.size)
    thr = int(os.environ.get("YTTM_HOST_MERGE_TOKENS", str(1 << 22)))
    log(f"[3] {n_bytes} bytes, {wo.size - 1} distinct words, {novel} novel tokens "
        f"(host-merge threshold {thr})")
    check(novel > thr, "novel tokens must exceed the host-merge threshold")
    sample = lines[:2000]

    # -- the main path, counted --
    with merge_arm(None):
        bpe = yttm.BPE(str(model_path), device=device)
        check(device is not None or bpe.device.type == "cuda", "BPE runs on cuda by default")
        ek.encode_greedy.launches = 0
        ek.encode_greedy_u16.launches = 0
        ids_main, main_s = timed(lambda: bpe.encode(lines))
        subwords = bpe.encode(sample, output_type=yttm.OutputType.SUBWORD)
        enc = Encoder(state, device=device)
        with merge_arm("device"):
            cli_main, cli_main_s = timed(lambda: b"".join(enc.encode_stream_cli(cli_chunks(blob))))
        decoded = bpe.decode(ids_main[: len(sample)])
        launches = {
            "encode_greedy": ek.encode_greedy.launches,
            "encode_greedy_u16": ek.encode_greedy_u16.launches,
        }
    log(f"[3] main path launches: {launches}")
    if bpe.device.type == "cuda":
        check(launches["encode_greedy_u16"] > 0, "the id encode did not launch the u16 kernel")
        check(launches["encode_greedy"] > 0, "the subword encode did not launch the int32 kernel")

    n_vocab = state.vocab_size()
    check(all(0 <= min(s) and max(s) < n_vocab for s in ids_main if s), "ids out of range")
    sub_ids = [[bpe.subword_to_id(p) for p in s] for s in subwords]
    check(sub_ids == ids_main[: len(sample)], "subwords do not map back to the ids")
    check(all("".join(s).replace("▁", " ")[1:] == t for s, t in zip(subwords, sample)),
          "subwords do not spell the text")
    check(decoded == sample, "decode round trip")
    log(f"[3] subwords map to the ids and spell the text; decode round trip of "
        f"{len(sample)} lines")

    # -- both arms in turns (device, host, host, device), fresh encoders
    #    each time, outside the counted window: the API call (cold word
    #    cache, then warm: no novel word left to merge), the CLI engine,
    #    and the merge stage alone on all the corpus's novel words
    turns = []
    for arm in ("device", "host", "host", "device"):
        with merge_arm(arm):
            api = yttm.BPE(str(model_path), device=device)
            ids, api_s = timed(lambda: api.encode(lines))
            check(ids == ids_main, f"{arm}-arm ids != the main path's")
            del ids
            ids, warm_s = timed(lambda: api.encode(lines))
            check(ids == ids_main, f"{arm}-arm warm-cache ids != the main path's")
            del ids, api
            enc = Encoder(state, device=device)
            out, cli_s = timed(lambda: b"".join(enc.encode_stream_cli(cli_chunks(blob))))
            check(out == cli_main, f"{arm}-arm encode_stream_cli bytes != the main path's")
            stage = Encoder(state, device=device)
            _, merge_s = timed(lambda: stage._merge_collect(stage._merge_dispatch(wf, wo)))
        turns.append({"arm": arm, "api_mbps": n_bytes / 1e6 / api_s,
                      "api_warm_mbps": n_bytes / 1e6 / warm_s,
                      "cli_mbps": n_bytes / 1e6 / cli_s, "merge_s": merge_s})
    log(f"[3] ids and encode_stream_cli bytes ({len(cli_main)}): device arm == host arm")
    _, bucket_s = timed(lambda: Encoder._bucket_rows(wf, wo))
    main_path = {"api_mbps": n_bytes / 1e6 / main_s, "cli_device_mbps": n_bytes / 1e6 / cli_main_s,
                 "tokenize_s": tokenize_s, "bucket_packing_s": bucket_s}

    # the main path's kernel inputs: the novel words' length buckets
    buckets = Encoder._bucket_rows(wf, wo)
    return {"launches": launches, "turns": turns, "main_path": main_path, "buckets": buckets,
            "unk": state.special_tokens.unk_id, "tables": bpe._encoder.tables}


# -- phase 4 ----------------------------------------------------------------


def event_ms(fn, reps: int) -> float:
    """Device milliseconds per call of ``fn``, from CUDA events.  A sleep
    kernel queued first keeps the card busy while the host enqueues all
    the calls, so the wrappers' host cost between launches is not counted
    as device time (a call that waits on the host, as the plain version
    does every round, still counts its waits)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def host_us_per_call(fn, n: int = 200) -> float:
    """Host microseconds to enqueue one call of ``fn`` (no sync)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)  # the card stays busy: only the host is timed
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def ranked_pairs(tables, x) -> int:
    """Adjacent token pairs the kernel ranks on rows ``x``: each row's
    valid pairs in every round it runs (its rounds with a rule, and the
    last one, which finds none)."""
    import torch

    from youtokentome_tpu_torch.ops import encode_kernel as ek

    total, toks = 0, x
    runs = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
    for _ in range(x.shape[1]):
        valid = (toks[:, :-1] != ek.PAD) & (toks[:, 1:] != ek.PAD) & runs[:, None]
        total += int(valid.sum())
        toks, active = ek.merge_round(tables, toks)
        runs &= active[:, 0]
        if not bool(runs.any()):
            break
    return total


def phase_times(card: str, kchk: dict, main: dict) -> list:
    import torch

    from youtokentome_tpu_torch.encoder import DEVICE_BATCH
    from youtokentome_tpu_torch.ops import encode_kernel as ek

    dev = torch.device("cuda", 0)
    tables, unk = kchk["tables"], kchk["unk"]
    x = torch.from_numpy(np.ascontiguousarray(kchk["rows"][CAPS[0]][:TIERS[0]])).to(dev)
    log(f"[4] host cost of one wrapper call (R {TIERS[0]}, cap {CAPS[0]}): "
        f"{host_us_per_call(lambda: ek.encode_greedy(tables, x)):.1f} us ({card})")
    log(f"[4] per-launch device times on random rows ({card}); "
        f"bound = R*L*(in+out bytes) / 3.35 TB/s")
    log("[4] variant   R     cap   kernel_ms   bound_ms   plain_ms")
    for cap, mat in kchk["rows"].items():
        for r in TIERS:
            x = torch.from_numpy(np.ascontiguousarray(mat[:r])).to(dev)
            x16 = torch.from_numpy(ek.pack_tokens_u16(mat[:r])).to(dev)
            for name, fk, fp, nb in (
                ("int32", lambda: ek.encode_greedy(tables, x),
                 lambda: ek.encode_greedy_plain(tables, x), 8),
                ("u16", lambda: ek.encode_greedy_u16(tables, x16, unk),
                 lambda: ek.encode_greedy_u16_plain(tables, x16, unk), 4),
            ):
                k_ms = event_ms(fk, 10)
                p_ms = event_ms(fp, 1)
                b_ms = r * cap * nb / HBM_BYTES_PER_S * 1e3
                log(f"[4] {name:6s} {r:5d} {cap:5d} {k_ms:11.4f} {b_ms:10.5f} {p_ms:10.3f}")

    # the main path's own inputs: every bucket chunk of the 100 MB encode
    tables, unk = main["tables"], main["unk"]
    chunks = []
    for _, mat in main["buckets"]:
        for c0 in range(0, mat.shape[0], DEVICE_BATCH):
            chunks.append(np.ascontiguousarray(mat[c0 : c0 + DEVICE_BATCH]))
    x32 = [torch.from_numpy(c).to(dev) for c in chunks]
    x16 = [torch.from_numpy(ek.pack_tokens_u16(c)).to(dev) for c in chunks]
    elems = sum(c.size for c in chunks)
    shapes = sorted({c.shape for c in chunks})
    pairs = sum(ranked_pairs(tables, x) for x in x32)
    ops_ms = pairs * OPS_PER_PAIR / OPS_PER_S * 1e3
    log(f"[4] main-path inputs: {pairs} ranked pairs, operations bound {ops_ms:.5f} ms")
    rows = []
    for name, xs, fk, fp, nb in (
        ("encode_greedy", x32, lambda x: ek.encode_greedy(tables, x),
         lambda x: ek.encode_greedy_plain(tables, x), 8),
        ("encode_greedy_u16", x16, lambda x: ek.encode_greedy_u16(tables, x, unk),
         lambda x: ek.encode_greedy_u16_plain(tables, x, unk), 4),
    ):
        k_ms = event_ms(lambda: [fk(x) for x in xs], 5)
        p_ms = event_ms(lambda: [fp(x) for x in xs], 1)
        b_ms = elems * nb / HBM_BYTES_PER_S * 1e3
        rows.append({"name": name, "ms": k_ms, "plain_ms": p_ms, "bound_ms": max(b_ms, ops_ms),
                     "bound_by": "bytes" if b_ms >= ops_ms else "operations"})
        log(f"[4] main-path inputs ({len(xs)} launches, shapes {shapes}): {name} "
            f"kernel {k_ms:.4f} ms, bytes bound {b_ms:.5f} ms, plain {p_ms:.3f} ms")
    mp = main["main_path"]
    log(f"[4] main path (default policy): API {mp['api_mbps']:.2f} MB/s; CLI engine, device "
        f"arm: {mp['cli_device_mbps']:.2f} MB/s; C++ tokenize {mp['tokenize_s']:.3f} s; "
        f"bucket packing {mp['bucket_packing_s']:.3f} s ({card})")
    for t in main["turns"]:
        log(f"[4] {t['arm']:6s} arm: API {t['api_mbps']:.2f} MB/s (warm cache "
            f"{t['api_warm_mbps']:.2f}), CLI engine {t['cli_mbps']:.2f} MB/s, merge stage "
            f"{t['merge_s']:.3f} s ({card})")
    return rows


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        import youtokentome_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable ({e}); run from the repo root",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    work = ROOT / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)

    info = phase_device_and_build()
    kchk = phase_kernel_checks()
    main_res = phase_main_path(work)
    times = phase_times(info["card"], kchk, main_res)

    source = "youtokentome_tpu_torch/csrc/encode_greedy.cu"
    replaces = {
        "encode_greedy": "youtokentome_tpu/ops/encode_kernel.py:95",
        "encode_greedy_u16": "youtokentome_tpu/ops/encode_kernel.py:148",
    }
    kernels = [
        {
            "name": t["name"], "route": "cuda", "source": source,
            "replaces": replaces[t["name"]], "launches": main_res["launches"][t["name"]],
            "max_abs_err": kchk["max_err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": None,
            "equal": True,
        }
        for t in times
    ]
    log(f"[4] build {info['build_s']:.2f} s, whole run {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(info["card"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
