"""The torch port's multi-process trainer against the JAX package, on the
CPU: two gloo ranks, each with two CPU shards (4 global), must train the
rules and char2id of the JAX one-process trainer on the concatenated text,
and agree with each other, through both engines (the kernel engine, whose
kernels run their plain versions here, and the plain round loop).  The
port's counterpart of ``tests/test_distributed.py``: the same texts, the
same pinned pcap that makes the run overflow and retry, and a split that
leaves rank 1 a single word.  One pair of worker processes runs every case
in turn, so the file starts two interpreters in all."""

import json
import os
import random
import re
import socket
import subprocess
import sys

import numpy as np
import pytest

from youtokentome_tpu.host import preprocess as j_pre
from youtokentome_tpu.models.state import BpeConfig as JConfig
from youtokentome_tpu.models.state import SpecialTokens as JSpecial
from youtokentome_tpu.ops.train_delta import _next_pow2, host_count_table
from youtokentome_tpu.ops.train_stream import flatten_word_buckets
from youtokentome_tpu.train import train_from_codepoints as j_train

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
ENGINES = ("kernels", "plain")
OVERFLOW_LINE = "pair-count table overflow: retrying"
PROGRESS = 8

# Each rank runs every case with both engines; the JAX package and JAX
# itself are refused at import, so a case that reached either fails.
WORKER = r"""
import contextlib, io, json, os, sys

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "youtokentome_tpu"):
            raise ImportError("the port imported " + name)
        return None

sys.meta_path.insert(0, Refuse())
rank, port, cases_path, out_path = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
sys.path.insert(0, %(repo)r)
import numpy as np
from youtokentome_tpu_torch.models.state import BpeConfig, SpecialTokens
from youtokentome_tpu_torch.ops import delta_sharded_kernels as dsk
from youtokentome_tpu_torch.parallel import distributed as dist
from youtokentome_tpu_torch.parallel.mesh import DataMesh

dist.initialize(f"localhost:{port}", num_processes=2, process_id=rank)
window_min = dsk.WINDOW_MIN
out = {}

# each exchange of the kernel engine: [recount rounds it folded (NREC's
# step), calls of the recount's plain version in it]
exchanges, recount_calls = [], []
real_recount, real_exchange = dsk.shard_recount_plain, dsk.ProcessShardedEngine._exchange

def counted_recount(st, shards):
    recount_calls.append(1)
    return real_recount(st, shards)

def logged_exchange(self, limit, recount=None):
    n0, c0 = int(self.head.ctl[dsk.NREC]), len(recount_calls)
    ret = real_exchange(self, limit, recount)
    exchanges.append([int(self.head.ctl[dsk.NREC]) - n0, len(recount_calls) - c0])
    return ret

dsk.shard_recount_plain = counted_recount
dsk.ProcessShardedEngine._exchange = logged_exchange
for case in json.load(open(cases_path)):
    dsk.WINDOW_MIN = case.get("window_min", window_min)
    local = case["text"][: case["split"]] if rank == 0 else case["text"][case["split"] :]
    cps = np.array([ord(c) for c in local], dtype=np.uint32)
    if case["pcap"]:
        os.environ["YTTM_TRAIN_PCAP"] = str(case["pcap"])
    else:
        os.environ.pop("YTTM_TRAIN_PCAP", None)
    for engine in %(engines)r:
        exchanges.clear()
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            state = dist.train_from_codepoints_distributed(
                cps, case["vocab"], BpeConfig(1.0, -1, SpecialTokens(0, 1, 2, 3)),
                progress_every=case["progress"], device="cpu", mesh=DataMesh(["cpu"] * 2),
                plain=engine == "plain")
        out[case["name"] + "/" + engine] = {
            "rules": state.rules, "char2id": sorted(state.char2id.items()),
            "stderr": err.getvalue(), "exchanges": list(exchanges)}
out["modules"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "youtokentome_tpu"))
with open(out_path, "w") as f:
    json.dump(out, f)
"""


def _text(seed: int, letters: str, n: int) -> str:
    """``tests/test_distributed.py``'s texts."""
    rng = random.Random(seed)
    return "".join(
        rng.choice(letters + " ") if rng.randrange(2) else rng.choice(letters) * rng.randint(2, 4)
        for _ in range(n)
    )


def _cps(text: str) -> np.ndarray:
    return np.array([ord(c) for c in text], dtype=np.uint32)


def _pinned_pcap(text: str) -> int:
    """next_pow2 of the initial pair kinds: any growth of the kinds
    overflows (``tests/test_distributed.py``)."""
    cps = _cps(text)
    uniq, cnt, dl = j_pre.char_frequencies(cps)
    alpha = j_pre.build_alphabet(uniq, cnt, dl, 1.0, 4)
    t, wid, freq = flatten_word_buckets(j_pre.training_word_buckets(cps, alpha))
    return _next_pow2(host_count_table(t, wid, freq)[0].size)


def _cases():
    match = _text(3, "abc", 500)
    overflow = _text(7, "abcde", 800)
    one_word = match.rstrip() + " cabbacab"
    return [
        # split at a word boundary near the middle (the caller's contract)
        {"name": "match", "text": match, "vocab": 30, "pcap": 0, "progress": 0,
         "split": match.find(" ", len(match) // 2) + 1},
        # a window of 4 entries: some rounds send their entries with the
        # ctl, others gather them again
        {"name": "overflow", "text": overflow, "vocab": 60, "pcap": _pinned_pcap(overflow),
         "progress": 0, "split": overflow.find(" ", len(overflow) // 2) + 1, "window_min": 4},
        # with the JAX host loop's progress lines, every PROGRESS ids
        {"name": "one_word", "text": one_word, "vocab": 30, "pcap": 0, "progress": PROGRESS,
         "split": one_word.rfind(" ") + 1},
    ]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both ranks' results ({case/engine: rules, char2id, stderr}) and the
    JAX one-process trainer's state of every case, computed while the
    workers run."""
    tmp = tmp_path_factory.mktemp("dist")
    cases = _cases()
    (tmp / "cases.json").write_text(json.dumps(cases))
    (tmp / "worker.py").write_text(WORKER % {"repo": REPO, "engines": ENGINES})
    # one thread a rank: the rounds' tensors are tiny, and two ranks that
    # each spread over every core slow each other down many times over
    env = dict(os.environ, YTTM_TRAIN_LOG="0", OMP_NUM_THREADS="1")
    env.pop("YTTM_TRAIN_PCAP", None)
    port = _free_port()
    outs = [tmp / f"out{r}.json" for r in range(2)]
    procs = [
        subprocess.Popen(
            [sys.executable, str(tmp / "worker.py"), str(r), str(port), str(tmp / "cases.json"),
             str(outs[r])],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        )
        for r in range(2)
    ]
    try:
        cfg = JConfig(1.0, -1, JSpecial(0, 1, 2, 3))
        single = {c["name"]: j_train(_cps(c["text"]), c["vocab"], cfg) for c in cases}
        errs = [proc.communicate(timeout=120)[1].decode() for proc in procs]
        failed = [f"rank {r}:\n{errs[r][-3000:]}" for r, p in enumerate(procs) if p.returncode]
        assert not failed, "\n".join(failed)
    finally:
        for proc in procs:
            proc.kill()
    results = [json.loads(o.read_text()) for o in outs]
    return results, single, {c["name"]: c for c in cases}


def _check(runs, name: str, engine: str):
    """Both ranks give the JAX one-process trainer's rules and char2id."""
    results, single, _ = runs
    got = [r[f"{name}/{engine}"] for r in results]
    want = single[name]
    for rank, g in enumerate(got):
        assert [tuple(r) for r in g["rules"]] == want.rules, f"rank {rank}'s rules"
        assert dict(tuple(p) for p in g["char2id"]) == {int(k): int(v) for k, v in want.char2id.items()}
    assert got[0]["rules"] == got[1]["rules"] and got[0]["char2id"] == got[1]["char2id"]
    return got


@pytest.mark.parametrize("engine", ENGINES)
def test_two_ranks_match_single(runs, engine):
    got = _check(runs, "match", engine)
    # only rank 0 prints, and only the JAX host loop's line
    n_chars = j_pre.char_frequencies(_cps(runs[2]["match"]["text"]))[0].size
    assert got[0]["stderr"] == f"number of unique characters in the training data: {n_chars}\n"
    assert got[1]["stderr"] == ""


@pytest.mark.parametrize("engine", ENGINES)
def test_two_ranks_overflow_retry(runs, engine):
    got = _check(runs, "overflow", engine)
    assert OVERFLOW_LINE in got[0]["stderr"], got[0]["stderr"]
    assert got[1]["stderr"] == ""


@pytest.mark.parametrize("engine", ENGINES)
def test_rank_with_a_single_word(runs, engine):
    case = runs[2]["one_word"]
    assert " " not in case["text"][case["split"]:]
    got = _check(runs, "one_word", engine)
    # rank 0 prints the JAX host loop's progress line after every segment of
    # PROGRESS ids (a segment's last round may pass its end)
    used0 = 30 - len(runs[1]["one_word"].rules)
    used = used0
    for line in got[0]["stderr"].splitlines()[1:]:
        m = re.fullmatch(r"id: (\d+)/30  merges: (\d+)  \(\d+\.\ds, \d+ merges/s\)", line)
        assert m and int(m[2]) == int(m[1]) - used0, line
        assert int(m[1]) >= min(30, used + PROGRESS), line
        used = int(m[1])
    assert used == 30
    assert got[1]["stderr"] == ""


def test_recount_only_on_recount_exchanges(runs):
    """The kernel engine's exchanges call the recount (its plain version
    here) on each of a rank's two shards in the exchanges that fold a
    recount, and in no other; the overflow case recounts at its start and
    at each retry."""
    results, _, cases = runs
    for name in cases:
        for rank, r in enumerate(results):
            ex = r[f"{name}/kernels"]["exchanges"]
            assert ex and all(calls == 2 * rebuilt and rebuilt in (0, 1) for rebuilt, calls in ex), (
                name, rank, ex)
            assert sum(rebuilt for rebuilt, _ in ex) >= (2 if name == "overflow" else 1), (name, ex)
            assert r[f"{name}/plain"]["exchanges"] == []


def test_imports_neither_jax_nor_the_jax_package(runs):
    for r in runs[0]:
        assert r["modules"] == []
