"""Batched sentence encoding: host pipeline + device merge kernels.

PyTorch counterpart of ``youtokentome_tpu/encoder.py``.  The reference
fans sentences out over threads and encodes word-by-word with a priority
queue (encode_parallel bpe.cpp:1697-1738).  Here, on the native backend:

  1. the C++ tokenizer (host/fasttok.cpp) splits sentences into words,
     deduplicates them against a persistent word cache, and maps chars to
     ids, collapsing unknown-char runs into placeholder tokens >= 10**9
     (bpe.cpp:1503-1527);
  2. novel words are packed into padded ``[rows, cap]`` length buckets
     and merged on the card by the CUDA kernel (ops/encode_kernel.py),
     or on the host by the C++ merger when the batch is small
     (``_merge_policy``);
  3. C++ expands cached results back to occurrences and formats them.

The flat stream backend (``YTTM_ENCODE_BACKEND=stream``, and id mode
without the C++ helpers) runs the whole pipeline on the device from the
raw bytes (ops/stream_kernel.py).  Subword output, and models whose id 0
is a real token, take a numpy host pipeline (the matrix path) that
deduplicates words and sends buckets to the merge kernel.

BPE-dropout (``dropout_prob`` > 0) samples every occurrence on its own
(bpe.cpp:1415-1453): id mode goes through the C++ tokenizer and its
seeded per-occurrence merge; subword output, ``YTTM_DROPOUT_NATIVE=0``
and zero-is-real models take the matrix path with one row per
occurrence and the dropout kernel.  The seed of one call is drawn from
the caller's ``torch.Generator``, or from ``os.urandom``.

The encoder runs on ``cuda`` unless the caller asks for ``cpu``; on the
CPU the kernels' plain torch versions run.  With more than one visible
card (at most ``YTTM_DEVICES``) the greedy merges of the native and the
matrix path shard their rows over a data mesh of the cards
(parallel/encode_sharded.py), as the JAX package does over its devices;
dropout merges and the stream backend stay on one device.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .host import fasttok, preprocess
from .models.state import BOS_TOKEN, EOS_TOKEN, SPACE_TOKEN, BPEState
from .models.vocab import Vocabulary
from .ops.encode_kernel import (
    PLACEHOLDER_START,
    U16_PAD,
    U16_PH_FLOOR,
    EncoderTables,
    encode_dropout,
    encode_greedy,
    encode_greedy_u16,
    pack_tokens_u16,
)
from .ops.stream_kernel import NEWLINE, U16_NEWLINE, StreamEncoder


# id-mode fast-path backend: "native" = C++ tokenizer + device merge of
# unique words; "stream" = the flat device pipeline from raw bytes;
# "matrix" = numpy host pipeline (always used for subwords).  Read per
# call so tests can parameterize over backends.
def _encode_backend() -> str:
    return os.environ.get("YTTM_ENCODE_BACKEND", "native")


ENCODE_BUCKETS = (8, 16, 32, 64, 128, 256, 512)
MAX_DEVICE_LEN = ENCODE_BUCKETS[-1]
# Largest row count of one kernel launch; bigger row sets are chunked.
DEVICE_BATCH = 8192


def resolve_device(device=None) -> torch.device:
    """The device to run on: ``cuda`` (card 0) when ``device`` is None.
    Raises when CUDA is asked for and absent; never falls back to the
    CPU on its own."""
    if device is None:
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU with the kernels' plain torch versions"
            )
        return torch.device("cuda", dev.index if dev.index is not None else 0)
    if dev.type != "cpu":
        raise ValueError(f"device must be cuda or cpu, not {dev}")
    return dev


def dropout_seed(generator: Optional[torch.Generator] = None) -> int:
    """The 64-bit seed of one dropout encode: two 32-bit draws from
    ``generator``, or eight bytes of ``os.urandom`` without one."""
    if generator is None:
        return int.from_bytes(os.urandom(8), "little")
    lo, hi = torch.randint(
        0, 1 << 32, (2,), generator=generator, dtype=torch.int64, device=generator.device
    ).tolist()
    return lo | hi << 32


def _assemble(pieces, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Ragged results (flat ids, offsets [n+1]) in uid order from pieces
    of (uids, lengths, flat ids), each piece's words laid end to end."""
    lens = np.zeros(n, np.int64)
    for uids, ln, _ in pieces:
        lens[uids] = ln
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    flat = np.empty(int(offsets[-1]), np.int64)
    for uids, ln, f in pieces:
        if f.size:
            within = np.arange(f.size) - np.repeat(np.cumsum(ln) - ln, ln)
            flat[np.repeat(offsets[uids], ln) + within] = f
    return flat, offsets


def _pad_rows(mats: List[np.ndarray], cap: int) -> np.ndarray:
    """Stack a bucket's id matrices into one [rows, cap] matrix, each row
    padded to ``cap``.  The kernels take any row count, so no PAD rows are
    added (the JAX package pads to multiples of DEVICE_BATCH so that XLA
    compiles one program a cap)."""
    k = sum(m.shape[0] for m in mats)
    out = np.full((k, cap), -1, dtype=np.int32)
    r = 0
    for m in mats:
        out[r : r + m.shape[0], : m.shape[1]] = m
        r += m.shape[0]
    return out


class _MergeResult:
    """One merged chunk on its way back to the host.  On a card the
    result lands in pinned host memory through asynchronous copies, and
    ``numpy()`` waits for the events recorded after them (one a card);
    on the CPU it is ready at once."""

    def __init__(self, host: torch.Tensor, events=(), inputs=()):
        self._host = host
        self._events = events
        self._inputs = inputs  # pinned sources must outlive their copies

    def numpy(self) -> np.ndarray:
        for event in self._events:
            event.synchronize()
        self._events = self._inputs = ()
        return self._host.numpy()


def _to_host(outs: List[torch.Tensor], inputs=()) -> _MergeResult:
    """Start copying the row blocks ``outs`` (in row order, each on its
    device) into one host array."""
    if outs[0].device.type == "cpu":
        return _MergeResult(torch.cat(outs) if len(outs) > 1 else outs[0])
    rows = sum(o.shape[0] for o in outs)
    host = torch.empty((rows, *outs[0].shape[1:]), dtype=outs[0].dtype, pin_memory=True)
    r = 0
    for o in outs:
        host[r : r + o.shape[0]].copy_(o, non_blocking=True)
        r += o.shape[0]
    events = []
    for dev in dict.fromkeys(o.device for o in outs):
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(dev))
        events.append(event)
    return _MergeResult(host, events, inputs)


class Encoder:
    """Stateful encoder bound to a trained model, on one device (its
    greedy merges sharded over a data mesh when there is one).  ``mesh``
    (a ``parallel.mesh.DataMesh``) overrides the default mesh of
    ``device``'s cards."""

    def __init__(self, state: BPEState, cache_size: int = 1 << 20, device=None, mesh=None):
        self.state = state
        self.device = resolve_device(device)
        # resolved lazily (the JAX package's _get_mesh), so that building
        # an Encoder never touches the cards
        self._mesh = mesh
        self._mesh_resolved = mesh is not None
        self.vocab = Vocabulary(state)
        self.tables = EncoderTables.from_state(state, self.device)
        sorted_cps = np.sort(
            np.fromiter(state.char2id.keys(), dtype=np.uint32, count=len(state.char2id))
        )
        self._sorted_cps = sorted_cps
        self._sorted_ids = np.fromiter(
            (state.char2id[int(c)] for c in sorted_cps),
            dtype=np.int32,
            count=sorted_cps.size,
        )
        self.space_id = state.char2id[SPACE_TOKEN]
        # reference emission quirk (bpe.cpp:1591-1593): per-word output
        # starts at the first token with id != 0, so when id 0 belongs
        # to a REAL token (custom special ids all >= 1 leave id 0 to ▁),
        # an unmerged word-leading ▁ is dropped.  Reproduced for
        # bit-exactness; the flag gates the strip.
        st0 = state.special_tokens
        self._zero_is_real = 0 not in (
            st0.pad_id, st0.unk_id, st0.bos_id, st0.eos_id
        )
        self._cache: Dict[bytes, np.ndarray] = {}
        self._cache_size = cache_size
        # uint16 wire format for the id-mode merge on a card (halves the
        # bytes each chunk moves; ops/encode_kernel.py layout note)
        self._u16_ok = (
            state.vocab_size() < U16_PH_FLOOR
            and state.special_tokens.unk_id >= 0
        )
        # persistent cross-batch word cache for the native path (stable
        # uids + cached results; only novel words reach the merge)
        self._wcache: Optional[fasttok.WordCache] = None
        # host-side rule table for the merge dispatch crossover
        self._rtab: Optional[fasttok.RuleTable] = None
        self._stream = StreamEncoder(
            self.tables, self._sorted_cps, self._sorted_ids, self.space_id
        )

    def _use_u16(self) -> bool:
        return self._u16_ok and self.device.type == "cuda"

    def _get_mesh(self):
        """The data mesh that greedy merges shard over, or None: every
        visible card of the encoder's device (at most ``YTTM_DEVICES``;
        one card, the CPU or ``YTTM_DEVICES=1`` give None), unless the
        caller gave a mesh."""
        if not self._mesh_resolved:
            self._mesh_resolved = True
            from .parallel.mesh import default_mesh

            self._mesh = default_mesh(self.device)
        return self._mesh

    def _dispatch_merge(self, mat: np.ndarray, u16: bool, dropout=None) -> _MergeResult:
        """Start merging one padded int32 [B, cap] chunk on the device.
        With ``u16`` the chunk travels in the uint16 wire format and
        comes back with placeholders mapped to unk (id mode only).  With
        ``dropout`` = (p, seed, row0) the dropout kernel merges it, its
        rows drawing the coins of global rows row0, row0 + 1, ..."""
        unk = self.state.special_tokens.unk_id
        src = torch.from_numpy(pack_tokens_u16(mat) if u16 else mat)
        mesh = self._get_mesh() if dropout is None else None
        if mesh is not None and mat.shape[0] % mesh.size == 0:
            # the rows sharded over the mesh (the JAX package's
            # _dispatch_greedy; it too shards only when the rows divide)
            from .parallel import encode_sharded as es

            if u16:
                return _to_host(es.encode_greedy_sharded_u16(self.tables, src, unk, mesh))
            return _to_host(es.encode_greedy_sharded(self.tables, src, mesh))
        inputs = ()
        if self.device.type == "cuda":
            inputs = (src.pin_memory(),)
            src = inputs[0].to(self.device, non_blocking=True)
        if dropout is not None:
            out = encode_dropout(self.tables, src, *dropout)
        elif u16:
            out = encode_greedy_u16(self.tables, src, unk)
        else:
            out = encode_greedy(self.tables, src)
        return _to_host([out], inputs)

    def _ruletab(self) -> fasttok.RuleTable:
        if self._rtab is None:
            self._rtab = fasttok.RuleTable(self.state.rules)
        return self._rtab

    def _merge_policy(self, n_tokens: int) -> str:
        """Dispatch crossover for novel-word merging: "host" (C++ greedy
        merge, the latency arm) vs "device" (batched kernel, the
        throughput arm).  A device dispatch costs a fixed round trip, so
        small novel-word batches (every warm-cache CLI chunk, and most
        cold ones after dedup) merge on the host.
        YTTM_ENCODE_MERGE=host|device forces an arm;
        YTTM_HOST_MERGE_TOKENS moves the auto threshold."""
        mode = os.environ.get("YTTM_ENCODE_MERGE", "auto")
        if mode in ("host", "device"):
            return mode
        thr = int(os.environ.get("YTTM_HOST_MERGE_TOKENS", str(1 << 22)))
        return "host" if n_tokens <= thr else "device"

    def _word_cache(self) -> fasttok.WordCache:
        if self._wcache is None:
            self._wcache = fasttok.WordCache(
                max_words=int(os.environ.get("YTTM_WORD_CACHE", str(1 << 22)))
            )
        return self._wcache

    # -- char -> id mapping with unknown-run collapse ----------------------

    def _idify_rows(self, rows: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """[k, L] codepoints -> ([k, L+1] ids with space prefix, lengths).

        Unknown-char runs collapse to placeholder ids >= PLACEHOLDER_START,
        numbered per word in order of appearance (bpe.cpp:1503-1527).
        """
        k, length = rows.shape
        pos = np.searchsorted(self._sorted_cps, rows)
        pos_c = np.minimum(pos, self._sorted_cps.size - 1)
        known = (self._sorted_cps[pos_c] == rows) if self._sorted_cps.size else np.zeros(
            rows.shape, bool
        )
        ids = np.where(known, self._sorted_ids[pos_c], -1).astype(np.int64)
        unk = ~known
        run_start = unk & ~np.concatenate([np.zeros((k, 1), bool), unk[:, :-1]], axis=1)
        ph = np.cumsum(run_start, axis=1) - 1
        vals = np.where(known, ids, PLACEHOLDER_START + ph)
        keepm = known | run_start
        newlen = keepm.sum(axis=1).astype(np.int64)
        dest = np.cumsum(keepm, axis=1) - 1
        out = np.full((k, length + 1), -1, dtype=np.int64)
        out[:, 0] = self.space_id
        rr = np.nonzero(keepm)
        out[rr[0], dest[rr] + 1] = vals[rr]
        return out.astype(np.int32), newlen + 1

    # -- unique-word encoding (matrix path) --------------------------------

    def _encode_unique(
        self, dd: preprocess.DedupWords, dropout_prob: float = 0.0, seed: int = 0
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Encode all unique words (with dropout, every occurrence: the
        rows of ``_no_dedup``); returns ragged results as (flat_ids,
        offsets) with offsets of length n_unique+1."""
        use_cache = dropout_prob == 0.0
        pieces = []  # (uids, lengths, flat ids)
        done_u: List[int] = []  # words answered by the cache or the host
        done_v: List[np.ndarray] = []

        # bucket -> list of (uids, raw rows, id-matrix)
        buckets: Dict[int, List[Tuple[np.ndarray, np.ndarray, np.ndarray]]] = {}
        base = 0
        for rows in dd.group_rows:
            k = rows.shape[0]
            uids = np.arange(base, base + k)
            base += k
            todo = np.ones(k, dtype=bool)
            if use_cache and self._cache:
                for i in range(k):
                    hit = self._cache.get(rows[i].tobytes())
                    if hit is not None:
                        done_u.append(uids[i])
                        done_v.append(hit)
                        todo[i] = False
            if not todo.any():
                continue
            rows_t = rows[todo]
            uids_t = uids[todo]
            mat, _ = self._idify_rows(rows_t)
            padded_len = mat.shape[1]
            if padded_len > MAX_DEVICE_LEN:
                # host greedy merge for monster words (rare); dropout does
                # not reach them, as in the JAX package
                for i in range(mat.shape[0]):
                    w = mat[i][mat[i] >= 0]
                    res = np.asarray(self._host_merge(w.tolist()), dtype=np.int64)
                    done_u.append(uids_t[i])
                    done_v.append(res)
                    if use_cache:
                        self._maybe_cache(rows_t[i], res)
                continue
            cap = next(c for c in ENCODE_BUCKETS if c >= padded_len)
            buckets.setdefault(cap, []).append((uids_t, rows_t, mat))

        # start every chunk of every bucket before collecting any; with
        # dropout each padded row draws the coins of its own global row
        pending = []
        row0 = 0
        for cap, entries in buckets.items():
            mat = _pad_rows([e[2] for e in entries], cap)
            futs = []
            for c0 in range(0, mat.shape[0], DEVICE_BATCH):
                chunk = mat[c0 : c0 + DEVICE_BATCH]
                drop = (dropout_prob, seed, row0) if dropout_prob else None
                futs.append(self._dispatch_merge(chunk, u16=False, dropout=drop))
                row0 += chunk.shape[0]
            pending.append((entries, futs))

        for entries, futs in pending:
            uids_all = np.concatenate([e[0] for e in entries])
            k = uids_all.size
            out = np.concatenate([f.numpy() for f in futs], axis=0)[:k]
            # vectorized ragged extraction: one boolean mask for the whole
            # bucket
            mask = out >= 0
            lens_b = mask.sum(axis=1)
            flat_b = out[mask].astype(np.int64)
            pieces.append((uids_all, lens_b, flat_b))
            if use_cache:
                offs_b = np.zeros(k + 1, dtype=np.int64)
                np.cumsum(lens_b, out=offs_b[1:])
                flat_raws = [row for e in entries for row in e[1]]
                cache = self._cache
                if len(cache) >= self._cache_size:
                    cache.clear()
                for i in range(k):
                    cache[flat_raws[i].tobytes()] = flat_b[offs_b[i] : offs_b[i + 1]]
        if done_u:
            pieces.append((
                np.asarray(done_u, np.int64),
                np.fromiter((v.size for v in done_v), np.int64, len(done_v)),
                np.concatenate(done_v).astype(np.int64),
            ))

        flat, offsets = _assemble(pieces, dd.n_unique)
        if self._zero_is_real:
            flat, offsets = self._strip_zero_heads(flat, offsets)
        return flat, offsets

    @staticmethod
    def _strip_zero_heads(flat: np.ndarray, offsets: np.ndarray):
        """Drop each word's leading token when its id is 0 (the
        reference's find_if emission skip, bpe.cpp:1591-1593).  Two
        distinct real tokens can't both have id 0, so at most one
        leading token goes per word."""
        lens = np.diff(offsets)
        heads = offsets[:-1]
        ne = lens > 0
        dropw = np.zeros(lens.shape, bool)
        dropw[ne] = flat[heads[ne]] == 0
        if not dropw.any():
            return flat, offsets
        keep = np.ones(flat.size, bool)
        keep[heads[dropw]] = False
        new_off = np.zeros_like(offsets)
        np.cumsum(lens - dropw, out=new_off[1:])
        return flat[keep], new_off

    def _maybe_cache(self, raw_row: np.ndarray, ids: np.ndarray) -> None:
        if len(self._cache) >= self._cache_size:
            self._cache.clear()  # simple epoch eviction
        self._cache[raw_row.tobytes()] = ids

    def _host_merge(self, word: List[int]) -> List[int]:
        """Oracle-style greedy merge for words too long for the device."""
        rule2id = self.vocab.rule2id
        rules = self.state.rules
        cur = word
        while True:
            best = None
            for i in range(len(cur) - 1):
                r = rule2id.get((cur[i], cur[i + 1]))
                if r is not None and (best is None or r < best):
                    best = r
            if best is None:
                return cur
            x, y, z = rules[best]
            out, i, n = [], 0, len(cur)
            while i < n:
                if i + 1 < n and cur[i] == x and cur[i + 1] == y:
                    out.append(z)
                    i += 2
                else:
                    out.append(cur[i])
                    i += 1
            cur = out

    # -- public API --------------------------------------------------------

    def encode(
        self,
        sentences: Sequence[str],
        output_type: str = "id",
        bos: bool = False,
        eos: bool = False,
        reverse: bool = False,
        dropout_prob: float = 0.0,
        generator: Optional[torch.Generator] = None,
    ):
        """Encode sentences to ids or subwords.  With ``dropout_prob`` > 0
        each call draws one 64-bit seed from ``generator`` (a
        ``torch.Generator``; the JAX package takes a ``key``), or from
        ``os.urandom`` without one."""
        st = self.state.special_tokens
        if bos and st.bos_id == -1:
            raise ValueError("Can't add <BOS> token. Model was trained without it.")
        if eos and st.eos_id == -1:
            raise ValueError("Can't add <EOS> token. Model was trained without it.")
        if dropout_prob < 0 or dropout_prob > 1:
            raise ValueError(
                "dropout_prob value must be in the range [0, 1]. Current value of "
                f"dropout_prob = {dropout_prob}"
            )

        n_sent = len(sentences)
        if n_sent == 0:
            return []
        backend = _encode_backend()
        seed = dropout_seed(generator) if dropout_prob > 0.0 else 0

        if (
            output_type == "id"
            and dropout_prob > 0.0
            and backend == "native"
            and fasttok.available()
            and not self._zero_is_real
            and os.environ.get("YTTM_DROPOUT_NATIVE", "1") != "0"
        ):
            # dropout disables dedup and caching (every occurrence samples
            # on its own, bpe.cpp:1415-1453): the matrix path pays a padded
            # device row per OCCURRENCE, so id-mode dropout runs through the
            # C++ tokenizer + per-occurrence host merge
            joined = "\n".join(sentences) + "\n"
            if joined.count("\n") == n_sent:
                return self._encode_ids_dropout_native(
                    joined.encode("utf-8"), n_sent, bos, eos, reverse, dropout_prob, seed
                )

        if output_type == "id" and dropout_prob == 0.0:
            # the fast paths work on a newline-joined byte stream; no
            # sentence may embed a newline (it would break the marking)
            joined = "\n".join(sentences) + "\n"
            if joined.count("\n") == n_sent:
                if backend == "native" and fasttok.available():
                    return self._encode_ids_native(
                        joined.encode("utf-8"), n_sent, bos, eos, reverse
                    )
                if backend in ("native", "stream") and not self._zero_is_real:
                    # the flat stream pipeline has no per-word emission
                    # step to apply the id-0 head quirk; such models take
                    # the matrix path below
                    return self._encode_ids_stream(joined, n_sent, bos, eos, reverse)

        arrs = [
            np.frombuffer(s.encode("utf-32-le"), dtype=np.uint32) for s in sentences
        ]
        sep = np.asarray([32], dtype=np.uint32)
        parts: List[np.ndarray] = []
        sent_starts = np.zeros(n_sent, dtype=np.int64)
        off = 0
        for i, a in enumerate(arrs):
            sent_starts[i] = off
            parts.append(a)
            parts.append(sep)
            off += a.size + 1
        stream = np.concatenate(parts) if parts else np.zeros(0, np.uint32)

        starts, lengths = preprocess.word_spans(stream)
        sid = np.searchsorted(sent_starts, starts, side="right") - 1
        if dropout_prob > 0.0:
            dd = self._no_dedup(stream, starts, lengths)  # every occurrence samples
        else:
            dd = preprocess.dedup_words(stream, starts, lengths)
        flat, offsets = self._encode_unique(dd, dropout_prob, seed)

        occ = dd.occurrence_uid
        occ_lens = offsets[occ + 1] - offsets[occ]
        occ_starts_flat = offsets[occ]
        total = int(occ_lens.sum())
        if total:
            occ_off = np.cumsum(occ_lens) - occ_lens
            pos_in_occ = np.arange(total, dtype=np.int64) - np.repeat(occ_off, occ_lens)
            out_ids = flat[np.repeat(occ_starts_flat, occ_lens) + pos_in_occ]
            out_sid = np.repeat(sid, occ_lens)
        else:
            out_ids = np.zeros(0, dtype=np.int64)
            out_sid = np.zeros(0, dtype=np.int64)

        # split at sentence boundaries
        bounds = np.searchsorted(out_sid, np.arange(n_sent + 1))

        if output_type == "id":
            unk = st.unk_id
            out_ids = np.where(out_ids >= PLACEHOLDER_START, unk, out_ids)
            big = out_ids.tolist()  # one C-level conversion
            b = bounds.tolist()
            result = []
            if not bos and not eos and not reverse:
                for i in range(n_sent):
                    result.append(big[b[i] : b[i + 1]])
            else:
                pre = [st.bos_id] if bos else []
                post = [st.eos_id] if eos else []
                for i in range(n_sent):
                    ids = pre + big[b[i] : b[i + 1]] + post
                    if reverse:
                        ids.reverse()
                    result.append(ids)
            return result
        elif output_type == "subword":
            piece = self.vocab.piece
            # raw text for placeholders, resolved per unique word
            ph_text = self._placeholder_texts(dd)
            result = []
            occ_bounds = np.searchsorted(sid, np.arange(n_sent + 1))
            for i in range(n_sent):
                pieces: List[str] = []
                if bos:
                    pieces.append(BOS_TOKEN)
                for j in range(occ_bounds[i], occ_bounds[i + 1]):
                    u = occ[j]
                    ids = flat[offsets[u] : offsets[u + 1]]
                    for t in ids:
                        t = int(t)
                        if t >= PLACEHOLDER_START:
                            pieces.append(ph_text[(u, t - PLACEHOLDER_START)])
                        else:
                            pieces.append(piece[t])
                if eos:
                    pieces.append(EOS_TOKEN)
                if reverse:
                    pieces.reverse()
                result.append(pieces)
            return result
        else:
            raise ValueError('output_type must be equal to "id" or "subword"')

    # -- native (C++ host tokenizer + device merge) fast path --------------

    @staticmethod
    def _bucket_rows(words_flat: np.ndarray, word_off: np.ndarray):
        """Pack the ragged words of length <= 512 into padded int32
        [rows, cap] length buckets: [(uids, mat), ...], one per occupied
        cap.  These are the kernel's inputs on the native path."""
        lengths = np.diff(word_off).astype(np.int64)
        out = []
        prev_cap = 1
        for cap in ENCODE_BUCKETS:
            sel = np.nonzero((lengths > prev_cap) & (lengths <= cap))[0]
            prev_cap = cap
            if sel.size == 0:
                continue
            idx2d = word_off[sel][:, None].astype(np.int64) + np.arange(cap)[None, :]
            in_row = np.arange(cap)[None, :] < lengths[sel][:, None]
            mat = np.where(
                in_row, words_flat[np.minimum(idx2d, words_flat.size - 1)], -1
            ).astype(np.int32)
            # snap the row count to a small tier first: steady-state CLI
            # chunks have few novel words, and a full 8192-row padded
            # batch for a handful of rows would dominate the chunk's cost
            k = mat.shape[0]
            kp = next(
                (r for r in (512, 2048) if k <= r),
                -(-k // DEVICE_BATCH) * DEVICE_BATCH,
            )
            if kp != k:
                mat = np.concatenate(
                    [mat, np.full((kp - k, cap), -1, np.int32)]
                )
            out.append((sel, mat))
        return out

    def _merge_dispatch(self, words_flat: np.ndarray, word_off: np.ndarray):
        """Stage 1 of unique-word merging: pack length buckets and start
        every device chunk.  Returns opaque state for ``_merge_collect``;
        between the two calls the card works while the host is free (the
        CLI stream loop tokenizes the next chunk there)."""
        n_uniq = word_off.size - 1
        if (
            n_uniq
            and fasttok.available()
            and self._merge_policy(int(words_flat.size)) == "host"
        ):
            rf, ro = self._ruletab().merge_words(words_flat, word_off)
            return ("host", rf, ro)
        u16 = self._use_u16()
        pending = [
            (
                sel,
                [
                    self._dispatch_merge(mat[c0 : c0 + DEVICE_BATCH], u16)
                    for c0 in range(0, mat.shape[0], DEVICE_BATCH)
                ],
            )
            for sel, mat in self._bucket_rows(words_flat, word_off)
        ]
        lengths = np.diff(word_off).astype(np.int64)
        res_lens = np.zeros(n_uniq, np.int64)
        # monster words (beyond the largest bucket) merge on the host —
        # rare, and it overlaps the in-flight device work
        monsters = np.nonzero(lengths > ENCODE_BUCKETS[-1])[0]
        monster_res = {}
        for u in monsters:
            w = words_flat[word_off[u] : word_off[u + 1]].tolist()
            r = self._host_merge(w)
            monster_res[int(u)] = np.asarray(r, np.int32)
            res_lens[u] = len(r)
        return pending, monster_res, res_lens, n_uniq

    def _merge_collect(self, st):
        """Stage 2: wait for the device results and assemble the ragged
        (results_flat, res_off) in uid order."""
        if st[0] == "host":
            _, rf, ro = st
            if self._zero_is_real:
                rf, ro = self._strip_zero_heads(rf, ro)
            return rf, ro.astype(np.int32)
        pending, monster_res, res_lens, n_uniq = st
        parts = []
        for sel, futs in pending:
            out = np.concatenate([f.numpy() for f in futs], axis=0)[: sel.size]
            if out.dtype == np.uint16:
                mask = out != U16_PAD
                out = out.astype(np.int32)
            else:
                mask = out >= 0
            res_lens[sel] = mask.sum(axis=1)
            parts.append((sel, out, mask))

        res_off = np.zeros(n_uniq + 1, np.int64)
        np.cumsum(res_lens, out=res_off[1:])
        results_flat = np.empty(int(res_off[-1]), np.int32)
        for sel, out, mask in parts:
            row_lens = mask.sum(axis=1).astype(np.int64)
            total = int(row_lens.sum())
            if not total:
                continue
            row_off = np.cumsum(row_lens) - row_lens
            pos = np.arange(total, dtype=np.int64) - np.repeat(row_off, row_lens)
            dst = np.repeat(res_off[sel], row_lens) + pos
            results_flat[dst] = out[mask]
        for u, r in monster_res.items():
            results_flat[res_off[u] : res_off[u + 1]] = r
        if self._zero_is_real:
            results_flat, res_off = self._strip_zero_heads(
                results_flat, res_off
            )
        return results_flat, res_off.astype(np.int32)

    def _tokenize_cached(self, data: bytes):
        """Tokenize against the persistent word cache: merge only words
        never seen before, register their results, return the occurrence
        stream (global uids)."""
        wc = self._word_cache()
        words_flat, word_off, occ, base = wc.tokenize(
            data, self._sorted_cps, self._sorted_ids, self.space_id
        )
        if word_off.size > 1:
            rf, ro = self._merge_collect(self._merge_dispatch(words_flat, word_off))
            unk = self.state.special_tokens.unk_id
            rf = np.where(rf >= PLACEHOLDER_START, unk, rf)
            wc.add_results(rf, ro, base)
        return wc, occ

    def encode_stream_cli(self, chunks):
        """Pipelined CLI path over an iterable of newline-terminated byte
        chunks: the host tokenize of chunk k+1 runs while the card merges
        chunk k's novel words (the dispatch/collect split).  Yields one
        formatted output bytes per input chunk, in order."""
        unk = self.state.special_tokens.unk_id
        wc = self._word_cache()
        pending = None  # (dispatch_state, occ, base) of the previous chunk

        def finish(p):
            st, occ, base = p
            if st is not None:
                rf, ro = self._merge_collect(st)
                rf = np.where(rf >= PLACEHOLDER_START, unk, rf)
                wc.add_results(rf, ro, base)
            return wc.format(occ)

        for chunk in chunks:
            # an eviction would invalidate the pending chunk's uids:
            # flush it first, then let tokenize's own check fire
            if pending is not None and wc.n_words > wc.max_words:
                yield finish(pending)
                pending = None
            words_flat, word_off, occ, base = wc.tokenize(
                chunk, self._sorted_cps, self._sorted_ids, self.space_id
            )
            # queue chunk k+1's device work before blocking on chunk k's
            # results: the device stream never drains
            st = (
                self._merge_dispatch(words_flat, word_off)
                if word_off.size > 1
                else None
            )
            out = finish(pending) if pending is not None else None
            pending = (st, occ, base)
            if out is not None:
                yield out
        if pending is not None:
            yield finish(pending)

    def _encode_ids_native(
        self, data: bytes, n_sent: int, bos: bool, eos: bool, reverse: bool
    ) -> List[List[int]]:
        wc, occ = self._tokenize_cached(data)
        flat = wc.expand_ids(occ)
        return self._split_sentences(flat, np.nonzero(flat == -1)[0], n_sent, bos, eos, reverse)

    def _encode_ids_dropout_native(
        self, data: bytes, n_sent: int, bos: bool, eos: bool, reverse: bool,
        p: float, seed: int,
    ) -> List[List[int]]:
        """ID-mode BPE-dropout via the C++ tokenizer + per-occurrence host
        merge (DropoutQueue semantics, bpe.cpp:1415-1453, with an explicit
        64-bit seed in place of the reference's shared unseeded mt19937)."""
        words_flat, word_off, occ, _ = fasttok.tokenize(
            data, self._sorted_cps, self._sorted_ids, self.space_id
        )
        flat = self._ruletab().merge_occurrences_dropout(words_flat, word_off, occ, p, seed)
        st = self.state.special_tokens
        sent_mark = flat == -1
        flat = np.where((flat >= PLACEHOLDER_START) & ~sent_mark, st.unk_id, flat)
        return self._split_sentences(flat, np.nonzero(sent_mark)[0], n_sent, bos, eos, reverse)

    def _split_sentences(self, flat, marks, n_sent, bos, eos, reverse) -> List[List[int]]:
        """Per-sentence id lists from a flat stream with one mark after
        each sentence."""
        st = self.state.special_tokens
        assert marks.size == n_sent, (marks.size, n_sent)
        big = flat.tolist()
        bounds = [0] + (marks + 1).tolist()
        pre = [st.bos_id] if bos else []
        post = [st.eos_id] if eos else []
        result = []
        for i in range(n_sent):
            ids = big[bounds[i] : bounds[i + 1] - 1]  # drop the mark
            if bos or eos:
                ids = pre + ids + post
            if reverse:
                ids.reverse()
            result.append(ids)
        return result

    # -- flat stream backend -------------------------------------------------

    def _stream_u16(self) -> bool:
        st = self.state.special_tokens
        return self.state.vocab_size() < 0xFFFE and st.unk_id >= 0

    def encode_bytes_flat(self, data: bytes):
        """Newline-separated text bytes -> (flat id array, sentinel).

        The CLI's path without the C++ tokenizer: ids come back as a flat
        array with a sentinel entry per '\n'; placeholders are already
        mapped to unk_id.  The array is uint16 (sentinel 0xFFFF) when the
        vocab fits, else int32 (sentinel NEWLINE)."""
        st = self.state.special_tokens
        if self._stream_u16():
            flat = self._stream.encode_bytes(data, pack_u16=True, unk_id=st.unk_id)
            return flat, U16_NEWLINE
        flat = self._stream.encode_bytes(data)
        flat = np.where(flat >= PLACEHOLDER_START, st.unk_id, flat)
        return flat, NEWLINE

    def _encode_ids_stream(
        self, joined: str, n_sent: int, bos: bool, eos: bool, reverse: bool
    ) -> List[List[int]]:
        """ID mode through the flat stream pipeline."""
        flat, sentinel = self.encode_bytes_flat(joined.encode("utf-8"))
        marks = np.nonzero(flat == sentinel)[0]
        return self._split_sentences(flat.astype(np.int32), marks, n_sent, bos, eos, reverse)

    def _no_dedup(self, stream, starts, lengths) -> preprocess.DedupWords:
        """Occurrence-preserving variant of dedup (for dropout): every
        occurrence is its own row."""
        n = starts.size
        group_lens: List[int] = []
        group_rows: List[np.ndarray] = []
        group_counts: List[np.ndarray] = []
        occurrence_uid = np.zeros(n, dtype=np.int64)
        base = 0
        for length in np.unique(lengths).tolist():
            sel = np.nonzero(lengths == length)[0]
            rows = stream[starts[sel][:, None] + np.arange(length)[None, :]]
            occurrence_uid[sel] = base + np.arange(sel.size)
            group_lens.append(int(length))
            group_rows.append(np.ascontiguousarray(rows))
            group_counts.append(np.ones(sel.size, dtype=np.int64))
            base += sel.size
        return preprocess.DedupWords(
            group_lens=group_lens,
            group_rows=group_rows,
            group_counts=group_counts,
            occurrence_uid=occurrence_uid,
            n_unique=base,
            uid_group=np.zeros(base, np.int32),
            uid_row=np.zeros(base, np.int64),
        )

    def _placeholder_texts(self, dd: preprocess.DedupWords) -> Dict[Tuple[int, int], str]:
        """Raw text of each unknown-char run, per unique word."""
        out: Dict[Tuple[int, int], str] = {}
        known_set = self._sorted_cps
        base = 0
        for rows in dd.group_rows:
            k, length = rows.shape
            pos = np.searchsorted(known_set, rows)
            pos_c = np.minimum(pos, max(known_set.size - 1, 0))
            known = (known_set[pos_c] == rows) if known_set.size else np.zeros(
                rows.shape, bool
            )
            has_unknown = ~known.all(axis=1)
            for i in np.nonzero(has_unknown)[0]:
                row = rows[i]
                kn = known[i]
                ph = 0
                j = 0
                while j < length:
                    if not kn[j]:
                        j0 = j
                        while j < length and not kn[j]:
                            j += 1
                        out[(base + i, ph)] = "".join(chr(int(c)) for c in row[j0:j])
                        ph += 1
                    else:
                        j += 1
            base += k
        return out
