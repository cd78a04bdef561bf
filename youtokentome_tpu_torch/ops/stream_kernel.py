"""Flat-stream encode pipeline: raw UTF-8 bytes in, token ids out.

PyTorch counterpart of ``youtokentome_tpu/ops/stream_kernel.py``.  A
chunk of bytes becomes a compact stream of tokens ``t[i]`` with a
parallel word-id array ``wid[i]``:

  * every word is emitted as [space_id, char ids...] (the U+2581 prefix,
    bpe.cpp:1514),
  * maximal runs of unknown chars collapse to one placeholder token
    >= 10**9, numbered per word (bpe.cpp:1503-1527),
  * every '\\n' becomes its own single-token pseudo-word carrying the
    sentinel NEWLINE (-2), so the host can split sentences afterwards,
  * slots past the stream's length hold t = wid = PAD (-1).

Words are then deduplicated (each unique word is merged once, numbered
by its first occurrence), merged to their greedy fixed point (the JAX
package's ``_merge_fixed_point``: per word, the leftmost non-overlapping
occurrences of its least-rank pair, parity restarting at each word and
each run of hits) and expanded back to occurrence order, optionally
packed to a uint16 wire format.

Three wrappers carry the pipeline, each a hand-written CUDA kernel
(``csrc/stream_encode.cu``, several launches each) on CUDA tensors and
its plain torch version on CPU tensors:

  ``stream_build``  bytes -> (t, wid, n_tokens)            (``build_stream``)
  ``stream_dedup``  (t, wid, n_tokens) -> ``StreamWords``  (``dedup_words``)
  ``stream_merge``  ``StreamWords`` -> (ids, n_ids)        (``merge_fixed_point``,
                    ``expand_occurrences``, ``pack_u16``)

Buffers are sized from the chunk: M = floor(1.5 N) + 4 tokens for N bytes
("a\\na\\n" is the worst case), so nothing is padded to a fixed chunk.
The counts (n_tokens, n_words, ...) stay on the device until the host
downloads the result.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..models.state import INVALID_UNICODE, SPACE_TOKEN
from . import _cuda
from .encode_kernel import PLACEHOLDER_START, EncoderTables
from .hashmap import MISS, _mulmod32
from .train_stream import _last_index

NEWLINE = -2  # sentence-boundary sentinel token in the output stream
PAD = -1
# the stream's own uint16 wire format (not the greedy merge's): valid
# when vocab < 0xFFFE; placeholders leave as unk_id
U16_NEWLINE = 0xFFFF
U16_STREAM_PAD = 0xFFFE
DEFAULT_CHUNK = 1024 * 1024

_M32 = 0xFFFFFFFF


def stream_capacity(n_bytes: int) -> int:
    """Token slots for a chunk of ``n_bytes``: 1.5 tokens a byte at most."""
    return (3 * n_bytes) // 2 + 4


def _shift_left(x: torch.Tensor, k: int, fill) -> torch.Tensor:
    return torch.cat([x[k:], x.new_full((min(k, x.numel()),), fill)])


def _compact_to(vals: torch.Tensor, keep: torch.Tensor, size: int, fill=PAD) -> torch.Tensor:
    out = torch.full((size,), fill, dtype=vals.dtype, device=vals.device)
    kept = vals[keep]
    out[: kept.numel()] = kept
    return out


def _scalar(v, device) -> torch.Tensor:
    return torch.tensor(int(v), dtype=torch.int32, device=device)


# -- stage 1: UTF-8 decode -----------------------------------------------------


def utf8_decode(b: torch.Tensor):
    """uint8 [N] -> (codepoints int64 [N] at char starts, is_start bool [N]):
    the JAX ``_utf8_decode_device`` closed form.  Invalid bytes yield
    INVALID_UNICODE starts; continuation bytes covered by a valid
    multi-byte char are not starts."""
    n = b.numel()
    b32 = b.to(torch.int64)
    is_cont = (b32 & 0xC0) == 0x80
    b1, b2, b3 = (_shift_left(b32, k, 0) for k in (1, 2, 3))
    c1, c2, c3 = (_shift_left(is_cont, k, False) for k in (1, 2, 3))
    ascii_ = b32 < 0x80
    lead2 = (b32 & 0xE0) == 0xC0
    lead3 = (b32 & 0xF0) == 0xE0
    lead4 = (b32 & 0xF8) == 0xF0
    cp2 = ((b32 & 0x1F) << 6) | (b1 & 0x3F)
    cp3 = ((b32 & 0x0F) << 12) | ((b1 & 0x3F) << 6) | (b2 & 0x3F)
    cp4 = ((b32 & 0x07) << 18) | ((b1 & 0x3F) << 12) | ((b2 & 0x3F) << 6) | (b3 & 0x3F)

    def ok_cp(cp):
        return (cp < 0xD800) | ((0xDFFF < cp) & (cp < 0x110000))

    ok2 = lead2 & c1 & (cp2 >= 0x80) & ok_cp(cp2)
    ok3 = lead3 & c1 & c2 & (cp3 >= 0x800) & ok_cp(cp3)
    ok4 = lead4 & c1 & c2 & c3 & (cp4 >= 0x10000) & ok_cp(cp4)
    length = torch.where(ok2, 2, torch.where(ok3, 3, torch.where(ok4, 4, 1)))
    valid_multi = ok2 | ok3 | ok4
    # the most recent valid multi-byte start decides coverage (valid
    # chars never overlap)
    idx = torch.arange(n, device=b.device)
    last_multi = _last_index(valid_multi)
    lm = last_multi.clamp(min=0)
    covered = (last_multi >= 0) & (idx > last_multi) & (idx < last_multi + length[lm])
    cp = torch.full((n,), INVALID_UNICODE, dtype=torch.int64, device=b.device)
    cp = torch.where(ascii_, b32, cp)
    cp = torch.where(ok2, cp2, cp)
    cp = torch.where(ok3, cp3, cp)
    cp = torch.where(ok4, cp4, cp)
    return cp, ~covered


# -- stage 2: the token stream -------------------------------------------------


def _is_space_cp(cp: torch.Tensor) -> torch.Tensor:
    return (cp == 32) | ((cp >= 9) & (cp <= 13)) | (cp == SPACE_TOKEN)


def build_stream(bytes_u8: torch.Tensor, alpha_cps: torch.Tensor, alpha_ids: torch.Tensor,
                 space_id: int):
    """bytes [N] -> (t [M] int32, wid [M] int32, n_tokens 0-dim int32), the
    JAX ``_build_stream`` on the chunk's own bytes (M = stream_capacity(N)).
    ``alpha_cps`` is the sorted alphabet, ``alpha_ids`` its ids."""
    dev = bytes_u8.device
    m = stream_capacity(bytes_u8.numel())
    cp, is_start = utf8_decode(bytes_u8)
    c = cp[is_start & (cp != INVALID_UNICODE)]  # the decoded chars
    is_nl = c == 10
    is_sp = _is_space_cp(c) & ~is_nl
    regular = ~is_nl & ~is_sp
    no = torch.zeros(1, dtype=torch.bool, device=dev)
    word_start = regular & ~torch.cat([no, regular[:-1]])
    seg_start = word_start | is_nl  # a segment is a word or a newline
    cps = alpha_cps.to(torch.int64)
    a_pos = torch.searchsorted(cps, c).clamp(max=max(cps.numel() - 1, 0))
    known = (cps[a_pos] == c) & regular
    char_id = torch.where(known, alpha_ids[a_pos].to(torch.int64), -1)
    unknown = regular & ~known
    run_start = unknown & (~torch.cat([no, unknown[:-1]]) | word_start)
    # placeholder ordinal: run starts counted within the segment
    rs = torch.cumsum(run_start.to(torch.int64), 0)
    seg_at = _last_index(seg_start).clamp(min=0)
    ordinal = rs - (rs[seg_at] - run_start[seg_at].to(torch.int64)) - 1
    tok = torch.where(known, char_id, PLACEHOLDER_START + ordinal.clamp(min=0))
    emit_char = known | run_start
    wid_c = torch.cumsum(seg_start.to(torch.int64), 0) - 1
    # word starts emit [space_id, tok]; other kept chars [tok]; newlines
    # [NEWLINE]
    first = torch.where(word_start, space_id, torch.where(is_nl, NEWLINE, tok))
    vals = torch.stack([first, tok], dim=1).reshape(-1)
    wids = torch.stack([wid_c, wid_c], dim=1).reshape(-1)
    keeps = torch.stack([word_start | emit_char | is_nl, word_start], dim=1).reshape(-1)
    t = _compact_to(vals.to(torch.int32), keeps, m)
    wid = _compact_to(wids.to(torch.int32), keeps, m)
    return t, wid, _scalar(keeps.sum(), dev)


# -- stage 2.5: word dedup -----------------------------------------------------


def _mix32(x: torch.Tensor, c1: int, c2: int) -> torch.Tensor:
    """The JAX ``_mix32`` in int64 arithmetic on values in [0, 2**32)."""
    h = _mulmod32(x, c1)
    h = h ^ (h >> 15)
    h = _mulmod32(h, c2)
    return h ^ (h >> 13)


@dataclasses.dataclass
class StreamWords:
    """The deduplicated stream of a chunk.  Unique words are numbered by
    first occurrence; buffers have the chunk's M slots, valid up to their
    count (``ut``/``uwid`` hold PAD past ``n_tokens``)."""

    ut: torch.Tensor  # tokens of the unique words, in order
    uwid: torch.Tensor  # unique id of each token
    n_tokens: torch.Tensor  # 0-dim int32
    occ_uid: torch.Tensor  # unique id of each word of the chunk (n_words)
    n_words: torch.Tensor
    ustart: torch.Tensor  # start of each unique word in ut (n_unique)
    ulen: torch.Tensor  # its length
    n_unique: torch.Tensor


def dedup_words(t: torch.Tensor, wid: torch.Tensor, n_tokens) -> StreamWords:
    """The JAX ``_dedup_words``: identity is (length, h1, h2), two 32-bit
    sums of ``_mix32`` over (token, position in word) with the JAX
    constants; the representative of each word is its first occurrence,
    and unique ids follow the representatives' stream order."""
    dev = t.device
    m = t.numel()
    n = int(n_tokens)
    tt = t[:n].to(torch.int64)
    ww = wid[:n].to(torch.int64)
    n_words = int(ww[-1]) + 1 if n else 0
    starts = torch.nonzero(torch.cat([torch.ones(min(n, 1), dtype=torch.bool, device=dev),
                                      ww[1:] != ww[:-1]])).flatten()
    wlen = torch.diff(torch.cat([starts, torch.tensor([n], device=dev)]))
    pos = torch.arange(n, device=dev) - starts[ww]
    tu = tt & _M32
    hv1 = _mix32(tu ^ ((pos << 16) & _M32), 0x9E3779B1, 0x85EBCA77)
    hv2 = _mix32((tu + ((pos * 0x27D4EB2F) & _M32)) & _M32, 0xC2B2AE3D, 0x165667B1)
    zero = torch.zeros(n_words, dtype=torch.int64, device=dev)
    h1 = zero.index_add(0, ww, hv1) & _M32
    h2 = zero.index_add(0, ww, hv2) & _M32
    w_idx = torch.arange(n_words, device=dev)
    if n_words:
        _, grp = torch.unique(torch.stack([wlen, h1, h2], dim=1), dim=0, return_inverse=True)
        first = torch.full((int(grp.max()) + 1,), n_words, dtype=torch.int64, device=dev)
        first = first.scatter_reduce(0, grp, w_idx, "amin")
        rep = first[grp]
    else:
        rep = w_idx
    is_rep = rep == w_idx
    uid = torch.cumsum(is_rep.to(torch.int64), 0) - 1
    keep = is_rep[ww]
    ulen = wlen[is_rep]

    def buf(v, fill=0):
        out = torch.full((m,), fill, dtype=torch.int32, device=dev)
        out[: v.numel()] = v.to(torch.int32)
        return out

    return StreamWords(
        ut=buf(tt[keep], PAD), uwid=buf(uid[ww][keep], PAD), n_tokens=_scalar(keep.sum(), dev),
        occ_uid=buf(uid[rep]), n_words=_scalar(n_words, dev),
        ustart=buf(torch.cumsum(ulen, 0) - ulen), ulen=buf(ulen),
        n_unique=_scalar(ulen.numel(), dev),
    )


# -- stage 3: merge fixed point, expansion, packing ----------------------------


def merge_fixed_point(tables: EncoderTables, t: torch.Tensor, wid: torch.Tensor, n_tokens):
    """The JAX ``_merge_fixed_point`` on a compact (t, wid) stream: every
    round, each word merges the leftmost non-overlapping occurrences of
    its least-rank pair, and the stream is compacted.  Returns (t, wid,
    n_tokens)."""
    if tables.n_rules == 0:
        return t, wid, n_tokens
    m = t.numel()
    miss = int(MISS)
    idx = torch.arange(m, device=t.device)
    while True:
        nxt_t = _shift_left(t, 1, PAD)
        nxt_w = _shift_left(wid, 1, PAD)
        valid = (wid >= 0) & (wid == nxt_w) & (t >= 0) & (nxt_t >= 0)
        ranks = torch.where(valid, tables.table.lookup(t, nxt_t), miss)
        seg = torch.where(wid >= 0, wid.to(torch.int64), m)
        mins = torch.full((m + 1,), miss, dtype=torch.int32, device=t.device)
        mseg = mins.scatter_reduce(0, seg, ranks, "amin")[seg]
        hit = (ranks == mseg) & (mseg < miss)
        # leftmost non-overlapping within runs of consecutive hits
        offset = idx - _last_index(~hit) - 1
        sel = hit & (offset % 2 == 0)
        if not bool(sel.any()):
            return t, wid, n_tokens
        z = tables.rules_z[mseg.clamp(0, tables.n_rules - 1).long()]
        new_t = torch.where(sel, z, t)
        keep = ~torch.cat([torch.zeros(1, dtype=torch.bool, device=t.device), sel[:-1]])
        keep &= new_t != PAD
        t, wid = _compact_to(new_t, keep, m), _compact_to(wid, keep, m)
        n_tokens = _scalar(keep.sum(), t.device)


def expand_occurrences(ut: torch.Tensor, uwid: torch.Tensor, occ_uid: torch.Tensor, n_words,
                       out_cap: int):
    """The JAX ``_expand_occurrences``: the merged unique stream gathered
    back into occurrence order.  Returns (out [out_cap] int32, total)."""
    dev = ut.device
    nw = int(n_words)
    is_word = uwid >= 0
    ulen = torch.bincount(uwid[is_word].to(torch.int64))
    ustart = torch.cumsum(ulen, 0) - ulen  # unique words are contiguous, in uid order
    occ = occ_uid[:nw].to(torch.int64)
    occ_len = ulen[occ]
    total = int(occ_len.sum())
    occ_off = torch.cumsum(occ_len, 0) - occ_len
    src = torch.repeat_interleave(ustart[occ] - occ_off, occ_len) + torch.arange(total, device=dev)
    out = torch.full((out_cap,), PAD, dtype=torch.int32, device=dev)
    out[:total] = ut[is_word][src]
    return out, _scalar(total, dev)


def pack_u16(t: torch.Tensor, unk_id: int) -> torch.Tensor:
    """int32 tokens -> the stream's uint16 wire format (vocab < 0xFFFE):
    placeholders -> unk_id, NEWLINE -> 0xFFFF, PAD -> 0xFFFE."""
    x = torch.where(t >= PLACEHOLDER_START, unk_id, t)
    x = torch.where(t == NEWLINE, U16_NEWLINE, x)
    x = torch.where(t == PAD, U16_STREAM_PAD, x)
    return x.to(torch.uint16)


def stream_merge_plain(tables: EncoderTables, words: StreamWords, unk_id=None):
    """``stream_merge``'s plain version: merge, expand, and pack when
    ``unk_id`` is given."""
    ut, uwid, _ = merge_fixed_point(tables, words.ut, words.uwid, words.n_tokens)
    out, total = expand_occurrences(ut, uwid, words.occ_uid, words.n_words, ut.numel())
    return (out if unk_id is None else pack_u16(out, unk_id)), total


# -- wrappers ------------------------------------------------------------------


def _on_card(x: torch.Tensor, name: str) -> bool:
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {x.device}")
    return True


def _need(x: torch.Tensor, dtype, dev, what: str) -> None:
    if x.dtype != dtype or x.dim() != 1 or not x.is_contiguous() or x.device != dev:
        raise ValueError(f"{what}: expected a contiguous 1-D {dtype} tensor on {dev}, got "
                         f"{x.dtype} {tuple(x.shape)} on {x.device}")


def _run(fn, *args) -> None:
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed: CUDA error {err}")


def stream_build(bytes_u8: torch.Tensor, alpha_cps: torch.Tensor, alpha_ids: torch.Tensor,
                 space_id: int):
    """Bytes -> (t, wid, n_tokens): the kernel on a CUDA tensor, the plain
    ``build_stream`` on a CPU tensor.  ``alpha_cps``/``alpha_ids`` are
    int32 on the same device."""
    if not _on_card(bytes_u8, "stream_build"):
        return build_stream(bytes_u8, alpha_cps, alpha_ids, space_id)
    dev = bytes_u8.device
    _need(bytes_u8, torch.uint8, dev, "bytes")
    _need(alpha_cps, torch.int32, dev, "alpha_cps")
    _need(alpha_ids, torch.int32, dev, "alpha_ids")
    n = bytes_u8.numel()
    m = stream_capacity(n)
    lib = _cuda.load_stream()
    t = torch.empty(m, dtype=torch.int32, device=dev)
    wid = torch.empty(m, dtype=torch.int32, device=dev)
    ctl = torch.zeros(2, dtype=torch.int32, device=dev)  # n_chars, n_tokens
    scratch = torch.empty(lib.yttm_stream_build_scratch(n), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _run(lib.yttm_stream_build, bytes_u8.data_ptr(), n, alpha_cps.data_ptr(),
             alpha_ids.data_ptr(), alpha_cps.numel(), int(space_id), t.data_ptr(),
             wid.data_ptr(), m, ctl.data_ptr(), scratch.data_ptr(),
             torch.cuda.current_stream(dev).cuda_stream)
    stream_build.launches += 1
    return t, wid, ctl[1]


def stream_dedup(t: torch.Tensor, wid: torch.Tensor, n_tokens: torch.Tensor) -> StreamWords:
    """(t, wid, n_tokens) -> ``StreamWords``: the kernel on CUDA tensors,
    the plain ``dedup_words`` on CPU tensors."""
    if not _on_card(t, "stream_dedup"):
        return dedup_words(t, wid, n_tokens)
    dev = t.device
    _need(t, torch.int32, dev, "t")
    _need(wid, torch.int32, dev, "wid")
    m = t.numel()
    if wid.numel() != m or n_tokens.device != dev or n_tokens.dtype != torch.int32:
        raise ValueError("stream_dedup: t, wid and n_tokens must match")
    lib = _cuda.load_stream()
    bufs = [torch.empty(m, dtype=torch.int32, device=dev) for _ in range(5)]
    ctl = torch.zeros(3, dtype=torch.int32, device=dev)  # n_words, n_unique, n_tokens
    scratch = torch.empty(lib.yttm_stream_dedup_scratch(m), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _run(lib.yttm_stream_dedup, t.data_ptr(), wid.data_ptr(), m, n_tokens.data_ptr(),
             *(b.data_ptr() for b in bufs), ctl.data_ptr(), scratch.data_ptr(),
             torch.cuda.current_stream(dev).cuda_stream)
    stream_dedup.launches += 1
    ut, uwid, occ_uid, ustart, ulen = bufs
    return StreamWords(ut, uwid, ctl[2], occ_uid, ctl[0], ustart, ulen, ctl[1])


def stream_merge(tables: EncoderTables, words: StreamWords, unk_id=None):
    """Merge every unique word to its fixed point, expand to occurrence
    order and, when ``unk_id`` is given, pack to the uint16 wire format.
    Returns (ids [M], n_ids 0-dim int32); slots past n_ids hold PAD
    (0xFFFE packed).  The kernel on CUDA tensors, ``stream_merge_plain``
    on CPU tensors."""
    if not _on_card(words.ut, "stream_merge"):
        return stream_merge_plain(tables, words, unk_id)
    dev = words.ut.device
    m = words.ut.numel()
    for name in ("ut", "occ_uid", "ustart", "ulen"):
        _need(getattr(words, name), torch.int32, dev, name)
    t = tables.table
    for name, x in (("kx", t.kx), ("ky", t.ky), ("val", t.val), ("rules_z", tables.rules_z)):
        if x.device != dev or not x.is_contiguous():
            raise ValueError(f"table {name} is not a contiguous tensor on {dev}")
    lib = _cuda.load_stream()
    out = torch.empty(m, dtype=torch.int32 if unk_id is None else torch.uint16, device=dev)
    ctl = torch.zeros(1, dtype=torch.int32, device=dev)  # n_ids
    scratch = torch.empty(lib.yttm_stream_merge_scratch(m), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _run(lib.yttm_stream_merge, words.ut.data_ptr(), m, words.ustart.data_ptr(),
             words.ulen.data_ptr(), words.n_unique.data_ptr(), words.occ_uid.data_ptr(),
             words.n_words.data_ptr(), t.kx.data_ptr(), t.ky.data_ptr(), t.val.data_ptr(),
             t.cap, t.max_probes, tables.rules_z.data_ptr(), tables.n_rules, out.data_ptr(),
             int(unk_id is not None), int(unk_id or 0), ctl.data_ptr(), scratch.data_ptr(),
             torch.cuda.current_stream(dev).cuda_stream)
    stream_merge.launches += 1
    return out, ctl[0]


# launches of the CUDA kernels through each wrapper (plain calls not counted)
stream_build.launches = 0
stream_dedup.launches = 0
stream_merge.launches = 0


def encode_stream(tables: EncoderTables, bytes_u8: torch.Tensor, alpha_cps: torch.Tensor,
                  alpha_ids: torch.Tensor, space_id: int, unk_id=None):
    """The whole pipeline on one chunk (the JAX ``encode_stream_device``,
    and ``_pack_u16`` when ``unk_id`` is given): (ids [M], n_ids)."""
    t, wid, n = stream_build(bytes_u8, alpha_cps, alpha_ids, space_id)
    return stream_merge(tables, stream_dedup(t, wid, n), unk_id)


class StreamEncoder:
    """Host wrapper: chunking, upload, download.

    Chunks hold at most ``YTTM_STREAM_CHUNK`` bytes (1 MiB by default, read
    per call) and end at a newline where the chunk has one, so no sentence
    straddles two chunks.  Buffers are sized from each chunk, so the JAX
    package's ``YTTM_STREAM_ADAPTIVE`` (pow2 capacities against compiles)
    has nothing to choose here.  Every chunk is enqueued before any result
    is read; only the first n_ids entries of each come back (this is the
    JAX ``_slice_prefix``)."""

    def __init__(self, tables: EncoderTables, alphabet_cps, alphabet_ids, space_id: int):
        self.tables = tables
        self.device = tables.rules_z.device
        self.alpha_cps = torch.from_numpy(np.asarray(alphabet_cps, np.int64).astype(np.int32)).to(
            self.device)
        self.alpha_ids = torch.from_numpy(np.asarray(alphabet_ids, np.int32).copy()).to(self.device)
        self.space_id = int(space_id)

    @staticmethod
    def chunks(data: bytes, chunk_cap: int):
        """The chunks of ``data``: at most ``chunk_cap`` bytes, ending at
        the last newline inside that span when there is one."""
        n, start = len(data), 0
        while start < n:
            end = min(start + chunk_cap, n)
            if end < n:
                nl = data.rfind(b"\n", start, end)
                if nl > start:
                    end = nl + 1
            yield data[start:end]
            start = end

    def encode_bytes(self, data: bytes, pack_u16: bool = False, unk_id: int = 1) -> np.ndarray:
        """Encode newline-separated text; returns the flat ids with NEWLINE
        sentinels (int32, or the uint16 wire format with 0xFFFF sentinels
        when ``pack_u16``)."""
        chunk_cap = int(os.environ.get("YTTM_STREAM_CHUNK", str(DEFAULT_CHUNK)))
        on_card = self.device.type == "cuda"
        pending = []
        for chunk in self.chunks(data, chunk_cap):
            src = host = torch.frombuffer(bytearray(chunk), dtype=torch.uint8)
            if on_card:
                host = host.pin_memory()  # kept until its copy is done
                src = host.to(self.device, non_blocking=True)
            out, n_ids = encode_stream(self.tables, src, self.alpha_cps, self.alpha_ids,
                                       self.space_id, unk_id if pack_u16 else None)
            if on_card:
                host_n = torch.empty((), dtype=torch.int32, pin_memory=True)
                host_n.copy_(n_ids, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(self.device))
                pending.append((out, host_n, ev, host))
            else:
                pending.append((out, n_ids, None, host))
        parts = []
        for out, n_ids, ev, _ in pending:
            if ev is not None:
                ev.synchronize()
            parts.append(out[: int(n_ids)].cpu().numpy())
        if not parts:
            return np.zeros(0, np.uint16 if pack_u16 else np.int32)
        return np.concatenate(parts)
