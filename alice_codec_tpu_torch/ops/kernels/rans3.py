"""ALC3 segment word-rANS encode / decode: the port of
``alice_codec_tpu/ops/pallas/rans3_kernels.py`` (encode_words_pallas,
decode_words_pallas).

Both compute the NumPy spec ``ops/rans_word.py`` word for word: segments
of ``s_seg × NG`` symbols, 128 lanes of 32-bit state, 16-bit
renormalisation at PROB_BITS = 11, emitted words appended in ascending
lane order at one cursor per segment, then the hi and lo state rows; an
all-zero segment is elided with count 0.

Layout (the JAX package's, so chunks move between the two):

* symbols: ``(n_streams, s_seg, NG)`` uint8 (the JAX kernels take int32);
* streams: ``(n_streams, stream_rows(s_seg), NG)`` int32 — one u16 word
  per element in emission order, zero past the count;
* counts:  ``(n_streams,)`` int32;
* tables:  ``(n_tables, 256)`` int32 freqs / cums; stream i uses table
  ``i // (n_streams // n_tables)``.

As in ``ops/kernels/lift.py``, each wrapper takes its plain PyTorch
version for a CPU tensor and launches the Hopper kernel
(``csrc/rans3.cu``) for a CUDA tensor, counting launches in
``launches``.
"""

from __future__ import annotations

import ctypes

import torch

from ... import _build
from ..rans_word import PROB_BITS, PROB_SCALE, WORD_L

__all__ = ["NG", "DEFAULT_V_SEG", "stream_rows", "encode_words",
           "decode_words", "encode_words_plain", "decode_words_plain",
           "decode_lut"]

#: lanes per segment (a wire constant: the TPU lane width).
NG = 128
#: segments per kernel slot of the TPU kernels.  Wire-visible through
#: alc3._segment_geometry, which rounds the segment count up to a multiple
#: of it; the CUDA kernels themselves need no V-batching.
DEFAULT_V_SEG = 8

_EMIT_SHIFT = 32 - PROB_BITS
_U32 = 0xFFFFFFFF
_MASK = PROB_SCALE - 1


def stream_rows(s_seg: int) -> int:
    """Stream-block rows for a segment length: the s_seg+2 worst case plus
    a margin row, rounded up to a multiple of 8 (the JAX layout)."""
    return -(-(s_seg + 3) // 8) * 8


def _check_tables(freqs, cums, n_streams: int) -> int:
    if freqs.shape != cums.shape or freqs.ndim != 2 or freqs.shape[1] != 256:
        raise ValueError(f"tables must be (n_tables, 256), got "
                         f"{tuple(freqs.shape)} / {tuple(cums.shape)}")
    n_tables = freqs.shape[0]
    if n_tables == 0 or n_streams % n_tables:
        raise ValueError(f"{n_streams} streams do not divide into "
                         f"{n_tables} tables")
    return n_streams // n_tables


def decode_lut(freqs: torch.Tensor, cums: torch.Tensor) -> torch.Tensor:
    """(n_tables, 256) tables → (n_tables, PROB_SCALE) int32 fused slot
    LUT ``sym | (f-1) << 8 | (slot - cum[sym]) << (8 + PROB_BITS)`` (the
    JAX package builds the same entries at rans3_kernels.py:331-339)."""
    f = freqs.to(torch.int32)
    c = cums.to(torch.int32).contiguous()
    slots = torch.arange(PROB_SCALE, dtype=torch.int32, device=c.device)
    slots = slots.expand(c.shape[0], PROB_SCALE).contiguous()
    sym = torch.searchsorted(c, slots, right=True) - 1
    return (sym | ((f.gather(1, sym) - 1) << 8)
            | ((slots - c.gather(1, sym)) << (8 + PROB_BITS))).to(torch.int32)


# ── plain versions ──────────────────────────────────────────────


def encode_words_plain(symbols, freqs, cums):
    """Plain PyTorch segment encode, vectorised over segments: one pass
    of tensor ops per step.  States are held in int64 and wrapped to
    uint32 after each update."""
    n, s_seg, ng = symbols.shape
    per = _check_tables(freqs, cums, n)
    dev = symbols.device
    w_words = stream_rows(s_seg) * NG
    tbl = torch.arange(n, device=dev) // per
    # the 11-bit fields of the TPU kernel's packed (f-1) << 11 | cum entry
    f_tab = (((freqs.to(torch.int64) - 1) & _MASK) + 1)[tbl]
    c_tab = (cums.to(torch.int64) & _MASK)[tbl]
    out = torch.zeros((n, w_words + 1), dtype=torch.int64, device=dev)
    x = torch.full((n, ng), WORD_L, dtype=torch.int64, device=dev)
    cur = torch.zeros((n, 1), dtype=torch.int64, device=dev)
    lanes = torch.arange(ng, device=dev)
    for j in range(s_seg - 1, -1, -1):
        s = symbols[:, j].to(torch.int64)
        f = f_tab.gather(1, s)
        c = c_tab.gather(1, s)
        emit = (x >> _EMIT_SHIFT) >= f
        e = emit.to(torch.int64)
        rank = torch.cumsum(e, 1) - e
        # non-emitting lanes write into the spare last column
        out.scatter_(1, torch.where(emit, cur + rank, w_words), x & 0xFFFF)
        cur = cur + e.sum(1, keepdim=True)
        x = torch.where(emit, x >> 16, x)
        q = x // f
        x = ((q << PROB_BITS) + (x - q * f) + c) & _U32
    out.scatter_(1, cur + lanes, x >> 16)
    out.scatter_(1, cur + NG + lanes, x & 0xFFFF)
    cur = cur[:, 0] + 2 * NG
    live = (symbols != 0).reshape(n, -1).any(1)
    out[~live] = 0
    counts = torch.where(live, cur, 0).to(torch.int32)
    streams = out[:, :w_words].to(torch.int32).reshape(n, -1, NG)
    return streams, counts


def decode_words_plain(streams, counts, freqs, cums, *, s_seg: int):
    """Plain PyTorch segment decode, vectorised over segments."""
    n, w_rows, ng = streams.shape
    per = _check_tables(freqs, cums, n)
    dev = streams.device
    w_words = w_rows * ng
    lut = decode_lut(freqs, cums).to(torch.int64)[
        torch.arange(n, device=dev) // per]
    flat = streams.reshape(n, w_words).to(torch.int64) & _U32
    cnt = counts.to(torch.int64).reshape(n, 1)
    lanes = torch.arange(ng, device=dev)

    def word_at(idx):
        ok = (idx >= 0) & (idx < w_words)
        return torch.where(ok, flat.gather(1, idx.clamp(0, w_words - 1)), 0)

    cur = (cnt - 2 * NG).clamp(min=0)
    x = ((word_at(cur + lanes) << 16) | word_at(cur + NG + lanes)) & _U32
    out = torch.empty((n, s_seg, ng), dtype=torch.uint8, device=dev)
    for j in range(s_seg):
        e = lut.gather(1, x & _MASK)
        out[:, j] = (e & 255).to(torch.uint8)
        f = ((e >> 8) & _MASK) + 1
        x = (f * (x >> PROB_BITS) + ((e >> (8 + PROB_BITS)) & _MASK)) & _U32
        need = x < WORD_L
        r = need.to(torch.int64)
        k = r.sum(1, keepdim=True)
        w = word_at((cur - k).clamp(min=0) + torch.cumsum(r, 1) - r)
        x = torch.where(need, ((x << 16) | w) & _U32, x)
        cur = cur - k
    out[cnt[:, 0] == 0] = 0
    return out


# ── CUDA launches ───────────────────────────────────────────────


def _lib() -> ctypes.CDLL:
    lib = _build.library("rans3")
    if not getattr(lib, "_alc_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.alc_encode_words.argtypes = [p, p, p, p, p, i, i, i, i, p]
        lib.alc_encode_words.restype = i
        lib.alc_decode_words.argtypes = [p, p, p, p, i, i, i, i, p]
        lib.alc_decode_words.restype = i
        lib._alc_typed = True
    return lib


def _table_i32(t: torch.Tensor, device) -> torch.Tensor:
    return t.to(device=device, dtype=torch.int32).contiguous()


def _check_symbols(symbols) -> None:
    if symbols.dtype != torch.uint8 or symbols.ndim != 3 or symbols.shape[2] != NG:
        raise ValueError(f"symbols must be (n, s_seg, {NG}) uint8, got "
                         f"{tuple(symbols.shape)} {symbols.dtype}")


def encode_words(symbols: torch.Tensor, freqs: torch.Tensor,
                 cums: torch.Tensor):
    """ALC3 segment encode: ``symbols`` (n_streams, s_seg, 128) uint8 →
    ``(streams, counts)`` in the layout of the module docstring."""
    _check_symbols(symbols)
    if symbols.device.type == "cpu":
        return encode_words_plain(symbols, freqs, cums)
    if not symbols.is_cuda:
        raise ValueError(f"encode_words: unsupported device {symbols.device}")
    n, s_seg, _ = symbols.shape
    per = _check_tables(freqs, cums, n)
    sym = symbols.contiguous()
    dev = sym.device
    w_words = stream_rows(s_seg) * NG
    f, c = _table_i32(freqs, dev), _table_i32(cums, dev)
    streams = torch.empty((n, w_words // NG, NG), dtype=torch.int32, device=dev)
    counts = torch.empty((n,), dtype=torch.int32, device=dev)
    _build.check(_lib().alc_encode_words(
        sym.data_ptr(), f.data_ptr(), c.data_ptr(), streams.data_ptr(),
        counts.data_ptr(), n, s_seg, w_words, per,
        torch.cuda.current_stream(dev).cuda_stream), "encode_words")
    encode_words.launches += 1
    return streams, counts


def decode_words(streams: torch.Tensor, counts: torch.Tensor,
                 freqs: torch.Tensor, cums: torch.Tensor, *,
                 s_seg: int) -> torch.Tensor:
    """ALC3 segment decode → (n_streams, s_seg, 128) uint8 symbols."""
    n, w_rows, ng = streams.shape
    if w_rows != stream_rows(s_seg) or ng != NG:
        raise ValueError(f"streams have shape {tuple(streams.shape)}; "
                         f"expected (n, {stream_rows(s_seg)}, {NG})")
    if streams.device.type == "cpu":
        return decode_words_plain(streams, counts, freqs, cums, s_seg=s_seg)
    if not streams.is_cuda:
        raise ValueError(f"decode_words: unsupported device {streams.device}")
    per = _check_tables(freqs, cums, n)
    dev = streams.device
    st = streams.to(torch.int32).contiguous()
    cn = counts.to(device=dev, dtype=torch.int32).contiguous()
    lut = decode_lut(_table_i32(freqs, dev), _table_i32(cums, dev)).contiguous()
    out = torch.empty((n, s_seg, NG), dtype=torch.uint8, device=dev)
    _build.check(_lib().alc_decode_words(
        st.data_ptr(), cn.data_ptr(), lut.data_ptr(), out.data_ptr(), n,
        s_seg, w_rows * NG, per, torch.cuda.current_stream(dev).cuda_stream),
        "decode_words")
    decode_words.launches += 1
    return out


encode_words.launches = 0
decode_words.launches = 0
