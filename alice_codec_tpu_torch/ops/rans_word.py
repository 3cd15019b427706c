"""ALC3 word-rANS: the TPU-native entropy wire format (executable spec).

The round-1 device entropy coders kept the reference's byte-oriented
per-lane streams (reference src/rans.rs:238-389), which forces the decoder
to track one byte cursor PER LANE — on TPU that refill becomes a gather
(or an O(stream) masked reduction) per symbol step and dominates decode
time.  ALC3 re-blocks the wire around three ideas:

* **16-bit renormalization** ("word rANS"): 32-bit state, interval
  [2^16, 2^32), emitting/consuming one uint16 at a time.  Each decode step
  refills each lane with AT MOST ONE u16 (vs 0-2 bytes for the byte
  variant), and the emit test is branch-free: ``emit ⇔ (x >> 20) >= freq``.
* **One cursor per stream**: words are laid out in *emission order*, which
  is exactly reverse decode order — the decoder walks a single cursor
  BACKWARD through the stream and each step's refill is a sequential
  window read.  A lane's position inside the window is the exclusive
  cumsum of the refill flags (a vector op / small matmul on TPU).  No
  per-lane cursors, no gathers over the whole stream, and the encoder is
  single-pass with NO post-hoc compaction or reversal.
* **Fixed-size segments**: the symbol stream is tiled into independent
  segments of ``s_seg × ng`` symbols (row-major; lane k of a segment owns
  its local symbols k, k+ng, …).  Segments are decoded (and encoded) in
  parallel — on TPU, one Pallas grid slot per segment with a statically
  bounded VMEM footprint; across chunks/channels/batches everything folds
  into one grid.  Each segment pays 2·ng words of state flush.

Per-segment stream layout (u16 values; "words")::

    words[0 : n_emit]          renormalization words, appended while
                               encoding steps j = s_seg-1 … 0; within a
                               step, emitting lanes in ASCENDING lane order
    words[n_emit : n_emit+ng]  state_hi per lane (x >> 16), lane-ascending
    words[+ng : +2·ng]         state_lo per lane (x & 0xFFFF)

    count = n_emit + 2·ng      (per-segment word count, stored separately)

The decoder reads the two state rows at ``count-2·ng``, then walks steps
j = 0 … s_seg-1 consuming each step's refill words from a cursor that
starts at ``n_emit`` and moves DOWN: step j's k words occupy
``[cursor-k, cursor)`` with the r-th refilling lane (ascending) at
``cursor-k+r``.  A valid stream ends with every lane back at ``WORD_L``
and the cursor at 0 — the final-state invariant callers may verify.

State math (PROB_BITS=11 since wire v6; 256-bin histograms with the same
sanitized normalization SHAPE as `.alc`/ALC2 — see
FrequencyTable.from_histogram — but scaled to PROB_SCALE=2048):

* encode (LIFO): ``if (x >> (32-PROB_BITS)) >= f: emit u16 = x & 0xFFFF;
  x >>= 16`` then ``x = (x // f) << PROB_BITS | (x % f + cum)``;
* decode: ``slot = x & (PROB_SCALE-1); x = f·(x >> PROB_BITS) + slot - cum``
  then ``if x < 2^16: x = x << 16 | next_u16``.

One refill always suffices: after the decode update ``x ≥ f·2^(16-PROB_BITS)
≥ 2^(16-PROB_BITS)``, so ``x << 16 | w > 2^16``.  The emit threshold is
evaluated as ``(x >> (32-PROB_BITS)) >= f`` so that f = PROB_SCALE (a
single-symbol table) cannot overflow the 32-bit product
``f << (32-PROB_BITS)``.  The emit test is exact duality: after a decode
refill ``x ≥ f·2^(32-PROB_BITS)``; without one ``x < f·2^(32-PROB_BITS)``.

**Why 11 bits, not the reference's 12** (a wire-format decision, not a
compat one — the `.alc`/ALC2 coders keep 12 bits): the TPU decode
kernel's serial chain resolves ``slot → (symbol, freq, slot-cum)`` with
one fused LUT gather; Mosaic's dynamic sublane gather is single-vreg
(8×128 i32 = 1024 entries per gather), so a 2048-slot table costs 2
gather pairs + 1 select and a 4096-slot table costs 4 + 3.  Measured
rate cost of the coarser tables on the bench content: +0.4% (bitmap
planes) to +2.2% (value planes) — bought back several-fold by the
shorter decode chain.  PROB_BITS=10 (single gather pair) was rejected:
min-freq-1 over the 256-symbol alphabet leaves only 768/1024 slots of
real probability mass on value planes (+20% rate).

This module is the NumPy reference implementation (the "spec"); the
Pallas kernels in ops/pallas/rans3_kernels.py must match it word-for-word.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "WORD_L",
    "PROB_BITS",
    "PROB_SCALE",
    "freq_table_words",
    "decode_lut_words",
    "segment_capacity_words",
    "encode_segment_words",
    "decode_segment_words",
    "encode_channel_words",
    "decode_channel_words",
]

PROB_BITS = 11
PROB_SCALE = 1 << PROB_BITS
#: Lower bound of the normalized state interval for the 16-bit-renorm coder.
WORD_L = 1 << 16
#: Emit/duality shift: emit ⇔ (x >> _EMIT_SHIFT) >= f.
_EMIT_SHIFT = 32 - PROB_BITS


def freq_table_words(hist) -> tuple[np.ndarray, np.ndarray]:
    """(256,) histogram → (freqs, cums) int32 at the ALC3 wire's
    PROB_SCALE — the NumPy twin of ops/tables_device.freq_table_device
    (same zero-for-absent/min-1-for-present rule, drain-from-first-argmax
    sanitize, argmax deficit absorption, and uniform all-zero fallback),
    for host-side spec decodes of ALC3 payloads.  NOTE:
    ops/rans.FrequencyTable builds 12-bit `.alc`-compat tables — those do
    NOT decode ALC3 wire.

    **Wire v7 semantics — zero frequency for absent symbols.**  Bins with
    histogram count 0 get frequency 0 (not the `.alc` tables' minimum 1):
    a zero bin in an ALC3 header histogram is a PROMISE that the symbol
    never occurs in the plane (encoders guarantee it by flooring the
    sampled histogram to ≥1 for every bin up to the plane's exact symbol
    maximum — see alc3._covered_hist).  The `.alc` min-1 rule exists so
    any histogram can code any stream; ALC3 controls both sides, and at
    PROB_BITS=11 the min-1 floor costs up to 255/2048 ≈ 12.5 % of the
    probability mass on sparse-alphabet planes (+0.19 bits/symbol
    measured at q=90) — the v7 rule refunds it.  The rounding deficit
    goes to the argmax bin (always a present symbol), not bin 255, which
    may be absent."""
    h = np.asarray(hist, np.uint64)
    total = int(h.sum())
    if total == 0:
        freqs = np.full(256, PROB_SCALE // 256, np.int32)
        cums = (np.arange(256, dtype=np.int32) * (PROB_SCALE // 256))
        return freqs, cums
    freqs = np.where(
        h > 0, np.maximum((h * PROB_SCALE) // total, 1), 0
    ).astype(np.int64)
    excess = int(freqs.sum()) - PROB_SCALE
    while excess > 0:
        imax = int(np.argmax(freqs))
        take = min(excess, int(freqs[imax]) - 1)
        if take <= 0:
            break
        freqs[imax] -= take
        excess -= take
    freqs[int(np.argmax(freqs))] += PROB_SCALE - int(freqs.sum())
    cums = np.concatenate([[0], np.cumsum(freqs)[:-1]]).astype(np.int32)
    return freqs.astype(np.int32), cums


def decode_lut_words(cums) -> np.ndarray:
    """PROB_SCALE-entry slot→symbol LUT for :func:`decode_segment_words`."""
    cums = np.asarray(cums, np.int64)
    return (np.searchsorted(cums, np.arange(PROB_SCALE), side="right") - 1
            ).astype(np.uint8)


class WordTable:
    """Convenience bundle of :func:`freq_table_words` +
    :func:`decode_lut_words` mirroring the ``FrequencyTable`` attribute
    surface (``freqs``/``cums``/``cum_to_sym``) for ALC3-wire callers."""

    __slots__ = ("freqs", "cums", "cum_to_sym")

    def __init__(self, freqs, cums):
        self.freqs = np.asarray(freqs, np.int32)
        self.cums = np.asarray(cums, np.int32)
        self.cum_to_sym = decode_lut_words(self.cums)

    @classmethod
    def from_histogram(cls, hist) -> "WordTable":
        return cls(*freq_table_words(hist))


def segment_capacity_words(s_seg: int, ng: int) -> int:
    """Hard upper bound on one segment's word count: every lane can emit at
    most one word per step (16-bit renorm), plus the 2·ng state words."""
    return (s_seg + 2) * ng


def encode_segment_words(sym_rows: np.ndarray, freqs, cums) -> np.ndarray:
    """Encode one segment.  ``sym_rows``: (s_seg, ng) uint8 symbol rows
    (row j = the segment's symbols at decode step j).  Returns the
    segment's u16 word stream in emission order (refill words + 2 state
    rows; see module docstring)."""
    sym_rows = np.asarray(sym_rows, np.uint8)
    s_steps, ng = sym_rows.shape
    freqs = np.asarray(freqs).astype(np.uint32)
    cums = np.asarray(cums).astype(np.uint32)

    x = np.full(ng, WORD_L, np.uint32)
    parts: list[np.ndarray] = []
    for j in range(s_steps - 1, -1, -1):
        s = sym_rows[j]
        f = freqs[s]
        c = cums[s]
        emit = (x >> _EMIT_SHIFT) >= f
        # decode step j consumes these; ascending lane order
        parts.append((x[emit] & 0xFFFF).astype(np.uint16))
        x = np.where(emit, x >> 16, x)
        x = ((x // f) << PROB_BITS) + (x % f) + c
    parts.append((x >> 16).astype(np.uint16))
    parts.append((x & 0xFFFF).astype(np.uint16))
    return np.concatenate(parts)


def decode_segment_words(
    stream: np.ndarray, count: int, s_seg: int, ng: int, freqs, cums, cum_to_sym
) -> tuple[np.ndarray, int]:
    """Decode one segment stream (first ``count`` entries of ``stream``
    meaningful).  Returns ``(symbols (s_seg, ng) uint8, final_cursor)``.
    ``final_cursor == 0`` for a valid stream (the decoder consumed every
    refill word walking back to the head)."""
    out, pos, _states = _decode_segment_core(
        stream, count, s_seg, ng, freqs, cums, cum_to_sym)
    return out, pos


def _decode_segment_core(
    stream, count, s_seg, ng, freqs, cums, cum_to_sym
) -> tuple[np.ndarray, int, np.ndarray]:
    """decode_segment_words plus the final per-lane states — a valid
    stream ends with every lane back at WORD_L (the full final-state
    invariant; the cursor alone can coincidentally land on 0 for a
    corrupted stream)."""
    stream = np.asarray(stream, np.uint16)
    freqs = np.asarray(freqs).astype(np.uint32)
    cums = np.asarray(cums).astype(np.uint32)
    lut = np.asarray(cum_to_sym, np.uint8)

    n_emit = count - 2 * ng
    x = (stream[n_emit : n_emit + ng].astype(np.uint32) << 16) | stream[
        n_emit + ng : n_emit + 2 * ng
    ]
    pos = n_emit
    out = np.empty((s_seg, ng), np.uint8)
    for j in range(s_seg):
        slot = x & (PROB_SCALE - 1)
        sym = lut[slot]
        out[j] = sym
        f = freqs[sym]
        c = cums[sym]
        x = f * (x >> PROB_BITS) + slot - c
        need = x < WORD_L
        k = int(need.sum())
        # corrupt streams can underflow the cursor: missing words read as 0
        # and the final cursor goes negative, failing the invariant check
        refill = stream[max(pos - k, 0) : max(pos, 0)].astype(np.uint32)
        if refill.shape[0] < k:
            refill = np.concatenate(
                [np.zeros(k - refill.shape[0], np.uint32), refill]
            )
        x[need] = (x[need] << 16) | refill
        pos -= k
    return out, pos, x


def _pad_to_segments(symbols: np.ndarray, s_seg: int, ng: int) -> np.ndarray:
    """(n,) symbols → (n_segments, s_seg, ng), zero-padded at the tail."""
    symbols = np.asarray(symbols, np.uint8)
    seg = s_seg * ng
    n_segments = -(-symbols.shape[0] // seg) if symbols.shape[0] else 0
    pad = n_segments * seg - symbols.shape[0]
    if pad:
        symbols = np.concatenate([symbols, np.zeros(pad, np.uint8)])
    return symbols.reshape(n_segments, s_seg, ng)


def encode_channel_words(
    symbols: np.ndarray, freqs, cums, *, s_seg: int, ng: int
) -> tuple[bytes, np.ndarray]:
    """Encode a channel's symbols into the compact ALC3 payload: per-segment
    streams concatenated in segment order (no padding between segments).

    The symbol stream is zero-padded up to a whole number of segments
    (decoders slice back to the real symbol count).  NOTE (wire v7):
    when padding occurs in a non-elided segment, the caller's table must
    keep bin 0 nonzero — ALC3 guarantees it by adding the padding mass
    to bin 0 of the table histogram (alc3._table_hists) on both sides.

    Returns ``(payload_bytes, word_counts)`` where ``word_counts[s]`` is
    segment s's stream length in u16 words.
    """
    segs = _pad_to_segments(symbols, s_seg, ng)
    counts = np.empty(segs.shape[0], np.uint32)
    parts = []
    for s in range(segs.shape[0]):
        if not segs[s].any():
            # all-zero segment ELIDED: count 0, zero payload words.  The
            # decoder emits s_seg·ng zero symbols without touching the
            # rANS state machine — skipping the serial chain entirely
            # (empty chroma planes and flat regions are the common case).
            counts[s] = 0
            continue
        stream = encode_segment_words(segs[s], freqs, cums)
        counts[s] = stream.shape[0]
        parts.append(stream)
    payload = np.concatenate(parts) if parts else np.empty(0, np.uint16)
    return payload.astype("<u2").tobytes(), counts


def decode_channel_words(
    payload: bytes | np.ndarray,
    word_counts: np.ndarray,
    n_symbols: int,
    *,
    s_seg: int,
    ng: int,
    freqs,
    cums,
    cum_to_sym,
    validate: bool = False,
) -> np.ndarray:
    """Inverse of :func:`encode_channel_words`; returns (n_symbols,) uint8."""
    data = (
        np.frombuffer(bytes(payload), "<u2")
        if isinstance(payload, (bytes, bytearray))
        else np.asarray(payload, np.uint16)
    )
    n_segments = len(word_counts)
    out = np.empty((n_segments, s_seg, ng), np.uint8)
    off = 0
    for s in range(n_segments):
        count = int(word_counts[s])
        if count == 0:  # elided all-zero segment (see encode_channel_words)
            out[s] = 0
            continue
        syms, cursor, states = _decode_segment_core(
            data[off : off + count], count, s_seg, ng, freqs, cums, cum_to_sym
        )
        if validate and cursor != 0:
            raise ValueError(
                f"segment {s}: {cursor} refill words unconsumed — corrupt stream"
            )
        if validate and (states != WORD_L).any():
            raise ValueError(
                f"segment {s}: final states off WORD_L — corrupt stream"
            )
        out[s] = syms
        off += count
    return out.reshape(-1)[:n_symbols]
