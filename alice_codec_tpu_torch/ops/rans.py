"""rANS entropy coding — host path (bit-exact `.alc` compatibility); the
port of ``alice_codec_tpu/ops/rans.py``.

Re-implements the reference 32-bit rANS (reference: src/rans.rs) with
identical arithmetic: PROB_BITS=12, PROB_SCALE=4096, RANS32_L=2^23, byte
renormalization, LIFO encode with whole-stream reversal, 4-byte state flush.

The inner per-symbol loops are an inherently serial state chain, so they run
in native C++ (``native/alice_rans.cpp``, built at first use) via ctypes.
The pure-Python loops are the executable spec: they run only when a caller
passes ``native=False`` — never in place of a native build that failed
(which raises).  The wide interleaved coder of ``ops/rans_device.py`` and
its CUDA kernels code the ALC2 lanes on the card; this module is what
reads/writes reference-compatible byte streams on the host.

API mirrors the reference types: :class:`FrequencyTable`,
:class:`RansEncoder`, :class:`RansDecoder`, :class:`InterleavedRansEncoder`,
:class:`InterleavedRansDecoder`, :class:`SimdRansDecoder`.
"""

from __future__ import annotations

import numpy as np

from ..native import get_lib

__all__ = [
    "PROB_BITS",
    "PROB_SCALE",
    "RANS32_L",
    "RansSymbol",
    "FrequencyTable",
    "RansEncoder",
    "RansDecoder",
    "InterleavedRansEncoder",
    "InterleavedRansDecoder",
    "SimdRansDecoder",
]

#: Probability precision bits (reference src/rans.rs:50).
PROB_BITS = 12
#: Total probability space; all tables sum to this (src/rans.rs:55).
PROB_SCALE = 1 << PROB_BITS
#: Lower bound of the normalized state interval (src/rans.rs:244).
RANS32_L = 1 << 23


class RansSymbol:
    """(cum_freq, freq) pair for one symbol (reference src/rans.rs:59-72)."""

    __slots__ = ("cum_freq", "freq")

    def __init__(self, cum_freq: int, freq: int):
        self.cum_freq = cum_freq
        self.freq = freq

    def __repr__(self) -> str:  # pragma: no cover
        return f"RansSymbol(cum_freq={self.cum_freq}, freq={self.freq})"


def _ctypes_ptr(arr: np.ndarray):
    import ctypes

    return arr.ctypes.data_as(
        {
            np.dtype(np.uint8): ctypes.POINTER(ctypes.c_uint8),
            np.dtype(np.uint16): ctypes.POINTER(ctypes.c_uint16),
            np.dtype(np.uint32): ctypes.POINTER(ctypes.c_uint32),
        }[arr.dtype]
    )


class FrequencyTable:
    """Normalized symbol frequency table (reference src/rans.rs:85-219).

    ``freqs``/``cums`` are uint16 arrays of length ``n_symbols``;
    ``cum_to_sym`` is the 4096-entry decode LUT.
    """

    __slots__ = ("freqs", "cums", "cum_to_sym")

    def __init__(self, freqs: np.ndarray, cums: np.ndarray, cum_to_sym: np.ndarray):
        self.freqs = np.ascontiguousarray(freqs, np.uint16)
        self.cums = np.ascontiguousarray(cums, np.uint16)
        self.cum_to_sym = np.ascontiguousarray(cum_to_sym, np.uint8)

    # -- construction -------------------------------------------------

    @classmethod
    def from_histogram(cls, histogram, *, sanitize: bool = False,
                       native: bool = True) -> "FrequencyTable":
        """Normalize a histogram to PROB_SCALE (reference src/rans.rs:102-150).

        Zero-count symbols get frequency 1; the last symbol absorbs the
        rounding difference; all-zero histograms fall back to uniform.

        ``sanitize=False`` (default) is reference-exact — including its
        latent defect: used-symbol slots may cross PROB_SCALE and corrupt
        the stream if an encoded state lands in the overlap (detected by
        :attr:`RansEncoder.overflowed`).  ``sanitize=True`` renormalizes
        the whole table to a valid one for the same histogram (used for
        ALC2 streams and as the encode-retry/decode-retry table).
        ``native=False`` runs the pure-Python spec.
        """
        hist = np.ascontiguousarray(histogram, np.uint32)
        n = len(hist)
        if native:
            lib = get_lib()
            freqs = np.zeros(n, np.uint16)
            cums = np.zeros(n, np.uint16)
            lut = np.zeros(PROB_SCALE, np.uint8)
            lib.alc_freq_table(
                _ctypes_ptr(hist), n, _ctypes_ptr(freqs), _ctypes_ptr(cums),
                _ctypes_ptr(lut), int(sanitize),
            )
            return cls(freqs, cums, lut)

        total = int(hist.sum(dtype=np.uint64))
        if total == 0:
            return cls.uniform(n)
        h = hist.astype(np.int64)
        freqs64 = np.maximum((h * PROB_SCALE) // np.int64(total), 1)
        s = int(freqs64.sum())
        if sanitize and s > PROB_SCALE:
            excess = s - PROB_SCALE
            while excess > 0:
                imax = int(np.argmax(freqs64))
                take = min(excess, int(freqs64[imax]) - 1)
                if take == 0:
                    break
                freqs64[imax] -= take
                excess -= take
        cums64 = np.concatenate([[0], np.cumsum(freqs64)[:-1]])
        normalized_total = int(freqs64.sum())
        freqs = (freqs64 & 0xFFFF).astype(np.uint16)
        cums = (cums64 & 0xFFFF).astype(np.uint16)
        if n and normalized_total != PROB_SCALE:
            freqs[-1] = (int(freqs[-1]) + PROB_SCALE - normalized_total) & 0xFFFF
        return cls(freqs, cums, _build_lut(freqs, cums))

    @classmethod
    def uniform(cls, n_symbols: int) -> "FrequencyTable":
        """Uniform table (reference src/rans.rs:158-189)."""
        per = PROB_SCALE // n_symbols
        freqs = np.full(n_symbols, per, np.uint16)
        cums = (np.arange(n_symbols, dtype=np.uint32) * per).astype(np.uint16)
        if n_symbols:
            freqs[-1] = (PROB_SCALE - int(cums[-1])) & 0xFFFF
        return cls(freqs, cums, _build_lut(freqs, cums))

    # -- queries ------------------------------------------------------

    def get_symbol(self, sym: int) -> RansSymbol:
        return RansSymbol(int(self.cums[sym]), int(self.freqs[sym]))

    def decode_symbol(self, cum_freq: int) -> tuple[int, RansSymbol]:
        sym = int(self.cum_to_sym[cum_freq])
        return sym, self.get_symbol(sym)

    def __len__(self) -> int:
        return len(self.freqs)

    @property
    def is_empty(self) -> bool:
        return len(self.freqs) == 0


def _build_lut(freqs: np.ndarray, cums: np.ndarray) -> np.ndarray:
    """cum→symbol LUT with the reference's overwrite-in-order semantics."""
    lut = np.zeros(PROB_SCALE, np.uint8)
    for sym in range(len(freqs)):
        start = int(cums[sym])
        end = min(start + int(freqs[sym]), PROB_SCALE)
        if start < end:
            lut[start:end] = sym & 0xFF
    return lut


class RansEncoder:
    """Single-stream 32-bit rANS encoder (reference src/rans.rs:238-315).

    Symbols are encoded in reverse order (LIFO); ``finish()`` flushes the
    4 state bytes and reverses the output so the decoder reads forward.

    >>> table = FrequencyTable.uniform(256)
    >>> enc = RansEncoder()
    >>> enc.encode_symbols([42, 100, 200], table)
    >>> data = enc.finish()
    >>> dec = RansDecoder(data)
    >>> [int(s) for s in dec.decode_n(3, table)]
    [42, 100, 200]
    """

    def __init__(self, capacity: int = 0, *, native: bool = True):
        self.state = RANS32_L
        self.native = native
        self._chunks: list[np.ndarray] = []
        #: True when an encoded slot crossed PROB_SCALE — i.e. the
        #: (reference-exact) table cannot represent this stream and a
        #: reference decoder would corrupt it.  Callers re-encode with a
        #: ``sanitize=True`` table when set.
        self.overflowed = False

    @classmethod
    def with_capacity(cls, capacity: int) -> "RansEncoder":
        return cls(capacity)

    def encode(self, sym_info: RansSymbol) -> None:
        """Encode a single symbol (callers must present symbols in reverse)."""
        freq = sym_info.freq
        cum = sym_info.cum_freq
        x_max = ((RANS32_L >> PROB_BITS) << 8) * freq
        out = bytearray()
        x = self.state
        while x >= x_max:
            out.append(x & 0xFF)
            x >>= 8
        slot = (x % freq) + cum
        if slot >= PROB_SCALE:
            self.overflowed = True
        self.state = ((x // freq) << PROB_BITS) + slot
        if out:
            self._chunks.append(np.frombuffer(bytes(out), np.uint8))

    def encode_symbols(self, symbols, table: FrequencyTable) -> None:
        """Encode a buffer of symbols in reverse order (src/rans.rs:288-294)."""
        syms = np.ascontiguousarray(symbols, np.uint8)
        n = len(syms)
        if n == 0:
            return
        if self.native:
            import ctypes

            lib = get_lib()
            out = np.empty(2 * n + 16, np.uint8)
            state = ctypes.c_uint32(self.state)
            ovf = ctypes.c_int32(1 if self.overflowed else 0)
            produced = lib.alc_rans_encode_put(
                ctypes.byref(state), _ctypes_ptr(syms), n,
                _ctypes_ptr(table.freqs), _ctypes_ptr(table.cums),
                _ctypes_ptr(out), ctypes.byref(ovf),
            )
            self.state = state.value
            self.overflowed = bool(ovf.value)
            if produced:
                self._chunks.append(out[:produced].copy())
            return
        # Pure-Python spec path.
        freqs, cums = table.freqs, table.cums
        x = self.state
        out = bytearray()
        for s in syms[::-1]:
            f = int(freqs[s])
            x_max = ((RANS32_L >> PROB_BITS) << 8) * f
            while x >= x_max:
                out.append(x & 0xFF)
                x >>= 8
            slot = (x % f) + int(cums[s])
            if slot >= PROB_SCALE:
                self.overflowed = True
            x = ((x // f) << PROB_BITS) + slot
        self.state = x
        if out:
            self._chunks.append(np.frombuffer(bytes(out), np.uint8))

    def finish(self) -> bytes:
        """Flush the state (4 bytes LSB-first) and reverse (src/rans.rs:298-308)."""
        flush = np.array(
            [
                self.state & 0xFF,
                (self.state >> 8) & 0xFF,
                (self.state >> 16) & 0xFF,
                (self.state >> 24) & 0xFF,
            ],
            np.uint8,
        )
        raw = np.concatenate(self._chunks + [flush]) if self._chunks else flush
        return raw[::-1].tobytes()


class RansDecoder:
    """Single-stream rANS decoder (reference src/rans.rs:321-389)."""

    def __init__(self, data: bytes | np.ndarray, *, native: bool = True):
        self.native = native
        self._data = np.ascontiguousarray(np.frombuffer(bytes(data), np.uint8))
        self.state = 0
        self.pos = 0
        if len(self._data) >= 4:
            self.state = int.from_bytes(self._data[:4].tobytes(), "big")
            self.pos = 4

    def decode(self, table: FrequencyTable) -> int:
        """Decode one symbol (src/rans.rs:351-371)."""
        return int(self.decode_n(1, table)[0])

    def decode_n(self, n: int, table: FrequencyTable) -> np.ndarray:
        out = np.empty(n, np.uint8)
        if self.native:
            import ctypes

            lib = get_lib()
            state = ctypes.c_uint32(self.state)
            pos = ctypes.c_int64(self.pos)
            # native re-inits from the first 4 bytes only when pos==0;
            # our constructor already consumed them, so pos is >= 4 here
            # (or 0 for an empty stream, where init is a no-op anyway).
            lib.alc_rans_decode_n(
                _ctypes_ptr(self._data), len(self._data), n,
                _ctypes_ptr(table.freqs), _ctypes_ptr(table.cums),
                _ctypes_ptr(table.cum_to_sym), _ctypes_ptr(out),
                ctypes.byref(state), ctypes.byref(pos),
            )
            self.state = state.value
            self.pos = pos.value
            return out
        freqs, cums, lut = table.freqs, table.cums, table.cum_to_sym
        x, p, data = self.state, self.pos, self._data
        ln = len(data)
        for i in range(n):
            slot = x & (PROB_SCALE - 1)
            s = int(lut[slot])
            x = (int(freqs[s]) * (x >> PROB_BITS) + slot - int(cums[s])) & 0xFFFFFFFF
            while x < RANS32_L and p < ln:
                x = ((x << 8) | int(data[p])) & 0xFFFFFFFF
                p += 1
            out[i] = s
        self.state, self.pos = x, p
        return out

    @property
    def is_empty(self) -> bool:
        return self.pos >= len(self._data) and self.state < RANS32_L


class InterleavedRansEncoder:
    """4-stream interleaved encoder (reference src/rans.rs:393-461).

    Symbol i is owned by stream i % 4.  Wire format: 4×u32 LE stream
    lengths, 4×u32 LE symbol counts, then the concatenated streams.
    """

    def __init__(self, *, native: bool = True) -> None:
        self.native = native
        self._calls: list[tuple[np.ndarray, FrequencyTable]] = []

    def encode(self, symbols, table: FrequencyTable) -> None:
        """Reference call semantics (src/rans.rs:413-427): each call pushes
        ITS symbols round-robin (reverse order, this call's table) into the
        four persistent stream encoders and OVERWRITES the stored per-stream
        symbol counts with this call's counts — so mixed-table multi-call
        sequences produce the reference's (surprising) wire bytes exactly."""
        self._calls.append((np.ascontiguousarray(symbols, np.uint8), table))

    def finish(self) -> bytes:
        if len(self._calls) == 1 and self.native:
            # fast native path for the common single-call case (identical
            # bytes to the spec path below)
            lib = get_lib()
            syms, table = self._calls[0]
            n = len(syms)
            out = np.empty(2 * n + 64, np.uint8)
            total = lib.alc_rans_encode4(
                _ctypes_ptr(syms), n, _ctypes_ptr(table.freqs),
                _ctypes_ptr(table.cums), _ctypes_ptr(out),
            )
            return out[:total].tobytes()
        # Spec path: four persistent LIFO encoders, replaying calls in order.
        encoders = [RansEncoder(native=False) for _ in range(4)]
        counts = [0, 0, 0, 0]
        for syms, table in self._calls:
            n = len(syms)
            counts = [(n + 3 - i) // 4 for i in range(4)]
            for i in range(n - 1, -1, -1):
                encoders[i % 4].encode(table.get_symbol(int(syms[i])))
        streams = [e.finish() for e in encoders]
        head = b"".join(len(s).to_bytes(4, "little") for s in streams)
        head += b"".join(c.to_bytes(4, "little") for c in counts)
        return head + b"".join(streams)


class InterleavedRansDecoder:
    """4-stream interleaved decoder (reference src/rans.rs:465-524).

    Stateful across calls, like the reference: two sequential
    ``decode_n(20, t)`` calls return the same symbols as one
    ``decode_n(40, t)`` — each call resumes the four per-stream decoders
    and the round-robin cursor where the previous call left them.
    """

    def __init__(self, data: bytes, *, native: bool = True):
        data = bytes(data)
        self._data = np.ascontiguousarray(np.frombuffer(data, np.uint8))
        lens = [int.from_bytes(data[4 * i : 4 * i + 4], "little") for i in range(4)]
        counts = [
            int.from_bytes(data[16 + 4 * i : 20 + 4 * i], "little") for i in range(4)
        ]
        self.stream_lens = lens
        self.symbols_remaining = counts
        offs = [32]
        for ln in lens:
            offs.append(offs[-1] + ln)
        # Persistent per-stream decoders (themselves stateful: state + byte
        # position survive across decode_n calls) and the rotating stream
        # index — the reference decoder's `next_stream` equivalent.
        self._decoders = [
            RansDecoder(data[offs[i] : offs[i + 1]], native=native)
            for i in range(4)
        ]
        self._next = 0

    def decode_n(self, n: int, table: FrequencyTable) -> np.ndarray:
        out = np.empty(n, np.uint8)
        remaining = list(self.symbols_remaining)
        k = self._next
        # Round-robin pick sequence for this call (skipping exhausted
        # streams, as the reference does near the tail).
        picks = np.empty(n, np.int8)
        for i in range(n):
            if remaining[0] or remaining[1] or remaining[2] or remaining[3]:
                while remaining[k] == 0:
                    k = (k + 1) % 4
                remaining[k] -= 1
            # else: every stream exhausted — keep round-robin order and let
            # the per-stream decoders emit their past-end symbols, exactly
            # what the reference's decode loop degenerates to.
            picks[i] = k
            k = (k + 1) % 4
        # Decode each stream's quota in one (native-accelerated, stateful)
        # per-stream call, then interleave into round-robin output order.
        for s in range(4):
            idx = np.nonzero(picks == s)[0]
            if idx.size:
                out[idx] = self._decoders[s].decode_n(int(idx.size), table)
        self.symbols_remaining = remaining
        self._next = k
        return out


class SimdRansDecoder:
    """4-state shared-buffer decoder (reference src/rans.rs:535-618).

    Reads 4 raw big-endian states from the head of one buffer and decodes
    round-robin with a single shared byte pointer.  Note (as in the
    reference): this framing is NOT compatible with
    :class:`InterleavedRansEncoder`'s header+separate-streams output.
    """

    def __init__(self, data: bytes):
        self._data = np.frombuffer(bytes(data), np.uint8)
        self.states = [0, 0, 0, 0]
        ptr = 0
        for i in range(4):
            if ptr + 4 <= len(self._data):
                self.states[i] = int.from_bytes(
                    self._data[ptr : ptr + 4].tobytes(), "big"
                )
                ptr += 4
        self.ptr = ptr

    def decode_4(self, table: FrequencyTable) -> list[int]:
        out = []
        data, ln = self._data, len(self._data)
        for i in range(4):
            x = self.states[i]
            slot = x & (PROB_SCALE - 1)
            s = int(table.cum_to_sym[slot])
            x = (
                int(table.freqs[s]) * (x >> PROB_BITS) + slot - int(table.cums[s])
            ) & 0xFFFFFFFF
            while x < RANS32_L and self.ptr < ln:
                x = ((x << 8) | int(data[self.ptr])) & 0xFFFFFFFF
                self.ptr += 1
            self.states[i] = x
            out.append(s)
        return out

    def decode_n(self, n: int, table: FrequencyTable) -> np.ndarray:
        if n % 4 != 0:
            raise ValueError("n must be multiple of 4 for SIMD decoder")
        out = np.empty(n, np.uint8)
        for i in range(n // 4):
            out[4 * i : 4 * i + 4] = self.decode_4(table)
        return out
