"""N-lane byte-rANS encode / decode of the ALC2 wire: the port of
``alice_codec_tpu/ops/pallas/rans_kernel.py`` (encode_nway_pallas) and
``alice_codec_tpu/ops/pallas/rans_decode_kernel.py`` (decode_nway_pallas),
and of the pack that ``alice_codec_tpu/ops/rans_device.py``
(``encode_pack_device``) runs after the encode.

Lane k of a stream owns symbols k, k+N, k+2N, … (row j of the stream's
``(steps, lanes)`` view holds symbols j·N … j·N+N−1) and is an
independent reference rANS stream: PROB_BITS 12, RANS32_L 2^23, byte
renormalisation, ``x' = (x/f) << 12 + x%f + cum``, rows walked LIFO on
encode.  Tables must be sanitized (every frequency ≥ 1, summing to 4096:
``FrequencyTable.from_histogram(..., sanitize=True)``).

Layout (many streams per call — one launch over every (chunk, channel)
stream of an ALC2 batch):

* encode and pack (:func:`encode_pack_nway`): symbols ``(S, n)`` uint8,
  ``n % n_lanes == 0``; freqs / cums ``(S, 256)`` → ``payload`` flat
  uint8, the streams' packed payloads one after another (each lane its
  4 state bytes big-endian, then its renorm bytes in reverse emission
  order, the lanes in order: the ``RansEncoder.finish`` layout, reference
  src/rans.rs:298-308), ``lane_lens (S, lanes)`` int32 including the 4
  state bytes, ``totals (S,)`` int64;
* encode, the TPU kernel's per-step layout (:func:`encode_nway`):
  ``bytes2 (S, steps, lanes, 2)`` uint8 (renorm bytes in emission order,
  unemitted slots 0), ``counts (S, steps, lanes)`` uint8 in {0, 1, 2},
  ``states (S, lanes)`` int64 (32-bit final states);
  :func:`pack_device` packs one stream of it;
* decode (:func:`decode_nway`): ``payload`` flat uint8, ``starts (S,
  lanes)`` int64 byte offsets of each lane's stream in it, ``lens (S,
  lanes)``, freqs / cums ``(S, 256)``, ``luts (S, 4096)`` uint8 (the
  tables' slot → symbol LUTs, ``FrequencyTable.cum_to_sym``) → symbols
  ``(S, steps, lanes)`` uint8.  A lane's state is its first four bytes,
  big-endian (0 past its length); at most two refills per step, only
  while ``pos < len``.

Each function has its plain PyTorch version (``*_plain``: one pass of
tensor ops per step over all streams and lanes, states in int64 masked to
32 bits; the pack by scatter) and a wrapper that takes it for a CPU tensor
and launches the Hopper kernels (``csrc/rans_nway.cu``) for a CUDA tensor,
counting launches in ``launches``.  :func:`slab_bytes`,
:func:`lane_offsets` and :func:`decode_table` are the glue of the CUDA
routes (the CPU tests hold them to the plain versions), and
:func:`rcp_update` models the encode kernel's reciprocal division.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ... import _build

__all__ = ["encode_nway", "encode_pack_nway", "decode_nway",
           "encode_nway_plain", "encode_pack_nway_plain", "decode_nway_plain",
           "pack_device", "pack_streams", "slab_bytes", "lane_offsets",
           "decode_table", "rcp_update"]

PROB_BITS = 12
PROB_SCALE = 1 << PROB_BITS
RANS32_L = 1 << 23
_X_MAX_UNIT = (RANS32_L >> PROB_BITS) << 8
_U32 = 0xFFFFFFFF
_MASK = PROB_SCALE - 1


def _streams(symbols: torch.Tensor, n_lanes: int) -> tuple[int, int]:
    if symbols.dtype != torch.uint8 or symbols.ndim != 2:
        raise ValueError(f"symbols must be (n_streams, n) uint8, got "
                         f"{tuple(symbols.shape)} {symbols.dtype}")
    s, n = symbols.shape
    if n_lanes < 1 or n % n_lanes:
        raise ValueError(f"symbol count {n} must be a multiple of n_lanes "
                         f"({n_lanes}); pad the symbol stream")
    return s, n // n_lanes


def _check_tables(n_streams: int, *tables) -> None:
    for t, width in tables:
        if tuple(t.shape) != (n_streams, width):
            raise ValueError(f"table of shape {tuple(t.shape)}; expected "
                             f"({n_streams}, {width})")


# ── plain versions ──────────────────────────────────────────────


def encode_nway_plain(symbols, freqs, cums, *, n_lanes: int):
    """Plain PyTorch N-lane encode, the per-step layout (module
    docstring)."""
    s, steps = _streams(symbols, n_lanes)
    _check_tables(s, (freqs, 256), (cums, 256))
    dev = symbols.device
    rows = symbols.reshape(s, steps, n_lanes)
    f_tab = freqs.to(device=dev, dtype=torch.int64)
    c_tab = cums.to(device=dev, dtype=torch.int64)
    bytes2 = torch.zeros((s, steps, n_lanes, 2), dtype=torch.uint8, device=dev)
    counts = torch.zeros((s, steps, n_lanes), dtype=torch.uint8, device=dev)
    x = torch.full((s, n_lanes), RANS32_L, dtype=torch.int64, device=dev)
    for j in range(steps - 1, -1, -1):
        sy = rows[:, j].to(torch.int64)
        f = f_tab.gather(1, sy)
        c = c_tab.gather(1, sy)
        x_max = _X_MAX_UNIT * f
        emit0 = x >= x_max
        b0 = torch.where(emit0, x & 0xFF, 0)
        x = torch.where(emit0, x >> 8, x)
        emit1 = x >= x_max
        b1 = torch.where(emit1, x & 0xFF, 0)
        x = torch.where(emit1, x >> 8, x)
        q = x // f
        x = ((q << PROB_BITS) + (x - q * f) + c) & _U32
        bytes2[:, j, :, 0] = b0.to(torch.uint8)
        bytes2[:, j, :, 1] = b1.to(torch.uint8)
        counts[:, j] = (emit0.to(torch.uint8) + emit1.to(torch.uint8))
    return bytes2, counts, x


def pack_device(bytes2: torch.Tensor, counts: torch.Tensor,
                states: torch.Tensor, *, n: int, n_lanes: int):
    """Pack one stream's per-step encode output into its payload.

    Per lane: the renorm bytes in emission order (the reversed row
    order), then the 4 state bytes LSB first, the whole lane reversed —
    the ``RansEncoder.finish`` layout (reference src/rans.rs:298-308) —
    and the lanes one after another.  Returns ``(payload (2n + 4·lanes,)
    uint8 front-aligned with zeros past the total, lane_lens (lanes,)
    int32 including the 4 flush bytes, total int64 scalar)``."""
    dev = bytes2.device
    cap = 2 * n + 4 * n_lanes
    c_em = counts.flip(0).to(torch.int64)          # emission order
    prefix = torch.cumsum(c_em, 0) - c_em          # exclusive, per lane
    lane_lens = c_em.sum(0) + 4
    lane_start = torch.cumsum(lane_lens, 0) - lane_lens
    # emission byte p of lane k lands at start_k + len_k - 1 - p
    dst0 = (lane_start + lane_lens - 1) - prefix
    del prefix
    payload = torch.zeros(cap + 1, dtype=torch.uint8, device=dev)  # +1: sink
    b_em = bytes2.flip(0)
    for slot in range(2):
        dst = torch.where(c_em > slot, dst0 - slot, cap)
        payload.index_put_((dst.reshape(-1),), b_em[..., slot].reshape(-1))
        del dst
    for b in range(4):  # the state flush: final positions 3..0
        payload[lane_start + (3 - b)] = ((states >> (8 * b)) & 0xFF).to(torch.uint8)
    return payload[:cap], lane_lens.to(torch.int32), lane_lens.sum()


def pack_streams(bytes2, counts, states):
    """The per-step output of ``S`` streams packed: :func:`pack_device` of
    each, the payloads concatenated → ``(payload, lane_lens (S, lanes)
    int32, totals (S,) int64)``, the layout of :func:`encode_pack_nway`."""
    s, steps, n_lanes = counts.shape
    parts, lens = [], []
    for i in range(s):
        pay, ln, tot = pack_device(bytes2[i], counts[i], states[i],
                                   n=steps * n_lanes, n_lanes=n_lanes)
        parts.append(pay[:int(tot)])
        lens.append(ln)
    lane_lens = torch.stack(lens)
    return torch.cat(parts), lane_lens, lane_lens.sum(1, dtype=torch.int64)


def encode_pack_nway_plain(symbols, freqs, cums, *, n_lanes: int):
    """Plain PyTorch encode and pack (:func:`encode_nway_plain`, then
    :func:`pack_streams`)."""
    return pack_streams(*encode_nway_plain(symbols, freqs, cums,
                                           n_lanes=n_lanes))


def decode_nway_plain(payload, starts, lens, freqs, cums, luts, *,
                      steps: int):
    """Plain PyTorch N-lane decode (layout in the module docstring)."""
    s, n_lanes = starts.shape
    _check_tables(s, (lens, n_lanes), (freqs, 256), (cums, 256),
                  (luts, PROB_SCALE))
    dev = payload.device
    data = payload.reshape(-1)
    last = max(data.numel() - 1, 0)
    start = starts.to(device=dev, dtype=torch.int64)
    ln = lens.to(device=dev, dtype=torch.int64)
    f_tab = freqs.to(device=dev, dtype=torch.int64)
    c_tab = cums.to(device=dev, dtype=torch.int64)
    lut = luts.to(device=dev, dtype=torch.int64)

    def byte_at(pos):
        ok = pos < ln
        idx = torch.where(ok, start + pos, 0).clamp(max=last)
        return torch.where(ok, data[idx].to(torch.int64), 0)

    x = torch.zeros((s, n_lanes), dtype=torch.int64, device=dev)
    for b in range(4):
        x = (x << 8) | byte_at(torch.full_like(x, b))
    pos = torch.full_like(x, 4)
    out = torch.empty((s, steps, n_lanes), dtype=torch.uint8, device=dev)
    for j in range(steps):
        slot = x & (PROB_SCALE - 1)
        sy = lut.gather(1, slot)
        x = (f_tab.gather(1, sy) * (x >> PROB_BITS) + slot
             - c_tab.gather(1, sy)) & _U32
        for _ in range(2):
            need = (x < RANS32_L) & (pos < ln)
            x = torch.where(need, ((x << 8) | byte_at(pos)) & _U32, x)
            pos = pos + need.to(torch.int64)
        out[:, j] = sy.to(torch.uint8)
    return out


# ── the CUDA routes' glue and models ───────────────────────────


def slab_bytes(steps: int) -> int:
    """Bytes of one lane's slab in the encode kernel's scratch buffer: the
    most a lane can hold (2 bytes a step and the 4 state bytes), rounded
    up to 16 so that every slab ends 16-byte aligned."""
    return -(-(2 * steps + 4) // 16) * 16


def lane_offsets(lane_lens: torch.Tensor) -> torch.Tensor:
    """Byte offset of every lane in the packed payload (streams one after
    another, lanes in order): the exclusive scan of the flattened lane
    lengths, int64."""
    ln = lane_lens.reshape(-1).to(torch.int64)
    return torch.cumsum(ln, 0) - ln


def decode_table(freqs: torch.Tensor, cums: torch.Tensor,
                 luts: torch.Tensor) -> torch.Tensor:
    """The decode kernel's table: per stream and slot one 32-bit word
    ``sym | (slot - cum[sym]) << 8 | (f[sym] - 1) << 20`` (as int32), so
    that ``x' = f · (x >> 12) + (slot - cum)`` takes one load."""
    lut = luts.to(torch.int64)
    f = freqs.to(device=lut.device, dtype=torch.int64).gather(1, lut)
    c = cums.to(device=lut.device, dtype=torch.int64).gather(1, lut)
    slot = torch.arange(PROB_SCALE, device=lut.device)
    w = lut | (((slot - c) & _MASK) << 8) | (((f - 1) & _MASK) << 20)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def rcp_update(x: np.ndarray, f: np.ndarray, c: np.ndarray) -> np.ndarray:
    """The encode kernel's state update (``csrc/rans_nway.cu``
    ``put_symbol``) in numpy: ``(x // f) << 12 + x % f + c`` by a
    multiply-high with ``m = (2^32 - 1) // f`` and one correction
    ``p = (r0 + 4096 - f) >> 12``, all in 32-bit arithmetic."""
    x, f, c = (np.asarray(a, np.uint64) for a in (x, f, c))
    m = np.uint64(_U32) // f
    g = np.uint64(PROB_SCALE) - f
    u32 = np.uint64(_U32)
    q0 = (x * m) >> np.uint64(32)
    t = (x + q0 * g) & u32
    p = ((t - (q0 << np.uint64(PROB_BITS)) + g) & u32) >> np.uint64(PROB_BITS)
    return (t + c + p * g) & u32


# ── CUDA launches ───────────────────────────────────────────────


def _lib() -> ctypes.CDLL:
    lib = _build.library("rans_nway")
    if not getattr(lib, "_alc_typed", False):
        p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.alc_encode_nway.argtypes = [p, p, p, p, p, p, i, i, i, p]
        lib.alc_encode_nway.restype = i
        lib.alc_encode_slabs.argtypes = [p, p, p, p, p, i, i, i, q, p]
        lib.alc_encode_slabs.restype = i
        lib.alc_compact_lanes.argtypes = [p, p, p, p, q, q, p]
        lib.alc_compact_lanes.restype = i
        lib.alc_decode_nway.argtypes = [p, q, p, p, p, p, i, i, i, p]
        lib.alc_decode_nway.restype = i
        lib._alc_typed = True
    return lib


def _grid_ok(n_streams: int, steps: int, n_lanes: int) -> None:
    if not (0 < n_streams <= 65535 and steps > 0 and 0 < n_lanes < 2**31):
        raise ValueError(f"unsupported geometry: {n_streams} streams, "
                         f"{steps} steps, {n_lanes} lanes")


def _i32(t: torch.Tensor, dev) -> torch.Tensor:
    return t.to(device=dev, dtype=torch.int32).contiguous()


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _encode_cuda(symbols, freqs, cums, n_lanes):
    s, steps = _streams(symbols, n_lanes)
    _check_tables(s, (freqs, 256), (cums, 256))
    _grid_ok(s, steps, n_lanes)
    dev = symbols.device
    sym = symbols.contiguous()
    f, c = _i32(freqs, dev), _i32(cums, dev)
    bytes2 = torch.empty((s, steps, n_lanes, 2), dtype=torch.uint8, device=dev)
    counts = torch.empty((s, steps, n_lanes), dtype=torch.uint8, device=dev)
    states = torch.empty((s, n_lanes), dtype=torch.int64, device=dev)
    _build.check(_lib().alc_encode_nway(
        sym.data_ptr(), f.data_ptr(), c.data_ptr(), bytes2.data_ptr(),
        counts.data_ptr(), states.data_ptr(), s, steps, n_lanes,
        _stream(dev)), "encode_nway")
    encode_nway.launches += 1
    return bytes2, counts, states


def _encode_slabs_cuda(symbols, freqs, cums, n_lanes):
    """The packed route's first kernel: every lane coded into its own slab
    → ``(slabs, lane_lens, slab bytes)``."""
    s, steps = _streams(symbols, n_lanes)
    _check_tables(s, (freqs, 256), (cums, 256))
    _grid_ok(s, steps, n_lanes)
    dev = symbols.device
    sym = symbols.contiguous()
    f, c = _i32(freqs, dev), _i32(cums, dev)
    slab = slab_bytes(steps)
    # 16 bytes past the last slab: compact_lanes reads up to 4 past it
    slabs = torch.empty(s * n_lanes * slab + 16, dtype=torch.uint8, device=dev)
    lens = torch.empty((s, n_lanes), dtype=torch.int32, device=dev)
    _build.check(_lib().alc_encode_slabs(
        sym.data_ptr(), f.data_ptr(), c.data_ptr(), slabs.data_ptr(),
        lens.data_ptr(), s, steps, n_lanes, slab, _stream(dev)),
        "encode_pack_nway (encode_slabs)")
    return slabs, lens, slab


def _compact_cuda(slabs, lens, slab):
    """The packed route's second kernel: the lanes moved from their slabs
    into the payload, whose size is read back first (one sync) →
    ``(payload, totals)``."""
    dev = lens.device
    offs = lane_offsets(lens)
    totals = lens.sum(1, dtype=torch.int64)
    payload = torch.empty(int(totals.sum()), dtype=torch.uint8, device=dev)
    _build.check(_lib().alc_compact_lanes(
        slabs.data_ptr(), lens.data_ptr(), offs.data_ptr(), payload.data_ptr(),
        lens.numel(), slab, _stream(dev)), "encode_pack_nway (compact_lanes)")
    return payload, totals


def _encode_pack_cuda(symbols, freqs, cums, n_lanes):
    slabs, lens, slab = _encode_slabs_cuda(symbols, freqs, cums, n_lanes)
    payload, totals = _compact_cuda(slabs, lens, slab)
    encode_pack_nway.launches += 1
    return payload, lens, totals


def _decode_cuda(payload, starts, lens, freqs, cums, luts, steps):
    s, n_lanes = starts.shape
    _check_tables(s, (lens, n_lanes), (freqs, 256), (cums, 256),
                  (luts, PROB_SCALE))
    _grid_ok(s, steps, n_lanes)
    dev = payload.device
    data = payload.reshape(-1).contiguous()
    if data.dtype != torch.uint8:
        raise ValueError(f"payload must be uint8, got {data.dtype}")
    if data.data_ptr() % 16:  # the kernel reads aligned 16-byte chunks
        data = data.clone()
    st = starts.to(device=dev, dtype=torch.int64).contiguous()
    ln = _i32(lens, dev)
    table = decode_table(freqs.to(dev), cums.to(dev), luts.to(dev)).contiguous()
    out = torch.empty((s, steps, n_lanes), dtype=torch.uint8, device=dev)
    _build.check(_lib().alc_decode_nway(
        data.data_ptr(), data.numel(), st.data_ptr(), ln.data_ptr(),
        table.data_ptr(), out.data_ptr(), s, steps, n_lanes, _stream(dev)),
        "decode_nway")
    decode_nway.launches += 1
    return out


# ── wrappers ────────────────────────────────────────────────────


def encode_nway(symbols: torch.Tensor, freqs: torch.Tensor,
                cums: torch.Tensor, *, n_lanes: int):
    """N-lane encode of ``S`` streams: ``(bytes2, counts, states)`` in the
    per-step layout of the module docstring."""
    if symbols.device.type == "cpu":
        return encode_nway_plain(symbols, freqs, cums, n_lanes=n_lanes)
    if symbols.is_cuda:
        return _encode_cuda(symbols, freqs, cums, n_lanes)
    raise ValueError(f"encode_nway: unsupported device {symbols.device}")


def encode_pack_nway(symbols: torch.Tensor, freqs: torch.Tensor,
                     cums: torch.Tensor, *, n_lanes: int):
    """N-lane encode of ``S`` streams into their packed payloads:
    ``(payload, lane_lens, totals)`` (module docstring).  On the card two
    kernels (the coder into per-lane slabs, then the compaction); the
    payload's size is read back between them (one sync)."""
    if symbols.device.type == "cpu":
        return encode_pack_nway_plain(symbols, freqs, cums, n_lanes=n_lanes)
    if symbols.is_cuda:
        return _encode_pack_cuda(symbols, freqs, cums, n_lanes)
    raise ValueError(f"encode_pack_nway: unsupported device {symbols.device}")


def decode_nway(payload: torch.Tensor, starts: torch.Tensor,
                lens: torch.Tensor, freqs: torch.Tensor, cums: torch.Tensor,
                luts: torch.Tensor, *, steps: int) -> torch.Tensor:
    """N-lane decode of ``S`` streams from one flat payload → symbols
    ``(S, steps, lanes)`` uint8.  Every lane must lie inside the payload
    (``0 <= starts``, ``starts + lens <= payload.numel()``)."""
    if payload.device.type == "cpu":
        return decode_nway_plain(payload, starts, lens, freqs, cums, luts,
                                 steps=steps)
    if payload.is_cuda:
        return _decode_cuda(payload, starts, lens, freqs, cums, luts, steps)
    raise ValueError(f"decode_nway: unsupported device {payload.device}")


encode_nway.launches = 0
encode_pack_nway.launches = 0
decode_nway.launches = 0
