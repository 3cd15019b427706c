"""N-lane byte-rANS encode / decode of the ALC2 wire: the port of
``alice_codec_tpu/ops/pallas/rans_kernel.py`` (encode_nway_pallas) and
``alice_codec_tpu/ops/pallas/rans_decode_kernel.py`` (decode_nway_pallas).

Lane k of a stream owns symbols k, k+N, k+2N, … (row j of the stream's
``(steps, lanes)`` view holds symbols j·N … j·N+N−1) and is an
independent reference rANS stream: PROB_BITS 12, RANS32_L 2^23, byte
renormalisation, ``x' = (x/f) << 12 + x%f + cum``, rows walked LIFO on
encode.  Tables must be sanitized (every frequency ≥ 1, summing to 4096:
``FrequencyTable.from_histogram(..., sanitize=True)``).

Layout (many streams per call — one launch over every (chunk, channel)
stream of an ALC2 batch):

* encode: symbols ``(S, n)`` uint8, ``n % n_lanes == 0``; freqs / cums
  ``(S, 256)`` → ``bytes2 (S, steps, lanes, 2)`` uint8 (renorm bytes in
  emission order, unemitted slots 0), ``counts (S, steps, lanes)`` uint8
  in {0, 1, 2}, ``states (S, lanes)`` int64 (32-bit final states);
* decode: ``payload`` flat uint8, ``starts (S, lanes)`` int64 byte
  offsets of each lane's stream in it, ``lens (S, lanes)``, freqs /
  cums ``(S, 256)``, ``luts (S, 4096)`` uint8 (the tables' slot → symbol
  LUTs, ``FrequencyTable.cum_to_sym``) → symbols ``(S, steps, lanes)``
  uint8.  A lane's state is its first four bytes, big-endian (0 past its
  length); at most two refills per step, only while ``pos < len``.

Each function has its plain PyTorch version (``*_plain``: one pass of
tensor ops per step over all streams and lanes, states in int64 masked to
32 bits) and a wrapper that takes it for a CPU tensor and launches the
Hopper kernel (``csrc/rans_nway.cu``) for a CUDA tensor, counting
launches in ``launches``.
"""

from __future__ import annotations

import ctypes

import torch

from ... import _build

__all__ = ["encode_nway", "decode_nway", "encode_nway_plain",
           "decode_nway_plain"]

PROB_BITS = 12
PROB_SCALE = 1 << PROB_BITS
RANS32_L = 1 << 23
_X_MAX_UNIT = (RANS32_L >> PROB_BITS) << 8
_U32 = 0xFFFFFFFF


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
    """Plain PyTorch N-lane encode (layout in the module docstring)."""
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


# ── CUDA launches ───────────────────────────────────────────────


def _lib() -> ctypes.CDLL:
    lib = _build.library("rans_nway")
    if not getattr(lib, "_alc_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.alc_encode_nway.argtypes = [p, p, p, p, p, p, i, i, i, p]
        lib.alc_encode_nway.restype = i
        lib.alc_decode_nway.argtypes = [p, p, p, p, p, p, p, i, i, i, p]
        lib.alc_decode_nway.restype = i
        lib._alc_typed = True
    return lib


def _grid_ok(n_streams: int, steps: int, n_lanes: int) -> None:
    if not (0 < n_streams <= 65535 and steps > 0 and 0 < n_lanes < 2**31):
        raise ValueError(f"unsupported geometry: {n_streams} streams, "
                         f"{steps} steps, {n_lanes} lanes")


def _i32(t: torch.Tensor, dev) -> torch.Tensor:
    return t.to(device=dev, dtype=torch.int32).contiguous()


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
        torch.cuda.current_stream(dev).cuda_stream), "encode_nway")
    encode_nway.launches += 1
    return bytes2, counts, states


def _decode_cuda(payload, starts, lens, freqs, cums, luts, steps):
    s, n_lanes = starts.shape
    _check_tables(s, (lens, n_lanes), (freqs, 256), (cums, 256),
                  (luts, PROB_SCALE))
    _grid_ok(s, steps, n_lanes)
    dev = payload.device
    data = payload.reshape(-1).contiguous()
    if data.dtype != torch.uint8:
        raise ValueError(f"payload must be uint8, got {data.dtype}")
    st = starts.to(device=dev, dtype=torch.int64).contiguous()
    ln = _i32(lens, dev)
    f, c = _i32(freqs, dev), _i32(cums, dev)
    lut = luts.to(device=dev, dtype=torch.uint8).contiguous()
    out = torch.empty((s, steps, n_lanes), dtype=torch.uint8, device=dev)
    _build.check(_lib().alc_decode_nway(
        data.data_ptr(), st.data_ptr(), ln.data_ptr(), f.data_ptr(),
        c.data_ptr(), lut.data_ptr(), out.data_ptr(), s, steps, n_lanes,
        torch.cuda.current_stream(dev).cuda_stream), "decode_nway")
    decode_nway.launches += 1
    return out


# ── wrappers ────────────────────────────────────────────────────


def encode_nway(symbols: torch.Tensor, freqs: torch.Tensor,
                cums: torch.Tensor, *, n_lanes: int):
    """N-lane encode of ``S`` streams: ``(bytes2, counts, states)`` in the
    layout of the module docstring."""
    if symbols.device.type == "cpu":
        return encode_nway_plain(symbols, freqs, cums, n_lanes=n_lanes)
    if symbols.is_cuda:
        return _encode_cuda(symbols, freqs, cums, n_lanes)
    raise ValueError(f"encode_nway: unsupported device {symbols.device}")


def decode_nway(payload: torch.Tensor, starts: torch.Tensor,
                lens: torch.Tensor, freqs: torch.Tensor, cums: torch.Tensor,
                luts: torch.Tensor, *, steps: int) -> torch.Tensor:
    """N-lane decode of ``S`` streams from one flat payload → symbols
    ``(S, steps, lanes)`` uint8.  Every lane must lie inside the payload
    (``starts + lens <= payload.numel()``)."""
    if payload.device.type == "cpu":
        return decode_nway_plain(payload, starts, lens, freqs, cums, luts,
                                 steps=steps)
    if payload.is_cuda:
        return _decode_cuda(payload, starts, lens, freqs, cums, luts, steps)
    raise ValueError(f"decode_nway: unsupported device {payload.device}")


encode_nway.launches = 0
decode_nway.launches = 0
