"""Device stages of the codec, the `.alc` container and the single-chunk
``FrameEncoder`` / ``FrameDecoder`` (PyTorch port of
``alice_codec_tpu/pipeline.py``).

Two coefficient layouts, as in the JAX package (its ``interleaved``
keyword): ALC3 keeps the interleaved one (low band at even indices, high
at odd), the `.alc` and ALC2 wires the reference ``[low | high]`` one.
On the padded, always-even dims the reference layout is a fixed
permutation of the interleaved one (``ops/wavelet.deinterleave_3d``), so
both run the same lift kernels:

* encode in the reference layout: the fused lift + quantize kernel, then
  one deinterleaving copy of the uint8 symbols (int16 storage between
  its passes is exact for 8-bit input);
* decode in the reference layout: interleave the uint8 symbols back,
  dequantize in int32, the plain level-0 3D inverse lift kernel (int32
  throughout), crop, the int16 truncating cast, inverse colour — the
  JAX package's unfused int32 decode.

The ALC3 stages (interleaved layout):

* encode: uint8 RGB (T, H, W, 3) → YCoCg-R → edge pad (int16) → fused
  lift + quantize + zigzag kernel → uint8 symbols (3, P) and row-sampled
  256-bin histograms (with each plane's symbol maximum, for ALC3's
  coverage floor, from the same pass: ``ops/kernels/hist.py``);
* decode: symbols (3, P) → fused dequantize + inverse lift kernel →
  crop → inverse YCoCg-R → uint8 RGB;
* where nothing is padded and the frames are of the fused kernels' fast
  form (:func:`_rgb_route`, as at 64×1080×1920), the fused kernels take
  the colour themselves: K1 loads the RGB frames and computes the colour
  flags as it loads, K4 writes RGB frames (``forward_quant_rgb`` /
  ``inverse_dequant_rgb``); elsewhere the colour and pad run as torch
  ops (:func:`_color_pad`, ``ops/color.py``), which stay the CPU spec;
* the modes without the fused kernels (multi-level, AnalyticalRDO, deep
  16-bit symbols), and the fixed-step chunks the JAX package's fused
  kernels refuse (:func:`_tpu_fused`): the transform is colour + pad
  (int32) → the plain level-0 3D lift kernel → the subgrid lifts of
  levels ≥ 1 (torch), then quantize per channel or per band; the inverse
  mirrors it and ends in the int32 → int16 truncating cast.
  :func:`_route` names a fixed-step chunk's route (``"rgb"``,
  ``"int16"`` or ``"int32"``) for every stage;
* sparse phase 1: the encode stage over the channels that carry nonzero
  colour only, with the value rows each needs (the zero-channel elision
  of the JAX package's ``encode_sparse_phase1``), and its deep form over
  the 6 lo/hi byte planes.
"""

from __future__ import annotations

import os
import struct
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import torch

from ._device import resolve_device
from .core import WaveletType, checked_pixel_count, padded_dims, quality_to_step
from .errors import InvalidBitstream, InvalidBufferSize, InvalidDimensions
from .ops import color, quant, wavelet
from .ops.rans import RANS32_L, FrequencyTable, RansDecoder, RansEncoder
from .ops.kernels.lift import (_FRAME_BYTES, forward_3d, forward_quant,
                               forward_quant_rgb, inverse_3d, inverse_dequant,
                               inverse_dequant_rgb, rgb_frame)
from .ops.kernels.hist import plane_stats, sampled
from .ops.kernels.sparse import tile_rows

__all__ = ["ChannelHeader", "EncodedChunk", "FrameEncoder", "FrameDecoder",
           "encode_device", "decode_device", "transform_moments_device",
           "encode_bands_device", "decode_bands_device", "encode_deep_device",
           "decode_deep_device", "encode_sparse_phase1",
           "encode_deep_sparse_phase1"]

_MAGIC = b"ALCC"
_FORMAT_VERSION = 1
_FIXED_HEADER_BYTES = 18
_CHANNEL_HEADER_BYTES = 1040

# The tile budget of the JAX package's Pallas lift kernels
# (lift_kernels.py:66): with _FRAME_BYTES it decides which shapes take
# its fused lift kernels (see _tpu_fused).
_TILE_BYTES = 6 * 1024 * 1024


def _edge_index(n: int, padded: int, device) -> torch.Tensor:
    return torch.arange(padded, device=device).clamp(max=n - 1)


def _color_pad(rgb: torch.Tensor, padded, dtype=torch.int16) -> torch.Tensor:
    """color → edge-pad: uint8 (T, H, W, 3) → ``dtype`` (3, pT, pH, pW)
    (edge replication, reference src/pipeline.rs:77-114)."""
    pw, ph, pf = padded
    t, h, w = rgb.shape[:3]
    chans = torch.stack(color.rgb_to_ycocg_r(rgb)).to(dtype)  # (3, T, H, W)
    dev = chans.device
    if pf != t:
        chans = chans.index_select(1, _edge_index(t, pf, dev))
    if ph != h:
        chans = chans.index_select(2, _edge_index(h, ph, dev))
    if pw != w:
        chans = chans.index_select(3, _edge_index(w, pw, dev))
    return chans.contiguous()


def _rgb_route(dims, padded) -> bool:
    """Whether the fused kernels take the colour themselves
    (``forward_quant_rgb`` / ``inverse_dequant_rgb``) for a (w, h, t)
    chunk padded to ``padded``: where nothing is padded and the frames are
    of the kernels' fast form (``lift.rgb_frame``).  Padded, ragged or
    small frames keep :func:`_color_pad` and the int16 volume.  A function
    of the shape alone: the same on every device."""
    w, h, t = dims
    return tuple(padded) == (w, h, t) and rgb_frame(t, h, w)


def _dims(rgb: torch.Tensor):
    """(w, h, t) of a (T, H, W, 3) chunk."""
    t, h, w = rgb.shape[:3]
    return w, h, t


def _lift_quant(rgb: torch.Tensor, wavelet_type, step, dead_zone, padded
                ) -> torch.Tensor:
    """colour → edge-pad → K1: uint8 (T, H, W, 3) → uint8 symbols (3, pT,
    pH, pW), with the colour in K1's load where :func:`_rgb_route`."""
    if _rgb_route(_dims(rgb), padded):
        return forward_quant_rgb(rgb, wavelet_type, step, dead_zone)[0]
    return forward_quant(_color_pad(rgb, padded), wavelet_type, step, dead_zone)


def _pick_tile(n: int, cap: int) -> int:
    """Largest 8-aligned divisor of ``n`` up to ``cap``, or ``n`` when it
    fits (the JAX package's _pick_hb / _pick_band)."""
    if n <= cap:
        return n
    b = 0
    for d in range(8, min(n, cap) + 1, 8):
        if n % d == 0:
            b = d
    return b


def _tpu_fused(padded) -> bool:
    """Whether the JAX package runs its fused Pallas lift kernels for a
    padded (pW, pH, pT) volume of int16 coefficients
    (lift_kernels.lift3d_ok).  Elsewhere it takes its unfused int32
    branch: its decode then stores no int16 between the passes, and its
    sparse phase 1 reports all three channels as nonzero (which the
    capacity caches of the codec see), so the port follows it."""
    w, h, t = padded
    if t % 2 or h % 2 or w % 2:
        return False
    if _pick_tile(h, max(1, _TILE_BYTES // (t * w * 4))) < 1:
        return False
    if h * w * 2 <= _FRAME_BYTES:
        return True
    return (_pick_tile(h, max(1, _TILE_BYTES // (w * 4))) >= 8
            and _pick_tile(w, max(1, _TILE_BYTES // (h * 4))) >= 128)


def _route(dims, padded, levels: int) -> str:
    """ALC3's route for a (w, h, t) chunk padded to ``padded``, lifted
    ``levels`` deep: ``"rgb"`` (the fused kernels take the colour,
    :func:`_rgb_route`), ``"int16"`` (the fused kernels after
    :func:`_color_pad`) or ``"int32"`` (the JAX package's unfused branch:
    ``levels`` > 1 or :func:`_tpu_fused` false).  Wire-visible: on
    ``"int32"`` sparse phase 1 reports every channel as nonzero."""
    if levels > 1 or not _tpu_fused(padded):
        return "int32"
    return "rgb" if _rgb_route(dims, padded) else "int16"


def _transform(rgb: torch.Tensor, wavelet_type, padded, levels: int = 1
               ) -> torch.Tensor:
    """color → edge-pad → forward 3D wavelet: uint8 (T, H, W, 3) → int32
    coefficients (3, pT, pH, pW).  Level 0 runs in the plain 3D lift
    kernel, levels ≥ 1 in the subgrid lifts (``padded`` divisible by
    2^levels)."""
    out = forward_3d(_color_pad(rgb, padded, torch.int32), wavelet_type)
    if levels > 1:
        out = wavelet.forward_3d_inter(out, wavelet_type, levels,
                                       start_level=1)
    return out


def _inverse_rgb(coeffs: torch.Tensor, wavelet_type, dims, levels: int,
                 exact: bool) -> torch.Tensor:
    """Inverse of :func:`_transform`: int32 coefficients (3, pT, pH, pW) →
    subgrid inverses down to level 1, the plain 3D lift kernel's level-0
    inverse (int32), crop, int32 → int16 truncating cast
    (src/pipeline.rs:602-611), inverse YCoCg-R → uint8 (T, H, W, 3)."""
    w, h, t = dims
    if levels > 1:
        coeffs = wavelet.inverse_3d_inter(coeffs, wavelet_type, levels,
                                          exact=exact, stop_level=1)
    volume = inverse_3d(coeffs, wavelet_type, exact=exact)
    chans = volume[:, :t, :h, :w].to(torch.int16)
    return color.ycocg_r_to_rgb(chans[0], chans[1], chans[2])


#: Row-subsample (nc, N) symbol planes for histogram building (the JAX
#: package's name for the rule; the sampled histogram rides the wire).
_hist_sample = sampled


def _symbols(rgb: torch.Tensor, step, dead_zone, *, wavelet_type, padded,
             levels: int) -> torch.Tensor:
    """Transform → quantize → zigzag: uint8 (T, H, W, 3) → uint8 symbols
    (3, P).  On the fused routes (:func:`_route`) the fused lift +
    quantize kernel; on ``"int32"`` :func:`_transform`, then quantize and
    zigzag."""
    pw, ph, pf = padded
    if _route(_dims(rgb), padded, levels) == "int32":
        coeffs = _transform(rgb, wavelet_type, padded, levels)
        sym = quant.to_symbols(quant.quantize(coeffs, step, dead_zone))
    else:
        sym = _lift_quant(rgb, wavelet_type, step, dead_zone, padded)
    return sym.reshape(3, pf * ph * pw)


def _check_reference_levels(levels: int) -> None:
    if levels != 1:
        raise ValueError("the reference layout (interleaved=False) is "
                         f"single-level; got levels={levels}")


def encode_device(rgb: torch.Tensor, step: int, dead_zone: int, *,
                  wavelet_type: WaveletType, padded, levels: int = 1,
                  hist_stride: int = 1, interleaved: bool = False):
    """Encode stage: ``rgb`` uint8 (T, H, W, 3) on the working device →
    ``(symbols (3, P) uint8, histograms (3, 256) int64, maxima (3,)
    int64)``: the histograms of the planes' :func:`_hist_sample` rows and
    each plane's symbol maximum (ALC3's coverage floor; the other wires
    leave it unread), from one pass (``ops/kernels/hist.py``).

    ``interleaved=True``: ALC3's layout (:func:`_symbols`).
    ``interleaved=False``: the reference layout of the `.alc` and ALC2
    wires (single level): the fused lift + quantize kernel, then one
    deinterleaving copy of the symbols."""
    if interleaved:
        symbols = _symbols(rgb, step, dead_zone, wavelet_type=wavelet_type,
                           padded=padded, levels=levels)
    else:
        _check_reference_levels(levels)
        sym = _lift_quant(rgb, wavelet_type, step, dead_zone, padded)
        symbols = wavelet.deinterleave_3d(sym).reshape(3, -1)
    return (symbols, *plane_stats(symbols, hist_stride))


def transform_moments_device(rgb: torch.Tensor, *, wavelet_type: WaveletType,
                             padded):
    """RDO phase 1: transform + exact per-band integer moments →
    ``(coeffs (3, pT, pH, pW) int32, s1 (3, 8) int64, s2 (3, 8) int64)``;
    the host turns the moments into per-band steps
    (:meth:`~.ops.quant.AnalyticalRDO.steps_from_moments`)."""
    coeffs = _transform(rgb, wavelet_type, padded)
    s1, s2 = quant.band_moments_inter(coeffs)
    return coeffs, s1, s2


def encode_bands_device(coeffs: torch.Tensor, steps8, dead_zones8, *,
                        padded, hist_stride: int = 1):
    """RDO phase 2: per-band quantize → ``(symbols (3, P) uint8,
    histograms (3, 256) int64, maxima (3,) int64)``, as
    :func:`encode_device`.  ``steps8`` / ``dead_zones8``: (3, 8)."""
    pw, ph, pf = padded
    q = quant.quantize_bands_inter(coeffs, steps8, dead_zones8)
    symbols = quant.to_symbols(q).reshape(3, pf * ph * pw)
    return (symbols, *plane_stats(symbols, hist_stride))


def decode_bands_device(symbols: torch.Tensor, steps8, *,
                        wavelet_type: WaveletType, dims, padded,
                        exact: bool = False) -> torch.Tensor:
    """Inverse of the RDO encode: symbols (3, P) uint8 + ``steps8``
    (3, 8) → RGB uint8."""
    pw, ph, pf = padded
    q = quant.from_symbols(symbols).reshape(3, pf, ph, pw)
    return _inverse_rgb(quant.dequantize_bands_inter(q, steps8),
                        wavelet_type, dims, 1, exact)


def _deep_planes(rgb, step, dead_zone, *, wavelet_type, padded, levels):
    """Transform → quantize → unwrapped 16-bit zigzag → (6, P) uint8 lo/hi
    byte planes in the order Y-lo, Y-hi, Co-lo, Co-hi, Cg-lo, Cg-hi."""
    pw, ph, pf = padded
    coeffs = _transform(rgb, wavelet_type, padded, levels)
    s16 = quant.to_symbols16(quant.quantize(coeffs, step, dead_zone))
    s16 = s16.reshape(3, pf * ph * pw)
    planes = torch.stack([s16 & 255, s16 >> 8], dim=1)  # (3, 2, P)
    return planes.reshape(6, pf * ph * pw).to(torch.uint8)


def encode_deep_device(rgb: torch.Tensor, step, dead_zone, *,
                       wavelet_type: WaveletType, padded, levels: int = 1,
                       hist_stride: int = 1):
    """Deep (16-bit symbol) encode stage — ALC3's escape coding:
    ``(planes (6, P) uint8, histograms (6, 256) int64, maxima (6,)
    int64)``, as :func:`encode_device`.  With q=100 (step 1) and the exact inverse
    it is lossless on any input."""
    planes = _deep_planes(rgb, step, dead_zone, wavelet_type=wavelet_type,
                          padded=padded, levels=levels)
    return (planes, *plane_stats(planes, hist_stride))


def decode_deep_device(planes: torch.Tensor, step: torch.Tensor, *,
                       wavelet_type: WaveletType, dims, padded,
                       exact: bool = False, levels: int = 1) -> torch.Tensor:
    """Inverse of :func:`encode_deep_device`: (6, P) uint8 planes → RGB.
    ``step``: per-channel (3,) quant steps."""
    pw, ph, pf = padded
    s16 = planes.reshape(3, 2, pf * ph * pw).to(torch.int32)
    s16 = s16[:, 0] | (s16[:, 1] << 8)
    q = quant.from_symbols16(s16).reshape(3, pf, ph, pw)
    return _inverse_rgb(quant.dequantize(q, step.reshape(3, 1, 1, 1)),
                        wavelet_type, dims, levels, exact)


def decode_device(symbols: torch.Tensor, step: torch.Tensor, *,
                  wavelet_type: WaveletType, dims, padded,
                  exact: bool = False, levels: int = 1,
                  active=None, interleaved: bool = False,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """Decode stage: symbols (3, P) uint8 → RGB (T, H, W, 3) uint8.
    ``step``: per-channel (3,) quant steps.  ``exact`` selects the
    exact-undo inverse; the default replays the reference's
    negated-coefficient inverse.

    ``interleaved=False``: symbols in the reference layout (single
    level): interleave them back, dequantize and :func:`_inverse_rgb`
    (int32 throughout, then the truncating cast) — the JAX package's
    decode of the `.alc` and ALC2 wires.

    ``interleaved=True`` (ALC3), by :func:`_route`: on the fused routes
    the fused dequantize + inverse lift kernel, which stores int16
    between its passes (on ``"rgb"`` it writes the RGB frames itself);
    on ``"int32"`` dequantize and :func:`_inverse_rgb` (int32
    throughout, then the truncating cast) — the JAX package's unfused
    branch, which differs from the fused one where an intermediate
    leaves int16.

    ``active`` (fused routes only): the channels that may carry nonzero
    symbols.  An all-zero channel inverse-lifts to exact zeros, so only
    the active ones go through the kernel and the rest are zeros
    (bit-exact).

    ``out``: a (T, H, W, 3) uint8 tensor to write the frames into
    (returned); the fused route's kernel writes there directly."""
    w, h, t = dims
    pw, ph, pf = padded
    route = _route(dims, padded, levels) if interleaved else None
    act = (0, 1, 2) if active is None else tuple(sorted(active))
    sym4 = symbols.reshape(3, pf, ph, pw)
    if not interleaved:
        _check_reference_levels(levels)
        sym = wavelet.interleave_3d(sym4)
        q = quant.from_symbols(sym)
        rgb = _inverse_rgb(quant.dequantize(q, step.reshape(3, 1, 1, 1)),
                           wavelet_type, dims, 1, exact)
    elif route == "int32":
        q = quant.from_symbols(sym4)
        rgb = _inverse_rgb(quant.dequantize(q, step.reshape(3, 1, 1, 1)),
                           wavelet_type, dims, levels, exact)
    elif route == "rgb":
        return inverse_dequant_rgb(sym4, wavelet_type, step, exact=exact,
                                   active=act, out=out)
    else:
        if act == (0, 1, 2):
            volume = inverse_dequant(sym4, wavelet_type, step, exact=exact)
            chans = [volume[c, :t, :h, :w] for c in range(3)]
        else:
            chans = [torch.zeros((t, h, w), dtype=torch.int16,
                                 device=symbols.device)] * 3
            if act:
                idx = torch.tensor(act, device=symbols.device)
                volume = inverse_dequant(sym4[idx], wavelet_type,
                                         step.reshape(-1)[idx], exact=exact)
                for i, c in enumerate(act):
                    chans[c] = volume[i, :t, :h, :w]
        rgb = color.ycocg_r_to_rgb(chans[0], chans[1], chans[2])
    return rgb if out is None else out.copy_(rgb)


def encode_sparse_phase1(rgb: torch.Tensor, step: int, dead_zone: int, *,
                         wavelet_type: WaveletType, padded, pp: int,
                         levels: int = 1, active=(0, 1, 2)):
    """Sparse phase 1: colour + pad, then the fused lift + quantize
    kernel over the ``active`` channels only (a channel whose colour
    plane is all zero gives all-zero symbols, so skipping it is
    bit-exact).  Returns ``(symbols (na, pp) uint8 — padded with zeros
    to ``pp``, trows (na, pp/1024) int32 — the value rows of each tile
    (:func:`~.ops.kernels.sparse.tile_rows`), flags (3,) bool — which
    colour planes are nonzero, regardless of ``active``)``.

    On the ``"int32"`` route (:func:`_route`) the JAX package takes its
    unfused branch, which reports every channel as nonzero; so does this
    one."""
    pw, ph, pf = padded
    active = tuple(sorted(active))
    route = _route(_dims(rgb), padded, levels)
    if route == "int32":
        flags = torch.ones(3, dtype=torch.bool, device=rgb.device)
        symbols = _symbols(rgb, step, dead_zone, wavelet_type=wavelet_type,
                           padded=padded, levels=levels)
        if active != (0, 1, 2):
            symbols = symbols[torch.tensor(active, device=rgb.device)]
    elif route == "rgb":
        symbols, flags = forward_quant_rgb(rgb, wavelet_type, step, dead_zone,
                                           active=active)
        symbols = symbols.reshape(len(active), pf * ph * pw)
    else:
        chans = _color_pad(rgb, padded)
        flags = (chans.reshape(3, -1) != 0).any(1)
        if active != (0, 1, 2):
            chans = chans[torch.tensor(active, device=chans.device)]
        symbols = forward_quant(chans, wavelet_type, step, dead_zone).reshape(
            len(active), pf * ph * pw)
    symbols = torch.nn.functional.pad(symbols, (0, pp - pf * ph * pw))
    return symbols, tile_rows(symbols), flags


def encode_deep_sparse_phase1(rgb: torch.Tensor, step: int, dead_zone: int,
                              *, wavelet_type: WaveletType, padded, pp: int,
                              levels: int = 1):
    """deep×sparse phase 1: the 6 lo/hi byte planes of
    :func:`encode_deep_device`, zero-padded to ``pp``, and their per-tile
    value rows — each byte plane then rides the sparse wire on its own."""
    pw, ph, pf = padded
    planes = _deep_planes(rgb, step, dead_zone, wavelet_type=wavelet_type,
                          padded=padded, levels=levels)
    planes = torch.nn.functional.pad(planes, (0, pp - pf * ph * pw))
    return planes, tile_rows(planes)


@dataclass
class ChannelHeader:
    """Per-plane metadata (reference src/pipeline.rs:123-137): 16 bytes of
    fields, then the 256-bin uint32 histogram (1040 bytes in all)."""

    compressed_len: int = 0
    quant_step: int = 1
    quant_dead_zone: int = 1
    num_symbols: int = 0
    histogram: np.ndarray = field(default_factory=lambda: np.zeros(256, np.uint32))

    def to_bytes(self) -> bytes:
        head = struct.pack(
            "<IiiI",
            self.compressed_len,
            self.quant_step,
            self.quant_dead_zone,
            self.num_symbols,
        )
        return head + np.ascontiguousarray(self.histogram, np.uint32).tobytes()

    @classmethod
    def from_bytes(cls, data: bytes) -> "ChannelHeader":
        compressed_len, step, dz, num_symbols = struct.unpack_from("<IiiI", data, 0)
        hist = np.frombuffer(data, np.uint32, count=256, offset=16).copy()
        return cls(compressed_len, step, dz, num_symbols, hist)


@dataclass
class EncodedChunk:
    """Compressed RGB chunk in the reference-compatible `.alc` container
    (reference ``EncodedChunk``, src/pipeline.rs:172-313)::

        "ALCC" | version=1 | wavelet u8 | width u32 | height u32 | frames u32
        3 × ChannelHeader (1040 B each) | the three channels' rANS streams

    Its bytes equal the JAX package's for the same input, and each
    package decodes the other's."""

    width: int
    height: int
    frames: int
    wavelet_type: WaveletType
    channel_headers: list[ChannelHeader]
    compressed_data: bytes

    @property
    def compressed_size(self) -> int:
        """Total size of the compressed payload in bytes."""
        return len(self.compressed_data)

    @property
    def wavelet(self) -> str:
        """Wavelet name string ("cdf53" | "cdf97" | "haar")."""
        return self.wavelet_type.name_str

    def to_bytes(self) -> bytes:
        """Serialize to a self-contained `.alc` byte buffer (src/pipeline.rs:200-226)."""
        buf = bytearray()
        buf += _MAGIC
        buf.append(_FORMAT_VERSION)
        buf.append(int(self.wavelet_type))
        buf += struct.pack("<III", self.width, self.height, self.frames)
        for ch in self.channel_headers:
            buf += ch.to_bytes()
        buf += self.compressed_data
        return bytes(buf)

    @classmethod
    def from_bytes(cls, data: bytes) -> "EncodedChunk":
        """Parse `.alc` bytes (validation per src/pipeline.rs:235-313)."""
        data = bytes(data)
        min_len = _FIXED_HEADER_BYTES + 3 * _CHANNEL_HEADER_BYTES
        if len(data) < min_len:
            raise InvalidBitstream(
                f"data too short: {len(data)} bytes (minimum {min_len})")
        if data[0:4] != _MAGIC:
            raise InvalidBitstream("bad magic (expected ALCC)")
        version = data[4]
        if version != _FORMAT_VERSION:
            raise InvalidBitstream(
                f"unsupported version: {version} (expected {_FORMAT_VERSION})")
        wavelet_type = WaveletType.from_u8(data[5])
        width, height, frames = struct.unpack_from("<III", data, 6)
        headers = []
        off = _FIXED_HEADER_BYTES
        total_compressed = 0
        for _ in range(3):
            hdr = ChannelHeader.from_bytes(data[off : off + _CHANNEL_HEADER_BYTES])
            headers.append(hdr)
            off += _CHANNEL_HEADER_BYTES
            total_compressed += hdr.compressed_len
        if len(data) < off + total_compressed:
            raise InvalidBitstream(
                f"truncated payload: need {off + total_compressed - len(data)} "
                f"more bytes")
        payload = data[off : off + total_compressed]
        return cls(width, height, frames, wavelet_type, headers, payload)

    def __repr__(self) -> str:
        return (f"EncodedChunk({self.width}x{self.height}x{self.frames}, "
                f"{self.compressed_size} bytes, {self.wavelet})")


def _decode_channel(stream: bytes, n_symbols: int, histogram, *,
                    strict: bool = False) -> np.ndarray:
    """rANS-decode one channel, detecting which table coded it.

    Decode with the reference-exact table first and check the rANS
    final-state invariant (a correct decode ends with state == RANS32_L
    and every byte consumed); on violation the encoder used the
    sanitized table (its overflow retry), so decode with that.  When
    neither table satisfies the invariant the stream is corrupt:
    ``strict`` raises ``InvalidBitstream``, the default returns the
    reference-table symbols (the reference decoder checks nothing,
    src/rans.rs:351-381)."""
    table = FrequencyTable.from_histogram(histogram)
    dec = RansDecoder(stream)
    syms = dec.decode_n(n_symbols, table)
    if dec.state == RANS32_L and dec.pos == len(stream):
        return syms
    table_s = FrequencyTable.from_histogram(histogram, sanitize=True)
    if not np.array_equal(table_s.freqs, table.freqs):
        dec = RansDecoder(stream)
        syms_s = dec.decode_n(n_symbols, table_s)
        if dec.state == RANS32_L and dec.pos == len(stream):
            return syms_s
    if strict:
        raise InvalidBitstream(
            "rANS final-state invariant violated: corrupt channel stream")
    return syms


def _empty_chunk(width: int, height: int, frames: int,
                 wt: WaveletType) -> EncodedChunk:
    return EncodedChunk(width, height, frames, wt,
                        [ChannelHeader() for _ in range(3)], b"")


def _map3(fn) -> list:
    """``fn`` over the three channels, in three threads where the host
    has the cores (the native coder releases the GIL)."""
    if (os.cpu_count() or 1) >= 2:
        with ThreadPoolExecutor(3) as pool:
            return list(pool.map(fn, range(3)))
    return [fn(ch) for ch in range(3)]


def as_uint8_tensor(rgb, device: torch.device) -> torch.Tensor:
    """An RGB array or tensor as a uint8 tensor on ``device``."""
    if isinstance(rgb, torch.Tensor):
        return rgb.to(device=device, dtype=torch.uint8)
    arr = np.ascontiguousarray(rgb, np.uint8)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr).to(device)


class FrameEncoder:
    """Single-chunk encoder to the `.alc` container (reference
    src/pipeline.rs:335-508, API per src/python.rs:365-436).

    The encode stage (colour, pad, lift, quantize, zigzag, histograms)
    runs on ``device`` (the CUDA card unless given another, such as
    ``"cpu"``); the three channels' serial rANS streams are coded on the
    host by the native coder, one thread each.
    """

    def __init__(self, quality: int = 90, wavelet: str | WaveletType = "cdf53",
                 *, device=None):
        self.quality = int(quality)
        self.wavelet_type = (wavelet if isinstance(wavelet, WaveletType)
                             else WaveletType.from_name(wavelet))
        self.device = resolve_device(device)

    @classmethod
    def with_wavelet(cls, quality: int, wavelet_type: WaveletType,
                     *, device=None) -> "FrameEncoder":
        return cls(quality, wavelet_type, device=device)

    def encode(self, rgb_frames, width: int, height: int,
               frames: int) -> EncodedChunk:
        """Encode interleaved RGB bytes ``[R0,G0,B0, R1,G1,B1, ...]``: a
        flat uint8 array (the reference layout) or ``(T, H, W, 3)``, as
        numpy or a tensor."""
        w, h, f = int(width), int(height), int(frames)
        n_pixels = checked_pixel_count(w, h, f)
        size = (rgb_frames.numel() if isinstance(rgb_frames, torch.Tensor)
                else np.asarray(rgb_frames).size)
        if n_pixels == 0:
            if size != 0:
                raise InvalidBufferSize(0, size)
            return _empty_chunk(w, h, f, self.wavelet_type)
        if w == 0 or h == 0:
            raise InvalidDimensions(w, h)
        if size != n_pixels * 3:
            raise InvalidBufferSize(n_pixels * 3, size)

        rgb = as_uint8_tensor(rgb_frames, self.device).reshape(f, h, w, 3)
        padded = padded_dims(w, h, f)
        padded_pixels = padded[0] * padded[1] * padded[2]
        step = quality_to_step(self.quality)
        dead_zone = step  # Quantizer::new semantics (src/quant.rs:70-75)
        symbols_dev, hists_dev, _ = encode_device(
            rgb, step, dead_zone, wavelet_type=self.wavelet_type,
            padded=padded, interleaved=False)
        symbols = symbols_dev.cpu().numpy()
        hists = hists_dev.cpu().numpy().astype(np.uint32)

        def encode_channel(ch: int) -> bytes:
            # The reference-exact table first: whenever the reference's
            # coder can represent the stream, the bytes are its bytes.  A
            # slot past PROB_SCALE (where the reference would corrupt the
            # stream) re-encodes with the sanitized table; the decoder
            # tells the two apart by the final-state invariant.
            table = FrequencyTable.from_histogram(hists[ch])
            enc = RansEncoder()
            enc.encode_symbols(symbols[ch], table)
            if enc.overflowed:
                table = FrequencyTable.from_histogram(hists[ch], sanitize=True)
                enc = RansEncoder()
                enc.encode_symbols(symbols[ch], table)
            return enc.finish()

        streams = _map3(encode_channel)
        headers = [ChannelHeader(compressed_len=len(s), quant_step=step,
                                 quant_dead_zone=dead_zone,
                                 num_symbols=padded_pixels,
                                 histogram=hists[ch])
                   for ch, s in enumerate(streams)]
        return EncodedChunk(w, h, f, self.wavelet_type, headers,
                            b"".join(streams))


class FrameDecoder:
    """Single-chunk `.alc` decoder (reference src/pipeline.rs:519-631):
    the channels' rANS streams decode on the host (native coder, one
    thread each), the rest on ``device`` (the CUDA card unless given
    another)."""

    def __init__(self, *, device=None) -> None:
        self.device = resolve_device(device)

    def decode(self, chunk: EncodedChunk, *, exact: bool = False,
               strict: bool = False) -> np.ndarray:
        """Decode a chunk to flat interleaved RGB uint8 (numpy).

        ``exact=True`` uses the exact-undo wavelet inverse; the default
        matches the reference decoder bit for bit.  ``strict=True``
        raises ``InvalidBitstream`` when a channel stream fails the rANS
        final-state invariant instead of returning garbage pixels."""
        w, h, f = int(chunk.width), int(chunk.height), int(chunk.frames)
        n_pixels = checked_pixel_count(w, h, f)
        if n_pixels == 0:
            return np.empty(0, np.uint8)
        padded = padded_dims(w, h, f)
        padded_pixels = padded[0] * padded[1] * padded[2]
        steps = np.empty(3, np.int32)
        streams = []
        offset = 0
        for ch, hdr in enumerate(chunk.channel_headers):
            if hdr.num_symbols != padded_pixels:
                raise InvalidBitstream(
                    f"channel {ch}: num_symbols {hdr.num_symbols} != "
                    f"padded_pixels {padded_pixels}")
            end = offset + hdr.compressed_len
            if end > len(chunk.compressed_data):
                raise InvalidBitstream(f"channel {ch}: compressed data overrun")
            streams.append(chunk.compressed_data[offset:end])
            offset = end
            steps[ch] = hdr.quant_step

        symbols = np.stack(_map3(lambda ch: _decode_channel(
            streams[ch], padded_pixels, chunk.channel_headers[ch].histogram,
            strict=strict)))
        rgb = decode_device(
            torch.from_numpy(symbols).to(self.device),
            torch.from_numpy(steps).to(self.device),
            wavelet_type=chunk.wavelet_type, dims=(w, h, f), padded=padded,
            exact=exact, interleaved=False)
        return rgb.cpu().numpy().reshape(-1)
