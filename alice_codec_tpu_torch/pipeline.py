"""Device stages of the dense ALC3 path (PyTorch port of the
interleaved, single-level fused branch of ``alice_codec_tpu/pipeline.py``)
and the per-plane container header.

* encode: uint8 RGB (T, H, W, 3) → YCoCg-R → edge pad to even dims
  (int16) → fused lift + quantize + zigzag kernel → uint8 symbols
  (3, P) and row-sampled 256-bin histograms;
* decode: symbols (3, P) → fused dequantize + inverse lift kernel →
  crop → inverse YCoCg-R → uint8 RGB.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np
import torch

from .core import WaveletType
from .ops import color, quant
from .ops.kernels.lift import forward_quant, inverse_dequant

__all__ = ["ChannelHeader", "encode_device", "decode_device"]


def _edge_index(n: int, padded: int, device) -> torch.Tensor:
    return torch.arange(padded, device=device).clamp(max=n - 1)


def _color_pad(rgb: torch.Tensor, padded) -> torch.Tensor:
    """color → edge-pad: uint8 (T, H, W, 3) → int16 (3, pT, pH, pW)
    (edge replication, reference src/pipeline.rs:77-114)."""
    pw, ph, pf = padded
    t, h, w = rgb.shape[:3]
    chans = torch.stack(color.rgb_to_ycocg_r(rgb))  # (3, T, H, W) int16
    dev = chans.device
    if pf != t:
        chans = chans.index_select(1, _edge_index(t, pf, dev))
    if ph != h:
        chans = chans.index_select(2, _edge_index(h, ph, dev))
    if pw != w:
        chans = chans.index_select(3, _edge_index(w, pw, dev))
    return chans.contiguous()


def _hist_sample(sym2d: torch.Tensor, stride: int) -> torch.Tensor:
    """Row-subsample a (nc, N) symbol plane for histogram building: the
    first 128-lane row of every ``stride`` rows.  Planes smaller than one
    stride block are returned whole.  (The sampled histogram rides the
    wire, so encoder and decoder build the same tables from it.)"""
    if stride <= 1:
        return sym2d
    nc, n = sym2d.shape
    blk = stride * 128
    nb = n // blk
    if nb == 0:
        return sym2d
    s = sym2d[:, : nb * blk].reshape(nc, nb, stride, 128)[:, :, 0, :]
    return s.reshape(nc, nb * 128)


def encode_device(rgb: torch.Tensor, step: int, dead_zone: int, *,
                  wavelet_type: WaveletType, padded, hist_stride: int = 1):
    """Fused encode stage: ``rgb`` uint8 (T, H, W, 3) on the working
    device → ``(symbols (3, P) uint8, histograms (3, 256) int64)``."""
    pw, ph, pf = padded
    chans = _color_pad(rgb, padded)
    sym = forward_quant(chans, wavelet_type, step, dead_zone)
    symbols = sym.reshape(3, pf * ph * pw)
    hists = torch.stack([
        quant.build_histogram(row) for row in _hist_sample(symbols, hist_stride)
    ])
    return symbols, hists


def decode_device(symbols: torch.Tensor, step: torch.Tensor, *,
                  wavelet_type: WaveletType, dims, padded,
                  exact: bool = False) -> torch.Tensor:
    """Fused decode stage: symbols (3, P) uint8 → RGB (T, H, W, 3) uint8.
    ``step``: per-channel (3,) quant steps.  ``exact`` selects the
    exact-undo inverse; the default replays the reference's
    negated-coefficient inverse."""
    w, h, t = dims
    pw, ph, pf = padded
    volume = inverse_dequant(symbols.reshape(3, pf, ph, pw), wavelet_type,
                             step, exact=exact)
    chans = volume[:, :t, :h, :w]
    return color.ycocg_r_to_rgb(chans[0], chans[1], chans[2])


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
