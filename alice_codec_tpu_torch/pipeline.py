"""Device stages of the dense ALC3 path (PyTorch port of the
interleaved, single-level fused branch of ``alice_codec_tpu/pipeline.py``)
and the per-plane container header.

* encode: uint8 RGB (T, H, W, 3) → YCoCg-R → edge pad to even dims
  (int16) → fused lift + quantize + zigzag kernel → uint8 symbols
  (3, P) and row-sampled 256-bin histograms;
* decode: symbols (3, P) → fused dequantize + inverse lift kernel →
  crop → inverse YCoCg-R → uint8 RGB;
* sparse phase 1: the encode stage over the channels that carry nonzero
  colour only, with the value rows each needs (the zero-channel elision
  of the JAX package's ``encode_sparse_phase1``).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np
import torch

from .core import WaveletType
from .ops import color, quant
from .ops.kernels.lift import forward_quant, inverse_dequant
from .ops.kernels.sparse import tile_rows

__all__ = ["ChannelHeader", "encode_device", "decode_device",
           "encode_sparse_phase1"]

# The tile budgets of the JAX package's Pallas lift kernels
# (lift_kernels.py:66-73): they decide which shapes its sparse phase 1
# reports per-channel colour flags for (see _tpu_fused).
_TILE_BYTES = 6 * 1024 * 1024
_FRAME_BYTES = 9 * 1024 * 1024


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
                  exact: bool = False, active=None) -> torch.Tensor:
    """Fused decode stage: symbols (3, P) uint8 → RGB (T, H, W, 3) uint8.
    ``step``: per-channel (3,) quant steps.  ``exact`` selects the
    exact-undo inverse; the default replays the reference's
    negated-coefficient inverse.

    ``active``: the channels that may carry nonzero symbols.  An all-zero
    channel inverse-lifts to exact zeros, so only the active ones go
    through the kernel and the rest are zeros (bit-exact)."""
    w, h, t = dims
    pw, ph, pf = padded
    sym4 = symbols.reshape(3, pf, ph, pw)
    act = (0, 1, 2) if active is None else tuple(sorted(active))
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
    return color.ycocg_r_to_rgb(chans[0], chans[1], chans[2])


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
    """Whether the JAX package runs its fused Pallas lift for a padded
    (pW, pH, pT) volume of int16 coefficients (lift_kernels.lift3d_ok).
    Only there does its sparse phase 1 report which channels are zero;
    elsewhere it reports all three as nonzero, and the capacity caches
    of the codec see the difference, so the port follows it."""
    w, h, t = padded
    if t % 2 or h % 2 or w % 2:
        return False
    if _pick_tile(h, max(1, _TILE_BYTES // (t * w * 4))) < 1:
        return False
    if h * w * 2 <= _FRAME_BYTES:
        return True
    return (_pick_tile(h, max(1, _TILE_BYTES // (w * 4))) >= 8
            and _pick_tile(w, max(1, _TILE_BYTES // (h * 4))) >= 128)


def encode_sparse_phase1(rgb: torch.Tensor, step: int, dead_zone: int, *,
                         wavelet_type: WaveletType, padded, pp: int,
                         active=(0, 1, 2)):
    """Sparse phase 1: colour + pad, then the fused lift + quantize
    kernel over the ``active`` channels only (a channel whose colour
    plane is all zero gives all-zero symbols, so skipping it is
    bit-exact).  Returns ``(symbols (na, pp) uint8 — padded with zeros
    to ``pp``, trows (na, pp/1024) int32 — the value rows of each tile
    (:func:`~.ops.kernels.sparse.tile_rows`), flags (3,) bool — which
    colour planes are nonzero, regardless of ``active``)``."""
    pw, ph, pf = padded
    active = tuple(sorted(active))
    chans = _color_pad(rgb, padded)
    if _tpu_fused(padded):
        flags = (chans.reshape(3, -1) != 0).any(1)
    else:
        flags = torch.ones(3, dtype=torch.bool, device=chans.device)
    if active != (0, 1, 2):
        chans = chans[torch.tensor(active, device=chans.device)]
    symbols = forward_quant(chans, wavelet_type, step, dead_zone).reshape(
        len(active), pf * ph * pw)
    symbols = torch.nn.functional.pad(symbols, (0, pp - pf * ph * pw))
    return symbols, tile_rows(symbols), flags


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
