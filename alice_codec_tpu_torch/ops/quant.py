"""Dead-zone quantization, zigzag symbols and histograms (PyTorch port
of the device primitives of ``alice_codec_tpu/ops/quant.py``;
reference src/quant.rs:89-110, 547-600)."""

from __future__ import annotations

import torch

__all__ = ["quantize", "dequantize", "to_symbols", "from_symbols",
           "build_histogram"]


def quantize(values: torch.Tensor, step, dead_zone) -> torch.Tensor:
    """Dead-zone quantize integer coefficients → int32.

    values in (-dead_zone, dead_zone) → 0; otherwise
    ``sign(v) * ((|v| - dead_zone/2) // step)`` (non-negative numerator,
    so floor equals the reference's truncation)."""
    v = values.to(torch.int32)
    av = v.abs()
    q = torch.div(av - (dead_zone >> 1), step, rounding_mode="floor")
    return torch.where(av < dead_zone, 0, torch.sign(v) * q).to(torch.int32)


def dequantize(qvalues: torch.Tensor, step) -> torch.Tensor:
    """Inverse of :func:`quantize`: ``q * step`` in int32."""
    return qvalues.to(torch.int32) * step


def to_symbols(coeffs: torch.Tensor) -> torch.Tensor:
    """Zigzag signed → uint8 symbols: 0→0, n→2n-1, -n→2n, keeping the
    reference's ``as u8`` wrap for |2q| > 255 (mod-256 truncation)."""
    c = coeffs.to(torch.int32)
    s = torch.where(c > 0, 2 * c - 1, -2 * c)
    return (s & 0xFF).to(torch.uint8)


def from_symbols(symbols: torch.Tensor) -> torch.Tensor:
    """Inverse zigzag → int32: odd s → (s+1)/2, even s → -(s/2)."""
    s = symbols.to(torch.int32)
    return torch.where(s % 2 == 1, (s + 1) // 2, -(s // 2))


def build_histogram(symbols: torch.Tensor) -> torch.Tensor:
    """256-bin histogram of byte symbols over all elements, int64 (the
    JAX package returns uint32; the counts are equal)."""
    return torch.bincount(symbols.reshape(-1).to(torch.int64), minlength=256)
