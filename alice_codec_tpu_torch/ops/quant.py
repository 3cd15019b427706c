"""Dead-zone quantization, zigzag symbols, histograms and the
closed-form RDO (PyTorch port of ``alice_codec_tpu/ops/quant.py``;
reference src/quant.rs:89-110, 377-505, 547-600).

Device functions take tensors; :class:`AnalyticalRDO` is host float
code, a verbatim copy of the JAX package's, so both packages pick the
same per-band steps from the same moments.  The scalar and NumPy
quantizers (:class:`Quantizer`, :class:`FastQuantizer`,
:func:`quantize_subband`, :func:`dequantize_subband`) are host code,
copied too.

Per-band functions work on the INTERLEAVED single-level layout: the band
of a coefficient is its index parity (bit y = h&1, x = w&1, t = t&1,
index ``y·4 + x·2 + t`` — :class:`~..core.SubBand3D` order).  A
``(..., T, H, W)`` volume viewed as ``(..., T/2, 2, H/2, 2, W/2, 2)``
puts the parities on their own axes, so per-band values broadcast with
no mask and no gather.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core import SubBand3D
from ..errors import InvalidQuantStep

__all__ = ["quantize", "dequantize", "to_symbols", "from_symbols",
           "to_symbols16", "from_symbols16", "build_histogram",
           "band_index_inter", "quantize_bands_inter",
           "dequantize_bands_inter", "band_moments_inter", "Quantizer",
           "FastQuantizer", "AnalyticalRDO", "quantize_subband",
           "dequantize_subband"]


def quantize(values: torch.Tensor, step, dead_zone) -> torch.Tensor:
    """Dead-zone quantize integer coefficients → int32.

    values in (-dead_zone, dead_zone) → 0; otherwise
    ``sign(v) * ((|v| - dead_zone/2) // step)`` (non-negative numerator,
    so floor equals the reference's truncation).  ``step`` and
    ``dead_zone``: scalars or int32 tensors that broadcast against
    ``values`` (per channel, or per element)."""
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


def to_symbols16(coeffs: torch.Tensor) -> torch.Tensor:
    """16-bit zigzag (ALC3 deep mode): :func:`to_symbols` without the u8
    wrap, so any |q| ≤ 32767 survives.  Returns int32 in [0, 65535]."""
    c = coeffs.to(torch.int32)
    s = torch.where(c > 0, 2 * c - 1, -2 * c)
    return s & 0xFFFF


def from_symbols16(symbols: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`to_symbols16` → int32."""
    return from_symbols(symbols)


def build_histogram(symbols: torch.Tensor) -> torch.Tensor:
    """256-bin histogram of byte symbols over all elements, int64 (the
    JAX package returns uint32; the counts are equal).  uint8 symbols on
    the card go through the plane-statistics kernel
    (``ops/kernels/hist.py``), one launch."""
    if symbols.is_cuda and symbols.dtype == torch.uint8:
        from .kernels.hist import plane_stats  # ops.kernels imports this module
        return plane_stats([symbols.reshape(-1)])[0][0]
    return torch.bincount(symbols.reshape(-1).to(torch.int64), minlength=256)


# ── per-band primitives (AnalyticalRDO's device half) ───────────


def band_index_inter(vol_shape) -> torch.Tensor:
    """Per-element SubBand3D index of a (T, H, W) interleaved volume:
    ``(h&1)·4 + (w&1)·2 + (t&1)``, int32."""
    t, h, w = vol_shape[-3:]
    it = torch.arange(t, dtype=torch.int32).view(t, 1, 1) & 1
    ih = torch.arange(h, dtype=torch.int32).view(1, h, 1) & 1
    iw = torch.arange(w, dtype=torch.int32).view(1, 1, w) & 1
    return (ih * 4 + iw * 2 + it).expand(t, h, w).contiguous()


def _parity_view(x: torch.Tensor) -> torch.Tensor:
    """(..., T, H, W) → (..., T/2, 2, H/2, 2, W/2, 2), a view."""
    t, h, w = x.shape[-3:]
    return x.reshape(*x.shape[:-3], t // 2, 2, h // 2, 2, w // 2, 2)


def _band_values(values8, like: torch.Tensor) -> torch.Tensor:
    """(..., 8) per-band int32 values (SubBand3D order) → a tensor that
    broadcasts against ``_parity_view(like)``: (..., 1, 2t, 1, 2y, 1, 2x)."""
    v = torch.as_tensor(values8, dtype=torch.int32, device=like.device)
    lead = v.shape[:-1]
    v = v.reshape(*lead, 2, 2, 2)            # (..., y, x, t)
    v = v.movedim(-1, -3)                    # (..., t, y, x)
    return v.reshape(*lead, 1, 2, 1, 2, 1, 2)


def quantize_bands_inter(coeffs: torch.Tensor, steps8, dead_zones8
                         ) -> torch.Tensor:
    """Dead-zone quantize an interleaved (..., T, H, W) volume with
    per-band ``steps8`` / ``dead_zones8`` (..., 8) → int32 (the JAX
    package's quantize_bands_inter)."""
    q = quantize(_parity_view(coeffs), _band_values(steps8, coeffs),
                 _band_values(dead_zones8, coeffs))
    return q.reshape(coeffs.shape)


def dequantize_bands_inter(qcoeffs: torch.Tensor, steps8) -> torch.Tensor:
    """Inverse of :func:`quantize_bands_inter`: per-band ``q · step``."""
    x = _parity_view(qcoeffs.to(torch.int32)) * _band_values(steps8, qcoeffs)
    return x.reshape(qcoeffs.shape)


def band_moments_inter(coeffs: torch.Tensor):
    """Exact per-band integer moments of an interleaved (..., T, H, W)
    volume: ``(s1, s2)``, each (..., 8) int64 — the sum and the sum of
    squares of each band (order-independent integer sums, so equal to the
    JAX package's masked sums)."""
    lead = coeffs.shape[:-3]
    c = _parity_view(coeffs).to(torch.int64)
    axes = (-6, -4, -2)
    s1 = c.sum(dim=axes)                      # (..., t, y, x)
    s2 = (c * c).sum(dim=axes)
    s1 = s1.movedim(-3, -1).reshape(*lead, 8)  # (..., y, x, t)
    s2 = s2.movedim(-3, -1).reshape(*lead, 8)
    return s1, s2


# ── host quantizers and RDO (verbatim copies of the JAX package's) ──


class Quantizer:
    """Dead-zone quantizer (reference src/quant.rs:57-146).

    >>> q = Quantizer(8)
    >>> q.quantize(20)
    2
    >>> q.dequantize(2)
    16
    """

    __slots__ = ("step", "dead_zone")

    def __init__(self, step: int, dead_zone: int | None = None):
        self.step = int(step)
        self.dead_zone = int(step if dead_zone is None else dead_zone)

    @classmethod
    def with_dead_zone(cls, step: int, dead_zone: int) -> "Quantizer":
        return cls(step, dead_zone)

    def quantize(self, value: int) -> int:
        av = abs(value)
        if av < self.dead_zone:
            return 0
        q = (av - (self.dead_zone >> 1)) // self.step
        return -q if value < 0 else q

    def dequantize(self, qvalue: int) -> int:
        return 0 if qvalue == 0 else qvalue * self.step

    def quantize_buffer(self, values: np.ndarray) -> np.ndarray:
        """Vectorized NumPy quantize (reference src/quant.rs:117-128)."""
        v = np.asarray(values, np.int32)
        av = np.abs(v)
        q = (av - (self.dead_zone >> 1)) // np.int32(self.step)
        return np.where(av < self.dead_zone, 0, np.sign(v) * q).astype(np.int32)

    def dequantize_buffer(self, qvalues: np.ndarray) -> np.ndarray:
        return (np.asarray(qvalues, np.int32) * np.int32(self.step)).astype(np.int32)

    def __repr__(self) -> str:  # pragma: no cover
        return f"Quantizer(step={self.step}, dead_zone={self.dead_zone})"


class FastQuantizer:
    """Magic-number-division quantizer (reference src/quant.rs:171-332).

    Precomputes ``reciprocal = ceil(2^(32+extra) / step)`` and divides via a
    64-bit multiply + shift.  Bit-identical to :class:`Quantizer` for all
    inputs (the round-up magic is exact for u32 dividends).
    """

    __slots__ = ("reciprocal", "shift", "step", "dead_zone")

    def __init__(self, step: int, dead_zone: int | None = None):
        step = int(step)
        if step <= 0:
            raise InvalidQuantStep(step)
        # extra_bits = 32 - leading_zeros(step as u32) = floor(log2(step)) + 1
        extra_bits = step.bit_length()
        self.shift = 32 + extra_bits
        power = 1 << self.shift
        self.reciprocal = (power + step - 1) // step  # ceil division
        self.step = step
        self.dead_zone = int(step if dead_zone is None else dead_zone)

    @classmethod
    def with_dead_zone(cls, step: int, dead_zone: int) -> "FastQuantizer":
        return cls(step, dead_zone)

    def _fast_div(self, x: int) -> int:
        return ((x * self.reciprocal) >> self.shift) & 0xFFFFFFFF

    def quantize(self, value: int) -> int:
        av = abs(value)
        if av < self.dead_zone:
            return 0
        adjusted = (av - (self.dead_zone >> 1)) & 0xFFFFFFFF
        q_abs = self._fast_div(adjusted)
        return -q_abs if value < 0 else q_abs

    def dequantize(self, qvalue: int) -> int:
        return 0 if qvalue == 0 else qvalue * self.step

    def quantize_buffer(self, values: np.ndarray) -> np.ndarray:
        """Vectorized magic-number quantize in uint64 NumPy."""
        v = np.asarray(values, np.int64)
        av = np.abs(v)
        adjusted = (av - (self.dead_zone >> 1)).astype(np.uint64)
        prod = adjusted * np.uint64(self.reciprocal)
        # reciprocal < 2^34 and adjusted < 2^32 can overflow u64 for huge
        # inputs; real coefficient magnitudes keep the product in range
        # exactly as the reference's u64 arithmetic does.
        q = (prod >> np.uint64(self.shift)).astype(np.int64)
        out = np.where(av < self.dead_zone, 0, np.sign(v) * q)
        return out.astype(np.int32)

    def dequantize_buffer(self, qvalues: np.ndarray) -> np.ndarray:
        return (np.asarray(qvalues, np.int32) * np.int32(self.step)).astype(np.int32)

    def __repr__(self) -> str:  # pragma: no cover
        return f"FastQuantizer(step={self.step}, dead_zone={self.dead_zone})"



class AnalyticalRDO:
    """Closed-form rate-distortion optimizer (reference src/quant.rs:377-505).

    λ_optimal = 6·ln(2)·σ² / R_target;  step = round(sqrt(12·λ)), scaled per
    sub-band by its quantization strength, with dead-zone = 1.5×step.
    """

    __slots__ = ("target_bpp", "quality")

    def __init__(self, target_bpp: float, quality: int = 75):
        self.target_bpp = float(target_bpp)
        self.quality = quality

    @classmethod
    def with_quality(cls, quality: int) -> "AnalyticalRDO":
        """Quality → approximate bpp: (q/100)²·23.9 + 0.1 (src/quant.rs:398-412)."""
        quality = min(int(quality), 100)
        q = quality / 100.0
        # Rust's f64::mul_add is a fused multiply-add; math.fma exists on
        # 3.13+, otherwise the unfused form differs by at most 1 ulp.
        fma = getattr(math, "fma", None)
        bpp = fma(q * q, 23.9, 0.1) if fma else q * q * 23.9 + 0.1
        return cls(bpp, quality)

    @staticmethod
    def estimate_variance(coeffs) -> float:
        """Population variance in f64, floored at 1.0 (src/quant.rs:415-435)."""
        c = np.asarray(coeffs, np.int64)
        if c.size == 0:
            return 1.0
        inv_n = 1.0 / float(c.size)
        mean = float(c.sum()) * inv_n
        var = float(((c.astype(np.float64) - mean) ** 2).sum()) * inv_n
        return max(var, 1.0)

    def compute_optimal_lambda(self, variance: float) -> float:
        return (6.0 * math.log(2.0) * variance) / self.target_bpp

    def lambda_to_step(self, lam: float) -> int:
        # libm::round rounds half away from zero, unlike Python's round().
        step = math.sqrt(12.0 * lam)
        return max(int(math.floor(step + 0.5)), 1)

    def compute_quantizer(self, coeffs, subband: SubBand3D) -> Quantizer:
        variance = self.estimate_variance(coeffs)
        lam = self.compute_optimal_lambda(variance)
        base_step = self.lambda_to_step(lam)
        step = max(base_step * subband.quant_strength, 1)
        dead_zone = step + step // 2
        return Quantizer.with_dead_zone(step, dead_zone)

    def compute_all_quantizers(self, subbands) -> list[Quantizer]:
        """Quantizers for the 8 sub-bands of a 3D decomposition (src/quant.rs:472-490)."""
        return [
            self.compute_quantizer(coeffs, band)
            for coeffs, band in zip(subbands, SubBand3D, strict=True)
        ]

    @staticmethod
    def variance_from_moments(n: int, s1: int, s2: int) -> float:
        """Population variance from exact integer moments, floored at 1.0:
        ``var = (s2 - s1²/n) / n`` in f64."""
        if n == 0:
            return 1.0
        mean = s1 / n
        var = s2 / n - mean * mean
        return max(var, 1.0)

    def step_from_moments(self, n: int, s1: int, s2: int,
                          subband: SubBand3D) -> tuple[int, int]:
        """(step, dead_zone) for one band from its moments
        (src/quant.rs:472-490 composition, dead_zone = 1.5×step)."""
        var = self.variance_from_moments(n, s1, s2)
        base_step = self.lambda_to_step(self.compute_optimal_lambda(var))
        step = max(base_step * subband.quant_strength, 1)
        return step, step + step // 2

    def steps_from_moments(self, n: int, s1_8, s2_8) -> tuple[np.ndarray, np.ndarray]:
        """Per-band (steps, dead_zones) int32 (8,) arrays from
        :func:`band_moments_inter` output for one channel; ``n`` is the
        per-band element count (volume size // 8)."""
        steps = np.empty(8, np.int32)
        dzs = np.empty(8, np.int32)
        for band in SubBand3D:
            s, d = self.step_from_moments(
                n, int(s1_8[int(band)]), int(s2_8[int(band)]), band
            )
            steps[int(band)] = s
            dzs[int(band)] = d
        return steps, dzs


def quantize_subband(coeffs, quantizer: Quantizer) -> np.ndarray:
    """Quantize sub-band coefficients (reference src/quant.rs:518-524)."""
    return quantizer.quantize_buffer(coeffs)


def dequantize_subband(coeffs, quantizer: Quantizer) -> np.ndarray:
    """Dequantize sub-band coefficients (reference src/quant.rs:531-537)."""
    return quantizer.dequantize_buffer(coeffs)
