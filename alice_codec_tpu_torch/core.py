"""Core enums and shape rules of the ALICE codec (PyTorch port).

A copy of the pieces of ``alice_codec_tpu/core.py`` the dense ALC3 path
needs, kept here so the port never imports the JAX package:

* ``WaveletType``    — reference src/pipeline.rs:34-62
* quality → quantization-step mapping — reference src/pipeline.rs:452-457
* even-dimension padding rules — reference src/pipeline.rs:437-440, 547-550
"""

from __future__ import annotations

import enum

from .errors import DimensionOverflow, InvalidBitstream

#: Maximum value of the reference's usize (64-bit) used by the checked
#: dimension multiplication (reference: src/pipeline.rs:67-71).
_USIZE_MAX = (1 << 64) - 1


class WaveletType(enum.IntEnum):
    """Wavelet filter used by the pipeline (reference: src/pipeline.rs:34-41)."""

    CDF53 = 0  # lossless-capable, default
    CDF97 = 1  # better lossy compression
    HAAR = 2   # fastest

    @classmethod
    def from_u8(cls, v: int) -> "WaveletType":
        """Parse the wavelet byte of a container header (reference: src/pipeline.rs:52-62)."""
        if v in (0, 1, 2):
            return cls(v)
        raise InvalidBitstream(f"unknown wavelet type byte: {v}")

    @classmethod
    def from_name(cls, name: str) -> "WaveletType":
        """Parse the user-facing wavelet name (reference: src/python.rs:381-390)."""
        try:
            return _WAVELET_NAMES[name]
        except KeyError:
            raise ValueError(
                f"unknown wavelet type '{name}'; expected 'cdf53', 'cdf97', or 'haar'"
            ) from None

    @property
    def name_str(self) -> str:
        return ("cdf53", "cdf97", "haar")[int(self)]


_WAVELET_NAMES = {
    "cdf53": WaveletType.CDF53,
    "cdf97": WaveletType.CDF97,
    "haar": WaveletType.HAAR,
}


def quality_to_step(quality: int) -> int:
    """Map quality 0-100 to the pipeline's global quantization step.

    quality 100 → step 1 (near-lossless); quality 0 → step 64.
    Reference: src/pipeline.rs:452-457 (``(64 - q.min(100)*63/100).max(1)``).
    """
    q = min(int(quality), 100)
    return max(64 - (q * 63) // 100, 1)


def checked_pixel_count(w: int, h: int, f: int) -> int:
    """Checked ``w*h*f`` mirroring the reference's usize overflow check.

    Reference: src/pipeline.rs:67-71.
    """
    n = w * h
    if n > _USIZE_MAX:
        raise DimensionOverflow()
    n *= f
    if n > _USIZE_MAX:
        raise DimensionOverflow()
    return n


def padded_dims(w: int, h: int, f: int) -> tuple[int, int, int]:
    """Pad (w, h, f) to even sizes per the pipeline's rules.

    Width and height are padded to even by +1; a single frame is padded to
    two, otherwise frames are padded to even.
    Reference: src/pipeline.rs:437-440 (encode) and :547-550 (decode).
    """
    padded_f = 2 if f == 1 else f + (f & 1)
    return w + (w & 1), h + (h & 1), padded_f


def padded_dims_levels(w: int, h: int, f: int, levels: int) -> tuple[int, int, int]:
    """Pad (w, h, f) for an L-level dyadic decomposition: every dim rounds
    up to a multiple of ``2**levels`` (reduces to :func:`padded_dims` at
    levels=1)."""
    if levels <= 1:
        return padded_dims(w, h, f)
    m = 1 << levels
    rup = lambda v: -(-v // m) * m  # noqa: E731
    return rup(w), rup(h), rup(max(f, 2))
