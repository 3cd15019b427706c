"""Lossless mode: CDF 5/3 integer lifting with perfect reconstruction
(PyTorch port of ``alice_codec_tpu/lossless.py``; reference src/lossless.rs).

The reference pairs its CDF 5/3 transform with a negated-coefficient
inverse that is only ±1-exact in general; this defaults to the
**exact-undo** inverse so ``verify_roundtrip_*`` holds for *every* input.
Set ``compat=True`` for the reference's arithmetic.  The transforms run on
``device`` (the CUDA card unless given another) through the
reference-layout lifts of :mod:`.ops.wavelet`; NumPy in and out.
"""

from __future__ import annotations

import numpy as np

from .core import WaveletType
from .ops import wavelet as _w

__all__ = [
    "LosslessEncoder",
    "verify_roundtrip_1d",
    "verify_roundtrip_2d",
    "u8_to_i32",
    "i32_to_u8",
]


class LosslessEncoder:
    """CDF 5/3 lossless transform wrapper (reference src/lossless.rs:15-55)."""

    def __init__(self, *, compat: bool = False, device=None):
        self.wavelet = WaveletType.CDF53
        self.exact = not compat
        self._w1 = _w.Wavelet1D(self.wavelet, device=device)
        self._w2 = _w.Wavelet2D.new(self._w1)
        self.device = self._w1.device

    def transform_1d(self, signal) -> np.ndarray:
        return self._w1.forward(signal)

    def inverse_1d(self, signal) -> np.ndarray:
        return self._w1.inverse(signal, exact=self.exact)

    def transform_2d(self, data, width: int | None = None,
                     height: int | None = None) -> np.ndarray:
        return self._w2.forward(data, width, height)

    def inverse_2d(self, data, width: int | None = None,
                   height: int | None = None) -> np.ndarray:
        return self._w2.inverse(data, width, height, exact=self.exact)


def verify_roundtrip_1d(signal, *, device=None) -> bool:
    """Exact 1D roundtrip check (reference src/lossless.rs:61-72)."""
    sig = np.asarray(signal, np.int32)
    if sig.size < 2:
        return True
    enc = LosslessEncoder(device=device)
    return bool(np.array_equal(enc.inverse_1d(enc.transform_1d(sig)), sig))


def verify_roundtrip_2d(data, width: int, height: int, *, device=None) -> bool:
    """Exact 2D roundtrip check (reference src/lossless.rs:76-87)."""
    arr = np.asarray(data, np.int32).reshape(-1)
    if arr.size != width * height or arr.size == 0:
        return arr.size == 0
    enc = LosslessEncoder(device=device)
    out = enc.inverse_2d(enc.transform_2d(arr, width, height), width, height)
    return bool(np.array_equal(out, arr))


def u8_to_i32(buf) -> np.ndarray:
    """u8 → i32 (reference src/lossless.rs:91-94)."""
    return np.asarray(buf, np.uint8).astype(np.int32)


def i32_to_u8(buf) -> np.ndarray:
    """i32 → u8 with clamp (reference src/lossless.rs:97-99)."""
    return np.clip(np.asarray(buf, np.int32), 0, 255).astype(np.uint8)
