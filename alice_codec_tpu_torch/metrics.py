"""Quality metrics: MSE / PSNR (PyTorch port of ``alice_codec_tpu/metrics.py``;
reference src/metrics.rs).

Host functions (``mse`` / ``psnr``) are f64 NumPy, copied from the JAX
package, for bit-parity with the reference.  The device functions
(``mse_device`` / ``psnr_device``) are torch reductions on the device of
the tensors they are given, accumulating in f32 as the JAX package's do
(differences are < 1e-4 dB at video scales).
"""

from __future__ import annotations

import numpy as np
import torch

from .errors import InvalidBufferSize

__all__ = ["mse", "psnr", "mse_device", "psnr_device"]


def mse(a, b) -> float:
    """Mean squared error between two byte buffers (src/metrics.rs:16-35)."""
    a = np.asarray(a).reshape(-1)
    b = np.asarray(b).reshape(-1)
    if a.size != b.size:
        raise InvalidBufferSize(a.size, b.size)
    if a.size == 0:
        return 0.0
    diff = a.astype(np.float64) - b.astype(np.float64)
    return float(np.mean(diff * diff))


def psnr(a, b) -> float:
    """Peak signal-to-noise ratio in dB; inf when identical (src/metrics.rs:57-63)."""
    m = mse(a, b)
    if m == 0.0:
        return float("inf")
    return 10.0 * float(np.log10(255.0 * 255.0 / m))


def mse_device(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Device MSE over the full tensor (f32 accumulation), a 0-d tensor."""
    diff = a.to(torch.float32) - b.to(torch.float32)
    return torch.mean(diff * diff)


def psnr_device(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Device PSNR in dB; inf when identical (a 0-d f32 tensor)."""
    m = mse_device(a, b)
    db = 10.0 * torch.log10(255.0 * 255.0 / torch.clamp(m, min=1e-30))
    return torch.where(m == 0.0, torch.full_like(m, float("inf")), db)
