"""SSIM / MS-SSIM quality metrics (PyTorch port of ``alice_codec_tpu/ssim.py``;
reference src/ssim.rs).

8×8-block SSIM with unbiased (n-1) variances, C1=6.5025, C2=58.5225;
MS-SSIM over 3 scales with ~equal weights, 2×2 average-pool downsampling and
early exit when a scale drops below 8 px (remaining weights assigned to the
current scale) — all per reference src/ssim.rs:12-202.

The host path is vectorized f64 NumPy, copied from the JAX package;
``ssim_device`` / ``ms_ssim_device`` are f32 torch versions on ``(..., H,
W)`` tensors, computed on the device of the tensors they are given.  Each
keeps its own clamp of the log (the host one takes ``-inf`` at 0, the
device one clamps at 1e-30), as the JAX package does.
"""

from __future__ import annotations

import numpy as np
import torch

from .errors import InvalidBufferSize

__all__ = ["ssim", "ms_ssim", "ssim_device", "ms_ssim_device"]

C1 = 6.5025  # (0.01 * 255)^2
C2 = 58.5225  # (0.03 * 255)^2
_BLOCK = 8


def _blocks(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """Extract all full 8×8 blocks → (n_blocks, 64) f64."""
    bh, bw = height // _BLOCK, width // _BLOCK
    img = img.reshape(height, width)[: bh * _BLOCK, : bw * _BLOCK]
    blk = img.reshape(bh, _BLOCK, bw, _BLOCK).transpose(0, 2, 1, 3)
    return blk.reshape(bh * bw, _BLOCK * _BLOCK).astype(np.float64)


def _validate(a: np.ndarray, b: np.ndarray, width: int, height: int) -> None:
    if a.size != b.size:
        raise InvalidBufferSize(a.size, b.size)
    if a.size != width * height:
        raise InvalidBufferSize(width * height, a.size)


def ssim(a, b, width: int, height: int) -> float:
    """Mean SSIM over 8×8 blocks (reference src/ssim.rs:63-115)."""
    a = np.asarray(a, np.uint8).reshape(-1)
    b = np.asarray(b, np.uint8).reshape(-1)
    _validate(a, b, width, height)
    if a.size == 0:
        return 1.0
    if height < _BLOCK or width < _BLOCK:
        return 1.0  # zero blocks → 1.0 (src/ssim.rs:108-110)
    ba, bb = _blocks(a, width, height), _blocks(b, width, height)
    n = float(_BLOCK * _BLOCK)
    mu_a = ba.mean(axis=1)
    mu_b = bb.mean(axis=1)
    da = ba - mu_a[:, None]
    db = bb - mu_b[:, None]
    denom = n - 1.0
    sig_a = (da * da).sum(axis=1) / denom
    sig_b = (db * db).sum(axis=1) / denom
    sig_ab = (da * db).sum(axis=1) / denom
    num = (2.0 * mu_a * mu_b + C1) * (2.0 * sig_ab + C2)
    den = (mu_a * mu_a + mu_b * mu_b + C1) * (sig_a + sig_b + C2)
    return float((num / den).mean())


def _downsample_2x(buf: np.ndarray, width: int, height: int) -> np.ndarray:
    """2×2 average pool with integer (u16) truncating divide (src/ssim.rs:186-202)."""
    nh, nw = height // 2, width // 2
    img = buf.reshape(height, width)[: nh * 2, : nw * 2].astype(np.uint16)
    pooled = (
        img[0::2, 0::2] + img[0::2, 1::2] + img[1::2, 0::2] + img[1::2, 1::2]
    ) // 4
    return pooled.astype(np.uint8).reshape(-1)


def ms_ssim(a, b, width: int, height: int) -> float:
    """Multi-scale SSIM, 3 scales (reference src/ssim.rs:125-183)."""
    a = np.asarray(a, np.uint8).reshape(-1)
    b = np.asarray(b, np.uint8).reshape(-1)
    _validate(a, b, width, height)
    if a.size == 0:
        return 1.0

    weights = [0.3333, 0.3333, 0.3334]
    cur_a, cur_b, cur_w, cur_h = a, b, width, height
    result = 0.0
    for i, weight in enumerate(weights):
        s = ssim(cur_a, cur_b, cur_w, cur_h)
        log_s = max(np.log(max(s, 0.0)) if s > 0 else -np.inf, -10.0)
        result += weight * log_s
        new_w, new_h = cur_w // 2, cur_h // 2
        if new_w < _BLOCK or new_h < _BLOCK:
            for w2 in weights[i + 1 :]:
                result += w2 * log_s
            break
        cur_a = _downsample_2x(cur_a, cur_w, cur_h)
        cur_b = _downsample_2x(cur_b, cur_w, cur_h)
        cur_w, cur_h = new_w, new_h
    return float(np.exp(result))


# ── Device (torch, f32) versions ────────────────────────────────


def ssim_device(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean 8×8-block SSIM of ``(..., H, W)`` tensors → f32 of shape
    ``(...)``; a 0-d 1.0 when the frame holds no full block."""
    h, w = a.shape[-2], a.shape[-1]
    bh, bw = h // _BLOCK, w // _BLOCK
    if bh == 0 or bw == 0:
        return torch.tensor(1.0, dtype=torch.float32, device=a.device)

    def blocks(x):
        x = x[..., : bh * _BLOCK, : bw * _BLOCK].to(torch.float32)
        x = x.reshape(*x.shape[:-2], bh, _BLOCK, bw, _BLOCK)
        x = x.transpose(-3, -2)
        return x.reshape(*x.shape[:-4], bh * bw, _BLOCK * _BLOCK)

    ba, bb = blocks(a), blocks(b)
    n = float(_BLOCK * _BLOCK)
    mu_a = ba.mean(dim=-1, keepdim=True)
    mu_b = bb.mean(dim=-1, keepdim=True)
    da, db = ba - mu_a, bb - mu_b
    denom = n - 1.0
    sig_a = (da * da).sum(dim=-1) / denom
    sig_b = (db * db).sum(dim=-1) / denom
    sig_ab = (da * db).sum(dim=-1) / denom
    mu_a, mu_b = mu_a[..., 0], mu_b[..., 0]
    num = (2.0 * mu_a * mu_b + C1) * (2.0 * sig_ab + C2)
    den = (mu_a * mu_a + mu_b * mu_b + C1) * (sig_a + sig_b + C2)
    return (num / den).mean(dim=-1)


def _pool_2x(x: torch.Tensor, nh: int, nw: int) -> torch.Tensor:
    """The JAX package's uint16 2×2 pool, in int32 (torch's uint16 has few
    ops): equal for inputs in [0, 255]."""
    x = x[..., : nh * 2, : nw * 2].to(torch.int32)
    p = (x[..., 0::2, 0::2] + x[..., 0::2, 1::2]
         + x[..., 1::2, 0::2] + x[..., 1::2, 1::2]) // 4
    return p.to(torch.uint8)


def ms_ssim_device(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """3-scale MS-SSIM of ``(..., H, W)`` tensors (f32)."""
    weights = (0.3333, 0.3333, 0.3334)
    result = torch.tensor(0.0, dtype=torch.float32, device=a.device)
    cur_a, cur_b = a, b
    h, w = a.shape[-2], a.shape[-1]
    for i, weight in enumerate(weights):
        s = ssim_device(cur_a, cur_b)
        log_s = torch.clamp(torch.log(torch.clamp(s, min=1e-30)), min=-10.0)
        result = result + weight * log_s
        nw, nh = w // 2, h // 2
        if nw < _BLOCK or nh < _BLOCK:
            for w2 in weights[i + 1 :]:
                result = result + w2 * log_s
            break
        cur_a, cur_b = _pool_2x(cur_a, nh, nw), _pool_2x(cur_b, nh, nw)
        h, w = nh, nw
    return torch.exp(result)
