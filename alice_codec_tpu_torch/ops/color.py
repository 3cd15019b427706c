"""YCoCg-R reversible integer color transform (PyTorch port of
``alice_codec_tpu/ops/color.py``; reference src/color.rs:75-112).

    Forward:  Co = R - B;  t = B + (Co >> 1);  Cg = G - t;  Y = t + (Cg >> 1)
    Inverse:  t = Y - (Cg >> 1);  G = Cg + t;  B = t - (Co >> 1);  R = Co + B

All arithmetic is int16 with arithmetic right shifts (``>>`` on a signed
tensor rounds toward -inf, like Rust ``i16``); the inverse clamps to
[0, 255] and casts to uint8.
"""

from __future__ import annotations

import torch

__all__ = ["rgb_to_ycocg_r", "ycocg_r_to_rgb"]


def rgb_to_ycocg_r(rgb: torch.Tensor):
    """RGB (uint8 or int16, shape ``(..., 3)``) → planar (y, co, cg) int16."""
    x = rgb.to(torch.int16)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    co = r - b
    t = b + (co >> 1)
    cg = g - t
    y = t + (cg >> 1)
    return y, co, cg


def ycocg_r_to_rgb(y: torch.Tensor, co: torch.Tensor, cg: torch.Tensor):
    """Planar int16 (y, co, cg) → clamped uint8 RGB, shape ``(..., 3)``."""
    y = y.to(torch.int16)
    co = co.to(torch.int16)
    cg = cg.to(torch.int16)
    t = y - (cg >> 1)
    g = cg + t
    b = t - (co >> 1)
    r = co + b
    return torch.stack([r, g, b], dim=-1).clamp(0, 255).to(torch.uint8)
