"""The one generator of the benchmark's traffic: a pool of synthetic
colour video chunks made on the device from a seed.

Every mix file in this folder names this module (``"generator"``) and
gives its parameters under ``"content"``.  A pool holds ``pool``
consecutive chunks of one video (chunk i is frames [i·T, (i+1)·T)); each
chunk's random draws come from a ``torch.Generator`` seeded from the run's
seed and the chunk's index, so one seed gives the same pool every run and
every seed gives the same sizes and statistics.

The frame formula is ``bench._test_chunk``'s, rewritten in torch:

* a moving luminance gradient ``(x·gx + y·gy + t·gt) % 256``;
* sensor noise, uniform in [0, noise_max], the same on all three channels;
* a colour field: one random offset per channel in [-color_amp,
  color_amp] for each ``color_block``-pixel × ``color_tblock``-frame block;

summed and clipped to [0, 255].  With ``freeze_background`` the gradient
and the colour field stay as they are at t = 0 (a fixed camera on a still
scene) and only the noise changes per frame.  ``region``, where given,
pastes a textured ``size``-pixel square (the gradient and colour field of
its own, with a fixed texture noise in [0, region.noise_max]) that moves
``speed`` pixels a frame to the right from a start drawn from the seed,
wrapping round the frame.
"""

from __future__ import annotations

import torch

__all__ = ["make_pool", "chunk_seed", "CONTENT_KEYS"]

_MASK63 = (1 << 63) - 1

#: the content parameters this generator reads; any other is refused
CONTENT_KEYS = frozenset({"gradient", "noise_max", "color_block", "color_tblock",
                          "color_amp", "freeze_background", "region"})
_REGION_KEYS = frozenset({"size", "speed", "noise_max"})


def chunk_seed(seed: int, index: int) -> int:
    """The generator seed of pool chunk ``index`` (any integer seed)."""
    return (int(seed) * 1_000_003 + 7919 * (index + 1)) & _MASK63


def _gen(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def _color_field(g, frames, h, w, block, tblock, amp, device):
    """(T, H, W, 3) int16 piecewise-constant colour offsets."""
    gt, gh, gw = -(-frames // tblock), -(-h // block), -(-w // block)
    field = torch.randint(-amp, amp + 1, (gt, gh, gw, 3), generator=g,
                          device=device, dtype=torch.int16)
    return (field.repeat_interleave(tblock, 0)[:frames]
            .repeat_interleave(block, 1)[:, :h]
            .repeat_interleave(block, 2)[:, :, :w])


def _gradient(t0, frames, h, w, slopes, device) -> torch.Tensor:
    """(T, H, W, 1) int16 gradient of absolute frames t0 .. t0+T-1."""
    gx, gy, gt = slopes
    x = torch.arange(w, device=device, dtype=torch.int32)[None, None, :, None]
    y = torch.arange(h, device=device, dtype=torch.int32)[None, :, None, None]
    tt = torch.arange(t0, t0 + frames, device=device,
                      dtype=torch.int32)[:, None, None, None]
    return ((x * gx + y * gy + tt * gt) % 256).to(torch.int16)


def _chunk(content: dict, index: int, seed: int, frames: int, h: int, w: int,
           device) -> torch.Tensor:
    g = _gen(chunk_seed(seed, index), device)
    slopes = content["gradient"]
    frozen = bool(content.get("freeze_background", False))
    t0 = index * frames
    if frozen:
        # the scene at t = 0, the same in every chunk of the pool
        g0 = _gen(chunk_seed(seed, -1), device)
        base = _gradient(0, 1, h, w, slopes, device)
        color = _color_field(g0, 1, h, w, content["color_block"],
                             content["color_tblock"], content["color_amp"], device)
        frame = base + color
        frame = frame.expand(frames, h, w, 3)
    else:
        base = _gradient(t0, frames, h, w, slopes, device)
        color = _color_field(g, frames, h, w, content["color_block"],
                             content["color_tblock"], content["color_amp"], device)
        frame = base + color
    noise = torch.randint(0, content["noise_max"] + 1, (frames, h, w, 1),
                          generator=g, device=device, dtype=torch.int16)
    out = frame + noise
    region = content.get("region")
    if region:
        out = out.contiguous()
        _paste_region(out, region, content, seed, t0, device)
    return out.clamp_(0, 255).to(torch.uint8)


def _paste_region(out, region: dict, content: dict, seed: int, t0: int, device):
    """Paste the moving textured square into every frame of ``out``."""
    frames, h, w, _ = out.shape
    size = int(region["size"])
    g = _gen(chunk_seed(seed, -2), device)
    tex = (_gradient(0, 1, size, size, content["gradient"], device)
           + _color_field(g, 1, size, size, content["color_block"],
                          content["color_tblock"], content["color_amp"], device)
           + torch.randint(0, int(region["noise_max"]) + 1, (1, size, size, 1),
                           generator=g, device=device, dtype=torch.int16))[0]
    start = torch.randint(0, 1 << 30, (2,), generator=g, device=device).tolist()
    y0 = start[0] % (h - size + 1)
    x_start = start[1] % w
    cols = torch.arange(size, device=device)
    for t in range(frames):
        x0 = (x_start + int(region["speed"]) * (t0 + t)) % w
        out[t, y0:y0 + size].index_copy_(1, (x0 + cols) % w, tex)


def make_pool(content: dict, pool: int, seed: int, frames: int, height: int,
              width: int, device) -> list[torch.Tensor]:
    """``pool`` chunks, each a (frames, height, width, 3) uint8 tensor on
    ``device``."""
    unknown = sorted(set(content) - CONTENT_KEYS
                     | {f"region.{k}" for k in set(content.get("region") or {}) - _REGION_KEYS})
    if unknown:
        raise ValueError(f"content keys the generator does not read: {unknown}")
    return [_chunk(content, i, seed, frames, height, width, device)
            for i in range(pool)]
