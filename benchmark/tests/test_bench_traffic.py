"""The traffic generator against its formula (``bench._test_chunk``'s,
rewritten in torch), and the parameters of the mixes."""

import json

import pytest
import torch

import harness
from conftest import BENCH

GEN = harness.load_module(BENCH / "traffic" / "generate.py", "_traffic_generate")
NAT = {"gradient": [3, 2, 7], "noise_max": 15, "color_block": 64, "color_tblock": 16,
       "color_amp": 32}


def _grid(t, h, w, t0=0, slopes=(3, 2, 7)):
    x = torch.arange(w)[None, None, :, None]
    y = torch.arange(h)[None, :, None, None]
    tt = torch.arange(t0, t0 + t)[:, None, None, None]
    return (x * slopes[0] + y * slopes[1] + tt * slopes[2]) % 256


def test_gradient_alone_is_the_formula():
    flat = dict(NAT, noise_max=0, color_amp=0)
    pool = GEN.make_pool(flat, 3, 5, 6, 20, 70, "cpu")
    for i, x in enumerate(pool):
        assert x.dtype == torch.uint8 and x.shape == (6, 20, 70, 3)
        assert torch.equal(x.to(torch.int64), _grid(6, 20, 70, t0=6 * i).expand(6, 20, 70, 3))


def test_noise_and_colour_field_keep_their_ranges_and_blocks():
    t, h, w = 20, 130, 140
    x = GEN.make_pool(dict(NAT, noise_max=0), 1, 8, t, h, w, "cpu")[0].to(torch.int64)
    base = _grid(t, h, w).expand(t, h, w, 3)
    off = x - base
    inside = (base >= 32) & (base <= 255 - 32)     # no clipping there
    assert off[inside].abs().max() <= 32
    # one offset a channel for each 64 px x 16-frame block
    for (t0, t1), (y0, y1), (x0, x1) in [((0, 16), (0, 64), (0, 64)),
                                         ((16, 20), (64, 128), (128, 140))]:
        blk = off[t0:t1, y0:y1, x0:x1][inside[t0:t1, y0:y1, x0:x1]].view(-1)
        per_ch = off[t0:t1, y0:y1, x0:x1].reshape(-1, 3)[
            inside[t0:t1, y0:y1, x0:x1].reshape(-1, 3).all(1)]
        assert blk.numel() and (per_ch == per_ch[0]).all()
    noisy = GEN.make_pool(NAT, 1, 8, t, h, w, "cpu")[0].to(torch.int64)
    n = noisy - x
    mid = inside & (x + 15 <= 255)
    assert n[mid].min() == 0 and n[mid].max() == 15
    assert (n[..., 0] == n[..., 1])[mid[..., 0] & mid[..., 1]].all()  # luminance noise


def test_one_seed_one_pool_and_distinct_chunks():
    a = GEN.make_pool(NAT, 4, 2**31 + 99, 4, 32, 64, "cpu")
    b = GEN.make_pool(NAT, 4, 2**31 + 99, 4, 32, 64, "cpu")
    c = GEN.make_pool(NAT, 4, 2**31 + 98, 4, 32, 64, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not any(torch.equal(x, y) for x, y in zip(a, c))
    assert len({bytes(x.reshape(-1)[:4096].numpy()) for x in a}) == 4


def test_static_scene_moves_only_its_square():
    content = dict(NAT, noise_max=1, freeze_background=True,
                   region={"size": 16, "speed": 4, "noise_max": 15})
    x = GEN.make_pool(content, 2, 3, 8, 48, 96, "cpu")
    for chunk in x:
        d = (chunk[1:].to(torch.int64) - chunk[:-1].to(torch.int64)).abs()
        moved = (d > 1).any(-1)                 # beyond the 0-1 sensor noise
        rows = moved.any(0).any(1).nonzero().view(-1)
        assert 0 < rows.numel() <= 16          # one band of 16 rows at most
    # the frozen background is the same in every chunk of the pool
    far = lambda c: c[:, :, :, :].to(torch.int64)  # noqa: E731
    a, b = far(x[0]), far(x[1])
    same = (a - b).abs() <= 1
    assert same.float().mean() > 0.6


@pytest.mark.parametrize("path", sorted((BENCH / "traffic").glob("*.json")),
                         ids=lambda p: p.stem)
def test_mix_files_name_the_one_generator(path):
    mix = json.loads(path.read_text())
    assert mix["generator"] == "generate" and mix["loop"] in ("chunk", "batch")
    assert mix["pool"] == 4 and set(mix) <= harness.TRAFFIC_KEYS
    assert set(mix["content"]) <= GEN.CONTENT_KEYS
    assert set(mix["content"]) >= {"gradient", "noise_max", "color_block", "color_tblock",
                                   "color_amp"}
