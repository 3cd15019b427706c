"""The colour folded into the fused lift kernels, on the CPU: which chunks
take it (a function of the shape alone), and the CPU path of the RGB
entry points (``lift.forward_quant_rgb`` / ``lift.inverse_dequant_rgb``)
against the composition they replace (``_color_pad`` + ``forward_quant``
and its colour flags; ``inverse_dequant`` + ``ycocg_r_to_rgb``), flags,
inactive channels and the caller's output tensor included.  The CUDA
kernels are held against the same composition on the card
(tests/test_torch_gpu.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch

from alice_codec_tpu_torch import pipeline
from alice_codec_tpu_torch.core import (WaveletType, padded_dims,
                                        padded_dims_levels)
from alice_codec_tpu_torch.ops import color
from alice_codec_tpu_torch.ops.kernels import launch_counts, lift

torch.set_num_threads(1)

WAVELETS = list(WaveletType)
ACTIVE = [(0,), (0, 1), (0, 2), (0, 1, 2)]


#: (T, H, W) and ALC3's lift route at one level
ROUTES = [
    (64, 1080, 1920, "rgb"),    # the north star's chunk
    (16, 2160, 3840, "rgb"),    # 4K (a split frame)
    (8, 256, 256, "rgb"),       # the sparse goldens' chunk
    (2, 64, 256, "rgb"),        # the smallest fast frame
    (63, 1080, 1920, "int16"),  # T padded to 64
    (64, 1079, 1920, "int16"),  # H padded
    (64, 1080, 1917, "int16"),  # W padded
    (64, 1080, 1916, "int16"),  # ragged: W even, not a multiple of 8
    (64, 62, 1920, "int32"),    # fewer rows than a tile window (and
                                # than the JAX kernels' tiles)
    (64, 1080, 248, "int16"),   # fewer columns than a tile window
    (5, 31, 63, "int16"),       # the dense golden's chunk
    (1, 64, 256, "int16"),      # one frame, padded to two
]


@pytest.mark.parametrize("t,h,w,fused", [(t, h, w, r == "rgb")
                                         for t, h, w, r in ROUTES])
def test_rgb_route_is_a_function_of_shape(t, h, w, fused):
    assert pipeline._rgb_route((w, h, t), padded_dims(w, h, t)) is fused


@pytest.mark.parametrize("t,h,w,route", ROUTES)
def test_route_decides_the_three_ways(monkeypatch, t, h, w, route):
    """``_route`` is the one three-way choice of the ALC3 stages: the RGB
    kernels, the int16 fused kernels, or the int32 unfused lift (the JAX
    package's unfused branch, where ``_tpu_fused`` is false or more than
    one level is lifted); it reads the predicates as module globals."""
    dims = (w, h, t)
    assert pipeline._route(dims, padded_dims(w, h, t), 1) == route
    assert pipeline._route(dims, padded_dims_levels(w, h, t, 2), 2) == "int32"
    assert (route == "int32") is not pipeline._tpu_fused(padded_dims(w, h, t))
    _old_route(monkeypatch)
    assert pipeline._route(dims, padded_dims(w, h, t), 1) == (
        "int16" if route == "rgb" else route)


def _rgb(t, h, w, seed, gray=False):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (t, h, w, 1 if gray else 3), dtype=np.uint8)
    return torch.from_numpy(np.repeat(x, 3, axis=3) if gray else x)


@pytest.mark.parametrize("wt", WAVELETS)
@pytest.mark.parametrize("active", ACTIVE)
def test_forward_quant_rgb_cpu_is_the_composition(wt, active):
    rgb = _rgb(4, 6, 10, int(wt) + len(active))
    sym, flags = lift.forward_quant_rgb(rgb, wt, 6, 6, active=active)
    chans = pipeline._color_pad(rgb, (10, 6, 4))
    want = lift.forward_quant(chans[list(active)], wt, 6, 6)
    assert sym.dtype == torch.uint8 and torch.equal(sym, want)
    assert torch.equal(flags, (chans.reshape(3, -1) != 0).any(1))
    gray = _rgb(2, 4, 8, 3, gray=True)
    _, gflags = lift.forward_quant_rgb(gray, wt, 6, 6, active=active)
    assert gflags.tolist() == [True, False, False]


@pytest.mark.parametrize("wt", WAVELETS)
@pytest.mark.parametrize("active", ACTIVE + [()])
@pytest.mark.parametrize("exact", [False, True])
def test_inverse_dequant_rgb_cpu_is_the_composition(wt, active, exact):
    rng = np.random.default_rng(int(wt) * 7 + len(active))
    # symbols that decode far outside [0, 255] (the int16 wrap and the clamp)
    sym = torch.from_numpy(rng.integers(0, 256, (3, 4, 6, 10), dtype=np.uint8))
    step = torch.tensor([64, 160, 96], dtype=torch.int32)
    chans = [torch.zeros((4, 6, 10), dtype=torch.int16)] * 3
    if active:
        vol = lift.inverse_dequant(sym[list(active)], wt, step[list(active)],
                                   exact=exact)
        for i, c in enumerate(active):
            chans[c] = vol[i]
    want = color.ycocg_r_to_rgb(*chans)
    got = lift.inverse_dequant_rgb(sym, wt, step, exact=exact, active=active)
    assert torch.equal(got, want)
    out = torch.full((4, 6, 10, 3), 7, dtype=torch.uint8)
    assert lift.inverse_dequant_rgb(sym, wt, step, exact=exact, active=active,
                                    out=out) is out
    assert torch.equal(out, want)


def test_rgb_entry_points_reject_what_they_cannot_take():
    with pytest.raises(ValueError, match="uint8"):
        lift.forward_quant_rgb(torch.zeros((2, 4, 4, 3), dtype=torch.int16),
                               WaveletType.CDF53, 4, 4)
    with pytest.raises(ValueError, match="no active channel"):
        lift.forward_quant_rgb(torch.zeros((2, 4, 4, 3), dtype=torch.uint8),
                               WaveletType.CDF53, 4, 4, active=())
    with pytest.raises(ValueError, match="active"):
        lift.inverse_dequant_rgb(torch.zeros((3, 2, 4, 4), dtype=torch.uint8),
                                 WaveletType.CDF53, 4, active=(0, 3))


def test_launch_counts_keep_their_keys():
    """The benchmark's roofline count reads ``launch_counts()`` by wrapper
    name: the RGB launches count under ``forward_quant`` /
    ``inverse_dequant``, and their own counters are no new key."""
    assert set(launch_counts()) == {
        "forward_quant", "encode_words", "decode_words", "inverse_dequant",
        "compact", "expand", "forward_3d", "inverse_3d", "encode_nway",
        "encode_pack_nway", "decode_nway"}
    before = (lift.forward_quant.rgb_launches, lift.inverse_dequant.rgb_launches,
              launch_counts())
    sym, _ = lift.forward_quant_rgb(_rgb(2, 4, 8, 1), WaveletType.HAAR, 4, 4)
    lift.inverse_dequant_rgb(sym, WaveletType.HAAR, 4)
    # the CPU path launches nothing
    assert (lift.forward_quant.rgb_launches, lift.inverse_dequant.rgb_launches,
            launch_counts()) == before


def _old_route(monkeypatch):
    monkeypatch.setattr(pipeline, "_rgb_route", lambda dims, padded: False)


@pytest.mark.parametrize("wt", WAVELETS)
def test_pipeline_on_the_rgb_route_equals_the_old_route(monkeypatch, wt):
    """At a fused shape (2x64x256) the pipeline's stages give what the
    _color_pad route gives: sparse phase 1 (symbols, tile rows, flags)
    for every active set, the dense and reference-layout encodes, and the
    decode into the caller's tensor."""
    t, h, w = 2, 64, 256
    rgb = _rgb(t, h, w, int(wt), gray=False)
    gray = _rgb(t, h, w, 5, gray=True)
    padded = (w, h, t)
    assert pipeline._rgb_route((w, h, t), padded)
    kw = dict(wavelet_type=wt, padded=padded)
    p = t * h * w
    new = {}
    for x, name in ((rgb, "rgb"), (gray, "gray")):
        for active in ACTIVE:
            new[name, active] = pipeline.encode_sparse_phase1(
                x, 8, 8, pp=p + 1024, active=active, **kw)
    new["dense"] = pipeline.encode_device(rgb, 8, 8, interleaved=True, **kw)
    new["ref"] = pipeline.encode_device(rgb, 8, 8, interleaved=False, **kw)
    sym = new["dense"][0]
    step = torch.tensor([8, 8, 8], dtype=torch.int32)
    dec = {}
    for active in ACTIVE:
        out = torch.zeros((t, h, w, 3), dtype=torch.uint8)
        dec[active] = pipeline.decode_device(
            sym, step, dims=(w, h, t), active=active, interleaved=True,
            out=out, **kw)
        assert dec[active] is out
    _old_route(monkeypatch)
    for key, got in new.items():
        if key in ("dense", "ref"):
            want = pipeline.encode_device(rgb, 8, 8, interleaved=key == "dense",
                                          **kw)
        else:
            x = rgb if key[0] == "rgb" else gray
            want = pipeline.encode_sparse_phase1(x, 8, 8, pp=p + 1024,
                                                 active=key[1], **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, want, strict=True)), key
    assert new["gray", (0,)][2].tolist() == [True, False, False]
    for active, got in dec.items():
        want = pipeline.decode_device(sym, step, dims=(w, h, t), active=active,
                                      interleaved=True, **kw)
        assert torch.equal(got, want), active
