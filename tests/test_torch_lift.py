"""The port's lifting kernels' plain versions against the JAX package:
the interleaved wavelet itself (levels 1-4), ``forward_quant`` against
``to_symbols(quantize(forward_3d_inter))``, ``inverse_dequant`` against
the Pallas ``inverse_dequant_pallas`` in interpret mode, and the plain
3D lift ``forward_3d`` / ``inverse_3d`` against the XLA
``forward_3d_inter`` / ``inverse_3d_inter`` (which the JAX package's own
tests hold bit-identical to its Pallas kernels) and once against
``forward_3d_pallas`` / ``inverse_3d_pallas`` in interpret mode.
Bit-exact.  On the CPU the wrappers take the plain versions and count no
launches; the CUDA kernels are held against the same plain versions on
the card (tests/test_torch_gpu.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alice_codec_tpu.core import WaveletType as JW
from alice_codec_tpu.ops import quant as jquant
from alice_codec_tpu.ops import wavelet as jwavelet
from alice_codec_tpu import pipeline as jpipeline
from alice_codec_tpu.ops.pallas import lift_kernels as jlift
from alice_codec_tpu.ops.pallas.lift_kernels import (
    forward_3d_pallas, forward_quant_pallas, inverse_3d_pallas,
    inverse_dequant_pallas)

from alice_codec_tpu_torch import pipeline
from alice_codec_tpu_torch.core import WaveletType
from alice_codec_tpu_torch.ops import quant, wavelet
from alice_codec_tpu_torch.ops.kernels import lift

# The suite runs several pytest workers on the CPU at once: keep these
# small tensor ops on one thread so they do not compete with them.
torch.set_num_threads(1)

WAVELETS = [WaveletType.HAAR, WaveletType.CDF53, WaveletType.CDF97]
#: (C, T, H, W) shapes; dims of 2 make both edge rules hit one sample pair
SHAPES = [(1, 2, 2, 2), (3, 4, 6, 10)]


def _vol(shape, seed, bound):
    rng = np.random.default_rng(seed)
    return rng.integers(-bound, bound, size=shape, dtype=np.int32)


@pytest.mark.parametrize("wt", WAVELETS)
@pytest.mark.parametrize("shape", SHAPES)
def test_wavelet_matches_jax(wt, shape):
    x = _vol(shape, sum(shape) + int(wt), 4000)
    jwt = JW(int(wt))
    fwd = wavelet.forward_3d_inter(torch.from_numpy(x), wt)
    want = jwavelet.forward_3d_inter(jnp.asarray(x), jwt)
    np.testing.assert_array_equal(fwd.numpy(), np.asarray(want))
    for exact in (False, True):
        inv = wavelet.inverse_3d_inter(fwd, wt, exact=exact)
        winv = jwavelet.inverse_3d_inter(want, jwt, exact=exact)
        np.testing.assert_array_equal(inv.numpy(), np.asarray(winv))
        if exact:
            np.testing.assert_array_equal(inv.numpy(), x)


#: the shape of the subgrid cases (divisible by 2^4 on every volume axis)
LEVEL_SHAPE = (2, 16, 16, 16)


@pytest.fixture(scope="module")
def levels_jax():
    """(levels, wavelet) → (input, JAX forward, {exact: JAX inverse}) over
    one shape, so the JAX ops compile once for it."""
    out = {}
    for levels in (2, 3, 4):
        for wt in WAVELETS:
            x = _vol(LEVEL_SHAPE, levels + int(wt), 3000)
            jwt = JW(int(wt))
            fwd = jwavelet.forward_3d_inter(jnp.asarray(x), jwt, levels)
            inv = {exact: np.asarray(jwavelet.inverse_3d_inter(
                fwd, jwt, levels, exact=exact)) for exact in (False, True)}
            out[(levels, wt)] = (x, np.asarray(fwd), inv)
    return out


def test_wavelet_levels_beyond_one_not_ported(levels_jax):
    # levels 2 is ported: the subgrid lifts against the JAX package's
    x, want, _ = levels_jax[(2, WaveletType.CDF53)]
    fwd = wavelet.forward_3d_inter(torch.from_numpy(x), WaveletType.CDF53,
                                   levels=2)
    np.testing.assert_array_equal(fwd.numpy(), want)
    back = wavelet.inverse_3d_inter(fwd, WaveletType.CDF53, levels=2,
                                    exact=True)
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("wt", WAVELETS)
@pytest.mark.parametrize("levels", [2, 3, 4])
def test_subgrid_levels_match_jax(levels_jax, wt, levels):
    """Levels 2-4: the strided-view subgrid lifts against the JAX
    package's rolled and masked ones, forward from level 0 and from level
    1 (the codec's split: the 3D lift kernel does level 0), and both
    inverses, likewise."""
    x, want, winv = levels_jax[(levels, wt)]
    fwd = wavelet.forward_3d_inter(torch.from_numpy(x), wt, levels)
    np.testing.assert_array_equal(fwd.numpy(), want)
    lvl0 = lift.forward_3d(torch.from_numpy(x), wt)
    np.testing.assert_array_equal(
        wavelet.forward_3d_inter(lvl0, wt, levels, start_level=1).numpy(), want)
    for exact in (False, True):
        inv = wavelet.inverse_3d_inter(fwd, wt, levels, exact=exact)
        np.testing.assert_array_equal(inv.numpy(), winv[exact])
        part = wavelet.inverse_3d_inter(fwd, wt, levels, exact=exact,
                                        stop_level=1)
        np.testing.assert_array_equal(
            lift.inverse_3d(part, wt, exact=exact).numpy(), winv[exact])


def test_subgrid_1d_level_matches_jax():
    x = _vol(LEVEL_SHAPE, 9, 3000)
    for wt in WAVELETS:
        for level in (1, 2):
            got = wavelet.forward_1d_inter(torch.from_numpy(x), wt, axis=-1,
                                           level=level)
            want = jwavelet.forward_1d_inter(jnp.asarray(x), JW(int(wt)),
                                             axis=-1, level=level)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            back = wavelet.inverse_1d_inter(got, wt, axis=-1, level=level,
                                            exact=True)
            np.testing.assert_array_equal(back.numpy(), x)
    with pytest.raises(ValueError, match="divisible"):
        wavelet.forward_1d_inter(torch.from_numpy(x), WaveletType.HAAR,
                                 axis=-2, level=4)


#: (C, T, H, W) int32 shapes for the plain 3D lift: tiny, and padded
#: from odd dims (5, 37, 51) as the codec pads them
LIFT3D_SHAPES = [(1, 2, 2, 2), (3, 6, 38, 52)]


@pytest.fixture(scope="module")
def lift3d_jax():
    """(wavelet, shape) → (input, JAX XLA forward, {exact: inverse}); the
    inputs reach ±2^20, far beyond int16, where storing int16 between the
    passes would wrap."""
    out = {}
    for shape in LIFT3D_SHAPES:
        for wt in WAVELETS:
            x = _vol(shape, sum(shape) + int(wt), 1 << 20)
            jwt = JW(int(wt))
            fwd = jwavelet.forward_3d_inter(jnp.asarray(x), jwt)
            inv = {exact: np.asarray(jwavelet.inverse_3d_inter(
                fwd, jwt, exact=exact)) for exact in (False, True)}
            out[(wt, shape)] = (x, np.asarray(fwd), inv)
    return out


@pytest.mark.parametrize("wt", WAVELETS)
@pytest.mark.parametrize("shape", LIFT3D_SHAPES)
def test_forward_3d_matches_jax(lift3d_jax, wt, shape):
    """K7's plain version against the JAX XLA level-0 lift, int32 in and
    out, and its inverses in both modes."""
    x, want, winv = lift3d_jax[(wt, shape)]
    before = (lift.forward_3d.launches, lift.inverse_3d.launches)
    got = lift.forward_3d(torch.from_numpy(x), wt)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (np.abs(want) > 32767).any()
    for exact in (False, True):
        inv = lift.inverse_3d(got, wt, exact=exact)
        np.testing.assert_array_equal(inv.numpy(), winv[exact])
    np.testing.assert_array_equal(winv[True], x)
    # CPU: the plain versions, no launch counted
    assert (lift.forward_3d.launches, lift.inverse_3d.launches) == before


def test_lift3d_matches_pallas_interpret():
    """One case against the Pallas K7 kernels themselves, in interpret
    mode (each interpret compile costs seconds): CDF 9/7, values beyond
    int16, both inverse modes."""
    x = _vol((2, 4, 6, 8), 31, 1 << 18)
    wt = WaveletType.CDF97
    fwd = lift.forward_3d(torch.from_numpy(x), wt)
    want = np.asarray(forward_3d_pallas(jnp.asarray(x), JW.CDF97,
                                        interpret=True))
    np.testing.assert_array_equal(fwd.numpy(), want)
    for exact in (False, True):
        winv = inverse_3d_pallas(jnp.asarray(want), JW.CDF97, exact=exact,
                                 interpret=True)
        np.testing.assert_array_equal(
            lift.inverse_3d(fwd, wt, exact=exact).numpy(), np.asarray(winv))


@pytest.mark.parametrize("wt", WAVELETS)
@pytest.mark.parametrize("shape", SHAPES)
def test_forward_quant_matches_unfused_jax(wt, shape):
    # video-bounded input (|x| ≤ 256): the int16 storage is exact there
    x = _vol(shape, 7 + int(wt), 256)
    c = shape[0]
    step = np.array([1, 7, 64][:c], np.int32)
    dz = np.array([1, 9, 64][:c], np.int32)
    before = lift.forward_quant.launches
    got = lift.forward_quant(torch.from_numpy(x.astype(np.int16)), wt,
                             torch.from_numpy(step), torch.from_numpy(dz))
    assert lift.forward_quant.launches == before  # CPU: plain version
    coeffs = jwavelet.forward_3d_inter(jnp.asarray(x), JW(int(wt)))
    want = jquant.to_symbols(jquant.quantize(
        coeffs, jnp.asarray(step).reshape(c, 1, 1, 1),
        jnp.asarray(dz).reshape(c, 1, 1, 1)))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def dequant_cases():
    """(wavelet, exact, input name) → (symbols, step, JAX interpret-mode
    result).  Random symbols at step 64 stay inside int16; at step 160
    they overflow it, so the int16 stores between and after the passes
    wrap."""
    shape = (3, 4, 6, 8)
    rng = np.random.default_rng(11)
    fq = lift.forward_quant_plain(
        torch.from_numpy(_vol(shape, 12, 256).astype(np.int16)),
        WaveletType.CDF53, 5, 5).numpy()
    inputs = {"coded": (fq, np.array([5, 5, 5], np.int32)),
              "random": (rng.integers(0, 256, size=shape, dtype=np.uint8),
                         np.array([64, 64, 64], np.int32)),
              "wrap": (rng.integers(0, 256, size=shape, dtype=np.uint8),
                       np.array([160, 160, 160], np.int32))}
    out = {}
    for wt in WAVELETS:
        for exact in (False, True):
            for name, (sym, step) in inputs.items():
                want = inverse_dequant_pallas(
                    jnp.asarray(sym), JW(int(wt)), jnp.asarray(step),
                    exact=exact, interpret=True)
                out[(wt, exact, name)] = (sym, step, np.asarray(want))
    return out


@pytest.mark.parametrize("wt", WAVELETS)
@pytest.mark.parametrize("exact", [False, True])
def test_inverse_dequant_matches_pallas_interpret(dequant_cases, wt, exact):
    wrapped = False
    for name in ("coded", "random", "wrap"):
        sym, step, want = dequant_cases[(wt, exact, name)]
        before = lift.inverse_dequant.launches
        got = lift.inverse_dequant(torch.from_numpy(sym), wt,
                                   torch.from_numpy(step), exact=exact)
        assert lift.inverse_dequant.launches == before
        assert got.dtype == torch.int16
        np.testing.assert_array_equal(got.numpy(), want)
        if name == "wrap":
            # the same inverse without the int16 stores leaves int16's
            # range: the stores really wrap here
            wide = wavelet.inverse_3d_inter(
                quant.from_symbols(torch.from_numpy(sym)) * 160, wt,
                exact=exact)
            wrapped = bool((wide.abs() > 32767).any())
    assert wrapped


def test_split_frames_store_int16_between_spatial_passes(monkeypatch):
    """Frames beyond the TPU's one-block budget (4K) take its split
    spatial path, which stores int16 between the W and H passes.  With
    the budget cut to 1 KB in both packages, a (16, 256) frame splits:
    the fused kernels' plain versions match the Pallas split path in
    interpret mode on inputs whose spatial intermediates leave int16, and
    differ from the unsplit form there."""
    shape = (3, 2, 16, 256)
    rng = np.random.default_rng(17)
    vol = rng.integers(-30000, 30000, size=shape, dtype=np.int16)
    sym = rng.integers(0, 256, size=shape, dtype=np.uint8)
    step = np.full(3, 160, np.int32)
    unsplit = (lift.forward_quant(torch.from_numpy(vol), WaveletType.CDF97,
                                  step, step),
               lift.inverse_dequant(torch.from_numpy(sym), WaveletType.CDF97,
                                    step))
    monkeypatch.setattr(jlift, "_FRAME_BYTES", 1024)
    monkeypatch.setattr(lift, "_FRAME_BYTES", 1024)
    assert lift.split_frame(16, 256) and jlift.lift3d_ok(shape, 2)
    want_f = np.asarray(forward_quant_pallas(
        jnp.asarray(vol), JW.CDF97, jnp.asarray(step), jnp.asarray(step),
        interpret=True))
    want_i = np.asarray(inverse_dequant_pallas(
        jnp.asarray(sym), JW.CDF97, jnp.asarray(step), interpret=True))
    got_f = lift.forward_quant(torch.from_numpy(vol), WaveletType.CDF97,
                               step, step)
    got_i = lift.inverse_dequant(torch.from_numpy(sym), WaveletType.CDF97,
                                 step)
    np.testing.assert_array_equal(got_f.numpy(), want_f)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    assert not np.array_equal(unsplit[0].numpy(), want_f)
    assert not np.array_equal(unsplit[1].numpy(), want_i)


def test_unfused_shapes_decode_like_jax(monkeypatch):
    """Where the JAX package cannot tile its fused kernels it decodes
    through its unfused int32 branch (no int16 store between passes); so
    does the port.  With the tile budget cut to 1 byte in both packages,
    random symbols at step 160 (intermediates beyond int16) decode to
    the JAX decode."""
    dims, padded = (9, 6, 4), (10, 6, 4)  # (w, h, t)
    sym = np.random.default_rng(19).integers(0, 256, (3, 240), dtype=np.uint8)
    step = np.full(3, 160, np.int32)
    fused = pipeline.decode_device(
        torch.from_numpy(sym), torch.from_numpy(step),
        wavelet_type=WaveletType.CDF53, dims=dims, padded=padded,
        interleaved=True)
    monkeypatch.setattr(jlift, "_TILE_BYTES", 1)
    monkeypatch.setattr(pipeline, "_TILE_BYTES", 1)
    assert not pipeline._tpu_fused(padded)
    assert not jlift.lift3d_ok((3, 4, 6, 10), 2)
    want = jpipeline.decode_device(
        jnp.asarray(sym), jnp.asarray(step), jnp.asarray(step),
        wavelet_type=JW.CDF53, dims=dims, padded=padded, interleaved=True)
    before = lift.inverse_dequant.launches
    got = pipeline.decode_device(torch.from_numpy(sym), torch.from_numpy(step),
                                 wavelet_type=WaveletType.CDF53, dims=dims,
                                 padded=padded, interleaved=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert lift.inverse_dequant.launches == before
    assert not torch.equal(got, fused)  # the int16 stores matter here


def test_lift_rejects_odd_or_mistyped_volumes():
    with pytest.raises(ValueError, match="even"):
        lift.forward_quant(torch.zeros(3, 4, 6, 9, dtype=torch.int16),
                           WaveletType.CDF53, 8, 8)
    with pytest.raises(ValueError, match="int16"):
        lift.forward_quant(torch.zeros(3, 4, 6, 8, dtype=torch.int32),
                           WaveletType.CDF53, 8, 8)
    with pytest.raises(ValueError, match="uint8"):
        lift.inverse_dequant(torch.zeros(3, 4, 6, 8, dtype=torch.int16),
                             WaveletType.CDF53, 8)
    with pytest.raises(ValueError, match="int32"):
        lift.forward_3d(torch.zeros(3, 4, 6, 8, dtype=torch.int16),
                        WaveletType.CDF53)
    with pytest.raises(ValueError, match="even"):
        lift.inverse_3d(torch.zeros(3, 4, 5, 8, dtype=torch.int32),
                        WaveletType.CDF53)
