"""The port's lifting kernels' plain versions against the JAX package:
the interleaved wavelet itself, ``forward_quant`` against
``to_symbols(quantize(forward_3d_inter))``, and ``inverse_dequant``
against the Pallas ``inverse_dequant_pallas`` in interpret mode.
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
from alice_codec_tpu.ops.pallas.lift_kernels import inverse_dequant_pallas

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


def test_wavelet_levels_beyond_one_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        wavelet.forward_3d_inter(torch.zeros(4, 4, 4, dtype=torch.int32),
                                 WaveletType.CDF53, levels=2)


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
