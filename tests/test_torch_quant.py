"""The port's mode quantizers against the JAX package: the unwrapped
16-bit zigzag of deep mode, the per-band helpers of AnalyticalRDO on the
interleaved layout (band index, quantize, dequantize, exact integer
moments) and the host RDO itself.  Bit-exact; every JAX result is made
once, in a module fixture."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from alice_codec_tpu.core import SubBand3D as JSubBand3D
from alice_codec_tpu.ops import quant as jquant

from alice_codec_tpu_torch.core import SubBand3D
from alice_codec_tpu_torch.ops import quant

# The suite runs several pytest workers on the CPU at once: keep these
# small tensor ops on one thread so they do not compete with them.
torch.set_num_threads(1)

VOL = (3, 4, 6, 8)  # (C, T, H, W)


def _inputs():
    rng = np.random.default_rng(21)
    coeffs = rng.integers(-3000, 3000, size=VOL, dtype=np.int32)
    big = rng.integers(-(1 << 24), 1 << 24, size=VOL, dtype=np.int32)
    steps8 = rng.integers(1, 200, size=(3, 8)).astype(np.int32)
    dzs8 = (steps8 + steps8 // 2).astype(np.int32)
    q16 = rng.integers(-40000, 40000, size=4096, dtype=np.int32)
    return coeffs, big, steps8, dzs8, q16


@pytest.fixture(scope="module")
def jax_run():
    coeffs, big, steps8, dzs8, q16 = _inputs()
    q = jquant.quantize_bands_inter(jnp.asarray(coeffs), jnp.asarray(steps8),
                                    jnp.asarray(dzs8))
    return dict(
        sym16=np.asarray(jquant.to_symbols16(jnp.asarray(q16))),
        back16=np.asarray(jquant.from_symbols16(
            jquant.to_symbols16(jnp.asarray(q16)))),
        band=np.asarray(jquant.band_index_inter(VOL)),
        q=np.asarray(q),
        dq=np.asarray(jquant.dequantize_bands_inter(q, jnp.asarray(steps8))),
        dq_big=np.asarray(jquant.dequantize_bands_inter(
            jnp.asarray(big), jnp.asarray(steps8))),
        moments=[tuple(np.asarray(m) for m in jquant.band_moments_inter(
            jnp.asarray(x))) for x in (coeffs, big)])


def test_symbols16_match_jax(jax_run):
    _, _, _, _, q16 = _inputs()
    s = quant.to_symbols16(torch.from_numpy(q16))
    np.testing.assert_array_equal(s.numpy(), jax_run["sym16"])
    assert int(s.max()) <= 65535 and int(s.min()) >= 0
    np.testing.assert_array_equal(quant.from_symbols16(s).numpy(),
                                  jax_run["back16"])
    # |q| ≤ 32767 survives the roundtrip (the u8 zigzag wraps past 127)
    ok = np.abs(q16) <= 32767
    np.testing.assert_array_equal(quant.from_symbols16(s).numpy()[ok], q16[ok])


def test_band_index_matches_jax(jax_run):
    np.testing.assert_array_equal(quant.band_index_inter(VOL).numpy(),
                                  jax_run["band"])


def test_quantize_bands_match_jax(jax_run):
    coeffs, big, steps8, dzs8, _ = _inputs()
    q = quant.quantize_bands_inter(torch.from_numpy(coeffs),
                                   torch.from_numpy(steps8),
                                   torch.from_numpy(dzs8))
    assert q.dtype == torch.int32 and q.shape == VOL
    np.testing.assert_array_equal(q.numpy(), jax_run["q"])
    dq = quant.dequantize_bands_inter(q, torch.from_numpy(steps8))
    np.testing.assert_array_equal(dq.numpy(), jax_run["dq"])
    # q · step past int32 wraps as jnp's int32 product does
    dq_big = quant.dequantize_bands_inter(torch.from_numpy(big), steps8)
    np.testing.assert_array_equal(dq_big.numpy(), jax_run["dq_big"])


def test_quantize_bands_is_per_band_quantize():
    """Each band quantized alone with its own scalar step equals the
    per-band call (the strided views hold the parities)."""
    coeffs, _, steps8, dzs8, _ = _inputs()
    x = torch.from_numpy(coeffs)
    q = quant.quantize_bands_inter(x, steps8, dzs8)
    for band in SubBand3D:
        k = int(band)
        y, xw, t = k >> 2, (k >> 1) & 1, k & 1
        for c in range(3):
            view = (c, slice(t, None, 2), slice(y, None, 2), slice(xw, None, 2))
            want = quant.quantize(x[view], int(steps8[c, k]), int(dzs8[c, k]))
            np.testing.assert_array_equal(q[view].numpy(), want.numpy())


@pytest.mark.parametrize("which", [0, 1])
def test_band_moments_match_jax(jax_run, which):
    x = _inputs()[which]
    s1, s2 = quant.band_moments_inter(torch.from_numpy(x))
    assert s1.dtype == s2.dtype == torch.int64 and s1.shape == (3, 8)
    want1, want2 = jax_run["moments"][which]
    np.testing.assert_array_equal(s1.numpy(), want1)
    np.testing.assert_array_equal(s2.numpy(), want2)


def test_subband_enum_matches_jax():
    assert [(b.name, int(b), b.quant_strength, b.is_temporal_high, b.is_dc)
            for b in SubBand3D] == [
        (b.name, int(b), b.quant_strength, b.is_temporal_high, b.is_dc)
        for b in JSubBand3D]


@pytest.mark.parametrize("quality", [0, 1, 37, 70, 85, 90, 99, 100, 150])
def test_rdo_steps_match_jax(quality):
    """AnalyticalRDO from quality and moments: the same bpp, steps and
    dead zones as the JAX class, over moments from flat to wild."""
    ours = quant.AnalyticalRDO.with_quality(quality)
    theirs = jquant.AnalyticalRDO.with_quality(quality)
    assert ours.target_bpp == theirs.target_bpp
    rng = np.random.default_rng(quality)
    n = 4096
    for scale in (0, 1, 30, 3000, 1 << 15):
        x = rng.integers(-scale - 1, scale + 1, size=(8, n)).astype(np.int64)
        s1, s2 = x.sum(1), (x * x).sum(1)
        got = ours.steps_from_moments(n, s1, s2)
        want = theirs.steps_from_moments(n, s1, s2)
        for a, b in zip(got, want):
            assert a.dtype == np.int32
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(got[1], got[0] + got[0] // 2)
    assert ours.steps_from_moments(0, [0] * 8, [0] * 8)[0].tolist() == \
        theirs.steps_from_moments(0, [0] * 8, [0] * 8)[0].tolist()
