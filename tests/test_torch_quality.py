"""The port's quality, rate and lossless layers against the JAX package,
on the CPU: the host metrics (``mse``, ``psnr``, ``ssim``, ``ms_ssim``)
exactly, the f32 device metrics within 1e-4 dB / 1e-5, the rate
controller's quality sequence and ``estimate_quality`` exactly, and the
reference-layout wavelets (``forward_1d`` … ``forward_3d_multi``, the
sub-band split, ``Wavelet1D/2D/3D``) and ``LosslessEncoder`` bit for bit.

Every JAX device result is computed once, in a module-scoped fixture that
traces one jitted program over all its cases."""

import importlib

import jax
import numpy as np
import pytest
import torch

from alice_codec_tpu import lossless as jlossless
from alice_codec_tpu import metrics as jmetrics
from alice_codec_tpu import rate_control as jrate
from alice_codec_tpu.core import WaveletType as JW
from alice_codec_tpu.ops import wavelet as jw

from alice_codec_tpu_torch import lossless, metrics, rate_control
from alice_codec_tpu_torch.core import SubBand3D, WaveletType
from alice_codec_tpu_torch.errors import InvalidBufferSize
from alice_codec_tpu_torch.ops import wavelet

# the packages re-export the ssim *function* under the submodule's name
jssim = importlib.import_module("alice_codec_tpu.ssim")
ssim = importlib.import_module("alice_codec_tpu_torch.ssim")

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _quick_jax_compiles():
    """The JAX programs of this module compile with most XLA optimizations
    off (their results are the same; their compile is the cost here), and
    the setting is restored after the module."""
    prev = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", prev)


def _run_jax(fn, inputs):
    """``fn(inputs)`` as one jitted JAX program, fetched to the host."""
    return jax.device_get(jax.jit(fn)(inputs))


# ── metrics and SSIM ────────────────────────────────────────────

#: (name, shape) of the metric cases: frames and batches, sizes below 8
#: (no block: SSIM 1.0; identical frames: PSNR inf) and not multiples of
#: 8; MS-SSIM exits early on all of them (after the first scale below 16
#: rows or columns, after the second below 32)
FRAMES = [("frame", (24, 40)), ("ragged", (21, 37)), ("batch", (3, 24, 40)),
          ("tiny", (7, 7)), ("one_scale", (12, 40))]
#: the cases also given as float32 planes (bench.py config3's form)
F32_FRAMES = ("frame", "batch")


def _frames(name, shape):
    rng = np.random.default_rng(sum(shape))
    a = rng.integers(0, 256, shape, dtype=np.uint8)
    if name == "tiny":
        b = a.copy()  # identical: PSNR inf
    else:
        noise = rng.integers(-12, 13, shape)
        b = np.clip(a.astype(np.int64) + noise, 0, 255).astype(np.uint8)
    return a, b


@pytest.fixture(scope="module")
def jax_metrics():
    """JAX's device metrics of every case, uint8 and float32 inputs."""
    inputs = {}
    for name, shape in FRAMES:
        a, b = _frames(name, shape)
        inputs[f"{name}|u8"] = (a, b)
        if name in F32_FRAMES:
            inputs[f"{name}|f32"] = (a.astype(np.float32), b.astype(np.float32))

    def run(ins):
        return {key: (jmetrics.psnr_device(a, b), jmetrics.mse_device(a, b),
                      jssim.ssim_device(a, b), jssim.ms_ssim_device(a, b))
                for key, (a, b) in ins.items()}

    return _run_jax(run, inputs)


@pytest.mark.parametrize("name, shape", FRAMES)
def test_host_metrics_equal_jax(name, shape):
    a, b = _frames(name, shape)
    assert metrics.mse(a, b) == jmetrics.mse(a, b)
    assert metrics.psnr(a, b) == jmetrics.psnr(a, b)
    h, w = shape[-2:]
    fa, fb = a.reshape(-1)[: h * w], b.reshape(-1)[: h * w]
    assert ssim.ssim(fa, fb, w, h) == jssim.ssim(fa, fb, w, h)
    assert ssim.ms_ssim(fa, fb, w, h) == jssim.ms_ssim(fa, fb, w, h)


def test_host_metric_edges_equal_jax():
    e = np.zeros(0, np.uint8)
    assert metrics.mse(e, e) == jmetrics.mse(e, e) == 0.0
    assert ssim.ssim(e, e, 0, 0) == jssim.ssim(e, e, 0, 0) == 1.0
    assert ssim.ms_ssim(e, e, 0, 0) == jssim.ms_ssim(e, e, 0, 0) == 1.0
    a = np.zeros(64, np.uint8)
    b = np.full(64, 255, np.uint8)  # SSIM near 0: the host log clamp
    assert ssim.ms_ssim(a, b, 8, 8) == jssim.ms_ssim(a, b, 8, 8)
    with pytest.raises(InvalidBufferSize):
        metrics.mse(a, e)
    with pytest.raises(InvalidBufferSize):
        ssim.ssim(a, b, 4, 4)


@pytest.mark.parametrize("name, shape, dtype", [
    (name, shape, dtype) for name, shape in FRAMES
    for dtype in ("u8", "f32") if dtype == "u8" or name in F32_FRAMES])
def test_device_metrics_match_jax(jax_metrics, name, shape, dtype):
    a, b = _frames(name, shape)
    if dtype == "f32":
        a, b = a.astype(np.float32), b.astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    j_psnr, j_mse, j_ssim, j_ms = jax_metrics[f"{name}|{dtype}"]
    got = metrics.psnr_device(ta, tb)
    assert got.dtype == torch.float32 and got.shape == ()
    if np.isinf(j_psnr):
        assert torch.isinf(got)
    else:
        assert abs(float(got) - float(j_psnr)) < 1e-4
    assert abs(float(metrics.mse_device(ta, tb)) - float(j_mse)) < 1e-4
    s, ms = ssim.ssim_device(ta, tb), ssim.ms_ssim_device(ta, tb)
    assert s.shape == np.shape(j_ssim) and ms.shape == np.shape(j_ms)
    np.testing.assert_allclose(s.numpy(), j_ssim, rtol=0, atol=1e-5)
    np.testing.assert_allclose(ms.numpy(), j_ms, rtol=0, atol=1e-5)


def test_ms_ssim_device_three_scales_match_host():
    """The full three-scale path (both pools) against the host f64
    MS-SSIM, which equals JAX's exactly (above)."""
    a, b = _frames("frame", (32, 48))
    host = ssim.ms_ssim(a, b, 48, 32)
    got = float(ssim.ms_ssim_device(torch.from_numpy(a), torch.from_numpy(b)))
    assert abs(got - host) < 1e-5


# ── rate control ────────────────────────────────────────────────


def _frame_sizes():
    """Seeded per-frame sizes: small (the buffer fills, quality climbs to
    its maximum), large (it drains, quality falls to its minimum), mixed."""
    rng = np.random.default_rng(7)
    return np.concatenate([rng.integers(0, 60_000, 220),
                           rng.integers(400_000, 1_200_000, 260),
                           rng.integers(0, 400_000, 120)]).tolist()


@pytest.mark.parametrize("cfg", [
    dict(),
    dict(target_bitrate_kbps=60_000, framerate=30.0),
    dict(target_bitrate_kbps=800, framerate=24.0, min_quality=20,
         max_quality=80, buffer_size_bits=333_333),
    dict(framerate=0.0),
    dict(buffer_size_bits=0)])
def test_rate_controller_matches_jax(cfg):
    ours = rate_control.RateController(rate_control.RateControlConfig(**cfg))
    ref = jrate.RateController(jrate.RateControlConfig(**cfg))
    seen = set()
    for size in _frame_sizes():
        for c in (ours, ref):
            c.update(size)
        assert ours.recommended_quality == ref.recommended_quality
        assert ours.buffer_ratio() == ref.buffer_ratio()
        assert ours.average_frame_size() == ref.average_frame_size()
        assert ours.actual_to_target_ratio() == ref.actual_to_target_ratio()
        seen.add(ours.current_quality)
    assert ours.frame_count == ref.frame_count == len(_frame_sizes())
    assert ours.target_bits_per_frame() == ref.target_bits_per_frame()
    if not cfg:
        assert {10, 95} <= seen  # both bounds reached
    assert (rate_control.RateController.with_defaults().recommended_quality
            == jrate.RateController.with_defaults().recommended_quality)


def test_estimate_quality_matches_jax():
    for kbps in (0, 1, 100, 800, 5_000, 20_000, 60_000, 400_000):
        for w, h in ((0, 1080), (320, 240), (1920, 1080), (3840, 2160)):
            for fps in (-1.0, 0.0, 24.0, 30.0, 59.94):
                assert (rate_control.estimate_quality(kbps, w, h, fps)
                        == jrate.estimate_quality(kbps, w, h, fps))


# ── reference-layout wavelets ───────────────────────────────────

#: the shapes of each transform's cases
SHAPES = {"1d": [(3, n) for n in (2, 3, 5, 8, 17)], "2d": [(7, 9), (8, 8)],
          "3d": [(5, 6, 7), (4, 8, 8)]}
_JFNS = {"1d": (jw.forward_1d, jw.inverse_1d), "2d": (jw.forward_2d, jw.inverse_2d),
         "3d": (jw.forward_3d, jw.inverse_3d)}
_FNS = {"1d": (wavelet.forward_1d, wavelet.inverse_1d),
        "2d": (wavelet.forward_2d, wavelet.inverse_2d),
        "3d": (wavelet.forward_3d, wavelet.inverse_3d)}
_CLASSES = {"1d": wavelet.Wavelet1D, "2d": wavelet.Wavelet2D,
            "3d": wavelet.Wavelet3D}
MULTI = (8, 8, 8)


def _ints(shape, seed=0):
    return np.random.default_rng(sum(shape) + seed).integers(
        -3000, 3000, shape).astype(np.int32)


@pytest.fixture(scope="module")
def jax_wavelets():
    """Every wavelet case through the JAX package's transforms, in one
    jitted program: forward and both inverses of the forward; the two-
    level multi transform, its compat inverse and the sub-bands."""
    inputs = {f"{k}|{s}": _ints(s) for k, shapes in SHAPES.items() for s in shapes}
    inputs["multi"] = _ints(MULTI)

    def run(ins):
        out = {}
        for wt in JW:
            for key, x in ins.items():
                if key == "multi":  # the reference decoder's inverse
                    f = jw.forward_3d_multi(x, wt, 2)
                    out[f"{int(wt)}|multi|inv0"] = jw.inverse_3d_multi(f, wt, 2)
                    out[f"{int(wt)}|multi|bands"] = {
                        int(b): v for b, v in jw.extract_subbands_3d(
                            jw.forward_3d(x, wt)).items()}
                else:
                    fwd, inv = _JFNS[key[:2]]
                    f = fwd(x, wt)
                    for exact in (False, True):
                        out[f"{int(wt)}|{key}|inv{int(exact)}"] = inv(f, wt, exact=exact)
                out[f"{int(wt)}|{key}|fwd"] = f
        return out

    return _run_jax(run, inputs)


@pytest.mark.parametrize("kind", list(SHAPES))
@pytest.mark.parametrize("wt", list(WaveletType))
def test_reference_layout_transforms_equal_jax(jax_wavelets, wt, kind):
    fwd, inv = _FNS[kind]
    cls = _CLASSES[kind](wt, device="cpu")
    for shape in SHAPES[kind]:
        x = _ints(shape)
        key = f"{int(wt)}|{kind}|{shape}"
        want = jax_wavelets[f"{key}|fwd"]
        got = fwd(torch.from_numpy(x), wt)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(cls.forward(x), want)
        for exact in (False, True):
            back = jax_wavelets[f"{key}|inv{int(exact)}"]
            np.testing.assert_array_equal(
                inv(torch.tensor(want), wt, exact=exact).numpy(), back)
            np.testing.assert_array_equal(cls.inverse(want, exact=exact), back)
        if kind != "1d":  # a flat buffer with its dimensions
            dims = dict(zip(("width", "height", "depth"), shape[::-1]))
            np.testing.assert_array_equal(
                cls.forward(x.reshape(-1), **dims), want.reshape(-1))
            np.testing.assert_array_equal(
                cls.inverse(want.reshape(-1), **dims, exact=True),
                jax_wavelets[f"{key}|inv1"].reshape(-1))


@pytest.mark.parametrize("wt", list(WaveletType))
def test_multi_level_and_subbands_equal_jax(jax_wavelets, wt):
    x = _ints(MULTI)
    want = jax_wavelets[f"{int(wt)}|multi|fwd"]
    got = wavelet.forward_3d_multi(torch.from_numpy(x), wt, 2)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        wavelet.inverse_3d_multi(torch.tensor(want), wt, 2).numpy(),
        jax_wavelets[f"{int(wt)}|multi|inv0"])
    np.testing.assert_array_equal(
        wavelet.inverse_3d_multi(got, wt, 2, exact=True).numpy(), x)
    single = wavelet.forward_3d(torch.from_numpy(x), wt)
    bands = wavelet.extract_subbands_3d(single)
    for band, v in jax_wavelets[f"{int(wt)}|multi|bands"].items():
        np.testing.assert_array_equal(bands[SubBand3D(band)].numpy(), v)
    assert torch.equal(wavelet.combine_subbands_3d(bands), single)
    with pytest.raises(ValueError, match="divisible"):
        wavelet.forward_3d_multi(torch.zeros(4, 6, 8, dtype=torch.int32), wt, 2)


@pytest.mark.parametrize("shape", [(3, 4, 6, 10), (2, 8, 8, 8), (1, 2, 2, 2)])
def test_even_reference_transform_unchanged(shape):
    """On even sizes the reference-layout transform is still the
    interleaved one composed with the layout permutation (the `.alc` and
    ALC2 wires' route), in every wavelet and both inverse modes."""
    x = torch.from_numpy(_ints(shape, seed=3))
    for wt in WaveletType:
        got = wavelet.forward_3d(x, wt)
        assert torch.equal(got, wavelet.deinterleave_3d(
            wavelet.forward_3d_inter(x, wt)))
        for exact in (False, True):
            assert torch.equal(
                wavelet.inverse_3d(got, wt, exact=exact),
                wavelet.inverse_3d_inter(wavelet.interleave_3d(got), wt,
                                         exact=exact))


# ── lossless ────────────────────────────────────────────────────


def test_lossless_equals_jax():
    """``LosslessEncoder`` in both inverse modes and the helpers, on shapes
    that each JAX program compiles once for."""
    rng = np.random.default_rng(5)
    sig = rng.integers(-(1 << 20), 1 << 20, 16).astype(np.int32)
    img = rng.integers(0, 256, 7 * 9).astype(np.int32)
    for compat in (False, True):
        ours = lossless.LosslessEncoder(compat=compat, device="cpu")
        ref = jlossless.LosslessEncoder(compat=compat)
        assert ours.exact == ref.exact and ours.wavelet == ref.wavelet
        f1 = ours.transform_1d(sig)
        np.testing.assert_array_equal(f1, ref.transform_1d(sig))
        np.testing.assert_array_equal(ours.inverse_1d(f1), ref.inverse_1d(f1))
        f2 = ours.transform_2d(img, 9, 7)
        np.testing.assert_array_equal(f2, ref.transform_2d(img, 9, 7))
        np.testing.assert_array_equal(ours.inverse_2d(f2, 9, 7),
                                      ref.inverse_2d(f2, 9, 7))
    for s in (sig, sig[:1], np.zeros(0, np.int32)):
        assert (lossless.verify_roundtrip_1d(s, device="cpu")
                == jlossless.verify_roundtrip_1d(s))
    assert lossless.verify_roundtrip_1d(sig, device="cpu") is True
    # an odd length loses its last sample (the reference's quirk)
    assert lossless.verify_roundtrip_1d(sig[:15], device="cpu") is False
    for data, w, h in ((img, 9, 7), (img, 8, 7), (np.zeros(0), 0, 0)):
        assert (lossless.verify_roundtrip_2d(data, w, h, device="cpu")
                == jlossless.verify_roundtrip_2d(data, w, h))
    # even dimensions roundtrip exactly, odd ones lose their last row / column
    assert lossless.verify_roundtrip_2d(img[:64 - 8] + 1, 8, 7, device="cpu") is False
    assert lossless.verify_roundtrip_2d(rng.integers(0, 256, 64), 8, 8,
                                        device="cpu") is True
    buf = np.array([-7, 0, 12, 255, 256, 70000], np.int32)
    np.testing.assert_array_equal(lossless.i32_to_u8(buf), jlossless.i32_to_u8(buf))
    u8 = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(lossless.u8_to_i32(u8), jlossless.u8_to_i32(u8))
