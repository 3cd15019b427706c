"""The port's public surface against the JAX package, on the CPU: the
package's ``__all__``, the host quantizers and AnalyticalRDO's quantizers,
the presets, ``version()``, the colour NumPy helpers and ``StageTimer``;
the new device entry points raise without a card; and the two
``bench.py`` routes these layers complete, in small against JAX live:

* config3 (``bench.py`` ``config3_cdf97_sweep``): dense level-1 ``cdf97``
  ALC3 at q = 50 and 95, byte-identical containers, equal decoded RGB,
  the centre frame's device PSNR / SSIM;
* config5 (``config5_rate_controlled_4k``): chunks whose quality a
  ``RateController`` picks from their sizes, the same quality sequence
  and sizes, and ``segment_by_motion`` on two decoded frames.

Each JAX codec program compiles once (the quality is a traced argument)."""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import alice_codec_tpu as jat
from alice_codec_tpu import profiling as jprofiling
from alice_codec_tpu.alc3 import Alc3Codec as JaxCodec
from alice_codec_tpu.core import SubBand3D as JSubBand3D
from alice_codec_tpu.metrics import psnr_device as j_psnr_device
from alice_codec_tpu.models import presets as jpresets
from alice_codec_tpu.ops import quant as jquant
from alice_codec_tpu.rate_control import RateControlConfig as JRateConfig
from alice_codec_tpu.rate_control import RateController as JRateController
from alice_codec_tpu.segment import segment_by_motion as j_segment_by_motion
from alice_codec_tpu.ssim import ssim_device as j_ssim_device
from bench import _test_chunk

import alice_codec_tpu_torch as at
from alice_codec_tpu_torch import Alc3Codec, lossless, profiling, segment
from alice_codec_tpu_torch.metrics import psnr_device
from alice_codec_tpu_torch.models import presets
from alice_codec_tpu_torch.ops import quant, wavelet
from alice_codec_tpu_torch.rate_control import RateControlConfig, RateController
from alice_codec_tpu_torch.ssim import ssim_device

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


# ── names ───────────────────────────────────────────────────────


def test_all_covers_jax_all():
    missing = sorted(set(jat.__all__) - set(at.__all__))
    assert not missing, missing
    assert {"DEFAULT_S_SEG"} <= set(at.__all__)
    for name in at.__all__:
        assert hasattr(at, name), name
    assert at.version() == jat.version() == at.VERSION == at.__version__
    assert at.DEFAULT_CHUNK_SIZE == jat.DEFAULT_CHUNK_SIZE
    assert [int(b) for b in at.SubBand3D] == [int(b) for b in jat.SubBand3D]


def test_new_device_entry_points_raise_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    f = np.zeros((8, 8), np.uint8)
    calls = [
        lambda: segment.segment_by_motion(f, f, 8, 8),
        lambda: segment.segment_by_chroma(f, f, f, 8, 8),
        lambda: segment.motion_mask_device(f, f, threshold=25, dilate_radius=2,
                                           erode_radius=1),
        lambda: segment.chroma_mask_device(f, 30),
        lambda: segment.segment_motion_numpy(f, f),
        lambda: wavelet.Wavelet1D.cdf53(),
        lambda: wavelet.Wavelet2D(at.WaveletType.HAAR),
        lambda: wavelet.Wavelet3D.cdf97(),
        lambda: lossless.LosslessEncoder(),
        lambda: lossless.verify_roundtrip_1d(np.arange(8)),
        lambda: presets.ARCHIVAL.encoder(),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


# ── host quantizers and AnalyticalRDO ───────────────────────────


@pytest.mark.parametrize("step, dead_zone", [
    (1, None), (2, None), (7, None), (8, 12), (64, None), (160, 240), (1000, 3)])
def test_quantizers_equal_jax(step, dead_zone):
    dz = step if dead_zone is None else dead_zone
    rng = np.random.default_rng(step)
    edges = [0, dz - 1, dz, dz + 1, 2 * dz + step, 2**20, 2**31 - 1]
    values = np.array(edges + [-v for v in edges] + [-(2**31)], np.int64)
    values = np.concatenate([values, rng.integers(-(2**31), 2**31, 200),
                             rng.integers(-4 * dz, 4 * dz, 200)]).astype(np.int32)
    for ours, ref in ((quant.Quantizer(step, dead_zone),
                       jquant.Quantizer(step, dead_zone)),
                      (quant.FastQuantizer(step, dead_zone),
                       jquant.FastQuantizer(step, dead_zone))):
        assert (ours.step, ours.dead_zone) == (ref.step, ref.dead_zone)
        q = ours.quantize_buffer(values)
        assert q.dtype == np.int32
        np.testing.assert_array_equal(q, ref.quantize_buffer(values))
        np.testing.assert_array_equal(ours.dequantize_buffer(q),
                                      ref.dequantize_buffer(q))
        np.testing.assert_array_equal(quant.quantize_subband(values, ours),
                                      jquant.quantize_subband(values, ref))
        np.testing.assert_array_equal(quant.dequantize_subband(q, ours),
                                      jquant.dequantize_subband(q, ref))
        for v in values[:40].tolist():
            assert ours.quantize(v) == ref.quantize(v)
            assert ours.dequantize(ours.quantize(v)) == ref.dequantize(ref.quantize(v))
    fast = quant.FastQuantizer.with_dead_zone(step, dz)
    ref = jquant.FastQuantizer.with_dead_zone(step, dz)
    assert (fast.reciprocal, fast.shift) == (ref.reciprocal, ref.shift)


def test_fast_quantizer_rejects_step_like_jax():
    for step in (0, -3):
        with pytest.raises(at.InvalidQuantStep):
            quant.FastQuantizer(step)
        with pytest.raises(jat.InvalidQuantStep):
            jquant.FastQuantizer(step)


@pytest.mark.parametrize("quality", [10, 50, 90, 100])
def test_rdo_quantizers_equal_jax(quality):
    rng = np.random.default_rng(quality)
    vol = torch.as_tensor(rng.integers(-2000, 2000, (4, 8, 8)).astype(np.int32))
    bands = wavelet.extract_subbands_3d(wavelet.forward_3d(vol, at.WaveletType.CDF53))
    subbands = [bands[b].numpy() for b in at.SubBand3D]
    subbands[3] = np.zeros(0, np.int32)  # an empty band: variance 1.0
    ours = quant.AnalyticalRDO.with_quality(quality)
    ref = jquant.AnalyticalRDO.with_quality(quality)
    got = ours.compute_all_quantizers(subbands)
    want = ref.compute_all_quantizers(subbands)
    assert [(q.step, q.dead_zone) for q in got] == [(q.step, q.dead_zone) for q in want]
    for sb, band, jband in zip(subbands, at.SubBand3D, JSubBand3D):
        assert ours.estimate_variance(sb) == ref.estimate_variance(sb)
        a, b = ours.compute_quantizer(sb, band), ref.compute_quantizer(sb, jband)
        assert (a.step, a.dead_zone) == (b.step, b.dead_zone)
    with pytest.raises(ValueError):
        ours.compute_all_quantizers(subbands[:7])


# ── presets, colour helpers, timing ─────────────────────────────


def test_presets_equal_jax():
    assert sorted(presets.PRESETS) == sorted(jpresets.PRESETS)
    for name, p in presets.PRESETS.items():
        j = jpresets.get_preset(name)
        assert presets.get_preset(name) is p
        assert (p.name, int(p.wavelet), p.quality, p.exact_decode, p.n_lanes) == (
            j.name, int(j.wavelet), j.quality, j.exact_decode, j.n_lanes)
        assert (p.rate_control is None) == (j.rate_control is None)
        if p.rate_control is not None:
            assert vars(p.rate_control) == vars(j.rate_control)
            rc = p.rate_controller()
            assert isinstance(rc, RateController)
            assert rc.recommended_quality == j.rate_controller().recommended_quality
        else:
            assert p.rate_controller() is None
        enc = p.encoder(device="cpu")
        assert (enc.quality, int(enc.wavelet_type)) == (p.quality, int(p.wavelet))
        assert p.decoder(device="cpu").device == torch.device("cpu")
        b = p.batch_encoder(device="cpu")
        assert (b.quality, b.n_lanes) == (p.quality, p.n_lanes)
    for mod in (presets, jpresets):
        with pytest.raises(ValueError, match="unknown preset 'x'"):
            mod.get_preset("x")


def test_preset_roundtrip_decodes_like_the_port():
    t, y, x = np.meshgrid(np.arange(2), np.arange(8), np.arange(8), indexing="ij")
    rgb = np.stack([40 + 3 * x + y, 90 + 2 * y + t, 60 + x + 2 * t], -1).astype(np.uint8)
    p = presets.LOSSLESS
    chunk = p.encoder(device="cpu").encode(rgb, 8, 8, 2)
    out = p.decode(p.decoder(device="cpu"), chunk)
    np.testing.assert_array_equal(out, rgb.reshape(-1))  # smooth: exact


def test_colour_numpy_helpers_equal_jax():
    rng = np.random.default_rng(4)
    rgb = rng.integers(0, 256, 3 * 97, dtype=np.uint8)
    got = at.rgb_to_ycocg_r_numpy(rgb)
    want = jat.rgb_to_ycocg_r_numpy(rgb)
    for a, b in zip(got, want):
        assert a.dtype == np.int16
        np.testing.assert_array_equal(a, b)
    planes = [rng.integers(-400, 400, 97).astype(np.int16) for _ in range(3)]
    for ys in (got, planes):  # in and out of gamut (clamped)
        back = at.ycocg_r_to_rgb_numpy(*ys)
        assert back.dtype == np.uint8
        np.testing.assert_array_equal(back, jat.ycocg_r_to_rgb_numpy(*ys))
    np.testing.assert_array_equal(at.ycocg_r_to_rgb_numpy(*got), rgb)
    for mod in (at, jat):
        with pytest.raises(mod.InvalidBufferSize):
            mod.rgb_to_ycocg_r_numpy(rgb[:4])
        with pytest.raises(mod.InvalidBufferSize):
            mod.ycocg_r_to_rgb_numpy(planes[0], planes[1][:5], planes[2])


def test_stage_timer_report_has_jax_shape():
    reports = []
    for mod in (profiling, jprofiling):
        timer = mod.StageTimer()
        for name in ("encode", "decode", "encode"):
            with timer.stage(name):
                pass
        assert timer.counts["encode"] == 2 and timer.average_us("none") == 0.0
        reports.append(re.sub(r"[0-9.]+", "#", timer.report()))
    assert reports[0] == reports[1]
    # as_metrics: the same CodecMetrics fields as JAX's (the DB bridge's)
    got, want = (mod.StageTimer(totals={"encode": 0.5}, counts={"encode": 2})
                 .as_metrics("encode", timestamp_ms=7, bitrate_bps=1.5e6,
                             psnr_db=38.25)
                 for mod in (profiling, jprofiling))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert type(got).__module__ == "alice_codec_tpu_torch.bridges.db"
    assert got.encode_time_us == 250_000.0


# ── the bench.py routes in small, against JAX live ──────────────

T, H, W = 6, 32, 64
S_SEG = 16
SWEEP = (50, 95)
#: config5 in small: a target these chunks overshoot, so the quality moves
RATE = dict(target_bitrate_kbps=100, framerate=30.0, buffer_size_bits=60_000)
N_CHUNKS = 3


@pytest.fixture(scope="module")
def jax_routes():
    """Everything JAX computes for both routes: one cdf97 encode and one
    decode program (quality traced), one cdf53 encode program."""
    rgb = _test_chunk(T, H, W)
    mid = T // 2

    def centre_metrics(src, out):  # bench.py's device metrics
        return (j_psnr_device(src[mid].reshape(-1), out[mid].reshape(-1)),
                j_ssim_device(src[mid, :, :, 1].astype(jnp.float32),
                              out[mid, :, :, 1].astype(jnp.float32)))

    metrics = jax.jit(centre_metrics)
    sweep = {}
    for q in SWEEP:
        codec = JaxCodec(q, "cdf97", s_seg=S_SEG)
        chunk = codec.encode(rgb)
        out = np.asarray(codec.decode(chunk, as_numpy=True))
        p, s = metrics(rgb, out)
        sweep[q] = dict(data=JaxCodec.to_bytes(chunk), rgb=out, psnr=float(p),
                        ssim=float(s))
    ctrl = JRateController(JRateConfig(**RATE))
    qualities, sizes = [], []
    for _ in range(N_CHUNKS):
        q = ctrl.recommended_quality
        size_bits = JaxCodec(q, "cdf53", s_seg=S_SEG).encode(rgb).compressed_size * 8
        qualities.append(q)
        sizes.append(size_bits // 8)
        for _ in range(T):
            ctrl.update(size_bits // T)
    return dict(rgb=rgb, sweep=sweep, qualities=qualities, sizes=sizes)


@pytest.mark.parametrize("quality", SWEEP)
def test_config3_cdf97_sweep_equals_jax(jax_routes, quality):
    rgb, want = jax_routes["rgb"], jax_routes["sweep"][quality]
    codec = Alc3Codec(quality, "cdf97", s_seg=S_SEG, device="cpu")
    assert (codec.levels, codec.sparse, codec.deep, codec.rdo) == (1, False, False, False)
    chunk = codec.encode(rgb)
    assert Alc3Codec.to_bytes(chunk) == want["data"]
    out = codec.decode(chunk)
    np.testing.assert_array_equal(out.numpy(), want["rgb"])
    mid = T // 2
    src = torch.from_numpy(rgb)
    p = float(psnr_device(src[mid].reshape(-1), out[mid].reshape(-1)))
    s = float(ssim_device(src[mid, :, :, 1].float(), out[mid, :, :, 1].float()))
    assert abs(p - want["psnr"]) < 1e-4 and abs(s - want["ssim"]) < 1e-5
    assert abs(p - at.psnr(rgb[mid], want["rgb"][mid])) < 1e-3
    assert abs(s - at.ssim(rgb[mid, :, :, 1], want["rgb"][mid, :, :, 1], W, H)) < 1e-4


def test_config3_psnr_is_monotone():
    """bench.py's ``monotone_psnr`` over the small sweep's qualities."""
    rgb = _test_chunk(T, H, W)
    psnrs = []
    for q in range(50, 96, 15):
        codec = Alc3Codec(q, "cdf97", s_seg=S_SEG, device="cpu")
        out = codec.decode(codec.encode(rgb))
        psnrs.append(float(psnr_device(torch.from_numpy(rgb), out)))
    assert all(b >= a - 0.1 for a, b in zip(psnrs, psnrs[1:])), psnrs


def test_config5_rate_controlled_chunks_equal_jax(jax_routes):
    rgb = jax_routes["rgb"]
    ctrl = RateController(RateControlConfig(**RATE))
    codecs, qualities, sizes = {}, [], []
    for _ in range(N_CHUNKS):
        q = ctrl.recommended_quality
        codec = codecs.setdefault(q, Alc3Codec(q, "cdf53", s_seg=S_SEG, device="cpu"))
        chunk = codec.encode(rgb)
        size_bits = chunk.compressed_size * 8
        qualities.append(q)
        sizes.append(chunk.compressed_size)
        for _ in range(T):
            ctrl.update(size_bits // T)
    assert qualities == jax_routes["qualities"] and sizes == jax_routes["sizes"]
    assert len(set(qualities)) > 1, qualities  # the controller moved
    frames = codecs[qualities[-1]].decode(chunk, as_numpy=True)
    cur, ref = frames[1, :, :, 1].reshape(-1), frames[0, :, :, 1].reshape(-1)
    got = segment.segment_by_motion(cur, ref, W, H, device="cpu")
    want = j_segment_by_motion(cur, ref, W, H)
    np.testing.assert_array_equal(got.mask, np.asarray(want.mask))
    assert (got.bbox, got.foreground_count) == (want.bbox, want.foreground_count)
