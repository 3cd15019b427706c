"""The PyTorch port's plain modules against the JAX package: core and
errors, device resolution, import isolation, colour and pad, quantize /
zigzag / histograms, and the ALC3 frequency tables.  Bit-exact."""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import alice_codec_tpu.core as jcore
import alice_codec_tpu.errors as jerrors
from alice_codec_tpu import pipeline as jpipeline
from alice_codec_tpu.ops import color as jcolor
from alice_codec_tpu.ops import quant as jquant
from alice_codec_tpu.ops import rans_word as jrans_word
from alice_codec_tpu.ops.tables_device import freq_table_device as j_freq_table

import alice_codec_tpu_torch as at
from alice_codec_tpu_torch import _device, core, errors, pipeline
from alice_codec_tpu_torch.ops import color, quant, rans_word
from alice_codec_tpu_torch.ops.tables_device import freq_table_device

# The suite runs several pytest workers on the CPU at once: keep these
# small tensor ops on one thread so they do not compete with them.
torch.set_num_threads(1)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


# ── core, errors, device, imports ───────────────────────────────


def test_core_copies_match():
    for q in range(-5, 106):
        assert core.quality_to_step(q) == jcore.quality_to_step(q)
    for w, h, f in [(1, 1, 1), (63, 31, 5), (64, 32, 6), (1920, 1080, 64),
                    (7, 9, 2)]:
        assert core.padded_dims(w, h, f) == jcore.padded_dims(w, h, f)
        assert core.checked_pixel_count(w, h, f) == jcore.checked_pixel_count(w, h, f)
        for lv in (1, 2, 3, 4):
            assert (core.padded_dims_levels(w, h, f, lv)
                    == jcore.padded_dims_levels(w, h, f, lv))
    for wt in jcore.WaveletType:
        assert core.WaveletType(int(wt)).name == wt.name
        assert core.WaveletType.from_name(wt.name_str) == int(wt)
        assert core.WaveletType.from_u8(int(wt)) == int(wt)
    with pytest.raises(errors.InvalidBitstream):
        core.WaveletType.from_u8(3)
    with pytest.raises(ValueError):
        core.WaveletType.from_name("db4")


def test_errors_copy_has_the_five_variants():
    names = ["InvalidBufferSize", "InvalidDimensions", "DimensionOverflow",
             "InvalidBitstream", "InvalidQuantStep"]
    for name in names:
        mine, ref = getattr(errors, name), getattr(jerrors, name)
        assert issubclass(mine, errors.CodecError)
        assert issubclass(mine, ValueError)
        assert mine.__bases__[0].__name__ == ref.__bases__[0].__name__
    args = {"InvalidBufferSize": (4, 3), "InvalidDimensions": (0, 5),
            "DimensionOverflow": (), "InvalidBitstream": ("x",),
            "InvalidQuantStep": (0,)}
    for name, a in args.items():
        assert str(getattr(errors, name)(*a)) == str(getattr(jerrors, name)(*a))


def test_import_leaves_jax_out():
    code = ("import sys, alice_codec_tpu_torch, alice_codec_tpu_torch.alc3, "
            "alice_codec_tpu_torch._build; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m.startswith('alice_codec_tpu.') or m == 'alice_codec_tpu']; "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_default_device_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _device.resolve_device()
    with pytest.raises(RuntimeError):
        at.Alc3Codec()
    with pytest.raises(RuntimeError):
        at.DeviceChunk.from_numpy(
            width=2, height=2, frames=2, wavelet_type=0, quant_step=8,
            s_seg=8, streams=np.zeros((24, 16, 128), np.int32),
            counts=np.zeros(24, np.int32), hists=np.zeros((3, 256), np.uint32))
    assert _device.resolve_device("cpu") == torch.device("cpu")


# ── colour and pad ──────────────────────────────────────────────


@pytest.mark.parametrize("shape", [(1, 1, 1), (3, 5, 7), (5, 31, 63)])
def test_color_and_pad_match(shape):
    t, h, w = shape
    rng = np.random.default_rng(sum(shape))
    rgb = rng.integers(0, 256, size=(t, h, w, 3), dtype=np.uint8)
    ours = color.rgb_to_ycocg_r(torch.from_numpy(rgb))
    ref = jcolor.rgb_to_ycocg_r(jnp.asarray(rgb))
    for a, b in zip(ours, ref):
        assert a.dtype == torch.int16
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    back = color.ycocg_r_to_rgb(*ours)
    np.testing.assert_array_equal(_np(back), rgb)
    # out-of-range planes clamp like the reference
    planes = [rng.integers(-600, 600, size=(t, h, w), dtype=np.int16)
              for _ in range(3)]
    np.testing.assert_array_equal(
        _np(color.ycocg_r_to_rgb(*map(torch.from_numpy, planes))),
        np.asarray(jcolor.ycocg_r_to_rgb(*map(jnp.asarray, planes))))
    padded = core.padded_dims(w, h, t)
    got = pipeline._color_pad(torch.from_numpy(rgb), padded)
    want = jpipeline._color_pad(jnp.asarray(rgb), padded, dtype=jnp.int16)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(_np(got), np.asarray(want))


# ── quantize, zigzag, histograms ────────────────────────────────


def test_quant_symbols_histograms_match():
    rng = np.random.default_rng(0)
    v = rng.integers(-3000, 3000, size=(3, 4, 6, 10), dtype=np.int32)
    step = np.array([1, 7, 64], np.int32).reshape(3, 1, 1, 1)
    dz = np.array([1, 9, 64], np.int32).reshape(3, 1, 1, 1)
    q = quant.quantize(torch.from_numpy(v), torch.from_numpy(step),
                       torch.from_numpy(dz))
    jq = jquant.quantize(jnp.asarray(v), jnp.asarray(step), jnp.asarray(dz))
    np.testing.assert_array_equal(_np(q), np.asarray(jq))
    assert int(q.abs().max()) > 127  # exercises the u8 zigzag wrap
    s = quant.to_symbols(q)
    assert s.dtype == torch.uint8
    np.testing.assert_array_equal(_np(s), np.asarray(jquant.to_symbols(jq)))
    np.testing.assert_array_equal(
        _np(quant.from_symbols(s)), np.asarray(jquant.from_symbols(np.asarray(s))))
    np.testing.assert_array_equal(
        _np(quant.dequantize(q, torch.from_numpy(step))),
        np.asarray(jquant.dequantize(jq, jnp.asarray(step))))
    np.testing.assert_array_equal(
        _np(quant.build_histogram(s)),
        np.asarray(jquant.build_histogram(jnp.asarray(_np(s)))).astype(np.int64))
    sym2d = rng.integers(0, 256, size=(3, 16 * 128 * 3 + 77), dtype=np.uint8)
    for stride in (1, 16, 64):
        np.testing.assert_array_equal(
            _np(pipeline._hist_sample(torch.from_numpy(sym2d), stride)),
            np.asarray(jpipeline._hist_sample(jnp.asarray(sym2d), stride)))


# ── frequency tables ────────────────────────────────────────────


def _hist_cases():
    rng = np.random.default_rng(1)
    zero = np.zeros(256, np.uint32)
    single = zero.copy()
    single[7] = 12345
    huge = zero.copy()
    huge[:3] = [2**31 - 10**6, 10**6 - 100, 90]  # total just below 2^31
    rand = rng.integers(0, 5000, 256).astype(np.uint32)
    rand[rng.random(256) < 0.3] = 0
    # many tiny bins: the min-1 floor oversubscribes and the drain runs
    drain = np.ones(256, np.uint32)
    drain[200] = 10**7
    drain[201] = 10**7
    skew = (rng.pareto(1.0, 256) * 50).astype(np.uint32)
    return {"zero": zero, "single": single, "huge": huge, "random": rand,
            "drain": drain, "skew": skew}


@pytest.mark.parametrize("case", list(_hist_cases()))
def test_freq_table_matches_both_references(case):
    h = _hist_cases()[case]
    f, c = freq_table_device(torch.from_numpy(h.astype(np.int64)))
    jf, jc = j_freq_table(jnp.asarray(h))
    nf, nc = jrans_word.freq_table_words(h)
    for a, b in ((f, jf), (c, jc)):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    np.testing.assert_array_equal(_np(f), nf)
    np.testing.assert_array_equal(_np(c), nc)
    assert int(f.sum()) == rans_word.PROB_SCALE
    assert ((f == 0) == torch.from_numpy(h == 0)).all() or case == "zero"


def test_freq_table_batched_equals_single():
    hs = np.stack(list(_hist_cases().values())).astype(np.int64)
    f, c = freq_table_device(torch.from_numpy(hs))
    for i, h in enumerate(hs):
        fi, ci = freq_table_device(torch.from_numpy(h))
        assert torch.equal(f[i], fi) and torch.equal(c[i], ci)


def test_rans_word_copy_matches_spec():
    rng = np.random.default_rng(2)
    sym = np.where(rng.random(3 * 8 * 128) < 0.6, 0,
                   rng.integers(0, 40, 3 * 8 * 128)).astype(np.uint8)
    f, c = rans_word.freq_table_words(np.bincount(sym, minlength=256))
    ours = rans_word.encode_channel_words(sym, f, c, s_seg=8, ng=128)
    ref = jrans_word.encode_channel_words(sym, f, c, s_seg=8, ng=128)
    assert ours[0] == ref[0]
    np.testing.assert_array_equal(ours[1], ref[1])
