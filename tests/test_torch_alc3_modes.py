"""The port's ALC3 modes against the JAX package, on the CPU (the kernels'
plain versions): deep 16-bit symbols, AnalyticalRDO per-band steps and
multi-level decomposition.

* dense: byte-identical containers against a live JAX encode at tiny
  shapes, cross-decoding both ways (through bytes and through
  ``DeviceChunk.from_numpy`` / ``to_numpy``), and the JAX package's own
  mode tests (``tests/test_alc3.py``) mirrored on the port.  The JAX
  side decodes the port's containers with its NumPy entropy spec
  (``ops/rans_word``, which its own tests hold to its Pallas decoder)
  and its device inverse programs: the interpret-mode Pallas decoder
  would cost seconds of compile per mode;
* sparse compositions: the committed JAX goldens of
  ``tests/golden/torch/modes`` (written by
  ``tools/golden/gen_torch_mode_goldens.py``; a live JAX sparse encode
  costs minutes on a CPU) — re-encoded byte for byte and decoded to the
  JAX decodes; the ``slow`` test reruns the generator's JAX side live.
"""

import hashlib
import json
import struct
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from alice_codec_tpu import alc3 as jalc3
from alice_codec_tpu import pipeline as jpipeline
from alice_codec_tpu.alc3 import Alc3Codec as JaxCodec
from alice_codec_tpu.alc3 import DeviceChunk as JaxChunk
from alice_codec_tpu.core import WaveletType as JW
from alice_codec_tpu.core import padded_dims_levels
from alice_codec_tpu.errors import InvalidBitstream as JaxInvalidBitstream
from alice_codec_tpu.ops.rans_word import (decode_channel_words,
                                           decode_lut_words, freq_table_words)
from chip_smoke import golden_input

from alice_codec_tpu_torch import Alc3Codec, DeviceChunk
from alice_codec_tpu_torch.errors import InvalidBitstream

# The suite runs several pytest workers on the CPU at once: keep these
# small tensor ops on one thread so they do not compete with them.
torch.set_num_threads(1)

S_SEG = 8
ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden" / "torch" / "modes"
CASES = json.loads((GOLDEN / "manifest.json").read_text())["cases"]

#: dense mode → (codec keyword arguments, input (kind, seed, shape))
MODES = {
    "deep": (dict(quality=100, wavelet="haar"), ("noise", 12, (4, 16, 16))),
    "rdo": (dict(quality=85, wavelet="cdf53", rdo=True),
            ("chunk", 9, (4, 16, 16))),
    # T = 4 pads to 8 for three levels
    "levels": (dict(quality=90, wavelet="cdf97", levels=3),
               ("chunk", 40, (4, 16, 16))),
}


def _input(mode):
    kind, seed, shape = MODES[mode][1]
    return golden_input(kind, seed, shape)


def _fields(chunk) -> dict:
    """A JAX chunk's fields, as ``DeviceChunk.from_numpy`` takes them."""
    return dict(width=chunk.width, height=chunk.height, frames=chunk.frames,
                wavelet_type=int(chunk.wavelet_type),
                quant_step=chunk.quant_step, s_seg=chunk.s_seg,
                streams=np.asarray(chunk.streams),
                counts=np.asarray(chunk.counts), hists=np.asarray(chunk.hists),
                band_steps=chunk.band_steps, deep=chunk.deep,
                levels=chunk.levels, sparse=chunk.sparse, kcaps=chunk.kcaps)


def _jax_decode(data: bytes, exact: bool = False) -> np.ndarray:
    """The JAX package's decode of a one-chunk dense container: its parser,
    its NumPy entropy decoder per plane, then its device inverse program
    for the chunk's mode."""
    _, chunks = JaxCodec.from_bytes(data)
    ck = chunks[0]
    padded = padded_dims_levels(ck.width, ck.height, ck.frames, ck.levels)
    p = int(np.prod(padded))
    n_seg = ck.n_segments
    tables = np.asarray(jalc3._table_hists(
        ck.hists, p, s_seg=ck.s_seg, v_seg=jalc3._pick_v_seg(n_seg)))
    counts = np.asarray(ck.counts).astype(np.int64)
    streams = np.asarray(ck.streams).reshape(len(counts), -1)
    planes = []
    for c in range(ck.n_planes):
        rows = slice(c * n_seg, (c + 1) * n_seg)
        words = np.concatenate([s[:k] for s, k in zip(streams[rows],
                                                      counts[rows])])
        freqs, cums = freq_table_words(tables[c])
        planes.append(decode_channel_words(
            words.astype(np.uint16), counts[rows], p, s_seg=ck.s_seg, ng=128,
            freqs=freqs, cums=cums, cum_to_sym=decode_lut_words(cums)))
    sym = jnp.asarray(np.stack(planes))
    kw = dict(wavelet_type=ck.wavelet_type,
              dims=(ck.width, ck.height, ck.frames), padded=padded,
              exact=exact, interleaved=True)
    steps = jnp.full((3,), ck.quant_step, jnp.int32)
    if ck.band_steps is not None:
        out = jpipeline.decode_bands_device(sym, jnp.asarray(ck.band_steps),
                                            **kw)
    elif ck.deep:
        out = jpipeline.decode_deep_device(sym, steps, levels=ck.levels, **kw)
    else:
        out = jpipeline.decode_device(sym, steps, steps, levels=ck.levels, **kw)
    return np.asarray(out)


@pytest.fixture(scope="module")
def port_run():
    out = {}
    for mode, (kwargs, _) in MODES.items():
        codec = Alc3Codec(s_seg=S_SEG, device="cpu", **kwargs)
        chunk = codec.encode(_input(mode))
        out[mode] = dict(codec=codec, chunk=chunk,
                         data=Alc3Codec.to_bytes(chunk),
                         rgb=codec.decode(chunk, as_numpy=True))
    return out


@pytest.fixture(scope="module")
def jax_run(port_run):
    """Every JAX result of the dense modes, made once: per mode the JAX
    encode and its container, and the JAX decode of the PORT's container
    (:func:`_jax_decode`)."""
    out = {}
    for mode, (kwargs, _) in MODES.items():
        chunk = JaxCodec(s_seg=S_SEG, **kwargs).encode(_input(mode))
        out[mode] = dict(chunk=chunk, data=JaxCodec.to_bytes(chunk),
                         rgb=_jax_decode(port_run[mode]["data"]))
    return out


# ── dense modes against a live JAX encode ───────────────────────


@pytest.mark.parametrize("mode", list(MODES))
def test_mode_container_matches_jax(port_run, jax_run, mode):
    ours, theirs = port_run[mode], jax_run[mode]
    assert ours["data"] == theirs["data"]
    fields = ours["chunk"].to_numpy()
    jc = theirs["chunk"]
    np.testing.assert_array_equal(fields["counts"], np.asarray(jc.counts))
    np.testing.assert_array_equal(fields["hists"], np.asarray(jc.hists))
    assert (fields["deep"], fields["levels"]) == (jc.deep, jc.levels)
    if jc.band_steps is None:
        assert fields["band_steps"] is None
    else:
        np.testing.assert_array_equal(fields["band_steps"], jc.band_steps)
        assert fields["quant_step"] == jc.quant_step == int(jc.band_steps.min())


@pytest.mark.parametrize("mode", list(MODES))
def test_mode_cross_decode(port_run, jax_run, mode):
    """The JAX decode of the port's container equals the port's decode,
    and the port decodes the JAX container to it too."""
    ours = port_run[mode]
    np.testing.assert_array_equal(ours["rgb"], jax_run[mode]["rgb"])
    codec, chunks = Alc3Codec.from_bytes(jax_run[mode]["data"], device="cpu")
    assert (codec.rdo, codec.deep, codec.levels) == (
        ours["codec"].rdo, ours["codec"].deep, ours["codec"].levels)
    np.testing.assert_array_equal(codec.decode(chunks[0], as_numpy=True),
                                  ours["rgb"])


@pytest.mark.parametrize("mode", list(MODES))
def test_mode_device_chunk_interchange(port_run, jax_run, mode):
    ours = DeviceChunk.from_numpy(**_fields(jax_run[mode]["chunk"]),
                                  device="cpu")
    np.testing.assert_array_equal(
        port_run[mode]["codec"].decode(ours, as_numpy=True), port_run[mode]["rgb"])
    back = port_run[mode]["chunk"].to_numpy()
    back["wavelet_type"] = JW(back["wavelet_type"])
    assert JaxCodec.to_bytes(JaxChunk(**back)) == port_run[mode]["data"]
    again = DeviceChunk.from_numpy(**port_run[mode]["chunk"].to_numpy(),
                                   device="cpu")
    assert Alc3Codec.to_bytes(again) == port_run[mode]["data"]


def test_deep_q100_is_lossless_and_wide(port_run):
    rgb = _input("deep")
    ck = port_run["deep"]["chunk"]
    out = port_run["deep"]["codec"].decode(ck, exact=True, as_numpy=True)
    np.testing.assert_array_equal(out, rgb)
    # noise drives coefficients past the u8 zigzag: the hi planes code
    assert ck.hists.reshape(3, 2, 256)[:, 1, 1:].sum() > 0


# ── the JAX package's mode tests, mirrored ──────────────────────


def _video(t, h, w, seed=0):
    """tests/test_alc3.py's synthetic video."""
    rng = np.random.default_rng(seed)
    x = np.arange(w, dtype=np.int32)[None, None, :, None]
    y = np.arange(h, dtype=np.int32)[None, :, None, None]
    tt = np.arange(t, dtype=np.int32)[:, None, None, None]
    base = (x * 3 + y * 2 + tt * 7) % 256
    noise = rng.integers(0, 16, size=(t, h, w, 3), dtype=np.int32)
    return np.clip(base + noise, 0, 255).astype(np.uint8)


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return np.inf if mse == 0 else 10 * np.log10(255.0**2 / mse)


def _codec(**kwargs):
    return Alc3Codec(s_seg=S_SEG, device="cpu", **kwargs)


def _reparse(chunk):
    return Alc3Codec.from_bytes(Alc3Codec.to_bytes(chunk), device="cpu")


def test_deep_lossless_on_noise():
    rng = np.random.default_rng(12)
    rgb = rng.integers(0, 256, size=(4, 16, 16, 3), dtype=np.uint8)
    codec = _codec(quality=100, wavelet="cdf53")
    assert codec.deep  # on by default at q=100
    chunk = codec.encode(rgb)
    assert chunk.deep and chunk.n_planes == 6
    np.testing.assert_array_equal(
        codec.decode(chunk, exact=True, as_numpy=True), rgb)


def test_deep_container_roundtrip():
    rng = np.random.default_rng(13)
    rgb = rng.integers(0, 256, size=(2, 8, 8, 3), dtype=np.uint8)
    chunk = _codec(quality=100, wavelet="haar").encode(rgb)
    codec2, chunks2 = _reparse(chunk)
    assert codec2.deep and chunks2[0].deep
    np.testing.assert_array_equal(
        codec2.decode(chunks2[0], exact=True, as_numpy=True), rgb)


def test_deep_mode_opt_in_lossy():
    rgb = _video(2, 8, 8, seed=14)
    deep, shallow = _codec(quality=80, deep=True), _codec(quality=80)
    np.testing.assert_array_equal(
        deep.decode(deep.encode(rgb), as_numpy=True),
        shallow.decode(shallow.encode(rgb), as_numpy=True))


def test_rdo_roundtrip_and_container():
    rgb = _video(4, 16, 16, seed=9)
    codec = _codec(quality=85, rdo=True)
    chunk = codec.encode(rgb)
    assert chunk.band_steps is not None and chunk.band_steps.shape == (3, 8)
    assert (chunk.band_steps >= 1).all()
    out = codec.decode(chunk, as_numpy=True)
    assert out.shape == rgb.shape and _psnr(out, rgb) > 12
    codec2, chunks2 = _reparse(chunk)
    assert codec2.rdo
    np.testing.assert_array_equal(chunks2[0].band_steps, chunk.band_steps)
    np.testing.assert_array_equal(codec2.decode(chunks2[0], as_numpy=True), out)


def test_rdo_beats_fixed_step_bpp_at_matched_quality():
    rgb = _video(4, 32, 32, seed=11)
    fixed = _codec(quality=60).encode(rgb)
    rdo = _codec(quality=60, rdo=True).encode(rgb)
    assert rdo.compressed_size <= fixed.compressed_size * 1.5


@pytest.mark.parametrize("levels", [2, 3])
def test_multilevel_roundtrip(levels):
    rgb = _video(4, 16, 16, seed=40)
    codec = _codec(quality=90, levels=levels)
    chunk = codec.encode(rgb)
    assert chunk.levels == levels
    out = codec.decode(chunk, as_numpy=True)
    assert out.shape == rgb.shape and _psnr(out, rgb) > 23


def test_multilevel_lossless_deep():
    rng = np.random.default_rng(41)
    rgb = rng.integers(0, 256, size=(4, 16, 16, 3), dtype=np.uint8)
    codec = _codec(quality=100, levels=2)
    np.testing.assert_array_equal(
        codec.decode(codec.encode(rgb), exact=True, as_numpy=True), rgb)


def test_multilevel_container_roundtrip():
    rgb = _video(4, 16, 16, seed=42)
    codec = _codec(quality=85, levels=2)
    chunk = codec.encode(rgb)
    codec2, chunks2 = _reparse(chunk)
    assert codec2.levels == 2 and chunks2[0].levels == 2
    np.testing.assert_array_equal(codec2.decode(chunks2[0], as_numpy=True),
                                  codec.decode(chunk, as_numpy=True))


def test_multilevel_improves_smooth_compression():
    x = np.linspace(0, 200, 32)[None, :, None, None]
    y = np.linspace(0, 55, 32)[None, None, :, None]
    rgb = np.broadcast_to((x + y).astype(np.uint8), (4, 32, 32, 3)).copy()
    c1 = _codec(quality=70, levels=1).encode(rgb)
    c2 = _codec(quality=70, levels=2).encode(rgb)
    assert c2.compressed_size < c1.compressed_size


def test_rdo_sparse_composition():
    rgb = _video(2, 16, 16, seed=95)
    rs, rd = _codec(quality=70, rdo=True, sparse=True), _codec(quality=70, rdo=True)
    ck = rs.encode(rgb)
    assert ck.sparse and ck.band_steps is not None
    out_rs = rs.decode(ck, as_numpy=True)
    np.testing.assert_array_equal(out_rs, rd.decode(rd.encode(rgb), as_numpy=True))
    codec2, chunks2 = _reparse(ck)
    assert codec2.rdo and codec2.sparse
    assert chunks2[0].sparse and chunks2[0].band_steps is not None
    np.testing.assert_array_equal(chunks2[0].band_steps, ck.band_steps)
    np.testing.assert_array_equal(codec2.decode(chunks2[0], as_numpy=True), out_rs)


def test_sparse_levels_composition():
    rgb = _video(4, 16, 16, seed=96)
    sl, dl = _codec(quality=80, sparse=True, levels=2), _codec(quality=80, levels=2)
    ck = sl.encode(rgb)
    assert ck.sparse and ck.levels == 2
    out = sl.decode(ck, as_numpy=True)
    np.testing.assert_array_equal(out, dl.decode(dl.encode(rgb), as_numpy=True))
    codec2, chunks2 = _reparse(ck)
    assert chunks2[0].levels == 2 and chunks2[0].sparse
    np.testing.assert_array_equal(codec2.decode(chunks2[0], as_numpy=True), out)


def test_deep_sparse_composition():
    rng = np.random.default_rng(97)
    rgb = rng.integers(0, 256, size=(2, 8, 8, 3), dtype=np.uint8)
    ds = _codec(quality=100, wavelet="haar", sparse=True)
    assert ds.deep and ds.sparse
    ck = ds.encode(rgb)
    assert ck.deep and ck.sparse and ck.n_planes == 12
    np.testing.assert_array_equal(ds.decode(ck, exact=True, as_numpy=True), rgb)
    codec2, chunks2 = _reparse(ck)
    assert codec2.deep and codec2.sparse
    assert chunks2[0].deep and chunks2[0].sparse
    np.testing.assert_array_equal(
        codec2.decode(chunks2[0], exact=True, as_numpy=True), rgb)


def test_deep_sparse_lossy_matches_deep_dense():
    rgb = _video(2, 8, 8, seed=98)
    ds, dd = _codec(quality=80, deep=True, sparse=True), _codec(quality=80, deep=True)
    np.testing.assert_array_equal(ds.decode(ds.encode(rgb), as_numpy=True),
                                  dd.decode(dd.encode(rgb), as_numpy=True))


# ── mode container validation ───────────────────────────────────


def _rdo_corruptions(data: bytes) -> dict:
    n_seg = struct.unpack_from("<I", data, 26)[0]
    steps0 = 31 + 1040 + 4 * n_seg  # the first plane's band steps

    def patch(off, fmt, value):
        b = bytearray(data)
        struct.pack_into(fmt, b, off, value)
        return bytes(b)

    return {"zero_band_step": patch(steps0, "<i", 0),
            "negative_band_step": patch(steps0 + 28, "<i", -3),
            "rdo_and_deep": patch(30, "<B", 1 | 2),
            "truncated_band_steps": data[: steps0 + 16]}


@pytest.mark.parametrize("case", ["zero_band_step", "negative_band_step",
                                  "rdo_and_deep", "truncated_band_steps"])
def test_corrupt_mode_containers_raise(port_run, case):
    bad = _rdo_corruptions(port_run["rdo"]["data"])[case]
    with pytest.raises(InvalidBitstream):
        Alc3Codec.from_bytes(bad, device="cpu")
    with pytest.raises(JaxInvalidBitstream):
        JaxCodec.from_bytes(bad)


def test_rdo_with_levels_flags_rejected(port_run):
    """A container that claims rdo with two levels parses, and both
    packages refuse the codec it asks for."""
    bad = bytearray(port_run["rdo"]["data"])
    bad[30] = 1 | 4
    with pytest.raises(ValueError, match="single-level"):
        Alc3Codec.from_bytes(bytes(bad), device="cpu")
    with pytest.raises(ValueError, match="single-level"):
        JaxCodec.from_bytes(bytes(bad))


# ── sparse compositions against the committed JAX goldens ───────


def _sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


@pytest.mark.parametrize("case", list(CASES))
def test_mode_golden(case):
    spec = CASES[case]
    data = (GOLDEN / spec["file"]).read_bytes()
    assert _sha(data) == spec["sha256"]
    codec = Alc3Codec(device="cpu", **spec["codec"])
    rgb = golden_input(spec["kind"], spec["seed"], spec["shape"])
    chunk = codec.encode(rgb)
    assert list(chunk.kcaps) == spec["kcaps"]
    assert Alc3Codec.to_bytes(chunk) == data
    codec2, chunks = Alc3Codec.from_bytes(data, device="cpu")
    assert (codec2.rdo, codec2.deep, codec2.levels, codec2.sparse) == (
        codec.rdo, codec.deep, codec.levels, True)
    assert Alc3Codec.to_bytes(chunks) == data
    for exact, key in ((False, "rgb_sha256"), (True, "rgb_exact_sha256")):
        out = codec2.decode(chunks[0], exact=exact, as_numpy=True)
        assert _sha(out.tobytes()) == spec[key]
    if codec.deep and codec.quality == 100:
        np.testing.assert_array_equal(
            codec2.decode(chunks[0], exact=True, as_numpy=True), rgb)


def test_mode_goldens_cover_the_wire():
    """The cases reach what the generator's docstring says they do: dense,
    sparse and elided planes across the deep, rdo and levels modes."""
    kc = {case: spec["kcaps"] for case, spec in CASES.items()}
    full = 1 << 20  # the dense capacity of these one-block planes at s_seg 8
    assert len(kc["deep"]) == 6 and 0 < min(kc["deep"]) and max(kc["deep"]) < full
    assert kc["deep_dense"][0::2] == [full] * 3 and max(kc["deep_dense"][1::2]) < full
    assert kc["deep_lossy"][1::2] == [0, 0, 0]
    assert kc["rdo_gray"][1:] == [0, 0]
    flags = {case: (GOLDEN / spec["file"]).read_bytes()[30]
             for case, spec in CASES.items()}
    assert flags == {"deep": 16 | 2, "deep_dense": 16 | 2, "deep_lossy": 16 | 2,
                     "rdo": 16 | 1, "rdo_gray": 16 | 1, "levels": 16 | 4}


@pytest.mark.slow
def test_mode_goldens_are_what_jax_writes():
    """The JAX sparse codec, live, writes the committed containers and
    decodes them to the committed RGB (minutes: interpret-mode Pallas)."""
    sys.path.insert(0, str(ROOT / "tools" / "golden"))
    from gen_torch_mode_goldens import make_cases

    made = make_cases()
    assert set(made) == set(CASES)
    for case, (data, kcaps, rgb_sha, exact_sha) in made.items():
        spec = CASES[case]
        assert _sha(data) == spec["sha256"]
        assert list(kcaps) == spec["kcaps"]
        assert (rgb_sha, exact_sha) == (spec["rgb_sha256"],
                                        spec["rgb_exact_sha256"])
