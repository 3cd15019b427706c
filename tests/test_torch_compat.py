"""The port's compat wires against the JAX package and the committed
fixtures: the reference-layout transform, the `.alc` single-chunk wire
(``FrameEncoder`` / ``FrameDecoder`` / ``EncodedChunk``) and the batched
ALC2 wire (``parallel``: host and device entropy).  Byte for byte.

* all 48 ``tests/golden/cpp/`` fixtures (the independent C++ pipeline)
  and every ``tests/golden/self/`` fixture: the port decodes the
  committed container to the committed RGB (or its digest) and
  re-encodes the closed-form input to the committed bytes;
* at tiny shapes the port's containers equal JAX's, and each package
  decodes the other's.

Every JAX result is computed once, in a module-scoped fixture."""

import hashlib
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import alice_codec_tpu as jalc
from alice_codec_tpu import pipeline as jpipeline
from alice_codec_tpu.core import WaveletType as JW
from alice_codec_tpu.ops import wavelet as jwavelet
from alice_codec_tpu.parallel import batch as jbatch
from alice_codec_tpu.utils.golden import golden_rgb as j_golden_rgb

import alice_codec_tpu_torch as at
from alice_codec_tpu_torch import pipeline
from alice_codec_tpu_torch.core import WaveletType
from alice_codec_tpu_torch.errors import (InvalidBitstream, InvalidBufferSize,
                                          InvalidDimensions)
from alice_codec_tpu_torch.ops import wavelet
from alice_codec_tpu_torch.parallel import (BatchFrameDecoder, BatchFrameEncoder,
                                            EncodedChunkStream, chunk_frames,
                                            chunk_mesh)
from alice_codec_tpu_torch.utils.golden import golden_rgb

# several pytest workers share the CPU: keep torch on one thread
torch.set_num_threads(1)

GOLDEN = Path(__file__).parent / "golden"
T, H, W = 4, 16, 16  # the tiny chunk of the cross-package checks
QUALITIES = (10, 90, 100)


def _records(kind: str):
    return json.loads((GOLDEN / kind / "manifest.json").read_text())["fixtures"]


def _params(kind: str):
    return [pytest.param(r, id=r["name"]) for r in _records(kind)]


def _sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def _chunk(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (T, H, W, 3), np.uint8)


def _sparkle() -> np.ndarray:
    """A flat chunk with a few hundred random pixels: at q=100 its
    reference-exact tables cross PROB_SCALE, so every channel takes the
    encoder's sanitized-table retry."""
    rng = np.random.default_rng(0)
    rgb = np.full((T, H, W, 3), 128, np.uint8)
    k = int(rng.integers(50, 400))
    rgb.reshape(-1)[rng.integers(0, rgb.size, k)] = rng.integers(0, 256, k)
    return rgb


def _batch() -> np.ndarray:
    return np.stack([_chunk(30), _chunk(31)])


@pytest.fixture(scope="module")
def jax_ref():
    """JAX's `.alc` bytes and decodes (both inverse modes) per (quality,
    wavelet), and of the sparkle chunk; JAX's ALC2 bytes per (lanes,
    entropy) and their decode."""
    rgb = _chunk(7)
    alc = {}
    for q in QUALITIES:
        for wt in WaveletType:
            data = jalc.FrameEncoder(q, wt.name_str).encode(
                rgb.reshape(-1), W, H, T).to_bytes()
            chunk = jalc.EncodedChunk.from_bytes(data)
            alc[q, wt] = (data, [np.asarray(jalc.FrameDecoder().decode(chunk, exact=e))
                                 for e in (False, True)])
    sp = jalc.FrameEncoder(100, "cdf53").encode(_sparkle(), W, H, T).to_bytes()
    sp_rgb = np.asarray(jalc.FrameDecoder().decode(jalc.EncodedChunk.from_bytes(sp)))
    alc2 = {}
    for lanes in (4, 8):
        for dev_ent in (False, True):
            data = jbatch.BatchFrameEncoder(
                90, "cdf97", n_lanes=lanes, device_entropy=dev_ent).encode(
                    _batch()).to_bytes()
            out = jbatch.BatchFrameDecoder(device_entropy=dev_ent).decode(
                jbatch.EncodedChunkStream.from_bytes(data))
            alc2[lanes, dev_ent] = (data, np.asarray(out))
    return dict(rgb=rgb, alc=alc, sparkle=(sp, sp_rgb), alc2=alc2)


# ── the committed fixtures ──────────────────────────────────────


@pytest.mark.parametrize("rec", _params("cpp"))
def test_cpp_golden_on_port(rec):
    """The independent C++ pipeline's container decodes to its committed
    RGB, and the port's encoder writes its bytes."""
    data = (GOLDEN / "cpp" / f"{rec['name']}.alc").read_bytes()
    assert _sha(data) == rec["alc_sha256"]
    want = np.frombuffer((GOLDEN / "cpp" / f"{rec['name']}.rgb").read_bytes(), np.uint8)
    out = at.FrameDecoder(device="cpu").decode(at.EncodedChunk.from_bytes(data))
    np.testing.assert_array_equal(out, want)
    rgb = golden_rgb(rec["w"], rec["h"], rec["f"]).reshape(-1)
    ours = at.FrameEncoder(rec["quality"], rec["wavelet"], device="cpu").encode(
        rgb, rec["w"], rec["h"], rec["f"])
    assert ours.to_bytes() == data


@pytest.mark.parametrize("rec", _params("self"))
def test_self_golden_on_port(rec):
    """The JAX package's committed container decodes to its RGB digest,
    and the port re-encodes the input to its bytes."""
    data = (GOLDEN / "self" / f"{rec['name']}.alc").read_bytes()
    assert _sha(data) == rec["alc_sha256"]
    out = at.FrameDecoder(device="cpu").decode(at.EncodedChunk.from_bytes(data))
    assert _sha(out.tobytes()) == rec["rgb_sha256"]
    rgb = golden_rgb(rec["w"], rec["h"], rec["f"])  # (T, H, W, 3) input form
    ours = at.FrameEncoder(rec["quality"], rec["wavelet"], device="cpu").encode(
        rgb, rec["w"], rec["h"], rec["f"])
    assert ours.to_bytes() == data


@pytest.mark.parametrize("dims", [(1, 1, 1), (17, 13, 3), (32, 24, 8), (20, 14, 64)])
def test_golden_rgb_copy_matches_jax(dims):
    np.testing.assert_array_equal(golden_rgb(*dims), j_golden_rgb(*dims))


# ── the reference-layout transform ──────────────────────────────


@pytest.mark.parametrize("wt", list(WaveletType))
def test_reference_layout_transform_matches_jax(wt):
    """``forward_3d`` / ``inverse_3d`` in the [low | high] layout equal
    JAX's on even shapes (both inverse modes), and the layout is a
    permutation of the interleaved one."""
    rng = np.random.default_rng(int(wt))
    x = rng.integers(-3000, 3000, (3, 4, 6, 10)).astype(np.int32)
    jw = JW(int(wt))
    want = np.array(jwavelet.forward_3d(jnp.asarray(x), jw))
    got = wavelet.forward_3d(torch.from_numpy(x), wt)
    np.testing.assert_array_equal(got.numpy(), want)
    for exact in (False, True):
        np.testing.assert_array_equal(
            wavelet.inverse_3d(torch.from_numpy(want), wt, exact=exact).numpy(),
            np.asarray(jwavelet.inverse_3d(jnp.asarray(want), jw, exact=exact)))
    assert torch.equal(wavelet.interleave_3d(wavelet.deinterleave_3d(got)), got)
    with pytest.raises(ValueError, match="even"):
        wavelet.deinterleave_3d(torch.zeros(3, 4, 6, 9, dtype=torch.int32))


def _extreme(kind: str) -> np.ndarray:
    if kind == "zero":
        return np.zeros((T, H, W, 3), np.uint8)
    if kind == "full":
        return np.full((T, H, W, 3), 255, np.uint8)
    t, y, x = np.meshgrid(np.arange(T), np.arange(H), np.arange(W), indexing="ij")
    odd = (t + y + x) % 2 == 1  # red against blue: Y, Co and Cg all swing
    return np.stack([np.where(odd, 255, 0), np.zeros_like(t),
                     np.where(odd, 0, 255)], -1).astype(np.uint8)


@pytest.mark.parametrize("kind", ["zero", "full", "checker"])
def test_reference_encode_stage_exact_on_extreme_content(kind):
    """The fused lift + quantize kernel (int16 between its passes) then
    deinterleaving gives JAX's int32 reference-layout symbols and
    histograms under CDF 9/7 on all-0, all-255 and max-amplitude
    checkerboard chunks (steps 1 and 8), and the decode stage equals
    JAX's."""
    rgb = _extreme(kind)
    for step in (1, 8):
        sym, hist, _ = pipeline.encode_device(
            torch.from_numpy(rgb), step, step, wavelet_type=WaveletType.CDF97,
            padded=(W, H, T))
        jsym, jhist = jpipeline.encode_device(
            jnp.asarray(rgb), jnp.int32(step), jnp.int32(step),
            wavelet_type=JW.CDF97, padded=(W, H, T))
        np.testing.assert_array_equal(sym.numpy(), np.asarray(jsym))
        np.testing.assert_array_equal(hist.numpy(), np.asarray(jhist))
        steps = np.full(3, step, np.int32)
        out = pipeline.decode_device(sym, torch.from_numpy(steps),
                                     wavelet_type=WaveletType.CDF97,
                                     dims=(W, H, T), padded=(W, H, T))
        want = jpipeline.decode_device(jsym, jnp.asarray(steps), jnp.asarray(steps),
                                       wavelet_type=JW.CDF97, dims=(W, H, T),
                                       padded=(W, H, T))
        np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="single-level"):
        pipeline.encode_device(torch.from_numpy(rgb), 8, 8,
                               wavelet_type=WaveletType.CDF97,
                               padded=(W, H, T), levels=2)


# ── the `.alc` wire against JAX ─────────────────────────────────


@pytest.mark.parametrize("wt", list(WaveletType), ids=lambda w: w.name_str)
@pytest.mark.parametrize("q", QUALITIES)
def test_alc_matches_jax_and_cross_decodes(jax_ref, q, wt):
    want_bytes, want_rgb = jax_ref["alc"][q, wt]
    rgb = jax_ref["rgb"]
    chunk = at.FrameEncoder(q, wt.name_str, device="cpu").encode(rgb, W, H, T)
    data = chunk.to_bytes()
    assert data == want_bytes
    dec = at.FrameDecoder(device="cpu")
    for exact, want in zip((False, True), want_rgb):
        np.testing.assert_array_equal(
            dec.decode(at.EncodedChunk.from_bytes(want_bytes), exact=exact), want)
    np.testing.assert_array_equal(
        np.asarray(jalc.FrameDecoder().decode(jalc.EncodedChunk.from_bytes(data))),
        want_rgb[0])
    # a torch input and the flat reference layout give the same chunk
    flat = at.FrameEncoder(q, wt, device="cpu").encode(
        torch.from_numpy(rgb.reshape(-1)), W, H, T)
    assert flat.to_bytes() == data
    assert chunk.compressed_size == len(data) - 18 - 3 * 1040
    assert chunk.wavelet == wt.name_str and repr(chunk).startswith("EncodedChunk(")


def test_alc_overflow_retry_matches_jax(jax_ref):
    """Where the reference-exact table overflows, the encoder re-codes
    with the sanitized table and the decoder detects which table coded
    each channel by the final-state invariant — as in JAX."""
    want_bytes, want_rgb = jax_ref["sparkle"]
    data = at.FrameEncoder(100, "cdf53", device="cpu").encode(
        _sparkle(), W, H, T).to_bytes()
    assert data == want_bytes
    chunk = at.EncodedChunk.from_bytes(data)
    out = at.FrameDecoder(device="cpu").decode(chunk, strict=True)
    np.testing.assert_array_equal(out, want_rgb)
    hdr = chunk.channel_headers[0]
    stream = chunk.compressed_data[: hdr.compressed_len]
    ref = at.FrequencyTable.from_histogram(hdr.histogram)
    sane = at.FrequencyTable.from_histogram(hdr.histogram, sanitize=True)
    assert not np.array_equal(ref.freqs, sane.freqs)  # the retry table coded it
    np.testing.assert_array_equal(
        pipeline._decode_channel(stream, hdr.num_symbols, hdr.histogram),
        jpipeline._decode_channel(stream, hdr.num_symbols, hdr.histogram))


def test_alc_validation_errors():
    data = at.FrameEncoder(50, device="cpu").encode(_chunk(3), W, H, T).to_bytes()
    for bad, match in ((data[:100], "too short"), (b"XXXX" + data[4:], "magic"),
                       (data[:4] + b"\x02" + data[5:], "version"),
                       (data[:-1], "truncated")):
        with pytest.raises(InvalidBitstream, match=match):
            at.EncodedChunk.from_bytes(bad)
    with pytest.raises(InvalidBitstream):
        at.EncodedChunk.from_bytes(data[:5] + b"\x07" + data[6:])  # wavelet id
    chunk = at.EncodedChunk.from_bytes(data)
    dec = at.FrameDecoder(device="cpu")
    chunk.channel_headers[1].num_symbols += 1
    with pytest.raises(InvalidBitstream, match="num_symbols"):
        dec.decode(chunk)
    chunk = at.EncodedChunk.from_bytes(data)
    chunk.channel_headers[2].compressed_len += 1
    with pytest.raises(InvalidBitstream, match="overrun"):
        dec.decode(chunk)
    chunk = at.EncodedChunk.from_bytes(data)
    payload = bytearray(chunk.compressed_data)
    payload[10] ^= 0xFF
    chunk.compressed_data = bytes(payload)
    with pytest.raises(InvalidBitstream, match="invariant"):
        dec.decode(chunk, strict=True)
    assert dec.decode(chunk).shape == (T * H * W * 3,)  # permissive default
    enc = at.FrameEncoder(device="cpu")
    empty = enc.encode(np.zeros(0, np.uint8), 0, 4, 2)
    assert empty.compressed_size == 0 and dec.decode(empty).size == 0
    with pytest.raises(InvalidBufferSize):
        enc.encode(np.zeros(5, np.uint8), 0, 4, 2)
    with pytest.raises(InvalidBufferSize):
        enc.encode(np.zeros(10, np.uint8), 2, 2, 1)


# ── the ALC2 wire against JAX ───────────────────────────────────


@pytest.mark.parametrize("device_entropy", [False, True], ids=["host", "device"])
@pytest.mark.parametrize("lanes", [4, 8])
def test_alc2_matches_jax_and_cross_decodes(jax_ref, lanes, device_entropy):
    want_bytes, want_rgb = jax_ref["alc2"][lanes, device_entropy]
    enc = BatchFrameEncoder(90, "cdf97", n_lanes=lanes,
                            device_entropy=device_entropy, device="cpu")
    stream = enc.encode(_batch())
    data = stream.to_bytes()
    assert data == want_bytes
    dec = BatchFrameDecoder(device_entropy=device_entropy, device="cpu")
    got = dec.decode(EncodedChunkStream.from_bytes(want_bytes))
    np.testing.assert_array_equal(got, want_rgb)
    other = jbatch.BatchFrameDecoder(device_entropy=not device_entropy).decode(
        jbatch.EncodedChunkStream.from_bytes(data))
    np.testing.assert_array_equal(np.asarray(other), want_rgb)
    on_dev = dec.decode(stream, as_numpy=False)
    assert isinstance(on_dev, torch.Tensor) and on_dev.shape == (2, T, H, W, 3)
    # the host path and the lane spec agree with the device path
    assert stream.n_chunks == 2 and stream.compressed_size == len(stream.payload)


def test_alc2_lane_spec_and_padding():
    """The pure-Python N-way coder (the spec) writes the native coder's
    lanes, and the lane padding of v2 is 8-aligned per lane."""
    from alice_codec_tpu_torch.parallel import batch

    assert batch._lane_sym_count(1024, 4) == 1024
    assert batch._lane_sym_count(1000, 7) == 1008
    assert batch._lane_sym_count(4096 * 32400, 4096) == 4096 * 32400
    stream = BatchFrameEncoder(90, n_lanes=4, device="cpu").encode(_batch())
    sym, _ = BatchFrameEncoder(90, n_lanes=4, device="cpu").encode_device_stage(_batch())
    hdr = stream.chunk_headers[0][0]
    table = at.FrequencyTable.from_histogram(hdr.histogram, sanitize=True)
    data, lens = batch._nway_encode_py(sym[0, 0].numpy(), table, 4)
    assert data == stream.payload[: hdr.compressed_len]
    np.testing.assert_array_equal(lens, stream.lane_lens[0, 0])
    np.testing.assert_array_equal(
        batch._nway_decode_py(data, sym.shape[-1], lens, table), sym[0, 0].numpy())
    frames = np.arange(5 * 2 * 2 * 3, dtype=np.uint8).reshape(5, 2, 2, 3)
    b, n = chunk_frames(frames, 2)
    assert b.shape == (3, 2, 2, 2, 3) and n == 5 and (b[2, 1] == frames[4]).all()


def test_alc2_validation_errors():
    with pytest.raises(InvalidBitstream, match="magic"):
        EncodedChunkStream.from_bytes(b"XXXX" + b"\x00" * 100)
    with pytest.raises(InvalidBitstream, match="too short"):
        EncodedChunkStream.from_bytes(b"AL")
    data = BatchFrameEncoder(n_lanes=4, device="cpu").encode(_batch()[:1]).to_bytes()
    with pytest.raises(InvalidBitstream, match="version"):
        EncodedChunkStream.from_bytes(data[:4] + b"\x01" + data[5:])  # v1
    with pytest.raises(InvalidBitstream, match="payload"):
        EncodedChunkStream.from_bytes(data[:-10])
    with pytest.raises(InvalidBitstream, match="header"):
        EncodedChunkStream.from_bytes(data[:26 + 1040])
    stream = EncodedChunkStream.from_bytes(data)
    stream.chunk_headers[0][1].num_symbols -= 1
    for dev_ent in (False, True):
        with pytest.raises(InvalidBitstream, match="num_symbols"):
            BatchFrameDecoder(device_entropy=dev_ent, device="cpu").decode(stream)
    stream = EncodedChunkStream.from_bytes(data)
    stream.chunk_headers[0][2].compressed_len += 1
    with pytest.raises(InvalidBitstream, match="overrun"):
        BatchFrameDecoder(device="cpu").decode(stream)
    with pytest.raises(InvalidBufferSize):
        BatchFrameEncoder(device="cpu").encode(np.zeros((2, 4, 4, 3), np.uint8))
    # a mesh splits the batch's leading axis evenly, or raises
    mesh = chunk_mesh(devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="split"):
        BatchFrameEncoder(n_lanes=4, mesh=mesh).encode(_batch()[:1])
    with pytest.raises(ValueError, match="split"):
        BatchFrameDecoder(mesh=mesh).decode(EncodedChunkStream.from_bytes(data))
    assert BatchFrameDecoder(pallas_entropy=True, device="cpu").device_entropy


def test_compat_entry_points_default_to_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (at.FrameEncoder, at.FrameDecoder, BatchFrameEncoder,
                 BatchFrameDecoder):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
