"""The port's dense ALC3 codec against the JAX package, end to end on the
CPU (the kernels' plain versions): byte-identical containers, decodes in
both inverse modes, cross-decoding through bytes and through
``DeviceChunk.from_numpy`` / ``to_numpy``, the committed JAX golden
(``tests/golden/torch``, written by ``tools/golden/gen_torch_goldens.py``),
container validation and the modes not ported yet."""

import hashlib
import json
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

from alice_codec_tpu.alc3 import Alc3Codec as JaxCodec
from alice_codec_tpu.alc3 import DeviceChunk as JaxChunk
from alice_codec_tpu.core import WaveletType as JW
from alice_codec_tpu.errors import InvalidBitstream as JaxInvalidBitstream
from bench import _test_chunk

from alice_codec_tpu_torch import Alc3Codec, DeviceChunk, WaveletType
from alice_codec_tpu_torch.errors import InvalidBitstream, InvalidBufferSize

# The suite runs several pytest workers on the CPU at once: keep these
# small tensor ops on one thread so they do not compete with them.
torch.set_num_threads(1)

GOLDEN = Path(__file__).parent / "golden" / "torch"
MANIFEST = json.loads((GOLDEN / "manifest.json").read_text())
S_SEG = MANIFEST["s_seg"]


def _rgb(seed=None):
    m = MANIFEST
    return _test_chunk(m["t"], m["h"], m["w"],
                       seed=m["seed"] if seed is None else seed)


#: qualities whose containers are compared with the JAX package's
QUALITIES = (10, 50)


@pytest.fixture(scope="module")
def jax_run():
    """Every JAX result the module compares with, made in one fixture so
    each JAX program compiles once (the quality is a traced argument):
    the golden input's encode and its two decodes, and the encodes of a
    second input at each of QUALITIES."""
    codec = JaxCodec(quality=MANIFEST["quality"], wavelet=MANIFEST["wavelet"],
                     s_seg=S_SEG)
    chunk = codec.encode(_rgb())
    other = {q: JaxCodec(q, MANIFEST["wavelet"], s_seg=S_SEG).encode(_rgb(seed=7))
             for q in QUALITIES}
    return dict(
        codec=codec, chunk=chunk, data=JaxCodec.to_bytes(chunk), other=other,
        compat=np.asarray(codec.decode(chunk, as_numpy=True)),
        exact=np.asarray(codec.decode(chunk, exact=True, as_numpy=True)))


@pytest.fixture(scope="module")
def port_run():
    codec = Alc3Codec(quality=MANIFEST["quality"], wavelet=MANIFEST["wavelet"],
                      s_seg=S_SEG, device="cpu")
    chunk = codec.encode(_rgb())
    return dict(codec=codec, chunk=chunk, data=Alc3Codec.to_bytes(chunk))


# ── the committed golden ────────────────────────────────────────


def test_golden_is_still_what_jax_writes(jax_run):
    for name, digest in MANIFEST["sha256"].items():
        assert hashlib.sha256((GOLDEN / name).read_bytes()).hexdigest() == digest
    assert jax_run["data"] == (GOLDEN / "dense.alc").read_bytes()
    for mode in ("compat", "exact"):
        assert jax_run[mode].tobytes() == (GOLDEN / f"dense.{mode}.rgb").read_bytes()
    # the two inverse modes really differ on this content
    assert jax_run["compat"].tobytes() != jax_run["exact"].tobytes()


def test_port_reproduces_golden(port_run):
    golden = (GOLDEN / "dense.alc").read_bytes()
    assert port_run["data"] == golden
    codec, chunks = Alc3Codec.from_bytes(golden, device="cpu")
    assert (codec.quality, codec.wavelet_type, codec.s_seg) == (
        MANIFEST["quality"], WaveletType.from_name(MANIFEST["wavelet"]), S_SEG)
    for mode, exact in (("compat", False), ("exact", True)):
        out = codec.decode(chunks[0], exact=exact, as_numpy=True)
        assert out.tobytes() == (GOLDEN / f"dense.{mode}.rgb").read_bytes()


# ── cross-decoding ──────────────────────────────────────────────


def test_cross_decode_through_bytes(jax_run, port_run):
    _, jchunks = JaxCodec.from_bytes(port_run["data"])
    for mode, exact in (("compat", False), ("exact", True)):
        ours = port_run["codec"].decode(port_run["chunk"], exact=exact,
                                        as_numpy=True)
        np.testing.assert_array_equal(ours, jax_run[mode])
        np.testing.assert_array_equal(
            np.asarray(jax_run["codec"].decode(jchunks[0], exact=exact,
                                               as_numpy=True)), ours)


def test_cross_decode_through_device_chunk(jax_run, port_run):
    jc = jax_run["chunk"]
    fields = dict(width=jc.width, height=jc.height, frames=jc.frames,
                  wavelet_type=int(jc.wavelet_type), quant_step=jc.quant_step,
                  s_seg=jc.s_seg, streams=np.asarray(jc.streams),
                  counts=np.asarray(jc.counts), hists=np.asarray(jc.hists))
    ours = DeviceChunk.from_numpy(**fields, device="cpu")
    np.testing.assert_array_equal(
        port_run["codec"].decode(ours, as_numpy=True), jax_run["compat"])
    back = port_run["chunk"].to_numpy()
    back["wavelet_type"] = JW(back["wavelet_type"])
    theirs = JaxChunk(**back)
    np.testing.assert_array_equal(
        np.asarray(jax_run["codec"].decode(theirs, exact=True, as_numpy=True)),
        jax_run["exact"])
    assert JaxCodec.to_bytes(theirs) == port_run["data"]
    again = DeviceChunk.from_numpy(**port_run["chunk"].to_numpy(), device="cpu")
    assert Alc3Codec.to_bytes(again) == port_run["data"]


# ── byte-identical containers ───────────────────────────────────


# The filters' lifting is held to the JAX package in test_torch_lift.py
# (all three); the rest of the path does not depend on the filter.
@pytest.mark.parametrize("quality", QUALITIES)
def test_container_bytes_match_jax(jax_run, quality):
    chunk = Alc3Codec(quality, MANIFEST["wavelet"], s_seg=S_SEG,
                      device="cpu").encode(_rgb(seed=7))
    jchunk = jax_run["other"][quality]
    assert Alc3Codec.to_bytes(chunk) == JaxCodec.to_bytes(jchunk)
    # the device representation agrees too (JAX's stream rows may hold
    # scratch words past a zero count; the port zeroes them)
    fields = chunk.to_numpy()
    np.testing.assert_array_equal(fields["counts"], np.asarray(jchunk.counts))
    np.testing.assert_array_equal(fields["hists"], np.asarray(jchunk.hists))
    flat = fields["streams"].reshape(len(fields["counts"]), -1)
    jflat = np.asarray(jchunk.streams).reshape(flat.shape)
    for i, k in enumerate(fields["counts"]):
        np.testing.assert_array_equal(flat[i, :k], jflat[i, :k])
        assert not flat[i, k:].any()


def test_multi_chunk_container(jax_run, port_run):
    second = port_run["codec"].encode(_rgb(seed=2))
    data = Alc3Codec.to_bytes([port_run["chunk"], second])
    fields = second.to_numpy()
    fields["wavelet_type"] = JW(fields["wavelet_type"])
    assert data == JaxCodec.to_bytes([jax_run["chunk"], JaxChunk(**fields)])
    _, chunks = Alc3Codec.from_bytes(data, device="cpu")
    assert len(chunks) == 2
    assert Alc3Codec.to_bytes(chunks) == data


def test_roundtrip_accepts_tensor_and_checks_rank(port_run):
    codec = port_run["codec"]
    rgb = torch.from_numpy(_rgb())
    assert Alc3Codec.to_bytes(codec.encode(rgb)) == port_run["data"]
    out = codec.decode(port_run["chunk"])
    assert isinstance(out, torch.Tensor) and out.dtype == torch.uint8
    with pytest.raises(InvalidBufferSize):
        codec.encode(np.zeros((4, 8, 8), np.uint8))


# ── container validation ────────────────────────────────────────


def _corruptions(data: bytes):
    hdr0 = 31  # 30-byte file header + 1 flags byte
    n_seg = struct.unpack_from("<I", data, 26)[0]
    counts0 = hdr0 + 1040

    def patch(off, fmt, value):
        b = bytearray(data)
        struct.pack_into(fmt, b, off, value)
        return bytes(b)

    return {
        "empty": b"",
        "short": data[:29],
        "magic": b"ALC2" + data[4:],
        "version": data[:4] + bytes([6]) + data[5:],
        "wavelet": data[:5] + bytes([3]) + data[6:],
        "s_seg_odd": patch(22, "<I", 12),
        "s_seg_zero": patch(22, "<I", 0),
        "n_segments": patch(26, "<I", n_seg + 8),
        "truncated_flags": data[:30],
        "num_symbols": patch(hdr0 + 12, "<I", 1),
        "compressed_len": patch(hdr0, "<I", 2),
        "count_below_flush": patch(counts0, "<I", 5),
        "count_above_capacity": patch(counts0, "<I", (S_SEG + 3) * 128),
        "truncated_header": data[: hdr0 + 500],
        "truncated_counts": data[: counts0 + 4],
        "truncated_payload": data[:-2],
    }


_CORRUPT = _corruptions((GOLDEN / "dense.alc").read_bytes())


@pytest.mark.parametrize("case", list(_CORRUPT))
def test_corrupt_containers_raise(case):
    bad = _CORRUPT[case]
    with pytest.raises(InvalidBitstream):
        Alc3Codec.from_bytes(bad, device="cpu")
    # the JAX package rejects the same bytes
    with pytest.raises(JaxInvalidBitstream):
        JaxCodec.from_bytes(bad)


# ── modes not ported yet ────────────────────────────────────────


@pytest.mark.parametrize("kwargs", [
    dict(sparse=True), dict(rdo=True), dict(levels=2), dict(quality=100),
    dict(deep=True)])
def test_unported_modes_raise(kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Alc3Codec(device="cpu", **kwargs)


@pytest.mark.parametrize("flags", [1, 2, 4, 8, 16])
def test_unported_container_flags_raise(port_run, flags):
    data = bytearray(port_run["data"])
    data[30] = flags  # the first chunk's flags byte
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Alc3Codec.from_bytes(bytes(data), device="cpu")


def test_docstring_example():
    import doctest

    import alice_codec_tpu_torch.alc3 as mod

    result = doctest.testmod(mod, verbose=False)
    assert result.attempted > 0 and result.failed == 0
