"""The port's chunk streaming and its `.alcs3` files
(``alice_codec_tpu_torch.streaming``) against the JAX package's, on the
CPU.

The `.alcs3` framing is pure Python, so files cross between the two
packages' writers and readers with no JAX program run: the payloads are
the committed JAX-written ALC3 goldens.  The stream coders run the
port's codec on its plain kernels; the single-chunk stream of the dense
golden's input is held to the JAX container byte for byte."""

import json
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

from alice_codec_tpu.errors import InvalidBitstream as JaxInvalidBitstream
from alice_codec_tpu.streaming import Alc3StreamReader as JaxReader
from alice_codec_tpu.streaming import Alc3StreamWriter as JaxWriter

from alice_codec_tpu_torch import (Alc3Codec, Alc3StreamReader,
                                   Alc3StreamWriter, decode_stream,
                                   encode_stream)
from alice_codec_tpu_torch.errors import InvalidBitstream
from bench import _test_chunk
from chip_smoke import golden_input

# The suite runs several pytest workers on the CPU at once: keep these
# small tensor ops on one thread so they do not compete with them.
torch.set_num_threads(1)

GOLDEN = Path(__file__).resolve().parent / "golden" / "torch"
#: JAX-written ALC3 containers: the dense golden and a few sparse ones
PAYLOADS = [(GOLDEN / name).read_bytes()
            for name in ("dense.alc", "sparse/a.alc", "sparse/e.alc")]


@pytest.mark.parametrize("writer, reader", [(JaxWriter, Alc3StreamReader),
                                            (Alc3StreamWriter, JaxReader)])
def test_alcs3_files_cross_between_the_packages(tmp_path, writer, reader):
    path = tmp_path / "s.alcs3"
    with writer(path) as w:
        for data in PAYLOADS:
            w.append(data)
    assert list(reader(path)) == PAYLOADS


def test_alcs3_files_are_byte_identical(tmp_path):
    files = []
    for writer in (JaxWriter, Alc3StreamWriter):
        path = tmp_path / f"{writer.__module__}.alcs3"
        with writer(path) as w:
            for data in PAYLOADS:
                w.append(data)
        files.append(path.read_bytes())
    assert files[0] == files[1]
    assert files[0][:8] == b"ALS3\x01\x00\x00\x00"
    assert files[0][8:12] == struct.pack("<I", len(PAYLOADS[0]))


def test_resume_drops_a_truncated_tail(tmp_path):
    path = tmp_path / "s.alcs3"
    with Alc3StreamWriter(path) as w:
        for data in PAYLOADS:
            w.append(data)
    whole = path.read_bytes()
    path.write_bytes(whole[:-5])  # the last container cut short
    with Alc3StreamWriter(path, resume=True) as w:
        assert w.containers_written == len(PAYLOADS) - 1
        w.append(PAYLOADS[-1])
    assert path.read_bytes() == whole
    assert list(JaxReader(path)) == PAYLOADS


@pytest.mark.parametrize("size", [0, 5])
def test_resume_after_a_short_header_starts_afresh(tmp_path, size):
    path = tmp_path / "s.alcs3"
    path.write_bytes(b"ALS3\x01"[:size])
    with Alc3StreamWriter(path, resume=True) as w:
        assert w.containers_written == 0
        w.append(PAYLOADS[0])
    assert list(Alc3StreamReader(path)) == PAYLOADS[:1]


@pytest.mark.parametrize("head", [b"ALSX\x01\x00\x00\x00", b"ALS3\x02\x00\x00\x00",
                                  b"ALS"])
def test_bad_headers_raise(tmp_path, head):
    path = tmp_path / "s.alcs3"
    path.write_bytes(head + struct.pack("<I", 0))
    with pytest.raises(InvalidBitstream):
        Alc3StreamReader(path)
    with pytest.raises(JaxInvalidBitstream):
        JaxReader(path)
    if len(head) >= 8:
        with pytest.raises(InvalidBitstream):
            Alc3StreamWriter(path, resume=True)


def test_encode_stream_writes_the_jax_container():
    """One chunk of the dense golden's input through encode_stream is the
    JAX package's container of it."""
    spec = json.loads((GOLDEN / "manifest.json").read_text())
    rgb = _test_chunk(spec["t"], spec["h"], spec["w"], seed=spec["seed"])
    out = list(encode_stream(rgb, chunk_size=spec["t"], quality=spec["quality"],
                             wavelet=spec["wavelet"], s_seg=spec["s_seg"],
                             device="cpu"))
    assert out == [PAYLOADS[0]]


@pytest.mark.parametrize("lookahead", [0, 2])
def test_stream_roundtrip_matches_per_chunk_decode(tmp_path, lookahead):
    """Ten frames in chunks of four (the last padded by repeating the
    last frame) through a file: the frames are the per-chunk decode."""
    frames = golden_input("chunk", 8, (10, 16, 16))
    codec = Alc3Codec(85, s_seg=8, sparse=True, device="cpu")
    path = tmp_path / "s.alcs3"
    with Alc3StreamWriter(path) as w:
        for data in encode_stream(frames, codec, chunk_size=4,
                                  lookahead=lookahead):
            w.append(data)
    got = list(decode_stream(Alc3StreamReader(path), lookahead=lookahead,
                             device="cpu"))
    assert len(got) == 3 and all(isinstance(g, np.ndarray) for g in got)
    padded = np.concatenate([frames, frames[-1:], frames[-1:]])
    ref = Alc3Codec(85, s_seg=8, sparse=True, device="cpu")
    for i, g in enumerate(got):
        want = ref.decode(ref.encode(padded[4 * i : 4 * i + 4]), as_numpy=True)
        np.testing.assert_array_equal(g, want)
