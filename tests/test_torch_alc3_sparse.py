"""The port's sparse ALC3 codec (``Alc3Codec(sparse=True)``) against the
JAX package, on the CPU (the kernels' plain versions).

A live run of the JAX sparse codec takes minutes here (its compact and
expand kernels compile in interpret mode), so the port is held to the
committed JAX-written goldens (``tests/golden/torch/sparse``, written by
``tools/golden/gen_torch_sparse_goldens.py``) in both directions: the port
encodes each input to the JAX bytes, its capacity caches included, and
decodes each JAX container to the JAX decode.  The ``slow`` test reruns
the JAX codec and compares live.  Corrupt sparse containers are rejected
by both packages' parsers, which run no JAX program."""

import hashlib
import importlib.util
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

from alice_codec_tpu_torch import Alc3Codec, DeviceChunk
from chip_smoke import golden_input
from alice_codec_tpu_torch.alc3 import _segment_geometry, _sparse_pp
from alice_codec_tpu_torch.core import padded_dims_levels
from alice_codec_tpu_torch.errors import InvalidBitstream

# The suite runs several pytest workers on the CPU at once: keep these
# small tensor ops on one thread so they do not compete with them.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden" / "torch" / "sparse"
CASES = json.loads((GOLDEN / "manifest.json").read_text())["cases"]
#: golden file → (case, index of the chunk in its case)
FILES = {ck["file"]: (case, i) for case, spec in CASES.items()
         for i, ck in enumerate(spec["chunks"]) if "file" in ck}


def _tool():
    spec = importlib.util.spec_from_file_location(
        "gen_torch_sparse_goldens",
        ROOT / "tools" / "golden" / "gen_torch_sparse_goldens.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


GEN = _tool()


def _input(ck) -> np.ndarray:
    return golden_input(ck["kind"], ck["seed"], ck["shape"])


def _sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


@pytest.fixture(scope="module")
def port_run():
    """Every case through the port on the CPU, one codec per case as the
    generator runs it: ``{file: chunk}``."""
    out = {}
    for case, spec in CASES.items():
        codec = Alc3Codec(spec["quality"], spec["wavelet"], s_seg=spec["s_seg"],
                          sparse=True, device="cpu")
        for ck in spec["chunks"]:
            chunk = codec.encode(_input(ck))
            if "file" in ck:
                out[ck["file"]] = chunk
    return out


def _entry(name):
    case, i = FILES[name]
    return CASES[case], CASES[case]["chunks"][i]


def test_golden_files_match_manifest():
    assert set(FILES) == {"a.alc", "b1.alc", "c.alc", "d0.alc", "d1.alc",
                          "d2.alc", "d3.alc", "e.alc"}
    for name in FILES:
        assert _sha((GOLDEN / name).read_bytes()) == _entry(name)[1]["sha256"]


@pytest.mark.parametrize("name", sorted(FILES))
def test_port_encodes_jax_bytes(port_run, name):
    chunk = port_run[name]
    assert chunk.sparse and list(chunk.kcaps) == _entry(name)[1]["kcaps"]
    assert Alc3Codec.to_bytes(chunk) == (GOLDEN / name).read_bytes()


@pytest.mark.parametrize("name", sorted(FILES))
def test_port_decodes_jax_bytes(name):
    codec, chunks = Alc3Codec.from_bytes((GOLDEN / name).read_bytes(),
                                         device="cpu")
    spec, ck = _entry(name)
    assert codec.sparse and codec.quality == spec["quality"]
    assert len(chunks) == 1 and list(chunks[0].kcaps) == ck["kcaps"]
    out = codec.decode(chunks[0], as_numpy=True)
    assert _sha(out.tobytes()) == ck["rgb_sha256"]


def test_kcaps_show_every_plane_kind():
    """The goldens cover dense, sparse and elided planes, the cache's
    overflow growth and the anchor plane (see the generator)."""
    kc = {name: _entry(name)[1]["kcaps"] for name in FILES}
    dense = _segment_geometry(1 << 20, 8)[1]
    assert kc["a.alc"][0] == dense and 0 < kc["a.alc"][1] < dense
    assert kc["a.alc"][2] == 0 and kc["b1.alc"][2] > 0
    assert kc["c.alc"] == [dense] * 3
    assert kc["e.alc"] == [8 * 8 * 128, 0, 0]


@pytest.mark.parametrize("name", ["a.alc", "c.alc"])
def test_sparse_decode_equals_dense(port_run, name):
    spec, ck = _entry(name)
    dense = Alc3Codec(spec["quality"], spec["wavelet"], s_seg=spec["s_seg"],
                      device="cpu")
    out = dense.decode(dense.encode(_input(ck)), as_numpy=True)
    assert _sha(out.tobytes()) == ck["rgb_sha256"]


def _jax_chunk(fields: dict) -> JaxChunk:
    fields = dict(fields, wavelet_type=JW(fields["wavelet_type"]))
    return JaxChunk(**fields)


def test_device_chunk_numpy_roundtrip(port_run):
    names = ["d0.alc", "d1.alc", "d2.alc", "d3.alc"]
    chunks = [port_run[n] for n in names]
    for name, chunk in zip(names, chunks):
        fields = chunk.to_numpy()
        assert fields["sparse"] and fields["kcaps"] == chunk.kcaps
        want = (GOLDEN / name).read_bytes()
        assert JaxCodec.to_bytes(_jax_chunk(fields)) == want
        again = DeviceChunk.from_numpy(**fields, device="cpu")
        assert Alc3Codec.to_bytes(again) == want
    # a container of several sparse chunks, each with its own capacities
    data = Alc3Codec.to_bytes(chunks)
    assert data == JaxCodec.to_bytes([_jax_chunk(c.to_numpy()) for c in chunks])
    _, back = Alc3Codec.from_bytes(data, device="cpu")
    assert [c.kcaps for c in back] == [c.kcaps for c in chunks]
    assert Alc3Codec.to_bytes(back) == data


# ── container validation ────────────────────────────────────────


def _plane_offsets(data: bytes, kcaps):
    """Byte offset of each of the 6 plane headers of the first chunk."""
    w, h, f, _, s_seg, _ = struct.unpack_from("<IIIIII", data, 6)
    pp = _sparse_pp(int(np.prod(padded_dims_levels(w, h, f, 1))))
    nb, _ = _segment_geometry(pp // 8, s_seg)
    ns = [nb if k else 0 for k in kcaps] + [k // (s_seg * 128) for k in kcaps]
    offs, off = [], 31
    for n in ns:
        offs.append(off)
        off += 1040 + 4 * n
    return offs, pp


def _corruptions():
    data = (GOLDEN / "a.alc").read_bytes()
    kcaps = _entry("a.alc")[1]["kcaps"]  # Y dense, Co sparse, Cg elided
    offs, pp = _plane_offsets(data, kcaps)
    seg = 8 * 128

    def patch(plane, field, value):
        b = bytearray(data)
        struct.pack_into("<I", b, offs[plane] + field, value)
        return bytes(b)

    # the Co bitmap's first segment count set below the state flush (its
    # header's compressed_len kept consistent)
    c0 = struct.unpack_from("<I", data, offs[1] + 1040)[0]
    below_flush = bytearray(patch(1, 0, struct.unpack_from(
        "<I", data, offs[1])[0] + 2 * (5 - c0)))
    struct.pack_into("<I", below_flush, offs[1] + 1040, 5)
    return {
        "value_capacity_not_segment_aligned": patch(4, 12, kcaps[1] + 8),
        "value_capacity_not_v_aligned": patch(4, 12, kcaps[1] + seg),
        "value_capacity_beyond_plane": patch(4, 12, kcaps[0] + 8 * seg),
        "value_capacity_zero_for_coded_bitmap": patch(4, 12, 0),
        "coded_value_plane_for_elided_bitmap": patch(5, 12, 8 * seg),
        "elided_bitmap_with_payload": patch(2, 0, 2),
        "elided_value_plane_with_payload": patch(5, 0, 2),
        "bitmap_num_symbols": patch(1, 12, pp // 8 + 128),
        "value_counts_disagree": patch(4, 0, struct.unpack_from(
            "<I", data, offs[4])[0] + 2),
        "bitmap_count_below_flush": bytes(below_flush),
        "truncated_value_counts": data[: offs[4] + 1040 + 8],
        "truncated_payload": data[:-2],
    }


_CORRUPT = _corruptions()


@pytest.mark.parametrize("case", list(_CORRUPT))
def test_corrupt_sparse_containers_raise(case):
    bad = _CORRUPT[case]
    with pytest.raises(InvalidBitstream):
        Alc3Codec.from_bytes(bad, device="cpu")
    with pytest.raises(JaxInvalidBitstream):
        JaxCodec.from_bytes(bad)


# ── the live JAX codec (minutes on a CPU) ───────────────────────


@pytest.mark.slow
def test_live_jax_sparse_codec_matches_goldens(port_run):
    made = GEN.make_cases()
    assert set(made) == set(FILES)
    for name, (data, kcaps, rgb_sha) in made.items():
        ck = _entry(name)[1]
        assert data == (GOLDEN / name).read_bytes()
        assert list(kcaps) == ck["kcaps"] and rgb_sha == ck["rgb_sha256"]
        assert Alc3Codec.to_bytes(port_run[name]) == data
