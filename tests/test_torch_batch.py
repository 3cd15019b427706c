"""The port's batches (``Alc3Codec.encode_batch`` / ``decode_batch``)
against the JAX package, on the CPU (the kernels' plain versions).

A live run of the JAX batch codec takes minutes here (its Pallas kernels
compile in interpret mode), so the port is held to the committed
JAX-written goldens (``tests/golden/torch/batch``, written by
``tools/golden/gen_torch_batch_goldens.py``) in both directions: the port
encodes each batch to the JAX containers, its capacity caches and its
active-set re-dispatch included, and decodes the JAX containers to the
JAX ``decode_batch``, bit for bit.  The mesh cases are
``test_torch_mesh.py``'s.  The ``slow`` test reruns the JAX codec and
compares live."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_batch_goldens as tg
from alice_codec_tpu_torch import Alc3Codec
from alice_codec_tpu_torch.alc3 import _join
from alice_codec_tpu_torch.ops.kernels import sparse as sk
from alice_codec_tpu_torch.ops.kernels.rans3 import NG
from chip_smoke import golden_input

# The suite runs several pytest workers on the CPU at once: keep these
# small tensor ops on one thread so they do not compete with them.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
#: the cases without a mesh
CASES = {case: spec for case, spec in tg.CASES.items() if not spec["mesh"]}


def _tool():
    spec = importlib.util.spec_from_file_location(
        "gen_torch_batch_goldens",
        ROOT / "tools" / "golden" / "gen_torch_batch_goldens.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def port_run():
    return {case: tg.run(spec, None) for case, spec in CASES.items()}


@pytest.mark.parametrize("case", list(CASES))
def test_port_encodes_the_jax_batches(port_run, case):
    """Each recorded batch: the port's containers and kcaps are JAX's, and
    its own decode_batch is JAX's."""
    tg.check_encodes(CASES[case], port_run[case])


@pytest.mark.parametrize("case", list(CASES))
def test_port_decodes_the_jax_containers(case):
    tg.check_decodes(CASES[case])


def test_batch_keeps_an_anchor_plane_in_every_chunk():
    """A black second chunk: its first plane is its anchor (the minimum
    bucket), the rest are elided; the chunk is a valid container on its
    own and decodes to black."""
    rgb = np.stack([golden_input("chunk", 0, (4, 32, 32)),
                    golden_input("black", 0, (4, 32, 32))])
    codec = Alc3Codec(50, s_seg=8, sparse=True, device="cpu")
    chunks = codec.encode_batch(rgb)
    assert chunks[1].kcaps == (8 * 8 * NG, 0, 0)
    _, back = Alc3Codec.from_bytes(Alc3Codec.to_bytes(chunks[1]), device="cpu")
    assert not codec.decode(back[0], as_numpy=True).any()
    assert not codec.decode_batch(chunks)[1].any()


@pytest.mark.parametrize("kwargs", [dict(quality=85, rdo=True),
                                    dict(quality=100, wavelet="haar"),
                                    dict(quality=85, rdo=True, sparse=True)])
def test_rdo_and_deep_batches_code_per_chunk(kwargs):
    rgb = np.stack([golden_input("chunk", s, (2, 16, 16)) for s in (1, 2)])
    codec = Alc3Codec(s_seg=8, device="cpu", **kwargs)
    ref = Alc3Codec(s_seg=8, device="cpu", **kwargs)
    chunks = codec.encode_batch(rgb)
    assert tg.containers(chunks) == [Alc3Codec.to_bytes(ref.encode(x)) for x in rgb]
    out = codec.decode_batch(chunks, exact=codec.deep)
    for i, ck in enumerate(chunks):
        assert torch.equal(out[i], ref.decode(ck, exact=codec.deep))


def test_decode_batch_of_mixed_chunks_decodes_per_chunk():
    rgb = golden_input("chunk", 3, (2, 16, 16))
    dense = Alc3Codec(80, s_seg=8, device="cpu")
    sp = Alc3Codec(80, s_seg=8, sparse=True, device="cpu")
    chunks = [dense.encode(rgb), sp.encode(rgb)]
    out = dense.decode_batch(chunks)
    assert torch.equal(out[0], dense.decode(chunks[0]))
    assert torch.equal(out[1], sp.decode(chunks[1]))


def test_compact_takes_a_list_of_planes():
    """The batch form of compact (the planes of several chunks, where each
    phase 1 left them) gives the bytes of the stacked form."""
    rng = np.random.default_rng(5)
    sym = torch.as_tensor(rng.integers(0, 256, (4, 4096), dtype=np.uint8)
                          * (rng.random((4, 4096)) < 0.1))
    trows = sk.tile_rows(sym)
    krs = (8, 0, 16, 40)
    bm, vals = sk.compact(sym, trows, krs)
    bm_l, vals_l = sk.compact(list(sym), list(trows), krs)
    assert torch.equal(bm, bm_l) and torch.equal(vals, vals_l)
    bm_p, vals_p = sk.compact(list(sym), list(trows), (16, 40), pick=(2, 3))
    assert torch.equal(bm_p, bm[2:]) and torch.equal(vals_p, vals[8:])
    with pytest.raises(ValueError):
        sk.compact(list(sym), list(trows[:3]), 8)


def test_join_reuses_the_chunks_of_one_batch():
    buf = torch.arange(24).reshape(6, 4)
    joined = _join([buf[:2], buf[2:5], buf[5:]])
    assert joined.data_ptr() == buf.data_ptr() and torch.equal(joined, buf)
    apart = _join([buf[:2], buf[3:]])
    assert torch.equal(apart, torch.cat([buf[:2], buf[3:]]))


# ── the live JAX codec (minutes on a CPU) ───────────────────────


@pytest.mark.slow
def test_live_jax_batch_codec_matches_goldens():
    files, rgbs = _tool().make_cases()
    for case, spec in tg.CASES.items():
        ran = tg.run(spec, tg.cpu_mesh(spec["mesh"]))
        for j, b in enumerate(spec["batches"]):
            if "chunks" not in b:
                continue
            assert rgbs[(case, j)] == b["rgb_sha256"]
            for ck, want in zip(ran[j][0], b["chunks"]):
                data, kcaps = files[want["file"]]
                assert data == (tg.GOLDEN / want["file"]).read_bytes()
                assert list(kcaps) == want["kcaps"]
                assert Alc3Codec.to_bytes(ck) == data
