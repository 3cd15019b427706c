"""The port's chunk meshes (``parallel.mesh``, ``mesh=`` of
``Alc3Codec.encode_batch`` / ``decode_batch`` and of the ALC2 classes,
``dryrun_multichip``) against the JAX package, on the CPU: a mesh here
is a list of CPU entries, on which every kernel runs its plain version.

The JAX package's mesh runs on its eight forced CPU devices; the port is
held to its committed goldens (``tests/golden/torch/batch``, the cases
with a mesh) in both directions, bit for bit.  The multi-card behaviour
itself (shards overlapping on several cards) needs several cards; these
tests stand for it."""

import numpy as np
import pytest
import torch

import torch_batch_goldens as tg
from alice_codec_tpu_torch import Alc3Codec
from alice_codec_tpu_torch.parallel import (BatchFrameDecoder,
                                            BatchFrameEncoder,
                                            EncodedChunkStream, chunk_mesh,
                                            shard_batch)
from alice_codec_tpu_torch.parallel.mesh import batch_sharding, dryrun_multichip
from chip_smoke import golden_input

# The suite runs several pytest workers on the CPU at once: keep these
# small tensor ops on one thread so they do not compete with them.
torch.set_num_threads(1)

CPU = torch.device("cpu")
#: the cases with a mesh
CASES = {case: spec for case, spec in tg.CASES.items() if spec["mesh"]}


@pytest.fixture(scope="module")
def port_run():
    return {case: tg.run(spec, tg.cpu_mesh(spec["mesh"]))
            for case, spec in CASES.items()}


@pytest.mark.parametrize("case", list(CASES))
def test_port_encodes_the_jax_mesh_batches(port_run, case):
    tg.check_encodes(CASES[case], port_run[case])


@pytest.mark.parametrize("case", list(CASES))
def test_port_decodes_the_jax_mesh_containers(case):
    tg.check_decodes(CASES[case])


def test_dense_batch_is_per_chunk_encode_with_or_without_a_mesh(port_run):
    """A dense batch codes each chunk's bytes as per-chunk encode does,
    and the same streams without the case's mesh."""
    spec = CASES["dense"]
    b = spec["batches"][0]
    rgb = tg.batch(b["inputs"])
    codec = tg.codec(spec)
    flat = codec.encode_batch(rgb)
    assert tg.containers(flat) == tg.containers(port_run["dense"][0][0])
    for i, ck in enumerate(flat):
        assert Alc3Codec.to_bytes(ck) == Alc3Codec.to_bytes(codec.encode(rgb[i]))
    assert tg.sha(codec.decode_batch(flat)) == b["rgb_sha256"]


def test_sparse_mesh_of_two_codes_the_mesh_of_four(port_run):
    """The mesh's capacity rule is batch-wide, so two CPU entries (two
    chunks a shard, the batch given as shards) write the containers of
    JAX's four-device mesh, and decode them as it does."""
    spec = CASES["m"]
    rgb = tg.batch(spec["batches"][0]["inputs"])
    mesh = tg.cpu_mesh(2)
    codec = tg.codec(spec)
    chunks = codec.encode_batch(shard_batch(rgb, mesh), mesh=mesh)
    assert tg.containers(chunks) == tg.containers(port_run["m"][0][0])
    assert all(c.kcaps == chunks[0].kcaps and min(c.kcaps) > 0 for c in chunks)
    assert tg.sha(codec.decode_batch(chunks, mesh=mesh)) \
        == spec["batches"][0]["rgb_sha256"]


def test_sparse_mesh_with_an_uneven_batch_encodes_per_chunk():
    spec = CASES["m"]
    rgb = tg.batch(spec["batches"][0]["inputs"])[:3]
    mesh = tg.cpu_mesh(2)
    codec, ref = tg.codec(spec), tg.codec(spec)
    chunks = codec.encode_batch(rgb, mesh=mesh)
    assert tg.containers(chunks) == [Alc3Codec.to_bytes(ref.encode(x)) for x in rgb]
    out = codec.decode_batch(chunks, mesh=mesh)  # uneven: per chunk
    for i, ck in enumerate(chunks):
        assert torch.equal(out[i], ref.decode(ck))


@pytest.mark.parametrize("device_entropy", [False, True])
def test_alc2_stream_is_the_same_with_a_mesh(device_entropy):
    rgb = np.stack([golden_input("chunk", s, (2, 16, 16)) for s in range(4)])
    mesh = tg.cpu_mesh(2)
    kw = dict(n_lanes=8, device_entropy=device_entropy)
    plain = BatchFrameEncoder(90, device="cpu", **kw).encode(rgb).to_bytes()
    meshed = BatchFrameEncoder(90, mesh=mesh, **kw).encode(rgb).to_bytes()
    assert plain == meshed
    stream = EncodedChunkStream.from_bytes(plain)
    out = BatchFrameDecoder(device_entropy=device_entropy,
                            device="cpu").decode(stream)
    out_mesh = BatchFrameDecoder(device_entropy=device_entropy,
                                 mesh=mesh).decode(stream)
    np.testing.assert_array_equal(out, out_mesh)


def test_dryrun_multichip_on_cpu_entries():
    dryrun_multichip(2, devices=["cpu", "cpu"])


def test_chunk_mesh_needs_a_card_or_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="devices="):
        chunk_mesh()
    with pytest.raises(RuntimeError):
        chunk_mesh(2)
    with pytest.raises(RuntimeError):
        dryrun_multichip(2)
    mesh = chunk_mesh(2, devices=["cpu"] * 3)
    assert mesh.devices == (CPU, CPU) and mesh.axis_names == ("chunks",)
    assert mesh.size == 2 and batch_sharding(mesh) == (CPU, CPU)
    with pytest.raises(ValueError):
        chunk_mesh(4, devices=["cpu"] * 3)
    with pytest.raises(ValueError):
        batch_sharding(mesh, "frames")


def test_shard_batch_splits_the_leading_axis():
    mesh = tg.cpu_mesh(2)
    x = np.arange(4 * 3).reshape(4, 3)
    shards = shard_batch(x, mesh)
    assert [s.tolist() for s in shards] == [x[:2].tolist(), x[2:].tolist()]
    assert all(s.device == CPU for s in shards)
    with pytest.raises(ValueError):
        shard_batch(x[:3], mesh)
    dense = Alc3Codec(80, s_seg=8, device="cpu")
    with pytest.raises(ValueError):  # an uneven dense batch has no mesh form
        dense.encode_batch(np.zeros((3, 2, 8, 8, 3), np.uint8), mesh=mesh)
