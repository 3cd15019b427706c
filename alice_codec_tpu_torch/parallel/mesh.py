"""Chunk meshes: the port of ``alice_codec_tpu/parallel/mesh.py`` and of
``__graft_entry__.dryrun_multichip``.

Chunks share no state, so a batch is split over devices along its
leading (chunk) axis and each device codes its own shard.  Where the JAX
package has one controller driving a ``jax.sharding.Mesh``, the port has
one process driving a :class:`ChunkMesh`, a list of ``torch.device`` s: the
work of every shard is issued before any host read, so the shards of a
machine with several cards run at once, and a result is gathered onto
the mesh's first device.  No ``torch.distributed`` process group is
involved.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["ChunkMesh", "chunk_mesh", "batch_sharding", "shard_batch",
           "dryrun_multichip"]


@dataclass(frozen=True)
class ChunkMesh:
    """A 1-D mesh: ``devices`` in shard order along ``axis_names[0]``."""

    devices: tuple[torch.device, ...]
    axis_names: tuple[str, ...] = ("chunks",)

    @property
    def size(self) -> int:
        """Devices on the mesh (the JAX code's ``mesh.devices.size``)."""
        return len(self.devices)


def chunk_mesh(n_devices: int | None = None, axis_name: str = "chunks", *,
               devices=None) -> ChunkMesh:
    """1-D mesh over the first ``n_devices`` visible CUDA cards (all of
    them by default), or over ``devices`` when given (for example
    ``["cpu"] * 4``: four CPU entries, on which every kernel runs its
    plain version).  Raises without a card and without ``devices``, as
    :func:`~alice_codec_tpu_torch._device.resolve_device` does."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass devices=['cpu', ...] to "
                "build a mesh of CPU entries")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = tuple(torch.device(d) for d in devices)
    if n_devices is not None:
        if not 1 <= n_devices <= len(devices):
            raise ValueError(f"a mesh of {n_devices} devices from "
                             f"{len(devices)} available")
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return ChunkMesh(devices, (axis_name,))


def batch_sharding(mesh: ChunkMesh, axis_name: str = "chunks"):
    """The placement that splits the leading (chunk-batch) axis over the
    mesh: its devices, in shard order."""
    if axis_name not in mesh.axis_names:
        raise ValueError(f"mesh has no axis {axis_name!r}")
    return mesh.devices


def shard_batch(array, mesh: ChunkMesh, axis_name: str = "chunks"
                ) -> list[torch.Tensor]:
    """Place a batch (numpy or a tensor) on the mesh, split along its
    leading axis: one tensor a device, in shard order.  The axis must
    divide evenly."""
    devices = batch_sharding(mesh, axis_name)
    if not isinstance(array, torch.Tensor):
        arr = np.asarray(array)
        if not arr.flags.writeable:  # torch wraps only writable arrays
            arr = arr.copy()
        array = torch.as_tensor(arr)
    n = array.shape[0]
    if n % len(devices):
        raise ValueError(f"a leading axis of {n} does not split over "
                         f"{len(devices)} devices")
    per = n // len(devices)
    return [array[i * per : (i + 1) * per].to(dev)
            for i, dev in enumerate(devices)]


def on_device(dev: torch.device):
    """Make ``dev`` the current CUDA device for the span of the block (the
    kernels launch on the current device's streams); nothing for a CPU
    entry."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def gather(parts, device: torch.device) -> torch.Tensor:
    """Concatenate per-shard results along their leading axis on
    ``device``."""
    return torch.cat([p.to(device) for p in parts])


def dryrun_multichip(n_devices: int, *, devices=None) -> None:
    """Run the batched encode and decode stages and the sparse ALC3
    codec's ``encode_batch`` / ``decode_batch`` over an ``n_devices`` mesh
    on tiny shapes, and check their results.

    The mesh is the first ``n_devices`` CUDA cards, or ``devices`` (for
    example ``["cpu"] * n_devices``)."""
    from ..alc3 import Alc3Codec
    from ..core import WaveletType, padded_dims
    from .batch import _decode_batch_device, _encode_batch_device

    mesh = chunk_mesh(n_devices, devices=devices)
    b, t, h, w = n_devices * 2, 4, 8, 8  # tiny: 2 chunks per device
    padded = padded_dims(w, h, t)
    rng = np.random.default_rng(0)
    shards = shard_batch(
        rng.integers(0, 256, size=(b, t, h, w, 3), dtype=np.uint8), mesh)
    symbols, hists = _encode_batch_device(
        shards, 8, 8, wavelet_type=WaveletType.CDF53, padded=padded,
        sharded=True)
    steps = [torch.full((s.shape[0], 3), 8, dtype=torch.int32, device=s.device)
             for s in symbols]
    decoded = _decode_batch_device(
        symbols, steps, wavelet_type=WaveletType.CDF53, dims=(w, h, t),
        padded=padded, sharded=True)
    first = mesh.devices[0]
    symbols, hists, decoded = (gather(x, first)
                               for x in (symbols, hists, decoded))
    assert symbols.shape == (b, 3, padded[0] * padded[1] * padded[2])
    assert hists.shape == (b, 3, 256)
    assert decoded.shape == (b, t, h, w, 3)
    # each chunk's histogram covers every padded pixel exactly once
    assert bool((hists.sum(-1) == padded[0] * padded[1] * padded[2]).all())

    # the sparse ALC3 codec over the same mesh: phase 1 on every shard, one
    # host read of the B·3 row counts, phase 2 on every shard; the sharded
    # decode; chunk 0 against its per-chunk decode
    codec = Alc3Codec(quality=85, s_seg=8, sparse=True, device=first)
    rgb = rng.integers(0, 256, size=(b, t, h, w, 3), dtype=np.uint8)
    chunks = codec.encode_batch(shard_batch(rgb, mesh), mesh=mesh)
    assert len(chunks) == b and all(c.sparse for c in chunks)
    out = codec.decode_batch(chunks, mesh=mesh)
    assert tuple(out.shape) == (b, t, h, w, 3) and out.device == first
    assert bool(torch.equal(out[0].cpu(), codec.decode(chunks[0]).cpu()))
