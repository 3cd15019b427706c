"""The JAX-written batch goldens (``tests/golden/torch/batch``, written by
``tools/golden/gen_torch_batch_goldens.py``) and the port's run of them,
shared by ``test_torch_batch.py``, ``test_torch_mesh.py`` and (on the
card, whose meshes repeat its one device) ``test_torch_gpu.py``.  Imports
no JAX."""

import hashlib
import json
from pathlib import Path

import numpy as np
import torch

from alice_codec_tpu_torch import Alc3Codec
from alice_codec_tpu_torch.parallel import chunk_mesh
from chip_smoke import golden_input

GOLDEN = Path(__file__).resolve().parent / "golden" / "torch" / "batch"
CASES = json.loads((GOLDEN / "manifest.json").read_text())["cases"]


def batch(inputs) -> np.ndarray:
    return np.stack([golden_input(s["kind"], s["seed"], s["shape"])
                     for s in inputs])


def sha(x) -> str:
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return hashlib.sha256(np.ascontiguousarray(x).tobytes()).hexdigest()


def cpu_mesh(n: int | None, device="cpu"):
    """A mesh of ``n`` entries of ``device`` (None for no mesh)."""
    return chunk_mesh(devices=[device] * n) if n else None


def codec(spec, device="cpu") -> Alc3Codec:
    return Alc3Codec(spec["quality"], spec["wavelet"], s_seg=spec["s_seg"],
                     sparse=spec["sparse"], device=device)


def run(spec, mesh, device="cpu"):
    """A case through the port as the generator runs it: ``{batch:
    (chunks, SHA-256 of the decode_batch)}`` of the recorded batches."""
    c = codec(spec, device)
    out = {}
    for j, b in enumerate(spec["batches"]):
        chunks = c.encode_batch(batch(b["inputs"]), mesh=mesh)
        if "chunks" in b:
            out[j] = chunks, sha(c.decode_batch(chunks, mesh=mesh))
    return out


def containers(chunks) -> list[bytes]:
    return [Alc3Codec.to_bytes(c) for c in chunks]


def check_encodes(spec, ran) -> None:
    """The port's run of a case wrote JAX's containers and kcaps, and its
    decode_batch is JAX's."""
    for j, b in enumerate(spec["batches"]):
        if "chunks" not in b:
            continue
        chunks, rgb_sha = ran[j]
        for ck, want in zip(chunks, b["chunks"]):
            assert list(ck.kcaps) == want["kcaps"]
            assert Alc3Codec.to_bytes(ck) == (GOLDEN / want["file"]).read_bytes()
        assert rgb_sha == b["rgb_sha256"]


def check_decodes(spec, device="cpu") -> None:
    """The JAX containers of each recorded batch decode through the port's
    decode_batch (over the case's mesh) to JAX's decode_batch."""
    for b in spec["batches"]:
        if "chunks" not in b:
            continue
        chunks = []
        for want in b["chunks"]:
            c, got = Alc3Codec.from_bytes((GOLDEN / want["file"]).read_bytes(),
                                          device=device)
            chunks += got
        assert sha(c.decode_batch(chunks, mesh=cpu_mesh(spec["mesh"], device))) \
            == b["rgb_sha256"]
