"""Write the JAX-made batch ALC3 goldens that the PyTorch port is held to.

``Alc3Codec.encode_batch`` / ``decode_batch`` of the JAX package, with and
without a chunk mesh, over small inputs.  A live run of the JAX sparse
codec on a CPU takes minutes (its Pallas kernels compile in interpret
mode), so its output is committed: one container per chunk and the
SHA-256 of each batch's ``decode_batch``.  Run from the repository root
with the JAX package importable::

    JAX_PLATFORMS=cpu python tools/golden/gen_torch_batch_goldens.py

(the script asks XLA for 8 CPU devices itself, as ``tests/conftest.py``
does, so the mesh cases have their devices).

Writes ``tests/golden/torch/batch/``: ``<case><batch>_<chunk>.alc`` per
chunk of a recorded batch, and ``manifest.json`` with, per case, the codec
settings and the mesh size (or null), and per batch, the inputs
(``chip_smoke.golden_input`` specs) and, where recorded, per chunk its
file, ``kcaps`` and SHA-256, and the SHA-256 of the batch's
``decode_batch`` (``exact=False``) as raw (B, T, H, W, 3) uint8.

Cases (``s_seg`` 8 throughout; every input pads to one 2^20-symbol sparse
plane, so all batches of one codec share its capacity caches):

* ``a`` — q=50, two colour chunks (``_test_chunk(8, 256, 256)``, seeds 0
  and 1): luma dense, chroma sparse or elided;
* ``b`` — q=50, one codec over four batches of two 4×64×64 chunks:
  grayscale + grayscale (primes the active-set cache with luma only, not
  recorded); grayscale + colour (a channel assumed zero is not: the whole
  batch is dispatched again, and the discarded dispatch's capacities are
  cached too); grayscale + grayscale (all channels transformed, the
  chroma elided or kept at the cached capacity); grayscale + grayscale
  again (luma only: its capacities come from the discarded dispatch);
* ``c`` — q=90, the inputs of ``a``: all planes dense;
* ``d`` — q=80, a batch of three 4×32×32 colour chunks;
* ``m`` — q=85 sparse over ``chunk_mesh(4)``, four 4×32×32 colour chunks:
  the mesh's capacity rule (one bucket per channel from the batch
  maximum, no elision, caches untouched);
* ``dense`` — q=80 dense, four 2×16×16 colour chunks over
  ``chunk_mesh(2)``, whose streams equal the unsharded batch's (checked
  here).

:func:`make_cases` is also what the ``slow`` test of
``tests/test_torch_batch.py`` reruns live.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from chip_smoke import golden_input  # noqa: E402  (JAX-free input maker)

OUT = ROOT / "tests" / "golden" / "torch" / "batch"
S_SEG = 8


def _chunks(kind: str, seeds, shape):
    return [(kind, s, shape) for s in seeds]


_G = ("gray", 3, (4, 64, 64))
_C = ("chunk", 5, (4, 64, 64))

#: case → (quality, sparse, mesh devices or None, [batch: input specs])
CASES = {
    "a": (50, True, None, [_chunks("chunk", (0, 1), (8, 256, 256))]),
    "b": (50, True, None, [[_G, _G], [_G, _C], [_G, _G], [_G, _G]]),
    "c": (90, True, None, [_chunks("chunk", (0, 1), (8, 256, 256))]),
    "d": (80, True, None, [_chunks("chunk", (70, 71, 72), (4, 32, 32))]),
    "m": (85, True, 4, [_chunks("chunk", (40, 41, 42, 43), (4, 32, 32))]),
    "dense": (80, False, 2, [_chunks("chunk", (30, 31, 32, 33), (2, 16, 16))]),
}
#: batches of a case that only prime the codec's caches
SKIP = {("b", 0)}


def golden_name(case: str, batch: int, i: int) -> str:
    return f"{case}{batch}_{i}.alc"


def batch_input(specs) -> np.ndarray:
    return np.stack([golden_input(kind, seed, shape)
                     for kind, seed, shape in specs])


def make_cases() -> tuple[dict, dict]:
    """Run the JAX codec over every case: ``({file name: (container bytes,
    kcaps)}, {(case, batch): SHA-256 of the decode_batch})``."""
    from alice_codec_tpu.alc3 import Alc3Codec
    from alice_codec_tpu.parallel.mesh import chunk_mesh

    files, rgbs = {}, {}
    for case, (quality, sparse, n_mesh, batches) in CASES.items():
        codec = Alc3Codec(quality=quality, wavelet="cdf53", s_seg=S_SEG,
                          sparse=sparse)
        mesh = chunk_mesh(n_mesh) if n_mesh else None
        for j, specs in enumerate(batches):
            rgb = batch_input(specs)
            chunks = codec.encode_batch(rgb, mesh=mesh)
            if (case, j) in SKIP:
                continue
            if not sparse and mesh is not None:
                flat = codec.encode_batch(rgb)
                for a, b in zip(flat, chunks):
                    assert Alc3Codec.to_bytes(a) == Alc3Codec.to_bytes(b)
            out = np.asarray(codec.decode_batch(chunks, mesh=mesh), np.uint8)
            rgbs[(case, j)] = hashlib.sha256(out.tobytes()).hexdigest()
            for i, ck in enumerate(chunks):
                files[golden_name(case, j, i)] = (
                    Alc3Codec.to_bytes(ck),
                    tuple(int(k) for k in ck.kcaps))
    return files, rgbs


def main() -> None:
    files, rgbs = make_cases()
    OUT.mkdir(parents=True, exist_ok=True)
    cases = {}
    for case, (quality, sparse, n_mesh, batches) in CASES.items():
        entries = []
        for j, specs in enumerate(batches):
            entry = dict(inputs=[dict(kind=k, seed=s, shape=list(sh))
                                 for k, s, sh in specs])
            if (case, j) not in SKIP:
                chunks = []
                for i in range(len(specs)):
                    name = golden_name(case, j, i)
                    data, kcaps = files[name]
                    (OUT / name).write_bytes(data)
                    chunks.append(dict(file=name, kcaps=list(kcaps),
                                       sha256=hashlib.sha256(data).hexdigest()))
                entry.update(chunks=chunks, rgb_sha256=rgbs[(case, j)])
            entries.append(entry)
        cases[case] = dict(quality=quality, wavelet="cdf53", s_seg=S_SEG,
                           sparse=sparse, mesh=n_mesh, batches=entries)
    (OUT / "manifest.json").write_text(
        json.dumps({"cases": cases}, indent=1) + "\n")
    print(f"wrote {len(files)} containers to {OUT}")


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    main()
