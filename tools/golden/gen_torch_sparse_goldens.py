"""Write the JAX-made sparse ALC3 goldens that the PyTorch port is held to.

A machine that runs the port on a card need not have JAX, and a live run
of the JAX sparse codec on a CPU takes minutes (its Pallas compact and
expand kernels compile in interpret mode), so the JAX package's output
is committed: one container per chunk and the SHA-256 of its decode.
Run from the repository root with the JAX package importable::

    JAX_PLATFORMS=cpu python tools/golden/gen_torch_sparse_goldens.py

Writes ``tests/golden/torch/sparse/``: ``<case>.alc`` per chunk, and
``manifest.json`` with, per case, the codec settings and, per chunk, the
input (kind, seed, shape), the per-plane value capacities ``kcaps``, the
container's SHA-256 and the SHA-256 of the JAX decode (``exact=False``)
as raw (T, H, W, 3) uint8.

Cases (``s_seg`` 8 throughout; every input pads to one 2^20-symbol
sparse plane, so all chunks of one codec share its capacity caches):

* ``a`` — ``_test_chunk(8, 256, 256, seed=0)`` at q=50: luma dense,
  Co sparse, Cg elided;
* ``b`` — seed 1 through the same codec: Co reuses the cached capacity,
  Cg grows from elided through the overflow path;
* ``c`` — the input of ``a`` at q=90: all three planes dense;
* ``d`` — one q=50 codec over grayscale, noisy colour, grayscale,
  grayscale chunks: the colour chunk forces the zero-channel re-dispatch,
  and the last chunk's luma capacity comes from its discarded first
  dispatch;
* ``e`` — an all-black chunk: only the anchor plane is coded.

The inputs come from ``chip_smoke.golden_input``, which imports no JAX,
so the card's checks make the same inputs.  :func:`make_cases` is also
what the ``slow`` test of ``tests/test_torch_alc3_sparse.py`` reruns live.
"""

from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from chip_smoke import golden_input  # noqa: E402  (JAX-free input maker)

OUT = ROOT / "tests" / "golden" / "torch" / "sparse"
S_SEG = 8

#: case → (quality, [input spec per chunk]); one codec per case
CASES = {
    "a": (50, [("chunk", 0, (8, 256, 256))]),
    "b": (50, [("chunk", 0, (8, 256, 256)), ("chunk", 1, (8, 256, 256))]),
    "c": (90, [("chunk", 0, (8, 256, 256))]),
    "d": (50, [("gray", 3, (4, 16, 16)), ("noise", 4, (4, 128, 128)),
               ("gray", 3, (4, 16, 16)), ("gray", 3, (4, 16, 16))]),
    "e": (50, [("black", 0, (4, 16, 16))]),
}
#: chunks of a case whose container is a golden of their own; the rest
#: (``b``'s first chunk) only prime the codec's caches
SKIP = {("b", 0)}


def golden_name(case: str, i: int) -> str:
    n = len(CASES[case][1])
    return f"{case}.alc" if n == 1 else f"{case}{i}.alc"


def make_cases() -> dict:
    """Run the JAX sparse codec over every case: ``{file name: (container
    bytes, kcaps, SHA-256 of the decode)}``."""
    from alice_codec_tpu.alc3 import Alc3Codec

    out = {}
    for case, (quality, inputs) in CASES.items():
        codec = Alc3Codec(quality=quality, wavelet="cdf53", s_seg=S_SEG,
                          sparse=True)
        for i, (kind, seed, shape) in enumerate(inputs):
            chunk = codec.encode(golden_input(kind, seed, shape))
            if (case, i) in SKIP:
                continue
            rgb = np.asarray(codec.decode(chunk, as_numpy=True), np.uint8)
            out[golden_name(case, i)] = (
                Alc3Codec.to_bytes(chunk), tuple(int(k) for k in chunk.kcaps),
                hashlib.sha256(rgb.tobytes()).hexdigest())
    return out


def main() -> None:
    made = make_cases()
    OUT.mkdir(parents=True, exist_ok=True)
    cases = {}
    for case, (quality, inputs) in CASES.items():
        chunks = []
        for i, (kind, seed, shape) in enumerate(inputs):
            entry = dict(kind=kind, seed=seed, shape=list(shape))
            if (case, i) not in SKIP:
                name = golden_name(case, i)
                data, kcaps, rgb_sha = made[name]
                (OUT / name).write_bytes(data)
                entry.update(file=name, kcaps=list(kcaps),
                             sha256=hashlib.sha256(data).hexdigest(),
                             rgb_sha256=rgb_sha)
            chunks.append(entry)
        cases[case] = dict(quality=quality, wavelet="cdf53", s_seg=S_SEG,
                           chunks=chunks)
    (OUT / "manifest.json").write_text(
        json.dumps({"cases": cases}, indent=1) + "\n")
    print(f"wrote {len(made)} containers to {OUT}")


if __name__ == "__main__":
    main()
