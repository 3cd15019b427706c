"""Write the JAX-made ALC3 goldens of the sparse mode compositions that the
PyTorch port is held to: deep×sparse, rdo×sparse and levels×sparse.

A live run of the JAX sparse codec on a CPU takes minutes (its Pallas
compact and expand kernels compile in interpret mode), so the JAX
package's output is committed: one container per case, and the SHA-256
of its decodes.  Run from the repository root with the JAX package
importable::

    JAX_PLATFORMS=cpu python tools/golden/gen_torch_mode_goldens.py

Writes ``tests/golden/torch/modes/``: ``<case>.alc`` per case, and
``manifest.json`` with, per case, the codec settings, the input (kind,
seed, shape), the per-plane value capacities ``kcaps``, the container's
SHA-256 and the SHA-256 of the JAX decodes (``exact=False`` and
``exact=True``) as raw (T, H, W, 3) uint8.

Cases (``s_seg`` 8; every input pads to one 2^20-symbol sparse plane):

* ``deep`` — noise at q=100, Haar: deep×sparse, lossless with the exact
  inverse; all 12 planes coded sparse;
* ``deep_dense`` — a larger noise chunk at q=100: its lo byte planes
  reach ``DENSE_ROW_FRAC`` and code dense, its hi byte planes sparse;
* ``deep_lossy`` — ``_test_chunk`` with ``deep=True`` at q=80: the hi
  byte planes are all zero, so all but the anchor plane are elided;
* ``rdo`` — ``_test_chunk`` with ``rdo=True`` at q=70: per-band steps on
  the wire beside sparse planes;
* ``rdo_gray`` — a grayscale chunk with ``rdo=True``: the chroma planes
  are elided, and their band steps ride the elided bitmap sections;
* ``levels`` — ``_test_chunk`` with ``levels=2`` at q=80.

The inputs come from ``chip_smoke.golden_input``, which imports no JAX,
so the card's checks make the same inputs.  :func:`make_cases` is also
what the ``slow`` test of ``tests/test_torch_alc3_modes.py`` reruns live.
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

OUT = ROOT / "tests" / "golden" / "torch" / "modes"
S_SEG = 8

#: case → (codec keyword arguments, input spec (kind, seed, shape))
CASES = {
    "deep": (dict(quality=100, wavelet="haar"), ("noise", 97, (4, 16, 16))),
    "deep_dense": (dict(quality=100, wavelet="cdf53"),
                   ("noise", 5, (8, 64, 128))),
    "deep_lossy": (dict(quality=80, wavelet="cdf53", deep=True),
                   ("chunk", 98, (4, 16, 16))),
    "rdo": (dict(quality=70, wavelet="cdf53", rdo=True),
            ("chunk", 95, (2, 16, 16))),
    "rdo_gray": (dict(quality=85, wavelet="cdf97", rdo=True),
                 ("gray", 3, (4, 16, 16))),
    "levels": (dict(quality=80, wavelet="cdf53", levels=2),
               ("chunk", 96, (4, 16, 16))),
}


def _sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def make_cases() -> dict:
    """Run the JAX sparse codec over every case: ``{case: (container bytes,
    kcaps, SHA-256 of the compat decode, SHA-256 of the exact decode)}``."""
    from alice_codec_tpu.alc3 import Alc3Codec

    out = {}
    for case, (kwargs, (kind, seed, shape)) in CASES.items():
        codec = Alc3Codec(s_seg=S_SEG, sparse=True, **kwargs)
        chunk = codec.encode(golden_input(kind, seed, shape))
        rgb = [np.asarray(codec.decode(chunk, exact=ex, as_numpy=True),
                          np.uint8).tobytes() for ex in (False, True)]
        out[case] = (Alc3Codec.to_bytes(chunk),
                     tuple(int(k) for k in chunk.kcaps),
                     _sha(rgb[0]), _sha(rgb[1]))
    return out


def main() -> None:
    made = make_cases()
    OUT.mkdir(parents=True, exist_ok=True)
    cases = {}
    for case, (kwargs, (kind, seed, shape)) in CASES.items():
        data, kcaps, rgb_sha, exact_sha = made[case]
        (OUT / f"{case}.alc").write_bytes(data)
        cases[case] = dict(codec=dict(s_seg=S_SEG, sparse=True, **kwargs),
                           kind=kind, seed=seed, shape=list(shape),
                           file=f"{case}.alc", kcaps=list(kcaps),
                           sha256=_sha(data), rgb_sha256=rgb_sha,
                           rgb_exact_sha256=exact_sha)
    (OUT / "manifest.json").write_text(
        json.dumps({"cases": cases}, indent=1) + "\n")
    print(f"wrote {len(made)} containers to {OUT}")


if __name__ == "__main__":
    main()
