"""Write the JAX-made dense ALC3 golden that the PyTorch port is held to.

A machine that runs the port on a card need not have JAX, so the JAX
package's output is committed: one small dense ALC3 container and its
two decodes.  Run from
the repository root with the JAX package importable::

    JAX_PLATFORMS=cpu python tools/golden/gen_torch_goldens.py

Writes ``tests/golden/torch/``:

* ``dense.alc`` — ``Alc3Codec(quality, wavelet, s_seg)`` container of the
  input ``bench._test_chunk(t, h, w, seed)``;
* ``dense.compat.rgb`` / ``dense.exact.rgb`` — the JAX decodes of that
  container (``exact=False`` / ``exact=True``), raw (T, H, W, 3) uint8;
* ``manifest.json`` — the input's seed and shape, the codec settings and
  the SHA-256 of each file.

``tests/test_torch_alc3.py`` checks that JAX still writes these bytes and
that the port reproduces them; ``chip_smoke.py`` checks the port on the
card against them.
"""

from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
OUT = ROOT / "tests" / "golden" / "torch"
#: odd dims, so the container exercises the edge padding (→ 6×32×64)
SPEC = {"t": 5, "h": 31, "w": 63, "seed": 1, "quality": 90,
        "wavelet": "cdf53", "s_seg": 16}


def main() -> None:
    sys.path.insert(0, str(ROOT))
    from alice_codec_tpu.alc3 import Alc3Codec
    from bench import _test_chunk

    rgb = _test_chunk(SPEC["t"], SPEC["h"], SPEC["w"], seed=SPEC["seed"])
    codec = Alc3Codec(quality=SPEC["quality"], wavelet=SPEC["wavelet"],
                      s_seg=SPEC["s_seg"])
    chunk = codec.encode(rgb)
    files = {
        "dense.alc": Alc3Codec.to_bytes(chunk),
        "dense.compat.rgb": np.asarray(
            codec.decode(chunk, as_numpy=True), np.uint8).tobytes(),
        "dense.exact.rgb": np.asarray(
            codec.decode(chunk, exact=True, as_numpy=True), np.uint8).tobytes(),
    }
    OUT.mkdir(parents=True, exist_ok=True)
    for name, data in files.items():
        (OUT / name).write_bytes(data)
    manifest = dict(SPEC, sha256={
        name: hashlib.sha256(data).hexdigest() for name, data in files.items()})
    (OUT / "manifest.json").write_text(json.dumps(manifest, indent=1) + "\n")
    print(f"wrote {len(files)} files to {OUT}")


if __name__ == "__main__":
    main()
