#!/usr/bin/env python3
"""Timing of the plane-statistics kernel (``ops/kernels/hist.py``
``plane_stats``, ``csrc/hist.cu``) alone on one CUDA card, on the planes
the codec gives it at the benchmark cells' shapes (64×1080×1920 chunks,
``bench._test_chunk``'s content), recorded as each path encodes
(``chip_smoke.recorded_plane_stats``):

* ``north_star``: the north star's sparse wire (``Alc3Codec(90, "cdf53",
  sparse=True)``): its bitmaps and value planes, stride 16, with maxima;
* ``lossless``: the lossless chunk's 6 deep byte planes, likewise;
* ``alc2_batch``: the ALC2 batch's 12 full planes in the reference layout
  (q=90), every symbol counted, as the encoder calls it (a call of 3
  planes a chunk), and ``alc2_one_launch``, the 12 in one call;
* ``dense_chunk``: the dense q=90 path's 3 interleaved planes, stride 16;
* ``zero12`` / ``uniform12``: 12 full planes all 0 / uniform, the skew
  check.

Each beside its bound (every byte of its planes read once over 3.35 TB/s:
the maxima read whole planes), the plain version on the card
(``plane_stats_plain``: ``torch.bincount`` of an int64 copy of the
sampled rows, and ``amax``) and ``torch.bincount`` of the uint8 sampled
rows as the library yardstick (``chip_smoke.plane_stats_case``).  Every
case checks the kernel's counts and maxima against the plain version.  The
last line is one JSON object with every number.  Run from a checkout's
root::

    python3 tools/hist_profile.py

Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from chip_smoke import (ALC2_CHUNKS, ALC2_LANES, QUALITY, H, T, W,  # noqa: E402
                        kernel_split, plane_stats_case, plane_stats_cases,
                        recorded_plane_stats)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("hist_profile: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    from alice_codec_tpu_torch import Alc3Codec, _build
    from alice_codec_tpu_torch.ops.kernels import hist
    from alice_codec_tpu_torch.parallel import BatchFrameEncoder
    from bench import _test_chunk

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    _build.build(("hist",))
    dev = torch.device("cuda")
    batch = torch.stack([torch.as_tensor(_test_chunk(T, H, W, seed=i), device=dev)
                         for i in range(ALC2_CHUNKS)])
    res = {"card": card, "shape": [T, H, W],
           "cases": plane_stats_cases(batch[0], batch, card)["cases"]}

    alc2 = recorded_plane_stats(lambda: BatchFrameEncoder(
        QUALITY, "cdf53", n_lanes=ALC2_LANES,
        device_entropy=True).encode_device_stage(batch))
    g = torch.Generator(device=dev).manual_seed(1)
    p = T * H * W
    extra = {
        "alc2_one_launch": [([v for planes, _ in alc2 for v in planes], 1)],
        "dense_chunk": recorded_plane_stats(
            lambda: Alc3Codec(QUALITY, "cdf53").encode(batch[0])),
        "zero12": [(list(torch.zeros((12, p), dtype=torch.uint8, device=dev)), 1)],
        "uniform12": [(list(torch.randint(0, 256, (12, p), dtype=torch.uint8,
                                          device=dev, generator=g)), 1)],
    }
    for name, calls in extra.items():
        res["cases"][name] = plane_stats_case(name, calls, card)
    res["alc2_batch_split"] = split = kernel_split(
        lambda: [hist.plane_stats(*call) for call in alc2], need=("plane_stats",))
    print("alc2_batch by kernel: " + ", ".join(f"{k} {v:.4f} ms" for k, v in split.items()))
    c = res["cases"]
    res["zero_over_uniform"] = c["zero12"]["ms"] / c["uniform12"]["ms"]
    print(f"all-zero / uniform time: {res['zero_over_uniform']:.3f}")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
