#!/usr/bin/env python3
"""The control of a cell's correctness check, at the cell's own size.

    python3 benchmark/control.py --workload ns1080.chunk --seeds 11 12 13

For each seed it makes the cell's pool on the card and judges, with the
same comparison a run makes (``checks.py``), what the control puts in the
program's place for every pool chunk:

* a lossy configuration (integer lifting with an int16 store between the
  spatial and the temporal pass): the plain reference with that store
  lowered to int8, the next precision down;
* a lossless configuration: the program itself with its own non-exact
  inverse (``exact=False``, the compat replay), which breaks the
  configuration's "lossless" guarantee (its int32 lifting held at int16
  changes nothing on 8-bit video, so a lower precision is no control).

It prints one JSON line a seed with the numbers and whether they pass,
and exits 1 if any seed's control passed.  The benchmark's runs never
run it.
"""

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
for p in (str(HERE), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def control_samples(cell, seed: int, device: str):
    """(input, symbols or chunk, decoded) triples of the control."""
    import torch

    import checks
    import harness
    cfg = cell.config
    geo = cfg["chunk"]
    pool = harness.generator(cell.root, cell.traffic).make_pool(
        cell.traffic["content"], int(cell.traffic["pool"]), seed, geo["frames"],
        geo["height"], geo["width"], device)
    if cfg.get("lossless"):
        from alice_codec_tpu_torch import Alc3Codec

        codec = Alc3Codec(**cfg["codec"], device=device)
        for x in pool:
            c = codec.encode(x)
            yield x, c, codec.decode(c, exact=False)
    else:
        ref = checks.reference_of(cfg)
        low = checks.spec_of(cfg, store=torch.int8)
        for x in pool:
            sym = ref.forward_symbols(x, low)
            yield x, sym, ref.inverse_rgb(sym, low)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    import checks
    import harness

    if args.device == "cuda" and not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    cell = harness.load_cell(ROOT, args.workload)
    passed_any = False
    for seed in args.seeds:
        numbers, failed = checks.judge(control_samples(cell, seed, args.device), cell.config)
        ok = checks.passed(numbers)
        passed_any |= ok
        print(json.dumps({"workload": cell.name, "seed": seed, "control": numbers,
                          "samples_failed": failed, "passes": ok}), flush=True)
    return 1 if passed_any else 0


if __name__ == "__main__":
    sys.exit(main())
