#!/usr/bin/env python3
"""The benchmark of ``alice_codec_tpu_torch`` (the PyTorch / CUDA port of
the ALICE codec) on one NVIDIA H100.

Run from the root of a checkout::

    python3 benchmark/run.py --workload ns1080.chunk --seed 7 --seconds 10 --trace 0

``--workload`` names a cell of ``BENCHMARK.json``; its configuration,
traffic mix and metrics are found by name (``harness.py``).  The last
line of standard output is the result, one JSON object; the numbers
compared to decide ``correct`` are also the last lines of standard error.
The run fails (no result, exit code not 0) without enough CUDA cards,
without the port in the checkout, or when JAX or the JAX package has been
loaded by the time the window closes.

Caches stay inside the checkout: the port builds its kernels into
``alice_codec_tpu_torch/_build/`` beside its sources, and PyTorch's and
Triton's kernel caches are pointed at ``.bench_cache/``.
"""

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
PORT = "alice_codec_tpu_torch"


def _fail(code: int, msg: str) -> int:
    print(f"benchmark: {msg}", file=sys.stderr)
    return code


def _card_line(torch) -> str:
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as e:
        smi = [f"nvidia-smi failed: {e}"]
    return json.dumps({"card": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                       "device_count": torch.cuda.device_count(),
                       "torch": torch.__version__, "cuda": torch.version.cuda})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / PORT / "__init__.py").is_file():
        return _fail(2, f"the port ({PORT}/) is not in the checkout {ROOT}")
    # one process with few threads: the host's part of a roundtrip is the
    # Python thread that drives the card, and idle CPU kernel pools only
    # contend with it
    os.environ["OMP_NUM_THREADS"] = "1"
    cache = ROOT / ".bench_cache"
    for var, sub in (("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"),
                     ("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(cache / sub)
    for p in (str(HERE), str(ROOT)):
        if p in sys.path:
            sys.path.remove(p)
        sys.path.insert(0, p)

    import harness

    try:
        cell = harness.load_cell(ROOT, args.workload)
    except (harness.CellError, KeyError) as e:
        return _fail(2, f"cannot load workload {args.workload!r}: {e}")

    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        return _fail(3, "no CUDA device is available")
    if torch.cuda.device_count() < cell.chips:
        return _fail(3, f"{cell.name} needs {cell.chips} cards, "
                        f"{torch.cuda.device_count()} visible")

    import alice_codec_tpu_torch

    where = Path(alice_codec_tpu_torch.__file__).resolve()
    if ROOT not in where.parents:
        return _fail(2, f"imported the port from {where}, not from the checkout {ROOT}")

    try:
        result = harness.run_cell(cell, seed=args.seed, seconds=args.seconds,
                                  trace=bool(args.trace), device="cuda",
                                  t_start=_T_START,
                                  log=lambda s: print(s, flush=True),
                                  after_window=lambda: print(_card_line(torch), flush=True))
    except harness.ForbiddenModules as e:
        return _fail(4, f"{e}: the benchmark may load neither JAX nor the JAX package")
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
