#!/usr/bin/env python3
"""Before/after timing of the port's sparse significance kernels (K5
``compact``, K6 ``expand``) on one CUDA card, with the package of this
checkout or of another one (``--repo``, e.g. a parent commit unpacked
with ``git archive`` into a git-ignored directory), so that parent and
change can alternate in one run.

On the q=50 chunk of the main paths (64×1080×1920, CDF 5/3,
``Alc3Codec(50, "cdf53", sparse=True)``, whose Co and Cg planes are
coded sparse):

* the K5 and K6 wrappers on the chroma planes at the path's capacities,
  checked bit-exact against the plain versions, timed by CUDA events,
  with the host time of one call, and split by kernel with
  torch.profiler (the sparse kernel, and the torch ops around it);
* where the package has it, the same kernels through the in-place
  interface the codec calls (planes picked from phase 1's symbols,
  bitmaps and values in the wire's segment buffer, symbols written into
  the rows of the decoded planes);
* the codec's sparse entropy stage, ``alc3._encode_chunk_sparse`` and
  ``alc3._sparse_entropy_expand``, replayed on the arguments one q=50
  roundtrip gives them: timed by CUDA events and split into the sparse
  kernels, the rANS kernels, copies (copy, cat, stack, gather), fills,
  scans, histograms and the rest;
* the q=50 roundtrip: chunks/s over 5 (host clock, synchronized) and one
  roundtrip's device time by torch.profiler, split the same way.

The numbers are taken with ``chip_smoke.py``'s own helpers (``time_ms``,
``device_profile``, ``kernel_split``).  The last line is one JSON object
with every number.  Run from a checkout's root::

    python3 tools/sparse_profile.py [--repo DIR] [--label NAME]

Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from chip_smoke import (H, T, W, bound_ms, device_profile,  # noqa: E402
                        kernel_split, time_ms)

REPS = 10
ROUNDTRIPS = 5
#: parts of a device profile, by substrings of the kernel names
PARTS = {
    "K5 compact": ("::compact(",),
    "K6 expand": ("::expand(",),
    "K5/K6 group scan": ("::group_rows(", "::scan_groups("),
    "rANS K2/K3": ("encode_words", "decode_words"),
    "lifts K1/K4": ("spatial_tiles", "temporal_"),
    "copies": ("copy", "Memcpy", "CatArray", "index", "gather"),
    "fills": ("Fill", "Memset"),
    "scans": ("scan", "Scan"),
    "histograms": ("Histogram", "histogram"),
}


def split_rows(rows) -> dict:
    """Device ms of profile rows by :data:`PARTS` (first match), the rest
    as ``other``."""
    out = dict.fromkeys(PARTS, 0.0)
    out["other"] = 0.0
    for key, ms, _ in rows:
        part = next((p for p, subs in PARTS.items()
                     if any(s in key for s in subs)), "other")
        out[part] += ms
    return out


def host_ms(fn, reps: int = 20) -> float:
    """Host time to enqueue one call of ``fn`` (no synchronisation inside
    the loop; the device may still be busy after it)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return t


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", type=Path, default=ROOT,
                    help="checkout whose alice_codec_tpu_torch is timed")
    ap.add_argument("--label", default="", help="prefix of the printed lines")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("sparse_profile: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.repo.resolve()))
    from alice_codec_tpu_torch import (Alc3Codec, WaveletType, _build, alc3,
                                       pipeline, quality_to_step)
    from alice_codec_tpu_torch.ops.kernels import sparse
    from bench import _test_chunk

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    _build.build()
    dev = torch.device("cuda")
    lbl = args.label
    in_place = "pick" in inspect.signature(sparse.compact).parameters
    res = {"card": card, "label": lbl, "repo": str(args.repo.resolve()),
           "in_place": in_place}
    rgb = torch.as_tensor(_test_chunk(T, H, W), device=dev)
    padded, p = (W, H, T), T * H * W
    pp = alc3._sparse_pp(p)
    codec = Alc3Codec(50, "cdf53", sparse=True)
    step = quality_to_step(50)
    sym, trows, _ = pipeline.encode_sparse_phase1(
        rgb, step, step, wavelet_type=WaveletType.CDF53, padded=padded, pp=pp,
        active=(1, 2))
    rows = trows.sum(-1).tolist()
    krs, _ = codec._settle_krs(rows, (1, 2), pp)
    used = sum(rows) * 128
    ok = True

    # the wrappers as the tests and chip_smoke.py call them
    comp = lambda: sparse.compact(sym, trows, krs)  # noqa: E731
    bm, vals = comp()
    want_bm, want_vals = sparse.compact_plain(sym, trows, krs)
    exact5 = bool(torch.equal(bm, want_bm)) and bool(torch.equal(vals, want_vals))
    del want_bm, want_vals
    exp = lambda: sparse.expand(bm, vals, krs)  # noqa: E731
    exact6 = bool(torch.equal(exp(), sym))
    ok &= exact5 and exact6
    w = res["wrappers"] = {
        "planes": 2, "symbols": sym.numel(), "value_rows": rows,
        "capacity_rows": list(krs), "bit_exact": [exact5, exact6],
        "compact_ms": time_ms(comp, REPS), "expand_ms": time_ms(exp, REPS),
        "compact_host_ms": host_ms(comp), "expand_host_ms": host_ms(exp),
        "compact_split": kernel_split(comp, ("::compact(",)),
        "expand_split": kernel_split(exp, ("::expand(",)),
        "compact_bound_ms": bound_ms(sym.numel() + trows.numel() * 4 + bm.numel()
                                     + used),
        "expand_bound_ms": bound_ms(bm.numel() + used + sym.numel())}
    for name in ("compact", "expand"):
        w[f"{name}_kernel_ms"] = sum(w[f"{name}_split"].get(k, 0.0) for k in (
            name, "group_rows", "scan_groups"))
        print(f"{lbl} K{5 if name == 'compact' else 6} {name}: bit-exact "
              f"{exact5 if name == 'compact' else exact6}; wrapper "
              f"{w[f'{name}_ms']:.3f} ms (host {w[f'{name}_host_ms']:.3f} ms a "
              f"call), kernel {w[f'{name}_kernel_ms']:.3f} ms, bound "
              f"{w[f'{name}_bound_ms']:.3f} ms [{card}]")
        print(f"{lbl}   split: " + ", ".join(
            f"{k[:60]} {v:.3f}" for k, v in w[f"{name}_split"].items()))

    if in_place:
        # the codec's calls: two planes picked out of three, bitmaps and
        # values written into one segment buffer, symbols into the rows
        # of the decoded planes (p < pp)
        three = torch.nn.functional.pad(sym, (0, 0, 1, 0))
        mb = -(-pp // 8 // (1 << 18)) * (1 << 18)
        sizes = [mb, mb] + [k * 128 for k in krs]
        buf = torch.empty(sum(sizes), dtype=torch.uint8, device=dev)
        parts = torch.split(buf, sizes)
        out = ([parts[0], parts[1]], [parts[2], parts[3]])
        three_rows = torch.nn.functional.pad(trows, (0, 0, 1, 0))
        comp_ip = lambda: sparse.compact(  # noqa: E731
            three, three_rows, krs, pick=(1, 2), out=out)
        comp_ip()
        exact5 = (bool(torch.equal(parts[0][: pp // 8], bm[0]))
                  and bool(torch.equal(parts[1][: pp // 8], bm[1]))
                  and not bool(parts[0][pp // 8 :].any())
                  and bool(torch.equal(torch.cat(parts[2:]), vals.reshape(-1))))
        dec = torch.empty((3, p), dtype=torch.uint8, device=dev)
        exp_ip = lambda: sparse.expand(  # noqa: E731
            [parts[0][: pp // 8], parts[1][: pp // 8]], [parts[2], parts[3]],
            krs, out=[dec[1], dec[2]])
        exp_ip()
        exact6 = bool(torch.equal(dec[1:], sym[:, :p]))
        ok &= exact5 and exact6
        ip = res["in_place"] = {
            "bit_exact": [exact5, exact6],
            "compact_ms": time_ms(comp_ip, REPS), "expand_ms": time_ms(exp_ip, REPS),
            "compact_host_ms": host_ms(comp_ip), "expand_host_ms": host_ms(exp_ip),
            "compact_split": kernel_split(comp_ip, ("::compact(",)),
            "expand_split": kernel_split(exp_ip, ("::expand(",))}
        print(f"{lbl} in place (2 of 3 planes picked; segment buffer; p < pp): "
              f"bit-exact {ip['bit_exact']}; compact {ip['compact_ms']:.3f} ms "
              f"(host {ip['compact_host_ms']:.3f}), expand {ip['expand_ms']:.3f} "
              f"ms (host {ip['expand_host_ms']:.3f}) [{card}]")
        for name in ("compact", "expand"):
            print(f"{lbl}   {name} split: " + ", ".join(
                f"{k[:60]} {v:.3f}" for k, v in ip[f"{name}_split"].items()))
        del three, buf, parts, out, dec
    del sym, trows, bm, vals
    torch.cuda.empty_cache()

    # the sparse entropy stage as one roundtrip calls it, replayed
    calls = {}

    def recording(name):
        fn = getattr(alc3, name)

        def call(*a, **kw):
            calls[name] = (a, kw)
            return fn(*a, **kw)
        return fn, call

    saved = {}
    for name in ("_encode_chunk_sparse", "_sparse_entropy_expand"):
        saved[name], rec = recording(name)
        setattr(alc3, name, rec)
    try:
        out_rgb = codec.decode(codec.encode(rgb))
    finally:
        for name, fn in saved.items():
            setattr(alc3, name, fn)
    del out_rgb
    stage = res["stage"] = {"kcaps": list(codec.encode(rgb).kcaps)}
    for name, fn in saved.items():
        a, kw = calls[name]
        call = lambda: fn(*a, **kw)  # noqa: E731
        _, rows_p = device_profile(call)
        stage[name] = {"ms": time_ms(call, REPS), "host_ms": host_ms(call, 5),
                       "device_ms": sum(r[1] for r in rows_p),
                       "split": split_rows(rows_p),
                       "top": [(k[:90], ms, n) for k, ms, n in rows_p[:10]]}
        s = stage[name]
        print(f"{lbl} {name}: {s['ms']:.3f} ms by events (host {s['host_ms']:.3f} "
              f"ms a call), device {s['device_ms']:.3f} ms: " + ", ".join(
                  f"{k} {v:.3f}" for k, v in s["split"].items() if v) + f" [{card}]")
        for k, ms, n in s["top"]:
            print(f"{lbl}     {ms:9.3f} ms  x{n:<3d} {k}")
    del calls
    torch.cuda.empty_cache()

    # the q=50 roundtrip
    codec.decode(codec.encode(rgb))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ROUNDTRIPS):
        codec.decode(codec.encode(rgb))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    wall_ms, rows_p = device_profile(lambda: codec.decode(codec.encode(rgb)))
    busy = sum(r[1] for r in rows_p)
    r = res["roundtrip"] = {
        "chunks_per_s": ROUNDTRIPS / wall, "profiled_wall_ms": wall_ms,
        "device_ms": busy, "split": split_rows(rows_p),
        "top": [(k[:90], ms, n) for k, ms, n in rows_p[:16]]}
    print(f"{lbl} q=50 roundtrip ({T}x{H}x{W}): {r['chunks_per_s']:.4f} chunks/s "
          f"over {ROUNDTRIPS} (host clock); one roundtrip {busy:.3f} ms of device "
          f"time in {wall_ms:.3f} ms wall (profiled) [{card}]")
    print(f"{lbl}   device time by part: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in r["split"].items()))
    for k, ms, n in r["top"]:
        print(f"{lbl}   {ms:9.3f} ms  x{n:<3d} {k}")
    print(json.dumps(res))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
