#!/usr/bin/env python3
"""Before/after timing of the port's level-0 lift kernels on one CUDA
card, with the package of this checkout or of another one (``--repo``,
e.g. a parent commit unpacked with ``git archive`` into a git-ignored
directory), so that parent and change can alternate in one run.

At the main paths' chunk (64×1080×1920, q=90): K1 ``forward_quant`` and
K4 ``inverse_dequant`` (compat and exact inverse) in every wavelet, each
checked bit-exact against its plain version, timed and split by kernel
with ``chip_smoke.py``'s own helpers (``time_ms``, ``kernel_split``: the
numbers are taken as phase 2 there takes them), with the wrappers' peak
device memory above their inputs; the colour route, RGB frames to
symbols and back as the codec runs it at this chunk (a checkout with
``forward_quant_rgb`` / ``inverse_dequant_rgb``: the colour in K1's load
and K4's store; one without: ``_color_pad`` + K1 and K4 +
``ycocg_r_to_rgb``), checked equal to the plain composition and timed
beside its bound at 2 bytes a coefficient (uint8 RGB, uint8 symbols);
then K7 (``forward_3d`` /
``inverse_3d`` in compat and exact form, int32) in every wavelet, at that
chunk and at the 4K check's (16×2160×3840), likewise checked, timed and
split by kernel (the split names whatever kernels the checkout's K7
launches), with its peak device memory above the input over one forward
and one inverse call.  The last line is one JSON object with every
number.  Run from a checkout's root::

    python3 tools/lift_profile.py [--repo DIR] [--label NAME]

Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from chip_smoke import (H, H4K, QUALITY, T, T4K, W, W4K, bound_ms,  # noqa: E402
                        kernel_split, time_ms)

REPS = 10


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", type=Path, default=ROOT,
                    help="checkout whose alice_codec_tpu_torch is timed")
    ap.add_argument("--label", default="", help="prefix of the printed lines")
    args = ap.parse_args()

    import subprocess

    import torch

    if not torch.cuda.is_available():
        print("lift_profile: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.repo.resolve()))
    from alice_codec_tpu_torch import WaveletType, _build, pipeline, quality_to_step
    from alice_codec_tpu_torch.ops import color
    from alice_codec_tpu_torch.ops.kernels import lift
    from alice_codec_tpu_torch.ops.kernels.lift import (
        forward_3d, forward_3d_plain, forward_quant, forward_quant_plain,
        inverse_3d, inverse_3d_plain, inverse_dequant, inverse_dequant_plain)
    from bench import _test_chunk

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    _build.build(("lift",))
    dev = torch.device("cuda")
    rgb = torch.as_tensor(_test_chunk(T, H, W), device=dev)
    vol = pipeline._color_pad(rgb, (W, H, T))
    step = quality_to_step(QUALITY)
    steps3 = torch.full((3,), step, dtype=torch.int32, device=dev)
    fused_rgb = hasattr(lift, "forward_quant_rgb")
    if fused_rgb:
        def k1_colour(wt):
            return lift.forward_quant_rgb(rgb, wt, step, step)[0]

        def k4_colour(sym, wt):
            return lift.inverse_dequant_rgb(sym, wt, steps3)
    else:
        def k1_colour(wt):
            return forward_quant(pipeline._color_pad(rgb, (W, H, T)), wt, step, step)

        def k4_colour(sym, wt):
            return color.ycocg_r_to_rgb(*inverse_dequant(sym, wt, steps3))
    res = {"card": card, "label": args.label, "repo": str(args.repo.resolve()),
           "shape": list(vol.shape),
           "k1k4_bound_ms": bound_ms(vol.numel() * 3),
           "colour_route": "rgb kernels" if fused_rgb else "torch colour + K1 / K4",
           "colour_bound_ms": bound_ms(vol.numel() * 2),
           "k7_bound_ms": bound_ms(vol.numel() * 8)}
    for wt in WaveletType:
        sym = forward_quant(vol, wt, step, step)
        ok = bool(torch.equal(sym, forward_quant_plain(vol, wt, step, step)))
        for exact in (False, True):
            ok &= bool(torch.equal(
                inverse_dequant(sym, wt, steps3, exact=exact),
                inverse_dequant_plain(sym, wt, steps3, exact=exact)))
        torch.cuda.empty_cache()
        fwd = lambda: forward_quant(vol, wt, step, step)  # noqa: E731
        inv = lambda: inverse_dequant(sym, wt, steps3)  # noqa: E731
        r = res[wt.name] = {
            "bit_exact": ok,
            "forward_quant_ms": time_ms(fwd, REPS),
            "inverse_dequant_ms": time_ms(inv, REPS),
            "inverse_dequant_exact_ms": time_ms(
                lambda: inverse_dequant(sym, wt, steps3, exact=True), REPS),
            "forward_quant_split": kernel_split(fwd),
            "inverse_dequant_split": kernel_split(inv)}
        c_sym = k1_colour(wt)
        r["colour_bit_exact"] = bool(torch.equal(c_sym, sym)) and bool(torch.equal(
            k4_colour(sym, wt),
            color.ycocg_r_to_rgb(*inverse_dequant_plain(sym, wt, steps3))))
        del c_sym
        torch.cuda.empty_cache()
        r["k1_colour_ms"] = time_ms(lambda: k1_colour(wt), REPS)
        r["k4_colour_ms"] = time_ms(lambda: k4_colour(sym, wt), REPS)
        r["k1_colour_split"] = kernel_split(lambda: k1_colour(wt))
        r["k4_colour_split"] = kernel_split(lambda: k4_colour(sym, wt))
        print(f"{args.label} {wt.name} colour route ({res['colour_route']}): equal "
              f"{r['colour_bit_exact']}; RGB -> symbols {r['k1_colour_ms']:.3f} ms, "
              f"symbols -> RGB {r['k4_colour_ms']:.3f} ms (bound "
              f"{res['colour_bound_ms']:.3f} ms each) [{card}]")
        for what in ("k1_colour_split", "k4_colour_split"):
            print(f"  {what}: " + ", ".join(f"{k} {v:.3f}" for k, v in r[what].items()))
        ok &= r["colour_bit_exact"]
        r["bit_exact"] = ok
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fwd()
        inv()
        torch.cuda.synchronize()
        r["peak_scratch_gib"] = (torch.cuda.max_memory_allocated() - base) / 2**30
        print(f"{args.label} {wt.name}: bit-exact {ok}; forward_quant "
              f"{r['forward_quant_ms']:.3f} ms, inverse_dequant "
              f"{r['inverse_dequant_ms']:.3f} ms (exact "
              f"{r['inverse_dequant_exact_ms']:.3f}); peak above the inputs "
              f"{r['peak_scratch_gib']:.3f} GiB [{card}]")
        for what in ("forward_quant_split", "inverse_dequant_split"):
            print(f"  {what}: " + ", ".join(
                f"{k} {v:.3f}" for k, v in r[what].items()))
        del sym
        torch.cuda.empty_cache()
    vols32 = {"1080p": vol.to(torch.int32)}
    del vol, rgb
    rgb4k = torch.as_tensor(_test_chunk(T4K, H4K, W4K, seed=1), device=dev)
    vols32["4k"] = pipeline._color_pad(rgb4k, (W4K, H4K, T4K), torch.int32)
    del rgb4k
    # the kernels a K7 call must show in its split: the temporal pass and
    # the checkout's spatial one
    src = (args.repo / "alice_codec_tpu_torch" / "csrc" / "lift.cu").read_text()
    need = ("temporal_lift", "col_lift" if "col_lift" in src else "spatial_tiles")
    for size, v32 in vols32.items():
        res[f"k7_{size}_bound_ms"] = bound_ms(v32.numel() * 8)
        for wt in WaveletType:
            c = forward_3d(v32, wt)
            ok = bool(torch.equal(c, forward_3d_plain(v32, wt)))
            for exact in (False, True):
                ok &= bool(torch.equal(inverse_3d(c, wt, exact=exact),
                                       inverse_3d_plain(c, wt, exact=exact)))
            torch.cuda.empty_cache()
            calls = {"forward_3d": lambda: forward_3d(v32, wt),
                     "inverse_3d": lambda: inverse_3d(c, wt),
                     "inverse_3d_exact": lambda: inverse_3d(c, wt, exact=True)}
            r = res[f"K7 {size} {wt.name}"] = {"bit_exact": ok}
            for name, fn in calls.items():
                r[name + "_ms"] = time_ms(fn, REPS)
                r[name + "_split"] = kernel_split(fn, need)
            del c
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            inverse_3d(forward_3d(v32, wt), wt)
            torch.cuda.synchronize()
            r["peak_above_input_gib"] = (torch.cuda.max_memory_allocated() - base) / 2**30
            print(f"{args.label} K7 {size} {wt.name}: bit-exact {ok}; "
                  + ", ".join(f"{n} {r[n + '_ms']:.3f} ms" for n in calls)
                  + f"; peak above the input {r['peak_above_input_gib']:.3f} GiB "
                  f"[{card}]")
            for name in calls:
                print(f"  {name}_split: " + ", ".join(
                    f"{k} {v:.3f}" for k, v in r[name + "_split"].items()))
    print(json.dumps(res))
    return 0 if all(v.get("bit_exact", True) for v in res.values()
                    if isinstance(v, dict)) else 1


if __name__ == "__main__":
    sys.exit(main())
