#!/usr/bin/env python3
"""Before/after timing of the port's ALC3 word-rANS kernels (K2
``encode_words``, K3 ``decode_words``) on one CUDA card, with the package
of this checkout or of another one (``--repo``, e.g. a parent commit
unpacked with ``git archive`` into a git-ignored directory), so that
parent and change can alternate in one run.

At the main paths' chunk (64×1080×1920, CDF 5/3):

* the dense path's 1536 segments (3 planes × 512, one table a plane):
  one K2 and one K3 launch, checked bit-exact against the plain versions,
  timed by CUDA events, with the per-step cycles (ms × SM clock / s_seg)
  and the bytes bound;
* the sparse paths' entropy stage (``alc3._encode_chunk_sparse`` /
  ``alc3._sparse_entropy_expand``: the north star ``Alc3Codec(90,
  sparse=True)`` and q=50, whose chroma planes are sparse), timed whole
  and split by kernel with torch.profiler, with the K2 / K3 launches it
  makes;
* where the package has it, the check of the encode kernel's reciprocal
  division against hardware division (``rans3.rcp_mismatches``).

The numbers are taken with ``chip_smoke.py``'s own helpers (``time_ms``,
``kernel_split``).  The last line is one JSON object with every number.
Run from a checkout's root::

    python3 tools/rans3_profile.py [--repo DIR] [--label NAME]

Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from chip_smoke import H, T, W, bound_ms, device_profile, kernel_split, time_ms  # noqa: E402

REPS = 5


def sm_clock_mhz() -> float:
    """The SM clock now, by nvidia-smi (MHz)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout
    return float(out.split()[0])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", type=Path, default=ROOT,
                    help="checkout whose alice_codec_tpu_torch is timed")
    ap.add_argument("--label", default="", help="prefix of the printed lines")
    args = ap.parse_args()

    import inspect

    import torch

    if not torch.cuda.is_available():
        print("rans3_profile: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.repo.resolve()))
    from alice_codec_tpu_torch import (Alc3Codec, WaveletType, _build, alc3,
                                       pipeline, quality_to_step)
    from alice_codec_tpu_torch.ops.kernels import launch_counts, rans3, reset_launches
    from alice_codec_tpu_torch.ops.tables_device import freq_table_device
    from bench import _test_chunk

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    _build.build()
    dev = torch.device("cuda")
    lbl = args.label
    rgb = torch.as_tensor(_test_chunk(T, H, W), device=dev)
    padded, p = (W, H, T), T * H * W
    s_seg = alc3.DEFAULT_S_SEG
    wt = WaveletType.CDF53
    folded = "planes" in inspect.signature(rans3.encode_words).parameters
    res = {"card": card, "label": lbl, "repo": str(args.repo.resolve()),
           "folded": folded}

    # the dense path's segments, one launch each way
    step = quality_to_step(90)
    # the encode stage returns (symbols, histograms), and with the
    # plane-statistics kernel the maxima third, which the coverage floor
    # then takes in place of the planes
    symbols, hists, *maxima = pipeline.encode_device(
        rgb, step, step, wavelet_type=wt, padded=padded,
        hist_stride=alc3.HIST_STRIDE, interleaved=True)
    hists = alc3._covered_hist(hists, maxima[0] if maxima else symbols)
    n_seg, m = alc3._segment_geometry(p, s_seg)
    freqs, cums = freq_table_device(alc3._table_hists(hists, p, s_seg=s_seg))
    segs = torch.nn.functional.pad(symbols, (0, m - p)).reshape(3 * n_seg, s_seg, 128)
    del symbols
    st, cn = rans3.encode_words(segs, freqs, cums)
    st_p, cn_p = rans3.encode_words_plain(segs, freqs, cums)
    ok = bool(torch.equal(st, st_p)) and bool(torch.equal(cn, cn_p))
    del st_p, cn_p
    out = rans3.decode_words(st, cn, freqs, cums, s_seg=s_seg)
    ok &= bool(torch.equal(out, segs))
    ok &= bool(torch.equal(out, rans3.decode_words_plain(st, cn, freqs, cums, s_seg=s_seg)))
    words = int(cn.to(torch.int64).sum())
    enc = lambda: rans3.encode_words(segs, freqs, cums)  # noqa: E731
    dec = lambda: rans3.decode_words(st, cn, freqs, cums, s_seg=s_seg)  # noqa: E731
    d = res["dense"] = {
        "bit_exact": ok, "segments": 3 * n_seg, "words": words,
        "encode_ms": time_ms(enc, REPS), "decode_ms": time_ms(dec, REPS)}
    clock = sm_clock_mhz()
    d.update(
        sm_clock_mhz=clock,
        encode_cycles_per_step=d["encode_ms"] * 1e-3 * clock * 1e6 / s_seg,
        decode_cycles_per_step=d["decode_ms"] * 1e-3 * clock * 1e6 / s_seg,
        encode_bound_ms=bound_ms(segs.numel() + st.numel() * 4 + cn.numel() * 4),
        decode_bound_ms=bound_ms(words * 4 + cn.numel() * 4 + segs.numel()),
        encode_split=kernel_split(enc), decode_split=kernel_split(dec))
    if hasattr(rans3, "rcp_mismatches"):
        d["rcp_mismatches"] = rans3.rcp_mismatches(dev)
    print(f"{lbl} dense {3 * n_seg} segments: bit-exact {ok}; encode_words "
          f"{d['encode_ms']:.3f} ms ({d['encode_cycles_per_step']:.0f} cycles a "
          f"step at {clock:.0f} MHz; bound {d['encode_bound_ms']:.3f}), "
          f"decode_words {d['decode_ms']:.3f} ms "
          f"({d['decode_cycles_per_step']:.0f} cycles a step; bound "
          f"{d['decode_bound_ms']:.3f}) [{card}]")
    if "rcp_mismatches" in d:
        print(f"{lbl}   rcp_mismatches: {d['rcp_mismatches']}")
    for k in ("encode_split", "decode_split"):
        print(f"{lbl}   {k}: " + ", ".join(f"{a} {v:.3f}" for a, v in d[k].items()))
    # segments in flight: a chain bound by its own latency takes as long
    # for fewer segments, one bound by the SMs' issue or pipes takes less
    sweep = d["sweep"] = {}
    for n in (132, 264, n_seg, 2 * n_seg, 3 * n_seg):  # whole planes past one
        k = -(-n // n_seg)
        sg, s_n, c_n = segs[:n], st[:n], cn[:n]
        sweep[n] = {
            "encode_ms": time_ms(lambda: rans3.encode_words(
                sg, freqs[:k], cums[:k]), REPS),
            "decode_ms": time_ms(lambda: rans3.decode_words(
                s_n, c_n, freqs[:k], cums[:k], s_seg=s_seg), REPS)}
        print(f"{lbl}   {n} segments: encode_words {sweep[n]['encode_ms']:.3f} ms, "
              f"decode_words {sweep[n]['decode_ms']:.3f} ms")
    del segs, st, cn, out
    torch.cuda.empty_cache()

    # the sparse paths' entropy stage, as the codec calls it
    pp = alc3._sparse_pp(p)
    nb, _ = alc3._segment_geometry(pp // 8, s_seg)
    v_b = alc3._pick_v_seg(nb)
    for q in (90, 50):
        codec = Alc3Codec(q, "cdf53", sparse=True)
        sym, trows, _ = pipeline.encode_sparse_phase1(
            rgb, codec.step, codec.step, wavelet_type=wt, padded=padded, pp=pp)
        rows = trows.sum(-1).tolist()
        krs, dense_rows = codec._settle_krs(rows, (0, 1, 2), pp)
        dense = tuple(i for i, k in enumerate(krs) if k == dense_rows)
        kcaps = tuple(k * 128 for k in krs)

        def encode():
            return alc3._encode_chunk_sparse(
                sym, trows, pp=pp, s_seg=s_seg, krs=krs, v_b=v_b,
                wire_active=(0, 1, 2), dense=dense)

        streams, counts, hists = encode()

        def decode():
            return alc3._sparse_entropy_expand(
                streams, counts, hists, p=p, s_seg=s_seg, kcaps=kcaps, v_b=v_b)

        ok = bool(torch.equal(decode(), sym[:, :p]))
        reset_launches()
        encode()
        decode()
        torch.cuda.synchronize()
        launches = {k: v for k, v in launch_counts().items() if v}
        name = "north_star_q90" if q == 90 else "sparse_q50"
        r = res[name] = {
            "bit_exact": ok, "krs": list(krs), "dense": list(dense),
            "launches": launches,
            "encode_stage_ms": time_ms(encode, REPS),
            "decode_stage_ms": time_ms(decode, REPS),
            "encode_split": kernel_split(encode),
            "decode_split": kernel_split(decode)}
        _, prof = device_profile(encode)
        r["encode_device_ms"] = sum(ms for _, ms, _ in prof)
        _, prof = device_profile(decode)
        r["decode_device_ms"] = sum(ms for _, ms, _ in prof)
        print(f"{lbl} {name}: bit-exact {ok}; capacity rows {list(krs)}, dense "
              f"{list(dense)}; launches {launches}; entropy encode stage "
              f"{r['encode_stage_ms']:.3f} ms (device {r['encode_device_ms']:.3f}), "
              f"decode stage {r['decode_stage_ms']:.3f} ms (device "
              f"{r['decode_device_ms']:.3f}) [{card}]")
        for k in ("encode_split", "decode_split"):
            print(f"{lbl}   {k}: " + ", ".join(
                f"{a} {v:.3f}" for a, v in r[k].items()))
        del sym, trows, streams, counts, hists
        torch.cuda.empty_cache()
    print(json.dumps(res))
    exact = [v["bit_exact"] for v in res.values() if isinstance(v, dict)]
    return 0 if all(exact) and res["dense"].get("rcp_mismatches", 0) == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
