#!/usr/bin/env python3
"""Before/after timing of the port's ALC2 device entropy coder (K8, the
N-lane byte-rANS encode and its pack; K9, the decode) on one CUDA card,
with the package of this checkout or of another one (``--repo``, e.g. a
parent commit unpacked with ``git archive`` into a git-ignored
directory), so that parent and change can alternate in one run.

On the ALC2 batch of ``bench.py``'s ``config4_alc_batched_decode`` (4
chunks of 64×1080×1920 at q=90 CDF 5/3, 4096 lanes: 12 streams of
32,400 steps × 4096 lanes):

* the per-step encode kernel (``encode_nway``), the 12 ``pack_device``
  calls on its output and the concatenation of their payloads (what
  ``parallel/batch.py``'s ``_compact_payloads`` did), each timed by CUDA
  events, and the three as one route split by kernel with torch.profiler;
* where the package has it, the packed route (``encode_pack_nway``: the
  coder writing per-lane slabs, then their compaction), timed and split
  by kernel, and held byte for byte to the route above;
* the decode kernel (``decode_nway``) on the packed payload, checked
  against the symbols, and the coder and decoder on 1, 4 and 12 streams
  (latency against issue);
* the ALC2 batch itself (``BatchFrameEncoder(90, "cdf53", n_lanes=4096,
  device_entropy=True)`` → ``BatchFrameDecoder(device_entropy=True)``):
  chunks/s over 3 batches (host clock, synchronized) and one roundtrip's
  device time by torch.profiler, split into K8, K9, the lifts, copies,
  histograms and the rest, with the number of scan and index kernels (the
  torch pack's) it ran.

The numbers are taken with ``chip_smoke.py``'s own helpers (``time_ms``,
``kernel_split``, ``device_profile``).  The last line is one JSON object
with every number.  Run from a checkout's root::

    python3 tools/rans_nway_profile.py [--repo DIR] [--label NAME]

Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from chip_smoke import (ALC2_CHUNKS, ALC2_LANES, H, QUALITY, T, W,  # noqa: E402
                        bound_ms, device_profile, kernel_split, time_ms)
from rans3_profile import sm_clock_mhz  # noqa: E402

REPS = 5
BATCHES = 3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", type=Path, default=ROOT,
                    help="checkout whose alice_codec_tpu_torch is timed")
    ap.add_argument("--label", default="", help="prefix of the printed lines")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("rans_nway_profile: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.repo.resolve()))
    from alice_codec_tpu_torch import FrequencyTable, _build
    from alice_codec_tpu_torch.ops.kernels import rans_nway
    from alice_codec_tpu_torch.ops.rans_device import pack_device
    from alice_codec_tpu_torch.parallel import BatchFrameDecoder, BatchFrameEncoder
    from bench import _test_chunk

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    with ThreadPoolExecutor(ALC2_CHUNKS) as pool:
        chunks = list(pool.map(lambda i: _test_chunk(T, H, W, seed=i),
                               range(ALC2_CHUNKS)))
    _build.build()
    dev = torch.device("cuda")
    lbl = args.label
    packed = hasattr(rans_nway, "encode_pack_nway")
    res = {"card": card, "label": lbl, "repo": str(args.repo.resolve()),
           "has_packed_route": packed}

    batch = torch.as_tensor(np.stack(chunks), device=dev)
    del chunks
    enc = BatchFrameEncoder(QUALITY, "cdf53", n_lanes=ALC2_LANES,
                            device_entropy=True)
    sym_b, hist_b = enc.encode_device_stage(batch)
    n_str = ALC2_CHUNKS * 3
    n = sym_b.shape[-1]
    steps = n // ALC2_LANES
    syms = sym_b.reshape(n_str, n)
    del sym_b
    tabs = [FrequencyTable.from_histogram(h, sanitize=True)
            for h in hist_b.reshape(n_str, 256).cpu().numpy().astype(np.uint32)]
    f = torch.as_tensor(np.stack([t.freqs for t in tabs]).astype(np.int32), device=dev)
    c = torch.as_tensor(np.stack([t.cums for t in tabs]).astype(np.int32), device=dev)
    lut = torch.as_tensor(np.stack([t.cum_to_sym for t in tabs]), device=dev)

    # the per-step kernel, the 12 packs, the concatenation
    enc8 = lambda: rans_nway.encode_nway(syms, f, c, n_lanes=ALC2_LANES)  # noqa: E731
    bytes2, counts, states = enc8()

    def packs():
        return [pack_device(bytes2[i], counts[i], states[i], n=n,
                            n_lanes=ALC2_LANES) for i in range(n_str)]

    parts = packs()
    totals = [int(t) for _, _, t in parts]

    def concat():
        return torch.cat([p[:t] for (p, _, _), t in zip(parts, totals)])

    payload = concat()
    lens = torch.stack([ln for _, ln, _ in parts])
    r = res["per_step_route"] = {
        "encode_nway_ms": time_ms(enc8, REPS),
        "packs_ms": time_ms(packs, 1),
        "concat_ms": time_ms(concat, 1),
        "payload_bytes": payload.numel()}
    del parts, bytes2, counts, states
    torch.cuda.empty_cache()

    def old_route():
        b2, cn, st = enc8()
        ps = [pack_device(b2[i], cn[i], st[i], n=n, n_lanes=ALC2_LANES)
              for i in range(n_str)]
        sizes = [int(t) for _, _, t in ps]
        return torch.cat([p[:t] for (p, _, _), t in zip(ps, sizes)])

    r["route_ms"] = time_ms(old_route, 1)
    r["route_split"] = kernel_split(old_route)
    r["bound_ms"] = bound_ms(n_str * n * (1 + 2 + 1) + n_str * ALC2_LANES * 8)
    print(f"{lbl} K8 per-step route on {n_str} streams of {ALC2_LANES} lanes x "
          f"{steps} steps ({payload.numel()} payload bytes): encode_nway "
          f"{r['encode_nway_ms']:.3f} ms (bound {r['bound_ms']:.3f}), 12 "
          f"pack_device {r['packs_ms']:.3f} ms, concatenation "
          f"{r['concat_ms']:.3f} ms; the route {r['route_ms']:.3f} ms [{card}]")
    print(f"{lbl}   route_split: " + ", ".join(
        f"{k[:60]} {v:.3f}" for k, v in r["route_split"].items()))

    ok = True
    if packed:
        route = lambda: rans_nway.encode_pack_nway(  # noqa: E731
            syms, f, c, n_lanes=ALC2_LANES)
        got, got_lens, got_totals = route()
        same = (bool(torch.equal(got, payload)) and bool(torch.equal(got_lens, lens))
                and got_totals.tolist() == totals)
        ok &= same
        del got, got_lens, got_totals
        slabs = rans_nway._encode_slabs_cuda(syms, f, c, ALC2_LANES)
        p = res["packed_route"] = {
            "bit_exact": same, "ms": time_ms(route, REPS),
            # the passes by CUDA events: the coder, then the compaction with
            # its lane-offset scan and size read
            "encode_slabs_ms": time_ms(
                lambda: rans_nway._encode_slabs_cuda(syms, f, c, ALC2_LANES), REPS),
            "compact_ms": time_ms(lambda: rans_nway._compact_cuda(*slabs), REPS),
            "split": kernel_split(route),
            "bound_ms": bound_ms(n_str * n + payload.numel() + n_str * ALC2_LANES * 4)}
        del slabs
        clock = sm_clock_mhz()
        p.update(sm_clock_mhz=clock, encode_cycles_per_step=(
            p["encode_slabs_ms"] * 1e-3 * clock * 1e6 / steps))
        print(f"{lbl} K8 packed route: equal to the per-step route {same}; "
              f"{p['ms']:.3f} ms = encode_slabs {p['encode_slabs_ms']:.3f} "
              f"({p['encode_cycles_per_step']:.0f} cycles a step at {clock:.0f} "
              f"MHz) + compaction {p['compact_ms']:.3f} (bound "
              f"{p['bound_ms']:.3f}) [{card}]")
        print(f"{lbl}   split: " + ", ".join(f"{k[:60]} {v:.3f}"
                                             for k, v in p["split"].items()))

    starts = torch.cumsum(lens.reshape(-1).long(), 0) - lens.reshape(-1).long()
    starts = starts.reshape(lens.shape)
    dec9 = lambda: rans_nway.decode_nway(  # noqa: E731
        payload, starts, lens, f, c, lut, steps=steps)
    exact9 = bool(torch.equal(dec9().reshape(n_str, n), syms))
    ok &= exact9
    clock = sm_clock_mhz()
    d = res["decode_nway"] = {
        "bit_exact": exact9, "ms": time_ms(dec9, REPS),
        "split": kernel_split(dec9),
        "bound_ms": bound_ms(payload.numel() + n_str * ALC2_LANES * 12 + n_str * n),
        "sm_clock_mhz": clock}
    d["cycles_per_step"] = d["ms"] * 1e-3 * clock * 1e6 / steps
    print(f"{lbl} K9 decode_nway: decodes to the symbols {exact9}; {d['ms']:.3f} "
          f"ms ({d['cycles_per_step']:.0f} cycles a step at {clock:.0f} MHz; "
          f"bound {d['bound_ms']:.3f}) [{card}]")
    print(f"{lbl}   split: " + ", ".join(f"{k[:60]} {v:.3f}"
                                         for k, v in d["split"].items()))
    # streams in flight: a chain bound by its own latency takes as long for
    # fewer streams (below a block an SM), one bound by the SMs' issue less
    sweep = res["streams_sweep"] = {}
    for k in (1, 4, n_str):
        sweep[k] = {"decode_ms": time_ms(lambda: rans_nway.decode_nway(
            payload, starts[:k], lens[:k], f[:k], c[:k], lut[:k], steps=steps), REPS)}
        if packed:
            sweep[k]["encode_slabs_ms"] = time_ms(
                lambda: rans_nway._encode_slabs_cuda(syms[:k], f[:k], c[:k], ALC2_LANES),
                REPS)
        print(f"{lbl}   {k} streams: " + ", ".join(
            f"{name} {ms:.3f} ms" for name, ms in sweep[k].items()))
    del syms, payload, lens, starts, f, c, lut
    torch.cuda.empty_cache()

    # the ALC2 batch, device entropy
    decb = BatchFrameDecoder(device_entropy=True)
    out = decb.decode(enc.encode(batch), as_numpy=False)  # warm-up
    del out
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_enc = t_dec = 0.0
    for _ in range(BATCHES):
        t0 = time.perf_counter()
        stream = enc.encode(batch)
        t1 = time.perf_counter()
        out = decb.decode(stream, as_numpy=False)
        torch.cuda.synchronize()
        t_enc += t1 - t0
        t_dec += time.perf_counter() - t1
        del out
    n_c = BATCHES * ALC2_CHUNKS
    wall_ms, rows = device_profile(
        lambda: decb.decode(enc.encode(batch), as_numpy=False),
        ("decode_nway",))
    busy = sum(ms for _, ms, _ in rows)
    parts_of = {"K8": ("encode_slabs", "compact_lanes", "encode_nway"),
                "K9": ("decode_nway",), "lifts": ("spatial_tiles", "temporal_"),
                "copies": ("Memcpy",), "histograms": ("Histogram",)}
    split = {k: sum(ms for key, ms, _ in rows if any(s in key for s in v))
             for k, v in parts_of.items()}
    split["other glue"] = busy - sum(split.values())
    a = res["alc2_batch"] = {
        "encode_chunks_per_s": n_c / t_enc, "decode_chunks_per_s": n_c / t_dec,
        "roundtrip_chunks_per_s": n_c / (t_enc + t_dec),
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "profiled_wall_ms": wall_ms, "device_ms": busy, "split": split,
        "scan_kernels": sum(cnt for key, _, cnt in rows if "scan" in key),
        "index_kernels": sum(cnt for key, _, cnt in rows if "index" in key),
        "top": [(key[:90], ms, cnt) for key, ms, cnt in rows[:12]]}
    print(f"{lbl} ALC2 batch ({ALC2_CHUNKS} x {T}x{H}x{W}): encode "
          f"{a['encode_chunks_per_s']:.4f}, decode {a['decode_chunks_per_s']:.4f}, "
          f"roundtrip {a['roundtrip_chunks_per_s']:.4f} chunks/s over {BATCHES} "
          f"batches (host clock); one roundtrip {busy:.3f} ms of device time "
          f"in {wall_ms:.3f} ms wall (profiled); peak {a['peak_gib']:.3f} GiB; "
          f"{a['scan_kernels']} scan and {a['index_kernels']} index kernel "
          f"launches [{card}]")
    print(f"{lbl}   device time by part: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in split.items()))
    for key, ms, cnt in a["top"]:
        print(f"{lbl}   {ms:9.3f} ms  x{cnt:<3d} {key}")
    print(json.dumps(res))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
