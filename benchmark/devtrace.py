"""Device profile of a few roundtrips, read from torch.profiler's trace.

:func:`profile_roundtrips` runs a callable under torch.profiler (CPU and
CUDA activities), exports the Chrome trace to a temporary file and reads
it back:

* device intervals: every kernel, copy and memset record on the card;
* the port's own kernels, told from PyTorch's by the names of the
  ``__global__`` functions in the port's ``csrc/*.cu``;
* the host spans the benchmark opened (``record_function``: ``pool``,
  ``encode``, ``decode``, ``sync``), which bound the window and name the
  idle gaps.

The profiler has been seen to leave kernels out of its record (the first
kernel of a session; both of K1's kernels in some runs), so a short spin
kernel opens each session, and a profile is complete only when every
kernel launch the runtime recorded has its device record and the port's
kernel records are at least as many as its wrappers counted launches
(``ops.kernels.launch_counts``).  An incomplete profile is taken again, up
to ``tries`` times; the last one is returned with ``complete`` false, and
the readers then report no kernel number.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from dataclasses import dataclass, field
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPANS = ("pool", "encode", "decode", "sync")
_GLOBAL = re.compile(
    r"__global__\s+(?:void\s+)?(?:__launch_bounds__\s*\([^)]*\)\s*)?(?:void\s+)?(\w+)\s*\(")


def csrc_kernels(csrc: Path) -> frozenset[str]:
    """Names of the ``__global__`` functions in ``csrc/*.cu``."""
    names = set()
    for src in sorted(Path(csrc).glob("*.cu")):
        names.update(_GLOBAL.findall(src.read_text()))
    return frozenset(names)


def base_name(kernel: str) -> str:
    """A demangled kernel name without its return type, template and
    argument lists; keeps a namespace other than an anonymous one."""
    name = kernel.replace("(anonymous namespace)::", "")
    name = name.removeprefix("void ").strip()
    return re.split(r"[<(]", name, maxsplit=1)[0].strip()


@dataclass
class Profile:
    complete: bool
    chunks: int
    window_s: float
    busy_s: float
    csrc_s: float
    glue_s: float
    launches: dict
    chunk_work: list
    ours: dict = field(default_factory=dict)   # the port's kernel records by name
    runtime_launches: int = 0                  # kernel launches the runtime recorded
    ops: list = field(default_factory=list)    # [(name, seconds)] by time
    gaps: list = field(default_factory=list)   # [(host span, seconds)]
    missing: list = field(default_factory=list)


def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def read_trace(events: list, csrc: frozenset, launches: dict, chunks: int,
               chunk_work: list, top: int = 10) -> Profile:
    """Reduce a Chrome trace's events (times in µs) to a :class:`Profile`."""
    spans = [e for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation" and e.get("name") in SPANS]
    if not spans:
        raise ValueError("the trace holds none of the benchmark's host spans")
    w0 = min(float(e["ts"]) for e in spans)
    w1 = max(float(e["ts"]) + float(e.get("dur", 0)) for e in spans)
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
           and w0 <= float(e["ts"]) < w1 and "spin_kernel" not in e.get("name", "")]
    ours = [e for e in dev if e.get("cat") == "kernel"
            and base_name(e.get("name", "")) in csrc]
    csrc_us = sum(float(e.get("dur", 0)) for e in ours)
    glue_us = sum(float(e.get("dur", 0)) for e in dev) - csrc_us
    merged = _union([(max(float(e["ts"]), w0),
                      min(float(e["ts"]) + float(e.get("dur", 0)), w1)) for e in dev])
    busy_us = sum(b - a for a, b in merged)
    # completeness: every runtime kernel launch has its device record, and
    # the port's kernels are at least as many as its wrappers' launches
    have = {e.get("args", {}).get("correlation") for e in dev}
    runtime = [e for e in events if e.get("ph") == "X"
               and e.get("cat") in ("cuda_runtime", "cuda_driver")
               and "LaunchKernel" in e.get("name", "") and w0 <= float(e["ts"]) < w1]
    missing = [e["name"] for e in runtime
               if e.get("args", {}).get("correlation") not in have]
    n_launch = sum(launches.values())
    if len(ours) < n_launch:
        missing.append(f"{n_launch - len(ours)} of the port's kernel records")
    by_name: dict[str, float] = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e.get("dur", 0))
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = []
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps.append((_span_at(spans, a), (b - a) / 1e6))
    gaps.sort(key=lambda g: -g[1])
    counts: dict[str, int] = {}
    for e in ours:
        counts[base_name(e["name"])] = counts.get(base_name(e["name"]), 0) + 1
    return Profile(not missing, chunks, (w1 - w0) / 1e6, busy_us / 1e6,
                   csrc_us / 1e6, glue_us / 1e6, dict(launches), list(chunk_work),
                   counts, len(runtime), [(n, us / 1e6) for n, us in ops], gaps[:top],
                   missing)


def _span_at(spans, t: float) -> str:
    """The innermost benchmark span open at ``t`` (µs)."""
    best = None
    for e in spans:
        a = float(e["ts"])
        b = a + float(e.get("dur", 0))
        if a <= t < b and (best is None or a >= float(best["ts"])):
            best = e
    return best["name"] if best is not None else "outside"


def profile_roundtrips(fn, *, csrc: frozenset, tries: int = 4) -> Profile:
    """Profile ``fn()`` (which runs roundtrips inside the benchmark's host
    spans and returns ``(chunks, [ChunkWork])``) until complete, or
    ``tries`` times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from alice_codec_tpu_torch.ops.kernels import launch_counts, reset_launches

    prof_out = None
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            reset_launches()
            chunks, work = fn()
            torch.cuda.synchronize()
            launches = launch_counts()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        prof_out = read_trace(events, csrc, launches, chunks, work)
        if prof_out.complete:
            break
    return prof_out
