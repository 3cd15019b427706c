"""The benchmark's harness: finds a cell's parts by name, drives the
port through the cell's window and reports the contract's result line.

Everything that belongs to one configuration, one traffic mix or one
metric is a file of its own, found by the name ``BENCHMARK.json`` gives:

* a configuration: ``configs[i].file`` (a JSON file of the chunk geometry,
  the keyword arguments of the codec the harness drives, ALC3's
  ``Alc3Codec``, the decode's, and the name of its plain reference, a
  module of ``benchmark/reference/``);
* a traffic mix: ``benchmark/traffic/<traffic>.json`` (the pool, the loop,
  the profiled roundtrips, and the content parameters its ``generator``
  module in the same folder reads);
* a metric: ``benchmark/metrics/<name>.py``, whose ``read(ctx)`` returns
  the number or None (nothing to read: the metric is left out).

A key the harness does not read is refused (:data:`CONFIG_KEYS`,
:data:`TRAFFIC_KEYS`; the generator refuses content keys it does not
know), so no file can seem to set what the run ignores.  Another codec
than ALC3 (the ALC2 batch, the ``.alc`` wire) needs a driver here.

A run: set-up (import, the kernels, the pool made on the device from the
seed, one warm roundtrip of every pool chunk), then a closed loop of one
client for ``seconds``: encode the next pool chunk (or the pool as one
batch) and decode it, synchronized.  With ``trace`` the loop also
synchronizes between encode and decode (for ``encode_ms`` /
``decode_ms``), and a few more roundtrips run under torch.profiler.
Afterwards one roundtrip of each pool chunk (of the batch), drawn from
the seed over the whole window, is judged (:mod:`checks`).
"""

from __future__ import annotations

import importlib.util
import json
import random
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from types import SimpleNamespace

import checks

#: top-level module names the process may not hold once the window has
#: closed: JAX, its libraries, the JAX package and its benchmark scripts
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "alice_codec_tpu", "bench", "benches"})

#: the keys a configuration file may hold: those the harness reads, and
#: free text that documents the deployment
CONFIG_KEYS = frozenset({"chunk", "codec", "decode", "reference", "lossless", "name",
                         "source", "deployment", "precision", "guarantees", "assumed"})
#: the keys a traffic mix may hold
TRAFFIC_KEYS = frozenset({"generator", "pool", "loop", "profile_roundtrips", "content"})
LOOPS = ("chunk", "batch")


class CellError(ValueError):
    """A cell, configuration, traffic mix or metric that cannot be found
    or read."""


class ForbiddenModules(RuntimeError):
    """The process holds a module it may not (:data:`FORBIDDEN`)."""

    def __init__(self, found):
        super().__init__(f"forbidden modules loaded: {found}")
        self.found = found


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list
    per_layer: list
    root: Path


def forbidden_modules(modules) -> list[str]:
    """The forbidden top-level names among ``modules`` (module names,
    compared by the part before the first dot, whole)."""
    return sorted({m.split(".", 1)[0] for m in modules} & FORBIDDEN)


def _load_json(path: Path, what: str) -> dict:
    try:
        return json.loads(path.read_text())
    except FileNotFoundError:
        raise CellError(f"{what}: {path} not found") from None


def _metrics_of(entries: list, cell: str, e2e_of_cell: set | None) -> list:
    out = []
    for m in entries:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif e2e_of_cell is None or m.get("moves") in e2e_of_cell:
            out.append(m)
    return out


def load_cell(root: Path, name: str) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its parts."""
    root = Path(root)
    bench = _load_json(root / "BENCHMARK.json", "the benchmark")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise CellError(f"no workload named {name!r} in BENCHMARK.json")
    cfg_entry = next((c for c in bench["configs"] if c["name"] == entry["config"]), None)
    if cfg_entry is None:
        raise CellError(f"workload {name!r} names no known config {entry['config']!r}")
    config = _load_json(root / cfg_entry["file"], f"config {entry['config']}")
    traffic = _load_json(root / "benchmark" / "traffic" / f"{entry['traffic']}.json",
                         f"traffic {entry['traffic']}")
    _only(config, CONFIG_KEYS, f"config {entry['config']}")
    _only(config["decode"], {"exact"}, f"config {entry['config']} decode")
    _only(config["chunk"], {"frames", "height", "width"}, f"config {entry['config']} chunk")
    _only(traffic, TRAFFIC_KEYS, f"traffic {entry['traffic']}")
    if traffic["loop"] not in LOOPS:
        raise CellError(f"traffic {entry['traffic']}: unknown loop {traffic['loop']!r}")
    e2e = _metrics_of(bench["end_to_end"], name, None)
    layer = _metrics_of(bench["per_layer"], name, {m["name"] for m in e2e})
    return Cell(name, config, traffic, int(entry["chips"]), e2e, layer, root)


def _only(d: dict, keys, what: str) -> None:
    unknown = sorted(set(d) - set(keys))
    if unknown:
        raise CellError(f"{what}: keys the harness does not read: {unknown}")


def load_module(path: Path, name: str):
    """Import the Python file ``path`` as module ``name``."""
    if not path.is_file():
        raise CellError(f"{path} not found")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(root: Path, metric: str):
    """The ``read(ctx)`` of metric ``metric``."""
    mod = load_module(Path(root) / "benchmark" / "metrics" / f"{metric}.py",
                      f"_metric_{metric.replace('.', '_').replace('-', '_')}")
    return mod.read


def generator(root: Path, traffic: dict):
    name = traffic["generator"]
    return load_module(Path(root) / "benchmark" / "traffic" / f"{name}.py",
                       f"_traffic_{name}")


# ── the device ──────────────────────────────────────────────────


class Device:
    """Synchronization and memory readings of the run's device (CPU runs,
    as the tests make them, read no memory)."""

    def __init__(self, device: str):
        import torch

        self.torch = torch
        self.name = device
        self.cuda = device.startswith("cuda")

    def sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize()

    def reset_peak(self) -> None:
        if self.cuda:
            self.torch.cuda.reset_peak_memory_stats()

    def peak(self) -> int | None:
        return int(self.torch.cuda.max_memory_allocated()) if self.cuda else None


def _storage_bytes(tensors, seen: set) -> int:
    n = 0
    for t in tensors:
        st = t.untyped_storage()
        if st.data_ptr() not in seen:
            seen.add(st.data_ptr())
            n += st.nbytes()
    return n


class Keeper:
    """Keeps one roundtrip's outputs for each slot of the loop (each pool
    chunk in the chunk loop, the one batch in the batch loop), drawn
    uniformly from every roundtrip of that slot in the window: a
    reservoir of one, whose draws come from the seed.  The n-th
    roundtrip of a slot replaces the kept one with chance 1/n, so the
    draws reach the window's end and every pool chunk is judged.

    It also reads the window's peak memory without the kept outputs: at
    each keep the peak so far, less the bytes kept until then, is noted
    and the peak reset."""

    def __init__(self, dev: Device, seed: int, slots: int):
        self.dev = dev
        self.rng = random.Random(int(seed))
        self.slots = slots
        self.offered = [0] * slots
        self.entries: list = [None] * slots   # (roundtrip, triples, bytes)
        self.bytes = 0
        self.peaks: list[int] = []

    def offer(self, i: int, inputs, chunks, decoded) -> None:
        """Offer roundtrip ``i``'s (input, chunk, frames) triples
        (``decoded``: the frames of each chunk)."""
        s = i % self.slots
        self.offered[s] += 1
        if self.rng.random() * self.offered[s] >= 1.0:
            return
        peak = self.dev.peak()
        if peak is not None:
            self.peaks.append(peak - self.bytes)
        tensors = list(decoded) + [t for c in chunks for t in (c.streams, c.counts, c.hists)]
        n = _storage_bytes(tensors, set())
        old = self.entries[s]
        self.bytes += n - (old[2] if old is not None else 0)
        self.entries[s] = (i, list(zip(inputs, chunks, decoded)), n)
        self.dev.reset_peak()

    @property
    def kept(self) -> list:
        """The kept (input, chunk, frames) triples, slot by slot."""
        return [t for e in self.entries if e is not None for t in e[1]]

    @property
    def roundtrips(self) -> list[int]:
        return [e[0] for e in self.entries if e is not None]

    def peak(self) -> int | None:
        last = self.dev.peak()
        if last is None:
            return None
        return max(self.peaks + [last - self.bytes])


# ── the run ─────────────────────────────────────────────────────


def _summary(chunk) -> SimpleNamespace:
    """What :func:`_work` needs of a coded chunk, read without a device
    synchronization (its counts stay a tensor)."""
    return SimpleNamespace(width=chunk.width, height=chunk.height, frames=chunk.frames,
                           s_seg=chunk.s_seg, n_streams=int(chunk.streams.shape[0]),
                           counts=chunk.counts, kcaps=tuple(chunk.kcaps),
                           sparse=chunk.sparse, deep=chunk.deep)


def _work(c: SimpleNamespace):
    """A chunk summary's :class:`roofline.ChunkWork` (reads its counts)."""
    import torch

    from reference.alc3_plain import padded_dims, segment_geometry, sparse_pp
    from roofline import ChunkWork

    pw, ph, pf = padded_dims(c.width, c.height, c.frames)
    p = pw * ph * pf
    pp = sparse_pp(p)
    dense = segment_geometry(pp, c.s_seg)[1]
    lifted = sum(1 for k in c.kcaps[:3] if k > 0) if c.sparse and not c.deep else 3
    return ChunkWork(p=p, pp=pp, s_seg=c.s_seg, n_streams=c.n_streams,
                     words=int(c.counts.to(torch.int64).sum().item()),
                     channels=lifted or 1,
                     sparse_planes=sum(1 for k in c.kcaps if 0 < k < dense))


class Loop:
    """One client's closed loop over the pool: a roundtrip is one chunk's
    (or, in the batch loop, the whole pool's) encode and decode."""

    def __init__(self, cell: Cell, codec, pool, dev: Device, batch=None):
        self.codec = codec
        self.pool = pool
        self.dev = dev
        self.batch = batch
        self.exact = bool(cell.config["decode"]["exact"])

    def inputs(self, i: int):
        return list(self.pool) if self.batch is not None else [self.pool[i % len(self.pool)]]

    def encode(self, i: int):
        if self.batch is not None:
            return self.codec.encode_batch(self.batch)
        return [self.codec.encode(self.pool[i % len(self.pool)])]

    def decode(self, chunks):
        if self.batch is not None:
            return self.codec.decode_batch(chunks, exact=self.exact)
        return self.codec.decode(chunks[0], exact=self.exact)

    def frames(self, out) -> list:
        """The decoded frames of each chunk of a roundtrip."""
        return list(out.unbind(0)) if self.batch is not None else [out]

    def roundtrip(self, i: int):
        chunks = self.encode(i)
        out = self.decode(chunks)
        self.dev.sync()
        return chunks, out


def window(loop: Loop, seconds: float, keeper: Keeper, *, split: bool):
    """The measured closed loop → dict of the counts and host times."""
    now = time.perf_counter
    lat, enc, dec, ends = [], [], [], []
    i = 0
    t0 = now()
    while True:
        ta = now()
        if split:
            chunks = loop.encode(i)
            loop.dev.sync()
            tm = now()
            out = loop.decode(chunks)
            loop.dev.sync()
            tb = now()
            enc.append(tm - ta)
            dec.append(tb - tm)
        else:
            chunks, out = loop.roundtrip(i)
            tb = now()
        lat.extend([tb - ta] * len(chunks))
        ends.append(tb - t0)
        keeper.offer(i, loop.inputs(i), chunks, loop.frames(out))
        del chunks, out
        i += 1
        if tb - t0 >= seconds:
            break
    return {"roundtrips": i, "chunks": len(lat), "elapsed_s": tb - t0,
            "latencies_s": lat, "encode_s": enc, "decode_s": dec, "ends_s": ends}


def slice_rates(ends_s: list, per: int, elapsed_s: float, width_s: float = 5.0) -> list:
    """Chunks a second in each ``width_s`` slice of the window (the last
    slice as long as it is), from the roundtrips' end times."""
    n = max(1, round(elapsed_s / width_s))
    width = elapsed_s / n
    counts = [0] * n
    for t in ends_s:
        counts[min(int(t / width), n - 1)] += per
    return [c / width for c in counts]


def profiled(loop: Loop, roundtrips: int):
    """A callable for :func:`devtrace.profile_roundtrips`: ``roundtrips``
    roundtrips inside the benchmark's host spans."""
    from torch.profiler import record_function

    def run():
        work = []
        chunks_done = 0
        for i in range(roundtrips):
            with record_function("pool"):
                inputs = loop.inputs(i)
            with record_function("encode"):
                chunks = loop.encode(i)
            with record_function("decode"):
                out = loop.decode(chunks)
            with record_function("sync"):
                loop.dev.sync()
            chunks_done += len(inputs)
            work += [_summary(c) for c in chunks]
            del chunks, out
        return chunks_done, work

    return run


def run_cell(cell: Cell, *, seed: int, seconds: float, trace: bool, device: str,
             t_start: float, log=print, after_window=None) -> dict:
    """Set up, run and judge one cell; returns the result (its keys in the
    contract's order, ``checks`` last).  ``after_window``: called once the
    window has closed (the card's description, kept out of the set-up)."""
    import torch

    from alice_codec_tpu_torch import Alc3Codec
    from alice_codec_tpu_torch.ops.kernels import launch_counts, reset_launches

    stamps = [("imports", time.perf_counter())]
    dev = Device(device)
    cfg = cell.config
    geo = cfg["chunk"]
    codec = Alc3Codec(**cfg["codec"], device=device)
    gen = generator(cell.root, cell.traffic)
    pool = gen.make_pool(cell.traffic["content"], int(cell.traffic["pool"]), seed,
                         geo["frames"], geo["height"], geo["width"], device)
    batch = None
    if cell.traffic["loop"] == "batch":
        batch = torch.stack(pool)
        pool = list(batch.unbind(0))
    loop = Loop(cell, codec, pool, dev, batch)
    dev.sync()
    stamps.append(("card context and pool", time.perf_counter()))
    # warm-up: every pool chunk once, as a stream would bring them
    for i in range(len(pool) if batch is None else 1):
        loop.roundtrip(i)
        if i == 0:
            stamps.append(("first roundtrip (kernels loaded or built)", time.perf_counter()))
    keeper = Keeper(dev, seed, len(pool) if batch is None else 1)
    reset_launches()
    dev.sync()
    dev.reset_peak()
    setup_s = time.perf_counter() - t_start
    stamps.append(("rest of the warm-up", t_start + setup_s))
    win = window(loop, seconds, keeper, split=trace)
    if after_window is not None:
        after_window()
    prev = t_start
    parts = []
    for what, t in stamps:
        parts.append(f"{what} {t - prev:.3f} s")
        prev = t
    log(f"set-up {setup_s:.3f} s: " + ", ".join(parts))
    launches = launch_counts()
    peak = keeper.peak()
    # a run's slices keep their level while runs differ: the spread of a
    # rate across runs is the host's speed in each process
    rates = slice_rates(win["ends_s"], win["chunks"] // win["roundtrips"], win["elapsed_s"])
    log(f"window {win['elapsed_s']:.3f} s, {win['roundtrips']} roundtrips; chunks/s a "
        f"5 s slice {[round(r, 2) for r in rates]}")
    log("launches over the window: "
        + json.dumps({k: v for k, v in launches.items() if v}))
    prof = None
    if trace and dev.cuda:
        import devtrace

        csrc = devtrace.csrc_kernels(Path(sys.modules["alice_codec_tpu_torch"].__file__)
                                     .parent / "csrc")
        run = profiled(loop, int(cell.traffic["profile_roundtrips"]))
        prof = devtrace.profile_roundtrips(run, csrc=csrc)
        prof.chunk_work = [_work(c) for c in prof.chunk_work]
        log(f"profile of {prof.chunks} chunks: complete={prof.complete}, "
            f"{prof.runtime_launches} runtime kernel launches, the port's kernel "
            f"records {json.dumps(prof.ours)}, its launches "
            f"{json.dumps({k: v for k, v in prof.launches.items() if v})}")
        if not prof.complete:
            log(f"profile incomplete after retries: {prof.missing[:8]}")
    del loop, codec
    if dev.cuda:
        torch.cuda.empty_cache()
    t_judge = time.perf_counter()
    numbers, failed = checks.judge(keeper.kept, cfg)
    log(f"judged {len(keeper.kept)} sampled chunks (roundtrips {keeper.roundtrips} of "
        f"{win['roundtrips']}) in {time.perf_counter() - t_judge:.3f} s")
    ctx = {"trace": trace, "setup_s": setup_s, "peak_bytes": peak, "profile": prof,
           "batch": len(pool) if batch is not None else 1, **win}
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = reader(cell.root, m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": checks.passed(numbers), "attempted": win["chunks"],
              "failed": failed, "metrics": metrics, "device": device_info(dev, peak, prof)}
    if prof is not None:
        result["breakdown"] = {
            "device_ops": [[n[:160], s] for n, s in prof.ops[:10]],
            "idle_gaps": [[n, s] for n, s in prof.gaps[:10]]}
    result["checks"] = {n: {"value": v, "limit": checks.LIMITS[n]} for n, v in numbers.items()}
    found = forbidden_modules(sys.modules)
    if found:
        raise ForbiddenModules(found)
    return result


def device_info(dev: Device, peak, prof) -> dict:
    import torch

    if dev.cuda:
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
                "memory_peak_bytes": peak}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}
    if prof is not None:
        info["busy_s"] = prof.busy_s
        info["window_s"] = prof.window_s
    return info


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (linear interpolation between order
    statistics, numpy's default)."""
    xs = sorted(values)
    if len(xs) == 1:
        return xs[0]
    k = (len(xs) - 1) * q / 100.0
    lo = int(k)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (k - lo)
