"""Per-stage timing and profiling hooks (PyTorch port of
``alice_codec_tpu/profiling.py``).

* :class:`StageTimer` — wall-clock stage accounting (host clock), a copy
  of the JAX package's, that feeds
  :class:`~alice_codec_tpu_torch.bridges.db.CodecMetrics` records; time
  device work with the device synchronized inside the stage, since CUDA
  launches return before the card is done.  Beside the JAX package's
  totals it keeps each stage's newest per-call times (``samples``, so a
  reader can take a median that leaves the warm-up out) and named
  per-call counts (:meth:`StageTimer.tally`);
* :func:`trace` — context manager around ``torch.profiler`` that writes a
  Chrome trace (``trace.json``, viewable in chrome://tracing or Perfetto)
  into ``log_dir``, where the JAX package drives ``jax.profiler``.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from collections import defaultdict, deque
from dataclasses import dataclass, field

import torch
from torch.profiler import ProfilerActivity, profile

#: per-call samples a :class:`StageTimer` keeps of each name (the newest)
SAMPLES = 1024


@dataclass
class StageTimer:
    """Accumulates wall-clock time per named pipeline stage.

    >>> timer = StageTimer()
    >>> with timer.stage("encode"):
    ...     pass
    >>> "encode" in timer.totals
    True
    """

    totals: dict = field(default_factory=lambda: defaultdict(float))
    counts: dict = field(default_factory=lambda: defaultdict(int))
    #: name → the newest :data:`SAMPLES` per-call values: a stage's
    #: seconds, or what :meth:`tally` recorded
    samples: dict = field(
        default_factory=lambda: defaultdict(lambda: deque(maxlen=SAMPLES)))
    #: name → the running sum of :meth:`tally`
    counters: dict = field(default_factory=lambda: defaultdict(int))

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1
            self.samples[name].append(dt)

    def tally(self, name: str, n: int) -> None:
        """Record one call's count ``n`` of ``name`` (reads, bytes)."""
        self.counters[name] += n
        self.samples[name].append(n)

    def average_us(self, name: str) -> float:
        """Mean stage time in microseconds (CodecMetrics.encode_time_us units)."""
        n = self.counts.get(name, 0)
        return 0.0 if n == 0 else self.totals[name] / n * 1e6

    def as_metrics(self, name: str, *, timestamp_ms: int, bitrate_bps: float = 0.0,
                   psnr_db: float = 0.0):
        """Build a CodecMetrics record for the DB bridge sink."""
        from .bridges.db import CodecMetrics

        return CodecMetrics(
            timestamp_ms=timestamp_ms,
            bitrate_bps=bitrate_bps,
            psnr_db=psnr_db,
            encode_time_us=self.average_us(name),
        )

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals):
            lines.append(
                f"{name:24s} {self.totals[name]*1e3:10.2f} ms total"
                f"  ({self.counts[name]} calls, {self.average_us(name):10.1f} µs avg)"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Profile the block with ``torch.profiler`` (CPU, and CUDA where a
    card is present) and write its Chrome trace to ``log_dir/trace.json``
    (default: ``alc_trace`` in the temporary directory).  Yields
    ``log_dir``."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "alc_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
