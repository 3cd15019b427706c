"""DB bridge: time-series sink for codec metrics (reference: src/db_bridge.rs;
a copy of the JAX package's ``bridges/db.py``, whose `.tsdb` logs either
package reads).

The reference stores per-frame metrics (bitrate, PSNR, encode time) in three
ALICE-DB instances.  Here each dimension is a lightweight append-only
time-series store (in-memory index + binary log file) with the same
query/aggregate/downsample API.
"""

from __future__ import annotations

import bisect
import enum
import struct
from dataclasses import dataclass
from pathlib import Path

__all__ = ["FrameType", "CodecMetrics", "Aggregation", "TimeSeriesDB", "CodecMetricsSink"]


class FrameType(enum.IntEnum):
    """Frame type indicator (reference src/db_bridge.rs:28-33)."""

    INTRA = 0
    PREDICTED = 1


@dataclass
class CodecMetrics:
    """Per-frame/chunk metrics record (reference src/db_bridge.rs:37-48)."""

    timestamp_ms: int
    bitrate_bps: float
    psnr_db: float
    encode_time_us: float
    frame_type: FrameType = FrameType.INTRA


class Aggregation(enum.Enum):
    AVG = "avg"
    MIN = "min"
    MAX = "max"
    SUM = "sum"
    COUNT = "count"


_REC = struct.Struct("<qf")  # timestamp i64, value f32


class TimeSeriesDB:
    """Append-only (timestamp, f32) store with range scans and aggregation.

    Stand-in for the external AliceDB (absent sibling crate); durable via a
    binary log file, ordered queries via an in-memory sorted index.
    """

    def __init__(self, path: str | Path):
        self._path = Path(path)
        self._path.parent.mkdir(parents=True, exist_ok=True)
        self._ts: list[int] = []
        self._vals: list[float] = []
        if self._path.exists():
            raw = self._path.read_bytes()
            usable = len(raw) - len(raw) % _REC.size
            for off in range(0, usable, _REC.size):
                t, v = _REC.unpack_from(raw, off)
                self._insert(t, v)
        self._fh = open(self._path, "ab")

    def _insert(self, t: int, v: float) -> None:
        idx = bisect.bisect_right(self._ts, t)
        self._ts.insert(idx, t)
        self._vals.insert(idx, v)

    def put(self, timestamp: int, value: float) -> None:
        self._insert(int(timestamp), float(value))
        self._fh.write(_REC.pack(int(timestamp), float(value)))

    def put_batch(self, records) -> None:
        for t, v in records:
            self.put(t, v)

    def scan(self, start: int, end: int) -> list[tuple[int, float]]:
        lo = bisect.bisect_left(self._ts, start)
        hi = bisect.bisect_right(self._ts, end)
        return list(zip(self._ts[lo:hi], self._vals[lo:hi]))

    def aggregate(self, start: int, end: int, agg: Aggregation) -> float:
        vals = [v for _, v in self.scan(start, end)]
        if not vals:
            return 0.0
        if agg is Aggregation.AVG:
            return sum(vals) / len(vals)
        if agg is Aggregation.MIN:
            return min(vals)
        if agg is Aggregation.MAX:
            return max(vals)
        if agg is Aggregation.SUM:
            return sum(vals)
        return float(len(vals))

    def downsample(
        self, start: int, end: int, interval_ms: int, agg: Aggregation
    ) -> list[tuple[int, float]]:
        out = []
        t = start
        while t <= end:
            bucket_end = min(t + interval_ms - 1, end)
            if self.scan(t, bucket_end):
                out.append((t, self.aggregate(t, bucket_end, agg)))
            t += interval_ms
        return out

    def flush(self) -> None:
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()


class CodecMetricsSink:
    """Persistent sink for codec metrics (reference src/db_bridge.rs:54-214)."""

    def __init__(self, dirpath: str | Path):
        d = Path(dirpath)
        d.mkdir(parents=True, exist_ok=True)
        self._bitrate = TimeSeriesDB(d / "bitrate.tsdb")
        self._psnr = TimeSeriesDB(d / "psnr.tsdb")
        self._encode_time = TimeSeriesDB(d / "encode_time.tsdb")

    @classmethod
    def open(cls, dirpath: str | Path) -> "CodecMetricsSink":
        return cls(dirpath)

    def record(self, m: CodecMetrics) -> None:
        self._bitrate.put(m.timestamp_ms, m.bitrate_bps)
        self._psnr.put(m.timestamp_ms, m.psnr_db)
        self._encode_time.put(m.timestamp_ms, m.encode_time_us)

    def record_batch(self, metrics) -> None:
        for m in metrics:
            self.record(m)

    def query_bitrate(self, start: int, end: int):
        return self._bitrate.scan(start, end)

    def query_psnr(self, start: int, end: int):
        return self._psnr.scan(start, end)

    def query_encode_time(self, start: int, end: int):
        return self._encode_time.scan(start, end)

    def average_bitrate(self, start: int, end: int) -> float:
        return self._bitrate.aggregate(start, end, Aggregation.AVG)

    def average_psnr(self, start: int, end: int) -> float:
        return self._psnr.aggregate(start, end, Aggregation.AVG)

    def max_encode_time(self, start: int, end: int) -> float:
        return self._encode_time.aggregate(start, end, Aggregation.MAX)

    def downsample_bitrate(self, start: int, end: int, interval_ms: int):
        return self._bitrate.downsample(start, end, interval_ms, Aggregation.AVG)

    def downsample_psnr(self, start: int, end: int, interval_ms: int):
        return self._psnr.downsample(start, end, interval_ms, Aggregation.AVG)

    def flush(self) -> None:
        self._bitrate.flush()
        self._psnr.flush()
        self._encode_time.flush()
