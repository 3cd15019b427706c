"""Rate control: leaky-bucket buffer model (reference: src/rate_control.rs).

A copy of ``alice_codec_tpu/rate_control.py`` (host Python, no JAX), kept
here so the port never imports the JAX package.

Pure-host controller: it consumes per-chunk compressed sizes from the device
pipeline and feeds the next chunk's quality setting (BASELINE config 5).
All arithmetic mirrors the reference exactly.
"""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["RateControlConfig", "RateController", "estimate_quality"]


@dataclass
class RateControlConfig:
    """Configuration (reference src/rate_control.rs:8-31)."""

    target_bitrate_kbps: int = 5_000
    framerate: float = 30.0
    min_quality: int = 10
    max_quality: int = 95
    buffer_size_bits: int = 5_000 * 1_000 * 2  # 2 seconds


@dataclass
class RateController:
    """Leaky-bucket rate controller (reference src/rate_control.rs:35-175).

    Buffer starts half full; each ``update`` adds (target − actual) bits
    clamped to ±buffer; quality moves +1 when the ratio > 0.3 and −2 when
    < −0.3.
    """

    config: RateControlConfig = field(default_factory=RateControlConfig)

    def __post_init__(self) -> None:
        self._buffer_fullness = self.config.buffer_size_bits // 2
        self._frame_history: list[int] = []
        self._max_history = 30
        self._current_quality = (self.config.min_quality + self.config.max_quality) // 2
        self._frame_count = 0

    @classmethod
    def with_defaults(cls) -> "RateController":
        return cls(RateControlConfig())

    def target_bits_per_frame(self) -> int:
        if self.config.framerate <= 0.0:
            return 0
        return int(self.config.target_bitrate_kbps * 1000.0 / self.config.framerate)

    @property
    def recommended_quality(self) -> int:
        return self._current_quality

    def update(self, frame_size_bits: int) -> None:
        target = self.target_bits_per_frame()
        self._buffer_fullness += target - int(frame_size_bits)
        cap = self.config.buffer_size_bits
        self._buffer_fullness = max(-cap, min(self._buffer_fullness, cap))
        self._frame_history.append(int(frame_size_bits))
        if len(self._frame_history) > self._max_history:
            self._frame_history.pop(0)
        self._frame_count += 1
        self._adjust_quality()

    def _adjust_quality(self) -> None:
        ratio = self.buffer_ratio()
        if ratio > 0.3:
            adjustment = 1
        elif ratio < -0.3:
            adjustment = -2
        else:
            adjustment = 0
        self._current_quality = max(
            self.config.min_quality,
            min(self._current_quality + adjustment, self.config.max_quality),
        )

    def buffer_ratio(self) -> float:
        if self.config.buffer_size_bits == 0:
            return 0.0
        return self._buffer_fullness / self.config.buffer_size_bits

    def average_frame_size(self) -> int:
        if not self._frame_history:
            return 0
        return sum(self._frame_history) // len(self._frame_history)

    @property
    def frame_count(self) -> int:
        return self._frame_count

    @property
    def current_quality(self) -> int:
        return self._current_quality

    def actual_to_target_ratio(self) -> float:
        target = self.target_bits_per_frame()
        if target == 0:
            return 0.0
        return self.average_frame_size() / target


def estimate_quality(target_bitrate_kbps: int, width: int, height: int, fps: float) -> int:
    """Static bpp→quality estimate (reference src/rate_control.rs:183-203)."""
    if fps <= 0.0 or width == 0 or height == 0:
        return 50
    pixels_per_sec = float(width) * float(height) * fps
    bpp = target_bitrate_kbps * 1000.0 / pixels_per_sec
    if bpp > 2.0:
        quality = 95.0
    elif bpp > 0.5:
        quality = bpp * 30.0 + 35.0
    elif bpp > 0.1:
        quality = bpp * 75.0 + 12.5
    else:
        quality = bpp * 100.0 + 5.0
    return max(5, min(int(quality), 100))
