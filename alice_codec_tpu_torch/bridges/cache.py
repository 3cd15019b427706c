"""Cache bridge: LRU cache for decoded frames (reference: src/cache_bridge.rs;
the port of the JAX package's ``bridges/cache.py``).

Avoids redundant inverse-wavelet decodes during scrubbing/looping/seeking.
Keyed by (chunk, frame, quality) exactly like the reference.

A frame is stored where it lies: a tensor as given (detached, on its own
device — a decoded frame on the card stays on the card, with no copy to
the host), anything else as a NumPy array.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["CachedFrame", "FrameKey", "FrameCache"]


@dataclass
class CachedFrame:
    """Cached decoded frame (reference src/cache_bridge.rs:9-17): ``data``
    is a tensor on the device it was put from, or a NumPy array."""

    data: torch.Tensor | np.ndarray
    width: int
    height: int


@dataclass(frozen=True)
class FrameKey:
    """(chunk, frame, quality) key (reference src/cache_bridge.rs:20-28)."""

    chunk: int
    frame: int
    quality: int


class FrameCache:
    """LRU decoded-frame cache (reference src/cache_bridge.rs:34-103).

    ``capacity`` is the number of decoded frames kept; for 1080p YCoCg-R
    each frame is ≈6 MB, so 64 frames ≈ 384 MB (of device memory, for
    frames put as tensors on the card).
    """

    def __init__(self, capacity: int):
        self._capacity = int(capacity)
        self._store: OrderedDict[FrameKey, CachedFrame] = OrderedDict()
        self._hits = 0
        self._misses = 0
        self._lock = threading.Lock()

    def get(self, chunk: int, frame: int, quality: int) -> CachedFrame | None:
        key = FrameKey(chunk, frame, quality)
        with self._lock:
            entry = self._store.get(key)
            if entry is None:
                self._misses += 1
                return None
            self._store.move_to_end(key)
            self._hits += 1
            return entry

    def put(
        self, chunk: int, frame: int, quality: int, data, width: int, height: int
    ) -> None:
        key = FrameKey(chunk, frame, quality)
        data = data.detach() if isinstance(data, torch.Tensor) else np.asarray(data)
        with self._lock:
            self._store[key] = CachedFrame(data, width, height)
            self._store.move_to_end(key)
            while len(self._store) > self._capacity:
                self._store.popitem(last=False)

    def hit_rate(self) -> float:
        total = self._hits + self._misses
        return 0.0 if total == 0 else self._hits / total

    def __len__(self) -> int:
        return len(self._store)

    @property
    def is_empty(self) -> bool:
        return len(self._store) == 0
