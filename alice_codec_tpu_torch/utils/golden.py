"""Deterministic golden-fixture input generator (a copy of the JAX
package's ``utils/golden.py``).

The same closed-form pattern is implemented in the off-rig Rust
generator (tools/golden/src/main.rs); both produce identical bytes, so a
fixture of ``tests/golden/`` is fully specified by ``(w, h, f)``.

Formula (all arithmetic exact in u64, result taken mod 256)::

    v(x, y, t, c) = (3x + 5y + 7t + 11c + ((x+1)(y+2)(t+3) mod 251)) mod 256

Pixel layout matches the reference API's flat interleaved buffer
(src/python.rs:365-436): frame-major, then rows, then columns, then the
3 RGB channels.
"""

from __future__ import annotations

import numpy as np

__all__ = ["golden_rgb"]


def golden_rgb(w: int, h: int, f: int) -> np.ndarray:
    """Return the deterministic test chunk as ``(f, h, w, 3)`` uint8."""
    x = np.arange(w, dtype=np.uint64)[None, None, :, None]
    y = np.arange(h, dtype=np.uint64)[None, :, None, None]
    t = np.arange(f, dtype=np.uint64)[:, None, None, None]
    c = np.arange(3, dtype=np.uint64)[None, None, None, :]
    mix = ((x + 1) * (y + 2) * (t + 3)) % 251
    v = (3 * x + 5 * y + 7 * t + 11 * c + mix) % 256
    return v.astype(np.uint8)
