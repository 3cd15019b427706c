"""Integer lifting wavelets in the interleaved layout (PyTorch port of
the interleaved part of ``alice_codec_tpu/ops/wavelet.py``).

Filters (coefficients ×2^12; reference src/wavelet.rs:66-127)::

    CDF 9/7: -6497, -217, 3616, 1817      Haar: -4096, 2048
    CDF 5/3: -4096, 1024

Each lifting step adds ``delta = (nbr·coeff + 4096) >> 13`` (the i64 form
of the reference) to its targets, evaluated in int32 through the same
exact decomposition the JAX package uses (:func:`_delta`), so both
packages give the same bits — including where int32 wraps.

The interleaved layout keeps coefficients in place (low band at even
indices, high band at odd), so a step is one elementwise pass over the
tensor: predict targets odd indices and mirrors its right neighbour at
``n-1``; update targets even indices and mirrors its left neighbour at 0.

Two inverse modes: ``exact=False`` replays the steps with negated
coefficients (the reference decoder, ±1 exact); ``exact=True`` subtracts
the identical forward delta (perfect reconstruction).

Multi-level decompositions keep the in-place property: level k lifts the
subgrid of indices ≡ 0 (mod 2^k) on every axis with neighbour distance
2^k.  That subgrid is the strided view ``x[..., ::2^k, ::2^k, ::2^k]``,
and lifting it is a level-0 lift of the view — the same values as the
JAX package's rolls by 2^k under its ``_level_active`` masks, without
touching the rest of the volume.

The reference layout (``[low | high]`` along each axis, the `.alc` and
ALC2 wires; reference src/wavelet.rs:220-233) holds the same values: on
even dimensions it is a fixed permutation of the interleaved one
(:func:`deinterleave_3d` / :func:`interleave_3d`, the codec's route).
Its transforms on any size (:func:`forward_1d` / :func:`inverse_1d` and
their 2D / 3D / multi-level compositions, the classes
:class:`Wavelet1D` / :class:`Wavelet2D` / :class:`Wavelet3D`) are the
JAX package's even/odd-split lifts, with the reference's odd-length
quirks: for odd n the forward leaves the last slot zero and the inverse
zero-fills the trailing even slot.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from ..core import SubBand3D, WaveletType

__all__ = ["LIFTING_STEPS", "forward_1d", "inverse_1d", "forward_2d",
           "inverse_2d", "forward_3d", "inverse_3d", "forward_3d_multi",
           "inverse_3d_multi", "extract_subbands_3d", "combine_subbands_3d",
           "forward_1d_inter", "inverse_1d_inter", "forward_3d_inter",
           "inverse_3d_inter", "deinterleave_3d", "interleave_3d",
           "Wavelet1D", "Wavelet2D", "Wavelet3D"]

# (coeff, predict) pairs per filter; coeff scaled by 2^12.
LIFTING_STEPS: dict[WaveletType, tuple[tuple[int, bool], ...]] = {
    WaveletType.CDF97: ((-6497, True), (-217, False), (3616, True), (1817, False)),
    WaveletType.HAAR: ((-4096, True), (2048, False)),
    WaveletType.CDF53: ((-4096, True), (1024, False)),
}


def _delta(avg: torch.Tensor, coeff: int) -> torch.Tensor:
    """Exact int32 evaluation of ``(avg_i64 * coeff + 4096) >> 13``.

    Power-of-two coefficients reduce to one shift,
    ``(avg·2^k + 4096) >> 13 = (avg + 2^(12-k)) >> (13-k)``; the others
    split ``avg = hi·8192 + lo`` so ``coeff·lo`` fits in 26 bits."""
    if coeff == -4096:
        return (1 - avg) >> 1
    if coeff == 4096:
        return (avg + 1) >> 1
    if coeff == 2048:
        return (avg + 2) >> 2
    if coeff == -2048:
        return (2 - avg) >> 2
    if coeff == 1024:
        return (avg + 4) >> 3
    if coeff == -1024:
        return (4 - avg) >> 3
    hi = avg >> 13          # arithmetic shift = floor(avg / 8192)
    lo = avg & 8191         # non-negative remainder
    return coeff * hi + ((coeff * lo + 4096) >> 13)


def lift_step(x: torch.Tensor, coeff: int, predict: bool, axis: int,
              inverse_exact: bool = False) -> torch.Tensor:
    """One in-place lifting step along ``axis`` of an int32 tensor (the
    JAX package's ``_lift_inter`` at level 0).

    predict: x[i] += Δ(x[i-1] + x[i+1]) for odd i, the right neighbour
    mirroring to x[i-1] at i = n-1 (reference src/wavelet.rs:180-197).
    update:  x[i] += Δ(x[i-1] + x[i+1]) for even i, the left neighbour
    mirroring to x[i+1] at i = 0 (src/wavelet.rs:201-217).
    ``inverse_exact`` subtracts the delta instead (exact undo)."""
    ax = axis % x.ndim
    n = x.shape[ax]
    shape = [1] * x.ndim
    shape[ax] = n
    idx = torch.arange(n, device=x.device).view(shape)
    nl = torch.roll(x, 1, ax)
    nr = torch.roll(x, -1, ax)
    if predict:
        tgt = (idx & 1) == 1
        nbr = nl + torch.where(idx == n - 1, nl, nr)
    else:
        tgt = (idx & 1) == 0
        nbr = torch.where(idx == 0, nr, nl) + nr
    d = _delta(nbr, coeff)
    return torch.where(tgt, x - d if inverse_exact else x + d, x)


def lift_steps(wavelet: WaveletType, *, inverse: bool = False,
               exact: bool = False) -> tuple[tuple[int, bool, bool], ...]:
    """(coeff, predict, inverse_exact) triples in application order."""
    base = LIFTING_STEPS[WaveletType(wavelet)]
    if not inverse:
        return tuple((c, p, False) for c, p in base)
    if exact:
        return tuple((c, p, True) for c, p in reversed(base))
    return tuple((-c, p, False) for c, p in reversed(base))


def lift_axis(x: torch.Tensor, steps, axis: int) -> torch.Tensor:
    """Apply every step of ``steps`` (from :func:`lift_steps`) along ``axis``."""
    if x.shape[axis] % 2:
        raise ValueError(f"axis length {x.shape[axis]} is not even")
    for coeff, predict, inv in steps:
        x = lift_step(x, coeff, predict, axis, inverse_exact=inv)
    return x


def _subgrid(ndim: int, s: int, axes) -> tuple:
    """Index of the stride-``s`` subgrid along ``axes``."""
    idx = [slice(None)] * ndim
    for ax in axes:
        idx[ax % ndim] = slice(None, None, s)
    return tuple(idx)


def _lift_subgrid(x: torch.Tensor, steps, level: int, lift_axes,
                  sub_axes) -> torch.Tensor:
    """Lift the stride-2^level subgrid (over ``sub_axes``) of ``x`` along
    each of ``lift_axes`` in turn; the rest of ``x`` is unchanged."""
    s = 1 << level
    if level == 0:
        for ax in lift_axes:
            x = lift_axis(x, steps, ax)
        return x
    idx = _subgrid(x.ndim, s, sub_axes)
    sub = x[idx]
    for ax in lift_axes:
        sub = lift_axis(sub, steps, ax)
    out = x.clone()
    out[idx] = sub
    return out


def _check_axis(x: torch.Tensor, axis: int, level: int) -> None:
    if x.shape[axis] % (2 << level):
        raise ValueError(f"axis length {x.shape[axis]} not divisible by "
                         f"{2 << level} (level {level})")


def forward_1d_inter(x: torch.Tensor, wavelet: WaveletType, axis: int = -1,
                     level: int = 0) -> torch.Tensor:
    """Forward lifting along ``axis`` of the indices ≡ 0 (mod 2^level)
    (every position of the other axes); int32."""
    _check_axis(x, axis, level)
    return _lift_subgrid(x, lift_steps(wavelet), level, (axis,), (axis,))


def inverse_1d_inter(x: torch.Tensor, wavelet: WaveletType, axis: int = -1,
                     level: int = 0, *, exact: bool = False) -> torch.Tensor:
    """Inverse of :func:`forward_1d_inter` (compat ±1 replay, or exact
    undo)."""
    _check_axis(x, axis, level)
    return _lift_subgrid(x, lift_steps(wavelet, inverse=True, exact=exact),
                         level, (axis,), (axis,))


def forward_3d_inter(volume: torch.Tensor, wavelet: WaveletType,
                     levels: int = 1, start_level: int = 0) -> torch.Tensor:
    """Interleaved 3D forward on int32 ``(..., T, H, W)``: per level, rows
    (W), then columns (H), then time (T) over the level's LLL subgrid
    (dims divisible by 2^levels).  ``start_level`` skips the first levels
    (the plain 3D lift kernel does level 0)."""
    steps = lift_steps(wavelet)
    for k in range(start_level, levels):
        for ax in (-1, -2, -3):
            _check_axis(volume, ax, k)
        volume = _lift_subgrid(volume, steps, k, (-1, -2, -3), (-1, -2, -3))
    return volume


def inverse_3d_inter(volume: torch.Tensor, wavelet: WaveletType,
                     levels: int = 1, *, exact: bool = False,
                     stop_level: int = 0) -> torch.Tensor:
    """Inverse of :func:`forward_3d_inter`: per level from the deepest,
    time, then columns, then rows.  ``stop_level`` stops before the last
    levels (the plain 3D lift kernel undoes level 0)."""
    steps = lift_steps(wavelet, inverse=True, exact=exact)
    for k in reversed(range(stop_level, levels)):
        for ax in (-3, -2, -1):
            _check_axis(volume, ax, k)
        volume = _lift_subgrid(volume, steps, k, (-3, -2, -1), (-3, -2, -1))
    return volume


def _halves(x: torch.Tensor) -> tuple[int, int, int]:
    t, h, w = x.shape[-3:]
    if t % 2 or h % 2 or w % 2:
        raise ValueError(f"T, H and W must be even, got {(t, h, w)}")
    return t // 2, h // 2, w // 2


def deinterleave_3d(x: torch.Tensor) -> torch.Tensor:
    """Interleaved → reference layout of ``(C, T, H, W)`` (even dims):
    along each axis the even indices (low band) move to the first half
    and the odd ones (high band) to the second — one copy of ``x``, of
    any dtype: (C, T/2, 2, H/2, 2, W/2, 2) → (C, 2, T/2, 2, H/2, 2, W/2)."""
    t2, h2, w2 = _halves(x)
    c = x.shape[0]
    v = x.reshape(c, t2, 2, h2, 2, w2, 2).permute(0, 2, 1, 4, 3, 6, 5)
    return v.reshape(x.shape)


def interleave_3d(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`deinterleave_3d`: reference → interleaved."""
    t2, h2, w2 = _halves(x)
    c = x.shape[0]
    v = x.reshape(c, 2, t2, 2, h2, 2, w2).permute(0, 2, 1, 4, 3, 6, 5)
    return v.reshape(x.shape)


# ── the reference layout on any size ────────────────────────────


def _sl(x: torch.Tensor, ax: int, sl: slice) -> torch.Tensor:
    """``x[..., sl, ...]`` with the slice at ``ax`` (non-negative)."""
    idx = [slice(None)] * x.ndim
    idx[ax] = sl
    return x[tuple(idx)]


def _lift(even: torch.Tensor, odd: torch.Tensor, coeff: int, predict: bool,
          ax: int, undo: bool = False):
    """One lifting step on split even/odd tensors along ``ax``; ``undo``
    subtracts the delta instead of adding it (the exact inverse).

    Predict (src/wavelet.rs:180-197): odd[i] += Δ(even[i] + even[i+1]),
    mirroring the last even at the right edge.
    Update (src/wavelet.rs:201-217): even[i] += Δ(odd[i-1] + odd[i]),
    mirroring odd[0] at the left edge.
    """
    def step(x, d):
        return x - d if undo else x + d

    ne, no = even.shape[ax], odd.shape[ax]
    if predict:
        if ne > no:
            # Odd-length signal: every odd sample has a real right neighbor.
            odd = step(odd, _delta(_sl(even, ax, slice(None, -1))
                                   + _sl(even, ax, slice(1, None)), coeff))
        else:
            even_r = torch.cat([_sl(even, ax, slice(1, None)),
                                _sl(even, ax, slice(-1, None))], ax)
            odd = step(odd, _delta(even + even_r, coeff))
    else:
        odd_l = torch.cat([_sl(odd, ax, slice(None, 1)),
                           _sl(odd, ax, slice(None, -1))], ax)
        delta = _delta(odd_l + odd, coeff)
        if ne > no:
            # Odd-length: the trailing even sample is never updated.
            even = torch.cat([step(_sl(even, ax, slice(None, -1)), delta),
                              _sl(even, ax, slice(-1, None))], ax)
        else:
            even = step(even, delta)
    return even, odd


def forward_1d(x: torch.Tensor, wavelet: WaveletType,
               axis: int = -1) -> torch.Tensor:
    """Forward transform of an int32 tensor along ``axis`` (lengths < 2
    are returned as they are): ``[low-pass..., high-pass...]``, the
    reference's deinterleave (src/wavelet.rs:220-233); for odd n only
    n//2 evens are copied and the final slot stays zero."""
    ax = axis % x.ndim
    n = x.shape[ax]
    if n < 2:
        return x
    even = _sl(x, ax, slice(0, None, 2))
    odd = _sl(x, ax, slice(1, None, 2))
    for coeff, predict in LIFTING_STEPS[WaveletType(wavelet)]:
        even, odd = _lift(even, odd, coeff, predict, ax)
    if n % 2 == 1:
        zero = torch.zeros_like(_sl(even, ax, slice(None, 1)))
        return torch.cat([_sl(even, ax, slice(None, -1)), odd, zero], ax)
    return torch.cat([even, odd], ax)


def inverse_1d(x: torch.Tensor, wavelet: WaveletType, axis: int = -1,
               *, exact: bool = False) -> torch.Tensor:
    """Inverse of :func:`forward_1d` along ``axis``: ``exact=False``
    replays the steps with negated coefficients (reference semantics, ±1
    approximate), ``exact=True`` subtracts the identical forward delta.
    For odd n the trailing even slot is zero-filled (src/wavelet.rs:236-248)."""
    ax = axis % x.ndim
    n = x.shape[ax]
    if n < 2:
        return x
    half = n // 2
    if n % 2 == 0:
        even = _sl(x, ax, slice(None, half))
        odd = _sl(x, ax, slice(half, None))
    else:
        zero = torch.zeros_like(_sl(x, ax, slice(None, 1)))
        even = torch.cat([_sl(x, ax, slice(None, half)), zero], ax)
        odd = _sl(x, ax, slice(half, 2 * half))
    for coeff, predict in reversed(LIFTING_STEPS[WaveletType(wavelet)]):
        if exact:  # subtract the same delta the forward step added
            even, odd = _lift(even, odd, coeff, predict, ax, undo=True)
        else:
            even, odd = _lift(even, odd, -coeff, predict, ax)
    # interleave even/odd back: stack on a new axis after ``ax``, fold it in
    body = torch.stack([_sl(even, ax, slice(None, half)), odd], dim=ax + 1)
    body = body.reshape(*x.shape[:ax], 2 * half, *x.shape[ax + 1:])
    if n % 2 == 1:
        return torch.cat([body, _sl(even, ax, slice(-1, None))], ax)
    return body


def forward_2d(image: torch.Tensor, wavelet: WaveletType) -> torch.Tensor:
    """2D forward on ``(..., H, W)``: rows then columns (reference
    src/wavelet.rs:292-316)."""
    return forward_1d(forward_1d(image, wavelet, -1), wavelet, -2)


def inverse_2d(image: torch.Tensor, wavelet: WaveletType, *,
               exact: bool = False) -> torch.Tensor:
    """2D inverse: columns then rows (reference src/wavelet.rs:319-340)."""
    image = inverse_1d(image, wavelet, -2, exact=exact)
    return inverse_1d(image, wavelet, -1, exact=exact)


def forward_3d(volume: torch.Tensor, wavelet: WaveletType) -> torch.Tensor:
    """Single-level 3D forward in the reference layout on int32 ``(..., T,
    H, W)`` of any size: rows, columns, then time (reference
    src/wavelet.rs:392-438).  On even dims it equals
    ``deinterleave_3d(forward_3d_inter(volume))``."""
    for ax in (-1, -2, -3):
        volume = forward_1d(volume, wavelet, ax)
    return volume


def inverse_3d(volume: torch.Tensor, wavelet: WaveletType, *,
               exact: bool = False) -> torch.Tensor:
    """Inverse of :func:`forward_3d` (time, columns, then rows;
    src/wavelet.rs:441-484): compat ±1 replay, or exact undo."""
    for ax in (-3, -2, -1):
        volume = inverse_1d(volume, wavelet, ax, exact=exact)
    return volume


def _check_levels(volume: torch.Tensor, levels: int) -> None:
    t, h, w = volume.shape[-3:]
    if any(d % (1 << levels) for d in (t, h, w)):
        raise ValueError(
            f"dims {(t, h, w)} not divisible by 2^{levels} for "
            f"{levels}-level decomposition")


def forward_3d_multi(volume: torch.Tensor, wavelet: WaveletType,
                     levels: int = 1) -> torch.Tensor:
    """Multi-level 3D decomposition: level k re-decomposes the previous
    level's LLL octant in place (every dim divisible by ``2**levels``);
    ``levels=1`` is :func:`forward_3d`."""
    if levels < 1:
        return volume
    _check_levels(volume, levels)
    t, h, w = volume.shape[-3:]
    out = forward_3d(volume, wavelet)
    for k in range(1, levels):
        box = (..., slice(t >> k), slice(h >> k), slice(w >> k))
        out[box] = forward_3d(out[box], wavelet)
    return out


def inverse_3d_multi(volume: torch.Tensor, wavelet: WaveletType,
                     levels: int = 1, *, exact: bool = False) -> torch.Tensor:
    """Inverse of :func:`forward_3d_multi` (deepest level first)."""
    if levels < 1:
        return volume
    t, h, w = volume.shape[-3:]
    out = volume.clone()
    for k in range(levels - 1, 0, -1):
        box = (..., slice(t >> k), slice(h >> k), slice(w >> k))
        out[box] = inverse_3d(out[box], wavelet, exact=exact)
    return inverse_3d(out, wavelet, exact=exact)


def _band_box(band: SubBand3D, ht: int, hh: int, hw: int) -> tuple:
    """Index of ``band``'s octant; letters are (y, x, t) per the
    reference enum (src/lib.rs:113-132)."""
    yh, xh, th = (int(band) >> 2) & 1, (int(band) >> 1) & 1, int(band) & 1
    return (..., slice(th * ht, (th + 1) * ht), slice(yh * hh, (yh + 1) * hh),
            slice(xh * hw, (xh + 1) * hw))


def extract_subbands_3d(volume: torch.Tensor) -> dict:
    """The 8 sub-bands of a single-level :func:`forward_3d` volume with
    even dims: ``{SubBand3D: (..., T/2, H/2, W/2) view}``."""
    t, h, w = volume.shape[-3:]
    return {band: volume[_band_box(band, t // 2, h // 2, w // 2)]
            for band in SubBand3D}


def combine_subbands_3d(bands: dict, *, like=None) -> torch.Tensor:
    """Inverse of :func:`extract_subbands_3d`: reassemble the full volume
    (``like`` is accepted for the JAX package's signature and unused)."""
    sample = bands[SubBand3D.LLL]
    ht, hh, hw = sample.shape[-3:]
    vol = sample.new_zeros((*sample.shape[:-3], 2 * ht, 2 * hh, 2 * hw))
    for band, data in bands.items():
        vol[_band_box(band, ht, hh, hw)] = data
    return vol


# ── Object API mirroring the reference types ────────────────────


class Wavelet1D:
    """1D lifting wavelet (reference src/wavelet.rs:47-249), computing on
    ``device`` (the CUDA card unless given another); NumPy in and out.

    >>> import numpy as np
    >>> w = Wavelet1D.cdf53(device="cpu")
    >>> sig = np.array([10, 20, 30, 40, 50, 60, 70, 80], np.int32)
    >>> bool(np.array_equal(w.inverse(w.forward(sig)), sig))
    True
    """

    def __init__(self, wavelet: WaveletType, *, device=None):
        self.wavelet = WaveletType(wavelet)
        self.device = resolve_device(device)

    @classmethod
    def cdf97(cls, *, device=None):
        return cls(WaveletType.CDF97, device=device)

    @classmethod
    def cdf53(cls, *, device=None):
        return cls(WaveletType.CDF53, device=device)

    @classmethod
    def haar(cls, *, device=None):
        return cls(WaveletType.HAAR, device=device)

    @classmethod
    def new(cls, wavelet_1d: "Wavelet1D"):
        return cls(wavelet_1d.wavelet, device=wavelet_1d.device)

    @property
    def steps(self) -> tuple[tuple[int, bool], ...]:
        return LIFTING_STEPS[self.wavelet]

    def _run(self, data, dims, fn, **kw) -> np.ndarray:
        """``fn`` on ``data`` as int32 on the device; a flat input is
        viewed as ``dims`` and the result has the input's shape."""
        arr = np.array(data, np.int32)  # a copy: torch takes only writable arrays
        x = torch.as_tensor(arr, device=self.device)
        if x.ndim == 1 and len(dims) > 1:
            x = x.reshape(dims)
        out = fn(x, self.wavelet, **kw)
        return out.cpu().numpy().reshape(arr.shape)

    def forward(self, signal) -> np.ndarray:
        return self._run(signal, (), forward_1d)

    def inverse(self, signal, *, exact: bool = False) -> np.ndarray:
        return self._run(signal, (), inverse_1d, exact=exact)


class Wavelet2D(Wavelet1D):
    """2D wavelet: rows then columns (reference src/wavelet.rs:265-341)."""

    def forward(self, image, width: int | None = None,
                height: int | None = None) -> np.ndarray:
        return self._run(image, (height, width), forward_2d)

    def inverse(self, image, width: int | None = None, height: int | None = None,
                *, exact: bool = False) -> np.ndarray:
        return self._run(image, (height, width), inverse_2d, exact=exact)


class Wavelet3D(Wavelet1D):
    """3D wavelet over (t, y, x) video volumes (reference src/wavelet.rs:359-485)."""

    def forward(self, volume, width: int | None = None, height: int | None = None,
                depth: int | None = None) -> np.ndarray:
        return self._run(volume, (depth, height, width), forward_3d)

    def inverse(self, volume, width: int | None = None, height: int | None = None,
                depth: int | None = None, *, exact: bool = False) -> np.ndarray:
        return self._run(volume, (depth, height, width), inverse_3d, exact=exact)
