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
(:func:`deinterleave_3d` / :func:`interleave_3d`), so its forward and
inverse transforms (:func:`forward_3d` / :func:`inverse_3d`) are the
interleaved ones composed with that permutation.
"""

from __future__ import annotations

import torch

from ..core import WaveletType

__all__ = ["LIFTING_STEPS", "forward_1d_inter", "inverse_1d_inter",
           "forward_3d_inter", "inverse_3d_inter", "deinterleave_3d",
           "interleave_3d", "forward_3d", "inverse_3d"]

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


def forward_3d(volume: torch.Tensor, wavelet: WaveletType) -> torch.Tensor:
    """Single-level 3D forward in the reference layout on int32
    ``(C, T, H, W)`` with even dims (rows, columns, then time; reference
    src/wavelet.rs:392-438)."""
    return deinterleave_3d(forward_3d_inter(volume, wavelet))


def inverse_3d(volume: torch.Tensor, wavelet: WaveletType, *,
               exact: bool = False) -> torch.Tensor:
    """Inverse of :func:`forward_3d` (time, columns, then rows;
    src/wavelet.rs:441-484): compat ±1 replay, or exact undo."""
    return inverse_3d_inter(interleave_3d(volume), wavelet, exact=exact)
