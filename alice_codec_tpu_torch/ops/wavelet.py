"""Integer lifting wavelets in the interleaved layout (PyTorch port of
the level-0 part of ``alice_codec_tpu/ops/wavelet.py``).

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

Only the single-level decomposition (``levels=1``) is ported; deeper
pyramids are ROADMAP Queue 1 item 10.
"""

from __future__ import annotations

import torch

from ..core import WaveletType

__all__ = ["LIFTING_STEPS", "forward_3d_inter", "inverse_3d_inter"]

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


def _check_levels(levels: int) -> None:
    if levels != 1:
        raise NotImplementedError(
            "multi-level decomposition is not ported yet "
            "(ROADMAP Queue 1 item 10)")


def forward_3d_inter(volume: torch.Tensor, wavelet: WaveletType,
                     levels: int = 1) -> torch.Tensor:
    """Interleaved 3D forward on int32 ``(..., T, H, W)``: rows (W), then
    columns (H), then time (T), all steps along one axis at a time."""
    _check_levels(levels)
    steps = lift_steps(wavelet)
    for ax in (-1, -2, -3):
        volume = lift_axis(volume, steps, ax)
    return volume


def inverse_3d_inter(volume: torch.Tensor, wavelet: WaveletType,
                     levels: int = 1, *, exact: bool = False) -> torch.Tensor:
    """Inverse of :func:`forward_3d_inter`: time, then columns, then rows."""
    _check_levels(levels)
    steps = lift_steps(wavelet, inverse=True, exact=exact)
    for ax in (-3, -2, -1):
        volume = lift_axis(volume, steps, ax)
    return volume
