"""Sparse significance coding: the port of
``alice_codec_tpu/ops/pallas/sparse_kernels.py`` (compact_pallas,
expand_pallas) and of the tile prepass it runs in XLA.

Both kernels compute the JAX package's NumPy spec
``alice_codec_tpu/ops/sparse_spec.py`` (wire v5).  A plane of P symbols
(P a whole number of 1024-symbol tiles) is:

* a bitmap, (P/8,) uint8: byte (tile, l) has bit j set where
  ``sym[tile·1024 + j·128 + l] != 0``;
* values: each tile's nonzeros in pixel order, zero-padded to whole
  128-symbol rows, tiles concatenated; the plane holds ``kr`` rows.

Layout of the port's values buffer: ``(sum(krs), 128)`` uint8, plane c
from row ``sum(krs[:c])``.  The JAX kernels put a ``BLOCK_ROWS`` margin
after each plane and leave the rows past a plane's used rows
unspecified; the port needs no margin and writes those rows as zeros,
which the JAX caller masks them to, so the wire is the same.

* :func:`compact` — (nc, P) symbols → (bitmaps, values).  A value that
  would land at or past its plane's capacity is dropped (the codec sizes
  capacities from the row counts first, so this never happens there).
* :func:`expand` — the inverse.  A read at or past a plane's capacity
  gives 0, so a hostile bitmap whose popcount exceeds the capacity
  decodes as the JAX package decodes it: there each 512-row block's base
  is clamped to the capacity and such reads land in a zero margin, and a
  block whose unclamped base reaches the capacity reads only zeros
  either way.

As in ``ops/kernels/lift.py``, each wrapper takes its plain PyTorch
version for a CPU tensor and launches the Hopper kernel
(``csrc/sparse.cu``) for a CUDA tensor, counting launches in
``launches``.  The prepass stays in PyTorch, as the JAX package keeps it
in XLA: a tile's values start at the exclusive prefix of the tiles'
value rows.  Compact takes those rows (:func:`tile_rows`) from the
codec's phase 1, which counted them to size the capacities; expand
counts them from the bitmaps.
"""

from __future__ import annotations

import ctypes

import torch

from ... import _build
from .rans3 import NG

__all__ = ["BLOCK_ROWS", "TILE_ROWS", "DEFAULT_V_BLK", "tile_rows",
           "compact", "expand", "compact_plain", "expand_plain"]

#: pixel rows per block of the TPU kernels.  The CUDA kernels do not
#: batch by it; it is wire-visible only through alc3._sparse_pp.
BLOCK_ROWS = 512
#: pixel rows per value-padding tile (a wire constant): one bitmap row.
TILE_ROWS = 8
#: blocks per TPU kernel slot.  Wire-visible through alc3._sparse_pp,
#: which pads a plane to a whole number of DEFAULT_V_BLK blocks.
DEFAULT_V_BLK = 16

_TILE = TILE_ROWS * NG
_MAX_PLANES = 16  # csrc/sparse.cu MAX_PLANES


def _norm_krs(krs, nc: int) -> tuple[int, ...]:
    """A capacity spec (int, or one per plane) → per-plane value rows."""
    if isinstance(krs, int):
        return (krs,) * nc
    krs = tuple(int(k) for k in krs)
    if len(krs) != nc:
        raise ValueError(f"{len(krs)} capacities for {nc} planes")
    return krs


def _ceil_rows(counts: torch.Tensor) -> torch.Tensor:
    return (counts + (NG - 1)) // NG


def tile_rows(symbols: torch.Tensor) -> torch.Tensor:
    """(nc, P) symbols → (nc, P/1024) int32 value rows of each tile (its
    nonzeros over 128, rounded up); their sum is a plane's value rows."""
    nc, p = symbols.shape
    return _ceil_rows((symbols.reshape(nc, p // _TILE, _TILE) != 0).sum(
        -1, dtype=torch.int32))


def _popcount8(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each uint8 (SWAR, in uint8)."""
    x = x - ((x >> 1) & 0x55)
    x = (x & 0x33) + ((x >> 2) & 0x33)
    return (x + (x >> 4)) & 0x0F


def _tile_bases(trows: torch.Tensor) -> torch.Tensor:
    """(nc, tiles) per-tile value rows → each tile's first value row in
    its plane: their exclusive prefix."""
    return torch.cumsum(trows, -1, dtype=torch.int32) - trows


def _tile_rows_from_bitmaps(bitmaps: torch.Tensor) -> torch.Tensor:
    """(nc, P/8) bitmaps → (nc, P/1024) int32 value rows of each tile."""
    nc, p8 = bitmaps.shape
    return _ceil_rows(_popcount8(bitmaps).reshape(nc, p8 // NG, NG).sum(
        -1, dtype=torch.int32))


def _row0(krs) -> list[int]:
    out, acc = [], 0
    for k in krs:
        out.append(acc)
        acc += k
    return out


def _check_planes(x: torch.Tensor, what: str, unit: int) -> None:
    if x.dtype != torch.uint8 or x.ndim != 2 or x.shape[1] % unit:
        raise ValueError(f"{what} must be (nc, n·{unit}) uint8, got "
                         f"{tuple(x.shape)} {x.dtype}")


def _check_trows(trows: torch.Tensor, symbols: torch.Tensor) -> None:
    want = (symbols.shape[0], symbols.shape[1] // _TILE)
    if trows.dtype != torch.int32 or tuple(trows.shape) != want:
        raise ValueError(f"tile rows must be {want} int32, got "
                         f"{tuple(trows.shape)} {trows.dtype}")


# ── plain versions ──────────────────────────────────────────────


def compact_plain(symbols: torch.Tensor, trows: torch.Tensor, krs):
    """Plain PyTorch compact, vectorised over every tile at once: (nc, P)
    uint8 symbols and their :func:`tile_rows` → ``(bitmaps (nc, P/8)
    uint8, values (sum(krs), 128) uint8)``."""
    _check_planes(symbols, "symbols", _TILE)
    _check_trows(trows, symbols)
    nc, p = symbols.shape
    krs = _norm_krs(krs, nc)
    dev = symbols.device
    tiles = symbols.reshape(nc, p // _TILE, TILE_ROWS, NG)
    bits = (tiles != 0).to(torch.uint8)
    shifts = torch.arange(TILE_ROWS, dtype=torch.uint8, device=dev)
    bitmaps = (bits << shifts.view(1, 1, TILE_ROWS, 1)).sum(
        2, dtype=torch.uint8).reshape(nc, p // 8)
    flat = bits.reshape(nc, p // _TILE, _TILE).to(torch.int64)
    rank = torch.cumsum(flat, -1) - flat
    dest = _tile_bases(trows).to(torch.int64)[..., None] * NG + rank
    cap = torch.tensor(krs, dtype=torch.int64, device=dev).view(nc, 1, 1) * NG
    row0 = torch.tensor(_row0(krs), dtype=torch.int64, device=dev)
    keep = (flat == 1) & (dest < cap)
    values = torch.zeros(sum(krs) * NG, dtype=torch.uint8, device=dev)
    index = dest + row0.view(nc, 1, 1) * NG
    values[index[keep]] = symbols.reshape(nc, p // _TILE, _TILE)[keep]
    return bitmaps, values.reshape(sum(krs), NG)


def expand_plain(bitmaps: torch.Tensor, values: torch.Tensor,
                 krs) -> torch.Tensor:
    """Plain PyTorch expand: (nc, P/8) bitmaps + (sum(krs), 128) values →
    (nc, P) uint8 symbols."""
    _check_planes(bitmaps, "bitmaps", NG)
    nc, p8 = bitmaps.shape
    krs = _norm_krs(krs, nc)
    _check_values(values, krs)
    dev = bitmaps.device
    shifts = torch.arange(TILE_ROWS, dtype=torch.uint8, device=dev)
    bits = ((bitmaps.reshape(nc, p8 // NG, 1, NG) >> shifts.view(1, 1, -1, 1))
            & 1).reshape(nc, p8 // NG, _TILE).to(torch.int64)
    rank = torch.cumsum(bits, -1) - bits
    row = _tile_bases(_tile_rows_from_bitmaps(bitmaps)).to(torch.int64)[..., None] + (rank >> 7)
    kr = torch.tensor(krs, dtype=torch.int64, device=dev).view(nc, 1, 1)
    row0 = torch.tensor(_row0(krs), dtype=torch.int64, device=dev).view(nc, 1, 1)
    ok = (bits == 1) & (row < kr)
    flat = values.reshape(-1)
    if flat.numel() == 0:
        return torch.zeros((nc, p8 * 8), dtype=torch.uint8, device=dev)
    index = ((row0 + row) * NG + (rank & (NG - 1))).clamp(0, flat.numel() - 1)
    out = torch.where(ok, flat[index], 0).to(torch.uint8)
    return out.reshape(nc, p8 * 8)


def _check_values(values: torch.Tensor, krs) -> None:
    want = (sum(krs), NG)
    if values.dtype != torch.uint8 or tuple(values.shape) != want:
        raise ValueError(f"values must be {want} uint8, got "
                         f"{tuple(values.shape)} {values.dtype}")


# ── CUDA launches ───────────────────────────────────────────────


def _lib() -> ctypes.CDLL:
    lib = _build.library("sparse")
    if not getattr(lib, "_alc_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for fn in (lib.alc_sparse_compact, lib.alc_sparse_expand):
            fn.argtypes = [p, p, p, p, i, ll, p, p, p]
            fn.restype = i
        lib._alc_typed = True
    return lib


def _plane_args(krs):
    n = len(krs)
    if not 1 <= n <= _MAX_PLANES:
        raise ValueError(f"{n} planes (the kernels take 1..{_MAX_PLANES})")
    kr = (ctypes.c_longlong * n)(*krs)
    row0 = (ctypes.c_longlong * n)(*_row0(krs))
    return kr, row0


def _grid(nc: int, tiles: int) -> None:
    if nc * tiles >= 2**31:
        raise ValueError(f"{nc * tiles} tiles exceed the grid limit")


def compact(symbols: torch.Tensor, trows: torch.Tensor, krs):
    """Sparse compact: (nc, P) uint8 symbols → ``(bitmaps (nc, P/8)
    uint8, values (sum(krs), 128) uint8)``.  ``trows``: the symbols'
    :func:`tile_rows` (phase 1 has them); ``krs``: value capacity rows
    (int, or one per plane)."""
    _check_planes(symbols, "symbols", _TILE)
    if symbols.device.type == "cpu":
        return compact_plain(symbols, trows, krs)
    if not symbols.is_cuda:
        raise ValueError(f"compact: unsupported device {symbols.device}")
    _check_trows(trows, symbols)
    nc, p = symbols.shape
    krs = _norm_krs(krs, nc)
    sym = symbols.contiguous()
    dev = sym.device
    tiles = p // _TILE
    _grid(nc, tiles)
    base = _tile_bases(trows.to(dev))
    bitmaps = torch.empty((nc, p // 8), dtype=torch.uint8, device=dev)
    values = torch.zeros((sum(krs), NG), dtype=torch.uint8, device=dev)
    if tiles:
        kr, row0 = _plane_args(krs)
        _build.check(_lib().alc_sparse_compact(
            sym.data_ptr(), base.data_ptr(), bitmaps.data_ptr(),
            values.data_ptr(), nc, tiles, ctypes.addressof(kr),
            ctypes.addressof(row0),
            torch.cuda.current_stream(dev).cuda_stream), "compact")
        compact.launches += 1
    return bitmaps, values


def expand(bitmaps: torch.Tensor, values: torch.Tensor, krs) -> torch.Tensor:
    """Sparse expand: (nc, P/8) uint8 bitmaps + (sum(krs), 128) uint8
    values → (nc, P) uint8 symbols."""
    _check_planes(bitmaps, "bitmaps", NG)
    if bitmaps.device.type == "cpu":
        return expand_plain(bitmaps, values, krs)
    if not bitmaps.is_cuda:
        raise ValueError(f"expand: unsupported device {bitmaps.device}")
    nc, p8 = bitmaps.shape
    krs = _norm_krs(krs, nc)
    _check_values(values, krs)
    bm = bitmaps.contiguous()
    dev = bm.device
    vals = values.to(dev).contiguous()
    tiles = p8 // NG
    _grid(nc, tiles)
    base = _tile_bases(_tile_rows_from_bitmaps(bm))
    out = torch.empty((nc, p8 * 8), dtype=torch.uint8, device=dev)
    if tiles:
        kr, row0 = _plane_args(krs)
        _build.check(_lib().alc_sparse_expand(
            bm.data_ptr(), vals.data_ptr(), base.data_ptr(), out.data_ptr(),
            nc, tiles, ctypes.addressof(kr), ctypes.addressof(row0),
            torch.cuda.current_stream(dev).cuda_stream),
            "expand")
        expand.launches += 1
    return out


compact.launches = 0
expand.launches = 0
