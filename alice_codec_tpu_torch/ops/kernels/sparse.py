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

* :func:`compact` — (n, P) symbols → (bitmaps, values).  A value that
  would land at or past its plane's capacity is dropped (the codec sizes
  capacities from the row counts first, so this never happens there).
* :func:`expand` — the inverse.  A read at or past a plane's capacity
  gives 0, so a hostile bitmap whose popcount exceeds the capacity
  decodes as the JAX package decodes it: there each 512-row block's base
  is clamped to the capacity and such reads land in a zero margin, and a
  block whose unclamped base reaches the capacity reads only zeros
  either way.

Both also work in place on the codec's wire buffers: ``compact`` reads
the planes ``pick`` of its symbols and writes each one's bitmap and
values into views it is given (``out``); ``expand`` reads bitmaps and
values from views and writes the first symbols of each plane into views.

As in ``ops/kernels/lift.py``, each wrapper takes its plain PyTorch
version for a CPU tensor and launches the Hopper kernels
(``csrc/sparse.cu``) for a CUDA tensor, counting one launch a call in
``launches``.  A tile's values start at the exclusive prefix of the
tiles' value rows, counted by compact from phase 1's :func:`tile_rows`
and by expand from the bitmaps.  The plain versions take that prefix in
torch, as the JAX package does in XLA; on the card it is a
reduce-then-scan over groups of ``GROUP_TILES`` tiles, two small kernels
before the main one, so a CUDA call runs these three kernels and no
torch op.
"""

from __future__ import annotations

import ctypes

import torch

from ... import _build
from .rans3 import NG

__all__ = ["BLOCK_ROWS", "TILE_ROWS", "DEFAULT_V_BLK", "GROUP_TILES",
           "TAIL_BYTES", "tile_rows", "group_grid", "compact", "expand",
           "compact_plain", "expand_plain"]

#: pixel rows per block of the TPU kernels.  The CUDA kernels do not
#: batch by it; it is wire-visible only through alc3._sparse_pp.
BLOCK_ROWS = 512
#: pixel rows per value-padding tile (a wire constant): one bitmap row.
TILE_ROWS = 8
#: blocks per TPU kernel slot.  Wire-visible through alc3._sparse_pp,
#: which pads a plane to a whole number of DEFAULT_V_BLK blocks.
DEFAULT_V_BLK = 16
#: tiles one CUDA block takes, one group of the scan of the tile bases
#: (``csrc/sparse.cu`` GROUP).
GROUP_TILES = 32
#: bytes one tail block of the compact kernel zeroes (``csrc/sparse.cu``
#: TAIL_BYTES).
TAIL_BYTES = 32768

_TILE = TILE_ROWS * NG
_MAX_PLANES = 64  # csrc/sparse.cu MAX_PLANES: the planes of a launch


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


def group_grid(tiles: int, krs, bm_lens=None) -> tuple[int, int]:
    """The kernels' launch geometry for planes of ``tiles`` tiles:
    ``(ng, nz)`` — tile groups a plane (a block each, and a word of the
    group scan) and, for compact, tail blocks a plane, each zeroing a
    ``TAIL_BYTES`` slice of a plane's value rows past its used rows (up
    to ``krs[c]`` rows) and of its bitmap segment past its bitmap
    (``bm_lens[c]`` bytes; default: the bitmap alone).  Compact's grid is
    ``len(krs) · (ng + nz)`` blocks, tile groups first."""
    ng = -(-tiles // GROUP_TILES)
    bm_lens = bm_lens or [tiles * NG] * len(krs)
    nz = max([0] + [-(-k * NG // TAIL_BYTES) for k in krs]
             + [-(-(b - tiles * NG) // TAIL_BYTES) for b in bm_lens])
    return ng, nz


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


def _check_values(values: torch.Tensor, krs) -> None:
    want = (sum(krs), NG)
    if values.dtype != torch.uint8 or tuple(values.shape) != want:
        raise ValueError(f"values must be {want} uint8, got "
                         f"{tuple(values.shape)} {values.dtype}")


def _check_views(views, n: int, what: str, sizes, *, at_least=False) -> list:
    """``views``: a sequence of ``n`` 1-D contiguous uint8 tensors of
    ``sizes[i]`` bytes (at least, with ``at_least``)."""
    views = list(views)
    if len(views) != n:
        raise ValueError(f"{len(views)} {what} views for {n} planes")
    for v, size in zip(views, sizes):
        if (v.dtype != torch.uint8 or v.ndim != 1 or not v.is_contiguous()
                or (v.numel() < size if at_least else v.numel() != size)):
            raise ValueError(
                f"a {what} view must be {'≥ ' if at_least else ''}{size} "
                f"contiguous uint8 bytes, got {tuple(v.shape)} {v.dtype}")
    return views


def _plane_list(symbols, trows) -> tuple[list, list, int]:
    """``symbols`` (n, P) uint8 and their (n, P/1024) int32 tile rows, or
    a sequence of n (P,) planes and a sequence of their (P/1024,) tile
    rows → ``(n planes, n tile rows, P)``, checked."""
    if isinstance(symbols, torch.Tensor):
        _check_planes(symbols, "symbols", _TILE)
        _check_trows(trows, symbols)
        return list(symbols), list(trows), symbols.shape[1]
    planes, rows = list(symbols), list(trows)
    p = planes[0].numel() if planes else 0
    if not planes or p % _TILE or len(rows) != len(planes):
        raise ValueError(f"{len(planes)} planes of {p} symbols and "
                         f"{len(rows)} tile rows (whole tiles of {_TILE})")
    for x in planes:
        if x.dtype != torch.uint8 or x.ndim != 1 or x.numel() != p:
            raise ValueError(f"a plane must be ({p},) uint8, got "
                             f"{tuple(x.shape)} {x.dtype}")
    for r in rows:
        if r.dtype != torch.int32 or tuple(r.shape) != (p // _TILE,):
            raise ValueError(f"tile rows must be ({p // _TILE},) int32, got "
                             f"{tuple(r.shape)} {r.dtype}")
    return planes, rows, p


def _pick(n: int, pick) -> tuple[int, ...]:
    pick = tuple(range(n)) if pick is None else tuple(int(i) for i in pick)
    if not pick or any(not 0 <= i < n for i in pick):
        raise ValueError(f"plane selection {pick} of {n} planes")
    return pick


# ── plain versions ──────────────────────────────────────────────


def compact_plain(symbols: torch.Tensor, trows: torch.Tensor, krs, *,
                  pick=None, out=None):
    """Plain PyTorch compact, vectorised over every tile at once.

    ``symbols``: (n, P) uint8; ``trows``: their :func:`tile_rows`;
    ``pick``: the planes to code (default all); ``krs``:
    value capacity rows (int, or one per picked plane).  Returns
    ``(bitmaps (len(pick), P/8) uint8, values (sum(krs), 128) uint8)``;
    with ``out = (bitmap views, value views)``, one 1-D view per picked
    plane — its bitmap segment of at least P/8 bytes (zeroed past P/8) and
    its ``krs[i]·128`` value bytes — writes them instead and returns
    ``out``.  ``symbols`` and ``trows`` may instead be sequences of (P,)
    planes and their (P/1024,) tile rows."""
    planes, rows, _ = _plane_list(symbols, trows)
    if not isinstance(symbols, torch.Tensor):
        symbols, trows = torch.stack(planes), torch.stack(rows)
    pick = _pick(symbols.shape[0], pick)
    if pick != tuple(range(symbols.shape[0])):
        index = torch.tensor(pick, device=symbols.device)
        symbols, trows = symbols[index], trows[index]
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
    values = values.reshape(sum(krs), NG)
    if out is None:
        return bitmaps, values
    bm_out, val_out = _compact_views(out, nc, p, krs)
    for i, (bm, vals) in enumerate(zip(bm_out, val_out)):
        bm[: p // 8].copy_(bitmaps[i])
        bm[p // 8 :].zero_()
        vals.copy_(values[row0[i] : row0[i] + krs[i]].reshape(-1))
    return out


def _compact_views(out, nc: int, p: int, krs):
    if len(out) != 2:
        raise ValueError("out must be (bitmap views, value views)")
    return (_check_views(out[0], nc, "bitmap", [p // 8] * nc, at_least=True),
            _check_views(out[1], nc, "values", [k * NG for k in krs]))


def _expand_inputs(bitmaps, values, krs):
    """(bitmaps, values) as a tensor each, or as per-plane views →
    ``(nc, P/8, krs, bitmap views or None, value views or None)``."""
    if isinstance(bitmaps, torch.Tensor):
        _check_planes(bitmaps, "bitmaps", NG)
        nc, p8 = bitmaps.shape
        bm_views = None
    else:
        bm_views = list(bitmaps)
        nc = len(bm_views)
        p8 = bm_views[0].numel() if nc else 0
        if not nc or p8 % NG:
            raise ValueError(f"bitmap views of {p8} bytes (whole tiles of {NG})")
        bm_views = _check_views(bm_views, nc, "bitmap", [p8] * nc)
    krs = _norm_krs(krs, nc)
    if isinstance(values, torch.Tensor):
        _check_values(values, krs)
        val_views = None
    else:
        val_views = _check_views(values, nc, "values", [k * NG for k in krs])
    return nc, p8, krs, bm_views, val_views


def _check_out(out, nc: int, p: int) -> tuple[list, int]:
    """Output views of the expand: one per plane, equal lengths ≤ P."""
    out = list(out)
    n = out[0].numel() if out else 0
    out = _check_views(out, nc, "output", [n] * nc)
    if n > p:
        raise ValueError(f"output views of {n} symbols for planes of {p}")
    return out, n


def expand_plain(bitmaps, values, krs, *, out=None):
    """Plain PyTorch expand: (nc, P/8) bitmaps + (sum(krs), 128) values →
    (nc, P) uint8 symbols.  Either input may instead be a sequence of nc
    1-D views (P/8 bytes; ``krs[i]·128`` bytes); with ``out``, a sequence
    of nc 1-D views of n ≤ P bytes, each receives the first n symbols of
    its plane, and ``out`` is returned."""
    nc, p8, krs, bm_views, val_views = _expand_inputs(bitmaps, values, krs)
    if bm_views is not None:
        bitmaps = torch.stack(bm_views)
    if val_views is not None:
        values = torch.cat(val_views).reshape(-1, NG)
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
        sym = torch.zeros((nc, p8 * 8), dtype=torch.uint8, device=dev)
    else:
        index = ((row0 + row) * NG + (rank & (NG - 1))).clamp(0, flat.numel() - 1)
        sym = torch.where(ok, flat[index], 0).to(torch.uint8).reshape(nc, p8 * 8)
    if out is None:
        return sym
    out, n = _check_out(out, nc, p8 * 8)
    for i, o in enumerate(out):
        o.copy_(sym[i, :n])
    return out


# ── CUDA launches ───────────────────────────────────────────────


def _lib() -> ctypes.CDLL:
    lib = _build.library("sparse")
    if not getattr(lib, "_alc_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.alc_sparse_compact.argtypes = [i, ll, i, i, p, p, p, p, p, p, p, p]
        lib.alc_sparse_expand.argtypes = [i, ll, i, ll, p, p, p, p, p, p]
        lib.alc_sparse_compact.restype = lib.alc_sparse_expand.restype = i
        lib._alc_typed = True
    return lib


def _addrs(views) -> ctypes.Array:
    return (ctypes.c_longlong * len(views))(*[v.data_ptr() for v in views])


def _check_device(views, dev: torch.device, what: str) -> None:
    for v in views:
        if v.device != dev:
            raise ValueError(f"{what} on {v.device}, not {dev}")
        if v.data_ptr() % 16:
            raise ValueError(f"{what} not 16-byte aligned")


def _check_count(nc: int, tiles: int, ng: int, nz: int = 0) -> None:
    if not 1 <= nc <= _MAX_PLANES:
        raise ValueError(f"{nc} planes (the kernels take 1..{_MAX_PLANES})")
    if nc * (ng + nz) >= 2**31 or tiles * TILE_ROWS >= 2**32:
        raise ValueError(f"{nc} planes of {tiles} tiles exceed the kernels' "
                         "grid or row limits")


def _scratch(nc: int, ng: int, dev: torch.device) -> torch.Tensor:
    """Words of the group scan: each group's rows, their prefix, and each
    plane's used rows (every word written by the kernels before it is
    read)."""
    return torch.empty(2 * nc * ng + nc, dtype=torch.int32, device=dev)


def compact(symbols, trows, krs, *, pick=None, out=None):
    """Sparse compact: (n, P) uint8 symbols → ``(bitmaps (len(pick), P/8)
    uint8, values (sum(krs), 128) uint8)``, or in place into ``out``, as
    :func:`compact_plain` says.  ``trows``: the symbols'
    :func:`tile_rows` (phase 1 has them; the tile bases are their
    prefix); ``krs``: value capacity rows (int, or one per picked
    plane).  ``symbols`` and ``trows`` may instead be sequences of (P,)
    planes (each 16-byte aligned) and their tile rows: the planes of a
    batch's chunks, read where each chunk's phase 1 left them.  One
    launch codes up to ``_MAX_PLANES`` picked planes."""
    planes, rows, p = _plane_list(symbols, trows)
    if planes[0].device.type == "cpu":
        return compact_plain(symbols, trows, krs, pick=pick, out=out)
    if not planes[0].is_cuda:
        raise ValueError(f"compact: unsupported device {planes[0].device}")
    pick = _pick(len(planes), pick)
    nc = len(pick)
    krs = _norm_krs(krs, nc)
    dev = planes[0].device
    if isinstance(symbols, torch.Tensor):
        planes = list(symbols.contiguous())
        rows = list(trows.to(dev).contiguous())
    planes, rows = [planes[i] for i in pick], [rows[i] for i in pick]
    tiles = p // _TILE
    if out is None:
        bitmaps = torch.empty((nc, p // 8), dtype=torch.uint8, device=dev)
        values = torch.empty((sum(krs), NG), dtype=torch.uint8, device=dev)
        flat = values.reshape(-1)
        bm_out = list(bitmaps)
        val_out = [flat[r * NG : (r + k) * NG] for r, k in zip(_row0(krs), krs)]
        result = bitmaps, values
    else:
        bm_out, val_out = _compact_views(out, nc, p, krs)
        result = out
    if not tiles:
        for v in bm_out + val_out:
            v.zero_()
        return result
    bm_lens = [b.numel() for b in bm_out]
    if any(b % 16 for b in bm_lens):
        raise ValueError(f"bitmap segments of {bm_lens} bytes (multiples of 16)")
    _check_device(planes, dev, "a symbol plane")
    _check_device(bm_out, dev, "a bitmap view")
    _check_device(val_out, dev, "a values view")
    for r in rows:
        if r.device != dev or not r.is_contiguous():
            raise ValueError(f"tile rows on {r.device}, not contiguous on {dev}")
    for g in range(0, nc, _MAX_PLANES):
        sel = slice(g, g + _MAX_PLANES)
        n, kg = len(planes[sel]), krs[sel]
        ng, nz = group_grid(tiles, kg, bm_lens[sel])
        _check_count(n, tiles, ng, nz)
        src, trs = _addrs(planes[sel]), _addrs(rows[sel])
        bm_len = (ctypes.c_longlong * n)(*bm_lens[sel])
        kr = (ctypes.c_longlong * n)(*kg)
        bm_ptr, val_ptr = _addrs(bm_out[sel]), _addrs(val_out[sel])
        scratch = _scratch(n, ng, dev)
        _build.check(_lib().alc_sparse_compact(
            n, tiles, ng, nz, ctypes.addressof(src), ctypes.addressof(trs),
            ctypes.addressof(bm_ptr), ctypes.addressof(bm_len),
            ctypes.addressof(val_ptr), ctypes.addressof(kr), scratch.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream), "compact")
        compact.launches += 1
    return result


def expand(bitmaps, values, krs, *, out=None):
    """Sparse expand: (nc, P/8) uint8 bitmaps + (sum(krs), 128) uint8
    values → (nc, P) uint8 symbols, or per-plane views in and out, as
    :func:`expand_plain` says.  One launch decodes up to ``_MAX_PLANES``
    planes."""
    first = bitmaps if isinstance(bitmaps, torch.Tensor) else next(iter(bitmaps), None)
    if first is None:
        raise ValueError("expand: no bitmap planes")
    if first.device.type == "cpu":
        return expand_plain(bitmaps, values, krs, out=out)
    if not first.is_cuda:
        raise ValueError(f"expand: unsupported device {first.device}")
    nc, p8, krs, bm_views, val_views = _expand_inputs(bitmaps, values, krs)
    dev = first.device
    if bm_views is None:
        bm_views = list(bitmaps.contiguous())
    if val_views is None:
        flat = values.to(dev).contiguous().reshape(-1)
        val_views = [flat[r * NG : (r + k) * NG] for r, k in zip(_row0(krs), krs)]
    if out is None:
        result = torch.empty((nc, p8 * 8), dtype=torch.uint8, device=dev)
        out_views, n_out = list(result), p8 * 8
    else:
        out_views, n_out = _check_out(out, nc, p8 * 8)
        result = out
    tiles = p8 // NG
    if not tiles or not n_out:
        return result
    _check_device(bm_views, dev, "a bitmap view")
    _check_device(val_views, dev, "a values view")
    for o in out_views:
        if o.device != dev:
            raise ValueError(f"an output view on {o.device}, not {dev}")
    for g in range(0, nc, _MAX_PLANES):
        sel = slice(g, g + _MAX_PLANES)
        n, kg = len(bm_views[sel]), krs[sel]
        ng, _ = group_grid(tiles, kg)
        _check_count(n, tiles, ng)
        kr = (ctypes.c_longlong * n)(*kg)
        bm_ptr, val_ptr = _addrs(bm_views[sel]), _addrs(val_views[sel])
        out_ptr = _addrs(out_views[sel])
        scratch = _scratch(n, ng, dev)
        _build.check(_lib().alc_sparse_expand(
            n, tiles, ng, n_out, ctypes.addressof(bm_ptr),
            ctypes.addressof(val_ptr), ctypes.addressof(out_ptr),
            ctypes.addressof(kr), scratch.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream), "expand")
        expand.launches += 1
    return result


compact.launches = 0
expand.launches = 0
