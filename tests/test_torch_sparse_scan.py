"""Numpy models of the port's sparse kernels (``csrc/sparse.cu``:
compact, expand, and the group scan before them) against the JAX
package, and the plain versions' in-place interface against the calls
and copies it replaces.

* The group scan of the tile bases: ``group_rows`` (a warp a group of
  ``GROUP_TILES`` tiles, in any order) sums each group's tile rows, from
  phase 1's per-tile counts or counted from the bitmap 16 bytes a lane;
  ``scan_groups`` (one block, rounds of threads × items groups with a
  carry) takes their exclusive prefix in each plane and each plane's
  used rows; a main block adds the warp scan of its tiles' rows.  The
  tile bases equal the JAX package's XLA prepass
  (``tile_row_bases_from_symbols`` / ``_from_bitmaps`` under the
  unclamped block prefix of ``value_row_bases``) at densities 0-100 %,
  at tile counts that are not a multiple of the group, with groups small
  enough that the scan takes several rounds, and on a hostile bitmap.
* A strip's arithmetic (a thread's 16 lanes × 8 rows of a tile): nonzero
  flags ORed into bitmap bytes, the 8×8 bit transpose to row masks, the
  segmented scan of packed popcounts over a tile's 8 strips, the ranks;
  against ``ops/sparse_spec.py``.
* ``compact_plain`` / ``expand_plain`` with planes picked out of the
  symbols, bitmaps and values in a segment buffer, and p < P, against
  today's call plus the copies ``alc3.py`` made around it, for 1, 2, 3
  and 6 planes.

Tiny shapes (at most 6 planes × 64 tiles); the JAX prepass runs once, in
a module-scoped fixture."""

import numpy as np
import pytest
import torch

from alice_codec_tpu.ops import sparse_spec as jspec
from alice_codec_tpu.ops.pallas import sparse_kernels as jsk

from alice_codec_tpu_torch.ops.kernels import sparse as sk

# several pytest workers share the CPU: keep torch on one thread
torch.set_num_threads(1)

TILE = 1024
JAX_TILES = 64  # the JAX prepass takes whole 512-row blocks: 64 tiles
# (planes, tiles, density): tile counts of 1, 13 and 45 are not whole
# groups of 32; the JAX planes are these, zero-padded to 64 tiles
CASES = [(1, 64, 0.0), (3, 45, 0.03), (6, 13, 0.3), (2, 64, 1.0), (3, 1, 0.3),
         (4, 64, 0.03)]
U64 = np.uint64


def _symbols(nc: int, tiles: int, density: float, seed: int) -> np.ndarray:
    """(nc, tiles·1024) uint8: plane i nonzero at density·(i+1)/nc, with
    runs of empty and of 4× denser tiles."""
    rng = np.random.default_rng(seed)
    p = tiles * TILE
    burst = np.repeat(rng.choice([0.0, 1.0, 4.0], tiles), TILE)
    return np.stack([
        np.where(rng.random(p) < np.minimum(1.0, density * (i + 1) / nc * burst),
                 rng.integers(1, 256, p), 0)
        for i in range(nc)]).astype(np.uint8)


def _hostile(seed: int = 11) -> np.ndarray:
    """Random bitmap bytes for 3 planes of 45 tiles, the second half of
    plane 1 empty."""
    bm = np.random.default_rng(seed).integers(0, 256, (3, 45 * 128),
                                              dtype=np.uint8)
    bm[1, 22 * 128 :] = 0
    return bm


def _pad_tiles(a: np.ndarray, unit: int) -> np.ndarray:
    """Zero-pad the planes of ``a`` to JAX_TILES tiles of ``unit`` bytes."""
    return np.pad(a, ((0, 0), (0, JAX_TILES * unit - a.shape[1])))


def _jax_bases(desc, bitmaps64: np.ndarray) -> np.ndarray:
    """Each tile's first value row in its plane from the JAX prepass: the
    block's base from ``value_row_bases`` with capacities too large to
    clamp, less the plane's start in the JAX values layout, plus the
    tile's offset in its block (the low half of its descriptor)."""
    nc = bitmaps64.shape[0]
    p = JAX_TILES * TILE
    krs = (p // 128 * 2,) * nc
    vbase, _ = jsk.value_row_bases(bitmaps64, p, krs)
    starts, _ = jsk.plane_row_bases(krs)
    block = np.asarray(vbase).reshape(nc, -1) - np.array(starts)[:, None]
    rel = (np.asarray(desc) & 0xFFFF).reshape(nc, block.shape[1], -1)
    return (block[:, :, None] + rel).reshape(nc, -1)


@pytest.fixture(scope="module")
def jax_bases():
    """The JAX tile bases of every case and of the hostile bitmap, from
    the symbols and from their bitmaps."""
    out = {}
    for k, (nc, tiles, density) in enumerate(CASES):
        sym = _pad_tiles(_symbols(nc, tiles, density, k), TILE)
        bm = jspec.pack_bitmap(sym)
        p = JAX_TILES * TILE
        out[k] = (_jax_bases(jsk.tile_row_bases_from_symbols(sym, p), bm),
                  _jax_bases(jsk.tile_row_bases_from_bitmaps(bm, p), bm))
    bm = _pad_tiles(_hostile(), 128)
    out["hostile"] = _jax_bases(
        jsk.tile_row_bases_from_bitmaps(bm, JAX_TILES * TILE), bm)
    return out


# ── the group scan ──────────────────────────────────────────────


def group_rows(nc: int, tiles: int, *, trows=None, bitmaps=None,
               group: int = sk.GROUP_TILES, seed: int = 0) -> np.ndarray:
    """``group_rows``: (nc, ng) rows of each group, a warp a group taken
    in a seeded shuffled order — from ``trows`` (nc, tiles), or counted
    from ``bitmaps`` (nc, tiles·128): lane l reads 16-byte word q = l +
    32 k of its group's bitmap, the 8 lanes of a tile sum their popcounts
    and take its ceil."""
    ng = -(-tiles // group)
    agg = np.full((nc, ng), -1, np.int64)
    order = np.random.default_rng(seed).permutation(nc * ng)
    for gw in order:
        c, grp = divmod(int(gw), ng)
        t0 = grp * group
        if trows is not None:
            agg[c, grp] = trows[c, t0 : t0 + group].sum()
            continue
        words = bitmaps[c, t0 * 128 : (t0 + group) * 128].reshape(-1, 16)
        pops = np.unpackbits(words, axis=-1).sum(-1, dtype=np.int64)
        per_tile = pops.reshape(-1, 8).sum(-1)  # q // 8: a tile's 8 words
        agg[c, grp] = (-(-per_tile // 128)).sum()
    return agg


def scan_groups(agg: np.ndarray, *, threads: int = 1024, items: int = 4):
    """``scan_groups``: one block, rounds of ``threads × items`` groups;
    thread t sums its items, the block scans the sums (warps, then the
    warp totals), each item gets carry + the prefix, and the last thread's
    running total is the next round's carry.  → ``(gbase (nc, ng), used
    (nc,))``."""
    nc, ng = agg.shape
    gbase = np.full((nc, ng), -1, np.int64)
    used = np.zeros(nc, np.int64)
    for c in range(nc):
        carry = 0
        for g0 in range(0, ng, threads * items):
            v = np.zeros(threads * items, np.int64)
            n = min(ng - g0, threads * items)
            v[:n] = agg[c, g0 : g0 + n]
            sums = v.reshape(threads, items).sum(-1)
            excl = np.cumsum(sums) - sums  # the block's scan of the sums
            run = carry + excl[:, None] + np.cumsum(v.reshape(threads, items), -1) \
                - v.reshape(threads, items)
            gbase[c, g0 : g0 + n] = run.reshape(-1)[:n]
            carry = int(carry + sums.sum())
        used[c] = carry
    return gbase, used


def tile_bases(tile_rows_: np.ndarray, gbase: np.ndarray, *,
               group: int = sk.GROUP_TILES, seed: int = 1) -> np.ndarray:
    """The main kernels' blocks, in a seeded shuffled order: the group's
    base plus the exclusive warp scan of its tiles' rows."""
    nc, tiles = tile_rows_.shape
    ng = gbase.shape[1]
    out = np.full((nc, tiles), -1, np.int64)
    for b in np.random.default_rng(seed).permutation(nc * ng):
        c, grp = divmod(int(b), ng)
        r = tile_rows_[c, grp * group : (grp + 1) * group]
        out[c, grp * group : grp * group + r.size] = gbase[c, grp] + np.cumsum(r) - r
    return out


def _trows(sym: np.ndarray) -> np.ndarray:
    nc = sym.shape[0]
    return -(-(sym.reshape(nc, -1, TILE) != 0).sum(-1, dtype=np.int64) // 128)


def _trows_from_bitmaps(bm: np.ndarray) -> np.ndarray:
    nc = bm.shape[0]
    cnt = np.unpackbits(bm.reshape(nc, -1, 128), axis=-1).sum(-1, dtype=np.int64)
    return -(-cnt // 128)


def model_bases(nc, tiles, trows, *, bitmaps=None, group=sk.GROUP_TILES,
                threads=1024, items=4, seed=0):
    """Tile bases and used rows as the three kernels compute them."""
    agg = group_rows(nc, tiles, trows=None if bitmaps is not None else trows,
                     bitmaps=bitmaps, group=group, seed=seed)
    gbase, used = scan_groups(agg, threads=threads, items=items)
    return tile_bases(trows, gbase, group=group, seed=seed + 1), used


@pytest.mark.parametrize("group,threads,items", [(sk.GROUP_TILES, 1024, 4),
                                                 (1, 4, 4), (3, 2, 3)])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_group_scan_matches_jax_prepass(jax_bases, case, group, threads, items):
    """The kernels' geometry (groups of 32, rounds of 1024 × 4 groups),
    and groups of 1 and 3 tiles with rounds of 16 and 6 groups, so that
    the scan carries across rounds."""
    nc, tiles, density = CASES[case]
    sym = _symbols(nc, tiles, density, case)
    from_sym, from_bm = jax_bases[case]
    trows = _trows(sym)
    bm = jspec.pack_bitmap(sym)
    assert (trows == _trows_from_bitmaps(bm)).all()
    for seed in range(2):
        for bitmaps in (None, bm):
            bases, used = model_bases(nc, tiles, trows, bitmaps=bitmaps,
                                      group=group, threads=threads,
                                      items=items, seed=seed)
            np.testing.assert_array_equal(bases, from_sym[:, :tiles])
            np.testing.assert_array_equal(bases, from_bm[:, :tiles])
            np.testing.assert_array_equal(used, trows.sum(-1))


@pytest.mark.parametrize("group", [sk.GROUP_TILES, 2])
def test_group_scan_hostile_bitmap_matches_jax(jax_bases, group):
    bm = _hostile()
    bases, _ = model_bases(3, 45, _trows_from_bitmaps(bm), bitmaps=bm,
                           group=group, threads=2, items=2, seed=5)
    np.testing.assert_array_equal(bases, jax_bases["hostile"][:, :45])


def test_group_grid():
    """Groups and tail blocks: the tail covers each plane's capacity and
    its bitmap segment's tail in TAIL_BYTES slices."""
    assert sk.group_grid(1, (0,)) == (1, 0)
    assert sk.group_grid(32, (1,)) == (1, 1)
    assert sk.group_grid(33, (0, 0)) == (2, 0)
    assert sk.group_grid(45, (256, 257)) == (2, 2)
    assert sk.group_grid(45, (1,), [45 * 128 + 16]) == (2, 1)
    assert sk.group_grid(45, (1,), [45 * 128 + 2 * sk.TAIL_BYTES + 16]) == (2, 3)


# ── a strip's arithmetic ────────────────────────────────────────


def nonzero_bits(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32)
    return (x | ((x & 0x7F7F7F7F) + 0x7F7F7F7F)) & np.uint32(0x80808080)


def transpose8(x: np.ndarray) -> np.ndarray:
    x = x.astype(U64)
    for mask, keep, s in ((0x00AA00AA00AA00AA, 0xAA55AA55AA55AA55, 7),
                          (0x0000CCCC0000CCCC, 0xCCCC3333CCCC3333, 14),
                          (0x00000000F0F0F0F0, 0xF0F0F0F00F0F0F0F, 28)):
        x = (x & U64(keep)) | ((x & U64(mask)) << U64(s)) | ((x >> U64(s)) & U64(mask))
    return x


def strips(bm_words: np.ndarray):
    """(…, 8 strips, 4) uint32 bitmap words of each strip → ``(masks (…,
    8 strips, 8 rows) 16-bit, pos (…, 8, 8) rank of each strip-row's first
    set bit in its tile, nnz (…) set bits of the tile)``, as
    ``strip_ranks`` computes them (packed 8-bit row counts, scanned over
    the tile's strips)."""
    w = bm_words.astype(U64)
    lo = transpose8(w[..., 0] | w[..., 1] << U64(32))
    hi = transpose8(w[..., 2] | w[..., 3] << U64(32))
    j = np.arange(8, dtype=U64)
    masks = (((lo[..., None] >> (U64(8) * j)) & U64(0xFF))
             | (((hi[..., None] >> (U64(8) * j)) & U64(0xFF)) << U64(8))).astype(np.uint32)
    cnt = np.vectorize(int.bit_count, otypes=[np.uint32])(masks)
    fields = np.arange(4, dtype=np.uint32) * 8
    packed = np.stack([(cnt[..., :4] << fields).sum(-1, dtype=np.uint32),
                       (cnt[..., 4:] << fields).sum(-1, dtype=np.uint32)], -1)
    inc = np.cumsum(packed, axis=-2, dtype=np.uint32)  # over the strips
    exc, tot = inc - packed, inc[..., 7:, :]
    row_cnt = (tot[..., None] >> fields) & 0xFF          # (…, 1, 2, 4)
    row_pre = (np.cumsum(row_cnt.reshape(*row_cnt.shape[:-3], 8), -1)
               - row_cnt.reshape(*row_cnt.shape[:-3], 8))
    pos = ((exc[..., None] >> fields) & 0xFF).reshape(*exc.shape[:-1], 8) \
        + row_pre[..., None, :]
    nnz = row_cnt.reshape(*row_cnt.shape[:-3], 8).sum(-1, dtype=np.int64)
    return masks, pos.astype(np.int64), nnz


def model_compact(sym: np.ndarray, krs):
    """compact as the kernel computes it, strip by strip: (nc, P) →
    (bitmaps (nc, P/8), values per plane (kr·128,))."""
    nc, p = sym.shape
    tiles = p // TILE
    x = np.ascontiguousarray(sym.reshape(nc, tiles, 8, 8, 16)).view(np.uint32)
    t = nonzero_bits(x)                                       # (c, t, j, g, 4)
    shift = (7 - np.arange(8, dtype=np.uint32))[:, None, None]
    words = np.bitwise_or.reduce(t >> shift, axis=2)          # (c, t, g, 4)
    bitmaps = np.ascontiguousarray(words).view(np.uint8).reshape(nc, p // 8)
    masks, pos, nnz = strips(words)
    bases, _ = model_bases(nc, tiles, -(-nnz // 128), seed=1)
    vals = []
    for c in range(nc):
        buf = np.zeros(max(krs[c], (bases[c, -1] + 8)) * 128, np.uint8)
        for ti, g, j, i in zip(*np.nonzero(
                (masks[c][..., None] >> np.arange(16)) & 1)):
            below = bin(int(masks[c, ti, g, j]) & ((1 << i) - 1)).count("1")
            buf[bases[c, ti] * 128 + pos[c, ti, g, j] + below] = \
                sym[c, ti * TILE + j * 128 + g * 16 + i]
        vals.append(buf[: krs[c] * 128])
    return bitmaps, vals


def model_expand(bitmaps: np.ndarray, vals, krs) -> np.ndarray:
    """expand as the kernel computes it: rows at or past a plane's
    capacity read as zero."""
    nc, p8 = bitmaps.shape
    tiles = p8 // 128
    words = np.ascontiguousarray(bitmaps.reshape(nc, tiles, 8, 16)).view(np.uint32)
    masks, pos, nnz = strips(words)
    bases, _ = model_bases(nc, tiles, -(-nnz // 128), bitmaps=bitmaps, seed=2)
    out = np.zeros((nc, tiles * TILE), np.uint8)
    for c in range(nc):
        for ti, g, j, i in zip(*np.nonzero(
                (masks[c][..., None] >> np.arange(16)) & 1)):
            below = bin(int(masks[c, ti, g, j]) & ((1 << i) - 1)).count("1")
            rank = pos[c, ti, g, j] + below
            row = bases[c, ti] + rank // 128
            if row < krs[c]:
                out[c, ti * TILE + j * 128 + g * 16 + i] = \
                    vals[c][row * 128 + rank % 128]
    return out


@pytest.mark.parametrize("case", range(len(CASES)))
def test_strip_model_matches_spec(case):
    nc, tiles, density = CASES[case]
    sym = _symbols(nc, tiles, density, case)
    need = [jspec.value_rows_needed(s) for s in sym]
    krs = tuple(n + 2 for n in need)
    bitmaps, vals = model_compact(sym, krs)
    np.testing.assert_array_equal(bitmaps, jspec.pack_bitmap(sym))
    for c in range(nc):
        np.testing.assert_array_equal(vals[c], jspec.compact_values(sym[c], krs[c] * 128))
    np.testing.assert_array_equal(model_expand(bitmaps, vals, krs), sym)
    # a capacity below the rows drops whole rows; expand reads zeros there
    small = tuple(n // 2 for n in need)
    _, cut = model_compact(sym, small)
    for c in range(nc):
        np.testing.assert_array_equal(cut[c], vals[c][: small[c] * 128])


def test_strip_model_hostile_bitmap_matches_plain():
    bm = _hostile()
    krs = (40, 3, 500)
    rng = np.random.default_rng(3)
    vals = [rng.integers(1, 256, k * 128, dtype=np.uint8) for k in krs]
    want = sk.expand_plain(torch.from_numpy(bm),
                           torch.from_numpy(np.concatenate(vals).reshape(-1, 128)),
                           krs)
    np.testing.assert_array_equal(model_expand(bm, vals, krs), want.numpy())


# ── the in-place interface ──────────────────────────────────────


@pytest.mark.parametrize("n_all,pick", [(1, (0,)), (3, (1, 2)), (3, (0, 1, 2)),
                                        (6, (0, 2, 3, 4, 5, 1)), (6, (5,))])
def test_plain_in_place_matches_calls_and_copies(n_all, pick):
    """Planes picked out of (n_all, P) symbols, their bitmaps and values
    written into a segment buffer laid out as ``_encode_chunk_sparse``
    lays it out (bitmap segments longer than the bitmap, then the value
    sections), and back into rows of p < P symbols, as
    ``_sparse_entropy_expand`` reads and writes them: the same bytes as
    the whole-tensor calls and the copies around them."""
    tiles = 45
    p_full = tiles * TILE
    sym = _symbols(n_all, tiles, 0.05, len(pick))
    t_sym = torch.from_numpy(sym)
    trows = sk.tile_rows(t_sym)
    krs = tuple(int(trows[i].sum()) + 3 for i in pick)
    mb = p_full // 8 + 2048
    sizes = [mb] * len(pick) + [k * 128 for k in krs]
    buf = torch.full((sum(sizes),), 0xA5, dtype=torch.uint8)
    parts = torch.split(buf, sizes)
    n = len(pick)
    got = sk.compact(t_sym, trows, krs, pick=pick,
                     out=(list(parts[:n]), list(parts[n:])))
    assert got[0][0] is parts[0]
    # today's call, then the copies alc3.py made into its buffer
    index = torch.tensor(pick)
    bm, vals = sk.compact(t_sym[index], trows[index], krs)
    want = torch.empty_like(buf)
    wparts = torch.split(want, sizes)
    row = 0
    for i, k in enumerate(krs):
        wparts[i][: p_full // 8].copy_(bm[i])
        wparts[i][p_full // 8 :].zero_()
        wparts[n + i].copy_(vals[row : row + k].reshape(-1))
        row += k
    assert torch.equal(buf, want)
    # the expand back into rows of p < P symbols (an odd p: rows unaligned)
    p = p_full - 777
    dec = torch.full((n_all + 1, p), 0x3C, dtype=torch.uint8)
    rows_out = [dec[1 + i] for i in range(n)]
    res = sk.expand([parts[i][: p_full // 8] for i in range(n)],
                    list(parts[n:]), krs, out=rows_out)
    assert res[0] is rows_out[0]
    full = sk.expand(torch.stack([parts[i][: p_full // 8] for i in range(n)]),
                     torch.cat(list(parts[n:])).reshape(-1, 128), krs)
    want_dec = torch.full_like(dec, 0x3C)
    want_dec[1 : 1 + n] = full[:, :p]
    assert torch.equal(dec, want_dec)
    assert torch.equal(dec[1 : 1 + n], t_sym[index, :p])


def test_in_place_views_are_checked():
    sym = torch.zeros((2, 2048), dtype=torch.uint8)
    bm = torch.zeros(256, dtype=torch.uint8)
    vals = torch.zeros(128, dtype=torch.uint8)
    with pytest.raises(ValueError, match="bitmap"):
        sk.compact(sym, sk.tile_rows(sym), (1,), pick=(0,), out=([bm[:255]], [vals]))
    with pytest.raises(ValueError, match="values"):
        sk.compact(sym, sk.tile_rows(sym), (2,), pick=(0,), out=([bm], [vals]))
    with pytest.raises(ValueError, match="selection"):
        sk.compact(sym, sk.tile_rows(sym), (1,), pick=(2,), out=([bm], [vals]))
    with pytest.raises(ValueError, match="output"):
        sk.expand([bm], [vals], (1,), out=[torch.zeros(2049, dtype=torch.uint8)])
