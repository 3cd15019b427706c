"""The port's sparse significance coding against the JAX package, on the
CPU: the plain versions of the compact / expand kernels
(``compact_plain`` / ``expand_plain``, which the wrappers run on a CPU
tensor) and their prepass, held against the JAX package's
``ops/sparse_spec.py`` (the reference its own kernel tests use) and, live,
against its XLA prepass helpers; and the sparse codec's sizing helpers
against the JAX ones.  All at one 2^20-symbol plane per channel, the size the
sparse codec pads the smallest chunk to."""

import numpy as np
import pytest
import torch

from alice_codec_tpu import alc3 as jax_alc3
from alice_codec_tpu.ops import sparse_spec as jspec
from alice_codec_tpu.ops.pallas import lift_kernels as jax_lift
from alice_codec_tpu.ops.pallas import sparse_kernels as jsk

from alice_codec_tpu_torch import alc3, pipeline
from alice_codec_tpu_torch.ops.kernels import sparse as sk

# The suite runs several pytest workers on the CPU at once: keep these
# small tensor ops on one thread so they do not compete with them.
torch.set_num_threads(1)

P = 1 << 20
DENSITIES = (0.0, 0.03, 0.3, 1.0)


def _planes(density: float, seed: int) -> np.ndarray:
    """(3, P) uint8 symbols: nonzero at ``density``, half of it and 0.9×."""
    rng = np.random.default_rng(seed)
    return np.stack([
        np.where(rng.random(P) < d, rng.integers(1, 256, P), 0)
        for d in (density, density / 2, 0.9 * density)]).astype(np.uint8)


def _spec_bitmaps(syms: np.ndarray) -> np.ndarray:
    return np.stack([jspec.pack_bitmap(s) for s in syms])


@pytest.fixture(scope="module", params=DENSITIES)
def case(request):
    """One density's planes, the JAX spec's bitmaps and value rows, and
    capacities that differ per plane."""
    syms = _planes(request.param, seed=int(request.param * 100) + 1)
    need = [jspec.value_rows_needed(s) for s in syms]
    krs = tuple(n + 8 * (i + 1) for i, n in enumerate(need))
    return dict(syms=syms, need=need, krs=krs, bitmaps=_spec_bitmaps(syms),
                trows=sk.tile_rows(torch.from_numpy(syms)))


def test_compact_plain_matches_spec(case):
    syms, krs = case["syms"], case["krs"]
    n = sk.compact.launches
    bm, vals = sk.compact(torch.from_numpy(syms), case["trows"], krs)
    assert sk.compact.launches == n  # the CPU path launches no kernel
    np.testing.assert_array_equal(bm.numpy(), case["bitmaps"])
    row = 0
    for c, k in enumerate(krs):
        np.testing.assert_array_equal(
            vals[row : row + k].reshape(-1).numpy(),
            jspec.compact_values(syms[c], k * 128))
        row += k


def test_expand_plain_matches_spec(case):
    syms, krs = case["syms"], case["krs"]
    vals = np.concatenate([jspec.compact_values(s, k * 128)
                           for s, k in zip(syms, krs)]).reshape(-1, 128)
    n = sk.expand.launches
    out = sk.expand(torch.from_numpy(case["bitmaps"]), torch.from_numpy(vals),
                    krs)
    assert sk.expand.launches == n
    np.testing.assert_array_equal(out.numpy(), syms)
    np.testing.assert_array_equal(
        out[1].numpy(), jspec.expand_values(case["bitmaps"][1], vals[
            krs[0] : krs[0] + krs[1]]))


def _jax_tile_bases(bitmaps: np.ndarray, krs) -> np.ndarray:
    """Each tile's first value row in its plane, from the JAX package's
    XLA prepass: its block's clamped base (``value_row_bases``, less the
    plane's start in the JAX values layout) plus its offset in the block
    (``tile_row_bases_from_bitmaps``)."""
    nc = bitmaps.shape[0]
    vbase, _ = jsk.value_row_bases(bitmaps, P, krs)
    rel = np.asarray(jsk.tile_row_bases_from_bitmaps(bitmaps, P)) & 0xFFFF
    bases, _ = jsk.plane_row_bases(krs)
    nb = P // 128 // jsk.BLOCK_ROWS
    block = np.asarray(vbase).reshape(nc, nb) - np.array(bases)[:, None]
    return (block[:, :, None] + rel.reshape(nc, nb, -1)).reshape(nc, -1)


@pytest.mark.parametrize("side", ["compact", "expand"])
def test_prepass_matches_jax(case, side):
    """The per-tile value rows, as compact gets them (phase 1's
    ``tile_rows`` of the symbols) and as expand counts them from the
    bitmaps, and each tile's first value row, against the JAX XLA
    prepass.  The capacities here hold every plane, so JAX's clamp does
    not bite (the hostile-bitmap test covers it)."""
    syms, krs, trows = case["syms"], case["krs"], case["trows"]
    np.testing.assert_array_equal(trows.sum(-1).numpy(), case["need"])
    np.testing.assert_array_equal(trows.sum(-1).numpy(),
                                  np.asarray(jsk.block_value_rows(syms)))
    if side == "compact":
        jax_desc = jsk.tile_row_bases_from_symbols(syms, P)
    else:
        trows = sk._tile_rows_from_bitmaps(torch.from_numpy(case["bitmaps"]))
        jax_desc = jsk.tile_row_bases_from_bitmaps(case["bitmaps"], P)
    np.testing.assert_array_equal(trows.numpy().reshape(-1),
                                  np.asarray(jax_desc) >> 16)
    np.testing.assert_array_equal(sk._tile_bases(trows).numpy(),
                                  _jax_tile_bases(case["bitmaps"], krs))


def _hostile_reference(bitmaps, values, krs):
    """What the JAX package's expand gives for any bitmap: each tile's
    rows start at :func:`_jax_tile_bases`; a row at or past the capacity
    reads the zero margin."""
    nc = bitmaps.shape[0]
    tile_base = _jax_tile_bases(bitmaps, krs)
    out = np.zeros((nc, P), np.uint8)
    row0 = np.cumsum((0,) + krs)
    for c in range(nc):
        bits = jspec.unpack_bitmap(bitmaps[c]).reshape(-1, 1024).astype(bool)
        plane = values[row0[c] : row0[c + 1]].reshape(-1)
        for t in np.flatnonzero(bits.any(1)):
            pos = np.arange(int(bits[t].sum()))
            flat = tile_base[c, t] * 128 + pos
            ok = flat < krs[c] * 128
            tile = np.zeros(1024, np.uint8)
            tile[np.flatnonzero(bits[t])] = np.where(
                ok, plane[np.minimum(flat, plane.size - 1)], 0)
            out[c, t * 1024 : (t + 1) * 1024] = tile
    return out


@pytest.mark.parametrize("krs", [(64, 1024), (300, 1500)])
def test_expand_hostile_bitmap_clamps_like_jax(krs):
    """A bitmap whose popcount runs past the declared capacity decodes as
    the JAX package decodes it (its 512-row block bases clamped to the
    capacity) and reads nothing past the values.  Random bytes give each
    plane about 256 value rows per block, so the capacity runs out in the
    first or second block of plane 0, and inside a block of plane 1 (all
    zero in its first half) at 1500."""
    rng = np.random.default_rng(9)
    bitmaps = rng.integers(0, 256, (2, P // 8), dtype=np.uint8)
    bitmaps[1, : P // 16] = 0  # a plane that runs over late
    values = rng.integers(1, 256, (sum(krs), 128), dtype=np.uint8)
    out = sk.expand(torch.from_numpy(bitmaps), torch.from_numpy(values), krs)
    np.testing.assert_array_equal(
        out.numpy(), _hostile_reference(bitmaps, values, krs))


def test_compact_drops_values_past_capacity():
    syms = _planes(0.3, seed=5)[:1]
    need = jspec.value_rows_needed(syms[0])
    t_sym = torch.from_numpy(syms)
    bm, vals = sk.compact(t_sym, sk.tile_rows(t_sym), need // 2)
    np.testing.assert_array_equal(bm.numpy(), _spec_bitmaps(syms))
    full = jspec.compact_values(syms[0], need * 128)
    np.testing.assert_array_equal(vals.reshape(-1).numpy(),
                                  full[: need // 2 * 128])


@pytest.mark.parametrize("kernel", ["compact", "expand"])
def test_wrappers_check_inputs_and_device(kernel):
    if kernel == "compact":
        sym = torch.zeros((2, 1024), dtype=torch.uint8)
        trows = sk.tile_rows(sym)
        with pytest.raises(ValueError):
            sk.compact(sym.to(torch.int32), trows, 8)
        with pytest.raises(ValueError):
            sk.compact(torch.zeros((2, 1000), dtype=torch.uint8), trows, 8)
        with pytest.raises(ValueError):
            sk.compact(sym, trows, (8, 8, 8))
        with pytest.raises(ValueError):
            sk.compact(sym, trows.to(torch.int64), 8)
        with pytest.raises(ValueError):
            sk.compact(sym, trows[:1], 8)
        with pytest.raises(ValueError, match="unsupported device"):
            sk.compact(sym.to("meta"), trows.to("meta"), 8)
    else:
        bm = torch.zeros((2, 8192), dtype=torch.uint8)
        vals = torch.zeros((16, 128), dtype=torch.uint8)
        with pytest.raises(ValueError):
            sk.expand(bm, vals[:15], 8)
        with pytest.raises(ValueError):  # not whole tiles
            sk.expand(bm[:, :100], vals, 8)
        with pytest.raises(ValueError, match="unsupported device"):
            sk.expand(bm.to("meta"), vals.to("meta"), 8)


# ── the sparse codec's sizing helpers ───────────────────────────


def test_constants_match_jax():
    assert (sk.BLOCK_ROWS, sk.TILE_ROWS, sk.DEFAULT_V_BLK) == (
        jsk.BLOCK_ROWS, jsk.TILE_ROWS, jsk.DEFAULT_V_BLK)
    assert alc3.DENSE_ROW_FRAC == jax_alc3.DENSE_ROW_FRAC


@pytest.mark.parametrize("fn", ["_sparse_pp", "_sampled_len", "_pick_v_seg"])
def test_size_helpers_match_jax(fn):
    grid = sorted({1, 7, 1024, 2048, 65535, 65536, 1 << 20, (1 << 20) + 1,
                   132_710_400, 133_169_152, 3 * 2**25}
                  | set(range(1, 4200, 37)))
    ours, theirs = getattr(alc3, fn), getattr(jax_alc3, fn)
    for n in grid:
        assert ours(n) == theirs(n), n


def test_bucket_nv_matches_jax():
    for s_seg in (8, 16, 2048):
        for max_nv in (None, 64, 1024):
            for rows in list(range(0, 300)) + [4095, 4096, 70_000, 10**6]:
                assert (alc3._bucket_nv(rows, s_seg, max_nv)
                        == jax_alc3._bucket_nv(rows, s_seg, max_nv))


def test_tpu_fused_matches_lift3d_ok():
    for t in (2, 4, 6, 64, 128):
        for h in (2, 16, 32, 1080, 1082, 2160, 4320):
            for w in (2, 64, 1920, 3840, 7680):
                assert pipeline._tpu_fused((w, h, t)) == jax_lift.lift3d_ok(
                    (3, t, h, w), 2), (t, h, w)
