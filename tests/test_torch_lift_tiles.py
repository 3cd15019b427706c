"""The geometry and arithmetic the CUDA lift kernels (K1
``forward_quant`` / K4 ``inverse_dequant``, K7 ``forward_3d`` /
``inverse_3d``, ``csrc/lift.cu``) rest on, checked on the CPU where the
kernels cannot run:

* the halo claim: the spatial pass lifts each frame in windows around its
  stored tiles (``lift.tile_windows`` with ``lift.spatial_halo`` rows of
  halo), and lifting each window on its own and keeping its tile gives
  the full-frame lift — for every wavelet, forward and both inverse
  modes, on frames smaller than one tile, ragged ones and ones whose
  windows the kernel clamps into the frame: at int16 with and without
  the split-frame int16 store between the axes (K1 / K4), and at int32
  with values of ±2^20 and no int16 store (K7), also on a tall and a wide
  frame; the full-frame lift of the largest frame of each is held to the
  JAX package's (``forward_1d_inter`` / ``inverse_1d_inter``);
* K7's two passes (the tiles, then T; T, then the tiles) give the plain
  3D lift;
* the per-channel reciprocal the forward temporal pass divides by
  (``lift.reciprocal``), exhaustively against ``//``;
* the windows of frames (``lift.axis_windows``) that the temporal passes
  lift chunks too long for shared memory in: each window lifted on its
  own gives the full lift, and the shape guard takes every shape the JAX
  package tiles.

``lift.tile_windows`` is a model of the kernel's tiles, not the kernel:
on the card ``test_torch_gpu.py::test_lift_tile_windows_match_kernel``
(and chip_smoke.py) hold it equal to the tiles the CUDA library launches
(``lift.kernel_tile_windows``), and the kernels themselves against the
plain versions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alice_codec_tpu.core import WaveletType as JW
from alice_codec_tpu.ops import wavelet as jwavelet
from alice_codec_tpu.ops.pallas import lift_kernels as jlift

from alice_codec_tpu_torch.core import WaveletType
from alice_codec_tpu_torch.ops.kernels import lift
from alice_codec_tpu_torch.ops.wavelet import lift_axis, lift_steps

# The suite runs several pytest workers on the CPU at once: keep these
# small tensor ops on one thread so they do not compete with them.
torch.set_num_threads(1)

WAVELETS = [WaveletType.HAAR, WaveletType.CDF53, WaveletType.CDF97]
#: None: forward (W then H); False / True: the compat / exact inverse (H
#: then W)
MODES = [None, False, True]
#: (H, W) frames: smaller than one tile; ragged (W not a multiple of 8, so
#: the windows are not clamped); exactly one window; several clamped
#: windows in both axes
FRAMES = [(10, 14), (70, 258), (64, 256), (130, 520)]
#: K7's frames: those, a tall one and a wide one (one row of tiles)
FRAMES32 = FRAMES + [(3640, 32), (8, 58368)]


def _frame(shape) -> np.ndarray:
    """Random int16 values (the fused kernels' spatial input in both
    directions)."""
    rng = np.random.default_rng(sum(shape))
    return rng.integers(-32768, 32768, size=shape, dtype=np.int16).astype(np.int32)


def _frame32(shape) -> np.ndarray:
    """Random int32 values of ±2^20 (K7's input; its coefficients and the
    rdo and deep modes' planes leave int16)."""
    rng = np.random.default_rng(sum(shape) + 32)
    return rng.integers(-(1 << 20), 1 << 20, size=shape, dtype=np.int32)


def _spatial(x: torch.Tensor, wt, exact, split: bool) -> torch.Tensor:
    """The fused kernels' spatial pass on a 2D int32 frame (port)."""
    steps = lift_steps(wt, inverse=exact is not None, exact=bool(exact))
    axes = (-1, -2) if exact is None else (-2, -1)
    x = lift_axis(x, steps, axes[0])
    if split:
        x = lift._int16(x)
    return lift_axis(x, steps, axes[1])


def _spatial_jax(x: np.ndarray, wt, exact, splits=(False, True)) -> dict:
    """The JAX package's spatial pass on a 2D frame, without and with the
    int16 store between the axes: {split: frame}."""
    jwt = JW(int(wt))
    if exact is None:
        lift1 = jwavelet.forward_1d_inter
        axes, kw = (-1, -2), {}
    else:
        lift1 = jwavelet.inverse_1d_inter
        axes, kw = (-2, -1), {"exact": exact}
    y = lift1(jnp.asarray(x), jwt, axis=axes[0], **kw)
    return {split: np.asarray(lift1(y.astype(jnp.int16).astype(jnp.int32)
                                    if split else y, jwt, axis=axes[1], **kw))
            for split in splits}


def _tiled(x: torch.Tensor, wt, exact, split: bool, halo: int) -> torch.Tensor:
    """Each window lifted on its own (its cut edges mirrored as frame
    edges), its tile kept; every pixel must be stored exactly once."""
    out = torch.zeros_like(x)
    stored = torch.zeros(x.shape, dtype=torch.int32)
    for (r0, r1), (c0, c1), (wr0, wr1), (wc0, wc1) in lift.tile_windows(
            *x.shape, halo):
        assert wr0 % 2 == 0 and wc0 % 2 == 0 and wr0 <= r0 and r1 <= wr1
        assert wc0 <= c0 and c1 <= wc1
        y = _spatial(x[wr0:wr1, wc0:wc1], wt, exact, split)
        out[r0:r1, c0:c1] = y[r0 - wr0:r1 - wr0, c0 - wc0:c1 - wc0]
        stored[r0:r1, c0:c1] += 1
    assert bool((stored == 1).all())
    return out


@pytest.fixture(scope="module")
def jax_frames():
    """The JAX package's full-frame spatial lift of the largest frame in
    every mode, computed once (tests/conftest.py clears JAX's caches every
    few tests)."""
    out = {}
    for shape in FRAMES[-1:]:
        for wt in WAVELETS:
            for exact in MODES:
                for split, y in _spatial_jax(_frame(shape), wt, exact).items():
                    out[shape, wt, exact, split] = y
    return out


@pytest.fixture(scope="module")
def jax_frames32():
    """The JAX package's full-frame int32 spatial lift (no int16 store) of
    K7's largest frame in every mode, computed once."""
    shape = max(FRAMES32, key=lambda s: s[0] * s[1])
    return {(shape, wt, exact): _spatial_jax(_frame32(shape), wt, exact,
                                             (False,))[False]
            for wt in WAVELETS for exact in MODES}


@pytest.mark.parametrize("wt", WAVELETS)
def test_halo_is_the_number_of_steps(wt):
    assert lift.spatial_halo(wt) == len(lift_steps(wt))
    for exact in (False, True):
        assert lift.spatial_halo(wt) == len(lift_steps(wt, inverse=True,
                                                        exact=exact))
    assert lift.spatial_halo(wt) <= lift._HALO_W


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("exact", MODES)
@pytest.mark.parametrize("wt", WAVELETS)
@pytest.mark.parametrize("shape", FRAMES)
def test_tiles_reproduce_the_full_frame_lift(jax_frames, shape, wt, exact, split):
    x = torch.from_numpy(_frame(shape))
    full = _spatial(x, wt, exact, split)
    if (shape, wt, exact, split) in jax_frames:
        np.testing.assert_array_equal(full.numpy(),
                                      jax_frames[shape, wt, exact, split])
    got = _tiled(x, wt, exact, split, lift.spatial_halo(wt))
    assert torch.equal(got, full)


@pytest.mark.parametrize("exact", MODES)
@pytest.mark.parametrize("wt", WAVELETS)
@pytest.mark.parametrize("shape", FRAMES32)
def test_int32_tiles_reproduce_the_full_frame_lift(jax_frames32, shape, wt, exact):
    """K7's spatial pass: int32 in and out, nothing stored between the
    axes, values far beyond int16."""
    x = torch.from_numpy(_frame32(shape))
    full = _spatial(x, wt, exact, False)
    if (shape, wt, exact) in jax_frames32:
        np.testing.assert_array_equal(full.numpy(), jax_frames32[shape, wt, exact])
    assert bool((full.abs() > 32767).any())
    assert torch.equal(_tiled(x, wt, exact, False, lift.spatial_halo(wt)), full)


@pytest.mark.parametrize("exact", MODES)
@pytest.mark.parametrize("wt", WAVELETS)
@pytest.mark.parametrize("shape", [(2, 6, 70, 260), (2, 6, 70, 264)])
def test_k7_two_passes_reproduce_the_3d_lift(shape, wt, exact):
    """K7's order of passes: forward, the tiles of every frame then the T
    lift; inverse, the T lift then the tiles; against the plain 3D lift
    (W, H, T and back).  Several tiles on each axis, ragged (W = 260) and
    clamped into the frame (W = 264)."""
    rng = np.random.default_rng(sum(shape))
    x = torch.from_numpy(rng.integers(-(1 << 20), 1 << 20, size=shape,
                                      dtype=np.int32))
    steps = lift_steps(wt, inverse=exact is not None, exact=bool(exact))
    halo = lift.spatial_halo(wt)
    fast = shape[2] >= lift._WIN_H and shape[3] % lift._SEG == 0
    assert len(lift.tile_windows(*shape[2:], halo)) == 4
    assert all((wc1 - wc0 == lift._WIN_W) == fast
               for *_, (wc0, wc1) in lift.tile_windows(*shape[2:], halo))

    def tiles(v):
        return torch.stack([torch.stack([_tiled(f, wt, exact, False, halo)
                                         for f in planes]) for planes in v])

    if exact is None:
        got, want = lift_axis(tiles(x), steps, -3), lift.forward_3d_plain(x, wt)
    else:
        got = tiles(lift_axis(x, steps, -3))
        want = lift.inverse_3d_plain(x, wt, exact=exact)
    assert torch.equal(got, want)


def test_a_smaller_halo_is_not_enough():
    """CDF 9/7's four steps reach four rows: with a halo of two, tiles
    below the first differ from the full-frame lift."""
    x = torch.from_numpy(_frame((130, 520)))
    for exact in MODES:
        full = _spatial(x, WaveletType.CDF97, exact, False)
        assert not torch.equal(_tiled(x, WaveletType.CDF97, exact, False, 2), full)


def test_tile_windows_clamp_into_large_frames():
    tiles = lift.tile_windows(1080, 1920, 2)
    assert len(tiles) == 18 * 8
    assert all(wr1 - wr0 == lift._WIN_H and wc1 - wc0 == lift._WIN_W
               for _, _, (wr0, wr1), (wc0, wc1) in tiles)


def test_reciprocal_matches_floor_division():
    """Every step 1-64 (``core.quality_to_step``'s range), every
    numerator 0..2^18, as the kernel computes it: ``umulhi(m, 2n) >> l``;
    then steps beyond (the split-frame checks use 160) on numerators
    up to 2^31 - 1."""
    n = np.arange(0, (1 << 18) + 1, dtype=np.uint64)
    for step in range(1, 65):
        m, l = lift.reciprocal(step)
        assert 1 << 31 <= m < 1 << 32
        q = ((np.uint64(m) * (n << np.uint64(1))) >> np.uint64(32)) >> np.uint64(l)
        np.testing.assert_array_equal(q, n // np.uint64(step))
    rng = np.random.default_rng(5)
    big = np.concatenate([rng.integers(0, 1 << 31, 1 << 16, dtype=np.int64),
                          (1 << 31) - 1 - np.arange(4096)]).astype(np.uint64)
    for step in (65, 160, 1000, (1 << 20) + 7, (1 << 31) - 1):
        m, l = lift.reciprocal(step)
        assert m < 1 << 32
        q = ((np.uint64(m) * (big << np.uint64(1))) >> np.uint64(32)) >> np.uint64(l)
        np.testing.assert_array_equal(q, big // np.uint64(step))


def test_quant_params_per_channel():
    qp = lift._quant_params(torch.tensor([1, 7, 64], dtype=torch.int32), 6, 3, "cpu")
    assert qp.dtype == torch.int32 and qp.shape == (3, 4)
    for row, step in zip(qp.tolist(), (1, 7, 64)):
        m, l = lift.reciprocal(step)
        assert row == [step, 6, m - (1 << 32) if m >= 1 << 31 else m, l]
    assert lift._quant_params(9, 9, 2, "cpu").tolist() == (
        lift._quant_params([9, 9], [9, 9], 2, "cpu").tolist())
    with pytest.raises(ValueError, match="step"):
        lift._quant_params(0, 0, 1, "cpu")
    with pytest.raises(ValueError, match="dead zone"):
        lift._quant_params(4, -1, 1, "cpu")


@pytest.mark.parametrize("exact", MODES)
@pytest.mark.parametrize("wt", WAVELETS)
@pytest.mark.parametrize("n", [6, 16, 18, 40, 58])
def test_axis_windows_reproduce_the_full_lift(n, wt, exact):
    """Windows of 16 along an axis of n (one window where n <= 16),
    each lifted on its own with its cut ends mirrored, keep the full
    lift in their stored spans; every position is stored once."""
    rng = np.random.default_rng(n + int(wt))
    x = torch.from_numpy(rng.integers(-(1 << 20), 1 << 20, (n, 6),
                                      dtype=np.int64).astype(np.int32))
    steps = lift_steps(wt, inverse=exact is not None, exact=bool(exact))
    halo = lift.spatial_halo(wt)
    full = lift_axis(x, steps, 0)
    out = torch.zeros_like(x)
    stored = np.zeros(n, np.int32)
    wins = lift.axis_windows(n, 16, halo)
    assert len(wins) == (1 if n <= 16 else -(-n // (16 - 2 * halo)))
    for (r0, r1), (lo, hi) in wins:
        assert lo % 2 == 0 and 0 <= lo <= r0 and r1 <= hi <= n
        assert hi - lo == min(n, 16)
        out[r0:r1] = lift_axis(x[lo:hi], steps, 0)[r0 - lo:r1 - lo]
        stored[r0:r1] += 1
    assert (stored == 1).all()
    assert torch.equal(out, full)


def test_tile_windows_are_line_windows():
    """The fused kernels' tiles are the line windows of each axis."""
    for h, w in ((10, 14), (130, 520), (1080, 1920)):
        fast = h >= lift._WIN_H and w >= lift._WIN_W and w % lift._SEG == 0
        rows = lift.line_windows(h, lift._WIN_H, 2, fast)
        cols = lift.line_windows(w, lift._WIN_W, lift._HALO_W, fast)
        assert [t[:2] for t in lift.tile_windows(h, w, 2)] == [
            ((r0, r1), (c0, c1)) for r0, r1, _ in rows for c0, c1, _ in cols]


@pytest.mark.gpu
@pytest.mark.skipif(not torch.cuda.is_available(),
                    reason="asks the CUDA library, which is built on the card")
def test_pass_windows_start_where_a_line_outgrows_shared_memory():
    """The temporal columns hold 454 frames whole; longer chunks take
    windows of frames, and K7's forward a scratch volume there (its
    temporal pass then cannot run in place); K7's inverse always takes
    one, since its tile pass cannot run in place (the library decides).
    Frames of any height and width are grids of tiles and need none."""
    for shape, fwd, inv in (((3, 64, 1080, 1920), False, True),
                            ((1, 4, 3632, 32), False, True),
                            ((1, 4, 3634, 32), False, True),
                            ((3, 16, 4320, 7680), False, True),
                            ((1, 2, 8, 58112), False, True),
                            ((1, 2, 8, 58368), False, True),
                            ((3, 454, 64, 64), False, True),
                            ((3, 456, 64, 64), True, True)):
        assert lift._k7_scratch(shape, forward=True) == fwd, shape
        assert lift._k7_scratch(shape, forward=False) == inv, shape


@pytest.mark.parametrize("shape, dtype", [
    ((3, 16, 4320, 7680), torch.int32),   # an 8K chunk's K7 volume
    ((1, 4, 3640, 32), torch.int32),
    ((1, 2, 8, 58368), torch.int32),      # a frame wider than K7's row
    ((3, 456, 64, 64), torch.int16),      # a 456-frame chunk, K1
    ((3, 456, 64, 64), torch.uint8),      # and K4
    ((3, 456, 64, 64), torch.int32),
    ((3, 1000, 16, 32), torch.int16)])
def test_cuda_shape_guard_takes_what_jax_takes(shape, dtype):
    """Shapes the JAX package's kernels take (``lift3d_ok``) pass the
    port's guard; meta tensors, so nothing is allocated."""
    itemsize = 4 if dtype == torch.int32 else 2
    assert jlift.lift3d_ok(shape, itemsize)
    lift._check_cuda_shape(torch.empty(shape, dtype=dtype, device="meta"))


def test_cuda_shape_guard_raises_at_the_grid_limit():
    for shape in ((32768, 2, 2, 2), (1, 65536, 2, 2)):
        x = torch.empty(shape, dtype=torch.int32, device="meta")
        with pytest.raises(ValueError, match="grid"):
            lift._check_cuda_shape(x)


def test_cuda_shape_guard_raises_for_frames_of_2_31_pixels():
    """The kernels index a frame with int32: H·W must stay below 2^31."""
    lift._check_cuda_shape(torch.empty((1, 1, 32768, 65535), device="meta"))
    with pytest.raises(ValueError, match="H·W"):
        lift._check_cuda_shape(torch.empty((1, 1, 32768, 65536), device="meta"))
