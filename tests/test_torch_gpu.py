"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``gpu``; every test skips where no CUDA device is present
(decided inside the ``cuda`` fixture, so every worker collects the same
tests).  A machine with a card need not have JAX, so this file imports
none; run it there with (``--noconftest`` keeps the JAX cache-clearing
fixture of ``tests/conftest.py`` out)::

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

Bit-exact everywhere.  chip_smoke.py repeats the comparisons at the main
paths' full widths."""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from alice_codec_tpu_torch import (Alc3Codec, EncodedChunk, FrameDecoder,
                                   FrameEncoder, FrequencyTable, WaveletType)
from alice_codec_tpu_torch.ops.kernels import (launch_counts, lift, rans3,
                                                rans_nway, reset_launches, sparse)
from alice_codec_tpu_torch.parallel import BatchFrameDecoder, BatchFrameEncoder
from alice_codec_tpu_torch.utils.golden import golden_rgb
from alice_codec_tpu_torch.ops.kernels.rans3 import NG
from alice_codec_tpu_torch.ops.tables_device import freq_table_device

pytestmark = pytest.mark.gpu

GOLDEN = Path(__file__).parent / "golden" / "torch"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and bool(torch.equal(a, b))


@pytest.mark.parametrize("wt", list(WaveletType))
@pytest.mark.parametrize("shape", [
    (3, 2, 2, 2), (3, 6, 38, 52), (1, 4, 70, 34),
    # tile edges of the spatial pass: one tile, ragged tiles in W and H,
    # one tile column of a 1080-row frame
    (1, 4, 34, 130), (2, 6, 70, 258), (3, 4, 1080, 136),
    # windows clamped into the frame (its fast form), and T = 64 (the
    # temporal pass in registers) with either spatial form
    (2, 4, 130, 520), (1, 64, 64, 256), (2, 64, 34, 130)])
def test_lift_kernels_match_plain(cuda, wt, shape):
    rng = np.random.default_rng(sum(shape))
    vol = torch.as_tensor(
        rng.integers(-256, 256, size=shape, dtype=np.int16), device=cuda)
    step = torch.as_tensor(rng.integers(1, 65, size=shape[0]).astype(np.int32),
                           device=cuda)
    n = lift.forward_quant.launches
    sym = lift.forward_quant(vol, wt, step, step)
    torch.cuda.synchronize()
    assert lift.forward_quant.launches == n + 1
    assert _equal(sym, lift.forward_quant_plain(vol, wt, step, step))
    # intermediates far outside int16 (wrapping at the int16 store)
    big = torch.as_tensor(
        rng.integers(-30000, 30000, size=shape, dtype=np.int16), device=cuda)
    assert _equal(lift.forward_quant(big, wt, 160, 160),
                  lift.forward_quant_plain(big, wt, 160, 160))
    rand = torch.as_tensor(rng.integers(0, 256, size=shape, dtype=np.uint8),
                           device=cuda)
    for exact in (False, True):
        for s, st in ((sym, step), (rand, 64), (rand, 160)):
            got = lift.inverse_dequant(s, wt, st, exact=exact)
            assert _equal(got, lift.inverse_dequant_plain(s, wt, st, exact=exact))


@pytest.mark.parametrize("wt", list(WaveletType))
def test_lift_tile_windows_match_kernel(cuda, wt):
    """The tile geometry tests/test_torch_lift_tiles.py holds on the CPU
    (lift.tile_windows) is the one the CUDA library launches with."""
    halo = lift.spatial_halo(wt)
    for h, w in ((2, 2), (10, 14), (34, 130), (70, 258), (64, 256), (130, 520),
                 (1080, 136), (1080, 1920), (2160, 3840)):
        assert lift.kernel_tile_windows(h, w, halo) == lift.tile_windows(h, w, halo)


def test_lift_reciprocal_exhaustive_on_card(cuda):
    """The forward kernels' multiply-high reciprocal against floor
    division for every non-negative int32 numerator, at every step 1-64
    and the larger steps the checks use."""
    assert lift.reciprocal_mismatches(list(range(1, 65)) + [160, 1000], cuda) == 0


def test_lift_fused_rejects_bad_quantizers(cuda):
    vol = torch.zeros((1, 2, 4, 4), dtype=torch.int16, device=cuda)
    with pytest.raises(ValueError, match="step"):
        lift.forward_quant(vol, WaveletType.CDF53, 0, 0)
    with pytest.raises(ValueError, match="dead zone"):
        lift.forward_quant(vol, WaveletType.CDF53, 4, -1)


@pytest.mark.parametrize("kind", ["noise", "skewed", "mixed"])
def test_rans_kernels_match_plain(cuda, kind):
    s_seg, n_seg = 24, 8
    rng = np.random.default_rng(3)
    n = 3 * n_seg * s_seg * NG
    if kind == "noise":
        sym = rng.integers(0, 256, size=n)
    else:
        sym = np.where(rng.random(n) < 0.7, 0, rng.integers(0, 40, size=n))
    sym = sym.astype(np.uint8).reshape(3 * n_seg, s_seg, NG)
    if kind == "mixed":
        sym[::3] = 0  # elided segments between coded ones
    hists = torch.stack([
        torch.bincount(torch.as_tensor(p.reshape(-1)).long(), minlength=256)
        for p in sym.reshape(3, -1)])
    freqs, cums = freq_table_device(hists)
    seg = torch.as_tensor(sym, device=cuda)
    f, c = freqs.to(cuda), cums.to(cuda)
    streams, counts = rans3.encode_words(seg, f, c)
    want_s, want_c = rans3.encode_words_plain(seg, f, c)
    assert _equal(counts, want_c) and _equal(streams, want_s)
    out = rans3.decode_words(streams, counts, f, c, s_seg=s_seg)
    assert _equal(out, rans3.decode_words_plain(streams, counts, f, c, s_seg=s_seg))
    assert _equal(out, seg)
    # the CPU (plain) path writes the same words
    cpu_s, cpu_c = rans3.encode_words(seg.cpu(), freqs, cums)
    assert _equal(cpu_s, streams.cpu()) and _equal(cpu_c, counts.cpu())


def test_rans_kernels_fold_planes_match_plain(cuda):
    """One launch over planes of different segment counts under their own
    tables, as the sparse wire codes them: a noise plane (all 128 lanes
    emit and refill in one step), a skewed one with elided segments
    between coded ones, a one-symbol one; then counts corrupted past the
    stream (decode reads zeros there), all held to the plain versions."""
    s_seg, planes = 40, (3, 2, 4, 1)
    rng = np.random.default_rng(8)
    parts = [rng.integers(0, 256, (3, s_seg, NG)),
             np.where(rng.random((2, s_seg, NG)) < 0.6, 0,
                      rng.integers(0, 30, (2, s_seg, NG))),
             np.where(rng.random((4, s_seg, NG)) < 0.9, 0,
                      rng.integers(0, 9, (4, s_seg, NG))),
             np.full((1, s_seg, NG), 7)]
    parts[2][1] = parts[2][3] = 0
    sym = np.concatenate(parts).astype(np.uint8)
    hists = torch.stack([torch.bincount(torch.as_tensor(p.reshape(-1)).long(),
                                        minlength=256) for p in parts])
    freqs, cums = (t.to(cuda) for t in freq_table_device(hists))
    seg = torch.as_tensor(sym, device=cuda)
    n = rans3.encode_words.launches, rans3.decode_words.launches
    streams, counts = rans3.encode_words(seg, freqs, cums, planes=planes)
    want_s, want_c = rans3.encode_words_plain(seg, freqs, cums, planes=planes)
    assert _equal(counts, want_c) and _equal(streams, want_s)
    assert (counts == 0).sum() == 2
    out = rans3.decode_words(streams, counts, freqs, cums, s_seg=s_seg,
                             planes=planes)
    torch.cuda.synchronize()
    assert (rans3.encode_words.launches, rans3.decode_words.launches) == (
        n[0] + 1, n[1] + 1)
    assert _equal(out, seg)
    assert _equal(out, rans3.decode_words_plain(streams, counts, freqs, cums,
                                                s_seg=s_seg, planes=planes))
    bad = counts.clone()
    bad[0] = streams.shape[1] * NG + 300
    bad[4] = 2**31 - 1
    bad[5] = -7
    assert _equal(rans3.decode_words(streams, bad, freqs, cums, s_seg=s_seg,
                                     planes=planes),
                  rans3.decode_words_plain(streams, bad, freqs, cums,
                                           s_seg=s_seg, planes=planes))


def test_rans_reciprocal_exact_on_card(cuda):
    """The encode kernel's multiply-high division against hardware
    division at every frequency 1-2048, on both sides of every multiple
    below 2^32 and on a random sample."""
    assert rans3.rcp_mismatches(cuda) == 0


def test_codec_on_card_matches_golden_and_cpu(cuda):
    man = json.loads((GOLDEN / "manifest.json").read_text())
    data = (GOLDEN / "dense.alc").read_bytes()
    codec, chunks = Alc3Codec.from_bytes(data)
    assert chunks[0].streams.is_cuda
    for mode, exact in (("compat", False), ("exact", True)):
        out = codec.decode(chunks[0], exact=exact, as_numpy=True)
        assert out.tobytes() == (GOLDEN / f"dense.{mode}.rgb").read_bytes()
    rgb = np.frombuffer((GOLDEN / "dense.compat.rgb").read_bytes(), np.uint8)
    rgb = rgb.reshape(man["t"], man["h"], man["w"], 3)
    on_card = Alc3Codec(man["quality"], man["wavelet"], s_seg=man["s_seg"])
    on_cpu = Alc3Codec(man["quality"], man["wavelet"], s_seg=man["s_seg"],
                       device="cpu")
    assert (Alc3Codec.to_bytes(on_card.encode(rgb))
            == Alc3Codec.to_bytes(on_cpu.encode(rgb)))


@pytest.mark.parametrize("density", [0.0, 0.03, 0.3, 1.0])
def test_sparse_kernels_match_plain(cuda, density):
    p = 1 << 20
    rng = np.random.default_rng(int(density * 100))
    planes = np.stack([
        np.where(rng.random(p) < d, rng.integers(1, 256, p), 0)
        for d in (density, density / 2, 0.9 * density)]).astype(np.uint8)
    sym = torch.as_tensor(planes, device=cuda)
    trows = sparse.tile_rows(sym)
    rows = trows.sum(-1).tolist()
    krs = tuple(r + 8 * (i + 1) for i, r in enumerate(rows))  # per plane
    n = sparse.compact.launches
    bm, vals = sparse.compact(sym, trows, krs)
    torch.cuda.synchronize()
    assert sparse.compact.launches == n + 1
    want_bm, want_vals = sparse.compact_plain(sym, trows, krs)
    assert _equal(bm, want_bm) and _equal(vals, want_vals)
    out = sparse.expand(bm, vals, krs)
    assert _equal(out, sparse.expand_plain(bm, vals, krs))
    assert _equal(out, sym)
    # a capacity below the rows: compact drops what does not fit
    if max(rows):
        small = tuple(max(r // 2, 1) for r in rows)
        got = sparse.compact(sym, trows, small)
        want = sparse.compact_plain(sym, trows, small)
        assert _equal(got[0], want[0]) and _equal(got[1], want[1])


def test_expand_hostile_bitmap_matches_plain(cuda):
    rng = np.random.default_rng(9)
    bm = torch.as_tensor(rng.integers(0, 256, (2, (1 << 20) // 8), dtype=np.uint8),
                         device=cuda)
    krs = (64, 1024)
    vals = torch.as_tensor(rng.integers(1, 256, (sum(krs), NG), dtype=np.uint8),
                           device=cuda)
    got = sparse.expand(bm, vals, krs)
    torch.cuda.synchronize()
    assert _equal(got, sparse.expand_plain(bm, vals, krs))


def _sparse_planes(rng, nc: int, p: int, density: float) -> np.ndarray:
    """(nc, p) uint8 symbols, plane i nonzero at density·(i+1)/nc, in
    bursts: runs of tiles at 4× the density and runs of empty tiles."""
    dens = np.repeat(rng.choice([0.0, 1.0, 4.0], p // 1024), 1024)
    return np.stack([
        np.where(rng.random(p) < np.minimum(1.0, density * (i + 1) / nc * dens),
                 rng.integers(1, 256, p), 0)
        for i in range(nc)]).astype(np.uint8)


@pytest.mark.parametrize("density", [0.0, 0.03, 0.3, 1.0])
@pytest.mark.parametrize("nc,tiles", [(1, 1), (2, 33), (5, 70), (16, 37)])
def test_sparse_scan_kernels_match_plain(cuda, density, nc, tiles):
    """Tile groups that are not whole (33, 70, 37 tiles over groups of
    32), 1-16 planes, per-plane capacities above, at and below the rows:
    the kernels' own row counts and chained scan against the plain
    versions' torch prefix."""
    rng = np.random.default_rng(nc * 100 + tiles + int(density * 10))
    sym = torch.as_tensor(_sparse_planes(rng, nc, tiles * 1024, density),
                          device=cuda)
    trows = sparse.tile_rows(sym)
    rows = trows.sum(-1).tolist()
    for krs in (tuple(r + 3 * i for i, r in enumerate(rows)),
                tuple(rows),
                tuple(max(r // 2 - i, 0) for i, r in enumerate(rows))):
        n = sparse.compact.launches
        got = sparse.compact(sym, trows, krs)
        assert sparse.compact.launches == n + 1
        want = sparse.compact_plain(sym, trows, krs)
        assert _equal(got[0], want[0]) and _equal(got[1], want[1])
        n = sparse.expand.launches
        out = sparse.expand(got[0], got[1], krs)
        torch.cuda.synchronize()
        assert sparse.expand.launches == n + 1
        assert _equal(out, sparse.expand_plain(got[0], got[1], krs))
        if krs[0] >= rows[0]:
            assert _equal(out[0], sym[0])


@pytest.mark.parametrize("pick", [(0,), (1, 2), (0, 1, 2, 3, 4, 5), (5, 2, 3)])
def test_sparse_in_place_matches_plain(cuda, pick):
    """The codec's interface: planes picked out of the phase-1 symbols,
    bitmaps and values written into one segment buffer that holds other
    bytes (the bitmap segments' tails and the value rows past the used
    ones come back zero), and the expand writing the first p < P symbols
    of each plane into rows of another tensor, at an odd p."""
    rng = np.random.default_rng(len(pick))
    tiles = 45
    p_full = tiles * 1024
    sym = torch.as_tensor(_sparse_planes(rng, 6, p_full, 0.05), device=cuda)
    trows = sparse.tile_rows(sym)
    rows = [int(trows[i].sum()) for i in pick]
    krs = tuple(r + 5 for r in rows)
    mb = p_full // 8 + 4096
    sizes = [mb] * len(pick) + [k * NG for k in krs]
    buf = torch.full((sum(sizes),), 0xA5, dtype=torch.uint8, device=cuda)
    parts = torch.split(buf, sizes)
    bm_v, val_v = list(parts[: len(pick)]), list(parts[len(pick):])
    ref = torch.full_like(buf, 0x5A)
    ref_parts = torch.split(ref, sizes)
    sparse.compact(sym, trows, krs, pick=pick, out=(bm_v, val_v))
    sparse.compact_plain(sym, trows, krs, pick=pick,
                         out=(list(ref_parts[: len(pick)]),
                              list(ref_parts[len(pick):])))
    assert _equal(buf, ref)
    p = p_full - 1000 - 3
    dec = torch.full((7, p), 0xC3, dtype=torch.uint8, device=cuda)
    rows_out = [dec[1 + i] for i in range(len(pick))]
    bms = [v[: p_full // 8] for v in bm_v]
    sparse.expand(bms, val_v, krs, out=rows_out)
    want = torch.full_like(dec, 0xC3)
    sparse.expand_plain(bms, val_v, krs, out=[want[1 + i] for i in range(len(pick))])
    assert _equal(dec, want)
    assert _equal(dec[1 : 1 + len(pick)], sym[list(pick), :p])


def test_sparse_scan_on_a_4k_chroma_plane(cuda):
    """One 4K chroma plane (16×2160×3840, padded as the sparse wire pads
    it): 4064 tile groups, many more than the card holds at once, so the
    look-back waits on groups that started long before and must always
    make progress."""
    from alice_codec_tpu_torch import alc3

    p = alc3._sparse_pp(16 * 2160 * 3840)
    rng = np.random.default_rng(44)
    sym = torch.as_tensor(_sparse_planes(rng, 1, p, 0.02), device=cuda)
    trows = sparse.tile_rows(sym)
    krs = (int(trows.sum()) + 7,)
    bm, vals = sparse.compact(sym, trows, krs)
    want = sparse.compact_plain(sym, trows, krs)
    assert _equal(bm, want[0]) and _equal(vals, want[1])
    del want
    assert _equal(sparse.expand(bm, vals, krs), sym)


def test_sparse_hostile_bitmaps_match_plain(cuda):
    """Random bitmaps on 3 planes of 37 tiles (popcounts far past the
    capacities, the last group not whole)."""
    rng = np.random.default_rng(19)
    bm = torch.as_tensor(rng.integers(0, 256, (3, 37 * NG), dtype=np.uint8),
                         device=cuda)
    for krs in ((1, 40, 300), (0, 7, 1000)):
        vals = torch.as_tensor(rng.integers(1, 256, (sum(krs), NG), dtype=np.uint8),
                               device=cuda)
        got = sparse.expand(bm, vals, krs)
        torch.cuda.synchronize()
        assert _equal(got, sparse.expand_plain(bm, vals, krs))


def test_sparse_goldens_on_card(cuda):
    """The JAX-written sparse goldens: each container decodes on the card
    to the JAX decode, and each input re-encodes to the same bytes
    through one codec per case (its capacity caches included)."""
    import hashlib

    from chip_smoke import golden_input

    sdir = GOLDEN / "sparse"
    cases = json.loads((sdir / "manifest.json").read_text())["cases"]
    for spec in cases.values():
        codec = Alc3Codec(spec["quality"], spec["wavelet"], s_seg=spec["s_seg"],
                          sparse=True)
        for ck in spec["chunks"]:
            chunk = codec.encode(golden_input(ck["kind"], ck["seed"], ck["shape"]))
            if "file" not in ck:
                continue
            data = (sdir / ck["file"]).read_bytes()
            assert list(chunk.kcaps) == ck["kcaps"]
            assert Alc3Codec.to_bytes(chunk) == data
            _, chunks = Alc3Codec.from_bytes(data)
            out = codec.decode(chunks[0], as_numpy=True)
            assert hashlib.sha256(out.tobytes()).hexdigest() == ck["rgb_sha256"]


@pytest.mark.parametrize("wt", list(WaveletType))
@pytest.mark.parametrize("shape", [
    (3, 2, 2, 2), (3, 6, 38, 52), (1, 4, 70, 34),
    # tiles clamped into the frame (the spatial pass's fast form) and T = 64
    # (the temporal pass in registers)
    (3, 64, 130, 520), (1, 64, 64, 256)])
def test_lift3d_kernels_match_plain(cuda, wt, shape):
    """K7, the plain 3D lift, on int32 volumes far beyond int16: an int16
    store between its passes would wrap here, and the plain versions
    store int32 throughout."""
    rng = np.random.default_rng(sum(shape) + int(wt))
    vol = torch.as_tensor(
        rng.integers(-(1 << 20), 1 << 20, size=shape, dtype=np.int32),
        device=cuda)
    n = (lift.forward_3d.launches, lift.inverse_3d.launches)
    fwd = lift.forward_3d(vol, wt)
    torch.cuda.synchronize()
    assert lift.forward_3d.launches == n[0] + 1
    assert _equal(fwd, lift.forward_3d_plain(vol, wt))
    assert bool((fwd.abs() > 32767).any())
    for exact in (False, True):
        for src in (fwd, vol):
            got = lift.inverse_3d(src, wt, exact=exact)
            assert _equal(got, lift.inverse_3d_plain(src, wt, exact=exact))
    assert lift.inverse_3d.launches == n[1] + 4
    assert _equal(lift.inverse_3d(fwd, wt, exact=True), vol)


def test_lift3d_rejects_shapes_it_cannot_take(cuda):
    """Only the grid limits are left (frames are lifted in tiles): C·T
    beyond 65535 raises, a tall frame runs."""
    tall = torch.zeros((1, 2, 3634, 2), dtype=torch.int32, device=cuda)
    assert _equal(lift.forward_3d(tall, WaveletType.CDF53), tall)
    many = torch.zeros((32768, 2, 2, 2), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="grid"):
        lift.inverse_3d(many, WaveletType.CDF53)


@pytest.mark.parametrize("wt", list(WaveletType))
@pytest.mark.parametrize("shape, scratch", [
    ((1, 4, 3640, 32), (False, True)),    # a tall frame
    ((1, 2, 8, 58368), (False, True))])   # a wide one
def test_lift3d_tall_and_wide_frames_match_plain(cuda, wt, shape, scratch):
    """K7 on a 3640-row and a 58368-column frame, both ordinary grids of
    tiles (one tile column; one tile row); the scratch volume (forward,
    inverse) only for the inverse, whose tile pass cannot run in place."""
    assert (lift._k7_scratch(shape, forward=True),
            lift._k7_scratch(shape, forward=False)) == scratch
    rng = np.random.default_rng(int(wt) + shape[2])
    vol = torch.as_tensor(
        rng.integers(-(1 << 20), 1 << 20, size=shape, dtype=np.int32), device=cuda)
    fwd = lift.forward_3d(vol, wt)
    assert _equal(fwd, lift.forward_3d_plain(vol, wt))
    for exact in (False, True):
        for src in (fwd, vol):
            assert _equal(lift.inverse_3d(src, wt, exact=exact),
                          lift.inverse_3d_plain(src, wt, exact=exact))
    assert _equal(lift.inverse_3d(fwd, wt, exact=True), vol)


def test_lift3d_raises_for_steps_of_no_filter(cuda, monkeypatch):
    """The kernels take the three wavelets' steps only (the filter is a
    template argument): other steps make the library refuse the launch,
    and the wrapper raises without counting it."""
    vol = torch.zeros((1, 64, 64, 256), dtype=torch.int32, device=cuda)
    steps = lift.lift_steps(WaveletType.CDF53)
    monkeypatch.setattr(lift, "lift_steps", lambda *a, **kw: (
        (steps[0][0] + 1, *steps[0][1:]), *steps[1:]))
    n = (lift.forward_3d.launches, lift.inverse_3d.launches)
    with pytest.raises(RuntimeError, match="forward_3d: CUDA error"):
        lift.forward_3d(vol, WaveletType.CDF53)
    with pytest.raises(RuntimeError, match="inverse_3d: CUDA error"):
        lift.inverse_3d(vol, WaveletType.CDF53)
    assert (lift.forward_3d.launches, lift.inverse_3d.launches) == n


@pytest.mark.parametrize("wt", list(WaveletType))
def test_lift_axis_windows_match_kernel(cuda, wt):
    """The window geometry tests/test_torch_lift_tiles.py holds on the
    CPU (lift.axis_windows) is the one the CUDA library launches with."""
    halo = lift.spatial_halo(wt)
    for n, win in ((6, 16), (16, 16), (18, 16), (58, 16), (3640, 256),
                   (456, 64), (1000, 64), (58368, 8192), (3632, 3632)):
        assert lift.kernel_axis_windows(n, win, halo) == lift.axis_windows(n, win, halo)


@pytest.mark.parametrize("wt", list(WaveletType))
@pytest.mark.parametrize("t", [456, 1000])
def test_lift_long_chunks_match_plain(cuda, t, wt):
    """K1 / K4 and K7 on chunks longer than their temporal columns hold
    (454 frames): the temporal pass in windows of frames with a halo."""
    shape = (2, t, 8, 32)
    rng = np.random.default_rng(t + int(wt))
    vol = torch.as_tensor(rng.integers(-30000, 30000, size=shape, dtype=np.int16),
                          device=cuda)
    step = torch.as_tensor([7, 160], dtype=torch.int32, device=cuda)
    sym = lift.forward_quant(vol, wt, step, step)
    assert _equal(sym, lift.forward_quant_plain(vol, wt, step, step))
    rand = torch.as_tensor(rng.integers(0, 256, size=shape, dtype=np.uint8),
                           device=cuda)
    for exact in (False, True):
        for s, st in ((sym, step), (rand, 160)):
            assert _equal(lift.inverse_dequant(s, wt, st, exact=exact),
                          lift.inverse_dequant_plain(s, wt, st, exact=exact))
    big = torch.as_tensor(
        rng.integers(-(1 << 20), 1 << 20, size=shape, dtype=np.int32), device=cuda)
    fwd = lift.forward_3d(big, wt)
    assert _equal(fwd, lift.forward_3d_plain(big, wt))
    for exact in (False, True):
        assert _equal(lift.inverse_3d(fwd, wt, exact=exact),
                      lift.inverse_3d_plain(fwd, wt, exact=exact))


def test_long_chunk_codec_on_card_matches_cpu(cuda):
    """A 456-frame chunk (fused kernels with windowed temporal passes):
    the container the card writes is the CPU's, and it decodes alike."""
    from chip_smoke import golden_input

    rgb = golden_input("chunk", 5, (456, 64, 64))
    on_card, on_cpu = Alc3Codec(90), Alc3Codec(90, device="cpu")
    card_chunk, cpu_chunk = on_card.encode(rgb), on_cpu.encode(rgb)
    assert Alc3Codec.to_bytes(card_chunk) == Alc3Codec.to_bytes(cpu_chunk)
    np.testing.assert_array_equal(on_card.decode(card_chunk, as_numpy=True),
                                  on_cpu.decode(cpu_chunk, as_numpy=True))


def test_mode_goldens_on_card(cuda):
    """The JAX-written goldens of the sparse mode compositions (deep, rdo,
    levels): each input re-encodes on the card to the same bytes and each
    container decodes to the JAX decodes, in both inverse modes."""
    import hashlib

    from chip_smoke import golden_input

    mdir = GOLDEN / "modes"
    cases = json.loads((mdir / "manifest.json").read_text())["cases"]
    for spec in cases.values():
        codec = Alc3Codec(**spec["codec"])
        chunk = codec.encode(golden_input(spec["kind"], spec["seed"],
                                          spec["shape"]))
        data = (mdir / spec["file"]).read_bytes()
        assert list(chunk.kcaps) == spec["kcaps"]
        assert Alc3Codec.to_bytes(chunk) == data
        _, chunks = Alc3Codec.from_bytes(data)
        for exact, key in ((False, "rgb_sha256"), (True, "rgb_exact_sha256")):
            out = codec.decode(chunks[0], exact=exact, as_numpy=True)
            assert hashlib.sha256(out.tobytes()).hexdigest() == spec[key]


@pytest.mark.parametrize("kwargs", [
    dict(quality=100, wavelet="haar"), dict(quality=85, rdo=True),
    dict(quality=90, wavelet="cdf97", levels=3)])
def test_dense_modes_on_card_match_cpu(cuda, kwargs):
    """The dense deep, rdo and multi-level codecs on the card write the
    CPU's bytes and decode to the CPU's RGB."""
    from chip_smoke import golden_input

    rgb = golden_input("chunk", 9, (4, 16, 16))
    on_card = Alc3Codec(s_seg=8, **kwargs)
    on_cpu = Alc3Codec(s_seg=8, device="cpu", **kwargs)
    card_chunk, cpu_chunk = on_card.encode(rgb), on_cpu.encode(rgb)
    assert Alc3Codec.to_bytes(card_chunk) == Alc3Codec.to_bytes(cpu_chunk)
    for exact in (False, True):
        np.testing.assert_array_equal(
            on_card.decode(card_chunk, exact=exact, as_numpy=True),
            on_cpu.decode(cpu_chunk, exact=exact, as_numpy=True))


@pytest.mark.parametrize("shape", [(3, 4, 16, 256), (2, 4, 130, 520)])
def test_split_frame_lift_kernels_match_plain(cuda, monkeypatch, shape):
    """The fused kernels' split-frame form (int16 stored between the W and
    H passes, as the TPU's split spatial path stores it at 4K), forced at
    a small shape by cutting the frame budget, on inputs whose spatial
    intermediates leave int16 (the second shape takes the kernel's fast
    form, windows clamped into the frame)."""
    monkeypatch.setattr(lift, "_FRAME_BYTES", 1024)
    assert lift.split_frame(*shape[2:])
    rng = np.random.default_rng(23)
    vol = torch.as_tensor(rng.integers(-30000, 30000, size=shape, dtype=np.int16),
                          device=cuda)
    sym = torch.as_tensor(rng.integers(0, 256, size=shape, dtype=np.uint8),
                          device=cuda)
    for wt in WaveletType:
        assert _equal(lift.forward_quant(vol, wt, 160, 160),
                      lift.forward_quant_plain(vol, wt, 160, 160))
        for exact in (False, True):
            assert _equal(lift.inverse_dequant(sym, wt, 160, exact=exact),
                          lift.inverse_dequant_plain(sym, wt, 160, exact=exact))


def _nway_streams(lanes: int, steps: int, seed: int, n_streams: int = 3):
    """``n_streams`` streams of ``steps`` x ``lanes`` symbols with their
    sanitized tables, cycling through a one-symbol table (symbol 7 only in
    its histogram), a uniform one and a skewed one (symbol 0 dominant; half
    the symbols drawn from the rare ones, forcing two-byte emits); a
    single stream is the skewed one."""
    rng = np.random.default_rng(seed)
    n = lanes * steps
    one = np.zeros(256, np.uint32)
    one[7] = 1000
    skew = np.zeros(256, np.uint32)
    skew[0] = 1 << 20
    skew[1:40] = 1
    hists = [one, np.full(256, 5, np.uint32), skew]
    kinds = [2] if n_streams == 1 else [i % 3 for i in range(n_streams)]
    syms = [[np.where(rng.random(n) < 0.95, 7, rng.integers(0, 256, n)),
             rng.integers(0, 256, n),
             np.where(rng.random(n) < 0.5, 0, rng.integers(1, 256, n))][k]
            for k in kinds]
    tables = [FrequencyTable.from_histogram(hists[k], sanitize=True) for k in kinds]
    return np.stack(syms).astype(np.uint8), tables


def _tables(tables, dev):
    f = torch.as_tensor(np.stack([t.freqs for t in tables]).astype(np.int32), device=dev)
    c = torch.as_tensor(np.stack([t.cums for t in tables]).astype(np.int32), device=dev)
    lut = torch.as_tensor(np.stack([t.cum_to_sym for t in tables]), device=dev)
    return f, c, lut


def _spread(payload, lens, seed):
    """The lanes of a packed payload moved apart by gaps of 0-3 bytes, so
    that they start at every offset in a word: ``(data, starts)``."""
    rng = np.random.default_rng(seed)
    gaps = torch.as_tensor(rng.integers(0, 4, lens.numel()), device=lens.device)
    flat = lens.reshape(-1).long()
    starts = rans_nway.lane_offsets(lens) + torch.cumsum(gaps, 0)
    lane = torch.repeat_interleave(torch.arange(flat.numel(), device=lens.device), flat)
    pos = torch.arange(payload.numel(), device=lens.device) - (
        rans_nway.lane_offsets(lens) - starts)[lane]
    data = torch.zeros(int((starts + flat).max()), dtype=torch.uint8,
                       device=lens.device)
    data[pos] = payload
    return data, starts.reshape(lens.shape)


@pytest.mark.parametrize("n_streams", [1, 13])
@pytest.mark.parametrize("steps", [1, 7, 32400])
@pytest.mark.parametrize("lanes", [1, 33, 4096])
def test_rans_nway_kernels_match_plain(cuda, lanes, steps, n_streams):
    """K8 (the packed route and the per-step layout) and K9 against their
    plain versions, one launch each over every stream; K9 decodes K8's
    payload back to the symbols, and decodes lanes that start 1-3 bytes
    past a word, are cut short, are shorter than their state or empty,
    the last one ending the payload, as the plain version does."""
    sym_np, tables = _nway_streams(lanes, steps, lanes + steps, n_streams)
    sym = torch.as_tensor(sym_np, device=cuda)
    f, c, lut = _tables(tables, cuda)
    n = rans_nway.encode_nway.launches
    got = rans_nway.encode_nway(sym, f, c, n_lanes=lanes)
    torch.cuda.synchronize()
    assert rans_nway.encode_nway.launches == n + 1
    plain = rans_nway.encode_nway_plain(sym, f, c, n_lanes=lanes)
    for a, b in zip(got, plain):
        assert _equal(a, b)
    skewed = [i for i, t in enumerate(tables) if t.freqs[0] > 3000]
    if steps == 32400 and lanes > 1:
        assert bool((plain[1][skewed] == 2).any())  # the skewed streams emit pairs
    del got
    n = rans_nway.encode_pack_nway.launches
    packed = rans_nway.encode_pack_nway(sym, f, c, n_lanes=lanes)
    torch.cuda.synchronize()
    assert rans_nway.encode_pack_nway.launches == n + 1
    for a, b in zip(packed, rans_nway.pack_streams(*plain)):
        assert _equal(a, b)
    del plain
    payload, lens, _ = packed
    starts = rans_nway.lane_offsets(lens).reshape(lens.shape)
    n = rans_nway.decode_nway.launches
    out = rans_nway.decode_nway(payload, starts, lens, f, c, lut, steps=steps)
    torch.cuda.synchronize()
    assert rans_nway.decode_nway.launches == n + 1
    assert _equal(out.reshape(n_streams, -1), sym)
    data, starts = _spread(payload, lens, steps)
    cut = lens.clone()
    cut[0, 0] = 3
    cut[-1, 0] = 0
    cut[n_streams // 2, -1] = 9
    cut[-1, -1] = 2
    data = data[: int(starts[-1, -1]) + 2]
    assert _equal(rans_nway.decode_nway(data, starts, cut, f, c, lut, steps=steps),
                  rans_nway.decode_nway_plain(data, starts, cut, f, c, lut,
                                              steps=steps))


def test_rans_nway_kernels_reject_bad_shapes(cuda):
    sym = torch.zeros(2, 30, dtype=torch.uint8, device=cuda)
    f = torch.ones(2, 256, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="multiple"):
        rans_nway.encode_nway(sym, f, f, n_lanes=7)
    with pytest.raises(ValueError, match="expected"):
        rans_nway.encode_nway(sym, f[:1], f[:1], n_lanes=5)
    with pytest.raises(ValueError, match="multiple"):
        rans_nway.encode_pack_nway(sym, f, f, n_lanes=7)
    with pytest.raises(ValueError, match="expected"):
        rans_nway.encode_pack_nway(sym, f[:1], f[:1], n_lanes=5)


def _golden_records(kind: str):
    d = Path(__file__).parent / "golden" / kind
    return d, json.loads((d / "manifest.json").read_text())["fixtures"]


@pytest.mark.parametrize("kind", ["cpp", "self"])
def test_alc_goldens_on_card(cuda, kind):
    """Every committed `.alc` fixture decodes on the card to its committed
    RGB (or digest), and the fixture input re-encodes to its bytes."""
    d, recs = _golden_records(kind)
    enc_dec = FrameDecoder()
    for rec in recs:
        data = (d / f"{rec['name']}.alc").read_bytes()
        out = enc_dec.decode(EncodedChunk.from_bytes(data))
        assert hashlib.sha256(out.tobytes()).hexdigest() == rec["rgb_sha256"], rec["name"]
        rgb = golden_rgb(rec["w"], rec["h"], rec["f"])
        chunk = FrameEncoder(rec["quality"], rec["wavelet"]).encode(
            rgb, rec["w"], rec["h"], rec["f"])
        assert chunk.to_bytes() == data, rec["name"]


def test_alc2_full_width_device_entropy_matches_host(cuda):
    """One 64x1080x1920 chunk at 4096 lanes: the device-entropy ALC2
    payload (K8's packed route, one call) equals the host native coder's,
    and each decoder decodes the other's to the same RGB."""
    import bench

    batch = bench._test_chunk(64, 1080, 1920)[None]
    dev = BatchFrameEncoder(90, "cdf53", n_lanes=4096, device_entropy=True)
    host = BatchFrameEncoder(90, "cdf53", n_lanes=4096)
    reset_launches()
    s_dev = dev.encode(batch)
    assert launch_counts()["encode_pack_nway"] == 1
    assert launch_counts()["encode_nway"] == 0
    s_host = host.encode(batch)
    assert s_dev.to_bytes() == s_host.to_bytes()
    out_dev = BatchFrameDecoder(device_entropy=True).decode(s_host, as_numpy=False)
    out_host = BatchFrameDecoder().decode(s_dev, as_numpy=False)
    assert _equal(out_dev, out_host)


# ── batches and chunk meshes ────────────────────────────────────


def test_batch_goldens_on_card(cuda):
    """The JAX-written batch goldens on the card: each batch re-encodes to
    the same containers (the sparse caches and the active-set re-dispatch
    included) and decodes to JAX's decode_batch, both ways; a case's mesh
    repeats the card as often as the JAX mesh has devices."""
    import torch_batch_goldens as tg

    for spec in tg.CASES.values():
        tg.check_encodes(spec, tg.run(spec, tg.cpu_mesh(spec["mesh"], cuda), cuda))
        tg.check_decodes(spec, cuda)


@pytest.mark.parametrize("quality, sparse", [(90, False), (90, True), (50, True)])
def test_batch_and_mesh_on_card_match_cpu(cuda, quality, sparse):
    """A batch of two on the card: K1 / K4 once a chunk, the word-rANS
    kernels (and, sparse, K5 / K6) once a batch; the
    containers and RGB are the CPU's (the plain versions'), also over
    ``chunk_mesh()`` against as many CPU entries."""
    from alice_codec_tpu_torch.parallel import chunk_mesh
    from chip_smoke import golden_input

    rgb = np.stack([golden_input("chunk", s, (4, 64, 64)) for s in (0, 1)])
    card = Alc3Codec(quality, s_seg=8, sparse=sparse)
    cpu = Alc3Codec(quality, s_seg=8, sparse=sparse, device="cpu")
    reset_launches()
    chunks = card.encode_batch(rgb)
    out = card.decode_batch(chunks)
    torch.cuda.synchronize()
    n = launch_counts()
    assert n["encode_words"] == n["decode_words"] == 1
    assert n["forward_quant"] == n["inverse_dequant"] == 2
    # at 4×64×64 every sparse plane is sparse (its values fill far fewer
    # rows than DENSE_ROW_FRAC of its padded plane)
    assert n["compact"] == n["expand"] == int(sparse)
    cpu_chunks = cpu.encode_batch(rgb)
    assert ([Alc3Codec.to_bytes(c) for c in chunks]
            == [Alc3Codec.to_bytes(c) for c in cpu_chunks])
    assert _equal(out.cpu(), cpu.decode_batch(cpu_chunks))
    mesh = chunk_mesh()
    cpu_mesh = chunk_mesh(devices=["cpu"] * mesh.size)
    rgb = np.stack([golden_input("chunk", s, (4, 64, 64))
                    for s in range(mesh.size * max(1, 2 // mesh.size))])
    m_chunks = card.encode_batch(rgb, mesh=mesh)
    c_chunks = cpu.encode_batch(rgb, mesh=cpu_mesh)
    assert ([Alc3Codec.to_bytes(c) for c in m_chunks]
            == [Alc3Codec.to_bytes(c) for c in c_chunks])
    assert _equal(card.decode_batch(m_chunks, mesh=mesh).cpu(),
                  cpu.decode_batch(c_chunks, mesh=cpu_mesh))


# ── quality, rate, segmentation and the reference-layout wavelets ──


@pytest.mark.parametrize("shape", [(24, 40), (3, 21, 37), (7, 7), (1080, 1920),
                                   (64, 96)])
def test_device_metrics_on_card_match_cpu(cuda, shape):
    """``psnr_device`` / ``ssim_device`` / ``ms_ssim_device`` on the card
    against their CPU runs (f32 reductions in another order: 1e-4 dB,
    1e-5), on uint8 and on float32 planes (bench.py config3's form)."""
    from alice_codec_tpu_torch.metrics import psnr_device
    from alice_codec_tpu_torch.ssim import ms_ssim_device, ssim_device

    rng = np.random.default_rng(sum(shape))
    a = rng.integers(0, 256, shape, dtype=np.uint8)
    b = np.clip(a.astype(np.int64) + rng.integers(-12, 13, shape), 0, 255
                ).astype(np.uint8)
    for x, y in ((a, b), (a.astype(np.float32), b.astype(np.float32))):
        cx, cy = torch.from_numpy(x), torch.from_numpy(y)
        gx, gy = cx.to(cuda), cy.to(cuda)
        p = psnr_device(gx, gy)
        assert p.device.type == "cuda"
        assert abs(float(p) - float(psnr_device(cx, cy))) < 1e-4
        for fn in (ssim_device, ms_ssim_device):
            got = fn(gx, gy)
            assert got.device.type == "cuda"
            np.testing.assert_allclose(got.cpu().numpy(), fn(cx, cy).numpy(),
                                       rtol=0, atol=1e-5)
    assert torch.isinf(psnr_device(torch.from_numpy(a).to(cuda),
                                   torch.from_numpy(a).to(cuda)))


@pytest.mark.parametrize("radii", [(0, 0), (2, 1), (3, 2)])
def test_segmentation_on_card_matches_cpu(cuda, radii):
    """The motion and chroma mask programs on the card (the default
    device) give the CPU's masks, bboxes and counts, at 24×40 and 4K."""
    from alice_codec_tpu_torch import segment

    for h, w in ((24, 40), (2160, 3840)):
        rng = np.random.default_rng(h)
        ref = rng.integers(0, 256, (h, w), dtype=np.uint8)
        cur = np.clip(ref.astype(np.int64) + rng.integers(-30, 31, (h, w)),
                      0, 255).astype(np.uint8)
        cur[: h // 4, w - w // 5:] = 255 - cur[: h // 4, w - w // 5:]  # edges
        cfg = segment.SegmentConfig(dilate_radius=radii[0], erode_radius=radii[1])
        got = segment.segment_by_motion(cur, ref, w, h, cfg)
        want = segment.segment_by_motion(cur, ref, w, h, cfg, device="cpu")
        np.testing.assert_array_equal(got.mask, want.mask)
        assert (got.bbox, got.foreground_count) == (want.bbox, want.foreground_count)
        cg = rng.integers(-60, 120, (h, w)).astype(np.int16)
        for threshold in (-12, 30):
            mask, bbox, fg = segment.chroma_mask_device(
                cg, threshold, dilate_radius=radii[0], erode_radius=radii[1])
            assert mask.device.type == "cuda"
            c_mask, c_bbox, c_fg = segment.chroma_mask_device(
                cg, threshold, dilate_radius=radii[0], erode_radius=radii[1],
                device="cpu")
            assert _equal(mask.cpu(), c_mask) and _equal(bbox.cpu(), c_bbox)
            assert int(fg) == int(c_fg)


@pytest.mark.parametrize("wt", list(WaveletType))
def test_reference_wavelets_on_card_match_cpu(cuda, wt):
    """``Wavelet1D`` / ``2D`` / ``3D`` (the reference layout, any size) and
    the multi-level transform on the card, bit for bit against the CPU."""
    from alice_codec_tpu_torch.ops import wavelet

    rng = np.random.default_rng(int(wt))
    for cls, shape in ((wavelet.Wavelet1D, (3, 17)), (wavelet.Wavelet2D, (37, 70)),
                       (wavelet.Wavelet3D, (5, 38, 51)), (wavelet.Wavelet3D, (4, 64, 64))):
        x = rng.integers(-30000, 30000, shape).astype(np.int32)
        card, cpu = cls(wt), cls(wt, device="cpu")
        assert card.device.type == "cuda"
        f = card.forward(x)
        np.testing.assert_array_equal(f, cpu.forward(x))
        for exact in (False, True):
            np.testing.assert_array_equal(card.inverse(f, exact=exact),
                                          cpu.inverse(f, exact=exact))
    v = torch.as_tensor(rng.integers(-3000, 3000, (8, 32, 32)).astype(np.int32))
    got = wavelet.forward_3d_multi(v.to(cuda), wt, 3)
    assert _equal(got.cpu(), wavelet.forward_3d_multi(v, wt, 3))
    assert _equal(wavelet.inverse_3d_multi(got, wt, 3, exact=True).cpu(), v)


def test_dense_cdf97_on_card_matches_plain(cuda):
    """bench.py config3's codec in small: a dense level-1 ``cdf97`` chunk on
    the card launches K1-K4 once each and writes the bytes of, and decodes
    to the RGB of, the plain pipeline on the CPU, at both ends of the
    sweep; ``profiling.trace`` records the roundtrip's kernels."""
    import json as _json
    import tempfile

    from alice_codec_tpu_torch import profiling
    from chip_smoke import golden_input

    rgb = golden_input("chunk", 3, (6, 36, 70))
    for q in (50, 95):
        card, cpu = Alc3Codec(q, "cdf97", s_seg=16), Alc3Codec(q, "cdf97", s_seg=16,
                                                               device="cpu")
        reset_launches()
        chunk = card.encode(rgb)
        out = card.decode(chunk)
        torch.cuda.synchronize()
        n = launch_counts()
        assert all(n[k] == (1 if k in ("forward_quant", "encode_words",
                                       "decode_words", "inverse_dequant") else 0)
                   for k in n), n
        cpu_chunk = cpu.encode(rgb)
        assert Alc3Codec.to_bytes(chunk) == Alc3Codec.to_bytes(cpu_chunk)
        assert _equal(out.cpu(), cpu.decode(cpu_chunk))
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace(tmp):
            card.decode(card.encode(rgb))
            torch.cuda.synchronize()
        events = _json.loads((Path(tmp) / "trace.json").read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("decode_words" in n for n in names), sorted(names)[:20]


# ── the tools on the card ───────────────────────────────────────


@pytest.mark.parametrize("flags, enc_want, dec_want", [
    ([], {"forward_quant": 1}, {"inverse_3d": 1}),
    (["--format", "alc3", "--sparse", "-q", "50", "--s-seg", "8"],
     {"forward_quant": 1, "encode_words": 1, "compact": 1},
     {"decode_words": 1, "expand": 1, "inverse_dequant": 1}),
    (["--format", "alc3", "--s-seg", "8", "--chunk-size", "4"],
     {"forward_quant": 2, "encode_words": 2},
     {"decode_words": 2, "inverse_dequant": 2}),
])
def test_cli_on_card_matches_cpu(cuda, tmp_path, flags, enc_want, dec_want):
    """The CLI without ``--device`` codes on the card, with each path's
    launches, and writes the bytes and RGB of its ``--device cpu`` run."""
    from alice_codec_tpu_torch import cli
    from chip_smoke import golden_input

    t, h, w = 8, 256, 256  # sparse golden case a's input: q=50 compacts a plane
    (tmp_path / "in.rgb").write_bytes(golden_input("chunk", 0, (t, h, w)).tobytes())
    files = {}
    for name, extra in (("card", []), ("cpu", ["--device", "cpu"])):
        reset_launches()
        assert cli.main(["encode", str(tmp_path / "in.rgb"), "-o",
                         str(tmp_path / f"{name}.alc"), "-W", str(w), "-H", str(h),
                         "-f", str(t), *flags, *extra]) == 0
        enc = launch_counts()
        reset_launches()
        assert cli.main(["decode", str(tmp_path / f"{name}.alc"), "-o",
                         str(tmp_path / f"{name}.rgb"), *extra]) == 0
        torch.cuda.synchronize()
        dec = launch_counts()
        if name == "card":
            assert all(enc[k] == enc_want.get(k, 0) for k in enc), enc
            assert all(dec[k] == dec_want.get(k, 0) for k in dec), dec
        else:
            assert not any(enc.values()) and not any(dec.values())
        files[name] = [(tmp_path / f"{name}{s}").read_bytes() for s in (".alc", ".rgb")]
    assert files["card"] == files["cpu"]


def test_ffi_on_card_matches_cpu(cuda):
    """The C ABI shim codes on the card unless asked for the CPU: the same
    bytes and RGB, K1 on encode and K7's inverse on decode."""
    import ctypes

    from alice_codec_tpu_torch import ffi
    from chip_smoke import golden_input

    t, h, w = 4, 40, 72
    rgb = golden_input("chunk", 1, (t, h, w)).reshape(-1)
    ptr = rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    got = {}
    for dev in (None, "cpu"):
        lib = ffi.get_ffi_lib(device=dev)
        enc = lib.alice_codec_encoder_create(90)
        reset_launches()
        chunk = lib.alice_codec_encode(enc, ptr, rgb.size, w, h, t)
        assert chunk
        n = ctypes.c_uint32(0)
        data_ptr = lib.alice_codec_chunk_to_bytes(chunk, ctypes.byref(n))
        data = ctypes.string_at(data_ptr, n.value)
        lib.alice_codec_data_free(data_ptr, n.value)
        out_ptr = lib.alice_codec_decode(chunk, ctypes.byref(n))
        out = ctypes.string_at(out_ptr, n.value)
        lib.alice_codec_data_free(out_ptr, n.value)
        torch.cuda.synchronize()
        counts = launch_counts()
        want = {"forward_quant": 1, "inverse_3d": 1} if dev is None else {}
        assert all(counts[k] == want.get(k, 0) for k in counts), counts
        lib.alice_codec_chunk_destroy(chunk)
        lib.alice_codec_encoder_destroy(enc)
        got[dev] = (data, out)
    ffi.get_ffi_lib()
    assert got[None] == got["cpu"] and len(got[None][1]) == rgb.size


def test_ml_bridge_and_cache_on_card_match_cpu(cuda):
    """The ML bridge on the card, with the matmul precision set to its
    lowest: integer features below 2^14 (past TF32's mantissa; every
    partial sum exact) give the CPU's logits exactly, float32 features stay
    within the float32 summation bound of the float64 products on both
    sides; the frame cache keeps a CUDA frame where it is."""
    from alice_codec_tpu_torch.bridges import cache, ml

    rng = np.random.default_rng(5)
    n = 300
    w = rng.integers(-1, 2, (16, n)).astype(np.int8)
    gamma = n * 2.0**-24 / (1 - n * 2.0**-24)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        card, cpu = (ml.SubBandClassifier(w, n, 16, device=d) for d in (cuda, "cpu"))
        mv_card, mv_cpu = (ml.MotionPredictor(w[:2], n, device=d) for d in (cuda, "cpu"))
        for x in (rng.integers(-16000, 16000, n).astype(np.float32),
                  rng.standard_normal(n).astype(np.float32) * 40):
            a, b = np.zeros(16, np.float32), np.zeros(16, np.float32)
            card.classify_logits(x, a)
            cpu.classify_logits(x, b)
            mv = np.array([mv_card.predict(x), mv_cpu.predict(x)])
            ref = w @ x.astype(np.float64)
            bound = gamma * (np.abs(w) @ np.abs(x.astype(np.float64)))
            if (x == np.round(x)).all():
                np.testing.assert_array_equal(a, ref)
                np.testing.assert_array_equal(b, ref)
                np.testing.assert_array_equal(mv, np.stack([ref[:2]] * 2))
                assert card.classify(x) == cpu.classify(x)
            else:
                for got in (a, b):
                    assert (np.abs(got - ref) <= bound).all()
                assert (np.abs(mv - ref[:2]) <= bound[:2]).all()
    finally:
        torch.set_float32_matmul_precision(prev)
    fc = cache.FrameCache(2)
    frame = torch.arange(24, dtype=torch.uint8, device=cuda).reshape(2, 4, 3)
    fc.put(0, 0, 90, frame, 4, 2)
    got = fc.get(0, 0, 90).data
    assert got.device == frame.device and got.data_ptr() == frame.data_ptr()
