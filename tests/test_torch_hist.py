"""Plane statistics (``ops/kernels/hist.py``): the sampling rule the
histograms follow (a wire rule), the coverage floor from a given maximum,
a model of how the kernel (``csrc/hist.cu``) splits a plane into edge bytes
and 16-byte vectors, and the kernel itself against its plain version on
the card.

The tests marked ``gpu`` skip where no CUDA device is present (decided
inside the ``cuda`` fixture); this file imports no JAX, so on the card::

    python -m pytest --noconftest -m gpu tests/test_torch_hist.py -q
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from alice_codec_tpu_torch import WaveletType, alc3, pipeline
from alice_codec_tpu_torch.ops import quant
from alice_codec_tpu_torch.ops.kernels import hist, launch_counts
from alice_codec_tpu_torch.ops.kernels.hist import (plane_stats,
                                                    plane_stats_plain, sampled)

NG = 128
CSRC = Path(hist.__file__).resolve().parents[2] / "csrc" / "hist.cu"


def _bincount(x: np.ndarray) -> np.ndarray:
    return np.bincount(x.reshape(-1), minlength=256).astype(np.int64)


def _rows_hist(x: np.ndarray, starts) -> np.ndarray:
    return _bincount(np.concatenate([x[s : s + NG] for s in starts]))


def _plane(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)


# ── the sampling rule (plain path) ──────────────────────────────


@pytest.mark.parametrize("extra", [0, 1, 300, 16 * NG - 1])
def test_tail_after_last_whole_block_is_dropped(extra):
    blk = 16 * NG
    x = _plane(3 * blk + extra, extra)
    want = _rows_hist(x, [0, blk, 2 * blk])
    got = plane_stats_plain([torch.from_numpy(x)], 16)[0][0].numpy()
    np.testing.assert_array_equal(got, want)
    assert got.sum() == 3 * NG


@pytest.mark.parametrize("n", [1, 15, NG, 16 * NG - 1])
def test_plane_shorter_than_one_block_is_counted_whole(n):
    x = _plane(n, n)
    got = plane_stats(torch.from_numpy(x)[None], 16)[0][0].numpy()
    np.testing.assert_array_equal(got, _bincount(x))


@pytest.mark.parametrize("stride", [0, 1])
def test_stride_one_counts_every_symbol(stride):
    x = _plane(5 * 16 * NG + 77, 5)
    got = plane_stats_plain([torch.from_numpy(x)], stride)[0][0].numpy()
    np.testing.assert_array_equal(got, _bincount(x))


@pytest.mark.parametrize("stride", [2, 16])
def test_hist_sample_is_the_rule_on_each_row(stride):
    x = np.stack([_plane(7 * stride * NG + 5, s) for s in range(3)])
    got = pipeline._hist_sample(torch.from_numpy(x), stride).numpy()
    for row, plane in zip(got, x):
        np.testing.assert_array_equal(
            row, sampled(torch.from_numpy(plane), stride).numpy())
        assert row.size == alc3._sampled_len(plane.size, stride)


def test_plain_stats_of_views_of_any_length():
    buf = torch.from_numpy(_plane(40_000, 9))
    views = [buf[3:3 + 20_000], buf[20_003:20_004], buf[20_010:], buf[:0]]
    hists, maxima = plane_stats(views, 16)
    assert hists.dtype == maxima.dtype == torch.int64
    assert hists.shape == (4, 256) and maxima.shape == (4,)
    for h, m, v in zip(hists, maxima, views):
        np.testing.assert_array_equal(
            h.numpy(), _bincount(sampled(v, 16).numpy()))
        assert int(m) == (int(v.max()) if v.numel() else 0)


def test_cpu_path_counts_no_launch():
    before = plane_stats.launches
    plane_stats(torch.zeros((2, 100), dtype=torch.uint8), 16)
    quant.build_histogram(torch.zeros(10, dtype=torch.uint8))
    assert plane_stats.launches == before
    assert "plane_stats" not in launch_counts()


def test_build_histogram_is_bincount():
    x = torch.from_numpy(_plane(3 * 1000, 3)).reshape(3, 1000)
    np.testing.assert_array_equal(quant.build_histogram(x).numpy(),
                                  _bincount(x.numpy()))


@pytest.mark.parametrize("top", [0, 1, 7, 255])
def test_covered_hist_from_a_given_maximum(top):
    rng = np.random.default_rng(top)
    sym = torch.from_numpy(rng.integers(0, top + 1, (3, 5000), dtype=np.uint8))
    hists, maxima = plane_stats(sym, 16)
    # the amax form the coverage floor had before it took the maximum
    mx = sym.amax(dim=-1).to(torch.int64)
    idx = torch.arange(256)
    want = torch.where(idx[None, :] <= mx[:, None], hists.clamp(min=1), hists)
    assert torch.equal(maxima, mx)
    assert torch.equal(alc3._covered_hist(hists, maxima), want)


def test_encode_stages_return_the_maxima():
    rgb = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (4, 16, 16, 3), dtype=np.uint8))
    kw = dict(wavelet_type=WaveletType.CDF53, padded=(16, 16, 4),
              hist_stride=16)
    for fn in (pipeline.encode_device, pipeline.encode_deep_device):
        planes, hists, maxima = fn(rgb, 8, 8, **kw)
        np.testing.assert_array_equal(
            hists.numpy(), [_bincount(r) for r in sampled(planes, 16).numpy()])
        assert torch.equal(maxima, planes.amax(-1).to(torch.int64))


# ── a model of the kernel's split of a plane ────────────────────


def _constants() -> dict:
    src = CSRC.read_text()
    return {k: int(v) for k, v in re.findall(
        r"constexpr (?:int|size_t) (\w+) = (\d+);", src)}


def test_kernel_constants_bound_its_counters():
    c = _constants()
    # a byte counter takes the edge byte and ROUND loads of 16 between
    # flushes, and overflows past 255
    assert 1 + c["ROUND"] * 16 <= 255
    assert c["ROUND"] % c["BATCH"] == 0
    # the flush maps the block's threads onto ROWS rows of 4 bins, a
    # quarter of the columns each; the edge bytes need < 32 threads
    assert c["THREADS"] == 256 and c["ROWS"] * 4 == 256
    assert c["MAX_PLANES"] == hist._MAX_PLANES
    assert c["NG"] == NG


def _model(plane: np.ndarray, addr: int, stride: int) -> tuple:
    """``csrc/hist.cu``'s split of a plane at device address ``addr``:
    edge bytes one a thread, 16-byte vectors with their byte masks →
    (histogram, maximum)."""
    n = plane.size
    per, lim = 1, None
    if stride > 1 and n // (stride * NG) > 0:
        per, lim = stride, n // (stride * NG) * stride

    def counts(row):
        return (lim is None or row < lim) and row % per == 0

    head = min(n, (16 - addr % 16) % 16)
    nvec = (n - head) // 16
    tail = head + nvec * 16
    edges = list(range(head)) + list(range(tail, n))
    assert len(edges) < 32
    counted = [plane[e] for e in edges if counts(e >> 7)]
    for v in range(nvec):
        off = head + 16 * v
        ra, rb = off >> 7, (off + 15) >> 7
        if per == 1:
            mask = 0xFFFF
        elif ra == rb:
            mask = 0xFFFF if counts(ra) else 0
        else:
            lo = (1 << (NG - (off & (NG - 1)))) - 1
            mask = (lo if counts(ra) else 0) | ((0xFFFF & ~lo) if counts(rb) else 0)
        counted += [plane[off + i] for i in range(16) if mask >> i & 1]
    mx = int(plane.max()) if n else 0
    return _bincount(np.asarray(counted, np.uint8)), mx


@pytest.mark.parametrize("stride", [1, 2, 16])
@pytest.mark.parametrize("addr", [0, 1, 8, 15])
@pytest.mark.parametrize("n", [0, 7, 16 * NG - 3, 3 * 16 * NG + 200, 5 * 16 * NG])
def test_kernel_split_follows_the_rule(stride, addr, n):
    x = _plane(n, n + addr)
    h, mx = _model(x, addr, stride)
    want, want_mx = plane_stats_plain([torch.from_numpy(x)], stride)
    np.testing.assert_array_equal(h, want[0].numpy())
    assert mx == int(want_mx[0])


def _rule(n: int, stride: int):
    if stride > 1 and n // (stride * NG) > 0:
        return stride, n // (stride * NG) * stride
    return 1, None


@pytest.mark.parametrize("stride,addr,blocks", [
    (1, 0, 1), (1, 7, 3), (16, 0, 3), (16, 9, 7), (2, 3, 2), (32, 0, 2),
    (3, 0, 2), (48, 5, 3)])
def test_kernel_schedule_covers_every_vector_and_bounds_its_counters(
        stride, addr, blocks):
    """The kernel's load schedule (``csrc/hist.cu``): load k of thread t
    of block b is vector ``b·256 + k·step + ((t + 8k) mod 256)``, with a
    flush every ``round`` loads.  Every vector is loaded once, and no
    thread counts more than ROUND·16 bytes between two flushes."""
    c = _constants()
    rnd_max, threads = c["ROUND"], c["THREADS"]
    per = stride if stride > 1 else 1
    rnd = rnd_max * min(per, 16) if per > 1 and 32 % per == 0 else rnd_max
    step = blocks * threads
    nvec = int(2.5 * rnd * step) + 37
    head = (16 - addr % 16) % 16
    n = head + 16 * nvec + 5
    per, lim = _rule(n, stride)
    seen = np.zeros(nvec, np.int64)
    for b in range(blocks):
        rounds = -(-(nvec - b * threads) // (rnd * step))
        k = np.arange(rounds * rnd)[None, :]
        t = np.arange(threads)[:, None]
        v = b * threads + k * step + ((t + 8 * k) & (threads - 1))
        ok = v < nvec
        seen += np.bincount(v[ok], minlength=nvec)
        off = head + 16 * v
        ra, rb = off >> 7, (off + 15) >> 7

        def counts(row):
            return (row % per == 0) & (True if lim is None else row < lim)

        cut = NG - (off & (NG - 1))
        nbytes = np.where(ra == rb, 16 * counts(ra),
                          cut * counts(ra) + (16 - cut) * counts(rb))
        nbytes = np.where(ok, nbytes, 0).reshape(threads, rounds, rnd)
        assert nbytes.sum(-1).max() <= 16 * rnd_max
    assert (seen == 1).all()


# ── the kernel on the card ──────────────────────────────────────


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _content(kind: str, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "zero":
        return np.zeros(n, np.uint8)
    if kind == "ff":
        return np.full(n, 255, np.uint8)
    if kind == "sparse":  # 99 % zeros
        x = rng.integers(1, 256, n, dtype=np.uint8)
        return np.where(rng.random(n) < 0.99, 0, x).astype(np.uint8)
    return rng.integers(0, 256, n, dtype=np.uint8)


def _check(planes, stride: int) -> None:
    n0 = hist.plane_stats.launches
    got = plane_stats(planes, stride)
    want = plane_stats_plain(planes, stride)
    torch.cuda.synchronize()
    assert got[0].dtype == got[1].dtype == torch.int64
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert hist.plane_stats.launches == n0 + -(-len(planes) // hist._MAX_PLANES)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["zero", "ff", "sparse", "uniform"])
@pytest.mark.parametrize("stride", [1, 16])
@pytest.mark.parametrize("n_planes", [1, 3, 6, 12])
def test_kernel_matches_plain(cuda, kind, stride, n_planes):
    # lengths off the 16-byte grid and off whole blocks
    n = 7 * 16 * NG + 1000 + n_planes
    x = np.stack([_content(kind, n, s) for s in range(n_planes)])
    _check(torch.as_tensor(x, device=cuda), stride)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["zero", "ff", "sparse", "uniform"])
@pytest.mark.parametrize("stride", [1, 16])
def test_kernel_on_offset_views(cuda, kind, stride):
    # the sparse entropy stage's planes: bitmap and value views of one
    # buffer, of other lengths, at any offset; and planes shorter than
    # one block or than one vector
    buf = torch.as_tensor(_content(kind, 300_000, 1), device=cuda)
    bounds = [(0, 65536), (65536, 65536 + 4096), (70001, 70001 + 5000),
              (80003, 80003 + 16 * NG - 1), (90000, 90007), (95001, 95001),
              (100000, 300_000)]
    _check([buf[a:b] for a, b in bounds], stride)


@pytest.mark.gpu
def test_kernel_over_more_planes_than_a_launch(cuda):
    x = torch.as_tensor(_content("sparse", 70 * 3000, 2).reshape(70, 3000),
                        device=cuda)
    _check(x, 16)


@pytest.mark.gpu
def test_kernel_full_width_plane(cuda):
    # a 1080p chunk's plane: 132,710,400 symbols, mostly zero
    n = 64 * 1080 * 1920
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randint(0, 256, (n,), device=cuda, dtype=torch.uint8, generator=g)
    x = torch.where(torch.rand(n, device=cuda, generator=g) < 0.9, 0, x)
    for stride in (1, 16):
        got, mx = plane_stats([x], stride)
        want = torch.bincount(sampled(x, stride).to(torch.int64), minlength=256)
        assert torch.equal(got[0], want) and int(mx[0]) == int(x.max())


@pytest.mark.gpu
def test_codec_encodes_through_the_kernel(cuda):
    # a flat frame with a noisy chroma patch: at q=50 sparse, planes
    # coded sparse (bitmaps and value planes of their own lengths)
    rng = np.random.default_rng(5)
    rgb = np.full((8, 64, 64, 3), 90, np.uint8)
    rgb[:, 8:24, 16:40, 1:] = rng.integers(0, 256, (8, 16, 24, 2), dtype=np.uint8)
    rgb = torch.as_tensor(rgb, device=cuda)
    keys = set(launch_counts())
    for kw in (dict(), dict(sparse=True, quality=50), dict(quality=100)):
        codec = alc3.Alc3Codec(**{"quality": 90, "s_seg": 8, **kw}, device=cuda)
        n0 = hist.plane_stats.launches
        chunk = codec.encode(rgb)
        assert hist.plane_stats.launches == n0 + 1
        cpu = alc3.Alc3Codec(**{"quality": 90, "s_seg": 8, **kw}, device="cpu")
        want = cpu.encode(rgb.cpu())
        assert alc3.Alc3Codec.to_bytes(chunk) == alc3.Alc3Codec.to_bytes(want)
    assert set(launch_counts()) == keys and len(keys) == 11
