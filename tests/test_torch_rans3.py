"""The port's word-rANS kernels' plain versions against the JAX
package's NumPy spec (``alice_codec_tpu/ops/rans_word.py``), word for
word: streams, counts and decoded symbols, with elided all-zero segments,
several tables and worst-case noise."""

import numpy as np
import pytest
import torch

from alice_codec_tpu.ops import rans_word as spec

from alice_codec_tpu_torch.ops.kernels import rans3
from alice_codec_tpu_torch.ops.kernels.rans3 import NG, stream_rows

# The suite runs several pytest workers on the CPU at once: keep these
# small tensor ops on one thread so they do not compete with them.
torch.set_num_threads(1)

S_SEG = 16


def _content(kind: str, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "noise":
        return rng.integers(0, 256, size=n, dtype=np.uint8)
    if kind == "skewed":
        vals = rng.integers(0, 16, size=n)
        return np.where(rng.random(n) < 0.7, 0, vals).astype(np.uint8)
    if kind == "zero":
        return np.zeros(n, np.uint8)
    raise AssertionError(kind)


def _table(sym: np.ndarray):
    return spec.freq_table_words(np.bincount(sym.reshape(-1), minlength=256))


def _spec_encode(planes, tables, s_seg):
    """Per-plane spec encode → padded streams (n, stream_rows, NG) and
    counts, the JAX package's device layout."""
    w_words = stream_rows(s_seg) * NG
    streams, counts = [], []
    for sym, (f, c) in zip(planes, tables):
        payload, cnt = spec.encode_channel_words(sym, f, c, s_seg=s_seg, ng=NG)
        words = np.frombuffer(payload, "<u2")
        off = 0
        for k in cnt:
            row = np.zeros(w_words, np.int32)
            row[:k] = words[off : off + k]
            off += k
            streams.append(row)
        counts.append(cnt.astype(np.int32))
    return (np.stack(streams).reshape(-1, stream_rows(s_seg), NG),
            np.concatenate(counts))


def _run(planes, s_seg=S_SEG):
    tables = [_table(p) for p in planes]
    freqs = torch.from_numpy(np.stack([t[0] for t in tables]))
    cums = torch.from_numpy(np.stack([t[1] for t in tables]))
    sym = torch.from_numpy(np.concatenate(planes)).reshape(-1, s_seg, NG)
    before = rans3.encode_words.launches, rans3.decode_words.launches
    streams, counts = rans3.encode_words(sym, freqs, cums)
    want_streams, want_counts = _spec_encode(planes, tables, s_seg)
    np.testing.assert_array_equal(counts.numpy(), want_counts)
    np.testing.assert_array_equal(streams.numpy(), want_streams)
    out = rans3.decode_words(streams, counts, freqs, cums, s_seg=s_seg)
    assert out.dtype == torch.uint8
    np.testing.assert_array_equal(out.numpy(), sym.numpy())
    # the spec's host decoder reads the same words, and validates them
    for i, p in enumerate(planes):
        n_seg = p.size // (s_seg * NG)
        cnt = want_counts[i * n_seg : (i + 1) * n_seg]
        rows = want_streams[i * n_seg : (i + 1) * n_seg].reshape(n_seg, -1)
        payload = np.concatenate([r[:k] for r, k in zip(rows, cnt)]).astype("<u2")
        back = spec.decode_channel_words(
            payload, cnt, p.size, s_seg=s_seg, ng=NG, freqs=tables[i][0],
            cums=tables[i][1], cum_to_sym=spec.decode_lut_words(tables[i][1]),
            validate=True)
        np.testing.assert_array_equal(back, p)
    # on the CPU the wrappers take the plain versions: no launches
    assert (rans3.encode_words.launches, rans3.decode_words.launches) == before
    return counts.numpy()


@pytest.mark.parametrize("kind", ["noise", "skewed", "zero"])
def test_single_table_word_for_word(kind):
    counts = _run([_content(kind, 4 * S_SEG * NG, seed=1)])
    assert (counts == 0).all() == (kind == "zero")


def test_elided_segments_between_coded_ones():
    live = _content("skewed", S_SEG * NG, seed=5)
    plane = np.zeros((4, S_SEG * NG), np.uint8)
    plane[1] = live
    plane[3] = live
    counts = _run([plane.reshape(-1)])
    assert list(counts == 0) == [True, False, True, False]


def test_three_tables():
    planes = [_content("skewed", 2 * S_SEG * NG, seed=3),
              _content("noise", 2 * S_SEG * NG, seed=4),
              (np.random.default_rng(2).integers(0, 4, 2 * S_SEG * NG)
               ).astype(np.uint8)]
    _run(planes)


def test_worst_case_noise_stays_in_capacity():
    s_seg = 8
    counts = _run([_content("noise", s_seg * NG, seed=9)], s_seg=s_seg)
    assert counts.max() <= spec.segment_capacity_words(s_seg, NG)


def test_decode_lut_matches_spec_lut():
    for kind, seed in (("skewed", 6), ("noise", 7)):
        f, c = _table(_content(kind, 4096, seed))
        lut = rans3.decode_lut(torch.from_numpy(f)[None], torch.from_numpy(c)[None])
        e = lut[0].numpy()
        slots = np.arange(spec.PROB_SCALE)
        sym = spec.decode_lut_words(c).astype(np.int64)
        np.testing.assert_array_equal(e & 255, sym)
        np.testing.assert_array_equal(((e >> 8) & 2047) + 1, f[sym])
        np.testing.assert_array_equal(e >> 19, slots - c[sym])


def test_shape_checks():
    with pytest.raises(ValueError):
        rans3.encode_words(torch.zeros(2, 8, NG, dtype=torch.int32),
                           torch.zeros(1, 256, dtype=torch.int32),
                           torch.zeros(1, 256, dtype=torch.int32))
    with pytest.raises(ValueError):
        rans3.decode_words(torch.zeros(2, 8, NG, dtype=torch.int32),
                           torch.zeros(2, dtype=torch.int32),
                           torch.zeros(1, 256, dtype=torch.int32),
                           torch.zeros(1, 256, dtype=torch.int32), s_seg=8)
