"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``gpu``; every test skips where no CUDA device is present
(decided inside the ``cuda`` fixture, so every worker collects the same
tests).  A machine with a card need not have JAX, so this file imports
none; run it there with (``--noconftest`` keeps the JAX cache-clearing
fixture of ``tests/conftest.py`` out)::

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

Bit-exact everywhere.  chip_smoke.py repeats the comparisons at the main
path's full widths."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from alice_codec_tpu_torch import Alc3Codec, WaveletType
from alice_codec_tpu_torch.ops.kernels import lift, rans3
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
@pytest.mark.parametrize("shape", [(3, 2, 2, 2), (3, 6, 38, 52), (1, 4, 70, 34)])
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
    rand = torch.as_tensor(rng.integers(0, 256, size=shape, dtype=np.uint8),
                           device=cuda)
    for exact in (False, True):
        for s, st in ((sym, step), (rand, 64), (rand, 160)):
            got = lift.inverse_dequant(s, wt, st, exact=exact)
            assert _equal(got, lift.inverse_dequant_plain(s, wt, st, exact=exact))


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
