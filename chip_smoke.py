#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``alice_codec_tpu_torch``) on one
CUDA card — the quickest proof that the port starts on the GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero before the last line):

1. print the card's name and power limit; build the kernels from
   ``alice_codec_tpu_torch/csrc`` (one nvcc per source, in parallel);
2. every kernel against its plain PyTorch version on the card, bit-exact:
   at the main path's full widths (a 64×1080×1920 chunk; all 1536 rANS
   segments) and at small odd-padded shapes; with per-kernel timings;
3. the committed JAX-written golden (``tests/golden/torch``): the port
   decodes its container to the JAX decodes (both inverse modes) and
   re-encodes its input to the same bytes;
4. the main path: ``Alc3Codec(quality=90, wavelet="cdf53")`` encode →
   decode of one 64×1080×1920 chunk kept on the card, with the launch
   counts of every kernel read around that one run; the decoded symbols
   equal the encoded ones, and the container and RGB equal those of the
   same pipeline run with the plain versions on the card;
5. timings (chunks/s, peak memory), one roundtrip under torch.profiler
   (device time by kernel), the ``kernels`` JSON line and the final
   ``{"ok": true, ...}`` line.

Needs no network and imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published memory rate
T, H, W = 64, 1080, 1920   # the main path's chunk
QUALITY = 90


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls after one warm-up
    call, by CUDA events."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(a, b) -> int:
    import torch

    check(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


@contextlib.contextmanager
def plain_kernels():
    """Route the codec's kernel calls to the plain versions (on the card)
    for the span of the block."""
    from alice_codec_tpu_torch import alc3, pipeline
    from alice_codec_tpu_torch.ops.kernels import lift, rans3

    swaps = [
        (pipeline, "forward_quant", lift.forward_quant_plain),
        (pipeline, "inverse_dequant", lift.inverse_dequant_plain),
        (alc3, "encode_words", rans3.encode_words_plain),
        (alc3, "decode_words", rans3.decode_words_plain),
    ]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    try:
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from alice_codec_tpu_torch import Alc3Codec, WaveletType, _build, quality_to_step
    from alice_codec_tpu_torch import alc3, pipeline
    from alice_codec_tpu_torch.ops.kernels import launch_counts, reset_launches
    from alice_codec_tpu_torch.ops.kernels.lift import (
        forward_quant, forward_quant_plain, inverse_dequant,
        inverse_dequant_plain)
    from alice_codec_tpu_torch.ops.kernels.rans3 import (
        NG, decode_words, decode_words_plain, encode_words, encode_words_plain)
    from alice_codec_tpu_torch.ops.tables_device import freq_table_device
    from bench import _test_chunk

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    # ── 1. build ────────────────────────────────────────────────
    t0 = time.perf_counter()
    for path in _build.build():
        print(f"built {path.name}")
    print(f"build: {time.perf_counter() - t0:.1f} s (parallel nvcc)")

    # ── 2. kernels vs plain versions ────────────────────────────
    wt = WaveletType.CDF53
    step = quality_to_step(QUALITY)
    t0 = time.perf_counter()
    rgb_np = _test_chunk(T, H, W)
    print(f"input: {rgb_np.shape} uint8, made in {time.perf_counter() - t0:.1f} s")
    rgb = torch.as_tensor(rgb_np, device=dev)
    padded = (W, H, T)
    p = T * H * W
    stats = {}

    # small odd-padded shapes: every wavelet, both inverse modes, and
    # random symbols at steps 64 and 160 (at 160 the inverse leaves
    # int16, so the kernels' int16 stores wrap)
    small = torch.as_tensor(_test_chunk(5, 37, 51, seed=3), device=dev)
    small_vol = pipeline._color_pad(small, (52, 38, 6))
    rng = np.random.default_rng(4)
    rand_sym = torch.as_tensor(
        rng.integers(0, 256, (3, 6, 38, 52), dtype=np.uint8), device=dev)
    for w_small in WaveletType:
        for st in (1, 7):
            a = forward_quant(small_vol, w_small, st, st)
            check(max_abs_err(a, forward_quant_plain(small_vol, w_small, st, st)) == 0,
                  f"forward_quant small {w_small.name} step {st}")
            for exact in (False, True):
                for sym, s2 in ((a, st), (rand_sym, 64), (rand_sym, 160)):
                    b = inverse_dequant(sym, w_small, s2, exact=exact)
                    c = inverse_dequant_plain(sym, w_small, s2, exact=exact)
                    check(max_abs_err(b, c) == 0,
                          f"inverse_dequant small {w_small.name} exact={exact}")
    print("small shapes: forward_quant / inverse_dequant bit-exact "
          "(3 wavelets, both inverse modes, random symbols at steps 64, 160)")

    # K1 at full width
    chans = pipeline._color_pad(rgb, padded)
    sym_k = forward_quant(chans, wt, step, step)
    sym_p = forward_quant_plain(chans, wt, step, step)
    err = max_abs_err(sym_k, sym_p)
    check(err == 0, f"forward_quant differs from its plain version by {err}")
    del sym_p
    stats["forward_quant"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: forward_quant(chans, wt, step, step), 10),
        plain_ms=time_ms(lambda: forward_quant_plain(chans, wt, step, step), 2),
        bound_ms=bound_ms(chans.numel() * 2 + sym_k.numel()))
    torch.cuda.empty_cache()

    # K4 at full width, both inverse modes
    steps3 = torch.full((3,), step, dtype=torch.int32, device=dev)
    err = 0
    for exact in (False, True):
        v_k = inverse_dequant(sym_k, wt, steps3, exact=exact)
        v_p = inverse_dequant_plain(sym_k, wt, steps3, exact=exact)
        e = max_abs_err(v_k, v_p)
        check(e == 0, f"inverse_dequant exact={exact} differs by {e}")
        err = max(err, e)
        del v_k, v_p
    torch.cuda.empty_cache()
    stats["inverse_dequant"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: inverse_dequant(sym_k, wt, steps3), 10),
        plain_ms=time_ms(lambda: inverse_dequant_plain(sym_k, wt, steps3), 2),
        bound_ms=bound_ms(sym_k.numel() + sym_k.numel() * 2))
    torch.cuda.empty_cache()

    # K2 / K3 at full width: all 3·512 segments of the chunk
    symbols, hists = pipeline.encode_device(
        rgb, step, step, wavelet_type=wt, padded=padded,
        hist_stride=alc3.HIST_STRIDE)
    hists = alc3._covered_hist(hists, symbols)
    n_seg, m = alc3._segment_geometry(p, alc3.DEFAULT_S_SEG)
    freqs, cums = freq_table_device(
        alc3._table_hists(hists, p, s_seg=alc3.DEFAULT_S_SEG))
    segs = torch.nn.functional.pad(symbols, (0, m - p)).reshape(
        3 * n_seg, alc3.DEFAULT_S_SEG, NG)
    st_k, cn_k = encode_words(segs, freqs, cums)
    st_p, cn_p = encode_words_plain(segs, freqs, cums)
    err = max(max_abs_err(cn_k, cn_p), max_abs_err(st_k, st_p))
    check(err == 0, f"encode_words differs from its plain version by {err}")
    del st_p
    words = int(cn_k.to(torch.int64).sum().item())
    stats["encode_words"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: encode_words(segs, freqs, cums), 5),
        plain_ms=time_ms(lambda: encode_words_plain(segs, freqs, cums), 1),
        bound_ms=bound_ms(segs.numel() + st_k.numel() * 4 + cn_k.numel() * 4))
    s_seg = alc3.DEFAULT_S_SEG
    d_k = decode_words(st_k, cn_k, freqs, cums, s_seg=s_seg)
    d_p = decode_words_plain(st_k, cn_k, freqs, cums, s_seg=s_seg)
    err = max_abs_err(d_k, d_p)
    check(err == 0, f"decode_words differs from its plain version by {err}")
    check(bool(torch.equal(d_k, segs)), "decode_words does not invert encode_words")
    del d_p
    stats["decode_words"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: decode_words(st_k, cn_k, freqs, cums, s_seg=s_seg), 5),
        plain_ms=time_ms(
            lambda: decode_words_plain(st_k, cn_k, freqs, cums, s_seg=s_seg), 1),
        bound_ms=bound_ms(words * 4 + cn_k.numel() * 4 + d_k.numel()))
    active = int((cn_k > 0).sum().item())
    print(f"rANS: {3 * n_seg} segments ({active} coded), {words} words; "
          f"serial chain {s_seg} steps per segment")
    del chans, sym_k, symbols, segs, st_k, cn_k, d_k
    torch.cuda.empty_cache()
    for name, s in stats.items():
        print(f"{name}: {s['ms']:.3f} ms per launch (plain {s['plain_ms']:.1f} ms, "
              f"bytes bound {s['bound_ms']:.3f} ms), max |kernel - plain| "
              f"{s['max_abs_err']} [{card}]")

    # ── 3. the JAX-written golden ───────────────────────────────
    gdir = ROOT / "tests" / "golden" / "torch"
    man = json.loads((gdir / "manifest.json").read_text())
    for name, digest in man["sha256"].items():
        check(hashlib.sha256((gdir / name).read_bytes()).hexdigest() == digest,
              f"golden file {name} does not match its manifest")
    g_rgb = _test_chunk(man["t"], man["h"], man["w"], seed=man["seed"])
    g_alc = (gdir / "dense.alc").read_bytes()
    g_codec, g_chunks = Alc3Codec.from_bytes(g_alc)
    for mode, exact in (("compat", False), ("exact", True)):
        want = np.frombuffer((gdir / f"dense.{mode}.rgb").read_bytes(), np.uint8)
        got = g_codec.decode(g_chunks[0], exact=exact, as_numpy=True)
        check(np.array_equal(got.reshape(-1), want),
              f"golden {mode} decode differs from the JAX decode")
    enc = Alc3Codec(quality=man["quality"], wavelet=man["wavelet"],
                    s_seg=man["s_seg"]).encode(g_rgb)
    check(Alc3Codec.to_bytes(enc) == g_alc,
          "golden re-encode differs from the JAX container")
    print("golden: JAX container decoded bit-exact (both modes); "
          "re-encode byte-identical")

    # ── 4. the main path at full width ──────────────────────────
    codec = Alc3Codec(quality=QUALITY, wavelet="cdf53")
    out = codec.decode(codec.encode(rgb))  # warm-up
    torch.cuda.synchronize()
    del out
    reset_launches()
    chunk = codec.encode(rgb)
    out = codec.decode(chunk)
    torch.cuda.synchronize()
    launches = launch_counts()
    print(f"main path launches: {launches}")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")

    n_seg = chunk.n_segments
    v_seg = alc3._pick_v_seg(n_seg)
    sym_enc, _ = pipeline.encode_device(
        rgb, codec.step, codec.step, wavelet_type=codec.wavelet_type,
        padded=padded, hist_stride=alc3.HIST_STRIDE)
    sym_dec = alc3._entropy_decode(chunk.streams, chunk.counts, chunk.hists,
                                   padded=padded, s_seg=chunk.s_seg, v_seg=v_seg)
    check(bool(torch.equal(sym_enc, sym_dec)),
          "decoded symbols differ from the encoded symbols")
    del sym_enc, sym_dec
    data = Alc3Codec.to_bytes(chunk)
    with plain_kernels():
        p_chunk = codec.encode(rgb)
        p_data = Alc3Codec.to_bytes(p_chunk)
        p_out = codec.decode(p_chunk)
    check(data == p_data, "container differs from the plain pipeline's")
    check(bool(torch.equal(out, p_out)), "RGB differs from the plain pipeline's")
    del p_chunk, p_out
    mse = float(((out.float() - rgb.float()) ** 2).mean().item())
    psnr = 10 * np.log10(255.0 ** 2 / mse) if mse else float("inf")
    ratio = rgb_np.nbytes / max(chunk.compressed_size, 1)
    print(f"main path: {len(data)} container bytes, compression "
          f"{ratio:.4f}x, PSNR {psnr:.4f} dB; equal to the plain pipeline")
    del out, chunk
    torch.cuda.empty_cache()

    # ── 5. timings ──────────────────────────────────────────────
    reps = 5
    chunk = codec.encode(rgb)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_enc = t_dec = 0.0
    t_all = time.perf_counter()
    for _ in range(reps):
        t0 = time.perf_counter()
        chunk = codec.encode(rgb)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = codec.decode(chunk)
        torch.cuda.synchronize()
        t_enc += t1 - t0
        t_dec += time.perf_counter() - t1
    t_all = time.perf_counter() - t_all
    peak = torch.cuda.max_memory_allocated()
    print(f"encode {reps / t_enc:.4f} chunks/s, decode {reps / t_dec:.4f} "
          f"chunks/s, roundtrip {reps / t_all:.4f} chunks/s at {T}x{H}x{W} "
          f"(host clock, synchronized); peak memory {peak / 2**30:.3f} GiB "
          f"[{card}]")

    # where the time goes: one roundtrip under torch.profiler
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = codec.decode(codec.encode(rgb))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    print(f"profile: one roundtrip {wall_ms:.3f} ms wall (profiled), device "
          f"kernel time {busy_ms:.3f} ms = {100 * busy_ms / wall_ms:.1f} % busy "
          f"[{card}]")
    for key, ms, count in rows[:14]:
        print(f"  {ms:9.3f} ms  x{count:<3d} {key[:90]}")

    sources = {
        "forward_quant": ("lift.cu", "alice_codec_tpu/ops/pallas/lift_kernels.py:354"),
        "encode_words": ("rans3.cu", "alice_codec_tpu/ops/pallas/rans3_kernels.py:499"),
        "decode_words": ("rans3.cu", "alice_codec_tpu/ops/pallas/rans3_kernels.py:289"),
        "inverse_dequant": ("lift.cu", "alice_codec_tpu/ops/pallas/lift_kernels.py:375"),
    }
    kernels = []
    for name, (src, replaces) in sources.items():
        s = stats[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"alice_codec_tpu_torch/csrc/{src}",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": s["max_abs_err"], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": "bytes", "library_ms": None,
        })
    print("kernels: " + json.dumps(
        [{k: d[k] for k in ("name", "launches", "max_abs_err")} for d in kernels]))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
