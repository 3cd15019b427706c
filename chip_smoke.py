#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``alice_codec_tpu_torch``) on one
CUDA card — the quickest proof that the port starts on the GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero before the last line):

1. print the card's name and power limit; build the kernels from
   ``alice_codec_tpu_torch/csrc`` (one nvcc per source, in parallel);
2. every kernel against its plain PyTorch version on the card, bit-exact:
   at the main paths' full widths (a 64×1080×1920 chunk: the fused lifts
   and the plain 3D lift at int32 in all three wavelets and both inverse
   modes; all 1536 rANS segments; compact / expand on the q=50 chroma
   planes) and at small shapes (odd-padded volumes; the fused lifts'
   tile-edge shapes with per-channel steps and int16-wrapping
   intermediates; int32 volumes far beyond int16; sparse planes at
   densities 0-100 % with capacities that differ per plane, and a hostile
   bitmap; the quantizer's reciprocal over every non-negative int32; the
   spatial pass's tiles against ``lift.tile_windows``, the model the CPU
   tests hold; a 3640-row and a 58368-column frame in the plain 3D lift,
   whose tiles cover any frame, and 456- and 1000-frame chunks, lifted
   in windows of frames, in all the lifts; the word-rANS kernels over
   planes of different segment
   counts and tables in one launch, with noise and corrupt counts, and
   the encoder's reciprocal division at every frequency), and the
   word-rANS kernels again on the north star's planes as its one launch
   each way gets them;
   with per-kernel timings and the lifts' device time split by kernel
   (spatial and temporal pass), K1 from RGB and K4 to RGB (the colour in
   the tile pass, the codec's route at this chunk) against the plain
   composition, flags included, timed beside their 2-byte bound; then a
   4K check (16×2160×3840, where the
   JAX package splits its spatial pass into single-axis band kernels):
   the fused lifts and the plain 3D lift (all three wavelets, both
   inverse modes) on that chunk against their plain versions, and a
   dense q=90 and a deep q=100 roundtrip of it;
3. the committed JAX-written goldens (``tests/golden/torch``, its
   ``sparse/`` and its ``modes/``): the port decodes each container to
   the JAX decode and re-encodes each input to the same bytes, the
   sparse codec's capacity caches included;
4. the paths at full width, each over one 64×1080×1920 chunk kept on
   the card, with the launch counts of every kernel set to 0 just before
   the path's encode → decode and read just after (each ALC3 path must
   launch ``encode_words`` and ``decode_words`` exactly once, and every
   K1 / K4 launch of an ALC3 path take RGB frames, ``rgb_launches``):
   ``Alc3Codec(90, "cdf53")`` (dense), the north star
   ``Alc3Codec(90, "cdf53", sparse=True)``,
   ``Alc3Codec(50, "cdf53", sparse=True)``, ``Alc3Codec(100, "haar")``
   (deep, lossless: its exact decode is the input),
   ``Alc3Codec(90, "cdf53", rdo=True)``, their sparse compositions, and
   ``Alc3Codec(90, "cdf53", levels=3)``; each container and RGB equal
   those of the same pipeline run with the plain versions on the card,
   and each sparse path's RGB equals the dense codec's at its settings;
   then the two compat wires: the `.alc` single chunk
   (``FrameEncoder(90, "cdf53")`` → ``EncodedChunk`` bytes →
   ``FrameDecoder``), whose container and RGB equal the plain pipeline's,
   and the ALC2 batch of ``bench.py``'s ``config4_alc_batched_decode`` (4
   chunks of 64×1080×1920, ``BatchFrameEncoder(90, "cdf53",
   n_lanes=4096, device_entropy=True)`` → ``EncodedChunkStream`` bytes →
   ``BatchFrameDecoder(device_entropy=True)``), whose payload and RGB
   equal the host-entropy coder's;
4b. batches, chunk meshes and streams, on the ALC2 batch's first two
   chunks (2 × 64×1080×1920, seeds 0 and 1), the launch counts set to 0
   just before each roundtrip and read just after:
   ``Alc3Codec(90, "cdf53")``, the north star and its q=50 form through
   ``encode_batch`` / ``decode_batch`` (K1 / K4 once a chunk, K2 / K3
   once a batch, on q=50 K5 / K6 once a batch), each batch's containers
   and RGB equal to the plain pipeline's, each row to the per-chunk
   decode, the dense containers to per-chunk encode's, chunks/s as
   batches and per chunk; then over ``chunk_mesh()`` (the visible
   cards): the dense batch's streams equal to the batch without a mesh,
   the sparse q=90 and q=50 mesh roundtrips decoding to the per-chunk
   decode with containers that parse, and the ALC2 batch's stream with
   ``mesh=`` equal to the one without; then 136 frames of 1080p (three
   chunks) through ``encode_stream`` into an `.alcs3` file and back
   through ``decode_stream``, equal to the per-chunk decode;
4c. the two routes of ``bench.py`` that the quality, rate and
   segmentation layers complete, the launch counts set to 0 just before
   each roundtrip (each encode) and read just after: config3
   (``config3_cdf97_sweep``), ``Alc3Codec(q, "cdf97")`` over the
   64×1080×1920 chunk for q = 50, 55, …, 95, each roundtrip K1-K4 once
   and no other kernel, the containers and RGB at q = 50 and 95 equal to
   the plain pipeline's, the centre frame's ``psnr_device`` and
   ``ssim_device`` on the card held to the host f64 ``psnr`` / ``ssim``
   (1e-3 dB, 1e-4) and to their CPU runs, PSNR monotone within 0.1 dB,
   chunks/s over q = 55-95 as ``bench.py`` reckons it; config5
   (``config5_rate_controlled_4k``), a 16×2160×3840 chunk coded six times
   at the quality a ``RateController`` (60 Mbit/s at 30 fps) recommends,
   each encode K1 and K2 once, the quality sequence and the sizes those of
   the plain pipeline (its containers compared at the first and the last
   distinct quality), the last chunk decoded and ``segment_by_motion`` on
   its frames 1 and 0 on the card equal to the CPU's; frames/s;
4d. the tools, over the 64×1080×1920 chunk written once as a raw file,
   the launch counts set to 0 just before each run and read just after:
   ``cli.main`` in process — ``encode --format alc3 --sparse -q 50`` (K1,
   K2, K5 once), ``info`` (no launch) and ``decode`` (K3, K6, K4 once),
   the file equal to phase 4's ``sparse_q50`` container and the raw output
   to its RGB; the default `.alc` format at ``-q 90`` (K1, then K7's
   inverse once), equal to phase 4's `.alc` chunk; ``--chunk-size 32``
   (K1 and K2 twice, K3 and K4 twice), equal to a per-chunk
   ``Alc3Codec`` encode and decode —, a ``StageTimer`` around the sparse
   encode recorded into a ``CodecMetricsSink``; ``python -m
   alice_codec_tpu_torch.cli`` in subprocesses without ``--device`` on an
   8×256×256 file, the bytes of ``cli.main``; the C ABI shim through
   ctypes (``alice_codec_encode`` K1 once, ``alice_codec_decode`` K7's
   inverse once, the bytes and RGB of phase 4's `.alc`,
   ``alice_codec_psnr`` within 1e-9 dB of the host ``psnr``); an `.alcs`
   file of two `.alc` chunks read back, truncated and resumed; the ML
   bridge on the card against the CPU; a ``FrameCache`` holding the
   decoded CUDA frames in place; seconds file to file;
5. timings (chunks/s, peak memory) of each path, one roundtrip of each
   under torch.profiler (device time by kernel), the ``kernels`` JSON
   line and the final ``{"ok": true, ...}`` line.

Phase 2 also holds the N-lane rANS kernels against their plain versions
on every (chunk, channel) stream of that ALC2 batch plus a stream under
a skewed table — K8 in both routes (the packed payload the ALC2 path
codes with, byte for byte against the plain encode, pack and
concatenation; the TPU kernel's per-step layout, which no path launches)
and K9 on the packed payload — and phase 3 decodes and re-encodes the 48
C++ and the self `.alc` fixtures of ``tests/golden`` on the card.

Needs no network and imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published memory rate
T, H, W = 64, 1080, 1920   # the main paths' chunk
ALC2_CHUNKS, ALC2_LANES = 4, 4096  # bench.py config4_alc_batched_decode
T4K, H4K, W4K = 16, 2160, 3840  # the 4K check's chunk (and bench.py config5's)
CONFIG3_Q = tuple(range(50, 96, 5))  # bench.py config3_cdf97_sweep
CONFIG5_CHUNKS = 6                 # bench.py config5_rate_controlled_4k
QUALITY = 90
SPARSE_Q = (90, 50)        # the north star, and a quality with sparse planes


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


def device_profile(fn, need=(), tries=4):
    """One call of ``fn`` under torch.profiler: ``(wall ms, [(kernel name,
    device ms, count)] sorted by device time)``.

    The profiler can leave the first kernel of a session out of its record
    (seen on the H100: the first of a wrapper call's kernels), so a short
    spin kernel, left out of the rows, opens each session.  A profile that
    lacks a kernel named by a substring of ``need`` is taken again, up to
    ``tries`` times in all, and the last one must hold them."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        rows = [(e.key, e.self_device_time_total / 1e3, e.count)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
                and "spin_kernel" not in e.key]
        rows.sort(key=lambda r: -r[1])
        missing = [n for n in need if not any(n in key for key, _, _ in rows)]
        if not missing:
            return wall_ms, rows
    check(False, f"{tries} profiles of one call lack a kernel of {missing}: "
                 f"{[key[:60] for key, _, _ in rows]}")


def kernel_split(fn, need=()) -> dict:
    """Device ms of one call of ``fn`` by kernel (torch.profiler; kernels
    under 0.01 ms left out), names without their argument lists; ``need``
    as in :func:`device_profile`."""
    _, rows = device_profile(fn, need)
    return {key.replace("(anonymous namespace)::", "").removeprefix(
        "void ").split("(")[0]: ms for key, ms, _ in rows if ms > 0.01}


def max_abs_err(a, b) -> int:
    import torch

    check(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    if a.numel() > 1 << 28:  # int64 copies one slice at a time
        pairs = zip(a.split(1 << 26), b.split(1 << 26)) if a.ndim == 1 else zip(a, b)
        return max(max_abs_err(x, y) for x, y in pairs)
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def sha256(path: Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


def golden_input(kind: str, seed: int, shape):
    """The (T, H, W, 3) uint8 input of one sparse or mode golden chunk
    (``tests/golden/torch/{sparse,modes}/manifest.json``).  Also used by the
    golden generator and the tests; the repository root must be on
    ``sys.path`` (for ``bench``)."""
    import numpy as np
    from bench import _test_chunk

    t, h, w = shape
    if kind == "chunk":
        return _test_chunk(t, h, w, seed=seed)
    if kind == "gray":
        g = _test_chunk(t, h, w, seed=seed)[..., :1]
        return np.broadcast_to(g, g.shape[:3] + (3,)).copy()
    if kind == "noise":
        return np.random.default_rng(seed).integers(
            0, 256, (t, h, w, 3), dtype=np.uint8)
    if kind == "black":
        return np.zeros((t, h, w, 3), np.uint8)
    raise ValueError(f"unknown input kind {kind!r}")


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


@contextlib.contextmanager
def plain_kernels():
    """Route the codec's kernel calls to the plain versions (on the card)
    for the span of the block."""
    from alice_codec_tpu_torch import alc3, pipeline
    from alice_codec_tpu_torch.ops.kernels import lift, rans3, rans_nway, sparse
    from alice_codec_tpu_torch.parallel import batch

    swaps = [
        (pipeline, "forward_quant", lift.forward_quant_plain),
        (pipeline, "inverse_dequant", lift.inverse_dequant_plain),
        (pipeline, "forward_quant_rgb", lift.forward_quant_rgb_plain),
        (pipeline, "inverse_dequant_rgb", lift.inverse_dequant_rgb_plain),
        (pipeline, "forward_3d", lift.forward_3d_plain),
        (pipeline, "inverse_3d", lift.inverse_3d_plain),
        (alc3, "encode_words", rans3.encode_words_plain),
        (alc3, "decode_words", rans3.decode_words_plain),
        (alc3, "compact", sparse.compact_plain),
        (alc3, "expand", sparse.expand_plain),
        (batch, "encode_pack_nway", rans_nway.encode_pack_nway_plain),
        (batch, "decode_nway", rans_nway.decode_nway_plain),
    ]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    try:
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def only_launches(launches: dict, want: dict) -> bool:
    """Every kernel launched exactly as often as ``want`` says (0 if absent)."""
    return all(launches[k] == want.get(k, 0) for k in launches)


def bench_routes(rgb, rgb5_np, card: str) -> dict:
    """Phase 4c: ``bench.py``'s config3 (the cdf97 sweep with device PSNR /
    SSIM, over the (T, H, W, 3) chunk ``rgb`` on the card) and config5
    (rate-controlled encodes of ``rgb5_np``, a 4K chunk, and motion
    segmentation of the last one's frames); raises on any mismatch.
    Returns the two routes' launch counts by path."""
    import numpy as np
    import torch

    from alice_codec_tpu_torch import (Alc3Codec, RateControlConfig,
                                       RateController, psnr,
                                       segment_by_motion, ssim)
    from alice_codec_tpu_torch.metrics import psnr_device
    from alice_codec_tpu_torch.ops.kernels import launch_counts, reset_launches
    from alice_codec_tpu_torch.ssim import ssim_device

    by_path = {}
    t, h, w = rgb.shape[:3]

    resident = torch.cuda.memory_allocated() / 2**30
    # config3: the cdf97 sweep over ``rgb``
    mid = t // 2
    src_mid = rgb[mid].cpu()
    rows, total, peak3 = [], {}, 0.0
    for q in CONFIG3_Q:
        codec = Alc3Codec(q, "cdf97")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        chunk = codec.encode(rgb)
        out = codec.decode(chunk)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        peak3 = max(peak3, torch.cuda.max_memory_allocated() / 2**30)
        launches = launch_counts()
        check(only_launches(launches, {"forward_quant": 1, "encode_words": 1,
                                       "decode_words": 1, "inverse_dequant": 1}),
              f"config3 q={q}: expected K1-K4 once each, got {launches}")
        total = {k: total.get(k, 0) + n for k, n in launches.items()}
        if q in (CONFIG3_Q[0], CONFIG3_Q[-1]):
            with plain_kernels():
                p_codec = Alc3Codec(q, "cdf97")
                p_chunk = p_codec.encode(rgb)
                same = Alc3Codec.to_bytes(chunk) == Alc3Codec.to_bytes(p_chunk)
                check(same, f"config3 q={q}: container differs from the "
                            f"plain pipeline's")
                check(bool(torch.equal(out, p_codec.decode(p_chunk))),
                      f"config3 q={q}: RGB differs from the plain pipeline's")
            del p_chunk
        bpp = 8.0 * chunk.compressed_size / (t * h * w)
        del chunk
        # the centre frame's device metrics, as bench.py takes them
        out_mid = out[mid]
        p_dev = float(psnr_device(rgb[mid].reshape(-1), out_mid.reshape(-1)))
        s_dev = float(ssim_device(rgb[mid, :, :, 1].float(),
                                  out_mid[:, :, 1].float()))
        out_mid = out_mid.cpu()
        p_cpu = float(psnr_device(src_mid.reshape(-1), out_mid.reshape(-1)))
        s_cpu = float(ssim_device(src_mid[:, :, 1].float(),
                                  out_mid[:, :, 1].float()))
        p_host = psnr(src_mid.numpy(), out_mid.numpy())
        s_host = ssim(src_mid[:, :, 1].numpy(), out_mid[:, :, 1].numpy(), w, h)
        check(abs(p_dev - p_host) < 1e-3 and abs(s_dev - s_host) < 1e-4,
              f"config3 q={q}: device PSNR / SSIM {p_dev} / {s_dev} against "
              f"the host's {p_host} / {s_host}")
        check(abs(p_dev - p_cpu) < 1e-4 and abs(s_dev - s_cpu) < 1e-5,
              f"config3 q={q}: device PSNR / SSIM {p_dev} / {s_dev} against "
              f"their CPU runs {p_cpu} / {s_cpu}")
        rows.append(dict(q=q, psnr_db=p_dev, ssim=s_dev, bpp=bpp,
                         roundtrip_s=elapsed))
        del out
    by_path["config3_cdf97"] = total
    print(f"config3_cdf97 launches over {len(CONFIG3_Q)} roundtrips: {total}")
    check(all(b["psnr_db"] >= a["psnr_db"] - 0.1 for a, b in zip(rows, rows[1:])),
          f"config3: PSNR not monotone: {[r['psnr_db'] for r in rows]}")
    for r in rows:
        print(f"config3 q={r['q']}: PSNR {r['psnr_db']:.4f} dB, SSIM "
              f"{r['ssim']:.6f} (centre frame, on the card), {r['bpp']:.4f} "
              f"bpp, roundtrip {r['roundtrip_s'] * 1e3:.3f} ms (host clock, "
              f"synchronized) [{card}]")
    cps = (len(rows) - 1) / sum(r["roundtrip_s"] for r in rows[1:])
    print(f"config3_cdf97: {cps:.4f} chunks/s over q=55-95 (bench.py's "
          f"reckoning: one roundtrip each, the first quality left out); "
          f"containers and RGB at q=50 and q=95 equal to the plain "
          f"pipeline's; device PSNR / SSIM within 1e-3 dB / 1e-4 of the "
          f"host f64 metrics and 1e-4 / 1e-5 of their CPU runs; PSNR "
          f"monotone; peak memory {peak3:.3f} GiB ({resident:.3f} GiB "
          f"resident before the sweep) [{card}]")

    # config5: rate-controlled 4K, CONFIG5_CHUNKS encodes of one input
    rgb5 = torch.as_tensor(rgb5_np, device=rgb.device)
    t5, h5, w5 = rgb5.shape[:3]
    torch.cuda.reset_peak_memory_stats()
    target = dict(target_bitrate_kbps=60_000, framerate=30.0)
    ctrl = RateController(RateControlConfig(**target))
    codecs = {}
    q0 = ctrl.recommended_quality
    codecs[q0] = Alc3Codec(q0, "cdf53")
    _ = codecs[q0].encode(rgb5).compressed_size  # warm-up
    qualities, sizes, total = [], [], {}
    start = time.perf_counter()
    for _ in range(CONFIG5_CHUNKS):
        q = ctrl.recommended_quality
        qualities.append(q)
        codec = codecs.setdefault(q, Alc3Codec(q, "cdf53"))
        reset_launches()
        chunk5 = codec.encode(rgb5)
        size_bits = chunk5.compressed_size * 8
        launches = launch_counts()
        check(only_launches(launches, {"forward_quant": 1, "encode_words": 1}),
              f"config5 q={q}: expected K1 and K2 once, got {launches}")
        total = {k: total.get(k, 0) + n for k, n in launches.items()}
        sizes.append(size_bits // 8)
        for _ in range(t5):
            ctrl.update(size_bits // t5)
    elapsed = time.perf_counter() - start
    fps = CONFIG5_CHUNKS * t5 / elapsed
    reset_launches()
    frames = codecs[qualities[-1]].decode(chunk5, as_numpy=True)
    launches = launch_counts()
    check(only_launches(launches, {"decode_words": 1, "inverse_dequant": 1}),
          f"config5 decode: expected K3 and K4 once, got {launches}")
    total = {k: total.get(k, 0) + n for k, n in launches.items()}
    by_path["config5_4k"] = total
    peak5 = torch.cuda.max_memory_allocated() / 2**30
    print(f"config5_4k launches over {CONFIG5_CHUNKS} encodes and one "
          f"decode: {total}")
    # the plain pipeline: one encode a distinct quality (the input is the
    # same each chunk), the controller driven by its sizes
    distinct = sorted(set(qualities), key=qualities.index)
    ends = (distinct[0], distinct[-1])
    data5 = {q: Alc3Codec.to_bytes(codecs[q].encode(rgb5)) for q in ends}
    plain_sizes = {}
    with plain_kernels():
        for q in distinct:
            p_chunk = Alc3Codec(q, "cdf53").encode(rgb5)
            plain_sizes[q] = p_chunk.compressed_size
            if q in ends:
                check(Alc3Codec.to_bytes(p_chunk) == data5[q],
                      f"config5 q={q}: container differs from the plain "
                      f"pipeline's")
            del p_chunk
    p_ctrl = RateController(RateControlConfig(**target))
    p_qualities = []
    for _ in range(CONFIG5_CHUNKS):
        q = p_ctrl.recommended_quality
        check(q in plain_sizes, f"config5: the plain pipeline reaches q={q}, "
                                f"the card's sequence {qualities} does not")
        p_qualities.append(q)
        for _ in range(t5):
            p_ctrl.update(plain_sizes[q] * 8 // t5)
    check(p_qualities == qualities and [plain_sizes[q] for q in qualities] == sizes,
          f"config5: qualities {qualities} / sizes {sizes} against the plain "
          f"pipeline's {p_qualities} / {[plain_sizes.get(q) for q in p_qualities]}")
    cur = frames[1, :, :, 1].reshape(-1)
    ref = frames[0, :, :, 1].reshape(-1)
    seg = segment_by_motion(cur, ref, w5, h5)
    seg_cpu = segment_by_motion(cur, ref, w5, h5, device="cpu")
    check(np.array_equal(seg.mask, seg_cpu.mask) and seg.bbox == seg_cpu.bbox
          and seg.foreground_count == seg_cpu.foreground_count,
          "config5: segment_by_motion on the card differs from the CPU's")
    kbps = size_bits / (t5 / 30.0) / 1000
    print(f"config5_4k: {fps:.4f} frames/s over {CONFIG5_CHUNKS} encodes of "
          f"{t5}x{h5}x{w5} (host clock, one size read an encode, after a "
          f"warm-up encode); qualities {qualities}, sizes {sizes} bytes, equal "
          f"to the plain pipeline's (containers at q={distinct[0]} and "
          f"q={distinct[-1]}); final {kbps:.1f} kbit/s; segment_by_motion on "
          f"frames 1 and 0: {seg.foreground_count} foreground pixels, bbox "
          f"{seg.bbox}, equal to the CPU's; peak memory {peak5:.3f} GiB [{card}]")
    return by_path


def tools_routes(rgb_np, sparse50, alc90, card: str) -> dict:
    """Phase 4d: the tools over the (T, H, W, 3) chunk ``rgb_np``, written
    once as a raw file — the CLI in process (ALC3 ``--sparse -q 50``, the
    `.alc` format, ALC3 ``--chunk-size``), the CLI as a module in a
    subprocess, the C ABI shim through ctypes, an `.alcs` stream, the ML
    bridge, the frame cache and the metrics sink.  ``sparse50`` is phase 4's
    ``sparse_q50`` (container bytes, decoded RGB on the card), ``alc90`` its
    `.alc` chunk (container bytes, flat decoded RGB); raises on any
    mismatch.  Returns each file-to-file path's launches (encode + decode)."""
    import ctypes
    import io

    import numpy as np
    import torch

    from alice_codec_tpu_torch import Alc3Codec, EncodedChunk, cli, ffi, psnr
    from alice_codec_tpu_torch.bridges import cache, db, ml
    from alice_codec_tpu_torch.ops.kernels import launch_counts, reset_launches
    from alice_codec_tpu_torch.profiling import StageTimer
    from alice_codec_tpu_torch.utils import (AlcStreamReader, AlcStreamWriter,
                                             read_raw_rgb, write_raw_rgb)

    t, h, w = rgb_np.shape[:3]
    dims = ["-W", str(w), "-H", str(h), "-f", str(t)]
    by_path = {}

    def run(name, argv, want):
        """``cli.main(argv)`` in process with the launch counts set to 0 just
        before it and read just after; (launches, seconds, stdout)."""
        out = io.StringIO()
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            code = cli.main(argv)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = launch_counts()
        print(f"{name} launches: {launches}")
        check(code == 0, f"{name}: exit code {code}")
        check(only_launches(launches, want), f"{name}: expected {want}, got {launches}")
        return launches, dt, out.getvalue()

    def roundtrip(name, flags, enc_want, dec_want, ref_data, ref_rgb, timer=None):
        """encode → info → decode of the raw file; the encode inside
        ``timer``'s "encode" stage where one is given."""
        f, back = tmp / f"{name}.alc", tmp / f"{name}.rgb"
        with timer.stage("encode") if timer else contextlib.nullcontext():
            enc, t_enc, _ = run(f"{name} encode", ["encode", str(raw), "-o", str(f),
                                                   *dims, *flags], enc_want)
        check(f.read_bytes() == ref_data, f"{name}: file differs from the codec's container")
        _, _, info = run(f"{name} info", ["info", str(f)], {})
        check(f"dimensions: {w}x{h}x" in info, f"{name}: info printed {info!r}")
        dec, t_dec, _ = run(f"{name} decode", ["decode", str(f), "-o", str(back)], dec_want)
        check(back.read_bytes() == ref_rgb, f"{name}: decoded file differs from the codec's RGB")
        by_path[name] = {k: enc[k] + dec[k] for k in enc}
        print(f"{name}: {f.stat().st_size} file bytes, equal to the codec's container, "
              f"decoded file equal to its RGB; file to file encode {t_enc:.3f} s, "
              f"decode {t_dec:.3f} s (host clock, first run) [{card}]")
        return info

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        raw = tmp / "chunk.rgb"
        write_raw_rgb(raw, rgb_np)
        check(np.array_equal(read_raw_rgb(raw, w, h), rgb_np),
              "the raw file reads back otherwise")

        # ── the CLI in process, each run reset and read apart
        timer = StageTimer()
        sparse_rgb = sparse50[1].cpu().numpy()
        info = roundtrip(
            "cli_alc3_sparse_q50", ["--format", "alc3", "--sparse", "-q", "50"],
            {"forward_quant": 1, "encode_words": 1, "compact": 1},
            {"decode_words": 1, "expand": 1, "inverse_dequant": 1},
            sparse50[0], sparse_rgb.tobytes(), timer)
        check("ALC3 (1 chunk(s), sparse)" in info, f"cli info printed {info!r}")
        roundtrip("cli_alc_q90", ["-q", "90"], {"forward_quant": 1},
                  {"inverse_3d": 1}, alc90[0], alc90[1].tobytes())
        half = t // 2
        codec = Alc3Codec(90)
        ref = [codec.encode(rgb_np[:half]), codec.encode(rgb_np[half:])]
        ref_rgb = torch.cat([codec.decode(c) for c in ref]).cpu().numpy().tobytes()
        roundtrip("cli_alc3_chunked_q90",
                  ["--format", "alc3", "-q", "90", "--chunk-size", str(half)],
                  {"forward_quant": 2, "encode_words": 2},
                  {"decode_words": 2, "inverse_dequant": 2},
                  Alc3Codec.to_bytes(ref), ref_rgb)
        del ref, ref_rgb

        # the metrics sink, fed by the stage timer around the CLI encode
        sink_dir = tmp / "metrics"
        m = timer.as_metrics("encode", timestamp_ms=1000,
                             bitrate_bps=len(sparse50[0]) * 8 * 30 / t,
                             psnr_db=psnr(rgb_np, sparse_rgb))
        sink = db.CodecMetricsSink.open(sink_dir)
        sink.record(m)
        sink.flush()
        reread = db.CodecMetricsSink.open(sink_dir)
        f32 = lambda v: float(np.float32(v))  # noqa: E731
        check(reread.query_encode_time(0, 2000) == [(1000, f32(m.encode_time_us))]
              and reread.query_bitrate(0, 2000) == [(1000, f32(m.bitrate_bps))]
              and reread.query_psnr(0, 2000) == [(1000, f32(m.psnr_db))],
              "the metrics sink reads back otherwise")
        print(f"metrics sink: encode {m.encode_time_us:.1f} us, "
              f"{m.bitrate_bps:.1f} bit/s at 30 fps, PSNR {m.psnr_db:.4f} dB, "
              f"read back [{card}]")

        # ── the CLI as a module, without --device: the card or nothing
        small = tmp / "small.rgb"
        write_raw_rgb(small, rgb_np[:8, :256, :256])
        argv = [str(small), *["-W", "256", "-H", "256", "-f", "8"], "--format",
                "alc3", "-q", "90"]
        t_module = 0.0
        for where in ("module", "process"):
            enc = ["encode", *argv, "-o", str(tmp / f"{where}.alc3")]
            dec = ["decode", str(tmp / f"{where}.alc3"), "-o", str(tmp / f"{where}.rgb")]
            if where == "module":
                t0 = time.perf_counter()
                for cmd in (enc, dec):
                    r = subprocess.run(
                        [sys.executable, "-m", "alice_codec_tpu_torch.cli", *cmd],
                        cwd=ROOT, capture_output=True, text=True, timeout=300)
                    check(r.returncode == 0, f"python -m alice_codec_tpu_torch.cli "
                                             f"{cmd[0]}: exit {r.returncode}: {r.stderr}")
                t_module = time.perf_counter() - t0
            else:
                check(cli.main(enc) == 0 and cli.main(dec) == 0, "cli on the small file")
        for ext in (".alc3", ".rgb"):
            check((tmp / f"module{ext}").read_bytes() == (tmp / f"process{ext}").read_bytes(),
                  f"python -m alice_codec_tpu_torch.cli wrote another {ext} than cli.main")
        print(f"python -m alice_codec_tpu_torch.cli encode + decode of 8x256x256 "
              f"(no --device): {t_module:.1f} s in two processes, the bytes "
              f"of cli.main [{card}]")

        # ── the C ABI shim through ctypes, on the card (its default)
        t0 = time.perf_counter()
        lib = ffi.get_ffi_lib()
        print(f"C ABI shim: {ffi._SO.name} built and loaded in "
              f"{time.perf_counter() - t0:.1f} s, libpython link flags "
              f"{ffi.libpython_flags() or 'none (symbols from the interpreter)'}")
        u8p = ctypes.POINTER(ctypes.c_uint8)
        flat = np.ascontiguousarray(rgb_np).reshape(-1)
        enc_h = lib.alice_codec_encoder_create(90)
        n = ctypes.c_uint32(0)
        reset_launches()
        t0 = time.perf_counter()
        chunk = lib.alice_codec_encode(enc_h, flat.ctypes.data_as(u8p), flat.size,
                                       w, h, t)
        check(bool(chunk), "alice_codec_encode returned NULL on the card")
        ptr = lib.alice_codec_chunk_to_bytes(chunk, ctypes.byref(n))
        data = ctypes.string_at(ptr, n.value)
        t_enc = time.perf_counter() - t0
        lib.alice_codec_data_free(ptr, n.value)
        enc = launch_counts()
        print(f"ffi_alc_q90 encode launches: {enc}")
        check(only_launches(enc, {"forward_quant": 1}),
              f"ffi_alc_q90 encode: expected forward_quant 1, got {enc}")
        check(data == alc90[0], "ffi_alc_q90: chunk bytes differ from phase 4's .alc")
        check((lib.alice_codec_chunk_width(chunk), lib.alice_codec_chunk_height(chunk),
               lib.alice_codec_chunk_frames(chunk)) == (w, h, t), "ffi chunk dims")
        reset_launches()
        t0 = time.perf_counter()
        ptr = lib.alice_codec_decode(chunk, ctypes.byref(n))
        check(bool(ptr) and n.value == flat.size, "alice_codec_decode failed")
        out = np.ctypeslib.as_array(ptr, (n.value,))
        t_dec = time.perf_counter() - t0
        dec = launch_counts()
        print(f"ffi_alc_q90 decode launches: {dec}")
        check(only_launches(dec, {"inverse_3d": 1}),
              f"ffi_alc_q90 decode: expected inverse_3d 1, got {dec}")
        check(np.array_equal(out, alc90[1]), "ffi_alc_q90: RGB differs from phase 4's .alc")
        db_ffi = lib.alice_codec_psnr(flat.ctypes.data_as(u8p), ptr, flat.size)
        db_host = psnr(flat, out)
        check(abs(db_ffi - db_host) < 1e-9,
              f"alice_codec_psnr {db_ffi!r} != host psnr {db_host!r}")
        lib.alice_codec_data_free(ptr, n.value)
        lib.alice_codec_chunk_destroy(chunk)
        lib.alice_codec_encoder_destroy(enc_h)
        by_path["ffi_alc_q90"] = {k: enc[k] + dec[k] for k in enc}
        print(f"ffi_alc_q90: {len(data)} chunk bytes and RGB equal to phase 4's "
              f".alc, PSNR {db_ffi:.6f} dB (host {db_host:.6f}); encode {t_enc:.3f} s, "
              f"decode {t_dec:.3f} s buffer to buffer (host clock) [{card}]")
        del out, data

        # ── an .alcs stream of two .alc chunks: read, truncated, resumed
        path = tmp / "two.alcs"
        with AlcStreamWriter(path) as wr:
            for _ in range(2):
                wr.append(EncodedChunk.from_bytes(alc90[0]))
        got = [c.to_bytes() for c in AlcStreamReader(path)]
        check(got == [alc90[0]] * 2, "the .alcs stream reads back otherwise")
        path.write_bytes(path.read_bytes()[:-7])
        reader = AlcStreamReader(path)
        check(len(list(reader)) == 1 and reader.valid_end == 12 + len(alc90[0]),
              "the truncated .alcs stream did not give back its first chunk")
        with AlcStreamWriter(path, resume=True) as wr:
            check(wr.chunks_written == 1, "the resumed .alcs writer counts otherwise")
            wr.append(EncodedChunk.from_bytes(alc90[0]))
        check(len(list(AlcStreamReader(path))) == 2, "the resumed .alcs stream")
        print(f".alcs: two {len(alc90[0])}-byte .alc chunks written, read back, "
              f"truncated by 7 bytes (one recovered) and resumed [{card}]")

    # ── the ML bridge on the card against the CPU; the frame cache.
    # Integer features below 2^14 (past TF32's and bf16's mantissas; every
    # partial sum exact in float32): the card's logits are the CPU's
    # exactly.  Float features: each side within the float32 summation
    # bound (n·u/(1 − n·u) · Σ|w·x|, any order) of the float64 products.
    rng = np.random.default_rng(12)
    n_in = 512
    wts = rng.integers(-1, 2, (16, n_in)).astype(np.int8)
    card_clf, cpu_clf = (ml.SubBandClassifier(wts, n_in, 16, device=d)
                         for d in ("cuda", "cpu"))
    card_mv, cpu_mv = (ml.MotionPredictor(wts[:2], n_in, device=d)
                       for d in ("cuda", "cpu"))
    gamma = n_in * 2.0**-24 / (1 - n_in * 2.0**-24)
    for feats in (rng.integers(-16000, 16000, n_in).astype(np.float32),
                  rng.standard_normal(n_in).astype(np.float32) * 60):
        a, b = np.zeros(16, np.float32), np.zeros(16, np.float32)
        card_clf.classify_logits(feats, a)
        cpu_clf.classify_logits(feats, b)
        mv = np.array([card_mv.predict(feats), cpu_mv.predict(feats)])
        x64 = feats.astype(np.float64)
        ref, bound = wts @ x64, gamma * (np.abs(wts) @ np.abs(x64))
        if (feats == np.round(feats)).all():
            check(np.array_equal(a, b) and np.array_equal(a, ref)
                  and (mv == ref[:2]).all(),
                  f"ternary logits of integer features: card {a}, CPU {b}, "
                  f"exact {ref}")
            check(card_clf.classify(feats) == cpu_clf.classify(feats),
                  "SubBandClassifier class on the card differs from the CPU's")
        else:
            check((np.abs(a - ref) <= bound).all() and (np.abs(b - ref) <= bound).all()
                  and (np.abs(mv - ref[:2]) <= bound[:2]).all(),
                  f"ternary logits beyond the float32 summation bound {bound}: "
                  f"card {a}, CPU {b}, float64 {ref}")
    fc = cache.FrameCache(t // 2)
    frames = sparse50[1]
    for i in range(t):
        fc.put(0, i, 50, frames[i], w, h)
    last = fc.get(0, t - 1, 50)
    check(len(fc) == t // 2 and fc.get(0, 0, 50) is None and last is not None
          and last.data.device == frames.device
          and last.data.data_ptr() == frames[t - 1].data_ptr(),
          "FrameCache did not hold the decoded CUDA frames in place")
    print(f"ml bridge: SubBandClassifier 16x{n_in} and MotionPredictor on the "
          f"card: integer features the CPU's logits exactly, float32 ones "
          f"within the summation bound of float64 on both; FrameCache({t // 2}) "
          f"holds {len(fc)} decoded CUDA frames in place, hit rate "
          f"{fc.hit_rate():.2f} [{card}]")
    return by_path


def main() -> int:
    import torch

    t_script = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from alice_codec_tpu_torch import (
        Alc3Codec, Alc3StreamReader, Alc3StreamWriter, EncodedChunk,
        FrameDecoder, FrameEncoder, FrequencyTable, WaveletType, _build,
        decode_stream, encode_stream, native, quality_to_step)
    from alice_codec_tpu_torch import alc3, pipeline
    from alice_codec_tpu_torch.ops.kernels.rans_nway import (
        decode_nway, decode_nway_plain, encode_nway, encode_nway_plain,
        encode_pack_nway, lane_offsets, pack_streams)
    from alice_codec_tpu_torch.parallel import (
        BatchFrameDecoder, BatchFrameEncoder, EncodedChunkStream, chunk_mesh)
    from alice_codec_tpu_torch.parallel.batch import _lane_sym_count
    from alice_codec_tpu_torch.utils.golden import golden_rgb
    from alice_codec_tpu_torch.ops.kernels import (
        launch_counts, lift, rans3, rans_nway, reset_launches)
    from alice_codec_tpu_torch.ops.kernels.lift import (
        forward_3d, forward_3d_plain, forward_quant, forward_quant_plain,
        forward_quant_rgb, forward_quant_rgb_plain, inverse_3d, inverse_3d_plain,
        inverse_dequant, inverse_dequant_plain, inverse_dequant_rgb,
        inverse_dequant_rgb_plain)
    from alice_codec_tpu_torch.ops.kernels.rans3 import (
        NG, decode_words, decode_words_plain, encode_words, encode_words_plain)
    from alice_codec_tpu_torch.ops.kernels.sparse import (
        compact, compact_plain, expand, expand_plain, tile_rows)
    from alice_codec_tpu_torch.ops import wavelet
    from alice_codec_tpu_torch.ops.tables_device import freq_table_device
    from bench import _test_chunk

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    # the other chunks of the ALC2 batch, made on the host meanwhile
    pool = ThreadPoolExecutor(ALC2_CHUNKS - 1)
    more_chunks = [pool.submit(_test_chunk, T, H, W, seed=i)
                   for i in range(1, ALC2_CHUNKS)]
    config5_chunk = pool.submit(_test_chunk, T4K, H4K, W4K)

    # ── 1. build ────────────────────────────────────────────────
    t0 = time.perf_counter()
    for path in _build.build():
        print(f"built {path.name}")
    native.get_lib()
    print(f"build: {time.perf_counter() - t0:.1f} s (parallel nvcc; g++ for "
          f"the host rANS coder)")

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
    # the tile edges of the fused kernels' spatial pass (one tile; ragged
    # tiles in W and H; one tile column of a 1080-row frame; windows clamped
    # into the frame) and T = 64 (the temporal pass in registers), C of 1-3
    # with per-channel steps, on int16 inputs at ±256 and at ±30000 with
    # step 160 (intermediates that wrap at the int16 stores) and random
    # symbols at steps 64 and 160
    tile_shapes = ((3, 2, 2, 2), (1, 4, 34, 130), (2, 6, 70, 258),
                   (3, 4, 1080, 136), (2, 4, 130, 520), (1, 64, 64, 256),
                   (2, 64, 34, 130))
    for shape in tile_shapes:
        c_s = shape[0]
        st_c = torch.as_tensor(rng.integers(1, 65, c_s).astype(np.int32), device=dev)
        v256 = torch.as_tensor(rng.integers(-256, 256, shape, dtype=np.int16),
                               device=dev)
        v30k = torch.as_tensor(rng.integers(-30000, 30000, shape, dtype=np.int16),
                               device=dev)
        sym_r = torch.as_tensor(rng.integers(0, 256, shape, dtype=np.uint8),
                                device=dev)
        for w_small in WaveletType:
            a = forward_quant(v256, w_small, st_c, st_c)
            check(max_abs_err(a, forward_quant_plain(v256, w_small, st_c, st_c)) == 0,
                  f"forward_quant {shape} {w_small.name}")
            check(max_abs_err(forward_quant(v30k, w_small, 160, 160),
                              forward_quant_plain(v30k, w_small, 160, 160)) == 0,
                  f"forward_quant {shape} {w_small.name} at ±30000")
            for exact in (False, True):
                for sym, s2 in ((a, st_c), (sym_r, 64), (sym_r, 160)):
                    check(max_abs_err(
                        inverse_dequant(sym, w_small, s2, exact=exact),
                        inverse_dequant_plain(sym, w_small, s2, exact=exact)) == 0,
                          f"inverse_dequant {shape} {w_small.name} exact={exact}")
    # the tiles the CPU tests hold (lift.tile_windows) are the kernel's
    for h_t, w_t in sorted({s[2:] for s in tile_shapes} | {(H, W), (H4K, W4K)}):
        for w_small in WaveletType:
            halo = lift.spatial_halo(w_small)
            check(lift.kernel_tile_windows(h_t, w_t, halo)
                  == lift.tile_windows(h_t, w_t, halo),
                  f"the kernel's tiles of a {h_t}x{w_t} frame (halo {halo}) "
                  f"differ from lift.tile_windows")
    # the split-frame form (int16 between the W and H passes, as the TPU
    # stores it on frames beyond its one-block budget), forced here by
    # cutting the budget, on inputs whose intermediates leave int16
    budget = lift._FRAME_BYTES
    lift._FRAME_BYTES = 1024
    try:
        for shape in ((3, 4, 16, 256), (2, 4, 130, 520)):
            big16 = torch.as_tensor(
                rng.integers(-30000, 30000, shape, dtype=np.int16), device=dev)
            sym16 = torch.as_tensor(
                rng.integers(0, 256, shape, dtype=np.uint8), device=dev)
            for w_small in WaveletType:
                check(max_abs_err(forward_quant(big16, w_small, 160, 160),
                                  forward_quant_plain(big16, w_small, 160, 160)) == 0,
                      f"forward_quant split frame {shape} {w_small.name}")
                for exact in (False, True):
                    check(max_abs_err(
                        inverse_dequant(sym16, w_small, 160, exact=exact),
                        inverse_dequant_plain(sym16, w_small, 160, exact=exact)) == 0,
                          f"inverse_dequant split frame {shape} {w_small.name}")
    finally:
        lift._FRAME_BYTES = budget
    # the forward kernels' reciprocal of the step: every non-negative int32
    # numerator at every step 1-64 and the larger steps above
    recip_bad = lift.reciprocal_mismatches(list(range(1, 65)) + [160, 1000], dev)
    check(recip_bad == 0, f"the quantizer's reciprocal divides wrongly "
                          f"{recip_bad} times")
    print("small shapes: forward_quant / inverse_dequant bit-exact "
          "(3 wavelets, both inverse modes, random symbols at steps 64, 160; "
          f"tile-edge shapes {list(tile_shapes)}; split frames); the "
          "kernel's tiles equal lift.tile_windows; the reciprocal exact for "
          "every n < 2^31 at steps 1-64, 160, 1000")
    # the plain 3D lift at small shapes, int32 far beyond int16 (an int16
    # store between its passes would wrap here), with tiles clamped into
    # the frame (the spatial pass's fast form) and T = 64 (the temporal
    # pass in registers) in the last two
    for shape in ((3, 6, 38, 52), (1, 4, 70, 34), (2, 2, 2, 2),
                  (3, 64, 130, 520), (1, 64, 64, 256)):
        big = torch.as_tensor(
            rng.integers(-(1 << 20), 1 << 20, shape, dtype=np.int32), device=dev)
        for w_small in WaveletType:
            a = forward_3d(big, w_small)
            check(max_abs_err(a, forward_3d_plain(big, w_small)) == 0,
                  f"forward_3d small {shape} {w_small.name}")
            check(bool((a.abs() > 32767).any()), "small K7 input stays in int16")
            for exact in (False, True):
                for src in (a, big):
                    check(max_abs_err(inverse_3d(src, w_small, exact=exact),
                                      inverse_3d_plain(src, w_small,
                                                       exact=exact)) == 0,
                          f"inverse_3d small {shape} {w_small.name} "
                          f"exact={exact}")
            check(bool(torch.equal(inverse_3d(a, w_small, exact=True), big)),
                  f"inverse_3d exact does not invert forward_3d {w_small.name}")
    print("small shapes: forward_3d / inverse_3d bit-exact (3 wavelets, both "
          "inverse modes, int32 values to ±2^20)")
    # long lines: K7 on a 3640-row and a 58368-column frame (one tile
    # column; one tile row), and K1 / K4 / K7 on chunks longer than their
    # temporal columns hold (454 frames: windows of frames with a halo),
    # each against its plain version
    long_shapes = ((1, 4, 3640, 32), (1, 2, 8, 58368), (2, 456, 8, 32),
                   (2, 1000, 8, 32))
    for shape in long_shapes:
        big = torch.as_tensor(
            rng.integers(-(1 << 20), 1 << 20, shape, dtype=np.int32), device=dev)
        v16 = torch.as_tensor(rng.integers(-30000, 30000, shape, dtype=np.int16),
                              device=dev)
        sym_r = torch.as_tensor(rng.integers(0, 256, shape, dtype=np.uint8),
                                device=dev)
        for w_small in WaveletType:
            a = forward_3d(big, w_small)
            check(max_abs_err(a, forward_3d_plain(big, w_small)) == 0,
                  f"forward_3d {shape} {w_small.name}")
            a16 = forward_quant(v16, w_small, 160, 160)
            check(max_abs_err(a16, forward_quant_plain(v16, w_small, 160, 160)) == 0,
                  f"forward_quant {shape} {w_small.name}")
            for exact in (False, True):
                check(max_abs_err(inverse_3d(a, w_small, exact=exact),
                                  inverse_3d_plain(a, w_small, exact=exact)) == 0,
                      f"inverse_3d {shape} {w_small.name} exact={exact}")
                for sym, s2 in ((a16, 160), (sym_r, 7)):
                    check(max_abs_err(
                        inverse_dequant(sym, w_small, s2, exact=exact),
                        inverse_dequant_plain(sym, w_small, s2, exact=exact)) == 0,
                          f"inverse_dequant {shape} {w_small.name} exact={exact}")
        del big, v16, sym_r, a, a16
    print(f"long lines: forward_3d / inverse_3d / forward_quant / "
          f"inverse_dequant bit-exact at {list(long_shapes)} (3 wavelets, both "
          f"inverse modes; T lifted in windows past 454 frames)")
    # the word-rANS kernels at small shapes: one launch over planes of
    # different segment counts and tables (noise, where every lane emits
    # and refills in one step; elided segments between coded ones), then
    # counts corrupted past the stream; and the encoder's reciprocal
    s_small, planes_s = 40, (3, 2, 4)
    parts = [rng.integers(0, 256, (3, s_small, NG)),
             np.where(rng.random((2, s_small, NG)) < 0.6, 0,
                      rng.integers(0, 30, (2, s_small, NG))),
             np.where(rng.random((4, s_small, NG)) < 0.9, 0,
                      rng.integers(0, 9, (4, s_small, NG)))]
    parts[2][1] = 0
    seg_s = torch.as_tensor(np.concatenate(parts).astype(np.uint8), device=dev)
    f_s, c_s = freq_table_device(torch.stack([
        torch.bincount(torch.as_tensor(q.reshape(-1)).long(), minlength=256)
        for q in parts]).to(dev))
    st_s, cn_s = encode_words(seg_s, f_s, c_s, planes=planes_s)
    want = encode_words_plain(seg_s, f_s, c_s, planes=planes_s)
    check(max_abs_err(st_s, want[0]) == 0 and max_abs_err(cn_s, want[1]) == 0,
          "encode_words differs from its plain version on folded planes")
    bad = cn_s.clone()
    bad[0], bad[3], bad[7] = st_s.shape[1] * NG + 300, 2**31 - 1, -7
    for cn_x in (cn_s, bad):
        d_s = decode_words(st_s, cn_x, f_s, c_s, s_seg=s_small, planes=planes_s)
        check(max_abs_err(d_s, decode_words_plain(
            st_s, cn_x, f_s, c_s, s_seg=s_small, planes=planes_s)) == 0,
              "decode_words differs from its plain version on folded planes")
    check(bool(torch.equal(decode_words(st_s, cn_s, f_s, c_s, s_seg=s_small,
                                        planes=planes_s), seg_s)),
          "decode_words does not invert encode_words on folded planes")
    rcp_bad = rans3.rcp_mismatches(dev)
    check(rcp_bad == 0, f"the encoder's reciprocal divides wrongly {rcp_bad} times")
    print(f"small shapes: encode_words / decode_words bit-exact over planes "
          f"{planes_s} of {s_small} steps in one launch (noise, elided "
          f"segments, corrupt counts); the encoder's reciprocal exact at every "
          f"frequency 1-2048 on both sides of each multiple below 2^32")

    # K1 / K4 at full width: every wavelet, both inverse modes, bit-exact,
    # each timed; the main path's (CDF 5/3) numbers go to the kernels line,
    # with the device time of one wrapper call split by kernel
    chans = pipeline._color_pad(rgb, padded)
    steps3 = torch.full((3,), step, dtype=torch.int32, device=dev)
    k14 = {}
    for w_full in WaveletType:
        sym_k = forward_quant(chans, w_full, step, step)
        sym_p = forward_quant_plain(chans, w_full, step, step)
        err1 = max_abs_err(sym_k, sym_p)
        check(err1 == 0, f"forward_quant {w_full.name} differs from its plain "
                         f"version by {err1}")
        del sym_p
        err4 = 0
        for exact in (False, True):
            v_k = inverse_dequant(sym_k, w_full, steps3, exact=exact)
            v_p = inverse_dequant_plain(sym_k, w_full, steps3, exact=exact)
            e = max_abs_err(v_k, v_p)
            check(e == 0, f"inverse_dequant {w_full.name} exact={exact} differs "
                          f"by {e}")
            err4 = max(err4, e)
            del v_k, v_p
        torch.cuda.empty_cache()
        k14[w_full] = dict(
            forward_quant=dict(
                max_abs_err=err1,
                ms=time_ms(lambda: forward_quant(chans, w_full, step, step), 10),
                bound_ms=bound_ms(chans.numel() * 2 + sym_k.numel())),
            inverse_dequant=dict(
                max_abs_err=err4,
                ms=time_ms(lambda: inverse_dequant(sym_k, w_full, steps3), 10),
                bound_ms=bound_ms(sym_k.numel() + sym_k.numel() * 2)))
        for name, fn in (
                ("forward_quant", lambda: forward_quant(chans, w_full, step, step)),
                ("inverse_dequant", lambda: inverse_dequant(sym_k, w_full, steps3))):
            # the split must hold both passes
            k14[w_full][name]["kernel_split"] = split = kernel_split(
                fn, need=("spatial_tiles", "temporal_" + name.split("_")[1]))
            print(f"{name} {w_full.name}: {k14[w_full][name]['ms']:.3f} ms per "
                  f"call (bytes bound {k14[w_full][name]['bound_ms']:.3f} ms); "
                  f"one call by kernel: "
                  + ", ".join(f"{k} {v:.3f} ms" for k, v in split.items())
                  + f" [{card}]")
        if w_full == wt:
            main_sym = sym_k
        del sym_k
        torch.cuda.empty_cache()
    sym_k = main_sym
    for name in ("forward_quant", "inverse_dequant"):
        stats[name] = dict(k14[wt][name], ms_by_wavelet={
            w_full.name: k14[w_full][name]["ms"] for w_full in WaveletType})
    stats["forward_quant"]["plain_ms"] = time_ms(
        lambda: forward_quant_plain(chans, wt, step, step), 2)
    stats["inverse_dequant"]["plain_ms"] = time_ms(
        lambda: inverse_dequant_plain(sym_k, wt, steps3), 2)
    del main_sym
    torch.cuda.empty_cache()
    print(f"full width: forward_quant / inverse_dequant bit-exact at {T}x{H}x{W} "
          "(3 wavelets, both inverse modes)")

    # K1 from RGB and K4 to RGB (the colour in the tile pass's load and
    # store, the route of this chunk) at full width: every wavelet, both
    # inverse modes, bit-exact against the plain composition (_color_pad +
    # K1 and the colour flags; K4 + ycocg_r_to_rgb), each timed beside the
    # bound of its interface (uint8 RGB and uint8 symbols: 2 bytes a
    # coefficient) and split by kernel
    check(pipeline._rgb_route((W, H, T), padded), "the chunk is not on the RGB route")
    rgb_bound = bound_ms(chans.numel() * 2)
    rgb_ms = {"forward_quant": {}, "inverse_dequant": {}}
    for w_full in WaveletType:
        n1 = lift.forward_quant.rgb_launches
        sym_r, flags_r = forward_quant_rgb(rgb, w_full, step, step)
        sym_p, flags_p = forward_quant_rgb_plain(rgb, w_full, step, step)
        torch.cuda.synchronize()
        check(lift.forward_quant.rgb_launches == n1 + 1, "forward_quant_rgb launches")
        check(max_abs_err(sym_r, sym_p) == 0 and bool(torch.equal(flags_r, flags_p)),
              f"forward_quant_rgb {w_full.name} differs from its plain version")
        del sym_p
        for exact in (False, True):
            e = max_abs_err(inverse_dequant_rgb(sym_r, w_full, steps3, exact=exact),
                            inverse_dequant_rgb_plain(sym_r, w_full, steps3, exact=exact))
            check(e == 0, f"inverse_dequant_rgb {w_full.name} exact={exact} differs by {e}")
        torch.cuda.empty_cache()
        fns = {"forward_quant": lambda: forward_quant_rgb(rgb, w_full, step, step),
               "inverse_dequant": lambda: inverse_dequant_rgb(sym_r, w_full, steps3)}
        for name, fn in fns.items():
            rgb_ms[name][w_full.name] = ms = time_ms(fn, 10)
            split = kernel_split(fn, need=("spatial_tiles", "temporal_" + name.split("_")[1]))
            if w_full == wt:
                stats[name]["rgb"] = dict(max_abs_err=0, ms=ms, bound_ms=rgb_bound,
                                          kernel_split=split, ms_by_wavelet=rgb_ms[name])
            print(f"{name} from/to RGB {w_full.name}: {ms:.3f} ms per call (bytes "
                  f"bound {rgb_bound:.3f} ms); one call by kernel: "
                  + ", ".join(f"{k} {v:.3f} ms" for k, v in split.items()) + f" [{card}]")
        del sym_r
        torch.cuda.empty_cache()
    print(f"full width: forward_quant_rgb / inverse_dequant_rgb bit-exact at {T}x{H}x{W} "
          "(3 wavelets, both inverse modes, the colour flags)")

    # K7 at full width: the plain 3D lift of the int32 chunk, all three
    # wavelets, both inverse modes
    chans32 = pipeline._color_pad(rgb, padded, torch.int32)
    err = 0
    for w_full in WaveletType:
        c_k = forward_3d(chans32, w_full)
        e = max_abs_err(c_k, forward_3d_plain(chans32, w_full))
        check(e == 0, f"forward_3d {w_full.name} differs by {e}")
        err = max(err, e)
        for exact in (False, True):
            v_k = inverse_3d(c_k, w_full, exact=exact)
            e = max_abs_err(v_k, inverse_3d_plain(c_k, w_full, exact=exact))
            check(e == 0, f"inverse_3d {w_full.name} exact={exact} differs by {e}")
            err = max(err, e)
            if exact:
                check(bool(torch.equal(v_k, chans32)),
                      f"inverse_3d exact does not invert forward_3d {w_full.name}")
            del v_k
        del c_k
        torch.cuda.empty_cache()
    c_k = forward_3d(chans32, wt)
    k7_bound = bound_ms(chans32.numel() * 4 * 2)
    k7_fns = {"forward_3d": lambda: forward_3d(chans32, wt),
              "inverse_3d": lambda: inverse_3d(c_k, wt, exact=True)}
    stats["forward_3d"] = dict(
        max_abs_err=err, ms=time_ms(k7_fns["forward_3d"], 10),
        plain_ms=time_ms(lambda: forward_3d_plain(chans32, wt), 2),
        bound_ms=k7_bound)
    stats["inverse_3d"] = dict(
        max_abs_err=err, ms=time_ms(k7_fns["inverse_3d"], 10),
        plain_ms=time_ms(lambda: inverse_3d_plain(c_k, wt, exact=True), 2),
        bound_ms=k7_bound)
    for name, fn in k7_fns.items():
        # the split must hold both passes
        stats[name]["kernel_split"] = split = kernel_split(
            fn, need=("spatial_tiles", "temporal_lift"))
        print(f"{name} {wt.name}: {stats[name]['ms']:.3f} ms per call (bytes "
              f"bound {k7_bound:.3f} ms); one call by kernel: "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in split.items())
              + f" [{card}]")
    del chans32, c_k, k7_fns
    torch.cuda.empty_cache()
    print("full width: forward_3d / inverse_3d bit-exact at int32 "
          f"{T}x{H}x{W} (3 wavelets, both inverse modes)")

    # K2 / K3 at full width: all 3·512 segments of the chunk
    symbols, hists = pipeline.encode_device(
        rgb, step, step, wavelet_type=wt, padded=padded,
        hist_stride=alc3.HIST_STRIDE, interleaved=True)
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
    # K2 / K3 on the north star's planes, as its one launch each way gets
    # them (every bitmap and value segment of the chunk, a table a plane):
    # the path's calls recorded, then replayed against the plain versions
    calls = {}

    def recording(name, fn):
        def call(*args, **kw):
            calls[name] = (args, kw)
            return fn(*args, **kw)
        return call

    saved = alc3.encode_words, alc3.decode_words
    alc3.encode_words = recording("encode_words", encode_words)
    alc3.decode_words = recording("decode_words", decode_words)
    try:
        ns = Alc3Codec(QUALITY, "cdf53", sparse=True)
        ns.decode(ns.encode(rgb))
        del ns
    finally:
        alc3.encode_words, alc3.decode_words = saved
    (ns_sym, ns_f, ns_c), ns_kw = calls["encode_words"]
    (ns_st, ns_cn, _, _), ns_dkw = calls["decode_words"]
    got = encode_words(ns_sym, ns_f, ns_c, **ns_kw)
    want = encode_words_plain(ns_sym, ns_f, ns_c, **ns_kw)
    err = max(max_abs_err(got[0], want[0]), max_abs_err(got[1], want[1]),
              max_abs_err(got[0], ns_st), max_abs_err(got[1], ns_cn))
    check(err == 0, f"encode_words differs from its plain version on the north "
                    f"star's planes by {err}")
    del got, want
    d_k = decode_words(ns_st, ns_cn, ns_f, ns_c, **ns_dkw)
    err3 = max(max_abs_err(d_k, decode_words_plain(ns_st, ns_cn, ns_f, ns_c,
                                                   **ns_dkw)),
               max_abs_err(d_k, ns_sym))
    check(err3 == 0, f"decode_words differs from its plain version on the north "
                     f"star's planes by {err3}")
    ns_words = int(ns_cn.to(torch.int64).sum().item())
    stats["encode_words"].update(
        planes_north_star=list(ns_kw["planes"]),
        ms_north_star=time_ms(lambda: encode_words(ns_sym, ns_f, ns_c, **ns_kw), 5),
        bound_ms_north_star=bound_ms(ns_sym.numel() + ns_st.numel() * 4
                                     + ns_cn.numel() * 4))
    stats["decode_words"].update(
        ms_north_star=time_ms(
            lambda: decode_words(ns_st, ns_cn, ns_f, ns_c, **ns_dkw), 5),
        bound_ms_north_star=bound_ms(ns_words * 4 + ns_cn.numel() * 4
                                     + d_k.numel()))
    print(f"rANS on the north star's planes: {ns_sym.shape[0]} segments in one "
          f"launch each way (segments per table {list(ns_kw['planes'])}), "
          f"bit-exact; encode_words {stats['encode_words']['ms_north_star']:.3f} "
          f"ms, decode_words {stats['decode_words']['ms_north_star']:.3f} ms "
          f"[{card}]")
    del calls, ns_sym, ns_st, ns_cn, d_k
    torch.cuda.empty_cache()

    # K5 / K6 at small shapes: densities 0-100 % with capacities that
    # differ per plane, then a hostile bitmap (popcount past its capacity)
    pp_small = 1 << 20
    for density in (0.0, 0.03, 0.3, 1.0):
        planes = np.stack([
            np.where(rng.random(pp_small) < d, rng.integers(1, 256, pp_small), 0)
            for d in (density, density / 2, 0.9 * density)]).astype(np.uint8)
        sym_t = torch.as_tensor(planes, device=dev)
        trows = tile_rows(sym_t)
        krs = tuple(r + 8 * (i + 1)
                    for i, r in enumerate(trows.sum(-1).tolist()))
        bm_k, vals_k = compact(sym_t, trows, krs)
        bm_p, vals_p = compact_plain(sym_t, trows, krs)
        check(max_abs_err(bm_k, bm_p) == 0 and max_abs_err(vals_k, vals_p) == 0,
              f"compact differs from its plain version at density {density}")
        out_k = expand(bm_k, vals_k, krs)
        check(max_abs_err(out_k, expand_plain(bm_k, vals_k, krs)) == 0,
              f"expand differs from its plain version at density {density}")
        check(bool(torch.equal(out_k, sym_t)),
              f"expand does not invert compact at density {density}")
    krs_h = (64, 1024)
    bm_h = torch.as_tensor(rng.integers(0, 256, (2, pp_small // 8), dtype=np.uint8),
                           device=dev)
    vals_h = torch.as_tensor(rng.integers(0, 256, (sum(krs_h), NG), dtype=np.uint8),
                             device=dev)
    check(max_abs_err(expand(bm_h, vals_h, krs_h),
                      expand_plain(bm_h, vals_h, krs_h)) == 0,
          "expand differs from its plain version on a hostile bitmap")
    print("small shapes: compact / expand bit-exact (densities 0, 3, 30, 100 %, "
          "per-plane capacities; hostile bitmap)")

    # K5 / K6 at full width: the chroma planes of the q=50 chunk, at the
    # capacities the q=50 path gives them
    step50 = quality_to_step(50)
    pp = alc3._sparse_pp(p)
    sym50, trows50, _ = pipeline.encode_sparse_phase1(
        rgb, step50, step50, wavelet_type=wt, padded=padded, pp=pp, active=(1, 2))
    rows50 = trows50.sum(-1).tolist()
    krs50, _ = Alc3Codec(50, "cdf53", sparse=True)._settle_krs(rows50, (1, 2), pp)
    check(all(0 < k < alc3._segment_geometry(pp, alc3.DEFAULT_S_SEG)[0]
              * alc3.DEFAULT_S_SEG for k in krs50),
          f"the q=50 chroma planes are not sparse (capacity rows {krs50})")
    bm_k, vals_k = compact(sym50, trows50, krs50)
    bm_p, vals_p = compact_plain(sym50, trows50, krs50)
    err = max(max_abs_err(bm_k, bm_p), max_abs_err(vals_k, vals_p))
    check(err == 0, f"compact differs from its plain version by {err}")
    del bm_p, vals_p
    used = sum(rows50) * NG
    stats["compact"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: compact(sym50, trows50, krs50), 10),
        plain_ms=time_ms(lambda: compact_plain(sym50, trows50, krs50), 2),
        bound_ms=bound_ms(sym50.numel() + trows50.numel() * 4 + bm_k.numel()
                          + used))
    out_k = expand(bm_k, vals_k, krs50)
    err = max_abs_err(out_k, expand_plain(bm_k, vals_k, krs50))
    check(err == 0, f"expand differs from its plain version by {err}")
    check(bool(torch.equal(out_k, sym50)), "expand does not invert compact")
    stats["expand"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: expand(bm_k, vals_k, krs50), 10),
        plain_ms=time_ms(lambda: expand_plain(bm_k, vals_k, krs50), 2),
        bound_ms=bound_ms(bm_k.numel() + used + out_k.numel()))
    # the codec's in-place calls: the planes read where phase 1 left them,
    # bitmaps and values written into a wire segment buffer that holds
    # other bytes (the bitmap segments' tails and the value rows past the
    # used ones must come back zero), the symbols into the rows of the
    # decoded planes (p < pp)
    _, mb50 = alc3._segment_geometry(pp // 8, alc3.DEFAULT_S_SEG)
    sizes = [mb50, mb50] + [k * NG for k in krs50]
    seg_k = torch.full((sum(sizes),), 0xA5, dtype=torch.uint8, device=dev)
    seg_p = torch.full_like(seg_k, 0x5A)
    views_k, views_p = torch.split(seg_k, sizes), torch.split(seg_p, sizes)
    out_ip = (list(views_k[:2]), list(views_k[2:]))
    compact(sym50, trows50, krs50, pick=(0, 1), out=out_ip)
    compact_plain(sym50, trows50, krs50, pick=(0, 1),
                  out=(list(views_p[:2]), list(views_p[2:])))
    err = max_abs_err(seg_k, seg_p)
    check(err == 0, f"compact in place differs from its plain version by {err}")
    bm_ip = [v[: pp // 8] for v in views_k[:2]]
    dec_k = torch.full((3, p), 0xC3, dtype=torch.uint8, device=dev)
    dec_p = torch.full_like(dec_k, 0xC3)
    expand(bm_ip, out_ip[1], krs50, out=[dec_k[1], dec_k[2]])
    expand_plain(bm_ip, out_ip[1], krs50, out=[dec_p[1], dec_p[2]])
    err = max_abs_err(dec_k, dec_p)
    check(err == 0 and bool(torch.equal(dec_k[1:], sym50[:, :p])),
          f"expand in place differs from its plain version by {err}")
    del seg_p, dec_p
    stats["compact"]["ms_in_place"] = time_ms(
        lambda: compact(sym50, trows50, krs50, pick=(0, 1), out=out_ip), 10)
    stats["expand"]["ms_in_place"] = time_ms(
        lambda: expand(bm_ip, out_ip[1], krs50, out=[dec_k[1], dec_k[2]]), 10)
    print(f"sparse in place: 2 planes into a {sum(sizes)}-byte segment buffer "
          f"and back into rows of {p} symbols, bit-exact; compact "
          f"{stats['compact']['ms_in_place']:.3f} ms, expand "
          f"{stats['expand']['ms_in_place']:.3f} ms [{card}]")
    # a wrapper call on the card is its kernels (the group scan of the
    # tile bases, then the kernel) and nothing else: no torch prepass
    # (tile counts, prefix sums) and no fill of the values buffer
    ours = ("::group_rows(", "::scan_groups(")
    for name, calls in (
            ("compact", (lambda: compact(sym50, trows50, krs50),
                         lambda: compact(sym50, trows50, krs50, pick=(0, 1),
                                         out=out_ip))),
            ("expand", (lambda: expand(bm_k, vals_k, krs50),
                        lambda: expand(bm_ip, out_ip[1], krs50,
                                       out=[dec_k[1], dec_k[2]])))):
        for fn in calls:
            fn()
            _, rows = device_profile(fn, need=(f"::{name}(",))
            others = [key[:60] for key, _, _ in rows
                      if not any(k in key for k in (f"::{name}(",) + ours)]
            check(not others, f"a {name} wrapper call launched more than its "
                              f"kernels: {others}")
        split = {k.strip(":("): sum(ms for key, ms, _ in rows if k in key)
                 for k in (f"::{name}(",) + ours}
        stats[name]["kernel_ms"] = sum(split.values())
        stats[name]["kernel_split"] = split
        print(f"{name}: one wrapper call (and one in place) launches its "
              f"kernels alone: " + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
              + f" ms by torch.profiler [{card}]")
    del seg_k, dec_k, out_ip, bm_ip, views_k
    # yardsticks, not the same function: one torch call that gathers the
    # nonzeros (no bitmap, no tile padding), and its scatter back
    mask = sym50 != 0
    nz = torch.masked_select(sym50, mask)
    ms_select = time_ms(lambda: torch.masked_select(sym50, mask), 10)
    ms_scatter = time_ms(
        lambda: torch.zeros_like(sym50).masked_scatter_(mask, nz), 10)
    print(f"sparse: q=50 chroma planes {2} x {pp} symbols, value rows {rows50}, "
          f"capacity rows {list(krs50)}; yardsticks masked_select "
          f"{ms_select:.3f} ms, masked_scatter_ {ms_scatter:.3f} ms [{card}]")
    del sym50, trows50, bm_k, vals_k, out_k, mask, nz
    torch.cuda.empty_cache()
    # 4K: frames the JAX package's fused spatial kernel cannot hold, so it
    # splits the pass into single-axis band kernels (K7b), storing at the
    # input's dtype between them (int16 in the fused kernels, int32 in the
    # plain 3D lift).  Here every lift takes its spatial tile kernel at
    # every frame size: the fused kernels (K1 / K4) with that int16 store,
    # the plain 3D lift (K7) at int32.  Both on a 4K chunk against their
    # plain versions, then a dense q=90 and a deep q=100 roundtrip of it
    # with the launches of the lift wrappers (each K7 launch runs one
    # spatial_tiles).
    t0 = time.perf_counter()
    rgb4k = torch.as_tensor(_test_chunk(T4K, H4K, W4K, seed=1), device=dev)
    padded4k = (W4K, H4K, T4K)
    ch16 = pipeline._color_pad(rgb4k, padded4k)
    check(lift.split_frame(H4K, W4K), "a 4K frame is not split")
    s4 = forward_quant(ch16, wt, step, step)
    check(max_abs_err(s4, forward_quant_plain(ch16, wt, step, step)) == 0,
          "forward_quant differs from its plain version at 4K")
    for exact in (False, True):
        check(max_abs_err(inverse_dequant(s4, wt, step, exact=exact),
                          inverse_dequant_plain(s4, wt, step, exact=exact)) == 0,
              f"inverse_dequant exact={exact} differs at 4K")
    k14_4k = {"forward_quant": time_ms(lambda: forward_quant(ch16, wt, step, step), 5),
              "inverse_dequant": time_ms(lambda: inverse_dequant(s4, wt, step), 5)}
    print(f"4K {T4K}x{H4K}x{W4K}: forward_quant {k14_4k['forward_quant']:.3f} ms, "
          f"inverse_dequant {k14_4k['inverse_dequant']:.3f} ms per call (split "
          f"frames: int16 between the spatial axes) [{card}]")
    del ch16, s4
    torch.cuda.empty_cache()
    ch32 = pipeline._color_pad(rgb4k, padded4k, torch.int32)
    for w4 in WaveletType:
        c4 = forward_3d(ch32, w4)
        check(max_abs_err(c4, forward_3d_plain(ch32, w4)) == 0,
              f"forward_3d {w4.name} differs at 4K")
        for exact in (False, True):
            check(max_abs_err(inverse_3d(c4, w4, exact=exact),
                              inverse_3d_plain(c4, w4, exact=exact)) == 0,
                  f"inverse_3d {w4.name} exact={exact} differs at 4K")
        del c4
        torch.cuda.empty_cache()
    # K7b's time: the int32 spatial_tiles kernel inside one forward_3d call
    forward_3d(ch32, wt)
    _, rows = device_profile(lambda: forward_3d(ch32, wt),
                             need=("spatial_tiles<", "temporal_lift"))
    spatial_ms = sum(ms for key, ms, _ in rows if "spatial_tiles<" in key)
    temporal_ms = sum(ms for key, ms, _ in rows if "temporal_lift" in key)
    steps_f = wavelet.lift_steps(wt)
    k7b_plain = time_ms(lambda: wavelet.lift_axis(
        wavelet.lift_axis(ch32, steps_f, -1), steps_f, -2), 2)
    k7b_bound = bound_ms(ch32.numel() * 4 * 2)
    del ch32
    torch.cuda.empty_cache()
    reset_launches()
    d4 = Alc3Codec(QUALITY, "cdf53")
    out4 = d4.decode(d4.encode(rgb4k))
    lossless = Alc3Codec(100, "haar")
    out4d = lossless.decode(lossless.encode(rgb4k), exact=True)
    torch.cuda.synchronize()
    launches4k = launch_counts()
    check(launches4k["forward_quant"] == launches4k["inverse_dequant"] == 1,
          f"4K lift launches {launches4k}")
    k7b_launches = launches4k["forward_3d"] + launches4k["inverse_3d"]
    check(k7b_launches == 2, f"4K lift launches {launches4k}")
    check(bool(torch.equal(out4d, rgb4k)),
          "deep q=100 at 4K: exact decode differs from the input")
    mse4 = float(((out4.float() - rgb4k.float()) ** 2).mean().item())
    stats["row_col_lift"] = dict(
        max_abs_err=0, ms=spatial_ms, plain_ms=k7b_plain, bound_ms=k7b_bound,
        kernel_split={"spatial_tiles": spatial_ms, "temporal_lift": temporal_ms})
    print(f"4K {T4K}x{H4K}x{W4K}: forward_quant / inverse_dequant / "
          f"forward_3d / inverse_3d bit-exact; spatial_tiles "
          f"{spatial_ms:.3f} ms (temporal pass {temporal_ms:.3f}) in one "
          f"forward_3d (plain W+H lift "
          f"{k7b_plain:.1f} ms); dense q=90 PSNR "
          f"{10 * np.log10(255.0 ** 2 / mse4):.4f} dB, deep q=100 lossless; "
          f"{k7b_launches} K7 launches (one spatial_tiles each), "
          f"{time.perf_counter() - t0:.1f} s "
          f"[{card}]")
    del rgb4k, out4, out4d, d4, lossless
    torch.cuda.empty_cache()

    # K8 / K9 at full width: every (chunk, channel) stream of the ALC2 batch
    # (4 x 3 streams of 4096 lanes x 32,400 steps, each under its own
    # sanitized table), plus the Y plane of chunk 0 under a skewed table
    # (symbol 0 dominant) that forces two-byte emits — one launch each
    # against one call of the plain version on the same streams
    t0 = time.perf_counter()
    batch_np = np.stack([rgb_np] + [f.result() for f in more_chunks])
    pool.shutdown()
    batch_dev = torch.as_tensor(batch_np, device=dev)
    b_enc = BatchFrameEncoder(QUALITY, "cdf53", n_lanes=ALC2_LANES,
                              device_entropy=True)
    sym_b, hist_b = b_enc.encode_device_stage(batch_dev)
    n_str = ALC2_CHUNKS * 3
    n_sym = _lane_sym_count(p, ALC2_LANES)
    check(n_sym == sym_b.shape[-1] == p, f"ALC2 symbols per channel {n_sym}")
    steps_n = n_sym // ALC2_LANES
    skew = np.ones(256, np.uint32)
    skew[0] = 1 << 30
    tabs = [FrequencyTable.from_histogram(h, sanitize=True)
            for h in hist_b.reshape(n_str, 256).cpu().numpy().astype(np.uint32)]
    tabs.append(FrequencyTable.from_histogram(skew, sanitize=True))
    syms = torch.cat([sym_b.reshape(n_str, p), sym_b[0, :1]])
    f_t = torch.as_tensor(np.stack([tb.freqs for tb in tabs]).astype(np.int32),
                          device=dev)
    c_t = torch.as_tensor(np.stack([tb.cums for tb in tabs]).astype(np.int32),
                          device=dev)
    lut_t = torch.as_tensor(np.stack([tb.cum_to_sym for tb in tabs]), device=dev)
    del sym_b

    def events_ms(fn):
        """(result, device ms) of one call of ``fn``, by CUDA events."""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        r = fn()
        end.record()
        torch.cuda.synchronize()
        return r, start.elapsed_time(end)

    # K8's two routes: the per-step layout (encode_nway) and the packed
    # payload (encode_pack_nway), against one call of the plain encode and
    # the plain pack of its output; K9 on the packed payload
    k8 = encode_nway(syms, f_t, c_t, n_lanes=ALC2_LANES)
    p8, k8_plain_ms = events_ms(
        lambda: encode_nway_plain(syms, f_t, c_t, n_lanes=ALC2_LANES))
    err = max(max_abs_err(a, b) for a, b in zip(k8, p8))
    check(err == 0, f"encode_nway differs from its plain version by {err}")
    del k8
    pairs = int((p8[1][-1] == 2).sum().item())
    check(pairs > 0, "the skewed stream emitted no byte pairs")
    k8p = encode_pack_nway(syms, f_t, c_t, n_lanes=ALC2_LANES)
    pp8, pack_plain_ms = events_ms(lambda: pack_streams(*p8))
    del p8
    err_p = max(max_abs_err(a, b) for a, b in zip(k8p, pp8))
    check(err_p == 0, f"encode_pack_nway differs from its plain version by {err_p}")
    del pp8
    payload_t, lens_t, totals_t = k8p
    del k8p
    tot_l = totals_t.tolist()
    starts_t = lane_offsets(lens_t).reshape(lens_t.shape)
    k9 = decode_nway(payload_t, starts_t, lens_t, f_t, c_t, lut_t, steps=steps_n)
    p9, k9_plain_ms = events_ms(lambda: decode_nway_plain(
        payload_t, starts_t, lens_t, f_t, c_t, lut_t, steps=steps_n))
    err9 = max_abs_err(k9, p9)
    check(err9 == 0, f"decode_nway differs from its plain version by {err9}")
    check(bool(torch.equal(k9.reshape(n_str + 1, -1), syms)),
          "decode_nway does not invert encode_pack_nway")
    del p9, k9
    torch.cuda.empty_cache()
    # timed on the main path's 12 streams
    m8 = (syms[:n_str], f_t[:n_str], c_t[:n_str])
    main_bytes = sum(tot_l[:n_str])
    m9 = (payload_t[:main_bytes], starts_t[:n_str], lens_t[:n_str],
          f_t[:n_str], c_t[:n_str], lut_t[:n_str])
    stats["encode_nway"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: encode_nway(*m8, n_lanes=ALC2_LANES), 5),
        plain_ms=k8_plain_ms, plain_streams=n_str + 1,
        # symbols in; two byte slots, a count per step and the states out
        bound_ms=bound_ms(n_str * n_sym * (1 + 2 + 1) + n_str * ALC2_LANES * 8))
    # the route's two passes timed apart (CUDA events): the coder into the
    # slabs, and the compaction with its lane-offset scan and size read
    slabs_t = rans_nway._encode_slabs_cuda(*m8, ALC2_LANES)
    stats["encode_pack_nway"] = dict(
        max_abs_err=err_p,
        ms=time_ms(lambda: encode_pack_nway(*m8, n_lanes=ALC2_LANES), 5),
        passes_ms={
            "encode_slabs": time_ms(
                lambda: rans_nway._encode_slabs_cuda(*m8, ALC2_LANES), 5),
            "compact_lanes": time_ms(lambda: rans_nway._compact_cuda(*slabs_t), 5)},
        # the plain encode and the plain pack of its output
        plain_ms=k8_plain_ms + pack_plain_ms, plain_pack_ms=pack_plain_ms,
        plain_streams=n_str + 1,
        # symbols in; the packed payload and the lane lengths out
        bound_ms=bound_ms(n_str * n_sym + main_bytes + n_str * ALC2_LANES * 4))
    del slabs_t
    stats["decode_nway"] = dict(
        max_abs_err=err9,
        ms=time_ms(lambda: decode_nway(*m9, steps=steps_n), 5),
        plain_ms=k9_plain_ms, plain_streams=n_str + 1,
        # the lanes' bytes in (with their starts and lengths); symbols out
        bound_ms=bound_ms(main_bytes + n_str * ALC2_LANES * 12 + n_str * n_sym))
    print(f"N-lane rANS: {n_str} + 1 streams of {ALC2_LANES} lanes x {steps_n} "
          f"steps bit-exact against the plain versions (the skewed stream "
          f"{pairs} byte pairs); the {n_str} main-path streams hold "
          f"{main_bytes} payload bytes; {time.perf_counter() - t0:.1f} s "
          f"(plain calls {k8_plain_ms / 1e3:.1f} + {pack_plain_ms / 1e3:.1f} + "
          f"{k9_plain_ms / 1e3:.1f} s for {n_str + 1} streams) [{card}]")
    print("encode_pack_nway passes: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in stats["encode_pack_nway"]["passes_ms"].items())
        + f" [{card}]")
    del syms, payload_t, starts_t, lens_t, totals_t, m8, m9, f_t, c_t, lut_t
    torch.cuda.empty_cache()

    for name, s in stats.items():
        print(f"{name}: {s['ms']:.3f} ms per launch (plain {s['plain_ms']:.1f} ms, "
              f"bytes bound {s['bound_ms']:.3f} ms), max |kernel - plain| "
              f"{s['max_abs_err']} [{card}]")

    # ── 3. the JAX-written goldens ──────────────────────────────
    gdir = ROOT / "tests" / "golden" / "torch"
    man = json.loads((gdir / "manifest.json").read_text())
    for name, digest in man["sha256"].items():
        check(sha256(gdir / name) == digest,
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

    sdir = gdir / "sparse"
    cases = json.loads((sdir / "manifest.json").read_text())["cases"]
    n_files = 0
    for case, spec in cases.items():
        s_codec = Alc3Codec(spec["quality"], spec["wavelet"], s_seg=spec["s_seg"],
                            sparse=True)
        for ck in spec["chunks"]:
            chunk = s_codec.encode(golden_input(ck["kind"], ck["seed"], ck["shape"]))
            if "file" not in ck:  # primes the codec's caches only
                continue
            data = (sdir / ck["file"]).read_bytes()
            check(sha256(sdir / ck["file"]) == ck["sha256"],
                  f"sparse golden {ck['file']} does not match its manifest")
            check(list(chunk.kcaps) == ck["kcaps"],
                  f"sparse golden {ck['file']}: capacities {chunk.kcaps}")
            check(Alc3Codec.to_bytes(chunk) == data,
                  f"sparse golden {ck['file']}: re-encode differs")
            _, chunks = Alc3Codec.from_bytes(data)
            got = s_codec.decode(chunks[0], as_numpy=True)
            check(hashlib.sha256(got.tobytes()).hexdigest() == ck["rgb_sha256"],
                  f"sparse golden {ck['file']}: decode differs from the JAX decode")
            n_files += 1
    print(f"sparse goldens: {n_files} JAX containers decoded bit-exact and "
          f"re-encoded byte-identical (cases {', '.join(cases)})")

    mdir = gdir / "modes"
    mcases = json.loads((mdir / "manifest.json").read_text())["cases"]
    for case, spec in mcases.items():
        data = (mdir / spec["file"]).read_bytes()
        check(sha256(mdir / spec["file"]) == spec["sha256"],
              f"mode golden {spec['file']} does not match its manifest")
        m_codec = Alc3Codec(**spec["codec"])
        m_rgb = golden_input(spec["kind"], spec["seed"], spec["shape"])
        chunk = m_codec.encode(m_rgb)
        check(list(chunk.kcaps) == spec["kcaps"],
              f"mode golden {case}: capacities {chunk.kcaps}")
        check(Alc3Codec.to_bytes(chunk) == data,
              f"mode golden {case}: re-encode differs")
        _, chunks = Alc3Codec.from_bytes(data)
        for exact, key in ((False, "rgb_sha256"), (True, "rgb_exact_sha256")):
            got = m_codec.decode(chunks[0], exact=exact, as_numpy=True)
            check(hashlib.sha256(got.tobytes()).hexdigest() == spec[key],
                  f"mode golden {case}: decode (exact={exact}) differs from "
                  f"the JAX decode")
    print(f"mode goldens: {len(mcases)} JAX containers (deep, rdo, levels "
          f"x sparse) decoded bit-exact in both inverse modes and re-encoded "
          f"byte-identical (cases {', '.join(mcases)})")

    # the `.alc` fixtures: 48 from the independent C++ pipeline, the rest
    # written by the JAX package; each decodes on the card to its RGB and
    # its closed-form input re-encodes to its bytes
    t0 = time.perf_counter()
    n_alc = {}
    for kind in ("cpp", "self"):
        adir = ROOT / "tests" / "golden" / kind
        recs = json.loads((adir / "manifest.json").read_text())["fixtures"]
        for rec in recs:
            data = (adir / f"{rec['name']}.alc").read_bytes()
            check(hashlib.sha256(data).hexdigest() == rec["alc_sha256"],
                  f".alc golden {kind}/{rec['name']} does not match its manifest")
            got = FrameDecoder().decode(EncodedChunk.from_bytes(data))
            check(hashlib.sha256(got.tobytes()).hexdigest() == rec["rgb_sha256"],
                  f".alc golden {kind}/{rec['name']}: decode differs")
            enc = FrameEncoder(rec["quality"], rec["wavelet"]).encode(
                golden_rgb(rec["w"], rec["h"], rec["f"]), rec["w"], rec["h"],
                rec["f"])
            check(enc.to_bytes() == data,
                  f".alc golden {kind}/{rec['name']}: re-encode differs")
        n_alc[kind] = len(recs)
    check(n_alc["cpp"] == 48, f"{n_alc['cpp']} C++ fixtures, expected 48")
    print(f".alc goldens: {n_alc['cpp']} C++ and {n_alc['self']} JAX-written "
          f"containers decoded to their RGB and re-encoded byte-identical on "
          f"the card ({time.perf_counter() - t0:.1f} s)")

    # ── 4. the paths at full width ──────────────────────────────
    paths = {"dense_q90": Alc3Codec(QUALITY, "cdf53")}
    for q in SPARSE_Q:
        paths[f"sparse_q{q}"] = Alc3Codec(q, "cdf53", sparse=True)
    paths.update(
        deep_q100=Alc3Codec(100, "haar"),
        rdo_q90=Alc3Codec(QUALITY, "cdf53", rdo=True),
        deep_sparse_q100=Alc3Codec(100, "haar", sparse=True),
        rdo_sparse_q90=Alc3Codec(QUALITY, "cdf53", rdo=True, sparse=True),
        levels3_q90=Alc3Codec(QUALITY, "cdf53", levels=3))

    def settings(codec, **change):
        kw = dict(quality=codec.quality, wavelet=codec.wavelet_type,
                  rdo=codec.rdo, deep=codec.deep, levels=codec.levels,
                  sparse=codec.sparse)
        kw.update(change)
        return kw

    dense_rgb = {}
    by_path = {}
    rgb_by_path = {}
    for name, codec in paths.items():
        exact = codec.deep  # deep q=100 is lossless with the exact inverse
        out = codec.decode(codec.encode(rgb))  # warm-up (fills the caches)
        torch.cuda.synchronize()
        del out
        reset_launches()
        chunk = codec.encode(rgb)
        out = codec.decode(chunk, exact=exact)
        torch.cuda.synchronize()
        launches = launch_counts()
        rgb_by_path[name] = rgb_n = (lift.forward_quant.rgb_launches,
                                     lift.inverse_dequant.rgb_launches)
        print(f"{name} launches: {launches}; of K1 / K4 from / to RGB: {rgb_n}")
        fused = not (codec.rdo or codec.deep or codec.levels > 1)
        # the colour in K1's load and K4's store wherever K1 / K4 run here
        check(rgb_n == (launches["forward_quant"], launches["inverse_dequant"])
              and rgb_n[1] == fused,
              f"{name}: K1 / K4 RGB launches {rgb_n}, launches {launches}")
        if fused:
            need = ["forward_quant", "encode_words", "decode_words",
                    "inverse_dequant"]
        else:
            need = ["forward_3d", "encode_words", "decode_words", "inverse_3d"]
            check(launches["forward_quant"] == launches["inverse_dequant"] == 0,
                  f"{name}: the fused lift kernels ran on a plain-lift path")
            if not codec.sparse:
                check(all(launches[k] == 1 for k in need),
                      f"{name}: expected one launch of each of {need}")
        if name == "sparse_q50":
            need += ["compact", "expand"]
        for k in need:
            check(launches[k] > 0, f"kernel {k} was not launched on {name}")
        check(launches["encode_words"] == launches["decode_words"] == 1,
              f"{name}: expected one encode_words and one decode_words launch "
              f"a roundtrip, got {launches}")

        s_seg = chunk.s_seg
        if fused:
            if chunk.sparse:
                sym_enc, _, _ = pipeline.encode_sparse_phase1(
                    rgb, codec.step, codec.step,
                    wavelet_type=codec.wavelet_type, padded=padded, pp=pp)
                sym_enc = sym_enc[:, :p]
                nb, _ = alc3._segment_geometry(pp // 8, s_seg)
                sym_dec = alc3._sparse_entropy_expand(
                    chunk.streams, chunk.counts, chunk.hists, p=p,
                    s_seg=s_seg, kcaps=chunk.kcaps, v_b=alc3._pick_v_seg(nb))
            else:
                sym_enc, _ = pipeline.encode_device(
                    rgb, codec.step, codec.step,
                    wavelet_type=codec.wavelet_type, padded=padded,
                    hist_stride=alc3.HIST_STRIDE, interleaved=True)
                sym_dec = alc3._entropy_decode(
                    chunk.streams, chunk.counts, chunk.hists, padded=padded,
                    s_seg=s_seg, v_seg=alc3._pick_v_seg(chunk.n_segments))
            check(bool(torch.equal(sym_enc, sym_dec)),
                  f"{name}: decoded symbols differ from the encoded symbols")
            del sym_enc, sym_dec
        data = Alc3Codec.to_bytes(chunk)
        with plain_kernels():
            p_codec = Alc3Codec(**settings(codec))
            p_chunk = p_codec.encode(rgb)
            p_data = Alc3Codec.to_bytes(p_chunk)
            p_out = p_codec.decode(p_chunk, exact=exact)
        check(data == p_data, f"{name}: container differs from the plain pipeline's")
        check(bool(torch.equal(out, p_out)),
              f"{name}: RGB differs from the plain pipeline's")
        del p_chunk, p_out
        if codec.deep and codec.quality == 100:
            check(bool(torch.equal(out, rgb)),
                  f"{name}: the exact decode differs from the input RGB")
        twin = tuple(settings(codec, sparse=False).values())
        if chunk.sparse:
            if dense_rgb.get(twin) is None:
                d_codec = Alc3Codec(**settings(codec, sparse=False))
                dense_rgb[twin] = d_codec.decode(d_codec.encode(rgb), exact=exact)
            check(bool(torch.equal(out, dense_rgb[twin])),
                  f"{name}: RGB differs from the dense codec's")
        else:
            dense_rgb[twin] = out
        mse = float(((out.float() - rgb.float()) ** 2).mean().item())
        psnr = 10 * np.log10(255.0 ** 2 / mse) if mse else float("inf")
        ratio = rgb_np.nbytes / max(chunk.compressed_size, 1)
        kc = f", kcaps {list(chunk.kcaps)}" if chunk.sparse else ""
        bs = (f", band steps {chunk.band_steps.tolist()}"
              if chunk.band_steps is not None else "")
        print(f"{name}: {len(data)} container bytes, compression {ratio:.4f}x, "
              f"PSNR {psnr:.4f} dB{kc}{bs}; equal to the plain pipeline"
              + ("; RGB equal to the dense codec's" if chunk.sparse else ""))
        by_path[name] = launches
        if name == "sparse_q50":  # phase 4d's CLI file is this container
            sparse50 = (data, out)
        del out, chunk
        torch.cuda.empty_cache()
    del dense_rgb
    torch.cuda.empty_cache()

    def quality_of(out, ref, payload_bytes, n_chunks=1):
        mse = float(((out.float() - ref.float()) ** 2).mean().item())
        psnr = 10 * np.log10(255.0 ** 2 / mse) if mse else float("inf")
        return rgb_np.nbytes * n_chunks / max(payload_bytes, 1), psnr

    # the `.alc` single chunk: encode stage on the card, serial host rANS
    fe, fd = FrameEncoder(QUALITY, "cdf53"), FrameDecoder()
    reset_launches()
    t0 = time.perf_counter()
    a_chunk = fe.encode(rgb, W, H, T)
    a_data = a_chunk.to_bytes()
    t1 = time.perf_counter()
    a_out = fd.decode(EncodedChunk.from_bytes(a_data))
    t_alc = (t1 - t0, time.perf_counter() - t1)
    launches = launch_counts()
    print(f"alc_q90 launches: {launches}")
    check(only_launches(launches, {"forward_quant": 1, "inverse_3d": 1}),
          f"alc_q90: expected forward_quant 1 and inverse_3d 1, got {launches}")
    by_path["alc_q90"] = launches
    with plain_kernels():
        pa_data = FrameEncoder(QUALITY, "cdf53").encode(rgb, W, H, T).to_bytes()
        pa_out = FrameDecoder().decode(EncodedChunk.from_bytes(pa_data))
    check(a_data == pa_data, "alc_q90: container differs from the plain pipeline's")
    check(np.array_equal(a_out, pa_out),
          "alc_q90: RGB differs from the plain pipeline's")
    del pa_out
    ratio, psnr = quality_of(torch.as_tensor(a_out, device=dev).reshape(rgb.shape),
                             rgb, a_chunk.compressed_size)
    print(f"alc_q90: {len(a_data)} container bytes, compression {ratio:.4f}x, "
          f"PSNR {psnr:.4f} dB; equal to the plain pipeline; first run "
          f"encode {t_alc[0]:.3f} s, decode {t_alc[1]:.3f} s [{card}]")
    alc90 = (a_data, a_out)  # phase 4d's CLI and shim files are this chunk
    del a_out, a_chunk

    # the ALC2 batch, device entropy (bench.py config4_alc_batched_decode)
    b_dec = BatchFrameDecoder(device_entropy=True)
    reset_launches()
    t0 = time.perf_counter()
    stream = b_enc.encode(batch_dev)
    s_data = stream.to_bytes()
    t1 = time.perf_counter()
    b_out = b_dec.decode(EncodedChunkStream.from_bytes(s_data), as_numpy=False)
    torch.cuda.synchronize()
    t_alc2 = (t1 - t0, time.perf_counter() - t1)
    launches = launch_counts()
    print(f"alc2_q90 launches: {launches}")
    check(only_launches(launches, {"forward_quant": ALC2_CHUNKS,
                                   "inverse_3d": ALC2_CHUNKS,
                                   "encode_pack_nway": 1, "decode_nway": 1}),
          f"alc2_q90: expected forward_quant {ALC2_CHUNKS}, inverse_3d "
          f"{ALC2_CHUNKS}, encode_pack_nway 1, decode_nway 1, got {launches}")
    by_path["alc2_q90"] = launches
    t0 = time.perf_counter()
    host = BatchFrameEncoder(QUALITY, "cdf53", n_lanes=ALC2_LANES).encode(batch_dev)
    t_host_enc = time.perf_counter() - t0
    check(host.payload == stream.payload,
          "alc2_q90: device-entropy payload differs from the host coder's")
    check(host.to_bytes() == s_data,
          "alc2_q90: device-entropy stream differs from the host coder's")
    del host
    t0 = time.perf_counter()
    h_out = BatchFrameDecoder().decode(EncodedChunkStream.from_bytes(s_data),
                                       as_numpy=False)
    torch.cuda.synchronize()
    t_host_dec = time.perf_counter() - t0
    check(bool(torch.equal(h_out, b_out)),
          "alc2_q90: RGB differs from the host-entropy decode")
    del h_out
    ratio, psnr = quality_of(b_out, batch_dev, stream.compressed_size, ALC2_CHUNKS)
    print(f"alc2_q90: {ALC2_CHUNKS} chunks, {len(s_data)} stream bytes, "
          f"compression {ratio:.4f}x, PSNR {psnr:.4f} dB; payload and stream "
          f"equal to the host coder's, RGB equal to the host decode's; first "
          f"run encode {t_alc2[0]:.3f} s, decode {t_alc2[1]:.3f} s; host "
          f"entropy encode {t_host_enc:.3f} s, decode {t_host_dec:.3f} s [{card}]")
    del b_out
    torch.cuda.empty_cache()

    # ── 4b. batches, chunk meshes and streams ───────────────────
    # (a function, so that nothing it leaves on the card outlives it)
    def batches_meshes_streams():
        # two chunks of different seeds (the ALC2 batch's first two), each
        # batch path's roundtrip with the launch counts set to 0 just before
        # it and read just after: K1 / K4 once a chunk, K2 / K3 (and on q=50
        # K5 / K6) once a batch
        rgb2 = batch_dev[:2]
        batch_paths = {"batch_dense_q90": Alc3Codec(QUALITY, "cdf53"),
                       "batch_sparse_q90": Alc3Codec(QUALITY, "cdf53", sparse=True),
                       "batch_sparse_q50": Alc3Codec(50, "cdf53", sparse=True)}
        batch_data = {}
        for name, codec in batch_paths.items():
            out = codec.decode_batch(codec.encode_batch(rgb2))  # warm-up (fills the caches)
            torch.cuda.synchronize()
            del out
            caches = dict(codec._krs_cache), dict(codec._active_cache)
            reset_launches()
            chunks = codec.encode_batch(rgb2)
            out = codec.decode_batch(chunks)
            torch.cuda.synchronize()
            launches = launch_counts()
            print(f"{name} launches: {launches}")
            want = {"forward_quant": 2, "encode_words": 1, "decode_words": 1,
                    "inverse_dequant": 2}
            if name == "batch_sparse_q50":
                want.update(compact=1, expand=1)
            check(only_launches(launches, want), f"{name}: expected {want}, got {launches}")
            by_path[name] = launches
            rgb_by_path[name] = rgb_n = (lift.forward_quant.rgb_launches,
                                         lift.inverse_dequant.rgb_launches)
            check(rgb_n == (2, 2), f"{name}: K1 / K4 RGB launches {rgb_n}")
            datas = [Alc3Codec.to_bytes(c) for c in chunks]
            with plain_kernels():
                p_codec = Alc3Codec(**settings(codec))
                p_codec._krs_cache, p_codec._active_cache = (dict(c) for c in caches)
                p_chunks = p_codec.encode_batch(rgb2)
                p_datas = [Alc3Codec.to_bytes(c) for c in p_chunks]
                p_out = p_codec.decode_batch(p_chunks)
            check(datas == p_datas,
                  f"{name}: containers differ from the plain pipeline's")
            check(bool(torch.equal(out, p_out)),
                  f"{name}: RGB differs from the plain pipeline's")
            del p_chunks, p_out
            for i, ck in enumerate(chunks):
                check(bool(torch.equal(out[i], codec.decode(ck))),
                      f"{name}: chunk {i} of decode_batch differs from its decode")
            if not codec.sparse:
                single = Alc3Codec(**settings(codec))
                check(datas == [Alc3Codec.to_bytes(single.encode(rgb2[i]))
                                for i in range(2)],
                      f"{name}: containers differ from per-chunk encode's")
            batch_data[name] = datas
            kc = [list(c.kcaps) for c in chunks] if codec.sparse else ""
            del chunks, out
            torch.cuda.empty_cache()

            def as_batch(codec=codec):
                codec.decode_batch(codec.encode_batch(rgb2))
                torch.cuda.synchronize()

            def per_chunk(codec=codec):
                for i in range(2):
                    codec.decode(codec.encode(rgb2[i]))
                torch.cuda.synchronize()

            # peak memory of each form from its warm-up call, then the two
            # forms in turns (host clock)
            peak = {}
            for form, fn in (("batch", as_batch), ("chunk", per_chunk)):
                torch.cuda.reset_peak_memory_stats()
                fn()
                peak[form] = torch.cuda.max_memory_allocated() / 2**30
            reps, t_form = 4, {"batch": 0.0, "chunk": 0.0}
            for _ in range(reps):
                for form, fn in (("batch", as_batch), ("chunk", per_chunk)):
                    t0 = time.perf_counter()
                    fn()
                    t_form[form] += time.perf_counter() - t0
            busy = {}
            for form, fn in (("batch", as_batch), ("chunk", per_chunk)):
                wall_ms, rows = device_profile(fn)
                busy[form] = (sum(r[1] for r in rows), wall_ms)
            print(f"{name}: {sum(map(len, datas))} container bytes{', kcaps ' if kc else ''}"
                  f"{kc}; equal to the plain pipeline's, rows equal to the per-chunk "
                  f"decode{'' if codec.sparse else ', containers to per-chunk encode'}; "
                  f"roundtrip {2 * reps / t_form['batch']:.4f} chunks/s as batches of "
                  f"2, {2 * reps / t_form['chunk']:.4f} chunks/s per chunk ({reps} of "
                  f"each in turns, host clock, synchronized); peak memory "
                  f"{peak['batch']:.3f} GiB as a batch, {peak['chunk']:.3f} GiB per "
                  f"chunk; device kernel time of two chunks (torch.profiler) "
                  f"{busy['batch'][0]:.3f} ms of {busy['batch'][1]:.3f} ms wall as a "
                  f"batch, {busy['chunk'][0]:.3f} ms of {busy['chunk'][1]:.3f} ms per "
                  f"chunk [{card}]")
            torch.cuda.empty_cache()

        # the chunk mesh over the visible cards: dense streams equal to the
        # batch without a mesh; the sparse mesh roundtrips decode to the
        # per-chunk decode and parse; the ALC2 stream equal without a mesh
        mesh = chunk_mesh()
        print(f"mesh: {mesh.size} device(s) {[str(d) for d in mesh.devices]} [{card}]")
        dense = batch_paths["batch_dense_q90"]
        reset_launches()
        m_chunks = dense.encode_batch(rgb2, mesh=mesh)
        m_out = dense.decode_batch(m_chunks, mesh=mesh)
        torch.cuda.synchronize()
        by_path["mesh_dense_q90"] = launches = launch_counts()
        print(f"mesh_dense_q90 launches: {launches}")
        check([Alc3Codec.to_bytes(c) for c in m_chunks] == batch_data["batch_dense_q90"],
              "mesh_dense_q90: streams differ from the batch without a mesh")
        check(bool(torch.equal(m_out, dense.decode_batch(m_chunks))),
              "mesh_dense_q90: RGB differs from the batch without a mesh")
        del m_chunks, m_out
        for q in SPARSE_Q:
            name = f"mesh_sparse_q{q}"
            codec = Alc3Codec(q, "cdf53", sparse=True)
            reset_launches()
            m_chunks = codec.encode_batch(rgb2, mesh=mesh)
            m_out = codec.decode_batch(m_chunks, mesh=mesh)
            torch.cuda.synchronize()
            by_path[name] = launches = launch_counts()
            print(f"{name} launches: {launches}")
            for i, ck in enumerate(m_chunks):
                data = Alc3Codec.to_bytes(ck)
                _, back = Alc3Codec.from_bytes(data)
                check(bool(torch.equal(m_out[i], codec.decode(ck))),
                      f"{name}: chunk {i} differs from its per-chunk decode")
                check(bool(torch.equal(m_out[i], codec.decode(back[0]))),
                      f"{name}: chunk {i}'s container decodes otherwise")
            print(f"{name}: kcaps {[list(c.kcaps) for c in m_chunks]}; rows equal "
                  f"to the per-chunk decode, containers parse [{card}]")
            del m_chunks, m_out
        m_enc = BatchFrameEncoder(QUALITY, "cdf53", n_lanes=ALC2_LANES,
                                  device_entropy=True, mesh=mesh)
        m_dec = BatchFrameDecoder(device_entropy=True, mesh=mesh)
        reset_launches()
        m_data = m_enc.encode(batch_dev).to_bytes()
        m_out = m_dec.decode(EncodedChunkStream.from_bytes(m_data), as_numpy=False)
        torch.cuda.synchronize()
        by_path["mesh_alc2_q90"] = launches = launch_counts()
        print(f"mesh_alc2_q90 launches: {launches}")
        check(m_data == s_data, "mesh_alc2_q90: stream differs from the one without a mesh")
        check(bool(torch.equal(m_out, b_dec.decode(EncodedChunkStream.from_bytes(s_data),
                                                   as_numpy=False))),
              "mesh_alc2_q90: RGB differs from the decode without a mesh")
        del m_out
        torch.cuda.empty_cache()

        # streaming: 136 frames (three chunks, the last padded by repeating
        # the last frame) through an .alcs3 file, against the per-chunk decode
        frames = np.concatenate([batch_np[0], batch_np[1], batch_np[2][:8]])
        s_codec = Alc3Codec(QUALITY, "cdf53", sparse=True)
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "chunks.alcs3"
            t0 = time.perf_counter()
            with Alc3StreamWriter(path) as wr:
                for data in encode_stream(frames, s_codec):
                    wr.append(data)
            t_enc = time.perf_counter() - t0
            t0 = time.perf_counter()
            got = list(decode_stream(Alc3StreamReader(path)))
            t_dec = time.perf_counter() - t0
            size = path.stat().st_size
        check(len(got) == 3, f"stream: {len(got)} chunks, expected 3")
        padded_frames = np.concatenate([frames, np.repeat(frames[-1:], 3 * T - 136, 0)])
        ref = Alc3Codec(QUALITY, "cdf53", sparse=True)
        for i, g in enumerate(got):
            want_rgb = ref.decode(ref.encode(padded_frames[i * T : (i + 1) * T]),
                                  as_numpy=True)
            check(np.array_equal(g, want_rgb),
                  f"stream: chunk {i} differs from its per-chunk decode")
        print(f"stream: 136 frames of {H}x{W} in 3 chunks, {size} .alcs3 bytes, "
              f"encode_stream + write {t_enc:.3f} s, read + decode_stream "
              f"{t_dec:.3f} s (first run, host clock); frames equal to the "
              f"per-chunk decode [{card}]")

    batches_meshes_streams()
    del batch_np
    torch.cuda.empty_cache()

    # ── 4c. bench.py config3 and config5 ────────────────────────
    by_path.update(bench_routes(rgb, config5_chunk.result(), card))
    torch.cuda.empty_cache()

    # ── 4d. the tools ───────────────────────────────────────────
    by_path.update(tools_routes(rgb_np, sparse50, alc90, card))
    del sparse50, alc90
    torch.cuda.empty_cache()

    # ── 5. timings ──────────────────────────────────────────────
    reps = 3
    torch.cuda.reset_peak_memory_stats()
    t_enc = t_dec = 0.0
    for _ in range(reps):
        t0 = time.perf_counter()
        stream = b_enc.encode(batch_dev)
        t1 = time.perf_counter()
        out = b_dec.decode(stream, as_numpy=False)
        torch.cuda.synchronize()
        t_enc += t1 - t0
        t_dec += time.perf_counter() - t1
        del out
    peak = torch.cuda.max_memory_allocated()
    n_c = reps * ALC2_CHUNKS
    print(f"alc2_q90: encode {n_c / t_enc:.4f} chunks/s, decode "
          f"{n_c / t_dec:.4f} chunks/s, roundtrip {n_c / (t_enc + t_dec):.4f} "
          f"chunks/s over {reps} batches of {ALC2_CHUNKS} x {T}x{H}x{W} (host "
          f"clock, synchronized; stream objects, without to_bytes/from_bytes); "
          f"peak memory {peak / 2**30:.3f} GiB [{card}]")
    t0 = time.perf_counter()
    s_data = stream.to_bytes()
    t1 = time.perf_counter()
    EncodedChunkStream.from_bytes(s_data)
    print(f"alc2_q90: to_bytes {t1 - t0:.3f} s, from_bytes "
          f"{time.perf_counter() - t1:.3f} s (host) [{card}]")
    torch.cuda.reset_peak_memory_stats()
    t_enc = t_dec = 0.0
    for _ in range(2):
        t0 = time.perf_counter()
        a_data = fe.encode(rgb, W, H, T).to_bytes()
        t1 = time.perf_counter()
        fd.decode(EncodedChunk.from_bytes(a_data))
        t_enc += t1 - t0
        t_dec += time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated()
    print(f"alc_q90: encode {t_enc / 2:.3f} s, decode {t_dec / 2:.3f} s per "
          f"{T}x{H}x{W} chunk (mean of 2, host clock, container bytes in and "
          f"out, RGB back on the host); peak memory {peak / 2**30:.3f} GiB "
          f"[{card}]")
    for name, fn, need in (
            ("alc2_q90", lambda: b_dec.decode(b_enc.encode(batch_dev),
                                              as_numpy=False),
             ("compact_lanes", "decode_nway")),
            ("alc_q90", lambda: fd.decode(fe.encode(rgb, W, H, T)), ())):
        wall_ms, rows = device_profile(fn, need)
        busy_ms = sum(r[1] for r in rows)
        print(f"{name} profile: one roundtrip {wall_ms:.3f} ms wall (profiled), "
              f"device kernel time {busy_ms:.3f} ms = "
              f"{100 * busy_ms / wall_ms:.1f} % busy [{card}]")
        for key, ms, count in rows[:16]:
            print(f"  {ms:9.3f} ms  x{count:<3d} {key[:90]}")
        if name == "alc2_q90":
            # K8 (both passes), K9, the lifts and the glue around them
            parts = {"K8 encode_slabs": ("encode_slabs",),
                     "K8 compact_lanes": ("compact_lanes",),
                     "K9 decode_nway": ("decode_nway",),
                     "lifts": ("spatial_tiles", "temporal_"),
                     "copies": ("Memcpy",), "histograms": ("Histogram",)}
            split = {k: sum(ms for key, ms, _ in rows if any(n in key for n in v))
                     for k, v in parts.items()}
            split["other glue"] = busy_ms - sum(split.values())
            print(f"{name} device time by part: " + ", ".join(
                f"{k} {v:.3f} ms" for k, v in split.items()) + f" [{card}]")
    del stream, batch_dev
    torch.cuda.empty_cache()

    reps = 5
    for name, codec in paths.items():
        chunk = codec.encode(rgb)
        torch.cuda.synchronize()
        del chunk
        torch.cuda.reset_peak_memory_stats()
        t_enc = t_dec = 0.0
        t_all = time.perf_counter()
        for _ in range(reps):
            t0 = time.perf_counter()
            chunk = codec.encode(rgb)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = codec.decode(chunk, exact=codec.deep)
            torch.cuda.synchronize()
            t_enc += t1 - t0
            t_dec += time.perf_counter() - t1
            del chunk, out
        t_all = time.perf_counter() - t_all
        peak = torch.cuda.max_memory_allocated()
        print(f"{name}: encode {reps / t_enc:.4f} chunks/s, decode "
              f"{reps / t_dec:.4f} chunks/s, roundtrip {reps / t_all:.4f} "
              f"chunks/s at {T}x{H}x{W} (host clock, synchronized); peak "
              f"memory {peak / 2**30:.3f} GiB [{card}]")

        # where the time goes: one roundtrip under torch.profiler
        wall_ms, rows = device_profile(
            lambda: codec.decode(codec.encode(rgb), exact=codec.deep))
        busy_ms = sum(r[1] for r in rows)
        print(f"{name} profile: one roundtrip {wall_ms:.3f} ms wall (profiled), "
              f"device kernel time {busy_ms:.3f} ms = "
              f"{100 * busy_ms / wall_ms:.1f} % busy [{card}]")
        for key, ms, count in rows[:14]:
            print(f"  {ms:9.3f} ms  x{count:<3d} {key[:90]}")
        for key, ms, count in rows[14:]:
            if any(k in key for k in ("::compact(", "::expand(", "::group_rows(",
                                      "::scan_groups(")):
                print(f"  {ms:9.3f} ms  x{count:<3d} {key[:90]}")

    sources = {
        "forward_quant": ("lift.cu", "alice_codec_tpu/ops/pallas/lift_kernels.py:354"),
        "encode_words": ("rans3.cu", "alice_codec_tpu/ops/pallas/rans3_kernels.py:499"),
        "decode_words": ("rans3.cu", "alice_codec_tpu/ops/pallas/rans3_kernels.py:289"),
        "inverse_dequant": ("lift.cu", "alice_codec_tpu/ops/pallas/lift_kernels.py:375"),
        "compact": ("sparse.cu", "alice_codec_tpu/ops/pallas/sparse_kernels.py:485"),
        "expand": ("sparse.cu", "alice_codec_tpu/ops/pallas/sparse_kernels.py:697"),
        "forward_3d": ("lift.cu", "alice_codec_tpu/ops/pallas/lift_kernels.py:328"),
        "inverse_3d": ("lift.cu", "alice_codec_tpu/ops/pallas/lift_kernels.py:342"),
        # K7b: the split spatial pass, whose counterpart in the plain 3D
        # lift (K7) is its int32 spatial tile kernel (the fused K1 / K4
        # split inside their int16 one); its launches are K7's on the 4K
        # deep roundtrip of phase 2
        "row_col_lift": ("lift.cu", "alice_codec_tpu/ops/pallas/lift_kernels.py:138"),
        # K8 in two routes: the packed payload (the ALC2 path's) and the
        # TPU kernel's own per-step layout, which no path launches
        "encode_pack_nway": ("rans_nway.cu",
                             "alice_codec_tpu/ops/pallas/rans_kernel.py:125"),
        "encode_nway": ("rans_nway.cu", "alice_codec_tpu/ops/pallas/rans_kernel.py:125"),
        "decode_nway": ("rans_nway.cu",
                        "alice_codec_tpu/ops/pallas/rans_decode_kernel.py:132"),
    }
    #: the path whose launches each kernel's entry reports
    main_path = {"compact": "sparse_q50", "expand": "sparse_q50",
                 "forward_3d": "deep_q100", "inverse_3d": "deep_q100",
                 "encode_nway": "alc2_q90", "encode_pack_nway": "alc2_q90",
                 "decode_nway": "alc2_q90"}
    kernels = []
    for name, (src, replaces) in sources.items():
        s = stats[name]
        if name == "row_col_lift":
            launches, by = k7b_launches, {"4k_q100": k7b_launches}
        else:
            launches = by_path[main_path.get(name, "sparse_q50")][name]
            by = {path: n[name] for path, n in by_path.items()}
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"alice_codec_tpu_torch/csrc/{src}",
            "replaces": replaces, "launches": launches,
            "launches_by_path": by,
            **({"rgb_launches_by_path": {
                path: n[name == "inverse_dequant"] for path, n in rgb_by_path.items()}}
               if name in ("forward_quant", "inverse_dequant") else {}),
            "max_abs_err": s["max_abs_err"], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": "bytes", "library_ms": None,
        })
        for extra in ("kernel_ms", "ms_in_place", "plain_streams", "plain_pack_ms",
                      "passes_ms", "rgb",
                      "ms_by_wavelet",
                      "kernel_split", "planes_north_star", "ms_north_star",
                      "bound_ms_north_star"):
            if extra in s:
                kernels[-1][extra] = s[extra]
    print("kernels: " + json.dumps(
        [{k: d[k] for k in ("name", "launches_by_path", "max_abs_err")}
         for d in kernels]))
    print(f"chip_smoke: {time.perf_counter() - t_script:.1f} s in all [{card}]")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
