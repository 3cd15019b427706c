"""Level-0 3D lifting, plain or fused with (de)quantization: the port of
``alice_codec_tpu/ops/pallas/lift_kernels.py`` (forward_quant_pallas,
inverse_dequant_pallas; forward_3d_pallas, inverse_3d_pallas).

Each function has two forms in this module:

* the plain PyTorch version (``*_plain``): the same integer arithmetic as
  the TPU kernels, as whole-tensor ops — what the CPU runs, and what the
  CUDA kernel is held against on the card;
* the wrapper (``forward_quant`` / ``inverse_dequant`` / ``forward_3d`` /
  ``inverse_3d``): takes the plain version for a CPU tensor and launches
  the hand-written Hopper kernel (``csrc/lift.cu``) for a CUDA tensor —
  never the plain version on the card.  Each launch adds one to the
  wrapper's ``launches`` count.

``forward_quant_rgb`` / ``inverse_dequant_rgb`` fold the YCoCg-R colour
(``ops/color.py``) into the fused kernels: K1 loads the interleaved uint8
RGB frames itself and computes the colour flags as it loads, K4 writes
RGB frames, on chunks of :func:`rgb_frame`'s form.  Their plain versions
are the composition they replace.  They launch under the names
``forward_quant`` / ``inverse_dequant`` (each launch also counted in the
wrapper's ``rgb_launches``).

Storage points follow the TPU kernels: int32 inside a pass; the fused
kernels store int16 between the spatial and temporal passes
(``o_ref.astype`` at lift_kernels.py:135 and :193), so an out-of-range
inverse intermediate wraps there.  On frames of more than
``_FRAME_BYTES`` at int16 (4K) the TPU kernels split the spatial pass
into a W pass and an H pass with an int16 store between them
(lift_kernels.py:267-291); the fused kernels here store int16 there too
on those frames (:func:`split_frame`).  The plain 3D lift (the rdo, deep
and multi-level modes' level 0) stores int32 throughout and never wraps.

Every CUDA lift runs as two passes, spatial and temporal.  The spatial
pass lifts each frame in halo tiles (:func:`tile_windows`: a window of
``_WIN_H`` x ``_WIN_W`` around each stored tile, with :func:`spatial_halo`
rows and ``_HALO_W`` columns of halo), at int16 for the fused kernels and
at int32 for the plain 3D lift; the fused forward kernel quantizes with a
per-channel reciprocal of the step (:func:`reciprocal`).
"""

from __future__ import annotations

import ctypes

import torch

from ... import _build
from ..color import rgb_to_ycocg_r, ycocg_r_to_rgb
from ..quant import from_symbols, quantize, to_symbols
from ..wavelet import forward_3d_inter, inverse_3d_inter, lift_axis, lift_steps

__all__ = ["forward_quant", "inverse_dequant", "forward_quant_plain",
           "inverse_dequant_plain", "forward_quant_rgb", "inverse_dequant_rgb",
           "forward_quant_rgb_plain", "inverse_dequant_rgb_plain", "rgb_frame",
           "forward_3d", "inverse_3d",
           "forward_3d_plain", "inverse_3d_plain", "reciprocal",
           "spatial_halo", "split_frame", "line_windows", "tile_windows",
           "axis_windows", "kernel_tile_windows", "kernel_axis_windows"]

#: frame budget of the TPU's one-block spatial kernel (lift_kernels.py
#: _FRAME_BYTES); larger int16 frames take its split spatial path
_FRAME_BYTES = 9 * 1024 * 1024
# the spatial pass's tiles (csrc/lift.cu kWinH, kWinW, kHaloW, kSeg)
_WIN_H, _WIN_W, _HALO_W, _SEG = 64, 256, 8, 8
_TILE_W = _WIN_W - 2 * _HALO_W


def _per_channel(v, c: int, device) -> torch.Tensor:
    """Scalar or (C,) quantizer parameter → (C,) int32 tensor on ``device``."""
    t = torch.as_tensor(v, dtype=torch.int32, device=device).reshape(-1)
    return t.expand(c).contiguous() if t.numel() == 1 else t.contiguous()


def _check_volume(x: torch.Tensor, dtype, what: str) -> None:
    if x.dtype != dtype or x.ndim != 4:
        raise ValueError(f"{what}: expected a (C, T, H, W) {dtype} tensor, "
                         f"got {tuple(x.shape)} {x.dtype}")
    if any(d % 2 for d in x.shape[1:]):
        raise ValueError(f"{what}: T, H and W must be even, got "
                         f"{tuple(x.shape[1:])}")


def split_frame(h: int, w: int) -> bool:
    """Whether the TPU kernels split the spatial pass of an (h, w) int16
    frame, storing int16 between its W and H passes."""
    return h * w * 2 > _FRAME_BYTES


def _fast_frame(h: int, w: int) -> bool:
    """Whether the spatial pass clamps its windows into an (h, w) frame
    (csrc/lift.cu ``fast_frame``)."""
    return h >= _WIN_H and w >= _WIN_W and w % _SEG == 0


def rgb_frame(t: int, h: int, w: int) -> bool:
    """Whether the fused kernels take a chunk of ``t`` (h, w) RGB frames
    themselves (:func:`forward_quant_rgb`, :func:`inverse_dequant_rgb`):
    frames of the spatial pass's clamped-window form and an even T.  The
    colour then runs in the tile pass's load and store."""
    return t % 2 == 0 and _fast_frame(h, w)


def _int16(x: torch.Tensor) -> torch.Tensor:
    """The int16 truncating store of an int32 tensor, read back as int32."""
    return x.to(torch.int16).to(torch.int32)


def spatial_halo(wavelet) -> int:
    """Rows of halo the spatial pass loads above and below a tile: one
    per lifting step, the farthest a step's result can travel."""
    return len(lift_steps(wavelet))


def line_windows(n: int, win: int, halo: int, clamp: bool):
    """The windows of a line of ``n`` positions lifted in windows of
    ``win`` (csrc/lift.cu ``line_window``): ``(r0, r1, w0)`` per window —
    it stores ``[r0, r1)``, ``win - 2 halo`` positions, and lifts
    ``[w0, w0 + win)`` around them (clamped into the line when ``clamp``;
    the caller clips it to ``[0, n)``)."""
    tile = win - 2 * halo
    out = []
    for r0 in range(0, n, tile):
        w0 = min(max(r0 - halo, 0), n - win) if clamp else r0 - halo
        out.append((r0, min(r0 + tile, n), w0))
    return out


def tile_windows(h: int, w: int, halo: int):
    """The tiles of the CUDA kernels' spatial pass on an (h, w) frame:
    ``((r0, r1), (c0, c1), (wr0, wr1), (wc0, wc1))`` per tile — the rows
    and columns it stores, and the window it lifts them in (clipped to the
    frame; the window's cut edges lie ``halo`` rows and ``_HALO_W``
    columns or more from the stored tile).  On frames of at least
    ``_WIN_H`` x ``_WIN_W`` with W a multiple of ``_SEG`` the windows are
    clamped into the frame (csrc/lift.cu spatial_tiles, FAST).  The
    kernel's own tiles (:func:`kernel_tile_windows`) are held equal to
    these on the card."""
    fast = _fast_frame(h, w)
    return [((r0, r1), (c0, c1), (max(wr0, 0), min(wr0 + _WIN_H, h)),
             (max(wc0, 0), min(wc0 + _WIN_W, w)))
            for r0, r1, wr0 in line_windows(h, _WIN_H, halo, fast)
            for c0, c1, wc0 in line_windows(w, _WIN_W, _HALO_W, fast)]


def axis_windows(n: int, win: int, halo: int):
    """The windows of the shared-memory temporal passes along T = ``n``
    frames lifted in windows of ``win`` (csrc/lift.cu ``axis_span``; the
    library picks ``win``, ``n`` itself where the column fits shared
    memory): ``((r0, r1), (lo, hi))`` per window — one window ``[0, n)``
    when ``n <= win``, else :func:`line_windows` clamped into the axis.
    A model for the CPU tests, held equal to :func:`kernel_axis_windows`
    on the card."""
    if n <= win:
        return [((0, n), (0, n))]
    return [((r0, r1), (w0, w0 + win))
            for r0, r1, w0 in line_windows(n, win, halo, True)]


def reciprocal(step: int) -> tuple[int, int]:
    """``(m, l)`` with ``floor(n / step) == (m * n) >> (31 + l)`` for every
    0 <= n < 2^31 (Granlund–Montgomery: ``l = ceil(log2 step)``,
    ``m = ceil(2^(31+l) / step) < 2^32``); the fused forward kernel
    divides by ``step`` as ``__umulhi(m, 2n) >> l``."""
    step = int(step)
    if step < 1:
        raise ValueError(f"quantizer step must be >= 1, got {step}")
    l = (step - 1).bit_length()
    return -(-(1 << (31 + l)) // step), l


# ── plain versions ──────────────────────────────────────────────


def forward_quant_plain(volume, wavelet, step, dead_zone) -> torch.Tensor:
    """(C, T, H, W) int16 → uint8 symbols: W then H lift (int32, stored
    int16; and between them on a split frame), T lift, dead-zone
    quantize, zigzag."""
    _check_volume(volume, torch.int16, "forward_quant")
    c = volume.shape[0]
    steps = lift_steps(wavelet)
    x = lift_axis(volume.to(torch.int32), steps, -1)
    if split_frame(*volume.shape[2:]):
        x = _int16(x)
    x = lift_axis(_int16(lift_axis(x, steps, -2)), steps, -3)
    s = _per_channel(step, c, volume.device).view(c, 1, 1, 1)
    dz = _per_channel(dead_zone, c, volume.device).view(c, 1, 1, 1)
    return to_symbols(quantize(x, s, dz))


def inverse_dequant_plain(symbols, wavelet, step, *, exact=False) -> torch.Tensor:
    """(C, T, H, W) uint8 symbols → int16 volume: un-zigzag, dequantize,
    inverse T lift (stored int16), then inverse H and W lifts (stored
    int16 between them on a split frame)."""
    _check_volume(symbols, torch.uint8, "inverse_dequant")
    c = symbols.shape[0]
    steps = lift_steps(wavelet, inverse=True, exact=exact)
    s = _per_channel(step, c, symbols.device).view(c, 1, 1, 1)
    x = lift_axis(from_symbols(symbols) * s, steps, -3)
    x = lift_axis(_int16(x), steps, -2)
    if split_frame(*symbols.shape[2:]):
        x = _int16(x)
    return lift_axis(x, steps, -1).to(torch.int16)


def _check_rgb(rgb: torch.Tensor, what: str) -> None:
    if rgb.dtype != torch.uint8 or rgb.ndim != 4 or rgb.shape[-1] != 3:
        raise ValueError(f"{what}: expected (T, H, W, 3) uint8 frames, got "
                         f"{tuple(rgb.shape)} {rgb.dtype}")


def _active(active) -> tuple:
    act = tuple(sorted(set(active)))
    if any(c not in (0, 1, 2) for c in act):
        raise ValueError(f"active channels must lie in (0, 1, 2), got {active}")
    return act


def forward_quant_rgb_plain(rgb, wavelet, step, dead_zone, *,
                            active=(0, 1, 2)):
    """(T, H, W, 3) uint8 RGB → ``(symbols, flags)``: YCoCg-R (int16),
    then :func:`forward_quant_plain` over the ``active`` channels
    (symbols (len(active), T, H, W) uint8; ``step`` / ``dead_zone``
    scalars or one value an active channel); flags (3,) bool, which of
    the three colour planes hold a nonzero value."""
    _check_rgb(rgb, "forward_quant_rgb")
    act = _active(active)
    if not act:
        raise ValueError("forward_quant_rgb: no active channel")
    chans = torch.stack(rgb_to_ycocg_r(rgb))
    flags = (chans.reshape(3, -1) != 0).any(1)
    if act != (0, 1, 2):
        chans = chans[list(act)]
    return forward_quant_plain(chans, wavelet, step, dead_zone), flags


def inverse_dequant_rgb_plain(symbols, wavelet, step, *, exact=False,
                              active=(0, 1, 2), out=None) -> torch.Tensor:
    """(3, T, H, W) uint8 symbols → (T, H, W, 3) uint8 RGB:
    :func:`inverse_dequant_plain` of the ``active`` channels (the others
    taken as zeros, their symbols unread), then inverse YCoCg-R.
    ``step``: scalar or (3,); ``out``: a tensor to copy the frames into
    (returned)."""
    _check_volume(symbols, torch.uint8, "inverse_dequant_rgb")
    act = _active(active)
    _, t, h, w = symbols.shape
    chans = [torch.zeros((t, h, w), dtype=torch.int16, device=symbols.device)] * 3
    if act:
        s = _per_channel(step, 3, symbols.device)[list(act)]
        vol = inverse_dequant_plain(symbols[list(act)], wavelet, s, exact=exact)
        for i, c in enumerate(act):
            chans[c] = vol[i]
    rgb = ycocg_r_to_rgb(*chans)
    return rgb if out is None else out.copy_(rgb)


def forward_3d_plain(volume, wavelet) -> torch.Tensor:
    """(C, T, H, W) int32 → int32 coefficients: W, then H, then T lift."""
    _check_volume(volume, torch.int32, "forward_3d")
    return forward_3d_inter(volume, wavelet)


def inverse_3d_plain(coeffs, wavelet, *, exact=False) -> torch.Tensor:
    """(C, T, H, W) int32 coefficients → int32 volume: T, then H, then W
    inverse lift (compat ±1 replay, or exact undo)."""
    _check_volume(coeffs, torch.int32, "inverse_3d")
    return inverse_3d_inter(coeffs, wavelet, exact=exact)


# ── CUDA launches ───────────────────────────────────────────────


def _lib() -> ctypes.CDLL:
    lib = _build.library("lift")
    if not getattr(lib, "_alc_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.alc_forward_quant.argtypes = [p, p, p, p, i, i, i, i, i,
                                          p, p, i, i, p]
        lib.alc_forward_quant.restype = i
        lib.alc_inverse_dequant.argtypes = [p, p, p, p, i, i, i, i, i,
                                            p, p, i, i, i, p]
        lib.alc_inverse_dequant.restype = i
        lib.alc_forward_quant_rgb.argtypes = [p, p, p, p, p, i, i, i, i, i, i,
                                              p, p, i, i, p]
        lib.alc_forward_quant_rgb.restype = i
        lib.alc_inverse_dequant_rgb.argtypes = [p, p, p, p, i, i, i, i, i,
                                                p, p, i, i, i, p]
        lib.alc_inverse_dequant_rgb.restype = i
        lib.alc_reciprocal_mismatches.argtypes = [p, i, p, p]
        lib.alc_reciprocal_mismatches.restype = i
        lib.alc_tile_windows.argtypes = [i, i, i, p, i]
        lib.alc_tile_windows.restype = i
        lib.alc_forward_3d.argtypes = [p, p, p, i, i, i, i, i, p, p, p]
        lib.alc_forward_3d.restype = i
        lib.alc_inverse_3d.argtypes = [p, p, p, i, i, i, i, i, p, p, i, p]
        lib.alc_inverse_3d.restype = i
        lib.alc_lift3d_scratch.argtypes = [i, i]
        lib.alc_lift3d_scratch.restype = i
        lib.alc_axis_windows.argtypes = [i, i, i, p, i]
        lib.alc_axis_windows.restype = i
        lib._alc_typed = True
    return lib


def _step_arrays(steps):
    n = len(steps)
    coeff = (ctypes.c_int * 4)(*[s[0] for s in steps])
    predict = (ctypes.c_int * 4)(*[int(s[1]) for s in steps])
    return n, coeff, predict


def _check_cuda_shape(x: torch.Tensor) -> None:
    """Raise for a shape the kernels cannot take: more than 65535 frames
    in all (C·T, a grid dimension of every kernel) or a frame of 2^31
    pixels or more.  Frames are lifted in tiles and long chunks in windows
    of frames, so no axis has a length limit of its own; a grid the card
    cannot launch for a rarer reason (more than 65535 tiles down a frame:
    H above 3,669,960 rows in CDF 9/7, 3,932,100 in the others; or more
    than 65535 windows of frames) is reported by the library's launch."""
    c, t, h, w = x.shape
    if c * t > 65535 or h * w > 2**31 - 1:
        raise ValueError(f"shape {tuple(x.shape)} exceeds the grid limit "
                         f"(C·T = {c * t}, H·W = {h * w})")


def _k7_scratch(shape, *, forward: bool) -> bool:
    """Whether K7 needs an int32 scratch volume for ``shape``, as the
    library decides it: the inverse always (its tile pass cannot run in
    place), the forward where T is lifted in windows of frames.  Needs the
    built library, not a card."""
    return bool(_lib().alc_lift3d_scratch(shape[1], int(forward)))


def _quant_params(step, dead_zone, c: int, device) -> torch.Tensor:
    """(C, 4) int32 on ``device``: each channel's step, dead zone and the
    step's reciprocal ``(m, l)`` (csrc/lift.cu QuantParams)."""
    def host(v):
        vals = torch.as_tensor(v).reshape(-1).tolist()
        return vals * c if len(vals) == 1 else vals

    rows = []
    for s, dz in zip(host(step), host(dead_zone), strict=True):
        if dz < 0:
            raise ValueError(f"forward_quant: dead zone must be >= 0, got {dz}")
        m, l = reciprocal(s)
        rows.append((s, dz, m - (1 << 32) if m >= 1 << 31 else m, l))
    return torch.tensor(rows, dtype=torch.int32).to(device)


def reciprocal_mismatches(steps, device) -> int:
    """On the card: how many (step, n) pairs, n over every non-negative
    int32, the fused forward kernel's reciprocal divides wrongly."""
    qp = _quant_params(list(steps), 0, len(steps), device)
    bad = torch.zeros(1, dtype=torch.int64, device=device)
    _build.check(_lib().alc_reciprocal_mismatches(
        qp.data_ptr(), len(steps), bad.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream), "reciprocal_mismatches")
    return int(bad.item())


def kernel_tile_windows(h: int, w: int, halo: int):
    """The tiles the CUDA kernels' spatial pass lifts on an (h, w) frame,
    as the CUDA library computes them for its launches, in the form of
    :func:`tile_windows` (which the CPU tests hold; this ties it to the
    kernel).  Needs the built library, not a card."""
    cap = -(-w // _TILE_W) * -(-h // (_WIN_H - 2 * halo))
    buf = (ctypes.c_int * (8 * cap))()
    n = _lib().alc_tile_windows(h, w, halo, ctypes.addressof(buf), cap)
    if n != cap:
        raise ValueError(f"alc_tile_windows({h}, {w}, {halo}) gave {n} tiles, "
                         f"expected {cap}")
    return [tuple(tuple(buf[8 * k + j:8 * k + j + 2]) for j in range(0, 8, 2))
            for k in range(n)]


def kernel_axis_windows(n: int, win: int, halo: int):
    """The windows the library's shared-memory temporal passes lift T =
    ``n`` frames in, in the form of :func:`axis_windows`.  Needs the built
    library, not a card."""
    cap = len(axis_windows(n, win, halo))
    buf = (ctypes.c_int * (4 * cap))()
    k = _lib().alc_axis_windows(n, win, halo, ctypes.addressof(buf), cap)
    if k != cap:
        raise ValueError(f"alc_axis_windows({n}, {win}, {halo}) gave {k} "
                         f"windows, expected {cap}")
    return [(tuple(buf[4 * i:4 * i + 2]), tuple(buf[4 * i + 2:4 * i + 4]))
            for i in range(k)]


def _forward_quant_cuda(volume, wavelet, step, dead_zone):
    _check_volume(volume, torch.int16, "forward_quant")
    _check_cuda_shape(volume)
    vol = volume.contiguous()
    c, t, h, w = vol.shape
    qp = _quant_params(step, dead_zone, c, vol.device)
    tmp16 = torch.empty_like(vol)
    out = torch.empty(vol.shape, dtype=torch.uint8, device=vol.device)
    n, coeff, predict = _step_arrays(lift_steps(wavelet))
    _build.check(_lib().alc_forward_quant(
        vol.data_ptr(), tmp16.data_ptr(), out.data_ptr(), qp.data_ptr(),
        c, t, h, w, n, ctypes.addressof(coeff), ctypes.addressof(predict),
        spatial_halo(wavelet), int(split_frame(h, w)),
        torch.cuda.current_stream(vol.device).cuda_stream),
        "forward_quant")
    forward_quant.launches += 1
    return out


def _inverse_dequant_cuda(symbols, wavelet, step, exact):
    _check_volume(symbols, torch.uint8, "inverse_dequant")
    _check_cuda_shape(symbols)
    sym = symbols.contiguous()
    c, t, h, w = sym.shape
    s = _per_channel(step, c, sym.device)
    tmp16 = torch.empty(sym.shape, dtype=torch.int16, device=sym.device)
    out = torch.empty_like(tmp16)
    n, coeff, predict = _step_arrays(
        lift_steps(wavelet, inverse=True, exact=exact))
    _build.check(_lib().alc_inverse_dequant(
        sym.data_ptr(), tmp16.data_ptr(), out.data_ptr(), s.data_ptr(),
        c, t, h, w, n, ctypes.addressof(coeff), ctypes.addressof(predict),
        int(exact), spatial_halo(wavelet), int(split_frame(h, w)),
        torch.cuda.current_stream(sym.device).cuda_stream),
        "inverse_dequant")
    inverse_dequant.launches += 1
    return out


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous and 16-byte aligned (copied where it is not)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _check_rgb_cuda(t: int, h: int, w: int, what: str) -> None:
    if not rgb_frame(t, h, w):
        raise ValueError(f"{what}: frames {t}x{h}x{w} are not of the fused "
                         "kernels' form (see rgb_frame)")
    if t > 65535 or h * w > 2**31 - 1:
        raise ValueError(f"{what}: shape {t}x{h}x{w} exceeds the grid limit")


def _forward_quant_rgb_cuda(rgb, wavelet, step, dead_zone, active):
    _check_rgb(rgb, "forward_quant_rgb")
    act = _active(active)
    if not act:
        raise ValueError("forward_quant_rgb: no active channel")
    src = _aligned(rgb)
    t, h, w, _ = src.shape
    _check_rgb_cuda(t, h, w, "forward_quant_rgb")
    n = len(act)
    qp = _quant_params(step, dead_zone, n, src.device)
    tmp16 = torch.empty((n, t, h, w), dtype=torch.int16, device=src.device)
    out = torch.empty((n, t, h, w), dtype=torch.uint8, device=src.device)
    flags = torch.zeros(4, dtype=torch.uint8, device=src.device)
    nsteps, coeff, predict = _step_arrays(lift_steps(wavelet))
    _build.check(_lib().alc_forward_quant_rgb(
        src.data_ptr(), tmp16.data_ptr(), out.data_ptr(), qp.data_ptr(),
        flags.data_ptr(), n, sum(c << (2 * k) for k, c in enumerate(act)),
        t, h, w, nsteps, ctypes.addressof(coeff), ctypes.addressof(predict),
        spatial_halo(wavelet), int(split_frame(h, w)),
        torch.cuda.current_stream(src.device).cuda_stream),
        "forward_quant_rgb")
    forward_quant.launches += 1
    forward_quant.rgb_launches += 1
    return out, flags[:3].view(torch.bool)


def _inverse_dequant_rgb_cuda(symbols, wavelet, step, exact, active, out):
    _check_volume(symbols, torch.uint8, "inverse_dequant_rgb")
    act = _active(active)
    c, t, h, w = symbols.shape
    if c != 3:
        raise ValueError(f"inverse_dequant_rgb: expected 3 channels, got {c}")
    _check_rgb_cuda(t, h, w, "inverse_dequant_rgb")
    sym = symbols.contiguous()
    dev = sym.device
    s = _per_channel(step, 3, dev)
    tmp16 = torch.empty((len(act), t, h, w), dtype=torch.int16, device=dev)
    shape = (t, h, w, 3)
    if out is not None and (out.shape != shape or out.dtype != torch.uint8
                            or out.device != dev):
        raise ValueError(f"inverse_dequant_rgb: out must be a {shape} uint8 "
                         f"tensor on {dev}, got {tuple(out.shape)} {out.dtype} "
                         f"on {out.device}")
    direct = (out is not None and out.is_contiguous()
              and out.data_ptr() % 16 == 0)
    dst = out if direct else torch.empty(shape, dtype=torch.uint8, device=dev)
    n, coeff, predict = _step_arrays(
        lift_steps(wavelet, inverse=True, exact=exact))
    _build.check(_lib().alc_inverse_dequant_rgb(
        sym.data_ptr(), tmp16.data_ptr(), dst.data_ptr(), s.data_ptr(),
        sum(1 << ch for ch in act), t, h, w, n,
        ctypes.addressof(coeff), ctypes.addressof(predict), int(exact),
        spatial_halo(wavelet), int(split_frame(h, w)),
        torch.cuda.current_stream(dev).cuda_stream),
        "inverse_dequant_rgb")
    inverse_dequant.launches += 1
    inverse_dequant.rgb_launches += 1
    if out is not None and not direct:
        out.copy_(dst)
        return out
    return dst


def _forward_3d_cuda(volume, wavelet):
    _check_volume(volume, torch.int32, "forward_3d")
    _check_cuda_shape(volume)
    vol = volume.contiguous()
    c, t, h, w = vol.shape
    out = torch.empty_like(vol)
    tmp = torch.empty_like(vol) if _k7_scratch(vol.shape, forward=True) else None
    n, coeff, predict = _step_arrays(lift_steps(wavelet))
    _build.check(_lib().alc_forward_3d(
        vol.data_ptr(), out.data_ptr(), tmp.data_ptr() if tmp is not None else None,
        c, t, h, w, n,
        ctypes.addressof(coeff), ctypes.addressof(predict),
        torch.cuda.current_stream(vol.device).cuda_stream),
        "forward_3d")
    forward_3d.launches += 1
    return out


def _inverse_3d_cuda(coeffs, wavelet, exact):
    _check_volume(coeffs, torch.int32, "inverse_3d")
    _check_cuda_shape(coeffs)
    vol = coeffs.contiguous()
    c, t, h, w = vol.shape
    out = torch.empty_like(vol)
    tmp = torch.empty_like(vol) if _k7_scratch(vol.shape, forward=False) else None
    n, coeff, predict = _step_arrays(
        lift_steps(wavelet, inverse=True, exact=exact))
    _build.check(_lib().alc_inverse_3d(
        vol.data_ptr(), out.data_ptr(), tmp.data_ptr() if tmp is not None else None,
        c, t, h, w, n,
        ctypes.addressof(coeff), ctypes.addressof(predict), int(exact),
        torch.cuda.current_stream(vol.device).cuda_stream),
        "inverse_3d")
    inverse_3d.launches += 1
    return out


# ── wrappers ────────────────────────────────────────────────────


def forward_quant(volume: torch.Tensor, wavelet, step, dead_zone) -> torch.Tensor:
    """Level-0 interleaved 3D forward lift fused with dead-zone quantize
    + zigzag: (C, T, H, W) int16 (T, H, W even) → uint8 symbols.
    ``step`` / ``dead_zone``: scalars or (C,) per-channel values."""
    if volume.device.type == "cpu":
        return forward_quant_plain(volume, wavelet, step, dead_zone)
    if volume.is_cuda:
        return _forward_quant_cuda(volume, wavelet, step, dead_zone)
    raise ValueError(f"forward_quant: unsupported device {volume.device}")


def inverse_dequant(symbols: torch.Tensor, wavelet, step, *,
                    exact: bool = False) -> torch.Tensor:
    """Un-zigzag + dequantize fused with the level-0 interleaved 3D
    inverse (compat ±1 replay, or exact undo with ``exact=True``):
    (C, T, H, W) uint8 → int16 volume.  ``step``: scalar or (C,)."""
    if symbols.device.type == "cpu":
        return inverse_dequant_plain(symbols, wavelet, step, exact=exact)
    if symbols.is_cuda:
        return _inverse_dequant_cuda(symbols, wavelet, step, exact)
    raise ValueError(f"inverse_dequant: unsupported device {symbols.device}")


def forward_quant_rgb(rgb: torch.Tensor, wavelet, step, dead_zone, *,
                      active=(0, 1, 2)):
    """The colour folded into :func:`forward_quant`: (T, H, W, 3) uint8
    RGB → ``(symbols (len(active), T, H, W) uint8, flags (3,) bool)``,
    YCoCg-R then K1 over the ``active`` channels, and which of the three
    colour planes hold a nonzero value (whatever ``active``).  On a CUDA
    tensor the kernel loads the RGB frames itself (frames of
    :func:`rgb_frame`'s form; one ``forward_quant`` launch, counted in
    ``forward_quant.launches`` and ``forward_quant.rgb_launches``)."""
    if rgb.device.type == "cpu":
        return forward_quant_rgb_plain(rgb, wavelet, step, dead_zone,
                                       active=active)
    if rgb.is_cuda:
        return _forward_quant_rgb_cuda(rgb, wavelet, step, dead_zone, active)
    raise ValueError(f"forward_quant_rgb: unsupported device {rgb.device}")


def inverse_dequant_rgb(symbols: torch.Tensor, wavelet, step, *,
                        exact: bool = False, active=(0, 1, 2),
                        out: torch.Tensor | None = None) -> torch.Tensor:
    """The inverse colour folded into :func:`inverse_dequant`: (3, T, H,
    W) uint8 symbols → (T, H, W, 3) uint8 RGB, K4 over the ``active``
    channels (the others taken as zeros), then inverse YCoCg-R with its
    int16 intermediates and the clamp.  ``out``: a (T, H, W, 3) uint8
    tensor to write into (returned).  On a CUDA tensor the kernel's tile
    pass writes the RGB frames itself (frames of :func:`rgb_frame`'s
    form; one ``inverse_dequant`` launch, counted in
    ``inverse_dequant.launches`` and ``inverse_dequant.rgb_launches``)."""
    if symbols.device.type == "cpu":
        return inverse_dequant_rgb_plain(symbols, wavelet, step, exact=exact,
                                         active=active, out=out)
    if symbols.is_cuda:
        return _inverse_dequant_rgb_cuda(symbols, wavelet, step, exact,
                                         active, out)
    raise ValueError(f"inverse_dequant_rgb: unsupported device {symbols.device}")


def forward_3d(volume: torch.Tensor, wavelet) -> torch.Tensor:
    """Plain level-0 interleaved 3D forward lift (W, then H, then T):
    (C, T, H, W) int32 (T, H, W even) → int32 coefficients."""
    if volume.device.type == "cpu":
        return forward_3d_plain(volume, wavelet)
    if volume.is_cuda:
        return _forward_3d_cuda(volume, wavelet)
    raise ValueError(f"forward_3d: unsupported device {volume.device}")


def inverse_3d(coeffs: torch.Tensor, wavelet, *, exact: bool = False
               ) -> torch.Tensor:
    """Plain level-0 interleaved 3D inverse lift (T, then H, then W;
    compat ±1 replay, or exact undo with ``exact=True``): (C, T, H, W)
    int32 → int32."""
    if coeffs.device.type == "cpu":
        return inverse_3d_plain(coeffs, wavelet, exact=exact)
    if coeffs.is_cuda:
        return _inverse_3d_cuda(coeffs, wavelet, exact)
    raise ValueError(f"inverse_3d: unsupported device {coeffs.device}")


forward_quant.launches = 0
inverse_dequant.launches = 0
# the launches above that took RGB frames (forward_quant_rgb /
# inverse_dequant_rgb); not a key of ops.kernels.launch_counts()
forward_quant.rgb_launches = 0
inverse_dequant.rgb_launches = 0
forward_3d.launches = 0
inverse_3d.launches = 0
