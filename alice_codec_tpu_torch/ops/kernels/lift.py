"""Fused level-0 3D lifting + (de)quantization: the port of
``alice_codec_tpu/ops/pallas/lift_kernels.py`` (forward_quant_pallas,
inverse_dequant_pallas).

Each function has two forms in this module:

* the plain PyTorch version (``*_plain``): the same integer arithmetic as
  the TPU kernels, as whole-tensor ops — what the CPU runs, and what the
  CUDA kernel is held against on the card;
* the wrapper (``forward_quant`` / ``inverse_dequant``): takes the plain
  version for a CPU tensor and launches the hand-written Hopper kernel
  (``csrc/lift.cu``) for a CUDA tensor — never the plain version on the
  card.  Each launch adds one to the wrapper's ``launches`` count.

Storage points follow the TPU kernels: int32 inside a pass, int16 between
the spatial and temporal passes (``o_ref.astype`` at lift_kernels.py:135
and :193), so an out-of-range inverse intermediate wraps there.
"""

from __future__ import annotations

import ctypes

import torch

from ... import _build
from ..quant import from_symbols, quantize, to_symbols
from ..wavelet import lift_axis, lift_steps

__all__ = ["forward_quant", "inverse_dequant", "forward_quant_plain",
           "inverse_dequant_plain"]

#: shared memory a block may use on Hopper (bytes)
_SMEM_LIMIT = 232448
_STRIP = 16           # columns per column-lift block (csrc/lift.cu kStrip)
_T_THREADS = 128      # threads per temporal block (kTemporalThreads)


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


# ── plain versions ──────────────────────────────────────────────


def forward_quant_plain(volume, wavelet, step, dead_zone) -> torch.Tensor:
    """(C, T, H, W) int16 → uint8 symbols: W then H lift (int32, stored
    int16), T lift, dead-zone quantize, zigzag."""
    _check_volume(volume, torch.int16, "forward_quant")
    c = volume.shape[0]
    steps = lift_steps(wavelet)
    x = volume.to(torch.int32)
    x = lift_axis(lift_axis(x, steps, -1), steps, -2)
    x = lift_axis(x.to(torch.int16).to(torch.int32), steps, -3)
    s = _per_channel(step, c, volume.device).view(c, 1, 1, 1)
    dz = _per_channel(dead_zone, c, volume.device).view(c, 1, 1, 1)
    return to_symbols(quantize(x, s, dz))


def inverse_dequant_plain(symbols, wavelet, step, *, exact=False) -> torch.Tensor:
    """(C, T, H, W) uint8 symbols → int16 volume: un-zigzag, dequantize,
    inverse T lift (stored int16), then inverse H and W lifts."""
    _check_volume(symbols, torch.uint8, "inverse_dequant")
    c = symbols.shape[0]
    steps = lift_steps(wavelet, inverse=True, exact=exact)
    s = _per_channel(step, c, symbols.device).view(c, 1, 1, 1)
    x = lift_axis(from_symbols(symbols) * s, steps, -3)
    x = x.to(torch.int16).to(torch.int32)
    x = lift_axis(lift_axis(x, steps, -2), steps, -1)
    return x.to(torch.int16)


# ── CUDA launches ───────────────────────────────────────────────


def _lib() -> ctypes.CDLL:
    lib = _build.library("lift")
    if not getattr(lib, "_alc_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.alc_forward_quant.argtypes = [p, p, p, p, p, p, i, i, i, i, i,
                                          p, p, p]
        lib.alc_forward_quant.restype = i
        lib.alc_inverse_dequant.argtypes = [p, p, p, p, p, i, i, i, i, i,
                                            p, p, i, p]
        lib.alc_inverse_dequant.restype = i
        lib._alc_typed = True
    return lib


def _step_arrays(steps):
    n = len(steps)
    coeff = (ctypes.c_int * 4)(*[s[0] for s in steps])
    predict = (ctypes.c_int * 4)(*[int(s[1]) for s in steps])
    return n, coeff, predict


def _check_cuda_shape(x: torch.Tensor) -> None:
    c, t, h, w = x.shape
    need = {"row": w * 4, "column": h * _STRIP * 4, "temporal": t * _T_THREADS * 4}
    for what, b in need.items():
        if b > _SMEM_LIMIT:
            raise ValueError(f"{what} pass needs {b} B of shared memory for "
                             f"shape {tuple(x.shape)} (limit {_SMEM_LIMIT})")
    if c * t > 65535 or c > 65535:
        raise ValueError(f"C·T = {c * t} exceeds the grid limit")


def _forward_quant_cuda(volume, wavelet, step, dead_zone):
    _check_volume(volume, torch.int16, "forward_quant")
    _check_cuda_shape(volume)
    vol = volume.contiguous()
    c, t, h, w = vol.shape
    s = _per_channel(step, c, vol.device)
    dz = _per_channel(dead_zone, c, vol.device)
    tmp32 = torch.empty(vol.shape, dtype=torch.int32, device=vol.device)
    tmp16 = torch.empty_like(vol)
    out = torch.empty(vol.shape, dtype=torch.uint8, device=vol.device)
    n, coeff, predict = _step_arrays(lift_steps(wavelet))
    _build.check(_lib().alc_forward_quant(
        vol.data_ptr(), tmp32.data_ptr(), tmp16.data_ptr(), out.data_ptr(),
        s.data_ptr(), dz.data_ptr(), c, t, h, w, n,
        ctypes.addressof(coeff), ctypes.addressof(predict),
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
    tmp32 = torch.empty(sym.shape, dtype=torch.int32, device=sym.device)
    out = torch.empty_like(tmp16)
    n, coeff, predict = _step_arrays(
        lift_steps(wavelet, inverse=True, exact=exact))
    _build.check(_lib().alc_inverse_dequant(
        sym.data_ptr(), tmp16.data_ptr(), tmp32.data_ptr(), out.data_ptr(),
        s.data_ptr(), c, t, h, w, n,
        ctypes.addressof(coeff), ctypes.addressof(predict), int(exact),
        torch.cuda.current_stream(sym.device).cuda_stream),
        "inverse_dequant")
    inverse_dequant.launches += 1
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


forward_quant.launches = 0
inverse_dequant.launches = 0
