"""Plane statistics: the 256-bin histograms the entropy tables are built
from, and each plane's symbol maximum (ALC3's coverage floor), in one
pass over uint8 planes.

The kernel (``csrc/hist.cu``) replaces no TPU kernel: the JAX package
builds its histograms in jnp (``alice_codec_tpu/ops/quant.py``
``build_histogram``) and its maxima with ``jnp.max``.  The plain version
is that arithmetic in torch, ``torch.bincount`` of the sampled rows and
``amax``, and is the spec.

What a histogram counts is :func:`sampled`'s rule (a wire rule: the
sampled histograms ride the ALC3 wire, so encoder and decoder build the
same tables from them).

:func:`plane_stats` takes its plain version for a CPU tensor and, for a
CUDA tensor, launches the kernel once for up to ``_MAX_PLANES`` planes of
any lengths and alignments, counting launches in ``launches``.  Its key
is not in :data:`~.WRAPPERS`: ``launch_counts()`` names the kernels whose
bytes the benchmark's roofline counts.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from ... import _build
from .rans3 import NG

__all__ = ["sampled", "plane_stats", "plane_stats_plain"]

_MAX_PLANES = 64   # csrc/hist.cu MAX_PLANES: the planes of a launch
_BLOCKS_PER_SM = 3  # csrc/hist.cu: 64 KB of counters a 256-thread block


def sampled(planes: torch.Tensor, stride: int) -> torch.Tensor:
    """The symbols a histogram counts, along the last axis: with
    ``stride`` > 1 the first 128-symbol row of every ``stride`` rows,
    nothing after the last whole block of ``stride`` rows, and the whole
    plane where it is shorter than one block; with ``stride`` ≤ 1 every
    symbol."""
    if stride <= 1:
        return planes
    n = planes.shape[-1]
    blk = stride * NG
    nb = n // blk
    if nb == 0:
        return planes
    lead = planes.shape[:-1]
    rows = planes[..., : nb * blk].reshape(*lead, nb, stride, NG)[..., 0, :]
    return rows.reshape(*lead, nb * NG)


def _views(planes) -> list[torch.Tensor]:
    """(n, N) planes, or a sequence of 1-D planes → a list of 1-D uint8
    tensors."""
    views = list(planes)
    for v in views:
        if v.dtype != torch.uint8 or v.ndim != 1:
            raise ValueError(f"a plane must be 1-D uint8, got "
                             f"{tuple(v.shape)} {v.dtype}")
    return views


def plane_stats_plain(planes, stride: int = 1):
    """Plain PyTorch plane statistics: ``planes`` (n, N) uint8, or a
    sequence of n 1-D uint8 planes of any lengths → ``(histograms,
    maxima)``: the (n, 256) int64 histograms of their :func:`sampled`
    symbols and the (n,) int64 maxima over every symbol of each plane (0
    for an empty plane)."""
    views = _views(planes)
    dev = views[0].device if views else torch.device("cpu")
    hists = torch.zeros((len(views), 256), dtype=torch.int64, device=dev)
    maxima = torch.zeros(len(views), dtype=torch.int64, device=dev)
    for i, v in enumerate(views):
        hists[i] = torch.bincount(sampled(v, stride).to(torch.int64),
                                  minlength=256)
        if v.numel():
            maxima[i] = v.amax()
    return hists, maxima


def _lib() -> ctypes.CDLL:
    lib = _build.library("hist")
    if not getattr(lib, "_alc_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.alc_plane_stats.argtypes = [i, p, p, i, i, p, p, p]
        lib.alc_plane_stats.restype = i
        lib._alc_typed = True
    return lib


@lru_cache(maxsize=16)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def plane_stats(planes, stride: int = 1):
    """Plane statistics, as :func:`plane_stats_plain` says: one kernel
    launch a call on the card (a launch a ``_MAX_PLANES`` planes), reading
    each plane where it lies, and the plain version on the CPU.  Each
    plane must be contiguous."""
    views = _views(planes)
    if not views:
        raise ValueError("plane_stats: no planes")
    dev = views[0].device
    if dev.type == "cpu":
        return plane_stats_plain(views, stride)
    if dev.type != "cuda":
        raise ValueError(f"plane_stats: unsupported device {dev}")
    for v in views:
        if v.device != dev or not v.is_contiguous():
            raise ValueError(f"a plane on {v.device}, not contiguous on {dev}")
    n = len(views)
    out = torch.zeros(n * 257, dtype=torch.int64, device=dev)
    hists, maxima = out[: n * 256].view(n, 256), out[n * 256 :]
    longest = max(v.numel() for v in views)
    stream = torch.cuda.current_stream(dev).cuda_stream
    index = torch.cuda.current_device() if dev.index is None else dev.index
    for g in range(0, n, _MAX_PLANES):
        group = views[g : g + _MAX_PLANES]
        k = len(group)
        blocks = max(1, min(-(-_sms(index) * _BLOCKS_PER_SM // k),
                            -(-longest // (16 * 256))))
        ptr = (ctypes.c_longlong * k)(*[v.data_ptr() for v in group])
        size = (ctypes.c_longlong * k)(*[v.numel() for v in group])
        _build.check(_lib().alc_plane_stats(
            k, ctypes.addressof(ptr), ctypes.addressof(size), int(stride),
            blocks, hists[g].data_ptr(), maxima[g].data_ptr(), stream),
            "plane_stats")
        plane_stats.launches += 1
    return hists, maxima


plane_stats.launches = 0
