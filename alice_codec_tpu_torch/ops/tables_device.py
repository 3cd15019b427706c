"""Frequency-table normalization for the ALC3 wire (PyTorch port of
``alice_codec_tpu/ops/tables_device.py``).

Matches ``ops.rans_word.freq_table_words`` and the JAX
``freq_table_device`` exactly (wire v7):

* zero-count symbols get frequency 0 (the absent-symbol promise), present
  symbols at least 1;
* oversubscription is drained from the FIRST argmax, one take at a time;
* the first argmax absorbs the remaining rounding deficit;
* an all-zero histogram yields the uniform table (8 per symbol).

``floor(h·PROB_SCALE/total)`` is computed directly in int64, which is
exact for every total below 2^52 (the JAX package runs a uint32 long
division, exact below 2^31 — the two agree wherever the JAX one is
defined).  Works on a batch ``(..., 256)`` of histograms on any device;
the drain loop reads one flag per iteration back to the host and
usually ends after one or two.
"""

from __future__ import annotations

import torch

from .rans_word import PROB_SCALE

__all__ = ["freq_table_device"]


def _first_argmax(x: torch.Tensor) -> torch.Tensor:
    """Index of the first maximum along the last axis (np.argmax ties)."""
    idx = torch.arange(x.shape[-1], device=x.device)
    hit = x == x.max(dim=-1, keepdim=True).values
    return torch.where(hit, idx, x.shape[-1]).min(dim=-1).values


def freq_table_device(hist: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., 256) histograms → (freqs, cums), each (..., 256) int32."""
    lead = hist.shape[:-1]
    h = hist.reshape(-1, 256).to(torch.int64)
    rows = torch.arange(h.shape[0], device=h.device)
    total = h.sum(dim=-1, keepdim=True)
    freqs = torch.where(
        h > 0, ((h * PROB_SCALE) // total.clamp(min=1)).clamp(min=1), 0)
    excess = freqs.sum(dim=-1) - PROB_SCALE
    while True:
        imax = _first_argmax(freqs)
        take = torch.minimum(excess, freqs[rows, imax] - 1)
        live = (excess > 0) & (take > 0)
        if not bool(live.any()):
            break
        take = torch.where(live, take, 0)
        freqs[rows, imax] -= take
        excess -= take
    freqs[rows, _first_argmax(freqs)] += PROB_SCALE - freqs.sum(dim=-1)
    cums = torch.cumsum(freqs, dim=-1) - freqs
    uniform = total == 0
    step = PROB_SCALE // 256
    freqs = torch.where(uniform, step, freqs)
    cums = torch.where(
        uniform, torch.arange(256, device=h.device) * step, cums)
    return (freqs.to(torch.int32).reshape(*lead, 256),
            cums.to(torch.int32).reshape(*lead, 256))
