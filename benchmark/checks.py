"""The comparison that decides a run's ``correct``.

A sample of the window's roundtrips, drawn from the seed, keeps what the
timed path produced: the coded chunk (its wire: streams, counts, stored
histograms, capacities and header fields) and the decoded frames.  Once
the window has closed, the configuration's plain reference (the module
of ``reference/`` its ``reference`` key names, ``alc3_plain`` for ALC3;
it imports nothing of the program) judges each one against the input
it was made from:

* ``header_mismatch``: header fields (geometry, wavelet, quant step, mode)
  that differ from what the configuration asks for;
* ``symbol_mismatch``: symbols where the reference's own reading of the
  chunk's wire differs from the reference's transform of the input — the
  colour, lift, quantize, the plane policy (dense, sparse, elided) and
  the entropy-coded streams;
* ``rgb_max_err``: the largest difference between the program's decoded
  frames and the reference's inverse of the reference's symbols — the
  inverse path;
* ``input_max_err`` (lossless configurations): the largest difference
  between the decoded frames and the input.

The codec's arithmetic is integer and its wire exact, so each limit is 0.
"""

from __future__ import annotations

import importlib

import torch

from reference import alc3_plain

WAVELETS = {"cdf53": 0, "cdf97": 1, "haar": 2}

#: each compared number's limit (exact comparisons)
LIMITS = {"header_mismatch": 0, "symbol_mismatch": 0, "rgb_max_err": 0,
          "input_max_err": 0}


def reference_of(config: dict):
    """The plain reference module the configuration names."""
    return importlib.import_module(f"reference.{config['reference']}")


def spec_of(config: dict, **change) -> alc3_plain.Spec:
    """The reference's view of a configuration (``change``: e.g. the
    control's lower ``store``)."""
    kw = dict(config["chunk"])
    kw.update(quality=config["codec"]["quality"], wavelet=config["codec"]["wavelet"],
              exact=config["decode"]["exact"])
    kw.update(change)
    return reference_of(config).Spec(**kw)


def names(config: dict) -> list[str]:
    """The numbers compared for a configuration."""
    out = ["header_mismatch", "symbol_mismatch", "rgb_max_err"]
    if config.get("lossless"):
        out.append("input_max_err")
    return out


def header_mismatch(chunk, config: dict, spec: alc3_plain.Spec) -> int:
    w, h, t = spec.dims
    want = (w, h, t, WAVELETS[spec.wavelet], spec.step, spec.deep,
            bool(config["codec"].get("sparse", False)), 1)
    have = (chunk.width, chunk.height, chunk.frames, int(chunk.wavelet_type),
            chunk.quant_step, bool(chunk.deep), bool(chunk.sparse), chunk.levels)
    return sum(a != b for a, b in zip(want, have))


def _max_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        return 256
    return int((a.to(torch.int16) - b.to(torch.int16)).abs().max().item())


def judge_one(rgb, chunk, decoded, config: dict, spec: alc3_plain.Spec) -> dict:
    """The numbers of one sample: ``rgb`` the input, ``chunk`` the coded
    chunk (None where a control supplies ``symbols`` itself), ``decoded``
    the frames."""
    ref = reference_of(config)
    ref_sym = ref.forward_symbols(rgb, spec)
    if isinstance(chunk, torch.Tensor):    # a control's symbols
        wire_sym, head = chunk, 0
    else:
        head = header_mismatch(chunk, config, spec)
        wire_sym = ref.read_wire(
            chunk.streams, chunk.counts, chunk.hists, spec=spec,
            s_seg=chunk.s_seg, sparse=chunk.sparse, kcaps=tuple(chunk.kcaps))
    out = {"header_mismatch": head,
           "symbol_mismatch": (int((wire_sym != ref_sym).sum().item())
                               if wire_sym.shape == ref_sym.shape else ref_sym.numel())}
    del wire_sym
    ref_rgb = ref.inverse_rgb(ref_sym, spec)
    del ref_sym
    out["rgb_max_err"] = _max_err(decoded, ref_rgb)
    del ref_rgb
    if config.get("lossless"):
        out["input_max_err"] = _max_err(decoded, rgb)
    return out


def judge(samples, config: dict, spec: alc3_plain.Spec | None = None):
    """``samples``: (input, chunk, decoded) triples → ``(numbers, failed)``:
    the worst of each number over the samples (``header`` and ``symbol``
    mismatches summed), and how many samples broke a limit."""
    spec = spec or spec_of(config)
    total = {n: 0 for n in names(config)}
    failed = 0
    for rgb, chunk, decoded in samples:
        one = judge_one(rgb, chunk, decoded, config, spec)
        failed += any(one[n] > LIMITS[n] for n in total)
        for n in total:
            total[n] = (total[n] + one[n] if n.endswith("mismatch")
                        else max(total[n], one[n]))
    return total, failed


def passed(numbers: dict) -> bool:
    return all(v <= LIMITS[n] for n, v in numbers.items())
