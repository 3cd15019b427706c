"""The comparison that decides a run's ``correct``.

A sample of the window's roundtrips, drawn from the seed, keeps what the
timed path produced: each judged unit's input, coded form (for ALC3 the
chunk's wire and header fields) and decoded frames, as the
configuration's driver splits a roundtrip into units.  Once the window
has closed, the configuration's plain reference (the module of
``reference/`` its ``reference`` key names; it imports nothing of the
program) judges each unit against the input it was made from: its
``judge_one(rgb, coded, decoded, config)`` returns the unit's numbers.
Every reference reports at least :func:`names`:

* ``header_mismatch``: header fields (geometry, wavelet, quant step, mode)
  that differ from what the configuration asks for;
* ``symbol_mismatch``: symbols where the reference's own reading of the
  wire differs from the reference's transform of the input — the colour,
  lift, quantize, the plane policy and the entropy coding;
* ``rgb_max_err``: the largest difference between the program's decoded
  frames and the reference's inverse of the reference's symbols — the
  inverse path;
* ``input_max_err`` (lossless configurations): the largest difference
  between the decoded frames and the input.

The limits live here, not with the references: a number that
:data:`LIMITS` does not hold fails the run, so a new reference judges by
these numbers and cannot bring one with a limit of its own.  The codec's
arithmetic is integer and its wires exact, so each limit is 0.
"""

from __future__ import annotations

#: each compared number's limit (exact comparisons)
LIMITS = {"header_mismatch": 0, "symbol_mismatch": 0, "rgb_max_err": 0,
          "input_max_err": 0}


def names(config: dict) -> list[str]:
    """The numbers every reference has to report for a configuration."""
    out = ["header_mismatch", "symbol_mismatch", "rgb_max_err"]
    if config.get("lossless"):
        out.append("input_max_err")
    return out


def judge(samples, config: dict, ref):
    """``samples``: (input, coded, decoded) triples, judged by the
    reference module ``ref`` → ``(numbers, failed)``: the worst of each
    number over the samples (mismatches summed), and how many samples
    broke a limit or reported a number without one."""
    total = {n: 0 for n in names(config)}
    failed = 0
    for rgb, coded, decoded in samples:
        one = ref.judge_one(rgb, coded, decoded, config)
        missing = [n for n in total if n not in one]
        if missing:
            raise ValueError(f"reference {config['reference']} reported no {missing}")
        failed += not passed(one)
        for n, v in one.items():
            total[n] = (total.get(n, 0) + v if n.endswith("mismatch")
                        else max(total.get(n, 0), v))
    return total, failed


def passed(numbers: dict) -> bool:
    return all(n in LIMITS and v <= LIMITS[n] for n, v in numbers.items())
