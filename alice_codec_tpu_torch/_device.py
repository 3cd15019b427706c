"""Default-device resolution for the port's entry points.

Entry points run on the CUDA card unless the caller names another
device (``device="cpu"``, as the tests do).  With no card and no
explicit device they raise: the port never carries on quietly on the
CPU, where the kernels' plain versions would stand in for the kernels.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda``; anything else → ``torch.device(device)``.

    Raises ``RuntimeError`` when the chosen device is CUDA and no card
    is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU"
        )
    return dev
