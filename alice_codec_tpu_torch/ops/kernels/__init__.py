"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch version (the counterpart of ``alice_codec_tpu/ops/pallas/``).

:data:`WRAPPERS` names every kernel wrapper; each keeps a ``launches``
count that grows by one per kernel launch on a CUDA tensor and never on
the CPU path.
"""

from __future__ import annotations

from .lift import forward_3d, forward_quant, inverse_3d, inverse_dequant
from .rans3 import decode_words, encode_words
from .rans_nway import decode_nway, encode_nway, encode_pack_nway
from .sparse import compact, expand

__all__ = ["WRAPPERS", "reset_launches", "launch_counts"]

WRAPPERS = {
    "forward_quant": forward_quant,
    "encode_words": encode_words,
    "decode_words": decode_words,
    "inverse_dequant": inverse_dequant,
    "compact": compact,
    "expand": expand,
    "forward_3d": forward_3d,
    "inverse_3d": inverse_3d,
    "encode_nway": encode_nway,
    "encode_pack_nway": encode_pack_nway,
    "decode_nway": decode_nway,
}


def reset_launches() -> None:
    """Set every wrapper's launch count to 0."""
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    """Launch count of every wrapper, by name."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}
