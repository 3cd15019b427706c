"""ML bridge: ternary-weight inference helpers (reference: src/ml_bridge.rs;
the port of the JAX package's ``bridges/ml.py``).

The reference delegates to the external alice-ml ``ternary_matvec`` with
1.58-bit ({-1, 0, 1}) weights.  Here the product runs in torch on
``device`` (the CUDA card unless given another, such as ``"cpu"``), in
true float32 like the JAX package's ``Precision.HIGHEST`` dot: each
ternary product is exact (±x or 0), and the rows are summed in float32
with an elementwise multiply and a sum, which no TF32 or lower matmul
precision setting (``torch.set_float32_matmul_precision``) reaches.
Results come back as NumPy arrays, as the JAX package's do.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device

__all__ = ["ternary_matvec", "SubBandClassifier", "MotionPredictor"]


def _f32(x, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(torch.float32)


def ternary_matvec(features, weights, out: np.ndarray | None = None, *,
                   device=None):
    """y = W·x with ternary W (rows × features); mirrors alice-ml's API.
    ``out``, where given, is a NumPy buffer that receives y."""
    dev = resolve_device(device)
    res = (_f32(weights, dev) * _f32(features, dev)).sum(dim=-1).cpu().numpy()
    if out is not None:
        out[: len(res)] = res
        return out
    return res


class SubBandClassifier:
    """Ternary sub-band quantization-strategy classifier
    (reference src/ml_bridge.rs:12-76); its products run on ``device``."""

    def __init__(self, weights, input_dim: int, num_classes: int, *,
                 device=None):
        w = np.asarray(weights, np.int8).reshape(num_classes, input_dim)
        if not np.isin(w, (-1, 0, 1)).all():
            raise ValueError("weights must be ternary {-1, 0, 1}")
        self.device = resolve_device(device)
        self._weights = _f32(w, self.device)
        self.input_dim = input_dim
        self.num_classes = num_classes

    def classify(self, features) -> tuple[int, float]:
        """Returns (class_index, confidence).  Ties resolve to the last max,
        matching the reference's max_by (src/ml_bridge.rs:49-56)."""
        logits = ternary_matvec(features, self._weights, device=self.device)
        best = int(len(logits) - 1 - np.argmax(logits[::-1]))
        return best, float(logits[best])

    def classify_logits(self, features, output: np.ndarray) -> None:
        ternary_matvec(features, self._weights, output, device=self.device)


class MotionPredictor:
    """Ternary motion-vector predictor (reference src/ml_bridge.rs:81-109);
    its products run on ``device``."""

    def __init__(self, weights, input_dim: int, *, device=None):
        w = np.asarray(weights, np.int8).reshape(2, input_dim)
        self.device = resolve_device(device)
        self._weights = _f32(w, self.device)
        self.input_dim = input_dim

    def predict(self, features) -> tuple[float, float]:
        out = ternary_matvec(features, self._weights, device=self.device)
        return float(out[0]), float(out[1])
