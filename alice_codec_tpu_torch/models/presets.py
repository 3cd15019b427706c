"""Named codec operating points (model presets; PyTorch port of
``alice_codec_tpu/models/presets.py``).

Each preset bundles a wavelet family, quality, entropy-lane width and
decode mode into encoder/decoder factories:

* ``REALTIME``  — Haar, q=75: lowest latency, cheapest transform.
* ``STREAMING`` — CDF 5/3, q=90 + leaky-bucket rate control: the default
  delivery profile (BASELINE config 5 pairing).
* ``ARCHIVAL``  — CDF 9/7, q=95: best lossy compression (BASELINE config 3).
* ``LOSSLESS``  — CDF 5/3, q=100, exact-undo inverse: perfect
  reconstruction for in-gamut content (BASELINE config 1).

The factories build the port's coders on ``device`` (the CUDA card unless
given another).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..core import WaveletType
from ..pipeline import FrameDecoder, FrameEncoder
from ..rate_control import RateControlConfig, RateController

__all__ = [
    "CodecPreset",
    "REALTIME",
    "STREAMING",
    "ARCHIVAL",
    "LOSSLESS",
    "PRESETS",
    "get_preset",
]


@dataclass(frozen=True)
class CodecPreset:
    """A named encode/decode operating point."""

    name: str
    wavelet: WaveletType
    quality: int
    exact_decode: bool = False
    n_lanes: int = 64
    rate_control: RateControlConfig | None = None

    def encoder(self, *, device=None) -> FrameEncoder:
        return FrameEncoder(quality=self.quality, wavelet=self.wavelet,
                            device=device)

    def decoder(self, *, device=None) -> FrameDecoder:
        return FrameDecoder(device=device)

    def decode(self, decoder: FrameDecoder, chunk):
        return decoder.decode(chunk, exact=self.exact_decode)

    def batch_encoder(self, *, mesh=None, device_entropy: bool = False,
                      device=None):
        from ..parallel import BatchFrameEncoder

        return BatchFrameEncoder(
            quality=self.quality,
            wavelet=self.wavelet,
            n_lanes=self.n_lanes,
            mesh=mesh,
            device_entropy=device_entropy,
            device=device,
        )

    def rate_controller(self) -> RateController | None:
        if self.rate_control is None:
            return None
        return RateController(self.rate_control)


REALTIME = CodecPreset("realtime", WaveletType.HAAR, 75)
STREAMING = CodecPreset(
    "streaming",
    WaveletType.CDF53,
    90,
    rate_control=RateControlConfig(),
)
ARCHIVAL = CodecPreset("archival", WaveletType.CDF97, 95)
LOSSLESS = CodecPreset("lossless", WaveletType.CDF53, 100, exact_decode=True)

PRESETS = {p.name: p for p in (REALTIME, STREAMING, ARCHIVAL, LOSSLESS)}


def get_preset(name: str) -> CodecPreset:
    try:
        return PRESETS[name]
    except KeyError:
        raise ValueError(
            f"unknown preset '{name}'; expected one of {sorted(PRESETS)}"
        ) from None
