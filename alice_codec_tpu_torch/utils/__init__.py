"""Utility helpers of the port: raw video IO, the `.alcs` chunk stream
and the fixtures' closed-form input (``golden``)."""

from .io import read_raw_rgb, write_raw_rgb, iter_chunks  # noqa: F401
from .stream import AlcStreamReader, AlcStreamWriter  # noqa: F401
