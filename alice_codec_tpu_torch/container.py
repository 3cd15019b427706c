"""Container probing: MP4 (ISO BMFF) and Matroska/WebM headers.

Pure-host byte parsing (reference: src/container.rs) — no device work.
A copy of ``alice_codec_tpu/container.py``, kept here so the port never
imports the JAX package.
Basis for storing ALICE streams inside standard containers.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

__all__ = [
    "ContainerFormat",
    "TrackKind",
    "TrackInfo",
    "ContainerInfo",
    "Mp4Box",
    "parse_mp4_box",
    "list_mp4_boxes",
    "box_type_str",
    "parse_ftyp",
    "is_mp4",
    "EbmlElement",
    "decode_vint",
    "decode_vint_size",
    "parse_ebml_element",
    "is_matroska",
    "detect_format",
    "list_ebml_elements",
]


class ContainerFormat(enum.Enum):
    """Container format kind (reference src/container.rs:17-25)."""

    ISO_BASE_MEDIA = "iso_base_media"
    MATROSKA = "matroska"
    UNKNOWN = "unknown"


class TrackKind(enum.Enum):
    """Track kind (reference src/container.rs:28-34)."""

    VIDEO = "video"
    AUDIO = "audio"
    SUBTITLE = "subtitle"
    OTHER = "other"


@dataclass
class TrackInfo:
    """Track metadata scaffold (reference src/container.rs:37-56)."""

    id: int
    kind: TrackKind
    codec_id: str
    width: int | None = None
    height: int | None = None
    sample_rate: int | None = None
    channels: int | None = None
    timescale: int = 0
    duration: int = 0


@dataclass
class ContainerInfo:
    """Container probe result scaffold (reference src/container.rs:59-69)."""

    format: ContainerFormat
    duration_secs: float = 0.0
    tracks: list[TrackInfo] = field(default_factory=list)
    metadata: dict[str, str] = field(default_factory=dict)


# ── MP4 / ISO-BMFF ──────────────────────────────────────────────


@dataclass
class Mp4Box:
    """MP4 box header (reference src/container.rs:76-85)."""

    box_type: bytes  # 4 bytes
    payload_size: int
    data_offset: int


def parse_mp4_box(data: bytes, offset: int) -> Mp4Box | None:
    """Parse one box header, handling 64-bit extended size and size-0
    (to-EOF) boxes (reference src/container.rs:92-140)."""
    if offset + 8 > len(data):
        return None
    size = int.from_bytes(data[offset : offset + 4], "big")
    box_type = bytes(data[offset + 4 : offset + 8])
    if size == 1:
        if offset + 16 > len(data):
            return None
        ext = int.from_bytes(data[offset + 8 : offset + 16], "big")
        return Mp4Box(box_type, max(ext - 16, 0), offset + 16)
    if size == 0:
        return Mp4Box(box_type, len(data) - offset - 8, offset + 8)
    return Mp4Box(box_type, max(size - 8, 0), offset + 8)


def list_mp4_boxes(data: bytes) -> list[Mp4Box]:
    """Enumerate top-level boxes (reference src/container.rs:144-158)."""
    boxes = []
    offset = 0
    while True:
        b = parse_mp4_box(data, offset)
        if b is None:
            break
        total = b.payload_size + (b.data_offset - offset)
        boxes.append(b)
        offset += total
        if offset >= len(data) or total == 0:
            break
    return boxes


def box_type_str(box_type: bytes) -> str:
    """4CC to string (reference src/container.rs:162-164)."""
    return box_type.decode("utf-8", errors="replace")


def parse_ftyp(data: bytes) -> str | None:
    """Major brand from an ftyp payload (reference src/container.rs:168-173)."""
    if len(data) < 4:
        return None
    return data[:4].decode("utf-8", errors="replace")


def is_mp4(data: bytes) -> bool:
    """True if the stream starts with an ftyp box (reference src/container.rs:177-179)."""
    b = parse_mp4_box(data, 0)
    return b is not None and b.box_type == b"ftyp"


# ── EBML / Matroska ─────────────────────────────────────────────


@dataclass
class EbmlElement:
    """EBML element header (reference src/container.rs:186-196)."""

    id: int
    data_size: int
    data_offset: int
    header_size: int


def decode_vint(data: bytes, offset: int) -> tuple[int, int] | None:
    """Decode an EBML variable-length integer → (value, length)
    (reference src/container.rs:202-224)."""
    if offset >= len(data):
        return None
    first = data[offset]
    if first == 0:
        return None
    length = (8 - first.bit_length()) + 1
    if offset + length > len(data) or length > 8:
        return None
    value = first
    for i in range(1, length):
        value = (value << 8) | data[offset + i]
    return value, length


def decode_vint_size(data: bytes, offset: int) -> tuple[int, int] | None:
    """Decode a size vint, clearing the length-marker bit
    (reference src/container.rs:228-233)."""
    res = decode_vint(data, offset)
    if res is None:
        return None
    raw, length = res
    return raw ^ (1 << (7 * length)), length


def parse_ebml_element(data: bytes, offset: int) -> EbmlElement | None:
    """Parse an EBML element header (reference src/container.rs:237-247)."""
    idres = decode_vint(data, offset)
    if idres is None:
        return None
    eid, id_len = idres
    sizeres = decode_vint_size(data, offset + id_len)
    if sizeres is None:
        return None
    data_size, size_len = sizeres
    return EbmlElement(eid, data_size, offset + id_len + size_len, id_len + size_len)


def is_matroska(data: bytes) -> bool:
    """EBML magic 0x1A45DFA3 check (reference src/container.rs:253-259)."""
    return len(data) >= 4 and data[:4] == b"\x1a\x45\xdf\xa3"


def detect_format(data: bytes) -> ContainerFormat:
    """Auto-detect container format (reference src/container.rs:263-271)."""
    if is_mp4(data):
        return ContainerFormat.ISO_BASE_MEDIA
    if is_matroska(data):
        return ContainerFormat.MATROSKA
    return ContainerFormat.UNKNOWN


def list_ebml_elements(data: bytes) -> list[EbmlElement]:
    """Enumerate top-level EBML elements (reference src/container.rs:275-289)."""
    elements = []
    offset = 0
    while True:
        elem = parse_ebml_element(data, offset)
        if elem is None:
            break
        total = elem.header_size + elem.data_size
        elements.append(elem)
        offset += total
        if offset >= len(data) or total == 0:
            break
    return elements
