"""Person segmentation: frame-diff + morphology + bbox (PyTorch port of
``alice_codec_tpu/segment.py``; reference src/segment.rs).

The mask programs (:func:`motion_mask_device`, :func:`chroma_mask_device`)
run in torch on ``device`` (the CUDA card unless given another): a uint8
elementwise diff or threshold, then a box dilation with a (2r+1)×(2r+1)
structuring element as a separable max over zero-padded shifted slices —
exact for a box, and the JAX package's ``reduce_window`` max with
``padding="SAME"`` and 0 as the pad — and erosion as its complement
(¬dilate¬, a windowed min with 1-padding).  BBox falls out of row/column
any() reductions.  The host API (configs, results, crop / paste, RLE, the
``*_numpy`` twins) is a copy of the JAX package's, and mirrors the
reference Python bindings (src/python.rs:80-271).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ._device import resolve_device
from .errors import InvalidBufferSize

__all__ = [
    "SegmentConfig",
    "SegmentResult",
    "segment_by_motion",
    "segment_by_chroma",
    "segment_motion_numpy",
    "segment_chroma_numpy",
    "motion_mask_device",
    "chroma_mask_device",
    "crop_to_bbox",
    "paste_from_bbox",
    "crop_bbox_numpy",
    "paste_bbox_numpy",
    "rle_encode_mask",
    "rle_encode_numpy",
    "rle_decode_mask",
]


@dataclass
class SegmentConfig:
    """Segmentation parameters (reference src/segment.rs:43-63)."""

    motion_threshold: int = 25
    min_region_size: int = 100
    dilate_radius: int = 2
    erode_radius: int = 1


@dataclass
class SegmentResult:
    """Mask + bbox + stats (reference src/segment.rs:79-101)."""

    mask: np.ndarray  # (H, W) uint8, 1 = foreground
    bbox: tuple[int, int, int, int]  # x, y, w, h
    foreground_count: int
    width: int
    height: int

    @property
    def coverage(self) -> float:
        total = self.width * self.height
        return 0.0 if total == 0 else self.foreground_count / total

    def extract_person_rgb(self, frame_rgb) -> np.ndarray:
        """Foreground RGB pixels within the bbox (src/segment.rs:107-125).

        Vectorized row-major selection — identical output order and
        bounds semantics to the reference's per-pixel loop (a pixel is
        included only when its mask bit is 1 AND its 3 bytes lie fully
        inside the frame buffer)."""
        frame = np.asarray(frame_rgb, np.uint8).reshape(-1)
        bx, by, bw, bh = self.bbox
        if bw == 0 or bh == 0:
            return np.empty(0, np.uint8)
        mask = self.mask.reshape(self.height, self.width)
        rows = np.arange(by, by + bh, dtype=np.int64)
        cols = np.arange(bx, bx + bw, dtype=np.int64)
        idx = rows[:, None] * self.width + cols[None, :]
        sel = (mask[by : by + bh, bx : bx + bw] == 1) & (
            idx * 3 + 2 < frame.size
        )
        pix = idx[sel]  # row-major == the reference loop order
        return frame[(pix[:, None] * 3 + np.arange(3)).reshape(-1)]

    def rle_encode_mask(self) -> bytes:
        return rle_encode_mask(self.mask)


# ── Device programs ─────────────────────────────────────────────


def _dilate(mask: torch.Tensor, r: int) -> torch.Tensor:
    """Box dilation radius r == windowed max over (2r+1)², edge-padded
    with 0: a max over 2r+1 shifted slices along W, then along H."""
    h, w = mask.shape[-2:]
    row = F.pad(mask, (r, r))
    out = row[..., 0:w]
    for k in range(1, 2 * r + 1):
        out = torch.maximum(out, row[..., k : k + w])
    col = F.pad(out, (0, 0, r, r))
    out = col[..., 0:h, :]
    for k in range(1, 2 * r + 1):
        out = torch.maximum(out, col[..., k : k + h, :])
    return out


def _erode(mask: torch.Tensor, r: int) -> torch.Tensor:
    """Erosion = ¬dilate(¬mask) == windowed min with 1-padding."""
    return _dilate(mask ^ 1, r) ^ 1


def _bbox_and_count(mask: torch.Tensor):
    """Row/col reduction bbox → ``(bbox (4,) int64 [x, y, w, h], count
    int64)``, the bbox zero when the mask is empty (the JAX package's are
    uint32; the values are equal)."""
    h, w = mask.shape
    fg_px = mask != 0
    # argmax on uint8 (torch has none on bool); both take the first maximum
    rows = fg_px.any(dim=1).to(torch.uint8)
    cols = fg_px.any(dim=0).to(torch.uint8)
    fg = mask.sum(dtype=torch.int64)
    min_y = torch.argmax(rows)
    max_y = h - 1 - torch.argmax(rows.flip(0))
    min_x = torch.argmax(cols)
    max_x = w - 1 - torch.argmax(cols.flip(0))
    bbox = torch.stack([min_x, min_y, max_x - min_x + 1, max_y - min_y + 1])
    return torch.where(fg > 0, bbox, torch.zeros_like(bbox)), fg


def _tensor(x, dev: torch.device) -> torch.Tensor:
    """``x`` (a tensor, or NumPy copied: torch takes only writable arrays)
    on ``dev``."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    return torch.as_tensor(np.array(x), device=dev)


def _morphology(mask: torch.Tensor, dilate_radius: int, erode_radius: int):
    if dilate_radius > 0:
        mask = _dilate(mask, dilate_radius)
    if erode_radius > 0:
        mask = _erode(mask, erode_radius)
    bbox, fg = _bbox_and_count(mask)
    return mask, bbox, fg


def motion_mask_device(current, reference, *, threshold: int, dilate_radius: int,
                       erode_radius: int, device=None):
    """Device motion segmentation of two (H, W) uint8 frames (tensors or
    NumPy, moved to ``device``, the CUDA card unless given another):
    |cur−ref| > threshold, then morphology → ``(mask (H, W) uint8, bbox,
    count)``.

    Matches the reference's saturating-diff semantics (src/segment.rs:194-208):
    ``a.sat_sub(b) | b.sat_sub(a)`` is exactly uint8 ``|a−b|``.
    """
    dev = resolve_device(device)
    a = _tensor(current, dev).to(torch.int16)
    b = _tensor(reference, dev).to(torch.int16)
    mask = ((a - b).abs() > threshold).to(torch.uint8)
    return _morphology(mask, dilate_radius, erode_radius)


def chroma_mask_device(cg, green_threshold, *, dilate_radius: int = 2,
                       erode_radius: int = 1, device=None):
    """Device chroma-key segmentation of an (H, W) Cg plane (moved to
    ``device``, the CUDA card unless given another): cg ≤ threshold in
    int16 → foreground (reference src/segment.rs:234-265)."""
    dev = resolve_device(device)
    mask = (_tensor(cg, dev).to(torch.int16) <= int(green_threshold)).to(torch.uint8)
    return _morphology(mask, dilate_radius, erode_radius)


# ── Host API (reference signatures) ─────────────────────────────


def segment_by_motion(
    current, reference, width: int, height: int, config: SegmentConfig | None = None,
    *, device=None,
) -> SegmentResult:
    """Motion-based segmentation (reference src/segment.rs:172-222); the
    mask program runs on ``device`` (the CUDA card unless given another)."""
    config = config or SegmentConfig()
    total = width * height
    cur = np.asarray(current, np.uint8).reshape(-1)
    ref = np.asarray(reference, np.uint8).reshape(-1)
    if cur.size < total:
        raise InvalidBufferSize(total, cur.size)
    if ref.size < total:
        raise InvalidBufferSize(total, ref.size)
    mask, bbox, fg = motion_mask_device(
        cur[:total].reshape(height, width),
        ref[:total].reshape(height, width),
        threshold=int(config.motion_threshold),
        dilate_radius=int(config.dilate_radius),
        erode_radius=int(config.erode_radius),
        device=device,
    )
    return _result(mask, bbox, fg, width, height)


def segment_by_chroma(
    y, co, cg, width: int, height: int, green_threshold: int = 30, *, device=None,
) -> SegmentResult:
    """Chroma-key segmentation (reference src/segment.rs:234-265); the
    mask program runs on ``device`` (the CUDA card unless given another)."""
    total = width * height
    cg_arr = np.asarray(cg, np.int16).reshape(-1)[:total].reshape(height, width)
    mask, bbox, fg = chroma_mask_device(cg_arr, int(green_threshold), device=device)
    return _result(mask, bbox, fg, width, height)


def _result(mask, bbox, fg, width: int, height: int) -> SegmentResult:
    """One host read of a mask program's outputs."""
    return SegmentResult(mask.cpu().numpy(), tuple(bbox.tolist()), int(fg),
                         width, height)


def crop_to_bbox(frame, frame_width: int, bbox) -> np.ndarray:
    """Crop a flat frame to a bbox region (reference src/segment.rs:269-281).

    Vectorized gather; a row is included only when it fits entirely inside
    the frame buffer (reference row-bounds semantics)."""
    frame = np.asarray(frame, np.uint8).reshape(-1)
    bx, by, bw, bh = (int(v) for v in bbox)
    if bw <= 0 or bh <= 0:
        return np.empty(0, np.uint8)
    starts = (np.arange(by, by + bh, dtype=np.int64) * frame_width) + bx
    starts = starts[starts + bw <= frame.size]
    return frame[(starts[:, None] + np.arange(bw)).reshape(-1)]


def paste_from_bbox(frame: np.ndarray, frame_width: int, person_data, bbox) -> None:
    """Paste cropped data back into a flat frame, in place (src/segment.rs:284-298).

    Vectorized scatter; a row is pasted only when both its destination and
    source spans fit (reference row-bounds semantics)."""
    person = np.asarray(person_data, np.uint8).reshape(-1)
    bx, by, bw, bh = (int(v) for v in bbox)
    if bw <= 0 or bh <= 0:
        return
    flat = frame.reshape(-1)
    dst = (np.arange(by, by + bh, dtype=np.int64) * frame_width) + bx
    src = np.arange(bh, dtype=np.int64) * bw
    keep = (dst + bw <= flat.size) & (src + bw <= person.size)
    cols = np.arange(bw)
    flat[(dst[keep, None] + cols).reshape(-1)] = person[
        (src[keep, None] + cols).reshape(-1)
    ]


def rle_encode_mask(mask) -> bytes:
    """RLE mask encoding: [u16 LE run][u8 value] (reference src/segment.rs:131-153)."""
    m = (np.asarray(mask, np.uint8).reshape(-1) & 1).astype(np.uint8)
    if m.size == 0:
        return b""
    # vectorized run extraction
    change = np.nonzero(np.diff(m))[0] + 1
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [m.size]])
    out = bytearray()
    for s, e in zip(starts, ends):
        val = int(m[s])
        run = e - s
        while run > 0xFFFF:
            out += (0xFFFF).to_bytes(2, "little") + bytes([val])
            run -= 0xFFFF
        out += int(run).to_bytes(2, "little") + bytes([val])
    return bytes(out)


def rle_decode_mask(data: bytes) -> np.ndarray:
    """Inverse of :func:`rle_encode_mask` (not in the reference; completeness)."""
    runs = np.frombuffer(data, np.uint8).reshape(-1, 3)
    lengths = runs[:, 0].astype(np.uint32) | (runs[:, 1].astype(np.uint32) << 8)
    return np.repeat(runs[:, 2], lengths).astype(np.uint8)


# ── NumPy-binding-compatible wrappers (reference src/python.rs) ──


def segment_motion_numpy(
    current, reference, motion_threshold: int = 25, dilate_radius: int = 2,
    erode_radius: int = 1, *, device=None,
):
    """Mirror of the reference PyO3 ``segment_motion_numpy`` (src/python.rs:82-129).

    Returns (mask (H,W) uint8, [x, y, w, h], foreground_count).
    """
    cur = np.asarray(current, np.uint8)
    ref = np.asarray(reference, np.uint8)
    h, w = cur.shape
    config = SegmentConfig(
        motion_threshold=motion_threshold,
        dilate_radius=dilate_radius,
        erode_radius=erode_radius,
    )
    res = segment_by_motion(cur, ref, w, h, config, device=device)
    return res.mask.reshape(h, w), list(res.bbox), res.foreground_count


def segment_chroma_numpy(y_channel, co_channel, cg_channel, green_threshold: int = 30,
                         *, device=None):
    """Mirror of the reference ``segment_chroma_numpy`` (src/python.rs:141-185)."""
    y = np.asarray(y_channel, np.int16)
    h, w = y.shape
    res = segment_by_chroma(y, co_channel, cg_channel, w, h, green_threshold,
                            device=device)
    return res.mask.reshape(h, w), list(res.bbox), res.foreground_count


def crop_bbox_numpy(frame, bbox):
    """Mirror of ``crop_bbox_numpy`` (src/python.rs:195-219)."""
    if len(bbox) != 4:
        raise ValueError("bbox must have 4 elements")
    frame = np.asarray(frame, np.uint8)
    h, w = frame.shape
    cropped = crop_to_bbox(frame, w, bbox)
    return cropped.reshape(int(bbox[3]), int(bbox[2]))


def paste_bbox_numpy(frame, person_data, bbox) -> None:
    """Mirror of ``paste_bbox_numpy`` (src/python.rs:227-248); modifies in place."""
    if len(bbox) != 4:
        raise ValueError("bbox must have 4 elements")
    h, w = frame.shape
    paste_from_bbox(frame, w, person_data, bbox)


def rle_encode_numpy(mask) -> bytes:
    """Mirror of ``rle_encode_numpy`` (src/python.rs:257-271)."""
    return rle_encode_mask(mask)
