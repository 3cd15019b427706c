"""The port's segmentation and container probing against the JAX package,
on the CPU: motion and chroma masks (the morphology's zero / one padding
at the frame's edges, empty masks), bboxes and counts equal; crop,
paste, RLE, ``extract_person_rgb`` and the ``*_numpy`` twins equal; the
MP4 / EBML parsers and ``detect_format`` equal on bytes built here."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from alice_codec_tpu import container as jcontainer
from alice_codec_tpu import segment as jsegment

from alice_codec_tpu_torch import container, segment

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _quick_jax_compiles():
    """The JAX programs of this module compile with most XLA optimizations
    off (their results are the same; their compile is the cost here), and
    the setting is restored after the module."""
    prev = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", prev)

H, W = 24, 40
#: (dilate_radius, erode_radius)
RADII = [(0, 0), (2, 1), (3, 2)]


def _frames(kind: str):
    """(current, reference) uint8 (H, W) frames of one motion case."""
    rng = np.random.default_rng(11)
    ref = rng.integers(0, 256, (H, W), dtype=np.uint8)
    if kind == "empty":
        return ref.copy(), ref
    cur = np.clip(ref.astype(np.int64) + rng.integers(-20, 21, (H, W)), 0, 255)
    if kind == "seeded":  # sensor noise around the threshold, two blobs
        cur[5:11, 8:15] += 90
        cur[14:17, 27:36] -= 80
    elif kind == "edges":  # motion touching every edge and corner
        cur = ref.astype(np.int64)
        cur[0, 3:9] += 60
        cur[H - 2 :, 30:33] += 60
        cur[8:12, 0] += 60
        cur[:2, W - 1] += 60
        cur[H - 1, 0] += 60
    return np.clip(cur, 0, 255).astype(np.uint8), ref


def _same_result(ours, ref):
    assert ours.mask.dtype == np.uint8
    np.testing.assert_array_equal(ours.mask, np.asarray(ref.mask))
    assert ours.bbox == ref.bbox
    assert ours.foreground_count == ref.foreground_count
    assert (ours.width, ours.height) == (ref.width, ref.height)
    assert ours.coverage == ref.coverage


@pytest.mark.parametrize("radii", RADII)
@pytest.mark.parametrize("kind", ["seeded", "edges", "empty"])
def test_motion_segmentation_equals_jax(kind, radii):
    cur, ref = _frames(kind)
    cfg = dict(motion_threshold=25, dilate_radius=radii[0], erode_radius=radii[1])
    ours = segment.segment_by_motion(cur.reshape(-1), ref.reshape(-1), W, H,
                                     segment.SegmentConfig(**cfg), device="cpu")
    want = jsegment.segment_by_motion(cur.reshape(-1), ref.reshape(-1), W, H,
                                      jsegment.SegmentConfig(**cfg))
    _same_result(ours, want)
    if kind == "empty":
        assert ours.bbox == (0, 0, 0, 0) and ours.foreground_count == 0
    else:
        assert 0 < ours.foreground_count < H * W
    mask, bbox, fg = segment.motion_mask_device(
        torch.from_numpy(cur), torch.from_numpy(ref), threshold=25,
        dilate_radius=radii[0], erode_radius=radii[1], device="cpu")
    assert mask.dtype == torch.uint8 and mask.shape == (H, W)
    assert tuple(bbox.tolist()) == want.bbox and int(fg) == want.foreground_count
    got_np = segment.segment_motion_numpy(cur, ref, 25, *radii, device="cpu")
    want_np = jsegment.segment_motion_numpy(cur, ref, 25, *radii)
    np.testing.assert_array_equal(got_np[0], want_np[0])
    assert got_np[1:] == want_np[1:]


@pytest.mark.parametrize("threshold", [-12, 30])
def test_chroma_segmentation_equals_jax(threshold):
    rng = np.random.default_rng(12)
    cg = rng.integers(-60, 120, (H, W)).astype(np.int16)
    cg[:, :6] = -100  # foreground at the left edge
    y = co = np.zeros((H, W), np.int16)
    ours = segment.segment_by_chroma(y, co, cg, W, H, threshold, device="cpu")
    want = jsegment.segment_by_chroma(y, co, cg, W, H, threshold)
    _same_result(ours, want)
    got_np = segment.segment_chroma_numpy(y, co, cg, threshold, device="cpu")
    want_np = jsegment.segment_chroma_numpy(y, co, cg, threshold)
    np.testing.assert_array_equal(got_np[0], want_np[0])
    assert got_np[1:] == want_np[1:]
    # a uint8 plane above int8 (cast to int16 before the compare)
    u8 = rng.integers(0, 256, (H, W)).astype(np.uint8)
    _same_result(segment.segment_by_chroma(y, co, u8, W, H, 200, device="cpu"),
                 jsegment.segment_by_chroma(y, co, u8, W, H, 200))


def test_segment_validation_equals_jax():
    small, full = np.zeros(10, np.uint8), np.zeros(H * W, np.uint8)
    for mod in (segment, jsegment):
        with pytest.raises(mod.InvalidBufferSize):
            mod.segment_by_motion(small, full, W, H, **(
                {"device": "cpu"} if mod is segment else {}))
        with pytest.raises(ValueError, match="4 elements"):
            mod.crop_bbox_numpy(np.zeros((4, 4), np.uint8), (1, 2, 3))
        with pytest.raises(ValueError, match="4 elements"):
            mod.paste_bbox_numpy(np.zeros((4, 4), np.uint8), b"", (1, 2, 3))


def test_crop_paste_and_person_pixels_equal_jax():
    rng = np.random.default_rng(13)
    frame = rng.integers(0, 256, (H, W), dtype=np.uint8)
    for bbox in [(3, 4, 6, 5), (35, 20, 10, 10), (0, 0, W, H), (5, 5, 0, 3)]:
        np.testing.assert_array_equal(
            segment.crop_to_bbox(frame.reshape(-1), W, bbox),
            jsegment.crop_to_bbox(frame.reshape(-1), W, bbox))
        person = rng.integers(0, 256, max(bbox[2] * bbox[3] - 7, 0), dtype=np.uint8)
        a, b = frame.copy(), frame.copy()
        segment.paste_from_bbox(a, W, person, bbox)
        jsegment.paste_from_bbox(b, W, person, bbox)
        np.testing.assert_array_equal(a, b)
    box = (3, 4, 6, 5)
    np.testing.assert_array_equal(segment.crop_bbox_numpy(frame, box),
                                  jsegment.crop_bbox_numpy(frame, box))
    a, b = np.zeros_like(frame), np.zeros_like(frame)
    crop = segment.crop_bbox_numpy(frame, box).reshape(-1)
    segment.paste_bbox_numpy(a, crop, box)
    jsegment.paste_bbox_numpy(b, crop, box)
    np.testing.assert_array_equal(a, b)

    cur, ref = _frames("seeded")
    cfg = dict(dilate_radius=2, erode_radius=1)
    ours = segment.segment_by_motion(cur, ref, W, H, segment.SegmentConfig(**cfg),
                                     device="cpu")
    want = jsegment.segment_by_motion(cur, ref, W, H, jsegment.SegmentConfig(**cfg))
    rgb = rng.integers(0, 256, H * W * 3, dtype=np.uint8)
    for n in (rgb.size, rgb.size - 100):  # a frame buffer cut short too
        np.testing.assert_array_equal(ours.extract_person_rgb(rgb[:n]),
                                      want.extract_person_rgb(rgb[:n]))
    empty = segment.SegmentResult(np.zeros((H, W), np.uint8), (0, 0, 0, 0), 0, W, H)
    assert empty.extract_person_rgb(rgb).size == 0
    assert ours.rle_encode_mask() == want.rle_encode_mask()


def test_rle_equals_jax():
    rng = np.random.default_rng(14)
    masks = [np.zeros(0, np.uint8), rng.integers(0, 2, (H, W), dtype=np.uint8),
             np.concatenate([np.zeros(70_000, np.uint8), np.ones(140_000, np.uint8),
                             np.zeros(3, np.uint8)]),  # runs over 65535
             np.full(65535, 1, np.uint8), np.full(65536, 3, np.uint8)]
    for m in masks:
        data = segment.rle_encode_mask(m)
        assert data == jsegment.rle_encode_mask(m)
        assert data == segment.rle_encode_numpy(m) == jsegment.rle_encode_numpy(m)
        back = segment.rle_decode_mask(data)
        np.testing.assert_array_equal(back, jsegment.rle_decode_mask(data))
        np.testing.assert_array_equal(back, m.reshape(-1) & 1)


# ── container probing ───────────────────────────────────────────


def _box(kind: bytes, payload: bytes) -> bytes:
    return (8 + len(payload)).to_bytes(4, "big") + kind + payload


def _mp4() -> bytes:
    return (_box(b"ftyp", b"isom\x00\x00\x02\x00isomiso2")
            + _box(b"free", b"")
            + (1).to_bytes(4, "big") + b"mdat" + (16 + 5).to_bytes(8, "big")
            + b"\x01\x02\x03\x04\x05"
            + (0).to_bytes(4, "big") + b"moov" + b"\x00" * 11)


def _ebml() -> bytes:
    header = b"\x42\x86\x81\x01" + b"\x42\x82\x84webm"
    return (b"\x1a\x45\xdf\xa3" + bytes([0x80 | len(header)]) + header
            + b"\x18\x53\x80\x67" + b"\x01\x00\x00\x00\x00\x00\x00\x03" + b"abc"
            + b"\x1f\x43\xb6\x75\x40\x02" + b"xy")


def _plain(x):
    """A parser result as plain values (the packages' classes differ)."""
    if x is None or isinstance(x, (int, float, str, bytes)):
        return x
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_plain(v) for v in x)
    if isinstance(x, list):
        return [_plain(v) for v in x]
    if dataclasses.is_dataclass(x):
        return (type(x).__name__, _plain(dataclasses.astuple(x)))
    if hasattr(x, "value"):  # an enum member
        return (type(x).__name__, x.value)
    raise TypeError(type(x))


@pytest.mark.parametrize("data", [_mp4(), _ebml(), b"", b"\x00" * 7,
                                  b"RIFF\x00\x00\x00\x00WAVE",
                                  _box(b"ftyp", b"mp"), b"\x1a\x45\xdf"])
def test_container_parsers_equal_jax(data):
    calls = [("detect_format", (data,)), ("is_mp4", (data,)),
             ("is_matroska", (data,)), ("list_mp4_boxes", (data,)),
             ("list_ebml_elements", (data,))]
    for off in range(min(len(data), 24)):
        calls += [("parse_mp4_box", (data, off)), ("decode_vint", (data, off)),
                  ("decode_vint_size", (data, off)),
                  ("parse_ebml_element", (data, off))]
    for name, args in calls:
        assert _plain(getattr(container, name)(*args)) == _plain(
            getattr(jcontainer, name)(*args)), (name, args[1:])
    for box in container.list_mp4_boxes(data):
        assert container.box_type_str(box.box_type) == jcontainer.box_type_str(
            box.box_type)
        payload = data[box.data_offset:]
        assert container.parse_ftyp(payload) == jcontainer.parse_ftyp(payload)


def test_container_formats_detected():
    assert container.detect_format(_mp4()) == container.ContainerFormat.ISO_BASE_MEDIA
    assert container.detect_format(_ebml()) == container.ContainerFormat.MATROSKA
    assert len(container.list_mp4_boxes(_mp4())) == 4
    assert len(container.list_ebml_elements(_ebml())) == 3
    info = container.ContainerInfo(container.ContainerFormat.UNKNOWN, tracks=[
        container.TrackInfo(1, container.TrackKind.VIDEO, "alc3", 64, 32)])
    jinfo = jcontainer.ContainerInfo(jcontainer.ContainerFormat.UNKNOWN, tracks=[
        jcontainer.TrackInfo(1, jcontainer.TrackKind.VIDEO, "alc3", 64, 32)])
    assert _plain(info) == _plain(jinfo)
