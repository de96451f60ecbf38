"""The port's video and image I/O without OpenCV
(mimo_tpu_torch/utils/video_io.py with ``cv2 = None``, as on the card)
against OpenCV and mimo_tpu/utils/video_io.py on the same files:

- an uncompressed AVI written and read back without OpenCV gives the
  frames equal in every bit (uint8, and [0, 1] floats quantised as the
  OpenCV branch quantises them), at odd widths, with its fps and frame count;
- OpenCV's VideoCapture and mimo_tpu's readers read that file equal in every
  bit, also under a .mp4 name;
- ``load_video_fixed_fps`` keeps the frames mimo_tpu keeps at 60 and 25 fps;
- a 24-bit top-down BI_RGB AVI reads too; a file OpenCV wrote with a codec
  (mp4v, MJPG) raises, naming the codec;
- PNG: read without OpenCV equal in every bit to ``cv2.imread`` of files
  OpenCV wrote (random, flat, smooth, RGBA and gray images, each PNG row
  filter forced, and the adaptive choice); ``cv2.imread`` of the port's PNG
  equals its input; JPEG and 16-bit PNG raise, naming the format.

Every comparison is exact (tolerance 0).
"""

import struct

import numpy as np
import pytest

import cv2
from mimo_tpu.utils import video_io as JVIO
from mimo_tpu_torch.utils import video_io as VIO


@pytest.fixture
def no_cv2(monkeypatch):
    monkeypatch.setattr(VIO, "cv2", None)


def _clip(n, h, w, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(n)]


def _cv2_read(path):
    cap = cv2.VideoCapture(path)
    fps, count = cap.get(cv2.CAP_PROP_FPS), cap.get(cv2.CAP_PROP_FRAME_COUNT)
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(f, cv2.COLOR_BGR2RGB))
    cap.release()
    return fps, count, frames


def _equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == np.uint8 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("shape", [(37, 53), (16, 24), (1, 7)])
def test_avi_round_trip(tmp_path, no_cv2, dtype, shape):
    frames = _clip(5, *shape)
    if dtype == np.float32:
        frames = [f.astype(np.float32) / 255 * 1.1 - 0.05 for f in frames]
    want = [(np.clip(f, 0, 1) * 255).astype(np.uint8)
            if f.dtype != np.uint8 else f for f in frames]
    p = str(tmp_path / "sub" / "v.mp4")
    VIO.save_video(frames, p, fps=29.97)
    _equal(VIO.read_frames(p), want)
    assert VIO.get_fps(p) == 29.97
    with VIO.VideoReader(p) as r:
        assert (len(r), r.fps, r.height, r.width) == (5, 29.97, *shape)
        np.testing.assert_array_equal(r.get_frame(3), want[3])
        _equal(r.sample_clip(3, 1, 5), [want[1], want[2], want[4]])
        with pytest.raises(IndexError):
            r.get_frame(5)


def test_avi_size_limit_and_bad_frames(tmp_path, no_cv2, monkeypatch):
    p = tmp_path / "v.mp4"
    with pytest.raises(ValueError, match="no frames"):
        VIO.save_video([], str(p))
    with pytest.raises(ValueError, match="alike"):
        VIO.save_video([np.zeros((4, 4, 3), np.uint8),
                        np.zeros((4, 6, 3), np.uint8)], str(p))
    monkeypatch.setattr(VIO, "_RIFF_LIMIT", 10_000)
    with pytest.raises(ValueError, match="RIFF limit"):
        VIO.save_video(_clip(2, 40, 40), str(p))
    assert not p.exists()
    with pytest.raises(FileNotFoundError):
        VIO.read_frames(str(tmp_path / "missing.mp4"))


@pytest.mark.parametrize("name", ["v.mp4", "v.avi"])
def test_opencv_and_mimo_tpu_read_the_port_avi(tmp_path, monkeypatch, name):
    frames = _clip(6, 27, 45, seed=1)
    p = str(tmp_path / name)
    monkeypatch.setattr(VIO, "cv2", None)
    VIO.save_video(frames, p, fps=30)
    fps, count, got = _cv2_read(p)
    assert (fps, count) == (30.0, 6.0)
    _equal(got, frames)
    _equal(JVIO.read_frames(p), frames)
    assert JVIO.get_fps(p) == 30.0
    with JVIO.VideoReader(p) as r:
        assert (len(r), r.width, r.height) == (6, 45, 27)
        np.testing.assert_array_equal(r.get_frame(4), frames[4])
    # and the port's OpenCV branch reads it as mimo_tpu does
    monkeypatch.setattr(VIO, "cv2", cv2)
    _equal(VIO.read_frames(p), frames)


@pytest.mark.parametrize("fps", [60, 25])
def test_load_video_fixed_fps_keeps_mimo_tpu_frames(tmp_path, monkeypatch,
                                                    fps):
    frames = _clip(17, 12, 20, seed=2)
    p = str(tmp_path / "v.mp4")
    monkeypatch.setattr(VIO, "cv2", None)
    VIO.save_video(frames, p, fps=fps)
    for target, speed in ((30.0, 1.0), (12.5, 1.0), (30.0, 2.0)):
        want = JVIO.load_video_fixed_fps(p, target, speed)
        got = VIO.load_video_fixed_fps(p, target, speed)
        _equal(got, want)
        assert len(got) < len(frames) or fps == 25


def _bi_rgb24_top_down(path, frames, fps=24):
    """A minimal AVI with 24-bit BI_RGB rows, top-down (negative height),
    rows padded to 4 bytes, no index."""
    h, w = frames[0].shape[:2]
    stride = (3 * w + 3) & ~3
    size = stride * h
    strh = struct.pack("<4s4sI2H8I4h", b"vids", b"\0\0\0\0", 0, 0, 0, 0, 1,
                       fps, 0, len(frames), size, 0, 0, 0, 0, w, h)
    strf = struct.pack("<IiiHHIIiiII", 40, w, -h, 1, 24, 0, size, 0, 0, 0,
                       0)
    strl = VIO._chunk(b"LIST", b"strl" + VIO._chunk(b"strh", strh)
                      + VIO._chunk(b"strf", strf))
    avih = struct.pack("<14I", 0, 0, 0, 0, len(frames), 0, 1, size, w, h,
                       0, 0, 0, 0)
    hdrl = VIO._chunk(b"LIST", b"hdrl" + VIO._chunk(b"avih", avih) + strl)
    rows = np.zeros((h, stride), np.uint8)
    movi = b"movi"
    for f in frames:
        rows[:, :3 * w] = f[..., ::-1].reshape(h, 3 * w)
        movi += VIO._chunk(b"00db", rows.tobytes())
    body = b"AVI " + hdrl + VIO._chunk(b"LIST", movi)
    with open(path, "wb") as out:
        out.write(VIO._chunk(b"RIFF", body))


def test_reads_24_bit_top_down(tmp_path, no_cv2):
    frames = _clip(3, 9, 11, seed=3)
    p = str(tmp_path / "v.avi")
    _bi_rgb24_top_down(p, frames)
    _equal(VIO.read_frames(p), frames)
    assert VIO.get_fps(p) == 24.0


@pytest.mark.parametrize("name,fourcc", [("v.mp4", "mp4v"),
                                         ("v.avi", "mp4v"),
                                         ("v.avi", "MJPG")])
def test_a_codec_raises_naming_it(tmp_path, monkeypatch, name, fourcc):
    p = str(tmp_path / name)
    writer = cv2.VideoWriter(p, cv2.VideoWriter_fourcc(*fourcc), 30, (32, 24))
    for f in _clip(3, 24, 32):
        writer.write(f)
    writer.release()
    monkeypatch.setattr(VIO, "cv2", None)
    for read in (VIO.read_frames, VIO.get_fps, VIO.load_video_fixed_fps,
                 VIO.VideoReader):
        with pytest.raises(ValueError, match=f"'{fourcc}' needs OpenCV"):
            read(p)


def _images():
    rng = np.random.default_rng(4)
    yy, xx = np.mgrid[0:45, 0:61]
    smooth = np.stack([xx * 3, yy * 5, xx + yy], -1) % 256
    return {"random": rng.integers(0, 256, (38, 51, 3), dtype=np.uint8),
            "flat": np.full((20, 30, 3), 77, np.uint8),
            "smooth": smooth.astype(np.uint8),
            "rgba": rng.integers(0, 256, (33, 21, 4), dtype=np.uint8),
            "gray": rng.integers(0, 256, (17, 29), dtype=np.uint8)}


PNG_FILTERS = {"none": cv2.IMWRITE_PNG_FILTER_NONE,
               "sub": cv2.IMWRITE_PNG_FILTER_SUB,
               "up": cv2.IMWRITE_PNG_FILTER_UP,
               "average": cv2.IMWRITE_PNG_FILTER_AVG,
               "paeth": cv2.IMWRITE_PNG_FILTER_PAETH,
               "adaptive": cv2.IMWRITE_PNG_ALL_FILTERS}


@pytest.mark.parametrize("flt", list(PNG_FILTERS))
@pytest.mark.parametrize("image", list(_images()))
def test_png_read_equals_imread(tmp_path, monkeypatch, image, flt):
    p = str(tmp_path / "a.png")
    assert cv2.imwrite(p, _images()[image],
                       [cv2.IMWRITE_PNG_FILTER, PNG_FILTERS[flt]])
    want = cv2.cvtColor(cv2.imread(p, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
    monkeypatch.setattr(VIO, "cv2", None)
    got = VIO.load_image(p)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_imread_of_the_port_png_equals_input(tmp_path, no_cv2, dtype):
    img = _images()["random"]
    given = img.astype(np.float32) / 255 if dtype == np.float32 else img
    p = str(tmp_path / "a.png")
    VIO.save_image(given, p)
    got = cv2.cvtColor(cv2.imread(p, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(VIO.load_image(p), img)
    np.testing.assert_array_equal(JVIO.load_image(p), img)


def test_other_image_formats_raise(tmp_path, monkeypatch):
    jpg, deep = str(tmp_path / "a.jpg"), str(tmp_path / "b.png")
    cv2.imwrite(jpg, _images()["random"])
    cv2.imwrite(deep, np.full((8, 8, 3), 1000, np.uint16))
    monkeypatch.setattr(VIO, "cv2", None)
    with pytest.raises(ValueError, match="decoding JPEG needs OpenCV"):
        VIO.load_image(jpg)
    with pytest.raises(ValueError, match="bit depth 16.*needs OpenCV"):
        VIO.load_image(deep)
    with pytest.raises(ValueError, match="needs OpenCV"):
        VIO.save_image(_images()["flat"], str(tmp_path / "c.jpg"))
    with pytest.raises(FileNotFoundError):
        VIO.load_image(str(tmp_path / "missing.png"))
