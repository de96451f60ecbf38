"""The port's copies of the numpy frame helpers, the template loader and the
reference-image prep, held to their mimo_tpu originals (exact equality:
the same integer/numpy code), and the OpenCV-free resize."""

import json

import numpy as np
import pytest

from mimo_tpu.entry import runner as JR
from mimo_tpu.entry import template as JT
from mimo_tpu.utils import frames as JFU
from mimo_tpu.utils import video_io as JVIO
from mimo_tpu_torch.entry import runner as R
from mimo_tpu_torch.entry import template as T
from mimo_tpu_torch.utils import frames as FU
from mimo_tpu_torch.utils import video_io as VIO


def _pose_frames(n=6, h=90, w=70):
    frames = []
    for t in range(n):
        f = np.zeros((h, w, 3), np.uint8)
        f[20 + t:80, 15 + 2 * t:40 + 2 * t] = (120, 180, 90)
        f[5:9, 30:33] = (9, 9, 9)            # below the sdc threshold
        frames.append(f)
    return frames


def _ref_image():
    img = np.full((120, 90, 3), 250, np.uint8)
    img[30:100, 25:60] = (30, 60, 160)
    img[10:30, 35:50] = (220, 170, 140)
    return img


def test_crop_pad_init_bk_equal_original():
    frames = _pose_frames()
    bk = FU.init_bk(len(frames), *frames[0].shape[:2])
    got = FU.crop_human(frames, bk)
    ref = JFU.crop_human(frames, JFU.init_bk(len(frames),
                                             *frames[0].shape[:2]))
    assert got[-1] == ref[-1]
    for stream_g, stream_r in zip(got[:-1], ref[:-1]):
        for a, b in zip(stream_g, stream_r):
            np.testing.assert_array_equal(a, b)
    for color in ((0, 0, 0), (255, 255, 255)):
        pg, bg = FU.pad_img(got[0][0], color)
        pr, br = JFU.pad_img(ref[0][0], color)
        np.testing.assert_array_equal(pg, pr)
        assert bg == br


def test_reference_prep_equals_original():
    img = _ref_image()
    np.testing.assert_array_equal(R.prep_reference_image(img),
                                  JR.prep_reference_image(img))
    mask = JFU.extract_mask_sdc(_pose_frames()[0])
    np.testing.assert_array_equal(FU.clean_mask(mask), JFU.clean_mask(mask))


@pytest.mark.parametrize("w,h", [(32, 24), (140, 100), (70, 90)])
def test_resize_equals_original(w, h):
    img = _ref_image()
    np.testing.assert_array_equal(FU.resize_frame(img, w, h),
                                  JFU.resize_frame(img, w, h))


@pytest.mark.parametrize("w,h,tol", [
    (45, 60, 1),     # exact 2x area shrink: cv2 INTER_AREA averages 2x2
    (180, 240, 2),   # bilinear growth, half-pixel centres
])
def test_resize_without_cv2_close_to_cv2(w, h, tol, monkeypatch):
    """Without OpenCV the torch fallback stays within `tol` uint8 levels of
    cv2 (rounding of the 8-bit results differs)."""
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (120, 90, 3)).astype(np.uint8)
    want = FU.resize_frame(img, w, h)
    monkeypatch.setattr(FU, "cv2", None)
    got = FU.resize_frame(img, w, h)
    assert got.shape == want.shape and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= tol


def test_template_and_video_io_equal_original(tmp_path):
    frames = _pose_frames(n=8, h=64, w=48)
    d = tmp_path / "tpl"
    d.mkdir()
    JVIO.save_video(frames, str(d / "sdc.mp4"), fps=30)
    (d / "config.json").write_text(json.dumps(
        {"fps": 30, "time_crop": {"start_idx": 1, "end_idx": 7}}))
    got = T.load_template(str(d), max_frames=5)
    ref = JT.load_template(str(d), max_frames=5)
    assert got.fps == ref.fps and got.num_frames == ref.num_frames == 5
    for a, b in zip(got.sdc, ref.sdc):
        np.testing.assert_array_equal(a, b)
    out = str(tmp_path / "out.mp4")
    VIO.save_video([f.astype(np.float32) / 255 for f in frames], out, fps=30)
    back = VIO.load_video_fixed_fps(out)
    assert len(back) == len(frames) and back[0].shape == frames[0].shape
    JVIO.save_image(_ref_image(), str(tmp_path / "ref.png"))
    np.testing.assert_array_equal(VIO.load_image(str(tmp_path / "ref.png")),
                                  JVIO.load_image(str(tmp_path / "ref.png")))
