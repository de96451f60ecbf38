"""The port's OpenCV-free morphology (mimo_tpu_torch/ops/morphology.py)
against OpenCV, bit for bit: dilate, erode, close and open over 5x5 and
2x2 rectangles, the 5x5 ellipse and an even / odd rectangle, on random
masks and masks that touch the borders, at 0/1 and 0/255, as numpy arrays
and as (N, H, W) tensors; the fixed-point gray conversion; the 8-connected
component count. Then the fault this repairs: with cv2 = None the port's
utils/frames.clean_mask and entry/runner.segment_reference equal
mimo_tpu's (which run with OpenCV) in every pixel, where clean_mask used
to return its input. And INTER_NEAREST's floor rule, which the background
stage takes from F.interpolate(mode="nearest").

Tolerance: none; every comparison is exact.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

cv2 = pytest.importorskip("cv2")

from mimo_tpu_torch.ops import morphology as MO  # noqa: E402

ELEMENTS = {"rect5": MO.rect(5, 5), "rect2": MO.rect(2, 2),
            "ellipse5": MO.ELLIPSE_5, "rect3x4": MO.rect(3, 4)}
CV_OPS = {"dilate": lambda m, k: cv2.dilate(m, k),
          "erode": lambda m, k: cv2.erode(m, k),
          "close": lambda m, k: cv2.morphologyEx(m, cv2.MORPH_CLOSE, k),
          "open": lambda m, k: cv2.morphologyEx(m, cv2.MORPH_OPEN, k)}


def _masks(seed, n=4, h=37, w=53):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        m = rng.random((h, w)) < rng.uniform(0.2, 0.8)
        if i % 2:                 # a solid block on the bottom-left border
            m[h // 2:, : w // 3] = True
            m[0, :] = True
        out.append(m.astype(np.uint8))
    return out


def test_ellipse_is_opencvs():
    np.testing.assert_array_equal(
        MO.ELLIPSE_5, cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (5, 5)))
    np.testing.assert_array_equal(
        MO.rect(2, 2), cv2.getStructuringElement(cv2.MORPH_RECT, (2, 2)))


@pytest.mark.parametrize("op", list(CV_OPS))
@pytest.mark.parametrize("element", list(ELEMENTS))
@pytest.mark.parametrize("scale", [1, 255])
def test_morphology_equals_opencv(op, element, scale):
    k = ELEMENTS[element]
    seed = 10 * list(CV_OPS).index(op) + list(ELEMENTS).index(element)
    masks = [m * scale for m in _masks(seed)]
    for m in masks:
        np.testing.assert_array_equal(getattr(MO, op)(m, k),
                                      CV_OPS[op](m, k))
    # the tensor path, a batch at once
    got = getattr(MO, op)(torch.from_numpy(np.stack(masks)), k)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(),
                                  np.stack([CV_OPS[op](m, k) for m in masks]))


def test_gray_equals_opencv():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (300, 300, 3)).astype(np.uint8)
    np.testing.assert_array_equal(MO.rgb_to_gray(img),
                                  cv2.cvtColor(img, cv2.COLOR_RGB2GRAY))
    # every pixel whose gray lies near the sdc threshold of 10
    v = np.arange(0, 64, dtype=np.uint8)
    near = np.stack(np.meshgrid(v, v, v, indexing="ij"), -1).reshape(
        64 * 64, 64, 3)
    gray = cv2.cvtColor(near, cv2.COLOR_RGB2GRAY)
    assert ((gray >= 8) & (gray <= 12)).sum() > 1000
    np.testing.assert_array_equal(MO.rgb_to_gray(near), gray)


def test_component_count_equals_opencv():
    for m in _masks(3, n=6, h=60, w=70):
        n = cv2.connectedComponentsWithStats(m, connectivity=8)[0] - 1
        assert MO.count_components_8(m) == n
        assert MO.count_components_8(m * 255) == n


def test_clean_mask_without_cv2_equals_jax(monkeypatch):
    """The repaired fault: with cv2 = None the port's clean_mask was the
    identity; now it equals mimo_tpu's (close 5x5, open 2x2, with
    OpenCV) on a seeded 96x80 mask, at 0/255 and 0/1."""
    from mimo_tpu.utils import frames as JF
    from mimo_tpu_torch.utils import frames as FU
    rng = np.random.default_rng(0)
    m = ((rng.random((96, 80)) < 0.5) * 255).astype(np.uint8)
    want = JF.clean_mask(m)
    monkeypatch.setattr(FU, "cv2", None)
    assert (want != m).sum() > 1000          # the identity was far off
    np.testing.assert_array_equal(FU.clean_mask(m), want)
    np.testing.assert_array_equal(FU.clean_mask(m // 255),
                                  JF.clean_mask(m // 255))


def test_segment_reference_without_cv2_equals_jax(monkeypatch):
    from mimo_tpu.entry import runner as JA
    from mimo_tpu_torch.entry import runner as R
    from mimo_tpu_torch.utils import frames as FU
    rng = np.random.default_rng(1)
    img = np.full((90, 70, 3), 240, np.uint8)
    img[15:80, 20:50] = rng.integers(0, 120, (65, 30, 3))
    img[rng.random((90, 70)) < 0.05] = 0       # speckle the cleanup removes
    want = JA.segment_reference(img)
    monkeypatch.setattr(FU, "cv2", None)
    got = R.segment_reference(img)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("size", [(720, 480, 540, 360), (36, 44, 32, 40),
                                  (30, 20, 48, 40)])
def test_nearest_resize_equals_inter_nearest(size):
    """The background stage's mask resize: F.interpolate(mode="nearest")
    takes INTER_NEAREST's floor(dst * src / dst_size) source pixel."""
    h, w, nh, nw = size
    m = (np.random.default_rng(2).random((h, w)) < 0.5).astype(np.uint8)
    want = cv2.resize(m, (nw, nh), interpolation=cv2.INTER_NEAREST)
    got = F.interpolate(torch.from_numpy(m)[None, None].float(),
                        size=(nh, nw), mode="nearest")[0, 0]
    np.testing.assert_array_equal(got.to(torch.uint8).numpy(), want)
