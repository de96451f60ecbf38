"""Host-side frame utilities of the animate path (numpy, cv2 optional).

Copies of the functions of ``mimo_tpu/utils/frames.py`` that the animate
path uses; that module cannot be imported where there is no JAX (importing
any ``mimo_tpu`` module imports ``jax``). ``tests/test_torch_frames.py``
holds each copy to its original.

``resize_frame`` is the one difference: without OpenCV it resizes with
``torch.nn.functional.interpolate`` (area when shrinking, bilinear with
half-pixel centres when growing, the two cv2 modes the original picks),
where the original fell back to nearest-neighbour sampling.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

try:
    import cv2
except ImportError:  # pragma: no cover - depends on the machine
    cv2 = None


def mask_bbox(mask: np.ndarray) -> Tuple[int, int, int, int]:
    """(x, y, w, h) bounding rect of a binary mask."""
    ys, xs = np.nonzero(mask)
    if len(xs) == 0:
        return 0, 0, 0, 0
    x, y = int(xs.min()), int(ys.min())
    return x, y, int(xs.max()) - x + 1, int(ys.max()) - y + 1


def crop_img(img: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Crop to the mask bbox, extended 5% vertically."""
    x, y, w, h = mask_bbox(mask)
    y_max = min(img.shape[0], y + h + int(h * 0.05))
    y = max(0, y - int(h * 0.05))
    return img[y:y_max, x:x + w]


def pad_img(img: np.ndarray, color=(255, 255, 255)):
    """Pad to a square whose side is the next multiple of 16. Returns
    (padded, (top, bottom, left, right))."""
    h, w = img.shape[:2]
    size = max(h, w)
    if size % 16 != 0:
        size = (size // 16) * 16 + 16
    top = (size - h) // 2
    bottom = size - h - top
    left = (size - w) // 2
    right = size - w - left
    out = np.empty((size, size) + img.shape[2:], dtype=img.dtype)
    out[...] = np.asarray(color, dtype=img.dtype)
    out[top:top + h, left:left + w] = img
    return out, (top, bottom, left, right)


def extract_mask_sdc(img: np.ndarray) -> np.ndarray:
    """Human mask from an sdc frame: gray > 10."""
    gray = (0.299 * img[..., 0] + 0.587 * img[..., 1]
            + 0.114 * img[..., 2])
    return np.where(gray > 10, np.uint8(255), np.uint8(0))


def clean_mask(mask: np.ndarray) -> np.ndarray:
    """Morphological close(5x5) + open(2x2); identity without OpenCV."""
    if cv2 is None:
        return mask
    se1 = cv2.getStructuringElement(cv2.MORPH_RECT, (5, 5))
    se2 = cv2.getStructuringElement(cv2.MORPH_RECT, (2, 2))
    mask = cv2.morphologyEx(mask, cv2.MORPH_CLOSE, se1)
    return cv2.morphologyEx(mask, cv2.MORPH_OPEN, se2)


def crop_bbox_sdc(img: np.ndarray,
                  mask: np.ndarray) -> Tuple[int, int, int, int]:
    """(y, y_max, x, x_max) mask bbox padded 10% vertically / 5%
    horizontally."""
    x, y, w, h = mask_bbox(mask)
    y_max = min(img.shape[0], y + h + int(h * 0.1))
    y = max(0, y - int(h * 0.1))
    x_max = min(img.shape[1], x + w + int(w * 0.05))
    x = max(0, x - int(w * 0.05))
    return y, y_max, x, x_max


def bbox_div2(x, x_max, y, y_max):
    """Make width/height even."""
    if (y_max - y) % 2 == 1:
        y_max += 1
    if (x_max - x) % 2 == 1:
        x_max += 1
    return x, x_max, y, y_max


def crop_human(pose_frames: Sequence[np.ndarray],
               *other_streams: Sequence[np.ndarray]):
    """Union bbox over all sdc frames, crop every stream to it. Returns
    (cropped_pose, *cropped_streams, bbox)."""
    y, y_max, x, x_max = 10 ** 9, 0, 10 ** 9, 0
    for frame in pose_frames:
        mask = extract_mask_sdc(frame)
        y_, ym_, x_, xm_ = crop_bbox_sdc(frame, mask)
        y, y_max = min(y, y_), max(y_max, ym_)
        x, x_max = min(x, x_), max(x_max, xm_)
    x, x_max, y, y_max = bbox_div2(x, x_max, y, y_max)
    out = [[f[y:y_max, x:x_max] for f in pose_frames]]
    for stream in other_streams:
        out.append([f[y:y_max, x:x_max] for f in stream])
    return (*out, (x, x_max, y, y_max))


def init_bk(n_frames: int, h: int, w: int) -> List[np.ndarray]:
    """White background frames."""
    return [np.full((h, w, 3), 255, np.uint8) for _ in range(n_frames)]


def resize_frame(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """Resize an (H, W, C) uint8 frame to (h, w): cv2 INTER_AREA when
    shrinking, INTER_LINEAR otherwise; the torch equivalents without cv2."""
    shrink = w < img.shape[1]
    if cv2 is not None:
        interp = cv2.INTER_AREA if shrink else cv2.INTER_LINEAR
        return cv2.resize(img, (w, h), interpolation=interp)
    x = torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1)[None]
    if shrink:
        y = F.interpolate(x.float(), size=(h, w), mode="area")
    else:
        y = F.interpolate(x.float(), size=(h, w), mode="bilinear",
                          align_corners=False)
    y = y[0].permute(1, 2, 0).round().clamp(0, 255)
    return y.to(torch.uint8).numpy()
