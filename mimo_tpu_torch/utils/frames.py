"""Host-side frame utilities of the animate and edit paths (numpy, cv2
optional): crops, pads, ROI shot windows, feather masks.

Copies of the functions of ``mimo_tpu/utils/frames.py``; that module cannot
be imported where there is no JAX (importing any ``mimo_tpu`` module imports
``jax``). ``tests/test_torch_frames.py`` and ``tests/test_torch_edit.py``
hold each copy to its original.

Without OpenCV the resizes differ: ``resize_frame`` and ``pose_adjust``
resize with ``torch.nn.functional.interpolate`` (area when shrinking,
bilinear with half-pixel centres when growing, the two cv2 modes
``resize_frame``'s original picks), where the originals fell back to
nearest-neighbour sampling. ``clean_mask`` computes OpenCV's morphology
without it (``ops/morphology.py``). With OpenCV every function computes what
its original does. ``resize_linear`` is the perception models' resize (OpenCV's
default INTER_LINEAR at any scale), on the card without OpenCV.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mimo_tpu_torch.ops import morphology as MO

try:
    import cv2
except ImportError:  # pragma: no cover - depends on the machine
    cv2 = None

BBox = Tuple[int, int, int, int]  # (x, x_max, y, y_max)


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
    """Morphological close(5x5) + open(2x2); without OpenCV through
    ``ops/morphology.py``, equal in every bit."""
    if cv2 is None:
        return MO.open(MO.close(mask, MO.rect(5, 5)), MO.rect(2, 2))
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


def bbox_pad(x, x_max, y, y_max, shape) -> BBox:
    """Expand the bbox toward a 16-multiple square, clamped to the frame."""
    h, w = y_max - y, x_max - x
    size = max(h, w)
    if size % 16 != 0:
        size = (size // 16) * 16 + 16
    top = (size - h) // 2
    bottom = size - h - top
    left = (size - w) // 2
    right = size - w - left
    return (max(0, x - left), min(shape[1], x_max + right),
            max(0, y - top), min(shape[0], y_max + bottom))


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


def crop_human_clip_auto_context(
    pose_frames: Sequence[np.ndarray], vid_frames: Sequence[np.ndarray],
    bk_frames: Sequence[np.ndarray], overlay: int = 4,
    roi_threshold: float = 0.5,
):
    """Split the clip into ROI 'shots': a running union bbox grows until some
    earlier frame's own bbox falls below ``roi_threshold`` of the union
    area, then a new shot starts; consecutive shots share ``overlay`` frames
    for cross-fading.

    Returns (pose_crops, vid_crops, bk_crops, bbox_clip_per_frame,
    context_list, bbox_clip_list)."""
    n = len(pose_frames)
    areas = np.zeros(n)
    context_list: List[List[int]] = []
    bbox_clip_list: List[BBox] = []
    bbox_clip: List[Optional[BBox]] = [None] * n

    x, x_max, y, y_max = 10 ** 9, 0, 10 ** 9, 0
    start_idx = 0
    for i in range(n):
        frame = pose_frames[i]
        mask = clean_mask(extract_mask_sdc(frame))
        y_, ym_, x_, xm_ = crop_bbox_sdc(frame, mask)
        x_, xm_, y_, ym_ = bbox_div2(x_, xm_, y_, ym_)
        x_, xm_, y_, ym_ = bbox_pad(x_, xm_, y_, ym_, frame.shape)
        prev_union = (x, x_max, y, y_max)
        x, x_max = min(x, x_), max(x_max, xm_)
        y, y_max = min(y, y_), max(y_max, ym_)
        cur_union = (x, x_max, y, y_max)
        cur = (x_, xm_, y_, ym_)
        areas[i] = (xm_ - x_) * (ym_ - y_) / 100.0
        union_area = (x_max - x) * (y_max - y) / 100.0
        ratios = (areas[start_idx:i] / union_area if union_area
                  else np.zeros(i - start_idx))

        def close_shot(bbox_for_shot, end):
            if context_list:
                ov = min(overlay, len(context_list[-1]))
                context_list.append(list(range(start_idx - ov, end)))
            else:
                context_list.append(list(range(start_idx, end)))
            bbox_clip_list.append(bbox_for_shot)
            for j in range(start_idx, end):
                bbox_clip[j] = bbox_for_shot

        if i == n - 1:
            close_shot(cur_union, n)
        elif ratios.size and ratios.sum() != 0 and np.any(
                ratios < roi_threshold):
            close_shot(prev_union, i)
            x, x_max, y, y_max = cur
            start_idx = i

    pose_out, vid_out, bk_out = [], [], []
    for k, context in enumerate(context_list):
        bx, bxm, by, bym = bbox_clip_list[k]
        for i in context:
            if bx >= bxm or by >= bym:
                h, w = pose_frames[i].shape[:2]
                bx, bxm, by, bym = 0, w - 1, 0, h - 1
            pose_out.append(pose_frames[i][by:bym, bx:bxm])
            vid_out.append(vid_frames[i][by:bym, bx:bxm])
            bk_out.append(bk_frames[i][by:bym, bx:bxm])

    return pose_out, vid_out, bk_out, bbox_clip, context_list, bbox_clip_list


def init_bk(n_frames: int, h: int, w: int) -> List[np.ndarray]:
    """White background frames."""
    return [np.full((h, w, 3), 255, np.uint8) for _ in range(n_frames)]


def pose_adjust(pose_img: np.ndarray, width: int = 512,
                height: int = 784) -> np.ndarray:
    """Resize-by-height (cv2 INTER_AREA; without OpenCV as
    ``resize_frame`` does), then center pad/crop to (height, width)."""
    h, w = pose_img.shape[:2]
    nh, nw = height, int(w * height / h)
    if cv2 is not None:
        resized = cv2.resize(pose_img, (nw, nh), interpolation=cv2.INTER_AREA)
    else:
        resized = _resize_torch(pose_img, nw, nh)
    canvas = np.zeros((height, width, 3), np.uint8)
    if nw < width:
        pad = (width - nw) // 2
        canvas[:, pad:pad + nw] = resized
    else:
        crop = (nw - width) // 2
        canvas = resized[:, crop:crop + width]
    return canvas


# ---------------------------------------------------------------------------
# feather masks (16 modes)
# ---------------------------------------------------------------------------

MASK_MODES = (
    "up_down_left_right", "left_right_up", "left_right_down", "up_down_left",
    "up_down_right", "left_right", "up_down", "left_up", "right_up",
    "left_down", "right_down", "left", "right", "up", "down", "inner",
)


def _ramp(n: int, feather: int, start: bool, end: bool) -> np.ndarray:
    v = np.ones(n, np.float32)
    f = min(feather, max(1, n // 4))
    ramp = np.linspace(0.0, 1.0, f, dtype=np.float32)
    if start:
        v[:f] = np.minimum(v[:f], ramp)
    if end:
        v[-f:] = np.minimum(v[-f:], ramp[::-1])
    return v


def make_feather_mask(shape: Tuple[int, int], mode: str,
                      feather: int = 32) -> np.ndarray:
    """The feather mask of a pasted crop of ``shape`` (h, w): alpha ramps to
    0 at crop edges interior to the frame; the edges the mode names (they
    touch the frame border) stay at 1; 'inner' touches none."""
    h, w = shape
    tokens = mode.split("_") if mode != "inner" else []
    rows = _ramp(h, feather, start="up" not in tokens,
                 end="down" not in tokens)
    cols = _ramp(w, feather, start="left" not in tokens,
                 end="right" not in tokens)
    return np.minimum(rows[:, None], cols[None, :])


def get_mask_mode(bbox: BBox, frame_size: Tuple[int, int]) -> str:
    """Which feather mode applies for a paste bbox; frame_size (w, h)."""
    w, h = frame_size
    w_min, w_max, h_min, h_max = bbox
    touch = {"left": w_min <= 0, "right": w_max >= w, "up": h_min <= 0,
             "down": h_max >= h}
    for mode in MASK_MODES[:-1]:
        sides = mode.split("_")
        if all(touch[t] for t in sides):
            return mode
    return "inner"


def get_feather_mask(bbox: BBox, frame_size: Tuple[int, int],
                     crop_size: Tuple[int, int],
                     feather: int = 32) -> np.ndarray:
    """Feather mask of the mode of ``bbox`` at the pasted crop's size;
    crop_size (h, w)."""
    return make_feather_mask(crop_size, get_mask_mode(bbox, frame_size),
                             feather)


def _resize_torch(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """(H, W, C) uint8 to (h, w): area when shrinking, bilinear with
    half-pixel centres otherwise, rounded to uint8."""
    x = torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1)[None]
    if w < img.shape[1]:
        y = F.interpolate(x.float(), size=(h, w), mode="area")
    else:
        y = F.interpolate(x.float(), size=(h, w), mode="bilinear",
                          align_corners=False)
    y = y[0].permute(1, 2, 0).round().clamp(0, 255)
    return y.to(torch.uint8).numpy()


def resize_linear(img: np.ndarray, w: int, h: int,
                  device=None) -> torch.Tensor:
    """An (H, W, C) uint8 frame resized to (h, w) with OpenCV's INTER_LINEAR
    semantics (bilinear, half-pixel centres, no antialiasing when
    shrinking), as a uint8 tensor on ``device``: ``cv2.resize`` on the host
    where OpenCV exists; else the frame is uploaded once and resized there
    by ``F.interpolate`` and rounded (within one level of OpenCV's
    fixed-point result). The perception models' resize (SAM, SAM2)."""
    if cv2 is not None:
        out = cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)
        return torch.from_numpy(out).to(device)
    x = torch.from_numpy(np.ascontiguousarray(img)).to(device)
    y = F.interpolate(x.permute(2, 0, 1)[None].float(), size=(h, w),
                      mode="bilinear", align_corners=False, antialias=False)
    return y[0].permute(1, 2, 0).round().clamp(0, 255).to(torch.uint8)


def resize_frame(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """Resize an (H, W, C) uint8 frame to (h, w): cv2 INTER_AREA when
    shrinking, INTER_LINEAR otherwise; the torch equivalents without cv2."""
    if cv2 is not None:
        interp = cv2.INTER_AREA if w < img.shape[1] else cv2.INTER_LINEAR
        return cv2.resize(img, (w, h), interpolation=interp)
    return _resize_torch(img, w, h)
