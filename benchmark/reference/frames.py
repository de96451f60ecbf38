"""The host side of the animate and edit entries, in numpy: reference-image
matting and crop, the template's human crop or ROI shot split, square
padding, resizes, feather masks and the occlusion-aware paste-back.

A frozen copy of the plain paths the program's entries take
(``utils/frames.py``, ``entry/runner.py``, ``entry/edit.py`` of the
PyTorch port, which follow MIMO's ``run_animate.py`` / ``run_edit.py``),
so that the reference works out every crop, pad and shot again from the
raw inputs. Resizes are OpenCV's where it imports, else the same
area / bilinear resizes through ``torch.nn.functional.interpolate`` that
the program takes then.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

try:
    import cv2
except ImportError:  # the card's machine has no OpenCV
    cv2 = None

OVERLAY = 4   # frames two consecutive ROI shots share (run_edit.py)


# ---------------------------------------------------------------------------
# resizes and masks
# ---------------------------------------------------------------------------


def resize_frame(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """(H, W, C) uint8 to (h, w): area when shrinking, bilinear with
    half-pixel centres otherwise (OpenCV's INTER_AREA / INTER_LINEAR)."""
    if cv2 is not None:
        interp = cv2.INTER_AREA if w < img.shape[1] else cv2.INTER_LINEAR
        return cv2.resize(img, (w, h), interpolation=interp)
    x = torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1)[None]
    if w < img.shape[1]:
        y = F.interpolate(x.float(), size=(h, w), mode="area")
    else:
        y = F.interpolate(x.float(), size=(h, w), mode="bilinear",
                          align_corners=False)
    return y[0].permute(1, 2, 0).round().clamp(0, 255).to(
        torch.uint8).numpy()


def _morph(mask: np.ndarray, k: int, ops: str) -> np.ndarray:
    """OpenCV's binary morphology with a k×k rectangle anchored at
    (k // 2, k // 2); outside the image a pixel never wins. ``ops``: 'd'
    dilate, 'e' erode, in order."""
    x = torch.from_numpy(np.ascontiguousarray(mask)).float()[None, None]
    a = k // 2
    for op in ops:
        sign = 1.0 if op == "d" else -1.0
        xp = F.pad(sign * x, (a, k - 1 - a, a, k - 1 - a),
                   value=float("-inf"))
        x = sign * F.max_pool2d(xp, (k, k), stride=1)
    return x[0, 0].to(torch.uint8).numpy()


def clean_mask(mask: np.ndarray) -> np.ndarray:
    """Morphological close (5×5) then open (2×2)."""
    return _morph(_morph(mask, 5, "de"), 2, "ed")


def mask_bbox(mask: np.ndarray) -> Tuple[int, int, int, int]:
    """(x, y, w, h) of a mask's nonzero pixels."""
    ys, xs = np.nonzero(mask)
    if len(xs) == 0:
        return 0, 0, 0, 0
    x, y = int(xs.min()), int(ys.min())
    return x, y, int(xs.max()) - x + 1, int(ys.max()) - y + 1


def pad_img(img: np.ndarray, color) -> Tuple[np.ndarray, tuple]:
    """Centre on a square whose side is the next multiple of 16."""
    h, w = img.shape[:2]
    size = -(-max(h, w) // 16) * 16
    top, left = (size - h) // 2, (size - w) // 2
    out = np.empty((size, size) + img.shape[2:], dtype=img.dtype)
    out[...] = np.asarray(color, dtype=img.dtype)
    out[top:top + h, left:left + w] = img
    return out, (top, size - h - top, left, size - w - left)


# ---------------------------------------------------------------------------
# the reference image
# ---------------------------------------------------------------------------


def prep_reference_image(img: np.ndarray) -> np.ndarray:
    """Matte by distance from the border's median colour, crop to the
    person (5% more rows each way), pad to a white square."""
    border = np.concatenate([img[0].reshape(-1, 3), img[-1].reshape(-1, 3),
                             img[:, 0].reshape(-1, 3),
                             img[:, -1].reshape(-1, 3)], axis=0)
    bg = np.median(border.astype(np.float32), axis=0)
    dist = np.linalg.norm(img.astype(np.float32) - bg, axis=-1)
    mask = clean_mask((dist > 40).astype(np.uint8) * 255)
    seg = img.copy()
    seg[mask == 0] = 255
    if mask.any():
        x, y, w, h = mask_bbox(mask)
        y_max = min(seg.shape[0], y + h + int(h * 0.05))
        y = max(0, y - int(h * 0.05))
        seg = seg[y:y_max, x:x + w]
    return pad_img(seg, (255, 255, 255))[0]


# ---------------------------------------------------------------------------
# the template: human crop (animate) and ROI shots (edit)
# ---------------------------------------------------------------------------


def sdc_mask(img: np.ndarray) -> np.ndarray:
    gray = 0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]
    return np.where(gray > 10, np.uint8(255), np.uint8(0))


def _sdc_bbox(img: np.ndarray, mask: np.ndarray):
    """(y, y_max, x, x_max): the mask's box, 10% more rows and 5% more
    columns each way, within the frame."""
    x, y, w, h = mask_bbox(mask)
    return (max(0, y - int(h * 0.1)), min(img.shape[0], y + h + int(h * 0.1)),
            max(0, x - int(w * 0.05)), min(img.shape[1], x + w + int(w * 0.05)))


def _even(x, x_max, y, y_max):
    return x, x_max + (x_max - x) % 2, y, y_max + (y_max - y) % 2


def _square16(x, x_max, y, y_max, shape):
    h, w = y_max - y, x_max - x
    size = -(-max(h, w) // 16) * 16
    top, left = (size - h) // 2, (size - w) // 2
    return (max(0, x - left), min(shape[1], x_max + size - w - left),
            max(0, y - top), min(shape[0], y_max + size - h - top))


def crop_human(pose: Sequence[np.ndarray], bk: Sequence[np.ndarray]):
    """Both streams cropped to the union over frames of the sdc box."""
    y, y_max, x, x_max = 10 ** 9, 0, 10 ** 9, 0
    for f in pose:
        y_, ym_, x_, xm_ = _sdc_bbox(f, sdc_mask(f))
        y, y_max = min(y, y_), max(y_max, ym_)
        x, x_max = min(x, x_), max(x_max, xm_)
    x, x_max, y, y_max = _even(x, x_max, y, y_max)
    return ([f[y:y_max, x:x_max] for f in pose],
            [f[y:y_max, x:x_max] for f in bk])


def roi_shots(pose: Sequence[np.ndarray], roi_threshold: float = 0.5):
    """Split the clip into shots: a running union box grows until an
    earlier frame's own box falls under ``roi_threshold`` of its area;
    consecutive shots share OVERLAY frames. Returns (frame indices of each
    shot, the box (x, x_max, y, y_max) of each shot)."""
    n = len(pose)
    areas = np.zeros(n)
    shots: List[List[int]] = []
    boxes: List[tuple] = []
    x, x_max, y, y_max = 10 ** 9, 0, 10 ** 9, 0
    start = 0
    for i in range(n):
        f = pose[i]
        y_, ym_, x_, xm_ = _sdc_bbox(f, clean_mask(sdc_mask(f)))
        x_, xm_, y_, ym_ = _square16(*_even(x_, xm_, y_, ym_), f.shape)
        prev_union = (x, x_max, y, y_max)
        x, x_max = min(x, x_), max(x_max, xm_)
        y, y_max = min(y, y_), max(y_max, ym_)
        areas[i] = (xm_ - x_) * (ym_ - y_) / 100.0
        union_area = (x_max - x) * (y_max - y) / 100.0
        ratios = (areas[start:i] / union_area if union_area
                  else np.zeros(i - start))

        def close(box, end):
            lo = start - min(OVERLAY, len(shots[-1])) if shots else start
            shots.append(list(range(lo, end)))
            boxes.append(box)

        if i == n - 1:
            close((x, x_max, y, y_max), n)
        elif ratios.size and ratios.sum() != 0 and np.any(
                ratios < roi_threshold):
            close(prev_union, i)
            x, x_max, y, y_max = x_, xm_, y_, ym_
            start = i
    return shots, boxes


def shot_crops(frames: Sequence[np.ndarray], shots, boxes):
    """Each shot's frames cropped to its box (the whole frame for an empty
    box), in shot order."""
    out = []
    for shot, (bx, bxm, by, bym) in zip(shots, boxes):
        for i in shot:
            if bx >= bxm or by >= bym:
                h, w = frames[i].shape[:2]
                bx, bxm, by, bym = 0, w - 1, 0, h - 1
            out.append(frames[i][by:bym, bx:bxm])
    return out


# ---------------------------------------------------------------------------
# the paste-back of edit
# ---------------------------------------------------------------------------

_MODES = ("up_down_left_right", "left_right_up", "left_right_down",
          "up_down_left", "up_down_right", "left_right", "up_down", "left_up",
          "right_up", "left_down", "right_down", "left", "right", "up",
          "down")


def _ramp(n: int, feather: int, start: bool, end: bool) -> np.ndarray:
    v = np.ones(n, np.float32)
    f = min(feather, max(1, n // 4))
    ramp = np.linspace(0.0, 1.0, f, dtype=np.float32)
    if start:
        v[:f] = np.minimum(v[:f], ramp)
    if end:
        v[-f:] = np.minimum(v[-f:], ramp[::-1])
    return v


def feather_mask(box, frame_wh, crop_hw, feather: int = 32) -> np.ndarray:
    """Alpha of a pasted crop: ramps to 0 over ``feather`` pixels at the
    crop's edges inside the frame; the edges on the frame's border (the
    first of MIMO's 16 modes they all satisfy) stay at 1."""
    w, h = frame_wh
    x0, x1, y0, y1 = box
    touch = {"left": x0 <= 0, "right": x1 >= w, "up": y0 <= 0,
             "down": y1 >= h}
    sides = next((m.split("_") for m in _MODES
                  if all(touch[t] for t in m.split("_"))), [])
    rows = _ramp(crop_hw[0], feather, "up" not in sides, "down" not in sides)
    cols = _ramp(crop_hw[1], feather, "left" not in sides,
                 "right" not in sides)
    return np.minimum(rows[:, None], cols[None, :])


def composite_back(video: np.ndarray, shots, boxes, pad_info, bk, vid,
                   occ: Optional[Sequence[np.ndarray]]) -> List[np.ndarray]:
    """Each generated frame unpadded, placed at its shot's box, feathered
    onto the background, the source video put back under the occlusion
    mask, and shot overlaps cross-faded. video (F, H, W, 3) in [0, 1]."""
    res: List[Optional[np.ndarray]] = [None] * len(bk)
    k = 0
    for shot, box in zip(shots, boxes):
        for i in shot:
            back = bk[i].astype(np.float32)
            fh, fw = back.shape[:2]
            pad_h, pad_w, (top, bottom, left, right) = pad_info[k]
            frame = resize_frame((video[k] * 255).astype(np.uint8), pad_w,
                                 pad_h)[top:pad_h - bottom,
                                        left:pad_w - right]
            x0, _, y0, _ = box
            ch, cw = frame.shape[:2]
            canvas = np.full((fh, fw, 3), 255, np.float32)
            canvas[y0:y0 + ch, x0:x0 + cw] = frame
            alpha = np.zeros((fh, fw), np.float32)
            alpha[y0:y0 + ch, x0:x0 + cw] = feather_mask(box, (fw, fh),
                                                         (ch, cw))
            out = canvas * alpha[..., None] + back * (1 - alpha[..., None])
            if occ is not None:
                o = occ[i][..., 0].astype(np.float32)[..., None] / 255.0
                out = out * (1 - o) + vid[i].astype(np.float32) * o
            if res[i] is None:
                res[i] = out
            else:
                t = (i - shot[0] + 1) / (OVERLAY + 1)
                res[i] = res[i] * (1 - t) + out * t
            k += 1
    return [np.clip(r, 0, 255).astype(np.uint8) for r in res
            if r is not None]
