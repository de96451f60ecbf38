"""Frame utilities of the animate and edit paths: crops, pads, ROI shot
windows, feather masks, resizes.

The numpy functions are copies of those of ``mimo_tpu/utils/frames.py``; that
module cannot be imported where there is no JAX (importing any ``mimo_tpu``
module imports ``jax``). ``tests/test_torch_frames.py`` and
``tests/test_torch_edit.py`` hold each copy to its original.

The entries do the same work on a clip's frames as batched tensor ops on
the Runner's device (the functions at the end: ``upload_frames``,
``sdc_masks``, ``sdc_rects``, ``pad_frames``, ``resize_frames``,
``to_unit``): the frames go to the device once as uint8, and only integer
bookkeeping (boxes, the shot split, pad offsets) comes back to the host.
The numpy functions are their oracle: ``tests/test_torch_frames_device.py``
holds each to them in every bit.

The resizes are OpenCV's, with or without it: ``cv_resize`` works out
``cv2.resize``'s INTER_AREA and INTER_LINEAR for uint8 frames as OpenCV
does (its tables, its float32 order, its fixed-point rounding), equal in
every bit, on any device; ``resize_frame`` and ``pose_adjust`` call OpenCV
where it imports and ``cv_resize`` where not (the originals fell back to
nearest-neighbour sampling). ``clean_mask`` computes OpenCV's morphology
without it (``ops/morphology.py``). ``resize_linear`` is the perception
models' resize (OpenCV's default INTER_LINEAR at any scale), on the card
through ``F.interpolate`` where OpenCV does not import.
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
    return sdc_box(mask_bbox(mask), img.shape)


def sdc_box(rect: Tuple[int, int, int, int],
            shape) -> Tuple[int, int, int, int]:
    """``crop_bbox_sdc`` from the mask's (x, y, w, h) and the frame's
    shape."""
    x, y, w, h = rect
    y_max = min(shape[0], y + h + int(h * 0.1))
    y = max(0, y - int(h * 0.1))
    x_max = min(shape[1], x + w + int(w * 0.05))
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


def union_box(boxes) -> BBox:
    """``crop_human``'s crop: the union of the frames' (y, y_max, x, x_max)
    sdc boxes, made even, as (x, x_max, y, y_max)."""
    y, y_max, x, x_max = 10 ** 9, 0, 10 ** 9, 0
    for y_, ym_, x_, xm_ in boxes:
        y, y_max = min(y, y_), max(y_max, ym_)
        x, x_max = min(x, x_), max(x_max, xm_)
    return bbox_div2(x, x_max, y, y_max)


def crop_human(pose_frames: Sequence[np.ndarray],
               *other_streams: Sequence[np.ndarray]):
    """Union bbox over all sdc frames, crop every stream to it. Returns
    (cropped_pose, *cropped_streams, bbox)."""
    x, x_max, y, y_max = union_box(
        crop_bbox_sdc(f, extract_mask_sdc(f)) for f in pose_frames)
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
    bbox_clip, context_list, bbox_clip_list = roi_shots(
        [roi_box(mask_bbox(clean_mask(extract_mask_sdc(f))), f.shape)
         for f in pose_frames], overlay, roi_threshold)
    pose_out, vid_out, bk_out = [], [], []
    for k, context in enumerate(context_list):
        bx, bxm, by, bym = shot_box(bbox_clip_list[k],
                                    pose_frames[context[0]].shape)
        for i in context:
            pose_out.append(pose_frames[i][by:bym, bx:bxm])
            vid_out.append(vid_frames[i][by:bym, bx:bxm])
            bk_out.append(bk_frames[i][by:bym, bx:bxm])

    return pose_out, vid_out, bk_out, bbox_clip, context_list, bbox_clip_list


def roi_box(rect: Tuple[int, int, int, int], shape) -> BBox:
    """A frame's own box in the shot split, (x, x_max, y, y_max): the sdc
    box of the mask's (x, y, w, h), made even, then grown toward a
    16-multiple square within the frame."""
    y, y_max, x, x_max = sdc_box(rect, shape)
    return bbox_pad(*bbox_div2(x, x_max, y, y_max), shape)


def shot_box(bbox: BBox, shape) -> BBox:
    """The crop of a shot's bbox: the whole frame but its last row and
    column where the bbox is empty, as the original crops."""
    bx, bxm, by, bym = bbox
    if bx >= bxm or by >= bym:
        h, w = shape[:2]
        return 0, w - 1, 0, h - 1
    return bbox


def roi_shots(boxes: Sequence[BBox], overlay: int = 4,
              roi_threshold: float = 0.5):
    """``crop_human_clip_auto_context``'s decisions from each frame's
    ``roi_box``: (bbox_clip_per_frame, context_list, bbox_clip_list)."""
    n = len(boxes)
    areas = np.zeros(n)
    context_list: List[List[int]] = []
    bbox_clip_list: List[BBox] = []
    bbox_clip: List[Optional[BBox]] = [None] * n

    x, x_max, y, y_max = 10 ** 9, 0, 10 ** 9, 0
    start_idx = 0
    for i in range(n):
        x_, xm_, y_, ym_ = boxes[i]
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
    return bbox_clip, context_list, bbox_clip_list


def init_bk(n_frames: int, h: int, w: int) -> List[np.ndarray]:
    """White background frames."""
    return [np.full((h, w, 3), 255, np.uint8) for _ in range(n_frames)]


def pose_adjust(pose_img: np.ndarray, width: int = 512,
                height: int = 784) -> np.ndarray:
    """Resize-by-height (cv2 INTER_AREA; without OpenCV its arithmetic,
    ``cv_resize``), then center pad/crop to (height, width)."""
    h, w = pose_img.shape[:2]
    nh, nw = height, int(w * height / h)
    if cv2 is not None:
        resized = cv2.resize(pose_img, (nw, nh), interpolation=cv2.INTER_AREA)
    else:
        resized = cv_resize(torch.from_numpy(
            np.ascontiguousarray(pose_img))[None], nw, nh, area=True)[0]
        resized = resized.numpy()
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
    shrinking, INTER_LINEAR otherwise; without OpenCV its arithmetic
    (``resize_frames``), equal in every bit."""
    if cv2 is not None:
        interp = cv2.INTER_AREA if w < img.shape[1] else cv2.INTER_LINEAR
        return cv2.resize(img, (w, h), interpolation=interp)
    return resize_frames(torch.from_numpy(np.ascontiguousarray(img))[None],
                         w, h)[0].numpy()


# ---------------------------------------------------------------------------
# the same work on a batch of frames, on the frames' device
# ---------------------------------------------------------------------------


def upload_frames(frames: Sequence[np.ndarray], device) -> torch.Tensor:
    """Host frames of one shape as one (F, ...) tensor of their dtype on
    ``device``: each frame copied there once, as it is."""
    first = torch.from_numpy(np.asarray(frames[0]))
    out = torch.empty((len(frames),) + tuple(first.shape), dtype=first.dtype,
                      device=device)
    for dst, f in zip(out, frames):
        dst.copy_(torch.from_numpy(np.asarray(f)))
    return out


def _ends(hit: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """First and last True index along axis 1 of an (F, n) bool tensor."""
    n = hit.shape[1]
    hit = hit.to(torch.uint8)
    return hit.argmax(1), n - 1 - hit.flip(1).argmax(1)


def sdc_masks(sdc: torch.Tensor, clean: bool = False) -> torch.Tensor:
    """``extract_mask_sdc`` of each frame of an (F, H, W, 3) uint8 tensor,
    or ``clean_mask`` of it with ``clean``, as an (F, H, W) bool tensor on
    its device. The gray level is float64 in numpy's order, as
    ``extract_mask_sdc`` computes it, so the mask is its in every bit, on
    the threshold too; the clean-up is ``ops/morphology.py``'s, OpenCV's in
    every bit."""
    gray = sdc[..., 0].double().mul_(0.299)
    gray += sdc[..., 1].double().mul_(0.587)
    gray += sdc[..., 2].double().mul_(0.114)
    mask = gray > 10
    del gray
    if clean:
        mask = MO.open(MO.close(mask.to(torch.uint8), MO.rect(5, 5)),
                       MO.rect(2, 2)) > 0
    return mask


def sdc_rects(sdc: torch.Tensor, clean: bool = False,
              clock=None) -> List[Tuple[int, int, int, int]]:
    """``mask_bbox`` of each of ``sdc_masks``' masks, from its rows' and
    columns' reductions on the device: one copy of F x 4 integers comes
    back, counted in ``clock`` (a ``profiling.PhaseClock``) when given."""
    mask = sdc_masks(sdc, clean)
    rows, cols = mask.any(2), mask.any(1)
    (y0, y1), (x0, x1) = _ends(rows), _ends(cols)
    found = rows.any(1)
    rect = (torch.stack([x0, y0, x1 - x0 + 1, y1 - y0 + 1], 1)
            * found[:, None]).cpu()
    if clock is not None:
        clock.copied("d2h", rect.nbytes)
    return [tuple(r) for r in rect.tolist()]


def pad_frames(x: torch.Tensor, color=(255, 255, 255)):
    """``pad_img`` of each frame of an (N, h, w, C) tensor, on its device.
    Returns (padded, (top, bottom, left, right))."""
    h, w = x.shape[1:3]
    size = max(h, w)
    if size % 16 != 0:
        size = (size // 16) * 16 + 16
    top, left = (size - h) // 2, (size - w) // 2
    out = x.new_empty((x.shape[0], size, size) + tuple(x.shape[3:]))
    for c, v in enumerate(color):
        out[..., c] = v
    out[:, top:top + h, left:left + w] = x
    return out, (top, size - h - top, left, size - w - left)


def resize_frames(x: torch.Tensor, w: int, h: int) -> torch.Tensor:
    """``resize_frame`` of each frame of an (N, H, W, C) uint8 tensor, on its
    device: INTER_AREA when shrinking the width, else INTER_LINEAR, as
    ``cv_resize`` works them out, equal to ``cv2.resize`` in every bit."""
    return cv_resize(x, w, h, area=w < x.shape[2])


def cv_resize(x: torch.Tensor, w: int, h: int, area: bool) -> torch.Tensor:
    """``cv2.resize`` of each frame of an (N, H, W, C) uint8 tensor to
    (h, w) with INTER_AREA (``area``) or INTER_LINEAR, as OpenCV works it
    out for uint8, on the tensor's device. INTER_AREA shrinking both ways
    sums whole source cells where both scales are whole numbers
    (``resizeAreaFast``; INTER_LINEAR halving both ways too) and otherwise
    weighs the cells' overlaps in float32, in OpenCV's order
    (``resizeArea``); every other case takes two taps a direction with
    11-bit fixed-point weights (``HResizeLinear`` then ``VResizeLinear``'s
    vector rounding), INTER_AREA with the taps' area weights."""
    n, hi, wi, c = x.shape
    if (wi, hi) == (w, h):
        return x.clone()
    sx, sy = 1.0 / (w / wi), 1.0 / (h / hi)
    kx, ky = round(sx), round(sy)
    whole = abs(sx - kx) < _DBL_EPS and abs(sy - ky) < _DBL_EPS
    if whole and (kx, ky) == (2, 2):
        area = True      # OpenCV's INTER_LINEAR halving is its INTER_AREA
    if area and sx >= 1 and sy >= 1:
        if whole:
            s = x.int().reshape(n, h, ky, w, kx, c).sum((2, 4))
            if (kx, ky) == (2, 2):
                return ((s + 2) >> 2).to(torch.uint8)
            v = s.float() * float(np.float32(1.0) / np.float32(kx * ky))
            return v.round().clamp(0, 255).to(torch.uint8)
        return _area_taps(_area_taps(x.float(), w, 2), h, 1).round().clamp(
            0, 255).to(torch.uint8)
    ix, ax = (torch.from_numpy(a).to(x.device)
              for a in _linear_taps(wi, w, area, True))
    iy, ay = (torch.from_numpy(a).to(x.device)
              for a in _linear_taps(hi, h, area, False))
    v = x.int()
    rows = (v[:, :, ix[:, 0]] * ax[:, 0, None]
            + v[:, :, ix[:, 1]] * ax[:, 1, None]) >> 4
    out = (((rows[:, iy[:, 0]] * ay[:, 0, None, None]) >> 16)
           + ((rows[:, iy[:, 1]] * ay[:, 1, None, None]) >> 16) + 2) >> 2
    return out.clamp(0, 255).to(torch.uint8)


_DBL_EPS = float(np.finfo(np.float64).eps)


def _linear_taps(n_in: int, n_out: int, area: bool, across: bool):
    """OpenCV's two source indices and 11-bit weights of each destination
    index (``resizeGeneric``'s tables for INTER_LINEAR, or INTER_AREA's
    when it does not shrink both ways): (n_out, 2) int64 and int32. Across
    a row (``across``) a tap past the edge takes the edge pixel alone;
    down a column the weights stay and the rows are clamped."""
    inv = n_out / n_in
    scale = 1.0 / inv
    d = np.arange(n_out, dtype=np.float64)
    if area:
        s = np.floor(d * scale)
        f = ((d + 1) - (s + 1) * inv).astype(np.float32)
        f = np.where(f <= 0, np.float32(0), f - np.floor(f))
    else:
        f = ((d + 0.5) * scale - 0.5).astype(np.float32)
        s = np.floor(f)
        f = f - s.astype(np.float32)
    s = s.astype(np.int64)
    if across:
        edge = (s < 0) | (s >= n_in - 1)
        s = np.clip(s, 0, n_in - 1)
        f = np.where(edge, np.float32(0), f)
    idx = np.clip(np.stack([s, s + 1], 1), 0, n_in - 1)
    wts = np.rint(np.stack([np.float32(1) - f, f], 1) * np.float32(2048))
    return idx, wts.astype(np.int32)


def _area_taps(x: torch.Tensor, n_out: int, dim: int) -> torch.Tensor:
    """``resizeArea`` along ``dim`` of a float32 tensor: each destination
    index the sum, in source order, of its source cells times their float32
    overlap weights (``computeResizeAreaTab``'s table: a partial first
    cell, whole cells, a partial last cell; missing taps weigh 0, which
    adds exact zeros)."""
    n_in = x.shape[dim]
    scale = 1.0 / (n_out / n_in)
    f1 = np.arange(n_out, dtype=np.float64) * scale
    f2 = f1 + scale
    cell = np.minimum(scale, n_in - f1)
    s2 = np.minimum(np.floor(f2), n_in - 1).astype(np.int64)
    s1 = np.minimum(np.ceil(f1).astype(np.int64), s2)
    whole = int((s2 - s1).max())
    idx = np.zeros((n_out, whole + 2), np.int64)
    wts = np.zeros((n_out, whole + 2), np.float32)
    first = s1 - f1 > 1e-3
    idx[:, 0] = np.where(first, s1 - 1, 0)
    wts[:, 0] = np.where(first, (s1 - f1) / cell, 0)
    for j in range(whole):
        inside = s1 + j < s2
        idx[:, 1 + j] = np.where(inside, s1 + j, 0)
        wts[:, 1 + j] = np.where(inside, 1.0 / cell, 0)
    last = f2 - s2 > 1e-3
    idx[:, -1] = np.where(last, s2, 0)
    wts[:, -1] = np.where(
        last, np.minimum(np.minimum(f2 - s2, 1.0), cell) / cell, 0)
    idx = torch.from_numpy(idx).to(x.device)
    wts = torch.from_numpy(wts).to(x.device)
    shape = [1] * x.dim()
    shape[dim] = n_out
    out = x.index_select(dim, idx[:, 0]) * wts[:, 0].reshape(shape)
    for j in range(1, idx.shape[1]):
        out = out + x.index_select(dim, idx[:, j]) * wts[:, j].reshape(shape)
    return out


def to_unit(x: torch.Tensor) -> torch.Tensor:
    """uint8 to float32 in [0, 1], ``x / 255.0`` with numpy's true division:
    CUDA turns a division by a Python number into a product with its
    reciprocal, which differs in the last bit."""
    return x.float() / torch.full((), 255.0, device=x.device)
