"""Reference-image human matting.

Counterpart of ``mimo_tpu/decomp/matting.py``: SAM-based matting (a box
prompt -> the best mask -> a feathered alpha) and the border-statistics
heuristic as the zero-weight fallback, both returning (rgba uint8, person
found). The feather is OpenCV's ``GaussianBlur(mask, (7, 7), 0)`` in torch:
its fixed 7-tap kernel, edges reflected without repeating the border
pixel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mimo_tpu_torch.utils import frames as FU


def heuristic_matting(img: np.ndarray,
                      bg_dist_thresh: float = 40.0) -> Tuple[np.ndarray, bool]:
    """Foreground = pixels far from the border's median colour."""
    border = np.concatenate([
        img[0].reshape(-1, 3), img[-1].reshape(-1, 3),
        img[:, 0].reshape(-1, 3), img[:, -1].reshape(-1, 3)], axis=0)
    bg = np.median(border.astype(np.float32), axis=0)
    dist = np.linalg.norm(img.astype(np.float32) - bg, axis=-1)
    mask = FU.clean_mask((dist > bg_dist_thresh).astype(np.uint8) * 255)
    return np.dstack([img, _feather(mask)]), bool(mask.mean() > 2.0)


def sam_matting(img: np.ndarray, predictor,
                box: Optional[np.ndarray] = None) -> Tuple[np.ndarray, bool]:
    """Prompt ``predictor`` (``decomp.sam.SamPredictor``) with ``box`` (or
    the central region) and feather its best multimask output."""
    h, w = img.shape[:2]
    if box is None:
        box = np.array([w * 0.1, h * 0.05, w * 0.9, h * 0.98])
    predictor.set_image(img)
    masks, iou = predictor.predict(box=box)
    best = int(np.argmax(iou[1:])) + 1 if len(iou) > 1 else 0
    mask = masks[best].astype(np.uint8) * 255
    return np.dstack([img, _feather(mask)]), bool(mask.mean() > 2.0)


# OpenCV's fixed Gaussian kernels for sizes up to 7 with sigma 0
_SMALL_TAPS = {1: [1.0], 3: [0.25, 0.5, 0.25],
               5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
               7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375,
                   0.03125]}


def _gaussian_taps(radius: int) -> torch.Tensor:
    k = 2 * radius + 1
    if k in _SMALL_TAPS:
        return torch.tensor(_SMALL_TAPS[k], dtype=torch.float64)
    sigma = 0.3 * ((k - 1) * 0.5 - 1) + 0.8        # OpenCV's sigma for k
    x = torch.arange(k, dtype=torch.float64) - radius
    g = torch.exp(-x * x / (2 * sigma * sigma))
    return g / g.sum()


def _feather(mask255: np.ndarray, radius: int = 3) -> np.ndarray:
    """Separable Gaussian blur of a uint8 mask, rounded to uint8."""
    taps = _gaussian_taps(radius)
    x = torch.from_numpy(mask255.astype(np.float64))[None, None]
    x = F.pad(x, (radius, radius, radius, radius), mode="reflect")
    x = F.conv2d(x, taps.view(1, 1, 1, -1))
    x = F.conv2d(x, taps.view(1, 1, -1, 1))
    return x[0, 0].round().clamp(0, 255).to(torch.uint8).numpy()


def composite_on_white(rgba: np.ndarray) -> np.ndarray:
    """RGBA -> RGB over white."""
    a = rgba[..., 3:4].astype(np.float32) / 255.0
    out = rgba[..., :3].astype(np.float32) * a + 255.0 * (1 - a)
    return out.astype(np.uint8)
