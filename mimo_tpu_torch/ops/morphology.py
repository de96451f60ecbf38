"""OpenCV's binary-mask morphology, gray conversion and 8-connected component
count, equal to OpenCV in every bit, without OpenCV.

The card's machine has no OpenCV, and the decomposition half's mask clean-up
(``utils/frames.clean_mask``, ``decomp/occlusion.py``, the background
stage's dilation) is built on these calls. OpenCV's conventions, which the
functions here keep:

- a structuring element of size (kh, kw) is anchored at (kh // 2, kw // 2),
  and both erode and dilate read the window at offsets ``row - anchor``
  over the element's ones: the element is not reflected for the dilation,
  so a 2x2 opening is not symmetric;
- outside the image, pixels count as the type's maximum for an erosion and
  its minimum for a dilation (``morphologyDefaultBorderValue``): the border
  never wins;
- ``morphologyEx`` close is dilate then erode, open is erode then dilate.

Each function takes a numpy array (computed on the host, returned as numpy)
or a tensor (computed on its device, returned as a tensor) of shape
(H, W) or (N, H, W). A rectangle goes through ``max_pool2d``; any other
element through the max over its shifted copies.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch
import torch.nn.functional as F

Array = Union[np.ndarray, torch.Tensor]


def rect(kh: int, kw: int) -> np.ndarray:
    """``cv2.getStructuringElement(MORPH_RECT, (kw, kh))``."""
    return np.ones((kh, kw), np.uint8)


# cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (5, 5))
ELLIPSE_5 = np.array([[0, 0, 1, 0, 0],
                      [1, 1, 1, 1, 1],
                      [1, 1, 1, 1, 1],
                      [1, 1, 1, 1, 1],
                      [0, 0, 1, 0, 0]], np.uint8)


def _max_filter(x: torch.Tensor, element: np.ndarray,
                fill: float) -> torch.Tensor:
    """x: (N, H, W) float; max over the window ``x[y + i - ay, x + j - ax]``
    of the element's ones, ``fill`` outside the image."""
    kh, kw = element.shape
    ay, ax = kh // 2, kw // 2
    xp = F.pad(x[:, None], (ax, kw - 1 - ax, ay, kh - 1 - ay), value=fill)
    if element.all():
        return F.max_pool2d(xp, (kh, kw), stride=1)[:, 0]
    h, w = x.shape[1:]
    out = None
    for i, j in zip(*np.nonzero(element)):
        s = xp[:, 0, i:i + h, j:j + w]
        out = s if out is None else torch.maximum(out, s)
    return out


def _apply(mask: Array, element: np.ndarray, ops: str) -> Array:
    """``ops``: a string of 'e' (erode) and 'd' (dilate), applied in order."""
    is_np = isinstance(mask, np.ndarray)
    t = torch.from_numpy(np.ascontiguousarray(mask)) if is_np else mask
    dtype = t.dtype
    x = t.float()
    squeeze = x.dim() == 2
    if squeeze:
        x = x[None]
    for op in ops:
        if op == "d":
            x = _max_filter(x, element, float("-inf"))
        else:
            x = -_max_filter(-x, element, float("-inf"))
    if squeeze:
        x = x[0]
    out = x.to(dtype)
    return out.numpy() if is_np else out


def dilate(mask: Array, element: np.ndarray) -> Array:
    """``cv2.dilate(mask, element)``."""
    return _apply(mask, element, "d")


def erode(mask: Array, element: np.ndarray) -> Array:
    """``cv2.erode(mask, element)``."""
    return _apply(mask, element, "e")


def close(mask: Array, element: np.ndarray) -> Array:
    """``cv2.morphologyEx(mask, cv2.MORPH_CLOSE, element)``."""
    return _apply(mask, element, "de")


def open(mask: Array, element: np.ndarray) -> Array:  # noqa: A001
    """``cv2.morphologyEx(mask, cv2.MORPH_OPEN, element)``."""
    return _apply(mask, element, "ed")


def rgb_to_gray(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)`` of a uint8 (..., 3) image:
    OpenCV's fixed-point weights (15 fractional bits), rounded."""
    r, g, b = (img[..., c].astype(np.int32) for c in range(3))
    return ((9798 * r + 19235 * g + 3735 * b + 16384) >> 15).astype(np.uint8)


def count_components_8(mask: np.ndarray) -> int:
    """Foreground components of a mask, 8-connected:
    ``cv2.connectedComponentsWithStats(mask, connectivity=8)[0] - 1``."""
    from scipy import ndimage
    _, n = ndimage.label(np.asarray(mask) > 0,
                         structure=np.ones((3, 3), np.int32))
    return int(n)
