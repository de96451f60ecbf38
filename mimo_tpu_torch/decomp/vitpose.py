"""ViTPose top-down wholebody pose: ViT backbone + deconv heatmap head.

Counterpart of ``mimo_tpu/decomp/vitpose.py``: ViT-huge (1280 wide, 32
deep, patch 16, input 256x192, patch padding 4), two deconvs (k4 s2 p1) to
256 channels with BatchNorm + ReLU, a 1x1 conv to 133 COCO-wholebody
heatmaps, the flip test, the argmax + quarter-pixel decode and the hand
boxes. ``square_crop`` is the port's copy of ``mimo_tpu/decomp/hmr.py``'s
(the person crop the pose model reads), resizing with torch.

On the track path it scores SAM's person proposals (``detector.py``) and
rejects half bodies (``pipeline.get_first_mask``); the pose stage runs it
over the clip (``estimate_pose_batch``), and the motion stage finds the
hands with it (``motion.py``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mimo_tpu_torch.decomp.vit import ViTConfig, tokens_to_grid, vit_apply, \
    vit_init
from mimo_tpu_torch.models import layers as L

Params = Dict[str, Any]

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


@dataclass(frozen=True)
class ViTPoseConfig:
    backbone: ViTConfig = field(default_factory=lambda: ViTConfig(
        img_size=(256, 192), patch_size=16, dim=1280, depth=32,
        num_heads=16, use_cls_token=False, patch_padding=4,
        cls_pos_to_all=True))
    num_keypoints: int = 133
    deconv_channels: int = 256
    num_deconv: int = 2
    flip_test: bool = True


def tiny_vitpose_config() -> ViTPoseConfig:
    return ViTPoseConfig(
        backbone=ViTConfig(img_size=(64, 48), patch_size=16, dim=32,
                           depth=2, num_heads=4, use_cls_token=False,
                           patch_padding=4, cls_pos_to_all=True),
        num_keypoints=7, deconv_channels=16)


def deconv_init(gen: torch.Generator, c_in: int, c_out: int, k: int,
                dtype: torch.dtype) -> Params:
    """A transposed conv in ``F.conv_transpose2d``'s (in, out, kh, kw)
    layout (the bridge's layout of the JAX package's flipped HWIO)."""
    bound = 1.0 / math.sqrt(c_in * k * k)
    w = torch.rand((c_in, c_out, k, k), generator=gen, device=gen.device)
    return {"kernel": (w * (2 * bound) - bound).to(dtype),
            "bias": torch.zeros((c_out,), dtype=dtype, device=gen.device)}


def deconv2d(p: Params, x: torch.Tensor, stride: int,
             padding: int) -> torch.Tensor:
    """(N, H, W, C) transposed conv -> (N, H', W', C_out)."""
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), p["kernel"].to(x.dtype),
                           p["bias"].to(x.dtype), stride=stride,
                           padding=padding)
    return y.permute(0, 2, 3, 1).contiguous()


def vitpose_init(gen: torch.Generator, cfg: ViTPoseConfig,
                 dtype: torch.dtype = torch.float32) -> Params:
    p: Params = {"backbone": vit_init(gen, cfg.backbone, dtype)}
    c_in, c = cfg.backbone.dim, cfg.deconv_channels
    dev = gen.device
    deconvs = []
    for _ in range(cfg.num_deconv):
        deconvs.append({
            "deconv": deconv_init(gen, c_in, c, 4, dtype),
            "bn_scale": torch.ones((c,), dtype=dtype, device=dev),
            "bn_bias": torch.zeros((c,), dtype=dtype, device=dev),
            "bn_mean": torch.zeros((c,), dtype=dtype, device=dev),
            "bn_var": torch.ones((c,), dtype=dtype, device=dev),
        })
        c_in = c
    p["deconvs"] = deconvs
    p["final"] = L.conv2d_init(gen, 1, 1, c_in, cfg.num_keypoints,
                               dtype=dtype)
    return p


def _bn(blk: Params, x: torch.Tensor) -> torch.Tensor:
    inv = torch.rsqrt(blk["bn_var"].float() + 1e-5)
    y = (x.float() - blk["bn_mean"].float()) * inv
    y = y * blk["bn_scale"].float() + blk["bn_bias"].float()
    return y.to(x.dtype)


def heatmaps(p: Params, cfg: ViTPoseConfig,
             crops: torch.Tensor) -> torch.Tensor:
    """crops: (B, 256, 192, 3) ImageNet-normalised -> (B, 64, 48, K)."""
    gh, gw = cfg.backbone.grid
    x = tokens_to_grid(vit_apply(p["backbone"], cfg.backbone, crops),
                       cfg.backbone, gh, gw)
    for blk in p["deconvs"]:
        x = torch.relu(_bn(blk, deconv2d(blk["deconv"], x, 2, 1)))
    return L.conv2d(p["final"], x, padding=0)


# COCO-wholebody mirrored keypoint pairs: body 8, feet 3, face 29, hands 21
COCO_WHOLEBODY_FLIP_PAIRS = [
    (1, 2), (3, 4), (5, 6), (7, 8), (9, 10), (11, 12), (13, 14), (15, 16),
    (17, 20), (18, 21), (19, 22),
    (23, 39), (24, 38), (25, 37), (26, 36), (27, 35), (28, 34), (29, 33),
    (30, 32), (40, 49), (41, 48), (42, 47), (43, 46), (44, 45), (54, 58),
    (55, 57), (59, 68), (60, 67), (61, 66), (62, 65), (63, 70), (64, 69),
    (71, 77), (72, 76), (73, 75), (78, 82), (79, 81), (83, 87), (84, 86),
    (88, 90),
    (91, 112), (92, 113), (93, 114), (94, 115), (95, 116), (96, 117),
    (97, 118), (98, 119), (99, 120), (100, 121), (101, 122), (102, 123),
    (103, 124), (104, 125), (105, 126), (106, 127), (107, 128), (108, 129),
    (109, 130), (110, 131), (111, 132),
]


def _flip_perm(num_keypoints: int, flip_pairs) -> np.ndarray:
    perm = np.arange(num_keypoints)
    for a, b in flip_pairs:
        perm[a], perm[b] = b, a
    return perm


def heatmaps_flip_test(p: Params, cfg: ViTPoseConfig, crops: torch.Tensor,
                       flip_pairs=None) -> torch.Tensor:
    """Flip-test averaging: the mirrored crop rides one doubled batch, its
    heatmaps get the mirrored channels swapped, are un-flipped, shifted one
    pixel right and averaged with the direct ones."""
    if flip_pairs is None:
        flip_pairs = [pr for pr in COCO_WHOLEBODY_FLIP_PAIRS
                      if pr[1] < cfg.num_keypoints]
    if not cfg.flip_test:
        return heatmaps(p, cfg, crops)
    b = crops.shape[0]
    hm2 = heatmaps(p, cfg, torch.cat([crops, crops.flip(2)], dim=0))
    hm, hm_f = hm2[:b], hm2[b:]
    perm = torch.as_tensor(_flip_perm(cfg.num_keypoints, flip_pairs),
                           device=hm.device)
    hm_f = hm_f.index_select(3, perm).flip(2)
    hm_f = torch.cat([hm_f[:, :, :1], hm_f[:, :, :-1]], dim=2)
    return (hm + hm_f) * 0.5


def decode_keypoints(hm: np.ndarray, boxes_xywh: np.ndarray) -> np.ndarray:
    """Per-keypoint argmax + 0.25 px toward the higher neighbour, mapped to
    image coordinates. hm: (B, h, w, K); boxes (B, 4) xywh. -> (B, K, 3)."""
    b, hh, ww, k = hm.shape
    flat = hm.reshape(b, hh * ww, k)
    idx = flat.argmax(axis=1)
    scores = np.take_along_axis(flat, idx[:, None, :], axis=1)[:, 0]
    ys, xs = np.unravel_index(idx, (hh, ww))
    xs_f = xs.astype(np.float64)
    ys_f = ys.astype(np.float64)
    for bi in range(b):
        for ki in range(k):
            x, y = xs[bi, ki], ys[bi, ki]
            if 0 < x < ww - 1:
                xs_f[bi, ki] += 0.25 * np.sign(hm[bi, y, x + 1, ki]
                                               - hm[bi, y, x - 1, ki])
            if 0 < y < hh - 1:
                ys_f[bi, ki] += 0.25 * np.sign(hm[bi, y + 1, x, ki]
                                               - hm[bi, y - 1, x, ki])
    out = np.zeros((b, k, 3))
    for bi in range(b):
        bx, by, bw, bh = boxes_xywh[bi]
        out[bi, :, 0] = bx + (xs_f[bi] + 0.5) * bw / ww
        out[bi, :, 1] = by + (ys_f[bi] + 0.5) * bh / hh
        out[bi, :, 2] = scores[bi]
    return out


def hand_boxes_from_keypoints(kpts: np.ndarray, score_thr: float = 0.5,
                              pad: float = 1.2):
    """Left hand = kpts[-42:-21], right = kpts[-21:]; (left, right) xyxy or
    None where fewer than 3 keypoints are confident."""
    def box(sub):
        ok = sub[:, 2] > score_thr
        if ok.sum() < 3:
            return None
        xs, ys = sub[ok, 0], sub[ok, 1]
        cx, cy = xs.mean(), ys.mean()
        half = max(xs.max() - xs.min(), ys.max() - ys.min()) * pad / 2
        return np.array([cx - half, cy - half, cx + half, cy + half])

    return box(kpts[-42:-21]), box(kpts[-21:])


def square_crop(image: np.ndarray, bbox_xyxy: np.ndarray,
                out_size: Tuple[int, int] = (256, 192),
                rescale: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    """Square crop around the box centre (side = the box's longer side x
    ``rescale``), zero outside the image, resized to ``out_size`` (bilinear,
    half-pixel centres: OpenCV's INTER_LINEAR) and ImageNet-normalised.
    Returns (crop (H, W, 3) float32, (cx, cy, size))."""
    x0, y0, x1, y1 = bbox_xyxy
    cx, cy = (x0 + x1) / 2, (y0 + y1) / 2
    size = max(x1 - x0, y1 - y0) * rescale
    half = size / 2
    h, w = image.shape[:2]
    xs0, ys0 = int(round(cx - half)), int(round(cy - half))
    xs1, ys1 = int(round(cx + half)), int(round(cy + half))
    canvas = np.zeros((ys1 - ys0, xs1 - xs0, 3), np.float32)
    sy0, sy1 = max(0, ys0), min(h, ys1)
    sx0, sx1 = max(0, xs0), min(w, xs1)
    canvas[sy0 - ys0:sy1 - ys0, sx0 - xs0:sx1 - xs0] = \
        image[sy0:sy1, sx0:sx1]
    crop = F.interpolate(torch.from_numpy(canvas).permute(2, 0, 1)[None],
                         size=out_size, mode="bilinear", align_corners=False)
    crop = crop[0].permute(1, 2, 0).numpy()
    crop = (crop / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
    return crop.astype(np.float32), np.array([cx, cy, size], np.float32)


def estimate_pose(p: Params, cfg: ViTPoseConfig, frame: np.ndarray,
                  bbox: np.ndarray) -> np.ndarray:
    """Wholebody keypoints (K, 3) [x, y, score] of the person in ``bbox``
    (xyxy) of ``frame`` (H, W, 3) uint8, flip test on, on the params'
    device and dtype."""
    leaf = p["final"]["kernel"]
    crop, cs = square_crop(frame, bbox, out_size=cfg.backbone.img_size)
    hm = heatmaps_flip_test(p, cfg, torch.from_numpy(crop[None]).to(
        leaf.device, leaf.dtype))
    half = cs[2] / 2
    box = np.array([[cs[0] - half, cs[1] - half, cs[2], cs[2]]])
    return decode_keypoints(hm.float().cpu().numpy(), box)[0]


def estimate_pose_batch(p: Params, cfg: ViTPoseConfig, frames, bboxes,
                        batch: int = 8) -> np.ndarray:
    """Whole-clip keypoints (T, K, 3): every frame's person crop cut on the
    host, the flip-test heatmaps ``batch`` crops a call (a memory bound;
    the last call may be shorter), one decode of the clip."""
    leaf = p["final"]["kernel"]
    crops, boxes_xywh = [], []
    for f, bb in zip(frames, bboxes):
        c, cs = square_crop(f, np.asarray(bb), out_size=cfg.backbone.img_size)
        crops.append(c)
        half = cs[2] / 2
        boxes_xywh.append([cs[0] - half, cs[1] - half, cs[2], cs[2]])
    crops = np.stack(crops)
    hms = [heatmaps_flip_test(p, cfg, torch.from_numpy(
        crops[i:i + batch]).to(leaf.device, leaf.dtype))
        for i in range(0, len(crops), batch)]
    return decode_keypoints(torch.cat(hms).float().cpu().numpy(),
                            np.asarray(boxes_xywh, np.float32))
