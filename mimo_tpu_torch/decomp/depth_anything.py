"""DepthAnythingV2: a DINOv2 encoder and the DPT fusion head -> relative
depth, the occlusion stage's depth order.

Counterpart of ``mimo_tpu/decomp/depth_anything.py``. The encoder is
``decomp/vit.py`` with the cls token and LayerScale; its unbiased attention
over the 2073 tokens of a 720x480 frame (a 56x37 grid at 784x518, plus the
cls token) reaches the flash kernel at d = 64 on the card. Every resize is
``jax.image.resize``'s bilinear (half-pixel centres, antialiased when
shrinking) through ``decomp/vit.py``'s ``resize_grid`` / ``resize_images``:
``infer_depth``'s last resize, 784x518 back to 720x480, shrinks, where
``F.interpolate(antialias=False)`` would differ.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from mimo_tpu_torch.decomp.vit import (ViTConfig, resize_grid, resize_images,
                                       tokens_to_grid, vit_apply, vit_init)
from mimo_tpu_torch.models import layers as L

Params = Dict[str, Any]


@dataclass(frozen=True)
class DepthAnythingConfig:
    encoder: ViTConfig = field(default_factory=lambda: ViTConfig(
        img_size=(518, 518), patch_size=14, dim=1024, depth=24,
        num_heads=16, use_cls_token=True, layer_scale=True))
    # blocks tapped for the DPT pyramid (vitl: 4, 11, 17, 23)
    tap_blocks: Tuple[int, ...] = (4, 11, 17, 23)
    out_channels: Tuple[int, ...] = (256, 512, 1024, 1024)
    features: int = 256


def tiny_depth_config() -> DepthAnythingConfig:
    return DepthAnythingConfig(
        encoder=ViTConfig(img_size=(56, 56), patch_size=14, dim=32, depth=4,
                          num_heads=4, use_cls_token=True, layer_scale=True),
        tap_blocks=(0, 1, 2, 3),
        out_channels=(16, 16, 32, 32),
        features=16,
    )


# per level, how the pyramid resizes the projected tokens
RESIZE_KINDS = ("up4", "up2", "id", "down2")


def _rcu_init(gen, ch: int, dtype) -> Params:
    return {"conv1": L.conv2d_init(gen, 3, 3, ch, ch, dtype=dtype),
            "conv2": L.conv2d_init(gen, 3, 3, ch, ch, dtype=dtype)}


def _rcu_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    h = L.conv2d(p["conv1"], F.relu(x), padding=1)
    h = L.conv2d(p["conv2"], F.relu(h), padding=1)
    return x + h


def depth_anything_init(gen: torch.Generator, cfg: DepthAnythingConfig,
                        dtype: torch.dtype = torch.float32) -> Params:
    f = cfg.features
    oc = cfg.out_channels

    def conv(kh, kw, ci, co, **opts):
        return L.conv2d_init(gen, kh, kw, ci, co, dtype=dtype, **opts)

    p: Params = {"encoder": vit_init(gen, cfg.encoder, dtype)}
    p["projects"] = [conv(1, 1, cfg.encoder.dim, c) for c in oc]
    p["resize"] = [{"kind": kind} if kind == "id"
                   else {"kind": kind, "conv": conv(3, 3, c, c)}
                   for kind, c in zip(RESIZE_KINDS, oc)]
    p["scratch"] = [conv(3, 3, c, f, bias=False) for c in oc]
    p["fuse"] = [{"rcu1": _rcu_init(gen, f, dtype),
                  "rcu2": _rcu_init(gen, f, dtype),
                  "project": conv(1, 1, f, f)} for _ in range(4)]
    p["head1"] = conv(3, 3, f, f // 2)
    p["head2"] = conv(3, 3, f // 2, 32)
    p["head3"] = conv(1, 1, 32, 1)
    return p


def depth_forward(p: Params, cfg: DepthAnythingConfig,
                  pixels: torch.Tensor) -> torch.Tensor:
    """pixels: (B, H, W, 3) ImageNet-normalised, H and W multiples of the
    patch size. Returns relative depth (B, H, W), >= 0."""
    _, h, w, _ = pixels.shape
    gh, gw = h // cfg.encoder.patch_size, w // cfg.encoder.patch_size
    _, inter = vit_apply(p["encoder"], cfg.encoder, pixels,
                         return_intermediates=list(cfg.tap_blocks))

    feats = []
    for lvl, tokens in enumerate(inter):
        g = tokens_to_grid(tokens, cfg.encoder, gh, gw)
        g = L.conv2d(p["projects"][lvl], g, padding=0)
        rz = p["resize"][lvl]
        if rz["kind"] == "up4":
            g = L.conv2d(rz["conv"], resize_images(g, gh * 4, gw * 4),
                         padding=1)
        elif rz["kind"] == "up2":
            g = L.conv2d(rz["conv"], resize_images(g, gh * 2, gw * 2),
                         padding=1)
        elif rz["kind"] == "down2":
            g = L.conv2d(rz["conv"], g, stride=2, padding=1)
        feats.append(L.conv2d(p["scratch"][lvl], g, padding=1))

    # top-down fusion (RefineNet style)
    path = None
    for lvl in (3, 2, 1, 0):
        x = feats[lvl]
        fz = p["fuse"][lvl]
        if path is not None:
            path = resize_images(path, x.shape[1], x.shape[2])
            x = x + _rcu_apply(fz["rcu1"], path)
        x = _rcu_apply(fz["rcu2"], x)
        path = L.conv2d(fz["project"], x, padding=0)

    out = resize_images(path, gh * 8, gw * 8)
    out = F.relu(L.conv2d(p["head1"], out, padding=1))
    out = F.relu(L.conv2d(p["head2"], out, padding=1))
    out = F.relu(L.conv2d(p["head3"], out, padding=0))
    return resize_images(out, h, w)[..., 0]


IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def infer_size(h: int, w: int, patch: int, input_size: int = 518):
    """The network's input size for an (h, w) frame: the short side near
    ``input_size``, both sides multiples of the patch."""
    s = input_size / min(h, w)
    return (max(patch, int(round(h * s / patch)) * patch),
            max(patch, int(round(w * s / patch)) * patch))


def infer_depth(p: Params, cfg: DepthAnythingConfig, image01: torch.Tensor,
                input_size: int = 518) -> torch.Tensor:
    """The reference's infer_image: resize to ~input_size (multiples of the
    patch), normalise, forward in the params' dtype, resize back. image01:
    (H, W, 3) float in [0, 1]. Returns (H, W) fp32."""
    h, w = image01.shape[:2]
    nh, nw = infer_size(h, w, cfg.encoder.patch_size, input_size)
    x = resize_grid(image01.float(), nh, nw, "bilinear")
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)
    std = torch.tensor(IMAGENET_STD, device=x.device)
    x = ((x - mean) / std).to(p["encoder"]["patch_embed"]["kernel"].dtype)
    d = depth_forward(p, cfg, x[None])[0].float()
    return resize_grid(d[..., None], h, w, "bilinear")[..., 0]
