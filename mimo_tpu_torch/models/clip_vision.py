"""CLIP ViT-L/14 vision tower + projection (CLIPVisionModelWithProjection
role). Counterpart of ``mimo_tpu/models/clip_vision.py``: patch conv (no
bias), class token, learned position embeddings, pre-LN, transformer layers
(LN→MHA→res, LN→MLP(quick_gelu)→res), post-LN on the CLS token, linear
projection (no bias). Its attention (S=257) takes plain attention.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from mimo_tpu_torch.config import CLIPVisionConfig
from mimo_tpu_torch.models import layers as L

Params = Dict[str, Any]

# CLIPImageProcessor defaults
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def _quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def _normal(gen: torch.Generator, shape, std: float, dtype) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, device=gen.device) * std).to(dtype)


def clip_vision_init(gen: torch.Generator, cfg: CLIPVisionConfig,
                     dtype: torch.dtype = torch.float32) -> Params:
    d = cfg.hidden_size
    n_pos = (cfg.image_size // cfg.patch_size) ** 2 + 1
    dev = gen.device
    layers_p = [{
        "ln1": L.layer_norm_init(d, dtype, dev),
        "q": L.linear_init(gen, d, d, dtype=dtype),
        "k": L.linear_init(gen, d, d, dtype=dtype),
        "v": L.linear_init(gen, d, d, dtype=dtype),
        "out": L.linear_init(gen, d, d, dtype=dtype),
        "ln2": L.layer_norm_init(d, dtype, dev),
        "fc1": L.linear_init(gen, d, 4 * d, dtype=dtype),
        "fc2": L.linear_init(gen, 4 * d, d, dtype=dtype),
    } for _ in range(cfg.num_layers)]
    patch = _normal(gen, (d, 3, cfg.patch_size, cfg.patch_size), 0.02, dtype)
    return {
        "patch_embed": {"kernel": patch.contiguous(
            memory_format=torch.channels_last)},
        "class_embed": _normal(gen, (d,), 0.02, dtype),
        "pos_embed": _normal(gen, (n_pos, d), 0.02, dtype),
        "pre_ln": L.layer_norm_init(d, dtype, dev),
        "layers": layers_p,
        "post_ln": L.layer_norm_init(d, dtype, dev),
        "projection": L.linear_init(gen, d, cfg.projection_dim, bias=False,
                                    dtype=dtype),
    }


def clip_image_embed(p: Params, cfg: CLIPVisionConfig,
                     pixels: torch.Tensor) -> torch.Tensor:
    """pixels: (B, 224, 224, 3), CLIP-normalized -> (B, projection_dim)."""
    b = pixels.shape[0]
    d = cfg.hidden_size
    h = L.conv2d(p["patch_embed"], pixels, stride=cfg.patch_size,
                 padding="VALID").reshape(b, -1, d)
    cls = p["class_embed"].to(h.dtype).expand(b, 1, d)
    h = torch.cat([cls, h], dim=1) + p["pos_embed"].to(h.dtype)[None]
    h = L.layer_norm(p["pre_ln"], h, cfg.layer_norm_eps)
    for lp in p["layers"]:
        y = L.layer_norm(lp["ln1"], h, cfg.layer_norm_eps)
        o = L.sdpa(L.linear(lp["q"], y), L.linear(lp["k"], y),
                   L.linear(lp["v"], y), cfg.num_heads)
        h = h + L.linear(lp["out"], o)
        y = L.layer_norm(lp["ln2"], h, cfg.layer_norm_eps)
        h = h + L.linear(lp["fc2"], _quick_gelu(L.linear(lp["fc1"], y)))
    pooled = L.layer_norm(p["post_ln"], h[:, 0], cfg.layer_norm_eps)
    return L.linear(p["projection"], pooled)


def clip_preprocess(images01: torch.Tensor) -> torch.Tensor:
    """images01: (B, 224, 224, 3) in [0, 1] -> CLIP-normalized."""
    mean = torch.tensor(CLIP_MEAN, dtype=images01.dtype,
                        device=images01.device)
    std = torch.tensor(CLIP_STD, dtype=images01.dtype, device=images01.device)
    return (images01 - mean) / std
