"""KL-VAE (sd-vae-ft-mse / SD1.5 AutoencoderKL), NHWC, frames batched.

Counterpart of ``mimo_tpu/models/vae.py``: ``encode_mean`` (the scaled
latent mean) and ``decode``. Every GroupNorm routes to the GroupNorm kernel
on CUDA (eps 1e-6); the mid block's single-head d=512 attention goes to the
wide flash kernel (``flash_attention_wide``) at 1024 tokens or more, as the
JAX package's went to ``flash_sdpa``, and to plain attention below
(ops/attention.py).
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from mimo_tpu_torch.config import VAEConfig
from mimo_tpu_torch.models import layers as L
from mimo_tpu_torch.models.unet import resnet_apply, resnet_init

Params = Dict[str, Any]

_EPS = 1e-6


def _attn_init(gen: torch.Generator, channels: int, dtype) -> Params:
    return {
        "norm": L.group_norm_init(channels, dtype, gen.device),
        "to_q": L.linear_init(gen, channels, channels, dtype=dtype),
        "to_k": L.linear_init(gen, channels, channels, dtype=dtype),
        "to_v": L.linear_init(gen, channels, channels, dtype=dtype),
        "to_out": L.linear_init(gen, channels, channels, dtype=dtype),
    }


def _attn_apply(p: Params, x: torch.Tensor, groups: int) -> torch.Tensor:
    """Single-head full self-attention over spatial tokens (mid block)."""
    n, h, w, c = x.shape
    t = L.group_norm(p["norm"], x, groups, _EPS).reshape(n, h * w, c)
    o = L.sdpa(L.linear(p["to_q"], t), L.linear(p["to_k"], t),
               L.linear(p["to_v"], t), heads=1)
    return x + L.linear(p["to_out"], o).reshape(n, h, w, c)


def _mid_init(gen: torch.Generator, channels: int, dtype) -> Params:
    return {
        "resnet1": resnet_init(gen, channels, channels, None, dtype),
        "attn": _attn_init(gen, channels, dtype),
        "resnet2": resnet_init(gen, channels, channels, None, dtype),
    }


def _mid_apply(p: Params, x: torch.Tensor, groups: int) -> torch.Tensor:
    x = resnet_apply(p["resnet1"], x, None, groups, _EPS)
    x = _attn_apply(p["attn"], x, groups)
    return resnet_apply(p["resnet2"], x, None, groups, _EPS)


def vae_init(gen: torch.Generator, cfg: VAEConfig,
             dtype: torch.dtype = torch.float32) -> Params:
    ch = cfg.block_out_channels
    dev = gen.device

    enc: Params = {"conv_in": L.conv2d_init(gen, 3, 3, cfg.sample_channels,
                                            ch[0], dtype=dtype)}
    downs = []
    c_prev = ch[0]
    for i, c_out in enumerate(ch):
        blk = {"resnets": [resnet_init(gen, c_prev if j == 0 else c_out,
                                       c_out, None, dtype)
                           for j in range(cfg.layers_per_block)]}
        blk["downsample"] = (L.conv2d_init(gen, 3, 3, c_out, c_out,
                                           dtype=dtype)
                             if i < len(ch) - 1 else None)
        downs.append(blk)
        c_prev = c_out
    enc["down"] = downs
    enc["mid"] = _mid_init(gen, ch[-1], dtype)
    enc["norm_out"] = L.group_norm_init(ch[-1], dtype, dev)
    enc["conv_out"] = L.conv2d_init(gen, 3, 3, ch[-1],
                                    2 * cfg.latent_channels, dtype=dtype)

    dec: Params = {"conv_in": L.conv2d_init(gen, 3, 3, cfg.latent_channels,
                                            ch[-1], dtype=dtype)}
    dec["mid"] = _mid_init(gen, ch[-1], dtype)
    ups = []
    rev = list(reversed(ch))
    c_prev = ch[-1]
    for i, c_out in enumerate(rev):
        blk = {"resnets": [resnet_init(gen, c_prev if j == 0 else c_out,
                                       c_out, None, dtype)
                           for j in range(cfg.layers_per_block + 1)]}
        blk["upsample"] = (L.conv2d_init(gen, 3, 3, c_out, c_out,
                                         dtype=dtype)
                           if i < len(rev) - 1 else None)
        ups.append(blk)
        c_prev = c_out
    dec["up"] = ups
    dec["norm_out"] = L.group_norm_init(ch[0], dtype, dev)
    dec["conv_out"] = L.conv2d_init(gen, 3, 3, ch[0], cfg.sample_channels,
                                    dtype=dtype)

    return {
        "encoder": enc,
        "decoder": dec,
        "quant_conv": L.conv2d_init(gen, 1, 1, 2 * cfg.latent_channels,
                                    2 * cfg.latent_channels, dtype=dtype),
        "post_quant_conv": L.conv2d_init(gen, 1, 1, cfg.latent_channels,
                                         cfg.latent_channels, dtype=dtype),
    }


def encode_mean(p: Params, cfg: VAEConfig, x: torch.Tensor) -> torch.Tensor:
    """x: (N, H, W, 3) in [-1, 1] -> latent mean (N, H/8, W/8, 4), scaled by
    cfg.scaling_factor."""
    g = cfg.norm_num_groups
    enc = p["encoder"]
    h = L.conv2d(enc["conv_in"], x, padding=1)
    for blk in enc["down"]:
        for rp in blk["resnets"]:
            h = resnet_apply(rp, h, None, g, _EPS)
        if blk["downsample"] is not None:
            # diffusers Downsample2D: asymmetric (0, 1) pad, VALID conv
            h = F.pad(h, (0, 0, 0, 1, 0, 1))
            h = L.conv2d(blk["downsample"], h, stride=2, padding=0)
    h = _mid_apply(enc["mid"], h, g)
    h = L.group_norm(enc["norm_out"], h, g, _EPS, fuse_silu=True)
    h = L.conv2d(enc["conv_out"], h, padding=1)
    h = L.conv2d(p["quant_conv"], h, padding=0)
    return h[..., :cfg.latent_channels] * cfg.scaling_factor


def decode(p: Params, cfg: VAEConfig, z: torch.Tensor) -> torch.Tensor:
    """z: (N, h, w, 4) scaled latents -> (N, 8h, 8w, 3) in [-1, 1]."""
    g = cfg.norm_num_groups
    dec = p["decoder"]
    h = L.conv2d(p["post_quant_conv"], z / cfg.scaling_factor, padding=0)
    h = L.conv2d(dec["conv_in"], h, padding=1)
    h = _mid_apply(dec["mid"], h, g)
    for blk in dec["up"]:
        for rp in blk["resnets"]:
            h = resnet_apply(rp, h, None, g, _EPS)
        if blk["upsample"] is not None:
            h = L.conv2d(blk["upsample"], L.upsample_nearest_2x(h), padding=1)
    h = L.group_norm(dec["norm_out"], h, g, _EPS, fuse_silu=True)
    return L.conv2d(dec["conv_out"], h, padding=1)
