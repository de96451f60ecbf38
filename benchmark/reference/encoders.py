"""The KL-VAE (sd-vae-ft-mse), the CLIP ViT-L/14 vision tower with its
projection, and MIMO's pose guider, in plain float32, NHWC."""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from benchmark.reference import nn
from benchmark.reference.unet import resnet

Params = Dict[str, Any]

VAE_EPS = 1e-6
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


# ---------------------------------------------------------------------------
# VAE
# ---------------------------------------------------------------------------


def _vae_attention(p: Params, x: torch.Tensor, groups: int) -> torch.Tensor:
    n, h, w, c = x.shape
    t = nn.group_norm(p["norm"], x, groups, VAE_EPS).reshape(n, h * w, c)
    o = nn.attention(nn.linear(p["to_q"], t), nn.linear(p["to_k"], t),
                     nn.linear(p["to_v"], t), heads=1)
    return x.float() + nn.linear(p["to_out"], o).reshape(n, h, w, c)


def _vae_mid(p: Params, x: torch.Tensor, groups: int) -> torch.Tensor:
    x = resnet(p["resnet1"], x, None, groups, VAE_EPS)
    x = _vae_attention(p["attn"], x, groups)
    return resnet(p["resnet2"], x, None, groups, VAE_EPS)


def vae_encode_mean(p: Params, cfg: Dict[str, Any], x: torch.Tensor
                    ) -> torch.Tensor:
    """x (N, H, W, 3) in [-1, 1] -> the scaled latent mean (N, H/8, W/8, 4)."""
    g = cfg["norm_num_groups"]
    enc = p["encoder"]
    h = nn.conv2d(enc["conv_in"], x, padding=1)
    for blk in enc["down"]:
        for rp in blk["resnets"]:
            h = resnet(rp, h, None, g, VAE_EPS)
        if blk["downsample"] is not None:
            h = F.pad(h, (0, 0, 0, 1, 0, 1))   # diffusers' (0, 1) pad
            h = nn.conv2d(blk["downsample"], h, stride=2, padding=0)
    h = _vae_mid(enc["mid"], h, g)
    h = nn.group_norm(enc["norm_out"], h, g, VAE_EPS, silu=True)
    h = nn.conv2d(enc["conv_out"], h, padding=1)
    h = nn.conv2d(p["quant_conv"], h, padding=0)
    return h[..., :cfg["latent_channels"]] * cfg["scaling_factor"]


def vae_decode(p: Params, cfg: Dict[str, Any], z: torch.Tensor
               ) -> torch.Tensor:
    """z (N, h, w, 4) scaled latents -> (N, 8h, 8w, 3) in [-1, 1]."""
    g = cfg["norm_num_groups"]
    dec = p["decoder"]
    h = nn.conv2d(p["post_quant_conv"], z.float() / cfg["scaling_factor"],
                  padding=0)
    h = nn.conv2d(dec["conv_in"], h, padding=1)
    h = _vae_mid(dec["mid"], h, g)
    for blk in dec["up"]:
        for rp in blk["resnets"]:
            h = resnet(rp, h, None, g, VAE_EPS)
        if blk["upsample"] is not None:
            h = h.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
            h = nn.conv2d(blk["upsample"], h, padding=1)
    h = nn.group_norm(dec["norm_out"], h, g, VAE_EPS, silu=True)
    return nn.conv2d(dec["conv_out"], h, padding=1)


# ---------------------------------------------------------------------------
# CLIP vision tower
# ---------------------------------------------------------------------------


def clip_preprocess(images01: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(CLIP_MEAN, device=images01.device)
    std = torch.tensor(CLIP_STD, device=images01.device)
    return (images01.float() - mean) / std


def clip_image_embed(p: Params, cfg: Dict[str, Any], pixels: torch.Tensor
                     ) -> torch.Tensor:
    """pixels (B, 224, 224, 3), CLIP-normalized -> (B, projection_dim)."""
    b, d, eps = pixels.shape[0], cfg["hidden_size"], cfg["layer_norm_eps"]
    h = nn.conv2d(p["patch_embed"], pixels, stride=cfg["patch_size"],
                  padding="VALID").reshape(b, -1, d)
    cls = p["class_embed"].float().expand(b, 1, d)
    h = torch.cat([cls, h], dim=1) + p["pos_embed"].float()[None]
    h = nn.layer_norm(p["pre_ln"], h, eps)
    for lp in p["layers"]:
        y = nn.layer_norm(lp["ln1"], h, eps)
        o = nn.attention(nn.linear(lp["q"], y), nn.linear(lp["k"], y),
                         nn.linear(lp["v"], y), cfg["num_heads"])
        h = h + nn.linear(lp["out"], o)
        y = nn.linear(lp["fc1"], nn.layer_norm(lp["ln2"], h, eps))
        h = h + nn.linear(lp["fc2"], y * torch.sigmoid(1.702 * y))
    pooled = nn.layer_norm(p["post_ln"], h[:, 0], eps)
    return nn.linear(p["projection"], pooled)


# ---------------------------------------------------------------------------
# pose guider
# ---------------------------------------------------------------------------


def pose_guider(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x (F, H, W, 3) in [0, 1] -> (F, H/8, W/8, embedding_channels)."""
    y = F.silu(nn.conv2d(p["conv_in"], x, padding=1))
    for blk in p["blocks"]:
        y = F.silu(nn.conv2d(blk["conv_a"], y, padding=1))
        y = F.silu(nn.conv2d(blk["conv_b"], y, stride=2, padding=1))
    return nn.conv2d(p["conv_out"], y, padding=1)
