"""Configurable ViT encoder of the perception models.

Counterpart of ``mimo_tpu/decomp/vit.py``, in its three forms:

- SAM's image encoder: windowed attention with a decomposed relative
  position bias, global attention (same bias) at ``global_blocks``, no cls
  token;
- ViTPose's backbone: plain global attention, patch conv padding 4 and the
  cls slot's pos embed added to every token (``cls_pos_to_all``);
- DINOv2: cls token and LayerScale.

Channels-last tokens (B, S, D). Attention keeps the JAX dispatch rule:
unbiased attention over S >= 1024 tokens goes to ``dispatch_sdpa`` (the
flash kernel on the card), the rest, and every biased attention, to
``F.scaled_dot_product_attention``, where the JAX package called
``jax.nn.dot_product_attention``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mimo_tpu_torch.models import layers as L
from mimo_tpu_torch.ops.attention import dispatch_sdpa

Params = Dict[str, Any]


@dataclass(frozen=True)
class ViTConfig:
    img_size: Tuple[int, int] = (224, 224)
    patch_size: int = 16
    in_channels: int = 3
    dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    use_cls_token: bool = False
    layer_scale: bool = False          # DINOv2
    window_size: int = 0               # SAM: windowed attn except globals
    global_blocks: Tuple[int, ...] = ()  # blocks with global attn (SAM)
    use_rel_pos: bool = False          # SAM decomposed rel-pos bias
    qkv_bias: bool = True
    ln_eps: float = 1e-6
    patch_padding: int = 0             # ViTPose: patch conv padding 4
    cls_pos_to_all: bool = False       # ViTPose: cls-slot pos on all tokens

    @property
    def grid(self) -> Tuple[int, int]:
        pp = self.patch_padding
        return ((self.img_size[0] + 2 * pp - self.patch_size)
                // self.patch_size + 1,
                (self.img_size[1] + 2 * pp - self.patch_size)
                // self.patch_size + 1)


def _normal(gen: torch.Generator, shape, std: float,
            dtype: torch.dtype) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, device=gen.device) * std
            ).to(dtype)


def _block_init(gen: torch.Generator, cfg: ViTConfig, windowed: bool,
                dtype: torch.dtype) -> Params:
    d = cfg.dim
    hidden = int(d * cfg.mlp_ratio)
    dev = gen.device
    p = {
        "ln1": L.layer_norm_init(d, dtype, dev),
        "qkv": L.linear_init(gen, d, 3 * d, bias=cfg.qkv_bias, dtype=dtype),
        "proj": L.linear_init(gen, d, d, dtype=dtype),
        "ln2": L.layer_norm_init(d, dtype, dev),
        "fc1": L.linear_init(gen, d, hidden, dtype=dtype),
        "fc2": L.linear_init(gen, hidden, d, dtype=dtype),
    }
    if cfg.layer_scale:
        p["ls1"] = torch.full((d,), 1e-5, dtype=dtype, device=dev)
        p["ls2"] = torch.full((d,), 1e-5, dtype=dtype, device=dev)
    if cfg.use_rel_pos:
        size = cfg.window_size if windowed and cfg.window_size \
            else max(cfg.grid)
        hdim = d // cfg.num_heads
        p["rel_pos_h"] = torch.zeros((2 * size - 1, hdim), dtype=dtype,
                                     device=dev)
        p["rel_pos_w"] = torch.zeros((2 * size - 1, hdim), dtype=dtype,
                                     device=dev)
    return p


def vit_init(gen: torch.Generator, cfg: ViTConfig,
             dtype: torch.dtype = torch.float32) -> Params:
    gh, gw = cfg.grid
    n_tokens = gh * gw + (1 if (cfg.use_cls_token or cfg.cls_pos_to_all)
                          else 0)
    p: Params = {
        "patch_embed": L.conv2d_init(gen, cfg.patch_size, cfg.patch_size,
                                     cfg.in_channels, cfg.dim, dtype=dtype),
        "pos_embed": _normal(gen, (n_tokens, cfg.dim), 0.02, dtype),
        "blocks": [_block_init(gen, cfg, cfg.window_size > 0
                               and i not in cfg.global_blocks, dtype)
                   for i in range(cfg.depth)],
        "ln_out": L.layer_norm_init(cfg.dim, dtype, gen.device),
    }
    if cfg.use_cls_token:
        p["cls_token"] = torch.zeros((cfg.dim,), dtype=dtype,
                                     device=gen.device)
    return p


# ---------------------------------------------------------------------------
# jax.image.resize as weight matrices
# ---------------------------------------------------------------------------


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(x))


def resize_matrix(n_in: int, n_out: int, method: str) -> np.ndarray:
    """(n_out, n_in) float32 weights of ``jax.image.resize`` along one axis
    (half-pixel centres, antialiased when shrinking, taps outside the input
    dropped and the rest renormalised): "bilinear" or "bicubic"."""
    kernel = {"bilinear": _triangle, "bicubic": _keys_cubic}[method]
    inv_scale = n_in / n_out
    kscale = max(inv_scale, 1.0)
    sample = (np.arange(n_out, dtype=np.float32) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None])
    w = kernel(x / kscale).astype(np.float32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).T.astype(np.float32)


def resize_grid(x: torch.Tensor, h: int, w: int, method: str) -> torch.Tensor:
    """(H, W, C) -> (h, w, C) as ``jax.image.resize(x, (h, w, C), method)``."""
    my = torch.from_numpy(resize_matrix(x.shape[0], h, method)).to(x.device)
    mx = torch.from_numpy(resize_matrix(x.shape[1], w, method)).to(x.device)
    y = torch.einsum("ha,abc,wb->hwc", my, x.float(), mx)
    return y.to(x.dtype)


def resize_images(x: torch.Tensor, h: int, w: int,
                  method: str = "bilinear") -> torch.Tensor:
    """(N, H, W, C) -> (N, h, w, C) as ``jax.image.resize`` over the two
    spatial axes (antialiased when shrinking), in fp32, result in x's
    dtype."""
    my = torch.from_numpy(resize_matrix(x.shape[1], h, method)).to(x.device)
    mx = torch.from_numpy(resize_matrix(x.shape[2], w, method)).to(x.device)
    y = torch.einsum("ha,nabc,wb->nhwc", my, x.float(), mx)
    return y.to(x.dtype)


def _interp_pos_embed(pos: torch.Tensor, cfg: ViTConfig, gh: int,
                      gw: int) -> torch.Tensor:
    """The grid part of a learned pos embed resized bilinearly to a new
    grid (DINOv2's interpolate_pos_encoding)."""
    n_extra = 1 if cfg.use_cls_token else 0
    if pos.shape[0] - n_extra == gh * gw:
        return pos
    g0h, g0w = cfg.grid
    grid = resize_grid(pos[n_extra:].reshape(g0h, g0w, -1), gh, gw,
                       "bilinear").reshape(gh * gw, -1)
    return torch.cat([pos[:n_extra], grid], dim=0) if n_extra else grid


# ---------------------------------------------------------------------------
# attention with optional windows + SAM decomposed rel-pos
# ---------------------------------------------------------------------------


def attention_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, Sq, H, d) x (B, Sk, H, d) -> (B, Sq, H, d), scale 1/sqrt(d),
    ``bias`` (B or 1, H or 1, Sq, Sk) added to the logits (or a boolean
    mask of the keys to keep): ``jax.nn.dot_product_attention``'s
    counterpart, one library call."""
    o = F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=bias)
    return o.transpose(1, 2)


def _rel_pos_bias(rel_h: torch.Tensor, rel_w: torch.Tensor, q: torch.Tensor,
                  hgt: int, wid: int) -> torch.Tensor:
    """SAM's decomposed relative position bias. q: (B, heads, H*W, d);
    returns (B, heads, H*W, H*W)."""
    def select(rel, n):
        idx = torch.arange(n, device=rel.device)
        return rel[idx[:, None] - idx[None, :] + (n - 1)]   # (n, n, d)

    b, heads, _, d = q.shape
    qr = q.reshape(b, heads, hgt, wid, d)
    bias_h = torch.einsum("bnhwd,hkd->bnhwk", qr, select(rel_h, hgt))
    bias_w = torch.einsum("bnhwd,wkd->bnhwk", qr, select(rel_w, wid))
    bias = bias_h[..., :, None] + bias_w[..., None, :]
    return bias.reshape(b, heads, hgt * wid, hgt * wid)


def _attn(p: Params, x: torch.Tensor, heads: int, hgt: int,
          wid: int) -> torch.Tensor:
    """x: (B, S, D) with S == hgt * wid (rel-pos needs no cls token)."""
    b, s, d = x.shape
    qkv = L.linear(p["qkv"], x).reshape(b, s, 3, heads, d // heads)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    bias = None
    if "rel_pos_h" in p:
        bias = _rel_pos_bias(p["rel_pos_h"].to(x.dtype),
                             p["rel_pos_w"].to(x.dtype), q.transpose(1, 2),
                             hgt, wid)
    o = attention_heads(q, k, v, bias)
    return L.linear(p["proj"], o.reshape(b, s, d))


def _attn_plain(p: Params, x: torch.Tensor, heads: int) -> torch.Tensor:
    """Unbiased global attention; S >= 1024 rides the flash dispatch with
    q/k/v as column views of the one q|k|v product."""
    b, s, d = x.shape
    qkv = L.linear(p["qkv"], x)
    if s >= 1024:
        q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
        return L.linear(p["proj"], dispatch_sdpa(q, k, v, heads))
    qkv = qkv.reshape(b, s, 3, heads, d // heads)
    o = attention_heads(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
    return L.linear(p["proj"], o.reshape(b, s, d))


def _window_partition(x: torch.Tensor, hgt: int, wid: int, ws: int):
    """(B, H*W, D) -> (B*nW, ws*ws, D) with bottom/right zero padding."""
    b, _, d = x.shape
    x = x.reshape(b, hgt, wid, d)
    ph, pw = (-hgt) % ws, (-wid) % ws
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = hgt + ph, wid + pw
    x = x.reshape(b, hp // ws, ws, wp // ws, ws, d)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, d)
    return x, (hp, wp)


def _window_unpartition(x: torch.Tensor, b: int, hgt: int, wid: int, ws: int,
                        padded: Tuple[int, int]) -> torch.Tensor:
    hp, wp = padded
    d = x.shape[-1]
    x = x.reshape(b, hp // ws, wp // ws, ws, ws, d)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, d)
    return x[:, :hgt, :wid].reshape(b, hgt * wid, d)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact GELU in fp32, result in x's dtype."""
    return F.gelu(x.float(), approximate="none").to(x.dtype)


def vit_apply(p: Params, cfg: ViTConfig, pixels: torch.Tensor,
              return_intermediates: Optional[List[int]] = None):
    """pixels: (B, H, W, C) -> tokens (B, S, D) after the final LN; with
    ``return_intermediates``, also the listed blocks' outputs (pre-LN)."""
    b = pixels.shape[0]
    h = L.conv2d(p["patch_embed"], pixels, stride=cfg.patch_size,
                 padding=cfg.patch_padding)
    gh, gw = h.shape[1], h.shape[2]
    tokens = h.reshape(b, gh * gw, cfg.dim)
    if cfg.use_cls_token:
        cls = p["cls_token"].to(tokens.dtype).expand(b, 1, cfg.dim)
        tokens = torch.cat([cls, tokens], dim=1)
    pos = p["pos_embed"].to(tokens.dtype)
    if cfg.cls_pos_to_all:
        tokens = tokens + pos[None, 1:] + pos[None, :1]
    else:
        tokens = tokens + _interp_pos_embed(pos, cfg, gh, gw)[None]

    inter = []
    for i, blk in enumerate(p["blocks"]):
        y = L.layer_norm(blk["ln1"], tokens, cfg.ln_eps)
        if cfg.window_size > 0 and i not in cfg.global_blocks \
                and not cfg.use_cls_token:
            yw, padded = _window_partition(y, gh, gw, cfg.window_size)
            aw = _attn(blk, yw, cfg.num_heads, cfg.window_size,
                       cfg.window_size)
            a = _window_unpartition(aw, b, gh, gw, cfg.window_size, padded)
        elif cfg.use_cls_token:
            a = _attn_plain(blk, y, cfg.num_heads)
        else:
            a = _attn(blk, y, cfg.num_heads, gh, gw)
        if "ls1" in blk:
            a = a * blk["ls1"].to(a.dtype)
        tokens = tokens + a

        y = L.layer_norm(blk["ln2"], tokens, cfg.ln_eps)
        m = L.linear(blk["fc2"], gelu(L.linear(blk["fc1"], y)))
        if "ls2" in blk:
            m = m * blk["ls2"].to(m.dtype)
        tokens = tokens + m
        if return_intermediates is not None and i in return_intermediates:
            inter.append(tokens)

    out = L.layer_norm(p["ln_out"], tokens, cfg.ln_eps)
    if return_intermediates is not None:
        return out, inter
    return out


def tokens_to_grid(tokens: torch.Tensor, cfg: ViTConfig, gh: int,
                   gw: int) -> torch.Tensor:
    """Drop cls (if any): (B, S, D) -> (B, gh, gw, D)."""
    if cfg.use_cls_token:
        tokens = tokens[:, 1:]
    b, _, d = tokens.shape
    return tokens.reshape(b, gh, gw, d)
