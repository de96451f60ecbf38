"""Hiera hierarchical ViT backbone + FPN neck (SAM2's image encoder).

Counterpart of ``mimo_tpu/decomp/hiera.py`` (hiera-large by default: embed
144, heads 2, stages (2, 6, 36, 4), window spec (8, 4, 16, 8), global
blocks 23 / 33 / 43, dim and heads doubling a stage, 2x2 query pooling at
each stage transition, FPN neck at 256 with top-down fusion into levels 2
and 3 and the stride-32 level dropped).

The block plan, the lagged window spec, the bicubic + tiled-window pos
embed, the max-pooled shortcut and the windowing are the JAX package's.
Global attention over >= 1024 queries (the three global blocks of stage 3
at 1024^2: 64x64 tokens, 8 heads of 72) goes to ``dispatch_sdpa`` with q,
k and v as strided views of the one q|k|v product; the rest to
``F.scaled_dot_product_attention``.

Between a block's products (cuBLAS, bias-free) its elementwise chains are
bf16 row passes on the card: LayerNorm by ``ops/ffn.py::ln_rows``, fc1's
bias + GELU and the bias + residual after fc2 and proj_attn (a windowed
block's product read through the inverse window partition) by
``ops/rows.py``, equal in every bit to the eager chain they replace (LN
within a bf16 ulp on the card; the CPU takes the eager chain).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mimo_tpu_torch.decomp.vit import (_normal, _window_partition,
                                       attention_heads, resize_grid)
from mimo_tpu_torch.models import layers as L
from mimo_tpu_torch.ops import ffn as FF
from mimo_tpu_torch.ops import rows as R
from mimo_tpu_torch.ops.attention import dispatch_sdpa, flash_applies

Params = Dict[str, Any]


@dataclass(frozen=True)
class HieraConfig:
    embed_dim: int = 144
    num_heads: int = 2
    stages: Tuple[int, ...] = (2, 6, 36, 4)
    window_spec: Tuple[int, ...] = (8, 4, 16, 8)
    global_blocks: Tuple[int, ...] = (23, 33, 43)
    input_size: Tuple[int, int] = (1024, 1024)
    pos_bkg_size: int = 7
    mlp_ratio: float = 4.0
    neck_dim: int = 256
    ln_eps: float = 1e-6

    @property
    def depth(self) -> int:
        return sum(self.stages)

    def stage_of(self, block_idx: int) -> int:
        acc = 0
        for s, n in enumerate(self.stages):
            acc += n
            if block_idx < acc:
                return s
        return len(self.stages) - 1

    def block_plan(self):
        """Per-block (dim_in, dim_out, heads, window, q_pool). The pooling
        block (first of a stage) keeps the previous stage's window."""
        plan = []
        dim, heads = self.embed_dim, self.num_heads
        boundaries = set(np.cumsum(self.stages[:-1]).tolist())
        for i in range(self.depth):
            stage = self.stage_of(i)
            if i in boundaries:
                window = 0 if i in self.global_blocks \
                    else self.window_spec[stage - 1]
                plan.append((dim, dim * 2, heads * 2, window, True))
                dim, heads = dim * 2, heads * 2
            else:
                window = 0 if i in self.global_blocks \
                    else self.window_spec[stage]
                plan.append((dim, dim, heads, window, False))
        return plan


def tiny_hiera_config() -> HieraConfig:
    return HieraConfig(embed_dim=16, num_heads=2, stages=(1, 1, 1, 1),
                       window_spec=(2, 2, 2, 2), global_blocks=(3,),
                       input_size=(64, 64), neck_dim=32)


def hiera_init(gen: torch.Generator, cfg: HieraConfig,
               dtype: torch.dtype = torch.float32) -> Params:
    d0 = cfg.embed_dim
    dev = gen.device
    blocks = []
    for (din, dout, _, _, _) in cfg.block_plan():
        hidden = int(dout * cfg.mlp_ratio)
        blk = {
            "ln1": L.layer_norm_init(din, dtype, dev),
            "qkv": L.linear_init(gen, din, 3 * dout, dtype=dtype),
            "proj_attn": L.linear_init(gen, dout, dout, dtype=dtype),
            "ln2": L.layer_norm_init(dout, dtype, dev),
            "fc1": L.linear_init(gen, dout, hidden, dtype=dtype),
            "fc2": L.linear_init(gen, hidden, dout, dtype=dtype),
        }
        if din != dout:
            blk["proj"] = L.linear_init(gen, din, dout, dtype=dtype)
        blocks.append(blk)
    w0 = cfg.window_spec[0]
    n = len(cfg.stages)
    return {
        "patch_embed": L.conv2d_init(gen, 7, 7, 3, d0, dtype=dtype),
        "pos_bkg": _normal(gen, (cfg.pos_bkg_size, cfg.pos_bkg_size, d0),
                           0.02, dtype),
        "pos_win": _normal(gen, (w0, w0, d0), 0.02, dtype),
        "blocks": blocks,
        # checkpoint order: neck[0] takes the deepest stage's feature
        "neck": [L.conv2d_init(gen, 1, 1, d0 * 2 ** (n - 1 - i),
                               cfg.neck_dim, dtype=dtype) for i in range(n)],
    }


def _maxpool2(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/2, W/2, C) 2x2 max pooling."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def _attn(blk: Params, x: torch.Tensor, heads: int, dout: int,
          q_pool: bool, hgt: int, wid: int):
    """MultiScaleAttention up to its output projection: q|k|v at dout,
    optional 2x2 max pool of q before attention. x: (B, H*W, din). Returns
    (the heads' output (B, oh*ow, dout), oh, ow)."""
    b = x.shape[0]
    qkv = L.linear(blk["qkv"], x).reshape(b, hgt * wid, 3, dout)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    oh, ow = hgt, wid
    if q_pool:
        q = _maxpool2(q.reshape(b, hgt, wid, dout))
        oh, ow = q.shape[1], q.shape[2]
        q = q.reshape(b, oh * ow, dout)
    d = dout // heads
    if flash_applies(q.shape[1], d):
        o = dispatch_sdpa(q, k, v, heads)
    else:
        o = attention_heads(q.reshape(b, -1, heads, d),
                            k.reshape(b, -1, heads, d),
                            v.reshape(b, -1, heads, d)).reshape(b, -1, dout)
    return o, oh, ow


def _product(lin: Params, x: torch.Tensor) -> torch.Tensor:
    """x · W of a linear layer, its bias left to the row pass after it."""
    return torch.matmul(x, lin["kernel"].to(x.dtype))


def hiera_pos_embed(p: Params, cfg: HieraConfig, gh: int,
                    gw: int) -> torch.Tensor:
    """Bicubic-resized background embed + tiled window embed."""
    pos = resize_grid(p["pos_bkg"], gh, gw, "bicubic")
    w0 = p["pos_win"].shape[0]
    tiled = p["pos_win"].repeat(-(-gh // w0), -(-gw // w0), 1)[:gh, :gw]
    return pos + tiled


def hiera_apply(p: Params, cfg: HieraConfig,
                pixels: torch.Tensor) -> List[torch.Tensor]:
    """pixels: (B, S, S, 3) normalised. Returns the per-stage feature maps
    [(B, S/4, S/4, d0), ..., (B, S/32, S/32, 8*d0)]."""
    b = pixels.shape[0]
    h = L.conv2d(p["patch_embed"], pixels, stride=4, padding=3)
    gh, gw = h.shape[1], h.shape[2]
    h = h + hiera_pos_embed(p, cfg, gh, gw).to(h.dtype)[None]
    tokens = h.reshape(b, gh * gw, cfg.embed_dim)
    stage_last = set((np.cumsum(cfg.stages) - 1).tolist())

    outputs = []
    for i, (blk, (din, dout, heads, window, q_pool)) in enumerate(
            zip(p["blocks"], cfg.block_plan())):
        ln1, ln2 = blk["ln1"], blk["ln2"]
        y = FF.ln_rows(tokens, ln1["scale"], ln1["bias"], cfg.ln_eps)
        if "proj" in blk:
            shortcut = L.linear(blk["proj"], y)
            if q_pool:
                shortcut = _maxpool2(shortcut.reshape(b, gh, gw, dout))
                shortcut = shortcut.reshape(b, -1, dout)
        else:
            shortcut = tokens

        un = None
        if window:
            yw, (hp, wp) = _window_partition(y, gh, gw, window)
            o, _, _ = _attn(blk, yw, heads, dout, q_pool, window, window)
            # each window's queries pooled 2x2: unpartition at window/2
            # onto the pooled grid
            f = 2 if q_pool else 1
            un = R.Unpartition(gh // f, gw // f, window // f,
                               (hp // f, wp // f))
            gh, gw = un.hgt, un.wid
        else:
            o, gh, gw = _attn(blk, y, heads, dout, q_pool, gh, gw)

        lin = blk["proj_attn"]
        tokens = R.bias_residual(_product(lin, o), lin["bias"], shortcut, un)
        y2 = FF.ln_rows(tokens, ln2["scale"], ln2["bias"], cfg.ln_eps)
        h = R.bias_gelu(_product(blk["fc1"], y2), blk["fc1"]["bias"])
        tokens = R.bias_residual(_product(blk["fc2"], h), blk["fc2"]["bias"],
                                 tokens)
        if i in stage_last:
            outputs.append(tokens.reshape(b, gh, gw, dout))
    return outputs


@functools.lru_cache(maxsize=None)
def sine_pos_embed(gh: int, gw: int, dim: int,
                   temperature: float = 10000.0) -> np.ndarray:
    """PositionEmbeddingSine, normalised, scale 2*pi: (gh, gw, dim) with the
    [y-feats ; x-feats] channel order. Cached (the stride-4 level alone is
    16M values of numpy sin / cos, which every encode of a frame chunk
    would otherwise recompute on the host): callers must not modify it."""
    npf = dim // 2
    scale = 2 * np.pi
    y = np.arange(1, gh + 1, dtype=np.float32)[:, None] \
        * np.ones((1, gw), np.float32)
    x = np.arange(1, gw + 1, dtype=np.float32)[None, :] \
        * np.ones((gh, 1), np.float32)
    eps = 1e-6
    y = y / (y[-1:, :] + eps) * scale
    x = x / (x[:, -1:] + eps) * scale
    dim_t = np.arange(npf, dtype=np.float32)
    dim_t = temperature ** (2 * (dim_t // 2) / npf)
    px = x[:, :, None] / dim_t
    py = y[:, :, None] / dim_t
    px = np.stack([np.sin(px[..., 0::2]), np.cos(px[..., 1::2])],
                  axis=-1).reshape(gh, gw, npf)
    py = np.stack([np.sin(py[..., 0::2]), np.cos(py[..., 1::2])],
                  axis=-1).reshape(gh, gw, npf)
    return np.concatenate([py, px], axis=-1)


def hiera_neck(p: Params, cfg: HieraConfig, stage_feats: List[torch.Tensor],
               scalp: int = 1) -> Tuple[List[torch.Tensor], List[np.ndarray]]:
    """FpnNeck with scalp: lateral 1x1 convs, top-down nearest-x2 fusion
    into levels 2 and 3, the stride-32 output dropped. Returns ([stride 4,
    8, 16] features at neck_dim, their sine pos embeds)."""
    n = len(stage_feats) - 1
    out: List[Any] = [None] * len(stage_feats)
    prev = None
    for i in range(n, -1, -1):
        lateral = L.conv2d(p["neck"][n - i], stage_feats[i], padding=0)
        if i in (2, 3) and prev is not None:
            prev = lateral + L.upsample_nearest_2x(prev).to(lateral.dtype)
        else:
            prev = lateral
        out[i] = prev
    if scalp:
        out = out[:-scalp]
    pos = [sine_pos_embed(f.shape[1], f.shape[2], cfg.neck_dim) for f in out]
    return out, pos


def encode_image_hiera(p: Params, cfg: HieraConfig,
                       pixels: torch.Tensor) -> torch.Tensor:
    """Stride-16 neck feature (B, S/16, S/16, neck_dim)."""
    necked, _ = hiera_neck(p, cfg, hiera_apply(p, cfg, pixels))
    return necked[2]
