"""SAM 2's image encoder in plain float32: the Hiera trunk and the FPN neck
(Ravi et al., arXiv 2408.00714; ``sam2_hiera_l.yaml`` in facebookresearch/
sam2: embed 144, heads 2, stages 2-6-36-4, windows 8-4-16-8, global blocks
23, 33 and 43, a 2x2 query pool at each stage boundary, neck at 256 with
top-down fusion into levels 2 and 3, the stride-32 level dropped).

Feature maps are NHWC; every product goes through ``nn.py``, so its
switches (the float8 control, the work log) apply. Nothing here imports
the program.

Departure from the published encoder, as the program has it: the
background position embedding is resized to the token grid with Keys'
cubic (a = -0.5), half-pixel centres, taps outside the grid dropped and
the rest renormalised (``jax.image.resize``'s bicubic); upstream calls
``F.interpolate(mode="bicubic")`` (a = -0.75, edges clamped).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import nn
from benchmark.reference.sam2_params import block_plan

Params = Dict[str, Any]
TOP_DOWN = (2, 3)   # the neck's levels that take the level below them


def _cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic kernel, a = -0.5."""
    x = np.abs(x)
    near = ((1.5 * x - 2.5) * x) * x + 1.0
    far = ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def cubic_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) weights of an upsampling along one axis: output i
    samples the input at (i + 0.5) n_in / n_out - 0.5; the taps that fall
    inside the input are renormalised to sum to one."""
    pos = (np.arange(n_out) + 0.5) * n_in / n_out - 0.5
    w = _cubic(pos[:, None] - np.arange(n_in)[None, :])
    return w / w.sum(axis=1, keepdims=True)


def pos_embed(p: Params, gh: int, gw: int, device) -> torch.Tensor:
    """(gh, gw, C): the background embed resized bicubically plus the
    window embed tiled over the grid."""
    bkg = p["pos_bkg"].float()
    my = torch.from_numpy(cubic_weights(bkg.shape[0], gh)).float().to(device)
    mx = torch.from_numpy(cubic_weights(bkg.shape[1], gw)).float().to(device)
    pos = torch.einsum("ha,abc,wb->hwc", my, bkg, mx)
    win = p["pos_win"].float()
    reps = (-(-gh // win.shape[0]), -(-gw // win.shape[1]), 1)
    return pos + win.repeat(*reps)[:gh, :gw]


def sine_embed(gh: int, gw: int, dim: int, device) -> torch.Tensor:
    """PositionEmbeddingSine (normalised, scale 2 pi, temperature 1e4):
    (gh, gw, dim), the y features then the x features, each an interleave
    of sin (even) and cos (odd) channels."""
    half, eps, scale = dim // 2, 1e-6, 2 * math.pi
    y = np.arange(1, gh + 1, dtype=np.float64)
    x = np.arange(1, gw + 1, dtype=np.float64)
    y, x = y / (y[-1] + eps) * scale, x / (x[-1] + eps) * scale
    dim_t = 10000.0 ** (2 * (np.arange(half) // 2) / half)

    def feats(v):
        a = v[:, None] / dim_t
        out = np.empty_like(a)
        out[:, 0::2], out[:, 1::2] = np.sin(a[:, 0::2]), np.cos(a[:, 1::2])
        return out

    fy, fx = feats(y), feats(x)
    pos = np.concatenate([np.broadcast_to(fy[:, None], (gh, gw, half)),
                          np.broadcast_to(fx[None, :], (gh, gw, half))], -1)
    return torch.from_numpy(pos).float().to(device)


def _pool(x: torch.Tensor) -> torch.Tensor:
    """2x2 max pool of (B, H, W, C)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def _windows(x: torch.Tensor, ws: int) -> Tuple[torch.Tensor, int, int]:
    """(B, H, W, C) -> (B·nW, ws, ws, C), zero-padded bottom / right;
    returns the padded height and width too."""
    b, h, w, c = x.shape
    hp, wp = -(-h // ws) * ws, -(-w // ws) * ws
    x = F.pad(x, (0, 0, 0, wp - w, 0, hp - h))
    x = x.reshape(b, hp // ws, ws, wp // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws, ws, c), hp, wp


def _unwindow(x: torch.Tensor, b: int, hp: int, wp: int, h: int,
              w: int) -> torch.Tensor:
    ws, c = x.shape[1], x.shape[-1]
    x = x.reshape(b, hp // ws, wp // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hp, wp, c)[:, :h, :w]


def _attention(blk: Params, x: torch.Tensor, heads: int, dout: int,
               pool: bool) -> torch.Tensor:
    """MultiScaleAttention on (B, H, W, C): q|k|v, q pooled 2x2 if
    ``pool``, softmax attention, the output projection."""
    b, h, w, _ = x.shape
    qkv = nn.linear(blk["qkv"], x.reshape(b, h * w, -1))
    q, k, v = qkv.reshape(b, h * w, 3, dout).unbind(2)
    if pool:
        q = _pool(q.reshape(b, h, w, dout))
        h, w = q.shape[1], q.shape[2]
        q = q.reshape(b, h * w, dout)
    o = nn.attention(q, k, v, heads)
    return nn.linear(blk["proj_attn"], o).reshape(b, h, w, dout)


def trunk(p: Params, h: Dict[str, Any], pixels: torch.Tensor
          ) -> List[torch.Tensor]:
    """pixels (B, S, S, 3) normalised -> each stage's last output (B, H, W,
    C), strides 4, 8, 16 and 32."""
    eps = h["ln_eps"]
    x = nn.conv2d(p["patch_embed"], pixels, stride=4, padding=3)
    x = x + pos_embed(p, x.shape[1], x.shape[2], x.device)[None]
    ends = {sum(h["stages"][:i + 1]) - 1 for i in range(len(h["stages"]))}
    outs = []
    for i, (blk, (din, dout, heads, window, pool)) in enumerate(
            zip(p["blocks"], block_plan(h))):
        b, hh, ww, _ = x.shape
        y = nn.layer_norm(blk["ln1"], x, eps)
        shortcut = x
        if din != dout:
            shortcut = nn.linear(blk["proj"], y)
            if pool:
                shortcut = _pool(shortcut)
        if window:
            yw, hp, wp = _windows(y, window)
            a = _attention(blk, yw, heads, dout, pool)
            if pool:
                hh, ww, hp, wp = hh // 2, ww // 2, hp // 2, wp // 2
            a = _unwindow(a, b, hp, wp, hh, ww)
        else:
            a = _attention(blk, y, heads, dout, pool)
        x = shortcut + a
        y = nn.layer_norm(blk["ln2"], x, eps)
        x = x + nn.linear(blk["fc2"], F.gelu(nn.linear(blk["fc1"], y)))
        if i in ends:
            outs.append(x)
    return outs


def neck(p: Params, feats: List[torch.Tensor]) -> List[torch.Tensor]:
    """The FPN neck: a 1x1 lateral conv a level, the levels in TOP_DOWN
    adding the level below them upsampled 2x (nearest); the stride-32
    level dropped. Returns the strides 4, 8 and 16."""
    n = len(feats) - 1
    out: List[Any] = [None] * len(feats)
    prev = None
    for i in range(n, -1, -1):
        lateral = nn.conv2d(p["neck"][n - i], feats[i], padding=0)
        if i in TOP_DOWN and prev is not None:
            up = prev.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
            lateral = lateral + up
        prev = out[i] = lateral
    return out[:-1]
