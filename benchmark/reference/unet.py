"""SD1.5 UNet of MIMO in plain float32: the reference UNet (2D, writes the
attention banks) and the denoising UNet (3D: banked self-attention for the
cond half under CFG, single-token cross-attention, AnimateDiff motion
modules). Feature maps are (N, H, W, C) with frames folded into N.

The configuration is the ``unet`` dict of a benchmark configuration file
(``benchmark/configs/*.json``), the parameter tree the one
``reference/params.py`` lays out.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import torch

from benchmark.reference import nn

Params = Dict[str, Any]


def resnet(p: Params, x: torch.Tensor, temb: Optional[torch.Tensor],
           groups: int, eps: float) -> torch.Tensor:
    h = nn.group_norm(p["norm1"], x, groups, eps, silu=True)
    h = nn.conv2d(p["conv1"], h, padding=1)
    t = None
    if temb is not None and "temb_proj" in p:
        t = nn.linear(p["temb_proj"], torch.nn.functional.silu(temb))
    h = nn.group_norm(p["norm2"], h, groups, eps, silu=True, row_add=t)
    h = nn.conv2d(p["conv2"], h, padding=1)
    if "shortcut" in p:
        x = nn.conv2d(p["shortcut"], x, padding=0)
    return x.float() + h


def _qkv(attn: Params, x: torch.Tensor, kind: Optional[str]):
    """q, k, v of bias-free projections as one (C, 3C) product."""
    w = torch.cat([attn[k]["kernel"] for k in ("to_q", "to_k", "to_v")],
                  dim=1)
    return nn.matmul(x, w, kind).chunk(3, dim=-1)


def spatial_transformer(p: Params, x: torch.Tensor, ctx: torch.Tensor,
                        cfg: Dict[str, Any],
                        bank_out: Optional[List[torch.Tensor]] = None,
                        bank_in: Optional[torch.Tensor] = None,
                        cfg_split: bool = False) -> torch.Tensor:
    """bank_out: the normed tokens before self-attention are appended
    (reference UNet). bank_in: (Lb, C) cond-bank tokens that the cond half
    (the second half of the batch under cfg_split) attends over beside its
    own."""
    n, hgt, wid, c = x.shape
    heads = cfg["num_heads"]
    h = nn.group_norm(p["norm"], x, cfg["norm_num_groups"], 1e-6)
    tokens = nn.conv2d(p["proj_in"], h, padding=0).reshape(n, hgt * wid, c)

    attn = p["attn1"]
    write = bank_out is not None
    norm1 = nn.layer_norm(p["norm1"], tokens)
    if write:
        bank_out.append(norm1)
    q, k, v = _qkv(attn, norm1, None if write else "qkv")
    if bank_in is None:
        o = nn.attention(q, k, v, heads)
    else:
        kb = nn.linear(attn["to_k"], bank_in[None])
        vb = nn.linear(attn["to_v"], bank_in[None])
        half = n // 2 if cfg_split else 0
        parts = [nn.attention(q[:half], k[:half], v[:half], heads)] \
            if half else []
        parts.append(nn.attention(q[half:], k[half:], v[half:], heads,
                                  kb, vb))
        o = torch.cat(parts, dim=0)
    tokens = tokens + nn.linear(attn["to_out"], o,
                                None if write else "out_res", res=True)
    # cross-attention over one CLIP token: softmax over one key is 1
    a2 = p["attn2"]
    tokens = tokens + nn.linear(a2["to_out"], nn.linear(a2["to_v"], ctx))
    tokens = nn.geglu_ff(p["ff"], nn.layer_norm(p["norm3"], tokens), tokens,
                         "ff")
    h = nn.conv2d(p["proj_out"], tokens.reshape(n, hgt, wid, c), padding=0)
    return h + x.float()


def temporal_pe(f: int, dim: int, device) -> torch.Tensor:
    position = torch.arange(f, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32,
                                 device=device) * (-math.log(10000.0) / dim))
    pe = torch.zeros((f, dim), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(position * div)
    pe[:, 1::2] = torch.cos(position * div)
    return pe


def temporal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       heads: int) -> torch.Tensor:
    """F×F softmax attention at every (b, s, head); (B, F, S, C) in and
    out."""
    b, f, s, c = q.shape
    d = c // heads
    nn._record(op="tattn", b=b, f=f, s=s, heads=heads, d=d)

    def split(t):
        return nn._op(t).reshape(b, f, s, heads, d)

    logits = torch.einsum("bfshd,bgshd->bshfg", split(q), split(k))
    w = torch.softmax(logits / math.sqrt(d), dim=-1)
    o = torch.einsum("bshfg,bgshd->bfshd", nn._op(w), split(v))
    return o.reshape(b, f, s, c)


def motion_module(p: Params, x: torch.Tensor, frames: int,
                  mcfg: Dict[str, Any]) -> torch.Tensor:
    """AnimateDiff's temporal transformer over the frame axis of
    (B·F, H, W, C); the PE is added to the normed states."""
    n, hgt, wid, c = x.shape
    b = n // frames
    heads = mcfg["num_heads"]
    h = nn.group_norm(p["norm"], x, mcfg["norm_num_groups"], 1e-6)
    tokens = nn.linear(p["proj_in"], h.reshape(b, frames, hgt * wid, c),
                       "proj_in")
    pe = temporal_pe(frames, c, x.device)[None, :, None, :]
    for blk in p["blocks"]:
        for a in blk["attns"]:
            normed = nn.layer_norm(a["norm"], tokens) + pe
            q, k, v = _qkv(a["attn"], normed, "t_qkv")
            o = temporal_attention(q, k, v, heads)
            tokens = tokens + nn.linear(a["attn"]["to_out"], o, "t_out_res",
                                        res=True)
        tokens = nn.geglu_ff(blk["ff"], nn.layer_norm(blk["ff_norm"], tokens),
                             tokens, "ff")
    out = x.float().reshape(b, frames, hgt * wid, c) + nn.linear(
        p["proj_out"], tokens, "proj_out_res", res=True)
    return out.reshape(n, hgt, wid, c)


def _time_embedding(p: Params, cfg: Dict[str, Any], t: float, batch: int,
                    device) -> torch.Tensor:
    tt = torch.full((batch,), float(t), dtype=torch.float32, device=device)
    emb = nn.timestep_embedding(tt, cfg["block_out_channels"][0],
                                cfg["flip_sin_to_cos"], cfg["freq_shift"])
    tm = p["time_mlp"]
    return nn.linear(tm["fc2"], torch.nn.functional.silu(
        nn.linear(tm["fc1"], emb)))


def _core(p: Params, cfg: Dict[str, Any], h: torch.Tensor,
          temb: torch.Tensor, ctx: torch.Tensor, frames: int,
          banks_out: Optional[List[torch.Tensor]],
          banks_in: Optional[List[torch.Tensor]], cfg_split: bool,
          head: bool) -> torch.Tensor:
    g, eps = cfg["norm_num_groups"], cfg["norm_eps"]
    mm = cfg["use_motion_module"]
    banks = iter(banks_in) if banks_in is not None else None

    def transformer(ap, h):
        return spatial_transformer(
            ap, h, ctx, cfg, bank_out=banks_out,
            bank_in=next(banks) if banks is not None else None,
            cfg_split=cfg_split)

    skips = [h]
    for blk in p["down"]:
        for j, rp in enumerate(blk["resnets"]):
            h = resnet(rp, h, temb, g, eps)
            if blk["attns"] is not None:
                h = transformer(blk["attns"][j], h)
            if mm and blk["motions"] is not None:
                h = motion_module(blk["motions"][j], h, frames, cfg["motion"])
            skips.append(h)
        if blk["downsample"] is not None:
            h = nn.conv2d(blk["downsample"], h, stride=2, padding=1)
            skips.append(h)

    mid = p["mid"]
    h = resnet(mid["resnets"][0], h, temb, g, eps)
    h = transformer(mid["attns"][0], h)
    if mm and mid["motions"] is not None:
        h = motion_module(mid["motions"][0], h, frames, cfg["motion"])
    h = resnet(mid["resnets"][1], h, temb, g, eps)

    for blk in p["up"]:
        for j, rp in enumerate(blk["resnets"]):
            h = torch.cat([h, skips.pop().float()], dim=-1)
            h = resnet(rp, h, temb, g, eps)
            if blk["attns"] is not None:
                h = transformer(blk["attns"][j], h)
            if mm and blk["motions"] is not None:
                h = motion_module(blk["motions"][j], h, frames, cfg["motion"])
        if blk["upsample"] is not None:
            h = nn.upsample_nearest_to(h, skips[-1].shape[1],
                                       skips[-1].shape[2])
            h = nn.conv2d(blk["upsample"], h, padding=1)
    if not head:
        return h
    h = nn.group_norm(p["norm_out"], h, g, eps, silu=True)
    return nn.conv2d(p["conv_out"], h, padding=1)


def unet2d_banks(p: Params, cfg: Dict[str, Any], x: torch.Tensor,
                 ctx: torch.Tensor) -> List[torch.Tensor]:
    """The reference UNet at t = 0: x (B, H, W, 4), ctx (B, 1, 768) ->
    the bank of each spatial transformer, (B, S, C), in block order."""
    banks: List[torch.Tensor] = []
    temb = _time_embedding(p, cfg, 0.0, x.shape[0], x.device)
    h = nn.conv2d(p["conv_in"], x, padding=1)
    _core(p, cfg, h, temb, ctx, 1, banks, None, False, head=False)
    return banks


def unet3d(p: Params, cfg: Dict[str, Any], x: torch.Tensor, t: float,
           ctx: torch.Tensor, pose_fea: torch.Tensor,
           banks: List[torch.Tensor], cfg_split: bool) -> torch.Tensor:
    """The denoising UNet: x (B, F, H, W, 8), ctx (B, 1, 768), pose_fea
    (B, F, H, W, 320), banks (S, C) each -> (B, F, H, W, 4)."""
    bsz, frames, hgt, wid, cin = x.shape
    xf = x.reshape(bsz * frames, hgt, wid, cin)
    temb = _time_embedding(p, cfg, t, bsz, x.device).repeat_interleave(
        frames, dim=0)
    ctxf = ctx.float().repeat_interleave(frames, dim=0)
    h = nn.conv2d(p["conv_in"], xf, padding=1)
    h = h + pose_fea.float().reshape(bsz * frames, hgt, wid, -1)
    out = _core(p, cfg, h, temb, ctxf, frames, None, banks, cfg_split,
                head=True)
    return out.reshape(bsz, frames, hgt, wid, -1)
