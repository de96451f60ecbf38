"""SD1.5 UNet family: the 2D reference UNet and the 3D denoising UNet share
one parameter layout and one set of block functions.

Counterpart of ``mimo_tpu/models/unet.py`` (same parameter tree, block order
and bank dataflow): ``unet2d_apply`` returns the pre-self-attention hidden
states ("banks"), ``unet3d_apply`` takes them; under CFG the batch is
``[uncond; cond]`` and only the cond half attends over ``[self ‖ bank]``;
cross-attention over a single CLIP token reduces exactly to
``to_out(to_v(ctx))``.

The transformer and motion blocks run through the GEMM-chain ops
(``ops/ffn.py``, ``ops/temporal_attention.py``) wherever the JAX package
calls its fused kernels. Left out here, because they exist for XLA: the SNC
token transposes and ``SNC_TOKEN_PATH``.

Frame-parallel generation (``pipelines/pose2vid.py``) runs every op here
on its rank's frames except the motion modules' temporal attention, which
needs every frame: ``group`` and ``frames_global`` reach
``motion_module_apply``, which swaps frame- for spatial-sharding with one
all-to-all each way (``reshard_mode``) over the ``torch.distributed``
group.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import torch

from mimo_tpu_torch.config import MotionModuleConfig, UNetConfig
from mimo_tpu_torch.models import layers as L
from mimo_tpu_torch.ops.attention import dispatch_sdpa, dispatch_sdpa_banked
from mimo_tpu_torch.ops.ffn import (ffn_ln_geglu_fused, matmul_bias,
                                    matmul_bias_residual, qkv_ln_fused)
from mimo_tpu_torch.ops.temporal_attention import temporal_attention_ln
from mimo_tpu_torch.parallel import comm

Params = Dict[str, Any]

# ---------------------------------------------------------------------------
# resnet block (time-conditioned)
# ---------------------------------------------------------------------------


def resnet_init(gen: torch.Generator, c_in: int, c_out: int,
                temb_dim: Optional[int],
                dtype: torch.dtype = torch.float32) -> Params:
    dev = gen.device
    p = {
        "norm1": L.group_norm_init(c_in, dtype, dev),
        "conv1": L.conv2d_init(gen, 3, 3, c_in, c_out, dtype=dtype),
        "norm2": L.group_norm_init(c_out, dtype, dev),
        "conv2": L.conv2d_init(gen, 3, 3, c_out, c_out, dtype=dtype),
    }
    if temb_dim is not None:
        p["temb_proj"] = L.linear_init(gen, temb_dim, c_out, dtype=dtype)
    if c_in != c_out:
        p["shortcut"] = L.conv2d_init(gen, 1, 1, c_in, c_out, dtype=dtype)
    return p


def resnet_apply(p: Params, x: torch.Tensor, temb: Optional[torch.Tensor],
                 groups: int, eps: float) -> torch.Tensor:
    """x: (N, H, W, C); temb: (N, T) already per-sample."""
    h = L.group_norm(p["norm1"], x, groups, eps, fuse_silu=True)
    h = L.conv2d(p["conv1"], h, padding=1)
    t = None
    if temb is not None and "temb_proj" in p:
        t = L.linear(p["temb_proj"], L.silu(temb))
    h = L.group_norm(p["norm2"], h, groups, eps, fuse_silu=True, row_add=t)
    h = L.conv2d(p["conv2"], h, padding=1)
    if "shortcut" in p:
        x = L.conv2d(p["shortcut"], x, padding=0)
    return x + h


# ---------------------------------------------------------------------------
# spatial transformer
# ---------------------------------------------------------------------------


def spatial_transformer_init(gen: torch.Generator, channels: int,
                             ctx_dim: int,
                             dtype: torch.dtype = torch.float32) -> Params:
    dev = gen.device
    return {
        "norm": L.group_norm_init(channels, dtype, dev),
        "proj_in": L.conv2d_init(gen, 1, 1, channels, channels, dtype=dtype),
        "norm1": L.layer_norm_init(channels, dtype, dev),
        "attn1": L.mha_init(gen, channels, dtype=dtype),
        "norm2": L.layer_norm_init(channels, dtype, dev),
        "attn2": L.mha_init(gen, channels, context_dim=ctx_dim, dtype=dtype),
        "norm3": L.layer_norm_init(channels, dtype, dev),
        "ff": L.geglu_ff_init(gen, channels, dtype=dtype),
        "proj_out": L.conv2d_init(gen, 1, 1, channels, channels, dtype=dtype),
    }


def _attn_banked_qkv(p_attn: Params, q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor, bank: Optional[torch.Tensor],
                     heads: int, cfg_split: bool) -> torch.Tensor:
    """Banked attention over projected q/k/v (N, S, inner), before to_out:
    the cond half of the batch attends over [own tokens ‖ bank tokens].
    bank: (Lb, C) cond bank tokens or None. With cfg_split the first N/2
    rows (uncond) use plain self-attention."""
    if bank is None:
        return dispatch_sdpa(q, k, v, heads)
    kb = L.linear(p_attn["to_k"], bank[None])      # (1, Lb, inner)
    vb = L.linear(p_attn["to_v"], bank[None])
    if not cfg_split:
        return dispatch_sdpa_banked(q, k, v, kb, vb, heads)
    h = q.shape[0] // 2
    return torch.cat([
        dispatch_sdpa(q[:h], k[:h], v[:h], heads),
        dispatch_sdpa_banked(q[h:], k[h:], v[h:], kb, vb, heads),
    ], dim=0)


def _cross_attn_single_token(p_attn: Params,
                             ctx: torch.Tensor) -> torch.Tensor:
    """Softmax over one key is 1, so cross-attention is to_out(to_v(ctx))
    broadcast over queries. ctx: (N, 1, D) -> (N, 1, C)."""
    return L.linear(p_attn["to_out"], L.linear(p_attn["to_v"], ctx))


def spatial_transformer_apply(
    p: Params, x: torch.Tensor, ctx: torch.Tensor, cfg: UNetConfig,
    bank_out: Optional[List[torch.Tensor]] = None,
    bank_in: Optional[torch.Tensor] = None,
    cfg_split: bool = False,
) -> torch.Tensor:
    """x: (N, H, W, C); ctx: (N, Lc, D) CLIP tokens.

    bank_out (write mode, reference UNet): the normed pre-self-attention
    tokens are appended to it. bank_in (read mode, denoiser): (Lb, C) cond
    bank tokens, extra self-attention keys/values for the cond half."""
    n, hgt, wid, c = x.shape
    residual = x
    h = L.group_norm(p["norm"], x, cfg.norm_num_groups, 1e-6)
    h = L.conv2d(p["proj_in"], h, padding=0)
    tokens = h.reshape(n, hgt * wid, c)

    attn = p["attn1"]
    if bank_out is None:
        # LN + q|k|v in one kernel, to_out + residual in another
        q, k, v = qkv_ln_fused(tokens, p["norm1"], attn)
        o = _attn_banked_qkv(attn, q, k, v, bank_in, cfg.num_heads, cfg_split)
        tokens = matmul_bias_residual(o, attn["to_out"], tokens)
    else:
        # reference-write mode needs norm1 materialised for the bank
        norm1 = L.layer_norm(p["norm1"], tokens)
        bank_out.append(norm1)
        q, k, v = (L.linear(attn[name], norm1)
                   for name in ("to_q", "to_k", "to_v"))
        o = _attn_banked_qkv(attn, q, k, v, bank_in, cfg.num_heads, cfg_split)
        tokens = tokens + L.linear(attn["to_out"], o)
    if ctx.shape[1] == 1:
        tokens = tokens + _cross_attn_single_token(p["attn2"], ctx)
    else:
        norm2 = L.layer_norm(p["norm2"], tokens)
        tokens = tokens + L.mha(p["attn2"], norm2, ctx, cfg.num_heads)
    tokens = ffn_ln_geglu_fused(tokens, p["norm3"], p["ff"])

    h = L.conv2d(p["proj_out"], tokens.reshape(n, hgt, wid, c), padding=0)
    return h + residual


# ---------------------------------------------------------------------------
# motion module (AnimateDiff Vanilla temporal transformer)
# ---------------------------------------------------------------------------


def motion_module_init(gen: torch.Generator, channels: int,
                       mcfg: MotionModuleConfig,
                       dtype: torch.dtype = torch.float32) -> Params:
    dev = gen.device
    proj_in = L.linear_init(gen, channels, channels, dtype=dtype)
    blocks = []
    for _ in range(mcfg.num_transformer_blocks):
        attns = [{"norm": L.layer_norm_init(channels, dtype, dev),
                  "attn": L.mha_init(gen, channels, dtype=dtype)}
                 for _ in range(mcfg.attentions_per_block)]
        blocks.append({
            "attns": attns,
            "ff_norm": L.layer_norm_init(channels, dtype, dev),
            "ff": L.geglu_ff_init(gen, channels, dtype=dtype),
        })
    return {
        "norm": L.group_norm_init(channels, dtype, dev),
        "proj_in": proj_in,
        "blocks": blocks,
        # zero-init output projection (reference motion_module.py:72-74)
        "proj_out": {"kernel": torch.zeros((channels, channels), dtype=dtype,
                                           device=dev),
                     "bias": torch.zeros((channels,), dtype=dtype,
                                         device=dev)},
    }


def _temporal_pe(f: int, dim: int, dtype: torch.dtype,
                 device) -> torch.Tensor:
    """Sinusoidal positional encoding (reference motion_module.py:264-279)."""
    position = torch.arange(f, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32,
                                 device=device) * (-math.log(10000.0) / dim))
    ang = position * div
    pe = torch.zeros((f, dim), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(ang)
    pe[:, 1::2] = torch.cos(ang)
    return pe.to(dtype)


def reshard_mode(spatial: int, ndev: int) -> str:
    """Which collective the frame-parallel temporal attention uses to swap
    frame- for spatial-sharding (``mimo_tpu/models/unet.py``'s).

    - "a2a": the spatial positions divide the group: one all-to-all each
      way, every rank keeps 1/n of the work. The production branch: the
      512x784 latent levels give S = 6272 / 1568 / 400 / 104, all divisible
      by 2, 4 and 8.
    - "gather": ragged S (tiny test shapes): all-gather the frames, attend
      over all of them, slice this rank's frames back out.
    """
    return "a2a" if spatial % ndev == 0 else "gather"


def motion_module_apply(p: Params, x: torch.Tensor, frames: int,
                        mcfg: MotionModuleConfig, group=None,
                        frames_global: Optional[int] = None) -> torch.Tensor:
    """x: (B*F, H, W, C) -> same. Temporal self-attention over the frame
    axis at every spatial location; frames stay the second axis of the
    (B, F, S, C) tokens throughout.

    Frame-parallel (``group`` set): x holds this rank's ``frames`` of
    ``frames_global``. The tokens swap the frame axis for the spatial axis
    ((b, F/n, S, c) -> (b, F, S/n, c)) with one all-to-all, the attention
    and FF blocks run over every frame on 1/n of the positions, and a
    second all-to-all swaps back; where S does not divide the group, the
    frames are all-gathered instead and this rank's slice is kept. The PE
    and the attention span ``frames_global``."""
    n, hgt, wid, c = x.shape
    b = n // frames
    h = L.group_norm(p["norm"], x, mcfg.norm_num_groups, 1e-6)
    tokens = matmul_bias(h.reshape(b, frames, hgt * wid, c), p["proj_in"])
    f_attn, mode = frames, None
    if group is not None and frames_global is not None \
            and frames_global != frames:
        f_attn = frames_global
        mode = reshard_mode(hgt * wid, frames_global // frames)
        if mode == "a2a":
            tokens = comm.all_to_all(tokens, group, split_axis=2,
                                     concat_axis=1)
        else:
            tokens = comm.all_gather(tokens, group, axis=1)
    pe = _temporal_pe(f_attn, c, tokens.dtype, tokens.device)
    for blk in p["blocks"]:
        for a in blk["attns"]:
            # tokens + attn(LN(tokens) + pe): the PE is added to the *normed*
            # states before qkv (reference motion_module.py:361-368)
            tokens = temporal_attention_ln(a["attn"], a["norm"], pe, tokens,
                                           mcfg.num_heads)
        tokens = ffn_ln_geglu_fused(tokens, blk["ff_norm"], blk["ff"])
    if mode == "a2a":
        tokens = comm.all_to_all(tokens, group, split_axis=1, concat_axis=2)
    elif mode == "gather":
        i = comm.axis_index(group)
        tokens = tokens[:, i * frames:(i + 1) * frames].contiguous()
    out = matmul_bias_residual(tokens, p["proj_out"],
                               x.reshape(b, frames, hgt * wid, c))
    return out.reshape(n, hgt, wid, c)


# ---------------------------------------------------------------------------
# UNet init (shared 2D/3D layout)
# ---------------------------------------------------------------------------


def unet_init(gen: torch.Generator, cfg: UNetConfig,
              dtype: torch.dtype = torch.float32) -> Params:
    dev = gen.device
    ch = cfg.block_out_channels
    temb_dim = cfg.time_embed_dim
    mm = cfg.use_motion_module

    def maybe_motion(c):
        return motion_module_init(gen, c, cfg.motion, dtype) if mm else None

    p: Params = {
        "conv_in": L.conv2d_init(gen, 3, 3, cfg.in_channels, ch[0],
                                 dtype=dtype),
        "time_mlp": L.time_mlp_init(gen, ch[0], temb_dim, dtype=dtype),
    }

    down = []
    c_prev = ch[0]
    for i, c_out in enumerate(ch):
        is_last = i == len(ch) - 1
        has_attn = cfg.cross_attn_blocks[i]
        blk: Params = {"resnets": [], "attns": [] if has_attn else None,
                       "motions": [] if mm else None}
        c_in = c_prev
        for _ in range(cfg.layers_per_block):
            blk["resnets"].append(resnet_init(gen, c_in, c_out, temb_dim,
                                              dtype))
            c_in = c_out
            if has_attn:
                blk["attns"].append(spatial_transformer_init(
                    gen, c_out, cfg.cross_attention_dim, dtype))
            if mm:
                blk["motions"].append(maybe_motion(c_out))
        blk["downsample"] = (None if is_last else
                             L.conv2d_init(gen, 3, 3, c_out, c_out,
                                           dtype=dtype))
        down.append(blk)
        c_prev = c_out
    p["down"] = down

    c_mid = ch[-1]
    p["mid"] = {
        "resnets": [resnet_init(gen, c_mid, c_mid, temb_dim, dtype),
                    resnet_init(gen, c_mid, c_mid, temb_dim, dtype)],
        "attns": [spatial_transformer_init(gen, c_mid,
                                           cfg.cross_attention_dim, dtype)],
        "motions": ([maybe_motion(c_mid)]
                    if (mm and cfg.motion_module_mid_block) else None),
    }

    up = []
    rev = list(reversed(ch))
    rev_attn = list(reversed(cfg.cross_attn_blocks))
    c_prev = ch[-1]
    for i, c_out in enumerate(rev):
        is_last = i == len(rev) - 1
        has_attn = rev_attn[i]
        skip_src = [rev[min(i + 1, len(rev) - 1)] if j == cfg.layers_per_block
                    else c_out for j in range(cfg.layers_per_block + 1)]
        blk = {"resnets": [], "attns": [] if has_attn else None,
               "motions": [] if mm else None}
        c_in = c_prev
        for j in range(cfg.layers_per_block + 1):
            blk["resnets"].append(resnet_init(gen, c_in + skip_src[j], c_out,
                                              temb_dim, dtype))
            c_in = c_out
            if has_attn:
                blk["attns"].append(spatial_transformer_init(
                    gen, c_out, cfg.cross_attention_dim, dtype))
            if mm:
                blk["motions"].append(maybe_motion(c_out))
        blk["upsample"] = (None if is_last else
                           L.conv2d_init(gen, 3, 3, c_out, c_out,
                                         dtype=dtype))
        up.append(blk)
        c_prev = c_out
    p["up"] = up

    p["norm_out"] = L.group_norm_init(ch[0], dtype, dev)
    p["conv_out"] = L.conv2d_init(gen, 3, 3, ch[0], cfg.out_channels,
                                  dtype=dtype)
    return p


# ---------------------------------------------------------------------------
# shared forward core
# ---------------------------------------------------------------------------


def _time_embedding(p: Params, cfg: UNetConfig, t: torch.Tensor, batch: int,
                    dtype: torch.dtype, device) -> torch.Tensor:
    t = torch.as_tensor(t, device=device).reshape(-1).expand(batch)
    emb = L.sinusoidal_timestep_embedding(
        t, cfg.block_out_channels[0], cfg.flip_sin_to_cos, cfg.freq_shift)
    return L.time_mlp(p["time_mlp"], emb.to(dtype))


# Test-only activation tap: when set to a callable, _unet_core calls it with
# (name, tensor) after every down block, the mid and every up block.
# Production code never sets it.
_TAP = None


def _tap(name: str, h: torch.Tensor) -> None:
    if _TAP is not None:
        _TAP(name, h)


def _unet_core(p: Params, cfg: UNetConfig, h: torch.Tensor,
               temb: torch.Tensor, ctx: torch.Tensor, frames: int,
               banks_out: Optional[List[torch.Tensor]],
               banks_in: Optional[List[torch.Tensor]],
               cfg_split: bool, skip_out_head: bool, group=None,
               frames_global: Optional[int] = None) -> torch.Tensor:
    """down → mid → up [→ head] on h = conv_in(x) [+ pose];
    h: (N, H, W, C0) with N = B*frames (``group``, ``frames_global``: see
    ``motion_module_apply``)."""
    g, eps = cfg.norm_num_groups, cfg.norm_eps
    mm = cfg.use_motion_module
    banks = iter(banks_in) if banks_in is not None else None

    def next_bank():
        return next(banks) if banks is not None else None

    skips = [h]
    for blk in p["down"]:
        for j, rp in enumerate(blk["resnets"]):
            h = resnet_apply(rp, h, temb, g, eps)
            if blk["attns"] is not None:
                h = spatial_transformer_apply(
                    blk["attns"][j], h, ctx, cfg, bank_out=banks_out,
                    bank_in=next_bank(), cfg_split=cfg_split)
            if mm and blk["motions"] is not None:
                h = motion_module_apply(blk["motions"][j], h, frames,
                                        cfg.motion, group, frames_global)
            skips.append(h)
        if blk["downsample"] is not None:
            h = L.conv2d(blk["downsample"], h, stride=2, padding=1)
            skips.append(h)
        _tap(f"down{len(skips)}", h)

    mid = p["mid"]
    h = resnet_apply(mid["resnets"][0], h, temb, g, eps)
    h = spatial_transformer_apply(mid["attns"][0], h, ctx, cfg,
                                  bank_out=banks_out, bank_in=next_bank(),
                                  cfg_split=cfg_split)
    if mm and mid["motions"] is not None:
        h = motion_module_apply(mid["motions"][0], h, frames, cfg.motion,
                                group, frames_global)
    h = resnet_apply(mid["resnets"][1], h, temb, g, eps)
    _tap("mid", h)

    for blk in p["up"]:
        for j, rp in enumerate(blk["resnets"]):
            h = torch.cat([h, skips.pop()], dim=-1)
            h = resnet_apply(rp, h, temb, g, eps)
            if blk["attns"] is not None:
                h = spatial_transformer_apply(
                    blk["attns"][j], h, ctx, cfg, bank_out=banks_out,
                    bank_in=next_bank(), cfg_split=cfg_split)
            if mm and blk["motions"] is not None:
                h = motion_module_apply(blk["motions"][j], h, frames,
                                        cfg.motion, group, frames_global)
        if blk["upsample"] is not None:
            # target the next skip's spatial dims (odd sizes: 13→25)
            h = L.upsample_nearest_to(h, skips[-1].shape[1],
                                      skips[-1].shape[2])
            h = L.conv2d(blk["upsample"], h, padding=1)
        _tap(f"up{len(skips)}", h)

    if skip_out_head:
        return h
    h = L.group_norm(p["norm_out"], h, g, eps, fuse_silu=True)
    return L.conv2d(p["conv_out"], h, padding=1)


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------


def unet2d_apply(p: Params, cfg: UNetConfig, x: torch.Tensor, t,
                 ctx: torch.Tensor) -> List[torch.Tensor]:
    """Reference-UNet role: x (B, H, W, 4), ctx (B, 1, 768). Returns the bank
    tensors (one per spatial transformer, structural order), each
    (B, S_block, C_block). The output head is skipped."""
    banks: List[torch.Tensor] = []
    temb = _time_embedding(p, cfg, t, x.shape[0], x.dtype, x.device)
    h = L.conv2d(p["conv_in"], x, padding=1)
    _unet_core(p, cfg, h, temb, ctx, frames=1, banks_out=banks,
               banks_in=None, cfg_split=False, skip_out_head=True)
    return banks


def unet3d_apply(p: Params, cfg: UNetConfig, x: torch.Tensor, t,
                 ctx: torch.Tensor, pose_fea: Optional[torch.Tensor],
                 banks: Optional[List[torch.Tensor]],
                 cfg_split: bool = False, group=None,
                 frames_global: Optional[int] = None) -> torch.Tensor:
    """Denoising-UNet role. x: (B, F, H, W, Cin); t: scalar timestep;
    ctx: (B, 1, 768); pose_fea: (B, F, H, W, 320) or None; banks: list of
    (S_block, C_block) cond banks or None. Returns (B, F, H, W, out).
    Frame-parallel: x holds this rank's F of ``frames_global`` frames and
    ``group`` is the frame axis's process group."""
    bsz, frames, hgt, wid, cin = x.shape
    xf = x.reshape(bsz * frames, hgt, wid, cin)
    temb = _time_embedding(p, cfg, t, bsz, x.dtype, x.device)
    temb = temb.repeat_interleave(frames, dim=0)
    ctxf = ctx.repeat_interleave(frames, dim=0)

    h = L.conv2d(p["conv_in"], xf, padding=1)
    if pose_fea is not None:
        h = h + pose_fea.reshape(bsz * frames, hgt, wid, -1).to(h.dtype)

    out = _unet_core(p, cfg, h, temb, ctxf, frames=frames, banks_out=None,
                     banks_in=banks, cfg_split=cfg_split, skip_out_head=False,
                     group=group, frames_global=frames_global)
    return out.reshape(bsz, frames, hgt, wid, cfg.out_channels)


def num_banks(cfg: UNetConfig) -> int:
    """Number of spatial-transformer banks (16 for SD1.5 topology)."""
    n = sum(cfg.layers_per_block for has in cfg.cross_attn_blocks if has) + 1
    return n + sum(cfg.layers_per_block + 1
                   for has in reversed(cfg.cross_attn_blocks) if has)
