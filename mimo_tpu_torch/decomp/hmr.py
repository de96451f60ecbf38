"""HMR2 / HaMeR: 3D body and hand parameter regression.

Counterpart of ``mimo_tpu/decomp/hmr.py``: a ViT-H backbone (ViTPose form:
patch padding 4, the cls slot's pos embed on every token; 1280 wide, 32
deep, 16 heads, 256x192 input) and the SMPLTransformerDecoderHead: one
query token cross-attends to the 192 image tokens through 6 pre-norm layers
(packed q|k|v without bias, 8 heads of 64), then linears predict the
change of the pose (6D per joint), the betas and the weak-perspective
camera, added to the mean parameters, ``ief_iters`` times. HaMeR is the
same with MANO's 16 joints.

The token input is ``zero`` (a zero scalar, the published heads) or
``mean_shape`` (the current pose | betas | cam); the MLP's GELU runs in
fp32; the head has no final norm; its outputs, and rot6d -> rotmat, are
fp32 whatever the compute dtype. The person crops are
``decomp.vitpose.square_crop``'s.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict

import torch

from mimo_tpu_torch.decomp.transforms import rot6d_to_rotmat
from mimo_tpu_torch.decomp.vit import (ViTConfig, attention_heads, gelu,
                                       vit_apply, vit_init)
from mimo_tpu_torch.models import layers as L

Params = Dict[str, Any]


@dataclass(frozen=True)
class HMRConfig:
    backbone: ViTConfig = field(default_factory=lambda: ViTConfig(
        img_size=(256, 192), patch_size=16, dim=1280, depth=32,
        num_heads=16, use_cls_token=False, patch_padding=4,
        cls_pos_to_all=True))
    num_joints: int = 24            # SMPL (HaMeR / MANO: 16)
    num_betas: int = 10
    head_dim: int = 1024            # the decoder's width
    head_layers: int = 6
    head_heads: int = 8
    head_dim_head: int = 64         # inner = 512, not head_dim
    mlp_dim: int = 1024
    ief_iters: int = 1
    transformer_input: str = "zero"  # 'zero' | 'mean_shape'


def hamer_config() -> HMRConfig:
    return HMRConfig(num_joints=16)


def tiny_hmr_config(num_joints: int = 5) -> HMRConfig:
    return HMRConfig(
        backbone=ViTConfig(img_size=(32, 32), patch_size=16, dim=32,
                           depth=2, num_heads=4, use_cls_token=False,
                           patch_padding=4, cls_pos_to_all=True),
        num_joints=num_joints, num_betas=4, head_dim=32, head_layers=2,
        head_heads=4, head_dim_head=8, mlp_dim=32, ief_iters=2,
        transformer_input="mean_shape")


def hmr_init(gen: torch.Generator, cfg: HMRConfig,
             dtype: torch.dtype = torch.float32) -> Params:
    d = cfg.head_dim
    inner = cfg.head_heads * cfg.head_dim_head
    npose = cfg.num_joints * 6
    token_dim = npose + cfg.num_betas + 3 \
        if cfg.transformer_input == "mean_shape" else 1
    dev = gen.device

    def lin(d_in, d_out, bias=True):
        return L.linear_init(gen, d_in, d_out, bias=bias, dtype=dtype)

    layers = [{
        "ln1": L.layer_norm_init(d, dtype, dev),
        "qkv": lin(d, 3 * inner, bias=False),
        "attn_out": lin(inner, d),
        "ln2": L.layer_norm_init(d, dtype, dev),
        "to_q": lin(d, inner, bias=False),
        "to_kv": lin(cfg.backbone.dim, 2 * inner, bias=False),
        "cross_out": lin(inner, d),
        "ln3": L.layer_norm_init(d, dtype, dev),
        "fc1": lin(d, cfg.mlp_dim),
        "fc2": lin(cfg.mlp_dim, d),
    } for _ in range(cfg.head_layers)]
    identity6d = torch.tensor([1.0, 0, 0, 0, 1.0, 0], device=dev)
    return {
        "backbone": vit_init(gen, cfg.backbone, dtype),
        "token_embed": lin(token_dim, d),
        "pos_embed": torch.randn((1, d), generator=gen, device=dev).to(dtype),
        "layers": layers,
        "dec_pose": lin(d, npose),
        "dec_betas": lin(d, cfg.num_betas),
        "dec_cam": lin(d, 3),
        # the IEF anchors (the published mean parameters in a converted
        # bundle; identity rotations here)
        "mean_pose": identity6d.repeat(cfg.num_joints).to(dtype),
        "mean_betas": torch.zeros((cfg.num_betas,), dtype=dtype, device=dev),
        "mean_cam": torch.tensor([0.9, 0.0, 0.0], device=dev).to(dtype),
    }


def _head_attn(q_in, kv_in, qkv_or_q, to_kv, out_p, heads, dim_head):
    """Packed self-attention (``to_kv`` None) or cross-attention to
    ``kv_in``: softmax(QK^T / sqrt(dim_head)) V over heads * dim_head."""
    inner = heads * dim_head
    if to_kv is None:
        q, k, v = L.linear(qkv_or_q, q_in).split(inner, dim=-1)
    else:
        q = L.linear(qkv_or_q, q_in)
        k, v = L.linear(to_kv, kv_in).split(inner, dim=-1)
    b, sq, _ = q.shape
    sk = k.shape[1]
    o = attention_heads(q.reshape(b, sq, heads, dim_head),
                        k.reshape(b, sk, heads, dim_head),
                        v.reshape(b, sk, heads, dim_head))
    return L.linear(out_p, o.reshape(b, sq, inner))


def hmr_forward(p: Params, cfg: HMRConfig, crops: torch.Tensor):
    """crops: (B, H, W, 3) ImageNet-normalised, in the compute dtype.
    Returns {pose_rotmats (B, J, 3, 3), betas (B, nb), cam (B, 3)} in fp32;
    cam is the weak-perspective [s, tx, ty] of the crop."""
    B = crops.shape[0]
    ctx = vit_apply(p["backbone"], cfg.backbone, crops)      # (B, S, D)

    pose = p["mean_pose"].float()[None].expand(B, -1)
    betas = p["mean_betas"].float()[None].expand(B, -1)
    cam = p["mean_cam"].float()[None].expand(B, -1)

    for _ in range(cfg.ief_iters):
        if cfg.transformer_input == "mean_shape":
            tok_in = torch.cat([pose, betas, cam], dim=-1)[:, None]
        else:
            tok_in = ctx.new_zeros((B, 1, 1))
        token = L.linear(p["token_embed"], tok_in.to(ctx.dtype))
        token = token + p["pos_embed"].to(token.dtype)[None]
        for blk in p["layers"]:
            y = L.layer_norm(blk["ln1"], token)
            token = token + _head_attn(y, None, blk["qkv"], None,
                                       blk["attn_out"], cfg.head_heads,
                                       cfg.head_dim_head)
            y = L.layer_norm(blk["ln2"], token)
            token = token + _head_attn(y, ctx, blk["to_q"], blk["to_kv"],
                                       blk["cross_out"], cfg.head_heads,
                                       cfg.head_dim_head)
            y = L.layer_norm(blk["ln3"], token)
            token = token + L.linear(blk["fc2"],
                                     gelu(L.linear(blk["fc1"], y)))
        feat = token[:, 0].float()              # no final norm
        pose = pose + L.linear(p["dec_pose"], feat)
        betas = betas + L.linear(p["dec_betas"], feat)
        cam = cam + L.linear(p["dec_cam"], feat)

    rotmats = rot6d_to_rotmat(pose.reshape(B, cfg.num_joints, 6))
    return {"pose_rotmats": rotmats, "betas": betas, "cam": cam}


def cam_crop_to_full(cam: torch.Tensor, center_scale: torch.Tensor,
                     img_w: float, img_h: float,
                     focal: float) -> torch.Tensor:
    """Weak-perspective crop camera (..., 3) [s, tx, ty] and its crop's
    (cx, cy, size) -> the full-image translation (..., 3): t_z = 2 focal /
    (s size), t_xy re-centred on the image."""
    s, tx, ty = cam[..., 0], cam[..., 1], cam[..., 2]
    cx, cy, b = (center_scale[..., 0], center_scale[..., 1],
                 center_scale[..., 2])
    w2, h2 = img_w / 2.0, img_h / 2.0
    bs = b * s + 1e-9
    tz = 2 * focal / bs
    tx_full = (2 * (cx - w2) / bs) + tx
    ty_full = (2 * (cy - h2) / bs) + ty
    return torch.stack([tx_full, ty_full, tz], dim=-1)
