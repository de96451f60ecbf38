"""ProPainter video inpainting, the background stage's model.

Counterpart of ``mimo_tpu/decomp/propainter.py`` (the reference's
``ProPainter``), in the JAX package's parameter tree and order:

- the recurrent flow completion net: the P3D encoder (a spatial conv and a
  dilated temporal conv), the dilated mid block, the second-order
  deformable-alignment propagation both ways, the align-corners decoder,
  and ``forward_bidirect_flow`` with its combine;
- image propagation along the completed flows with the forward-backward
  consistency check (only the forward pass's output is used, as in the
  reference, so the backward pass is not run);
- the inpainting generator: the grouped-conv encoder, flow-guided learnable
  feature propagation, soft split / soft composition (``F.unfold`` /
  ``F.fold``), the sparse window transformer (window, rolled-ring and
  pooled global keys; the masked windows attend over the kept frames, the
  others within their frame) with the fusion feed-forward, and the
  decoder;
- ``inpaint_video``, the reference's ``process`` orchestration: RAFT in
  width-dependent clips, flow completion in chunks with 5-frame pads, image
  propagation in chunks with 10-frame pads, and the sliding neighbour /
  reference window blended 0.5 / 0.5 on the device. Its chunk rules change
  its output and are the JAX package's.

The recurrences are Python loops where the JAX package scans; the masked /
unmasked window split is both paths and a per-window select, as written
there. Every ``jax.image.resize`` goes through ``decomp/vit.py``'s copy of
its semantics (antialiased when shrinking), nearest through
``F.interpolate(mode="nearest-exact")``, which samples where it does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mimo_tpu_torch.decomp.vit import resize_images
from mimo_tpu_torch.models import layers as L
from mimo_tpu_torch.ops.sampling import (deform_conv2d, deform_conv2d_window,
                                         flow_warp)

Params = Dict[str, Any]


@dataclass(frozen=True)
class ProPainterConfig:
    channel: int = 128          # generator feature channels at 1/4 res
    hidden: int = 512           # transformer token dim
    fc_dim: int = 32            # flow-completion base channels
    kernel: Tuple[int, int] = (7, 7)
    stride: Tuple[int, int] = (3, 3)
    padding: Tuple[int, int] = (3, 3)
    window: Tuple[int, int] = (5, 9)
    pool: Tuple[int, int] = (4, 4)
    depths: int = 8
    heads: int = 4
    ffn_hidden: int = 1960      # 49 * 40 (folds to a 40-ch map)
    deform_groups: int = 16
    t_dilation: int = 2
    neighbor_length: int = 10
    ref_stride: int = 10
    subvideo_length: int = 80
    raft_iters: int = 20


def tiny_propainter_config() -> ProPainterConfig:
    return ProPainterConfig(channel=16, hidden=32, fc_dim=8,
                            kernel=(3, 3), stride=(2, 2), padding=(1, 1),
                            window=(2, 3), pool=(2, 2), depths=2, heads=2,
                            ffn_hidden=9 * 4, deform_groups=4,
                            neighbor_length=4, ref_stride=4,
                            subvideo_length=8, raft_iters=2)


def _lrelu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    return F.leaky_relu(x, slope)


def _conv_init(gen, kh, kw, c_in, c_out, dtype, **opts):
    return L.conv2d_init(gen, kh, kw, c_in, c_out, dtype=dtype, **opts)


# ---------------------------------------------------------------------------
# deformable alignment modules
# ---------------------------------------------------------------------------


def _offset_stack_init(gen, c_in: int, c: int, groups: int, dtype) -> Params:
    """conv_offset: 4 convs, the last zero-initialised."""
    return {"c1": _conv_init(gen, 3, 3, c_in, c, dtype),
            "c2": _conv_init(gen, 3, 3, c, c, dtype),
            "c3": _conv_init(gen, 3, 3, c, c, dtype),
            "c4": _conv_init(gen, 3, 3, c, 27 * groups, dtype, zero=True)}


def _offset_stack(p: Params, x: torch.Tensor) -> torch.Tensor:
    h = F.leaky_relu(L.conv2d(p["c1"], x, padding=1), 0.1)
    h = F.leaky_relu(L.conv2d(p["c2"], h, padding=1), 0.1)
    h = F.leaky_relu(L.conv2d(p["c3"], h, padding=1), 0.1)
    return L.conv2d(p["c4"], h, padding=1)


def _deform_align_init(gen, c_in: int, c_out: int, cond_in: int, groups: int,
                       dtype) -> Params:
    offset = _offset_stack_init(gen, cond_in, c_out, groups, dtype)
    kernel = _conv_init(gen, 3, 3, c_in, c_out, dtype, bias=False)["kernel"]
    return {"offset": offset, "kernel": kernel,
            "bias": torch.zeros((c_out,), dtype=dtype, device=gen.device)}


def _deform_align(p: Params, x: torch.Tensor, cond: torch.Tensor,
                  groups: int, max_residue: float,
                  flow: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(Second-order) deformable alignment: offsets and modulation from the
    offset stack, offset = max_residue * tanh(cat(o1, o2)), plus the flow
    prior's (dy, dx) at every (group, tap) for the generator's variant."""
    out = _offset_stack(p["offset"], cond)
    n = out.shape[-1] // 3
    o1, o2, mask = out[..., :n], out[..., n:2 * n], out[..., 2 * n:]
    offset = max_residue * torch.tanh(torch.cat([o1, o2], dim=-1))
    if flow is not None:
        fl = flow.flip(-1)
        offset = offset + fl.repeat(1, 1, 1, offset.shape[-1] // 2)
        return deform_conv2d(x, offset, p["kernel"], p["bias"],
                             mask=torch.sigmoid(mask), deform_groups=groups)
    return deform_conv2d_window(x, offset, p["kernel"], p["bias"],
                                mask=torch.sigmoid(mask),
                                deform_groups=groups,
                                max_abs_offset=max_residue)


# ---------------------------------------------------------------------------
# flow completion net
# ---------------------------------------------------------------------------


def _p3d_init(gen, c_in: int, c_out: int, dtype) -> Params:
    dev = gen.device
    return {"spatial": _conv_init(gen, 3, 3, c_in, c_out, dtype),
            # temporal conv: kernel 3, dilation 2, stored (3, C, C)
            "temporal": {
                "kernel": (torch.randn((3, c_out, c_out), generator=gen,
                                       device=dev)
                           * (1.0 / math.sqrt(3 * c_out))).to(dtype),
                "bias": torch.zeros((c_out,), dtype=dtype, device=dev)}}


def _temporal_conv(p: Params, x: torch.Tensor,
                   dilation: int = 2) -> torch.Tensor:
    """Conv over the frame axis: kernel 3, dilation 2, zero padding 2.
    x: (T, h, w, c)."""
    k = p["kernel"].to(x.dtype)
    t = x.shape[0]
    xp = F.pad(x, (0, 0, 0, 0, 0, 0, dilation, dilation))
    out = (xp[:t] @ k[0] + xp[dilation:dilation + t] @ k[1]
           + xp[2 * dilation:2 * dilation + t] @ k[2])
    return out + p["bias"].to(x.dtype)


def _p3d(p: Params, x: torch.Tensor, stride: int) -> torch.Tensor:
    h = _lrelu(L.conv2d(p["spatial"], x, stride=stride, padding=1))
    return _temporal_conv(p["temporal"], h)


def flow_complete_init(gen, cfg: ProPainterConfig,
                       dtype: torch.dtype = torch.float32) -> Params:
    b = cfg.fc_dim
    g = cfg.deform_groups

    def conv(kh, kw, ci, co):
        return _conv_init(gen, kh, kw, ci, co, dtype)

    def bidir_prop(c):
        return {
            "align_bwd": _deform_align_init(gen, 2 * c, c, 3 * c, g, dtype),
            "align_fwd": _deform_align_init(gen, 2 * c, c, 3 * c, g, dtype),
            "backbone_bwd": [conv(3, 3, 2 * c, c), conv(3, 3, c, c)],
            "backbone_fwd": [conv(3, 3, 3 * c, c), conv(3, 3, c, c)],
            "fusion": conv(1, 1, 2 * c, c),
        }

    return {
        "down": conv(5, 5, 3, b),
        "enc1a": _p3d_init(gen, b, b, dtype),
        "enc1b": _p3d_init(gen, b, 2 * b, dtype),
        "enc2a": _p3d_init(gen, 2 * b, 2 * b, dtype),
        "enc2b": _p3d_init(gen, 2 * b, 4 * b, dtype),
        "mid": [conv(3, 3, 4 * b, 4 * b) for _ in range(3)],
        "prop": bidir_prop(4 * b),
        "dec2": [conv(3, 3, 4 * b, 4 * b), conv(3, 3, 4 * b, 2 * b)],
        "dec1": [conv(3, 3, 2 * b, 2 * b), conv(3, 3, 2 * b, b)],
        "up": [conv(3, 3, b, b), conv(3, 3, b, 2)],
    }


def _align_corners_2x(x: torch.Tensor) -> torch.Tensor:
    """Bilinear 2x with align_corners=True. x: (T, h, w, c)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2,
                      mode="bilinear", align_corners=True)
    return y.permute(0, 2, 3, 1)


def _dilated_conv(p: Params, x: torch.Tensor, dil: int) -> torch.Tensor:
    """3x3 conv with dilation and padding ``dil``."""
    y = F.conv2d(x.permute(0, 3, 1, 2), p["kernel"].to(x.dtype),
                 p["bias"].to(x.dtype), padding=dil, dilation=dil)
    return y.permute(0, 2, 3, 1)


def _second_order_prop(p: Params, x: torch.Tensor, reverse: bool,
                       groups: int, extra: Optional[torch.Tensor] = None,
                       backbone_key: str = "", align_key: str = ""):
    """One direction of the flow net's propagation: second-order deformable
    alignment with cond = [prev1, current, prev2], then the backbone.
    x: (T, h, w, c); ``extra`` (T, h, w, c): the other direction's
    features (the forward pass reads the backward outputs)."""
    t = x.shape[0]
    order = range(t - 1, -1, -1) if reverse else range(t)
    prev1 = torch.zeros_like(x[0])
    prev2 = torch.zeros_like(x[0])
    bb = p[backbone_key]
    outs: List[Optional[torch.Tensor]] = [None] * t
    for i, idx in enumerate(order):
        cur = x[idx]
        if i > 0:
            cond = torch.cat([prev1, cur, prev2], dim=-1)
            xx = torch.cat([prev1, prev2], dim=-1)
            feat_prop = _deform_align(p[align_key], xx[None], cond[None],
                                      groups, 5.0)[0]
        else:
            feat_prop = torch.zeros_like(cur)
        parts = [cur, feat_prop] if extra is None \
            else [cur, extra[idx], feat_prop]
        feat = torch.cat(parts, dim=-1)[None]
        r = F.leaky_relu(L.conv2d(bb[0], feat, padding=1), 0.1)
        feat_prop = (feat_prop + L.conv2d(bb[1], r, padding=1)[0]
                     ).to(cur.dtype)
        outs[idx] = feat_prop
        prev1, prev2 = feat_prop, prev1
    return torch.stack(outs)


def flow_complete_forward(p: Params, cfg: ProPainterConfig,
                          masked_flows: torch.Tensor,
                          masks: torch.Tensor) -> torch.Tensor:
    """The flow completion net. masked_flows: (T, H, W, 2); masks: (T, H,
    W, 1). Returns the predicted flow (T, H, W, 2)."""
    g = cfg.deform_groups
    x = torch.cat([masked_flows, masks], dim=-1)
    xp = F.pad(x.permute(0, 3, 1, 2), (2, 2, 2, 2),
               mode="replicate").permute(0, 2, 3, 1)
    h0 = _lrelu(L.conv2d(p["down"], xp, stride=2, padding=0))

    e1 = _lrelu(_p3d(p["enc1a"], h0, 1))
    e1 = _lrelu(_p3d(p["enc1b"], e1, 2))          # 4x
    e2 = _lrelu(_p3d(p["enc2a"], e1, 1))
    e2 = _lrelu(_p3d(p["enc2b"], e2, 2))          # 8x

    m = e2
    for conv, dil in zip(p["mid"], (3, 2, 1)):
        m = _lrelu(_dilated_conv(conv, m, dil))

    pr = p["prop"]
    f_b = _second_order_prop(pr, m, True, g, backbone_key="backbone_bwd",
                             align_key="align_bwd")
    f_f = _second_order_prop(pr, m, False, g, extra=f_b,
                             backbone_key="backbone_fwd",
                             align_key="align_fwd")
    fused = L.conv2d(pr["fusion"], torch.cat([f_b, f_f], -1),
                     padding=0) + m

    d2 = _lrelu(L.conv2d(p["dec2"][0], fused, padding=1))
    d2 = _lrelu(L.conv2d(p["dec2"][1], _align_corners_2x(d2), padding=1))
    d2 = d2 + e1
    d1 = _lrelu(L.conv2d(p["dec1"][0], d2, padding=1))
    d1 = _lrelu(L.conv2d(p["dec1"][1], _align_corners_2x(d1), padding=1))
    u = _lrelu(L.conv2d(p["up"][0], d1, padding=1))
    return L.conv2d(p["up"][1], _align_corners_2x(u), padding=1)


def forward_bidirect_flow(p: Params, cfg: ProPainterConfig,
                          flows_f: torch.Tensor, flows_b: torch.Tensor,
                          masks: torch.Tensor):
    """Completed flows both ways, combined with the known ones outside the
    masks. flows_f / flows_b: (T-1, H, W, 2); masks: (T, H, W, 1)."""
    m_f = masks[:-1]
    m_b = masks[1:]
    pred_f = flow_complete_forward(p, cfg, flows_f * (1 - m_f), m_f)
    pred_b = flow_complete_forward(p, cfg, (flows_b * (1 - m_b)).flip(0),
                                   m_b.flip(0)).flip(0)
    return (pred_f * m_f + flows_f * (1 - m_f),
            pred_b * m_b + flows_b * (1 - m_b))


# ---------------------------------------------------------------------------
# image / feature propagation
# ---------------------------------------------------------------------------


def _length_sq(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.square(x), dim=-1, keepdim=True)


def _fb_consistency(flow_fw: torch.Tensor, flow_bw: torch.Tensor,
                    alpha1: float = 0.01, alpha2: float = 0.5):
    """1 where the forward flow and the warped backward flow cancel."""
    flow_bw_warped = flow_warp(flow_bw[None], flow_fw[None])[0]
    flow_diff = flow_fw + flow_bw_warped
    mag_sq = _length_sq(flow_fw) + _length_sq(flow_bw_warped)
    thresh = alpha1 * mag_sq + alpha2
    return (_length_sq(flow_diff) < thresh).to(flow_fw.dtype)


def _binary(m: torch.Tensor, th: float = 0.1) -> torch.Tensor:
    return (m > th).to(m.dtype)


def img_propagation(frames: torch.Tensor, flows_f: torch.Tensor,
                    flows_b: torch.Tensor, masks: torch.Tensor):
    """Non-learnable propagation, the forward pass (the one whose outputs
    the reference keeps): each frame's holes filled from the previous
    frame's propagated pixels warped along the backward flow where the
    flows are consistent. frames: (T, H, W, 3) masked frames; flows_f/b:
    (T-1, H, W, 2); masks: (T, H, W, 1), 1 = hole. Returns (frames,
    updated masks)."""
    feats, ms = [frames[0]], [masks[0]]
    for i in range(1, frames.shape[0]):
        cur, mcur = frames[i], masks[i]
        flow_p, flow_c = flows_b[i - 1], flows_f[i - 1]
        valid = _fb_consistency(flow_p, flow_c)
        warped = flow_warp(feats[-1][None], flow_p[None])[0]
        mask_warped = _binary(flow_warp(ms[-1][None], flow_p[None])[0])
        union = _binary(mcur * valid * (1 - mask_warped))
        feats.append((union * warped + (1 - union) * cur).to(cur.dtype))
        ms.append(_binary(mcur * (1 - valid * (1 - mask_warped))
                          ).to(mcur.dtype))
    return torch.stack(feats), torch.stack(ms)


def feat_propagation(p: Params, cfg: ProPainterConfig, feats: torch.Tensor,
                     flows_f: torch.Tensor, flows_b: torch.Tensor,
                     masks2: torch.Tensor) -> torch.Tensor:
    """Learnable propagation at 1/4 resolution: flow-guided deformable
    alignment and the backbone each way, fused with a residual.
    feats: (T, h, w, c); flows at that resolution; masks2: (T, h, w, 2)
    [mask_in, mask_updated]."""
    g = cfg.deform_groups

    def run(reverse: bool) -> torch.Tensor:
        t = feats.shape[0]
        order = list(range(t - 1, -1, -1)) if reverse else list(range(t))
        akey = "align_bwd" if reverse else "align_fwd"
        bb = p["backbone_bwd" if reverse else "backbone_fwd"]
        outs: List[Optional[torch.Tensor]] = [None] * t
        fprop = None
        for i, idx in enumerate(order):
            cur, mcur = feats[idx], masks2[idx]
            if i > 0:
                # traversal step i reads flow slot i - 1 in traversal order
                if reverse:
                    flow_p, flow_c = flows_f[idx], flows_b[idx]
                else:
                    flow_p, flow_c = flows_b[idx - 1], flows_f[idx - 1]
                valid = _fb_consistency(flow_p, flow_c)
                warped = flow_warp(fprop[None], flow_p[None])[0]
                cond = torch.cat([cur, warped, flow_p, valid, mcur], dim=-1)
                fprop = _deform_align(p[akey], fprop[None], cond[None], g,
                                      3.0, flow=flow_p[None])[0]
            else:
                fprop = cur
            feat = torch.cat([cur, fprop, mcur], dim=-1)[None]
            r = _lrelu(L.conv2d(bb[0], feat, padding=1))
            fprop = (fprop + L.conv2d(bb[1], r, padding=1)[0]).to(cur.dtype)
            outs[idx] = fprop
        return torch.stack(outs)

    outs_b = run(True)
    outs_f = run(False)
    cat = torch.cat([outs_b, outs_f, masks2], dim=-1)
    fz = p["fuse"]
    r = _lrelu(L.conv2d(fz[0], cat, padding=1))
    return L.conv2d(fz[1], r, padding=1) + feats


# ---------------------------------------------------------------------------
# soft split / comp (overlapping unfold / fold) and the fusion FF
# ---------------------------------------------------------------------------


def _unfold(x: torch.Tensor, kernel, stride, padding) -> torch.Tensor:
    """torch.nn.Unfold over (T, H, W, C) -> (T, oh, ow, C*kh*kw), columns
    channel-major."""
    t, h, w, _ = x.shape
    kh, kw = kernel
    oh = (h + 2 * padding[0] - kh) // stride[0] + 1
    ow = (w + 2 * padding[1] - kw) // stride[1] + 1
    cols = F.unfold(x.permute(0, 3, 1, 2), kernel, padding=padding,
                    stride=stride)
    return cols.transpose(1, 2).reshape(t, oh, ow, -1)


def _fold(cols: torch.Tensor, out_hw, kernel, stride,
          padding) -> torch.Tensor:
    """F.fold of (T, oh, ow, C*kh*kw) channel-major columns -> (T, H, W,
    C), overlaps summed."""
    t, oh, ow, n = cols.shape
    y = F.fold(cols.reshape(t, oh * ow, n).transpose(1, 2), tuple(out_hw),
               kernel, padding=padding, stride=stride)
    return y.permute(0, 2, 3, 1)


def soft_split(p: Params, cfg: ProPainterConfig,
               x: torch.Tensor) -> torch.Tensor:
    """Overlapping unfold + linear embedding: (T, h, w, c) -> (T, f_h, f_w,
    hidden)."""
    cols = _unfold(x, cfg.kernel, cfg.stride, cfg.padding)
    return L.linear(p["ss"], cols)


def soft_comp(p: Params, cfg: ProPainterConfig, tokens: torch.Tensor,
              out_hw) -> torch.Tensor:
    """Linear + fold (overlaps summed) + a 3x3 bias conv."""
    cols = L.linear(p["sc"], tokens)
    x = _fold(cols, out_hw, cfg.kernel, cfg.stride, cfg.padding)
    return L.conv2d(p["sc_bias"], x, padding=1)


def fusion_ff(p: Params, cfg: ProPainterConfig, x: torch.Tensor,
              out_hw) -> torch.Tensor:
    """fc1 -> fold to a spatial map normalised by the fold of ones ->
    unfold -> exact GELU -> fc2. x: (T, f_h, f_w, hidden)."""
    t, fh, fw, _ = x.shape
    h = L.linear(p["ff1"], x)
    kh, kw = cfg.kernel
    folded = _fold(h, out_hw, cfg.kernel, cfg.stride, cfg.padding)
    ones = torch.ones((t, fh, fw, kh * kw), dtype=h.dtype, device=h.device)
    norm = _fold(ones, out_hw, cfg.kernel, cfg.stride, cfg.padding)
    h = _unfold(folded / norm, cfg.kernel, cfg.stride, cfg.padding)
    h = F.gelu(h.float(), approximate="none").to(h.dtype)
    return L.linear(p["ff2"], h)


# ---------------------------------------------------------------------------
# sparse window attention
# ---------------------------------------------------------------------------


def _roll_masks(window: Tuple[int, int]) -> np.ndarray:
    """The ring tokens kept of the 4 stacked rolled windows."""
    wh, ww = window
    eh, ew = (wh + 1) // 2, (ww + 1) // 2
    tl = np.ones((wh, ww)); tl[:-eh, :-ew] = 0
    tr = np.ones((wh, ww)); tr[:-eh, ew:] = 0
    bl = np.ones((wh, ww)); bl[eh:, :-ew] = 0
    br = np.ones((wh, ww)); br[eh:, ew:] = 0
    return np.stack([tl, tr, bl, br]).reshape(-1).astype(bool)


def _softmax(logits: torch.Tensor) -> torch.Tensor:
    return torch.softmax(logits.float(), dim=-1).to(logits.dtype)


def sparse_window_attention(p: Params, cfg: ProPainterConfig,
                            x: torch.Tensor, mask: torch.Tensor,
                            t_ind: Sequence[int]) -> torch.Tensor:
    """Sparse window attention. x: (T, fh, fw, hidden); mask: (lt, fh, fw,
    1) the pooled local masks; t_ind: the frames whose keys and values the
    masked windows keep. A window any local mask touches attends from
    every frame over its window, the rolled ring and the pooled global
    tokens of the kept frames; the others attend within their frame's
    window. Both are computed for every window, then selected."""
    heads = cfg.heads
    wh, ww = cfg.window
    t, fh, fw, c = x.shape
    ch = c // heads
    n_wh, n_ww = -(-fh // wh), -(-fw // ww)
    pad_b, pad_r = n_wh * wh - fh, n_ww * ww - fw
    if pad_b or pad_r:
        x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        mask = F.pad(mask, (0, 0, 0, pad_r, 0, pad_b))
    hh, wwid = n_wh * wh, n_ww * ww
    nw = n_wh * n_ww

    q = L.linear(p["q"], x)
    k = L.linear(p["k"], x)
    v = L.linear(p["v"], x)

    def windows(a):   # (T, H, W, c) -> (nw, heads, T, wh*ww, ch)
        a = a.reshape(t, n_wh, wh, n_ww, ww, heads, ch)
        return a.permute(1, 3, 5, 0, 2, 4, 6).reshape(nw, heads, t,
                                                      wh * ww, ch)

    win_q, win_k, win_v = windows(q), windows(k), windows(v)

    eh, ew = (wh + 1) // 2, (ww + 1) // 2
    valid = torch.from_numpy(_roll_masks(cfg.window)).to(x.device)
    rolls = [(-eh, -ew), (-eh, ew), (eh, -ew), (eh, ew)]
    rool_k = torch.cat([windows(torch.roll(k, r, dims=(1, 2)))
                        for r in rolls], dim=3)[:, :, :, valid]
    rool_v = torch.cat([windows(torch.roll(v, r, dims=(1, 2)))
                        for r in rolls], dim=3)[:, :, :, valid]

    # pooled global tokens: a trained depthwise strided conv, then the key
    # and value projections, shared by every window
    ph, pw = cfg.pool
    p_h, p_w = hh // ph, wwid // pw
    pool_x = L.conv2d(p["pool"], x, stride=ph, padding=0, groups=c)

    def pooled(proj):
        a = L.linear(p[proj], pool_x).reshape(t, p_h * p_w, heads, ch)
        return a.permute(2, 0, 1, 3)[None].expand(nw, heads, t, p_h * p_w,
                                                  ch)

    k_full = torch.cat([win_k, rool_k, pooled("k")], dim=3)
    v_full = torch.cat([win_v, rool_v, pooled("v")], dim=3)
    scale = 1.0 / math.sqrt(ch)

    # masked windows: queries of every frame, keys of the kept frames
    ti = torch.as_tensor(list(t_ind), device=x.device)
    kf = k_full[:, :, ti].reshape(nw, heads, -1, ch)
    vf = v_full[:, :, ti].reshape(nw, heads, -1, ch)
    qf = win_q.reshape(nw, heads, t * wh * ww, ch)
    att = _softmax((qf @ kf.transpose(-1, -2)) * scale)
    out_masked = (att @ vf).reshape(nw, heads, t, wh * ww, ch)

    # unmasked windows: attention within each frame's window
    att_s = _softmax((win_q @ win_k.transpose(-1, -2)) * scale)
    out_plain = att_s @ win_v

    lt = mask.shape[0]
    mwin = mask.reshape(lt, n_wh, wh, n_ww, ww).amax(dim=(2, 4))
    flag = (mwin.sum(dim=0) > 0).reshape(nw, 1, 1, 1, 1)
    out = torch.where(flag, out_masked, out_plain)

    out = out.reshape(n_wh, n_ww, heads, t, wh, ww, ch)
    out = out.permute(3, 0, 4, 1, 5, 2, 6).reshape(t, hh, wwid, c)
    if pad_b or pad_r:
        out = out[:, :fh, :fw]
    return L.linear(p["proj"], out)


def transformer_block(p: Params, cfg: ProPainterConfig, x: torch.Tensor,
                      mask: torch.Tensor, t_ind: Sequence[int],
                      out_hw) -> torch.Tensor:
    y = L.layer_norm(p["ln1"], x)
    x = x + sparse_window_attention(p, cfg, y, mask, t_ind)
    y = L.layer_norm(p["ln2"], x)
    return x + fusion_ff(p, cfg, y, out_hw)


# ---------------------------------------------------------------------------
# generator
# ---------------------------------------------------------------------------

ENC_GROUPS = (1, 2, 4, 8, 1)
ENC_PLAN = [
    # (cin, cout, stride, groups)
    (5, 64, 2, 1),
    (64, 64, 1, 1),
    (64, 128, 2, 1),
    (128, 256, 1, 1),
    (256, 384, 1, 1),
    (640, 512, 1, 2),
    (768, 384, 1, 4),
    (640, 256, 1, 8),
    (512, 128, 1, 1),
]


def _enc_plan(cfg: ProPainterConfig):
    s = cfg.channel / 128.0
    return [(cin if cin == 5 else int(cin * s), int(cout * s), st, gr)
            for cin, cout, st, gr in ENC_PLAN]


def generator_init(gen, cfg: ProPainterConfig,
                   dtype: torch.dtype = torch.float32) -> Params:
    c = cfg.channel
    hid = cfg.hidden
    kh, kw = cfg.kernel
    g = cfg.deform_groups
    dev = gen.device

    def conv(kh_, kw_, ci, co, **opts):
        return _conv_init(gen, kh_, kw_, ci, co, dtype, **opts)

    def lin(di, do):
        return L.linear_init(gen, di, do, dtype=dtype)

    enc = [conv(3, 3, cin, cout, groups=gr)
           for cin, cout, _, gr in _enc_plan(cfg)]
    blocks = []
    for _ in range(cfg.depths):
        pool_k = torch.full((hid, 1, cfg.pool[0], cfg.pool[1]),
                            1.0 / (cfg.pool[0] * cfg.pool[1]), dtype=dtype,
                            device=dev)
        blocks.append({
            "ln1": L.layer_norm_init(hid, dtype, dev),
            "q": lin(hid, hid), "k": lin(hid, hid), "v": lin(hid, hid),
            "proj": lin(hid, hid),
            # depthwise pooling conv, initialised to mean pooling
            "pool": {"kernel": pool_k.contiguous(
                memory_format=torch.channels_last),
                "bias": torch.zeros((hid,), dtype=dtype, device=dev)},
            "ln2": L.layer_norm_init(hid, dtype, dev),
            "ff1": lin(hid, cfg.ffn_hidden),
            "ff2": lin(cfg.ffn_hidden, hid),
        })
    return {
        "enc": enc,
        "ss": lin(c * kh * kw, hid),
        "sc": lin(hid, c * kh * kw),
        "sc_bias": conv(3, 3, c, c),
        "blocks": blocks,
        "align_bwd": _deform_align_init(gen, c, c, 2 * c + 5, g, dtype),
        "align_fwd": _deform_align_init(gen, c, c, 2 * c + 5, g, dtype),
        "backbone_bwd": [conv(3, 3, 2 * c + 2, c), conv(3, 3, c, c)],
        "backbone_fwd": [conv(3, 3, 2 * c + 2, c), conv(3, 3, c, c)],
        "fuse": [conv(3, 3, 2 * c + 2, c), conv(3, 3, c, c)],
        "dec": [conv(3, 3, c, c), conv(3, 3, c, c // 2),
                conv(3, 3, c // 2, c // 2), conv(3, 3, c // 2, 3)],
    }


def encoder_forward(p: Params, cfg: ProPainterConfig,
                    x: torch.Tensor) -> torch.Tensor:
    """The grouped-conv encoder with its channel re-cat. x: (T, H, W, 5)."""
    out = x
    x0 = None
    for i, (conv, (_, _, st, gr)) in enumerate(zip(p["enc"],
                                                    _enc_plan(cfg))):
        if i == 4:
            x0 = out
        if i > 4:
            gidx = ENC_GROUPS[i - 4]
            t, h, w, _ = x0.shape
            a = x0.reshape(t, h, w, gidx, -1)
            b = out.reshape(t, h, w, gidx, -1)
            out = torch.cat([a, b], dim=-1).reshape(t, h, w, -1)
        out = _lrelu(L.conv2d(conv, out, stride=st, padding=1, groups=gr))
    return out


def _nearest(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``jax.image.resize(..., "nearest")`` of (N, H, W, C)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(h, w),
                      mode="nearest-exact")
    return y.permute(0, 2, 3, 1)


def inpaint_forward(p: Params, cfg: ProPainterConfig,
                    masked_frames: torch.Tensor, flows_f: torch.Tensor,
                    flows_b: torch.Tensor, masks_in: torch.Tensor,
                    masks_updated: torch.Tensor,
                    num_local: int) -> torch.Tensor:
    """The generator over one window: encode the local and reference
    frames, propagate features over the local ones, the sparse transformer
    over all, decode the local frames. Returns (num_local, H, W, 3) in
    [-1, 1]."""
    t = masked_frames.shape[0]
    lt = num_local
    x = torch.cat([masked_frames, masks_in, masks_updated], dim=-1)
    feat = encoder_forward(p, cfg, x)
    h4, w4 = feat.shape[1], feat.shape[2]

    # flows at 1/4 (bilinear, antialiased) and masks (nearest)
    fl_f = resize_images(flows_f, h4, w4) / 4.0
    fl_b = resize_images(flows_b, h4, w4) / 4.0
    ds_mask_l = _nearest(masks_in, h4, w4)[:lt]
    ds_upd_l = _nearest(masks_updated[:lt], h4, w4)
    local = feat_propagation(p, cfg, feat[:lt], fl_f, fl_b,
                             torch.cat([ds_mask_l, ds_upd_l], dim=-1))
    feat = torch.cat([local, feat[lt:]], dim=0)

    # the token grid's mask: max pool of the local masks
    mask_pool = F.max_pool2d(ds_mask_l.permute(0, 3, 1, 2), cfg.kernel,
                             stride=cfg.stride,
                             padding=cfg.padding).permute(0, 2, 3, 1)
    tokens = soft_split(p, cfg, feat)
    t_inds = [list(range(i, t, cfg.t_dilation))
              for i in range(cfg.t_dilation)]
    for i, blk in enumerate(p["blocks"]):
        tokens = transformer_block(blk, cfg, tokens, mask_pool,
                                   t_inds[i % cfg.t_dilation], (h4, w4))

    feat = feat + soft_comp(p, cfg, tokens, (h4, w4))
    d = feat[:lt]
    d = _lrelu(L.conv2d(p["dec"][0], _align_corners_2x(d), padding=1))
    d = _lrelu(L.conv2d(p["dec"][1], d, padding=1))
    d = _lrelu(L.conv2d(p["dec"][2], _align_corners_2x(d), padding=1))
    return torch.tanh(L.conv2d(p["dec"][3], d, padding=1))


# ---------------------------------------------------------------------------
# end-to-end orchestration
# ---------------------------------------------------------------------------


def _get_ref_index(mid, neighbor_ids, length, ref_stride, ref_num):
    """Every ref_stride-th frame outside the neighbourhood, optionally
    capped around mid."""
    ref = []
    if ref_num == -1:
        for i in range(0, length, ref_stride):
            if i not in neighbor_ids:
                ref.append(i)
    else:
        start = max(0, mid - ref_stride * (ref_num // 2))
        end = min(length, mid + ref_stride * (ref_num // 2))
        for i in range(start, end, ref_stride):
            if i not in neighbor_ids:
                ref.append(i)
                if len(ref) > ref_num:
                    break
    return ref


def _blend_window(comp: torch.Tensor, seen: torch.Tensor,
                  pred: torch.Tensor, frames01: torch.Tensor,
                  masks: torch.Tensor, start: int) -> None:
    """Blend one window's prediction into the composite in place: the
    prediction inside the masks, the source frame outside, 0.5 / 0.5 with
    what an earlier window wrote."""
    lt = pred.shape[0]
    sl = slice(start, start + lt)
    pred01 = (pred.float() + 1.0) * 0.5
    m = masks[sl].float()
    img = pred01 * m + frames01[sl].float() * (1.0 - m)
    comp[sl] = torch.where(seen[sl] > 0, 0.5 * comp[sl] + 0.5 * img, img)
    seen[sl] = 1.0


def raft_clip(width: int) -> int:
    """RAFT's clip length at a frame width (the reference's short_clip_len)."""
    if width <= 640:
        return 12
    if width <= 720:
        return 8
    if width <= 1280:
        return 4
    return 2


def fc_chunk(cfg: ProPainterConfig, height: int, width: int) -> int:
    """The flow completion's chunk of flows (the JAX package's rule: the
    reference's subvideo_length, capped by the frame's size for a 16 GB
    chip)."""
    return max(8, min(cfg.subvideo_length,
                      int(2.4e9 // (height * width * 500))))


def _chunked(n: int, chunk: int, pad: int):
    """(start, end, keep_from, keep_to) of each padded chunk over n
    items: compute over [start, end), keep [keep_from, keep_to) of it."""
    for f in range(0, n, chunk):
        s = max(0, f - pad)
        e = min(n, f + chunk + pad)
        yield s, e, f - s, e - s - (e - min(n, f + chunk))


def inpaint_video(params: Params, cfg: ProPainterConfig,
                  raft_params: Params, raft_cfg,
                  frames01: torch.Tensor, masks: torch.Tensor,
                  phases: Optional[Dict[str, Any]] = None) -> torch.Tensor:
    """frames01: (T, H, W, 3) in [0, 1]; masks: (T, H, W, 1), 1 = remove;
    H and W multiples of 8. Returns the inpainted frames (T, H, W, 3) fp32
    in [0, 1]. ``phases``, when given, maps "raft", "flow_complete",
    "img_propagation" and "windows" to a context manager factory entered
    around each phase (the profile's timers)."""
    import contextlib
    from mimo_tpu_torch.decomp.raft import raft_bi

    def phase(name):
        fn = (phases or {}).get(name)
        return fn() if fn is not None else contextlib.nullcontext()

    t, h, w, _ = frames01.shape
    frames = frames01 * 2.0 - 1.0

    with phase("raft"):
        clip = raft_clip(w)
        if t > clip:
            ff, bb = [], []
            for f in range(0, t, clip):
                e = min(t, f + clip)
                s = f if f == 0 else f - 1
                fw, bw = raft_bi(raft_params, raft_cfg, frames[s:e])
                ff.append(fw)
                bb.append(bw)
            flows_f, flows_b = torch.cat(ff), torch.cat(bb)
        else:
            flows_f, flows_b = raft_bi(raft_params, raft_cfg, frames)

    with phase("flow_complete"):
        fl = t - 1
        chunk = fc_chunk(cfg, h, w)
        if fl > chunk:
            pf, pb = [], []
            for s, e, a, b in _chunked(fl, chunk, 5):
                of, ob = forward_bidirect_flow(
                    params["flow"], cfg, flows_f[s:e], flows_b[s:e],
                    masks[s:e + 1])
                pf.append(of[a:b])
                pb.append(ob[a:b])
            flows_f, flows_b = torch.cat(pf), torch.cat(pb)
        else:
            flows_f, flows_b = forward_bidirect_flow(
                params["flow"], cfg, flows_f, flows_b, masks)

    with phase("img_propagation"):
        masked = frames * (1 - masks)
        sub_img = min(100, cfg.subvideo_length)
        if t > sub_img:
            uf, um = [], []
            for s, e, a, b in _chunked(t, sub_img, 10):
                pi, pm = img_propagation(masked[s:e], flows_f[s:e - 1],
                                         flows_b[s:e - 1], masks[s:e])
                fi = frames[s:e] * (1 - masks[s:e]) + pi * masks[s:e]
                uf.append(fi[a:b])
                um.append(pm[a:b])
            upd_frames, upd_masks = torch.cat(uf), torch.cat(um)
        else:
            pi, pm = img_propagation(masked, flows_f, flows_b, masks)
            upd_frames = frames * (1 - masks) + pi * masks
            upd_masks = pm

    with phase("windows"):
        stride = cfg.neighbor_length // 2
        ref_num = cfg.subvideo_length // cfg.ref_stride \
            if t > cfg.subvideo_length else -1
        comp = torch.zeros((t, h, w, 3), dtype=torch.float32,
                           device=frames01.device)
        seen = torch.zeros((t, 1, 1, 1), dtype=torch.float32,
                           device=frames01.device)
        for f in range(0, t, stride):
            neighbor_ids = list(range(max(0, f - stride),
                                      min(t, f + stride + 1)))
            ref_ids = _get_ref_index(f, neighbor_ids, t, cfg.ref_stride,
                                     ref_num)
            sel = torch.as_tensor(neighbor_ids + ref_ids,
                                  device=frames01.device)
            nb = torch.as_tensor(neighbor_ids[:-1], device=frames01.device)
            pred = inpaint_forward(params["gen"], cfg, upd_frames[sel],
                                   flows_f[nb], flows_b[nb], masks[sel],
                                   upd_masks[sel], len(neighbor_ids))
            _blend_window(comp, seen, pred, frames01, masks,
                          neighbor_ids[0])
    return comp.clamp(0.0, 1.0)


def propainter_init(gen: torch.Generator, cfg: ProPainterConfig,
                    dtype: torch.dtype = torch.float32) -> Params:
    return {"flow": flow_complete_init(gen, cfg, dtype),
            "gen": generator_init(gen, cfg, dtype)}
