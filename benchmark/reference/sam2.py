"""SAM 2 video tracking in plain float32 (Ravi et al., "SAM 2: Segment
Anything in Images and Videos", arXiv 2408.00714; ``sam2_hiera_l.yaml`` in
facebookresearch/sam2), as MIMO's ``video_decomp`` runs it on a person:
prompted with points of the first mask on frame 0, then propagated frame by
frame through a memory bank. Nothing here imports the program; every
product goes through ``nn.py``, so its switches apply (the float8 control,
the work log).

- the frame upload and resize: each uint8 frame to the square model input
  with OpenCV's INTER_LINEAR (``cv2.resize``; where OpenCV is missing,
  ``F.interpolate`` bilinear rounded to uint8, as the program then does),
  /255, ImageNet mean and deviation;
- the image encoder: ``hiera.py``, the decoder's stride-4 and stride-8
  skips projected by ``conv_s0`` / ``conv_s1``;
- the prompt encoder (random Fourier features of the point, a label
  embedding) and the two-way mask decoder (object-score token, IoU token, 4
  mask tokens; 2 blocks of post-norm attention, token -> image and image
  -> token at half width, 8 heads; the upscaling with the high-res skips;
  the IoU head's sigmoid, the object-score MLP);
- the mask choice: the best IoU of the 3 multimask outputs on a propagated
  frame; on a prompt of several points the single mask if its stability
  (area above +0.05 over area above -0.05) reaches 0.98, else the best
  multimask; the object gate (logit > 0) sets a mask to -1024 and its
  pointer to the no-object pointer;
- memory attention: 4 pre-norm layers at 256, one head, the current
  frame's features plus 0.1 x their sine position as input; RoPE
  self-attention, RoPE cross-attention into the memory bank (keys: the
  memories plus their position, with the axial rotation tiled over the
  memories; the pointer tokens neither rotated nor given a position), a
  2048-wide ReLU feed-forward; a final LayerNorm;
- the memory encoder: the mask (sigmoid x 20 - 10 on a propagated frame,
  the binarised mask x 20 - 10 on the prompt frame) down by 4 stride-2
  convs with LayerNorm and GELU and a 1x1 conv, added to the projected
  frame features, 2 ConvNeXt blocks, a projection to 64 channels;
- the loop: the conditioning memory and the 6 most recent ones, each with
  the sine position at 64 channels plus its temporal embedding (age a
  takes row a - 1, the conditioning memory the last row), and the
  conditioning pointer with the 15 most recent ones, each split into 4
  tokens of 64.

Departures from the published model, as the program has them
(``decomp/sam2.py``, ``decomp/hiera.py``):

- ``hiera.py``'s position-embedding resize;
- frames are resized with INTER_LINEAR; upstream's frame loader resizes
  with PIL's default filter;
- the point prompt gets no padding token, and a frame without points is
  prompted with one not-a-point token (upstream appends a padding point
  to a prompt without a box, so it has 6 and 2 tokens);
- no hole filling of the masks (the upstream video predictor's
  ``fill_hole_area``);
- the memory's temporal embedding follows the memory's age in frames,
  which on a clip tracked frame by frame is upstream's slot order.

What ``correct`` compares (``entries/track.py``): the sigmoid of the picked
candidate's low-res logits before the object gate, every frame. With
random weights the tracker decides at near-ties, so the reference takes
the program's recorded decision where its own margin is within ``TIES``,
and its own everywhere else (``Decider``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import hiera as H
from benchmark.reference import nn

try:
    import cv2
except ImportError:
    cv2 = None

Params = Dict[str, Any]
NO_OBJ = -1024.0
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
# Margins within which the reference follows the program's decision: the
# program decides in bfloat16, whose unit in the last place is 2^-8 of a
# value; the IoU heads' sigmoids (0.5-1) then round by 0.002-0.004 and the
# logits by 0.4% of their size, on top of the drift of its features.
TIES = {"iou": 0.02, "stability": 0.01, "object": 0.25, "pixel": 0.25}


# ---------------------------------------------------------------------------
# products and small pieces
# ---------------------------------------------------------------------------


def conv2d(p: Params, x: torch.Tensor, stride: int = 1, padding: int = 0,
           groups: int = 1) -> torch.Tensor:
    """``nn.conv2d`` with groups (the ConvNeXt blocks' depthwise conv)."""
    if groups == 1:
        return nn.conv2d(p, x, stride=stride, padding=padding)
    y = F.conv2d(nn._op(x).permute(0, 3, 1, 2), nn._op(p["kernel"]),
                 p["bias"].float(), stride=stride, padding=padding,
                 groups=groups)
    return y.permute(0, 2, 3, 1)


def deconv2x(p: Params, x: torch.Tensor) -> torch.Tensor:
    """A 2x2 stride-2 transposed conv of (N, H, W, C_in): each input pixel
    makes its own 2x2 output block, one product with the (C_in, 4 C_out)
    kernel."""
    n, h, w, _ = x.shape
    k = p["kernel"].float()
    c_out = k.shape[1]
    y = nn.matmul(x, k.permute(0, 2, 3, 1).reshape(k.shape[0], 4 * c_out))
    y = y.reshape(n, h, w, 2, 2, c_out).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(n, 2 * h, 2 * w, c_out) + p["bias"].float()


def mlp3(p: Params, x: torch.Tensor) -> torch.Tensor:
    x = F.relu(nn.linear(p["fc1"], x))
    x = F.relu(nn.linear(p["fc2"], x))
    return nn.linear(p["fc3"], x)


def resize_logits(m: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(..., H, W) -> (..., h, w): bilinear, half-pixel centres, edges
    clamped."""
    lead = m.shape[:-2]
    y = F.interpolate(m.reshape(-1, 1, *m.shape[-2:]).float(), size=(h, w),
                      mode="bilinear", align_corners=False)
    return y.reshape(*lead, h, w)


def frame_pixels(frame: np.ndarray, s: int, device) -> torch.Tensor:
    """A uint8 (H, W, 3) frame as the normalised (1, s, s, 3) input."""
    if cv2 is not None:
        px = torch.from_numpy(cv2.resize(frame, (s, s),
                                         interpolation=cv2.INTER_LINEAR))
    else:
        x = torch.from_numpy(np.ascontiguousarray(frame)).permute(2, 0, 1)
        px = F.interpolate(x[None].float(), size=(s, s), mode="bilinear",
                           align_corners=False)[0].permute(1, 2, 0)
        px = px.round().clamp(0, 255)
    px = px.to(device).float() / 255.0
    mean = torch.tensor(MEAN, device=device)
    std = torch.tensor(STD, device=device)
    return ((px - mean) / std)[None]


def prompt_points(mask: np.ndarray, n: int, seed: int) -> np.ndarray:
    """n points of a mask: its centroid, then n - 1 of its pixels drawn
    without replacement from ``numpy.random.default_rng(seed)``."""
    ys, xs = np.nonzero(mask)
    pts = [[xs.mean(), ys.mean()]]
    rng = np.random.default_rng(seed)
    for i in rng.choice(len(xs), size=min(n - 1, len(xs)), replace=False):
        pts.append([xs[i], ys[i]])
    return np.asarray(pts, np.float32)


# ---------------------------------------------------------------------------
# image encoder, prompt encoder, mask decoder
# ---------------------------------------------------------------------------


def encode(p: Params, cfg: Dict[str, Any], pixels: torch.Tensor):
    """(1, S, S, 3) -> (feat (g, g, d), skip at 2g (2g, 2g, d/4), skip at
    4g (4g, 4g, d/8))."""
    fpn = H.neck(p["trunk"], H.trunk(p["trunk"], cfg["hiera"], pixels))
    dec = p["decoder"]
    return (fpn[2][0], nn.conv2d(dec["conv_s1"], fpn[1], padding=0)[0],
            nn.conv2d(dec["conv_s0"], fpn[0], padding=0)[0])


def fourier(p: Params, coords01: torch.Tensor) -> torch.Tensor:
    """Random Fourier features of (..., 2) coords in [0, 1]."""
    x = 2 * math.pi * nn.matmul(2.0 * coords01 - 1.0,
                                p["prompt"]["pe_gaussian"])
    return torch.cat([torch.sin(x), torch.cos(x)], dim=-1)


def point_tokens(p: Params, points_px: np.ndarray, size: int,
                 device) -> torch.Tensor:
    """(N, 2) points in model-input pixels, all positive: (N, d)."""
    c = (torch.from_numpy(points_px).float().to(device) + 0.5) / size
    return fourier(p, c) + p["prompt"]["point_embed"][1].float()


def dense_pe(p: Params, g: int, device) -> torch.Tensor:
    """The Fourier features of the g x g cell centres, (x, y) a cell."""
    c = (torch.arange(g, dtype=torch.float32, device=device) + 0.5) / g
    grid = torch.stack([c[None, :].expand(g, g), c[:, None].expand(g, g)],
                       dim=-1)
    return fourier(p, grid)


def _attn(p: Params, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          heads: int) -> torch.Tensor:
    return nn.linear(p["to_out"], nn.attention(
        nn.linear(p["to_q"], q), nn.linear(p["to_k"], k),
        nn.linear(p["to_v"], v), heads))


def two_way(p: Params, tokens: torch.Tensor, src: torch.Tensor,
            pos: torch.Tensor, heads: int):
    """The two-way transformer (post-norm; the first self-attention without
    the token PE). tokens (1, T, d), src / pos (1, g², d)."""
    dec = p["decoder"]
    q, pe = tokens, tokens
    for i, blk in enumerate(dec["transformer"]):
        if i == 0:
            q = _attn(blk["self_attn"], q, q, q, heads)
        else:
            q = q + _attn(blk["self_attn"], q + pe, q + pe, q, heads)
        q = nn.layer_norm(blk["ln1"], q)
        q = nn.layer_norm(blk["ln2"], q + _attn(blk["t2i"], q + pe,
                                                src + pos, src, heads))
        m = nn.linear(blk["mlp_fc2"], F.relu(nn.linear(blk["mlp_fc1"], q)))
        q = nn.layer_norm(blk["ln3"], q + m)
        src = nn.layer_norm(blk["ln4"], src + _attn(blk["i2t"], src + pos,
                                                    q + pe, q, heads))
    q = q + _attn(dec["final_attn"], q + pe, src + pos, src, heads)
    return nn.layer_norm(dec["final_ln"], q), src


def decode(p: Params, cfg: Dict[str, Any], feat: torch.Tensor,
           sparse: torch.Tensor, s0: torch.Tensor, s1: torch.Tensor):
    """feat (g, g, d), sparse (N, d) -> (masks (nm, 4g, 4g), IoUs (nm,),
    mask tokens (nm, d), object logit)."""
    c = cfg["sam2"]
    dec = p["decoder"]
    g, d, nm = feat.shape[0], c["dim"], c["num_mask_tokens"]
    tokens = torch.cat([dec["obj_token"].float()[None],
                        dec["iou_token"].float()[None],
                        dec["mask_tokens"].float(), sparse])[None]
    src = (feat + p["prompt"]["no_mask_embed"].float()).reshape(1, g * g, d)
    pos = dense_pe(p, g, feat.device).reshape(1, g * g, d)
    q, src = two_way(p, tokens, src, pos, c["decoder_heads"])
    up = deconv2x(dec["up1"], src.reshape(1, g, g, d)) + s1[None]
    up = F.gelu(nn.layer_norm(dec["up_ln"], up, 1e-6))
    up = F.gelu(deconv2x(dec["up2"], up) + s0[None])
    toks = q[0, 2:2 + nm]
    embeds = torch.stack([mlp3(dec["mask_mlps"][i], toks[i])
                          for i in range(nm)])
    masks = nn.matmul(up[0], embeds.t()).permute(2, 0, 1)
    iou = torch.sigmoid(mlp3(dec["iou_mlp"], q[0, 1]))
    return masks, iou, toks, mlp3(dec["obj_mlp"], q[0, 0])[0]


def stability(logits: torch.Tensor, delta: float) -> torch.Tensor:
    inner = (logits > delta).sum().float()
    outer = (logits > -delta).sum().float()
    return inner / outer if outer > 0 else torch.ones((), device=logits.device)


def object_pointer(p: Params, token: torch.Tensor, present: bool):
    if present:
        return mlp3(p["obj_ptr_proj"], token)
    return p["no_obj_ptr"].float()


# ---------------------------------------------------------------------------
# memory attention and memory encoder
# ---------------------------------------------------------------------------


def rope_angles(dim: int, g: int, theta: float, device):
    """(cos, sin) of the axial rotation on a g x g grid, (g², dim / 2): the
    first dim / 4 pairs turn with the column, the rest with the row."""
    freqs = 1.0 / theta ** (np.arange(0, dim, 4)[:dim // 4] / dim)
    t = np.arange(g * g)
    ang = np.concatenate([np.outer(t % g, freqs), np.outer(t // g, freqs)],
                         axis=-1)
    ang = torch.from_numpy(ang).float().to(device)
    return torch.cos(ang), torch.sin(ang)


def rotate(x: torch.Tensor, cos: torch.Tensor,
           sin: torch.Tensor) -> torch.Tensor:
    """(S, dim) as dim / 2 pairs (x[2i], x[2i+1]), each turned by its
    angle."""
    a, b = x[:, 0::2], x[:, 1::2]
    return torch.stack([a * cos - b * sin, a * sin + b * cos],
                       dim=-1).reshape(x.shape)


def rope_attention(p: Params, q_in: torch.Tensor, k_in: torch.Tensor,
                   v_in: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                   rotated_keys: int) -> torch.Tensor:
    """One head: the queries rotated, the first ``rotated_keys`` keys
    rotated with the angles tiled over them, the rest (pointers) not."""
    q = nn.linear(p["q"], q_in)
    k = nn.linear(p["k"], k_in)
    v = nn.linear(p["v"], v_in)
    q = rotate(q, cos, sin)
    rep = rotated_keys // cos.shape[0]
    k = torch.cat([rotate(k[:rotated_keys], cos.repeat(rep, 1),
                          sin.repeat(rep, 1)), k[rotated_keys:]])
    return nn.linear(p["out"], nn.attention(q[None], k[None], v[None],
                                            1)[0])


def memory_attention(p: Params, cfg: Dict[str, Any], feat: torch.Tensor,
                     feat_pos: torch.Tensor, mems: torch.Tensor,
                     mem_pos: torch.Tensor,
                     ptr_tokens: torch.Tensor) -> torch.Tensor:
    """feat / feat_pos (g, g, d); mems / mem_pos (M, g, g, md); ptr_tokens
    (P, md). Returns (g, g, d)."""
    c = cfg["sam2"]
    g, d = feat.shape[0], feat.shape[-1]
    s, m, md = g * g, mems.shape[0], mems.shape[-1]
    x = (feat + 0.1 * feat_pos).reshape(s, d)
    memory = torch.cat([mems.reshape(m * s, md), ptr_tokens])
    keys = torch.cat([(mems + mem_pos).reshape(m * s, md), ptr_tokens])
    cos, sin = rope_angles(d, g, c["rope_theta"], feat.device)
    for blk in p["mem_attn"]["layers"]:
        t = nn.layer_norm(blk["norm1"], x)
        x = x + rope_attention(blk["self"], t, t, t, cos, sin, s)
        t = nn.layer_norm(blk["norm2"], x)
        x = x + rope_attention(blk["cross"], t, keys, memory, cos, sin,
                               m * s)
        t = nn.layer_norm(blk["norm3"], x)
        x = x + nn.linear(blk["lin2"], F.relu(nn.linear(blk["lin1"], t)))
    return nn.layer_norm(p["mem_attn"]["norm"], x).reshape(g, g, d)


def encode_memory(p: Params, feat: torch.Tensor,
                  mask_in: torch.Tensor) -> torch.Tensor:
    """feat (g, g, d), mask_in (16g, 16g) already scaled -> (g, g, md)."""
    me = p["mem_enc"]
    h = mask_in[None, :, :, None].float()
    for conv, ln in zip(me["mask_down"][:-1], me["mask_down_ln"]):
        h = F.gelu(nn.layer_norm(ln, conv2d(conv, h, stride=2, padding=1),
                                 1e-6))
    h = conv2d(me["mask_down"][-1], h)
    x = conv2d(me["pix_proj"], feat[None]) + h
    for blk in me["fuser"]:
        y = conv2d(blk["dwconv"], x, padding=3, groups=x.shape[-1])
        y = nn.layer_norm(blk["norm"], y, 1e-6)
        y = nn.linear(blk["pw2"], F.gelu(nn.linear(blk["pw1"], y)))
        x = x + y * blk["gamma"].float()
    return conv2d(me["out_proj"], x)[0]


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------


class Decider:
    """The reference's decisions: its own, but where the program's
    recorded decision differs and the reference's margin lies within
    ``ties``, the program's. Counts what it did by kind in ``stats``."""

    def __init__(self, record: Optional[Dict[str, Any]],
                 ties: Dict[str, float]):
        self.record, self.ties = record, ties
        self.stats: Dict[str, Dict[str, int]] = {}

    def _count(self, kind: str, what: str, n: int = 1) -> None:
        self.stats.setdefault(kind, {"decisions": 0, "followed": 0,
                                     "differ": 0})[what] += n

    def _pick(self, kind: str, own, recorded, margin: float):
        self._count(kind, "decisions")
        if recorded is None or recorded == own:
            return own
        if margin <= self.ties[kind]:
            self._count(kind, "followed")
            return recorded
        self._count(kind, "differ")
        return own

    def best(self, ious: torch.Tensor, recorded: Optional[int]) -> int:
        """Argmax of the multimask IoUs; margin: the IoU gap to the
        recorded pick."""
        own = int(torch.argmax(ious))
        margin = (float(ious[own] - ious[recorded]) if recorded is not None
                  else 0.0)
        return self._pick("iou", own, recorded, margin)

    def stable(self, score: float, thresh: float,
               recorded: Optional[bool]) -> bool:
        return self._pick("stability", score >= thresh, recorded,
                          abs(score - thresh))

    def present(self, logit: float, recorded: Optional[float]) -> bool:
        rec = None if recorded is None else recorded > 0
        return self._pick("object", logit > 0, rec, abs(logit))

    def binary(self, logits: torch.Tensor,
               recorded: Optional[np.ndarray]) -> torch.Tensor:
        """logits > 0, but the program's bit where |logit| <= the tie."""
        own = logits > 0
        self._count("pixel", "decisions", own.numel())
        if recorded is None:
            return own
        prog = torch.from_numpy(recorded).to(own.device)
        tie = logits.abs() <= self.ties["pixel"]
        self._count("pixel", "followed", int((tie & (prog != own)).sum()))
        self._count("pixel", "differ", int((~tie & (prog != own)).sum()))
        return torch.where(tie, prog, own)


def track(p: Params, cfg: Dict[str, Any], frames: List[np.ndarray],
          first_mask: np.ndarray, device, record: Optional[Dict] = None,
          ties: Dict[str, float] = TIES, stats: Optional[Dict] = None
          ) -> torch.Tensor:
    """Tracks ``first_mask`` from frame 0 forwards through ``frames``.
    Returns (T, 4g, 4g): the sigmoid of each frame's picked candidate's
    logits before the object gate. ``record``: the program's decisions
    (``TrackRecord.decisions``), followed at near-ties; ``stats`` takes
    the ``Decider``'s counts."""
    c, tr = cfg["sam2"], cfg["track"]
    s, nm = cfg["hiera"]["input_size"][0], c["num_maskmem"]
    assert tr["prompt_frame"] == 0, "the reference tracks forwards from 0"
    decide = Decider(record, ties)
    rec = record or {}

    def features(t):
        return encode(p, cfg, frame_pixels(frames[t], s, device))

    h, w = frames[0].shape[:2]
    pts = prompt_points(first_mask, tr["points"], tr["points_seed"])
    pts_px = (pts / [w, h] * s).astype(np.float32)
    feat, s1, s0 = features(0)
    g = feat.shape[0]
    feat_pos = H.sine_embed(g, g, c["dim"], device)
    masks, iou, toks, obj = decode(
        p, cfg, feat + p["no_mem_embed"].float(),
        point_tokens(p, pts_px, s, device), s0, s1)
    best = decide.best(iou[1:], rec.get("prompt_best"))
    if len(pts) <= 1:
        picked, token = masks[1 + best], toks[1 + best]
    else:
        score = float(stability(masks[0], c["stability_delta"]))
        stable = decide.stable(score, c["stability_thresh"],
                               rec.get("prompt_stable"))
        picked = masks[0] if stable else masks[1 + best]
        token = toks[0]
    present = decide.present(float(obj), rec.get("prompt_obj"))
    high = resize_logits(picked if present
                         else torch.full_like(picked, NO_OBJ), s, s)
    binary = decide.binary(high, rec.get("prompt_mask"))
    scale, bias = c["sigmoid_scale_mem"], c["sigmoid_bias_mem"]
    cond_mem = encode_memory(p, feat, binary.float() * scale + bias)
    cond_ptr = object_pointer(p, token, present)
    out = [torch.sigmoid(picked)]

    md = c["mem_dim"]
    sine = H.sine_embed(g, g, md, device)
    tpos = p["maskmem_tpos_enc"].float()
    mems: List[torch.Tensor] = []
    ptrs: List[torch.Tensor] = []
    blank = p["prompt"]["not_a_point"].float()[None]
    if "frames" in rec:
        assert list(rec["frames"]) == list(range(1, len(frames)))
    for k, t in enumerate(range(1, len(frames))):
        feat, s1, s0 = features(t)
        mem_all = torch.stack([cond_mem] + mems)
        pos_all = torch.stack([sine + tpos[nm - 1]]
                              + [sine + tpos[a - 1]
                                 for a in range(len(mems), 0, -1)])
        ptr_tokens = torch.stack([cond_ptr] + ptrs).reshape(-1, md)
        x = memory_attention(p, cfg, feat, feat_pos, mem_all, pos_all,
                             ptr_tokens)
        masks, iou, toks, obj = decode(p, cfg, x, blank, s0, s1)
        best = decide.best(iou[1:], (int(rec["best"][k]) if "best" in rec
                                     else None))
        picked = masks[1 + best]
        present = decide.present(float(obj), (float(rec["obj"][k])
                                              if "obj" in rec else None))
        high = resize_logits(picked if present
                             else torch.full_like(picked, NO_OBJ), s, s)
        mems = (mems + [encode_memory(p, feat, torch.sigmoid(high) * scale
                                      + bias)])[-(nm - 1):]
        ptrs = (ptrs + [object_pointer(p, toks[1 + best], present)]
                )[-(c["max_obj_ptrs"] - 1):]
        out.append(torch.sigmoid(picked))
    if stats is not None:
        stats.update(decide.stats)
    return torch.stack(out)
