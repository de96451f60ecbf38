"""SAM2 video segmentation and tracking (sam2.1 with Hiera-L).

Counterpart of ``mimo_tpu/decomp/sam2.py``:

- image encoder: the Hiera trunk + FPN neck + sine pos (``hiera.py``), the
  decoder's conv_s0 / conv_s1 skips precomputed per frame;
- memory attention: 4 pre-norm layers of RoPE self-attention, RoPE
  cross-attention into the memory bank (the pointer tokens left unrotated)
  and a ReLU FF, one head of 256;
- memory encoder: the mask downsampler (4 stride-2 convs with LN + GELU),
  fused with projected pixel features through 2 ConvNeXt blocks, projected
  to 64 channels;
- prompt encoder + mask decoder at 256 with high-res skips, the object
  score head, the dynamic multimask-via-stability choice, and the object
  pointer with the no-object gating;
- the video predictor ``init_state`` / ``add_new_points`` /
  ``propagate_in_video`` and ``track_object``.

The decoder's image -> token attention reaches the flash kernel on the card
through ``sam.twoway_transformer`` (4096 image tokens at 1024^2, 7 tokens,
8 heads of 16); the memory attention (one head of 256 against up to
7 x 4096 memory tokens + 64 pointer tokens) is one
``F.scaled_dot_product_attention`` call, where the JAX package called
``jax.nn.dot_product_attention``.

The TPU workarounds are gone, their outputs kept: ``init_state`` encodes in
chunks only to bound memory, without padding a chunk to one static shape;
the propagation is a plain loop over the real frames (no padded scan
steps) that keeps the last 6 memories and 15 pointers. On the card each
frame replays a CUDA graph of its bank's shape (``_FrameGraph``), and
nothing in the encode or the loop reads a device value on the host. A
``TrackRecord`` keeps a call's decisions, its phases and spans, and its
counters. Attending to the
valid memory slots only is what the JAX ring buffers with -inf bias on the
empty slots compute. A memory of age a (frames since it was written) gets
the temporal embedding ``maskmem_tpos_enc[a - 1]``, the conditioning frame
``maskmem_tpos_enc[num_maskmem - 1]``, as in the JAX package.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from mimo_tpu_torch.decomp.hiera import (HieraConfig, hiera_apply,
                                         hiera_init, hiera_neck,
                                         sine_pos_embed, tiny_hiera_config)
from mimo_tpu_torch.decomp.sam import (embed_points, mlp3, mlp3_init,
                                       pe_encode, resize_logits,
                                       sam_attn_init, twoway_block_init,
                                       twoway_transformer)
from mimo_tpu_torch.decomp.vit import _normal, attention_heads, gelu
from mimo_tpu_torch.decomp.vitpose import deconv2d, deconv_init
from mimo_tpu_torch.models import layers as L
from mimo_tpu_torch.ops import ffn as FF
from mimo_tpu_torch.ops import rows as R
from mimo_tpu_torch.utils import frames as FU
from mimo_tpu_torch.utils import profiling

Params = Dict[str, Any]

NO_OBJ_SCORE = -1024.0


@dataclass(frozen=True)
class SAM2Config:
    hiera: HieraConfig = field(default_factory=HieraConfig)  # hiera-large
    dim: int = 256
    mem_dim: int = 64
    num_maskmem: int = 7           # 1 conditioning + 6 recent
    mem_layers: int = 4
    mem_heads: int = 1
    mem_ff: int = 2048
    max_obj_ptrs: int = 16
    num_mask_tokens: int = 4       # 1 single + 3 multimask
    decoder_heads: int = 8
    rope_theta: float = 10000.0
    sigmoid_scale_mem: float = 20.0
    sigmoid_bias_mem: float = -10.0
    stability_delta: float = 0.05
    stability_thresh: float = 0.98

    @property
    def image_size(self) -> int:
        return self.hiera.input_size[0]


def tiny_sam2_config() -> SAM2Config:
    return SAM2Config(hiera=tiny_hiera_config(), dim=32, mem_dim=16,
                      num_maskmem=3, mem_layers=1, mem_heads=1, mem_ff=64,
                      max_obj_ptrs=4, decoder_heads=4)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _rope_attn_init(gen: torch.Generator, d: int, kv_in: int,
                    dtype: torch.dtype) -> Params:
    return {"q": L.linear_init(gen, d, d, dtype=dtype),
            "k": L.linear_init(gen, kv_in, d, dtype=dtype),
            "v": L.linear_init(gen, kv_in, d, dtype=dtype),
            "out": L.linear_init(gen, d, d, dtype=dtype)}


def sam2_init(gen: torch.Generator, cfg: SAM2Config,
              dtype: torch.dtype = torch.float32) -> Params:
    d, md, nm = cfg.dim, cfg.mem_dim, cfg.num_mask_tokens
    dev = gen.device

    def ln(n):
        return L.layer_norm_init(n, dtype, dev)

    mem_layers = [{
        "norm1": ln(d), "self": _rope_attn_init(gen, d, d, dtype),
        "norm2": ln(d), "cross": _rope_attn_init(gen, d, md, dtype),
        "norm3": ln(d),
        "lin1": L.linear_init(gen, d, cfg.mem_ff, dtype=dtype),
        "lin2": L.linear_init(gen, cfg.mem_ff, d, dtype=dtype),
    } for _ in range(cfg.mem_layers)]
    # mask downsampler: 4 stride-2 convs, channels x4 capped at d, then 1x1
    mask_down, mask_down_ln = [], []
    c_in = 1
    for _ in range(4):
        c_out = min(c_in * 4, d)
        mask_down.append(L.conv2d_init(gen, 3, 3, c_in, c_out, dtype=dtype))
        mask_down_ln.append(ln(c_out))
        c_in = c_out
    mask_down.append(L.conv2d_init(gen, 1, 1, c_in, d, dtype=dtype))

    def cxblock():
        return {"dwconv": L.conv2d_init(gen, 7, 7, d, d, dtype=dtype,
                                        groups=d),
                "norm": ln(d),
                "pw1": L.linear_init(gen, d, 4 * d, dtype=dtype),
                "pw2": L.linear_init(gen, 4 * d, d, dtype=dtype),
                "gamma": torch.full((d,), 1e-6, dtype=dtype, device=dev)}

    return {
        "trunk": hiera_init(gen, cfg.hiera, dtype),
        "mem_attn": {"layers": mem_layers, "norm": ln(d)},
        "mem_enc": {
            "mask_down": mask_down, "mask_down_ln": mask_down_ln,
            "pix_proj": L.conv2d_init(gen, 1, 1, d, d, dtype=dtype),
            "fuser": [cxblock(), cxblock()],
            "out_proj": L.conv2d_init(gen, 1, 1, d, md, dtype=dtype),
        },
        "maskmem_tpos_enc": _normal(gen, (cfg.num_maskmem, md), 0.02, dtype),
        "no_mem_embed": _normal(gen, (d,), 0.02, dtype),
        "no_mem_pos_enc": _normal(gen, (d,), 0.02, dtype),
        "no_obj_ptr": _normal(gen, (d,), 0.02, dtype),
        "obj_ptr_proj": mlp3_init(gen, d, d, d, dtype),
        "prompt": {
            "pe_gaussian": _normal(gen, (2, d // 2), 1.0, dtype),
            "point_embed": _normal(gen, (4, d), 0.02, dtype),
            "not_a_point": _normal(gen, (d,), 0.02, dtype),
            "no_mask_embed": _normal(gen, (d,), 0.02, dtype),
            "mask_down": [L.conv2d_init(gen, 2, 2, 1, 4, dtype=dtype),
                          L.conv2d_init(gen, 2, 2, 4, 16, dtype=dtype),
                          L.conv2d_init(gen, 1, 1, 16, d, dtype=dtype)],
            "mask_down_ln": [ln(4), ln(16)],
        },
        "decoder": {
            "obj_token": _normal(gen, (d,), 0.02, dtype),
            "iou_token": _normal(gen, (d,), 0.02, dtype),
            "mask_tokens": _normal(gen, (nm, d), 0.02, dtype),
            "transformer": [twoway_block_init(gen, d, dtype)
                            for _ in range(2)],
            "final_attn": sam_attn_init(gen, d, d // 2, dtype),
            "final_ln": ln(d),
            "up1": deconv_init(gen, d, d // 4, 2, dtype),
            "up_ln": ln(d // 4),
            "up2": deconv_init(gen, d // 4, d // 8, 2, dtype),
            "conv_s0": L.conv2d_init(gen, 1, 1, d, d // 8, dtype=dtype),
            "conv_s1": L.conv2d_init(gen, 1, 1, d, d // 4, dtype=dtype),
            "mask_mlps": [mlp3_init(gen, d, d, d // 8, dtype)
                          for _ in range(nm)],
            "iou_mlp": mlp3_init(gen, d, d, nm, dtype),
            "obj_mlp": mlp3_init(gen, d, d, 1, dtype),
        },
    }


# ---------------------------------------------------------------------------
# rotary position encoding (axial 2-D)
# ---------------------------------------------------------------------------


def axial_rope_angles(head_dim: int, end_x: int, end_y: int,
                      theta: float = 10000.0) -> np.ndarray:
    """(end_x * end_y, head_dim // 2) angles: the first head_dim // 4
    columns rotate by x-position frequencies, the rest by y."""
    n = head_dim // 4
    freqs = 1.0 / theta ** (np.arange(0, head_dim, 4)[:n].astype(np.float32)
                            / head_dim)
    t = np.arange(end_x * end_y, dtype=np.float32)
    tx, ty = t % end_x, np.floor(t / end_x)
    return np.concatenate([np.outer(tx, freqs), np.outer(ty, freqs)],
                          axis=-1)


def _apply_rope(x: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor) -> torch.Tensor:
    """x: (..., S, head_dim) as head_dim // 2 complex pairs, rotated."""
    xf = x.float().reshape(*x.shape[:-1], -1, 2)
    xr, xi = xf[..., 0], xf[..., 1]
    y = torch.stack([xr * cos - xi * sin, xr * sin + xi * cos], dim=-1)
    return y.reshape(x.shape).to(x.dtype)


def _rope_attention(p: Params, q_in: torch.Tensor, k_in: torch.Tensor,
                    v_in: torch.Tensor, heads: int, cos: torch.Tensor,
                    sin: torch.Tensor, repeat_k: int = 1,
                    k_rope_len: Optional[int] = None) -> torch.Tensor:
    """RoPEAttention: project in the param dtype, rotate q fully and the
    first ``k_rope_len`` keys (angles tiled ``repeat_k`` times), attend,
    merge heads."""
    dt = p["q"]["kernel"].dtype
    q = L.linear(p["q"], q_in.to(dt))
    k = L.linear(p["k"], k_in.to(dt))
    v = L.linear(p["v"], v_in.to(dt))
    b, sq, inner = q.shape
    sk = k.shape[1]
    dh = inner // heads
    qh = _apply_rope(q.reshape(b, sq, heads, dh).transpose(1, 2), cos, sin)
    kh = k.reshape(b, sk, heads, dh).transpose(1, 2)
    kr = sk if k_rope_len is None else k_rope_len
    rot = _apply_rope(kh[:, :, :kr], cos.repeat(repeat_k, 1),
                      sin.repeat(repeat_k, 1))
    kh = torch.cat([rot, kh[:, :, kr:]], dim=2) if kr < sk else rot
    o = attention_heads(qh.transpose(1, 2), kh.transpose(1, 2),
                        v.reshape(b, sk, heads, dh))
    return L.linear(p["out"], o.reshape(b, sq, inner))


@functools.lru_cache(maxsize=None)
def _rope_tables(head_dim: int, g: int, theta: float, device: str):
    ang = torch.from_numpy(axial_rope_angles(head_dim, g, g, theta)).to(device)
    return torch.cos(ang), torch.sin(ang)


def rope_tables(cfg: SAM2Config, g: int, device):
    """(cos, sin) of the memory attention's axial RoPE on a g x g grid,
    made once per device (no host -> device copy in the tracking loop)."""
    return _rope_tables(cfg.dim // cfg.mem_heads, g, cfg.rope_theta,
                        str(device))


def memory_attention(p: Params, cfg: SAM2Config, feat: torch.Tensor,
                     feat_pos: torch.Tensor, mem: torch.Tensor,
                     mem_pos: torch.Tensor,
                     obj_ptr_tokens: torch.Tensor) -> torch.Tensor:
    """MemoryAttention. feat / feat_pos: (g, g, d) current-frame features
    and sine pos; mem / mem_pos: (M, g, g, mem_dim) the valid memories
    (temporal embeddings already added to the pos); obj_ptr_tokens: (P,
    mem_dim) the valid pointers' tokens (no pos, no rotation). Returns the
    conditioned (g, g, d)."""
    g, d = feat.shape[0], cfg.dim
    s = g * g
    m = mem.shape[0]
    md = cfg.mem_dim
    x = (feat + 0.1 * feat_pos).reshape(1, s, d)
    ptr = obj_ptr_tokens.to(mem.dtype)
    memory = torch.cat([mem.reshape(m * s, md), ptr], dim=0)[None]
    memory_pos = torch.cat([mem_pos.reshape(m * s, md).to(mem.dtype),
                            torch.zeros_like(ptr)], dim=0)[None]
    cos, sin = rope_tables(cfg, g, feat.device)
    for blk in p["mem_attn"]["layers"]:
        t = L.layer_norm(blk["norm1"], x)
        x = x + _rope_attention(blk["self"], t, t, t, cfg.mem_heads, cos, sin)
        t = L.layer_norm(blk["norm2"], x)
        x = x + _rope_attention(blk["cross"], t, memory + memory_pos, memory,
                                cfg.mem_heads, cos, sin, repeat_k=m,
                                k_rope_len=m * s)
        t = L.layer_norm(blk["norm3"], x)
        x = x + L.linear(blk["lin2"], torch.relu(L.linear(blk["lin1"], t)))
    return L.layer_norm(p["mem_attn"]["norm"], x).reshape(g, g, d)


# ---------------------------------------------------------------------------
# memory encoder
# ---------------------------------------------------------------------------


def encode_memory(p: Params, cfg: SAM2Config, feat: torch.Tensor,
                  mask_for_mem: torch.Tensor) -> torch.Tensor:
    """feat: (g, g, d); mask_for_mem: (16g, 16g) mask input already scaled
    (sigmoid * 20 - 10, or binarised). Returns (g, g, mem_dim)."""
    me = p["mem_enc"]
    h = mask_for_mem[None, ..., None].to(feat.dtype)
    for conv, ln in zip(me["mask_down"][:-1], me["mask_down_ln"]):
        h = gelu(L.layer_norm(ln, L.conv2d(conv, h, stride=2, padding=1),
                              1e-6))
    h = L.conv2d(me["mask_down"][-1], h, padding=0)
    x = L.conv2d(me["pix_proj"], feat[None], padding=0) + h
    for blk in me["fuser"]:
        y = L.conv2d(blk["dwconv"], x, padding=3, groups=x.shape[-1])
        y = L.layer_norm(blk["norm"], y, 1e-6)
        y = L.linear(blk["pw2"], gelu(L.linear(blk["pw1"], y)))
        x = x + y * blk["gamma"].to(y.dtype)
    return L.conv2d(me["out_proj"], x, padding=0)[0]


# ---------------------------------------------------------------------------
# prompt encoder + mask decoder
# ---------------------------------------------------------------------------


def encode_points(p: Params, cfg: SAM2Config, points_px: torch.Tensor,
                  labels: torch.Tensor) -> torch.Tensor:
    """points_px: (B, N, 2) in model-input pixels (+0.5 pixel shift);
    labels (B, N). -> (B, N, d) fp32."""
    coords01 = (points_px.float() + 0.5) / cfg.image_size
    return embed_points(p["prompt"], pe_encode(p["prompt"], coords01),
                        labels)


def _dense_pe(p: Params, g: int, dtype: torch.dtype, device) -> torch.Tensor:
    ys = (torch.arange(g, dtype=torch.float32, device=device) + 0.5) / g
    grid = torch.stack(torch.meshgrid(ys, ys, indexing="xy"), dim=-1)
    return pe_encode(p["prompt"], grid).to(dtype)


def decode_masks(p: Params, cfg: SAM2Config, feat: torch.Tensor,
                 sparse: torch.Tensor, feat_s0: torch.Tensor,
                 feat_s1: torch.Tensor):
    """feat: (g, g, d); sparse: (B, N, d); feat_s0 (4g, 4g, d/8) and
    feat_s1 (2g, 2g, d/4) already projected. Returns (masks (B, nm, 4g,
    4g), iou (B, nm), mask tokens (B, nm, d), object logits (B, 1))."""
    dd = p["decoder"]
    g, d, nm = feat.shape[0], cfg.dim, cfg.num_mask_tokens
    b = sparse.shape[0]
    tokens = torch.cat([
        dd["obj_token"].to(sparse.dtype).expand(b, 1, d),
        dd["iou_token"].to(sparse.dtype).expand(b, 1, d),
        dd["mask_tokens"].to(sparse.dtype).expand(b, nm, d),
        sparse], dim=1)
    src = (feat + p["prompt"]["no_mask_embed"].to(feat.dtype)).reshape(
        1, g * g, d).expand(b, -1, -1)
    pos = _dense_pe(p, g, feat.dtype, feat.device).reshape(
        1, g * g, d).expand(b, -1, -1)
    q, src = twoway_transformer(dd["transformer"], dd["final_attn"],
                                dd["final_ln"], tokens, src, pos,
                                cfg.decoder_heads)
    img = src.reshape(b, g, g, d)
    up = deconv2d(dd["up1"], img, 2, 0) + feat_s1[None].to(img.dtype)
    up = gelu(L.layer_norm(dd["up_ln"], up, 1e-6))
    up = gelu(deconv2d(dd["up2"], up, 2, 0) + feat_s0[None].to(up.dtype))
    mask_tokens_out = q[:, 2:2 + nm]
    mask_embeds = torch.stack([mlp3(dd["mask_mlps"][i], mask_tokens_out[:, i])
                               for i in range(nm)], dim=1)
    masks = torch.einsum("bmc,bhwc->bmhw", mask_embeds,
                         up.to(mask_embeds.dtype))
    iou = torch.sigmoid(mlp3(dd["iou_mlp"], q[:, 1]))
    return masks, iou, mask_tokens_out, mlp3(dd["obj_mlp"], q[:, 0])


def _stability_scores(mask_logits: torch.Tensor,
                      delta: float) -> torch.Tensor:
    flat = mask_logits.reshape(*mask_logits.shape[:-2], -1)
    area_i = (flat > delta).sum(-1).float()
    area_u = (flat > -delta).sum(-1).float()
    return torch.where(area_u > 0, area_i / area_u.clamp(min=1),
                       torch.ones_like(area_u))


def forward_sam_heads(p: Params, cfg: SAM2Config, feat: torch.Tensor,
                      feat_s0: torch.Tensor, feat_s1: torch.Tensor,
                      sparse: Optional[torch.Tensor],
                      multimask_output: bool,
                      decided: Optional[Dict[str, torch.Tensor]] = None):
    """Decoder + mask choice (multimask: best IoU; single: the single mask
    if stable, else the best multimask) + object-score gating + object
    pointer. Returns (low_res (4g, 4g) fp32, high_res (16g, 16g) fp32,
    obj_ptr (d,), object logit). ``decided``, if given, takes the call's
    decisions as device tensors: ``best`` (the best multimask's index
    among the three), ``stable`` (single output only), ``obj`` (the object
    logit, the gate open where > 0) and ``picked`` (the chosen mask's
    fp32 logits before the gate)."""
    if sparse is None:      # an empty point with label -1
        sparse = encode_points(
            p, cfg, torch.zeros((1, 1, 2), device=feat.device),
            torch.full((1, 1), -1, dtype=torch.int32, device=feat.device))
    masks, ious, mask_tokens_out, obj_logits = decode_masks(
        p, cfg, feat, sparse, feat_s0, feat_s1)
    is_obj = obj_logits[0, 0] > 0
    best = torch.argmax(ious[0, 1:])
    # the best multimask by a device-side index: indexing with the tensor
    # would read it on the host, waiting for the device every frame
    pick = (1 + best).reshape(1)
    best_mask = masks[0].index_select(0, pick)[0]
    if multimask_output:
        low_res = best_mask
        sam_token = mask_tokens_out[0].index_select(0, pick)[0]
    else:
        stable = _stability_scores(masks[0, 0], cfg.stability_delta) \
            >= cfg.stability_thresh
        low_res = torch.where(stable, masks[0, 0], best_mask)
        sam_token = mask_tokens_out[0, 0]
        if decided is not None:
            decided["stable"] = stable
    picked = low_res.float()
    if decided is not None:
        decided.update(best=best, obj=obj_logits[0, 0], picked=picked)
    low_res = torch.where(is_obj, picked,
                          torch.full_like(picked, NO_OBJ_SCORE))
    s = cfg.image_size
    high_res = resize_logits(low_res, s, s)
    lam = is_obj.float()
    obj_ptr = mlp3(p["obj_ptr_proj"], sam_token)
    obj_ptr = lam * obj_ptr + (1 - lam) * p["no_obj_ptr"].to(obj_ptr.dtype)
    return low_res, high_res, obj_ptr, obj_logits[0, 0]


# ---------------------------------------------------------------------------
# image encoding
# ---------------------------------------------------------------------------


def encode_frames(p: Params, cfg: SAM2Config, frames: torch.Tensor):
    """frames: (T, S, S, 3) normalised. Returns (feat16 (T, g, g, d),
    feat_s1 (T, 2g, 2g, d/4), feat_s0 (T, 4g, 4g, d/8), pos16 (g, g, d))."""
    fpn, pos = hiera_neck(p["trunk"], cfg.hiera,
                          hiera_apply(p["trunk"], cfg.hiera, frames))
    s0 = L.conv2d(p["decoder"]["conv_s0"], fpn[0], padding=0)
    s1 = L.conv2d(p["decoder"]["conv_s1"], fpn[1], padding=0)
    g = fpn[2].shape[1]
    return fpn[2], s1, s0, sine_on(g, pos[2].shape[-1], str(fpn[2].device),
                                   fpn[2].dtype)


@functools.lru_cache(maxsize=None)
def sine_on(g: int, dim: int, device: str, dtype: torch.dtype):
    """``sine_pos_embed(g, g, dim)`` on the device, copied there once: a
    copy from the host waits for the device's queue, which inside a clip's
    encode or frame loop would idle the device. Callers must not modify
    it."""
    return torch.from_numpy(sine_pos_embed(g, g, dim)).to(device, dtype)


# ---------------------------------------------------------------------------
# video predictor
# ---------------------------------------------------------------------------

IMG_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMG_STD = np.array([0.229, 0.224, 0.225], np.float32)


# the encode's Hiera passes: the row passes' kernel launches (bias + GELU,
# fc2 and proj_attn bias + residual: 3 a block on the card), their plain
# versions' calls (3 a block on the CPU) and the LayerNorm pass's launches
# (2 a block on the card)
HIERA_PASSES = ("hiera_fused_passes", "hiera_eager_passes",
                "hiera_ln_passes")


def hiera_passes() -> Dict[str, int]:
    """The process's counts of ``HIERA_PASSES`` so far."""
    fns = (R.bias_gelu, R.bias_residual)
    return dict(zip(HIERA_PASSES, (sum(f.launches for f in fns),
                                   sum(f.plain_calls for f in fns),
                                   FF.ln_rows.launches)))


class TrackRecord:
    """What one tracking call did, read after the call: the clip's phases
    and host spans (``clock``, a ``utils.profiling.PhaseClock``, which
    the caller marks at "start", "encode" and "prompt"; the predictor marks
    "frame<i>" after each propagated frame and opens a ``track.masks`` span
    a direction), the prompt frame's decisions (``forward_sam_heads``'s
    ``decided``, with its binarised 16g x 16g mask), each direction's
    frames as ``propagate_logits`` stacked them (the picked candidate's
    low-res logits before the object gate, and a frame's best index and
    object logit), the counters of each propagated frame: memory slots,
    keys of a cross-attention and pointer tokens, and the encode's Hiera
    passes (``hiera``, by ``hiera_passes``). Recording never synchronises
    and copies nothing on the device; the last call's record holds its
    stacked logits until the next call."""

    def __init__(self, clock):
        self.clock = clock
        self.hiera = dict.fromkeys(HIERA_PASSES, 0)
        self.prompt: Dict[str, Any] = {}
        self.frames: List[int] = []             # traversal order
        self.picks: List[torch.Tensor] = []     # (n, 4g, 4g) a direction
        self.decided: List[torch.Tensor] = []   # (n, 2): best, object logit
        self.slots: List[int] = []
        self.keys: List[int] = []
        self.ptr_tokens: List[int] = []

    def add_frame(self, slots: int, keys: int, ptr_tokens: int) -> None:
        self.slots.append(slots)
        self.keys.append(keys)
        self.ptr_tokens.append(ptr_tokens)
        self.clock.mark(f"frame{len(self.slots) - 1}")

    def add_direction(self, order: List[int], picked: torch.Tensor,
                      decided: torch.Tensor) -> None:
        self.frames += order
        self.picks.append(picked)
        self.decided.append(decided)

    def picked(self) -> torch.Tensor:
        """(n, 4g, 4g) fp32 logits of the picked candidate before the gate,
        of the prompt frame and every propagated one in frame order, on the
        device."""
        rows = torch.cat([self.prompt["picked"][None]] + self.picks)
        return rows[np.argsort([self.prompt["frame"]] + self.frames,
                               kind="stable")]

    def decisions(self) -> Dict[str, Any]:
        """The decisions as host values: the prompt frame's index,
        ``stable`` (None for a multimask prompt), ``best``, object logit
        and mask; each propagated frame's index, ``best`` and object logit,
        in traversal order."""
        pr = self.prompt
        frames = {"best": np.zeros(0, np.int64), "obj": np.zeros(0,
                                                                 np.float32)}
        if self.decided:
            d = torch.cat(self.decided).cpu().numpy()
            frames = {"best": d[:, 0].astype(np.int64), "obj": d[:, 1]}
        return {"prompt_frame": pr["frame"],
                "prompt_stable": (bool(pr["stable"]) if "stable" in pr
                                  else None),
                "prompt_best": int(pr["best"]),
                "prompt_obj": float(pr["obj"]),
                "prompt_mask": pr["mask"].cpu().numpy(),
                "frames": np.asarray(self.frames, np.int64), **frames}

    def timings(self) -> Dict[str, Any]:
        """The call's record: ``encode`` (None where the encode was
        cached), ``prompt`` and each propagated frame's ``frame_ms`` on the
        device's timeline (ms), their mean, ``frames`` (propagated), the
        mean ``slots``, ``keys`` and ``ptr_tokens`` a frame attended,
        then ``clock.record()``'s ``clip``, ``spans`` (host) and
        ``h2d_bytes`` / ``d2h_bytes``, and the encode's ``HIERA_PASSES``
        (0 where it was cached)."""
        ms = self.clock.durations_ms()
        frame_ms = [v for k, v in ms.items() if k.startswith("frame")]

        def mean(xs):
            return sum(xs) / len(xs) if xs else None

        return {"encode": ms.get("encode"), "prompt": ms["prompt"],
                "frame_ms": frame_ms, "frame_mean": mean(frame_ms),
                "frames": len(frame_ms), "slots": mean(self.slots),
                "keys": mean(self.keys), "ptr_tokens": mean(self.ptr_tokens),
                **self.clock.record(), **self.hiera}


def frame_step(p: Params, cfg: SAM2Config, feat: torch.Tensor,
               pos16: torch.Tensor, s0: torch.Tensor, s1: torch.Tensor,
               mem_all: torch.Tensor, pos_all: torch.Tensor,
               ptr_tokens: torch.Tensor):
    """One propagated frame: memory attention over the bank, the decoder
    prompted with no point (the best of the multimask outputs), and the
    frame's memory from its mask (sigmoid x scale + bias). Returns (the
    picked candidate's low-res logits before the object gate, (2,) fp32:
    the best index and the object logit, the memory, the object
    pointer)."""
    cond_feat = memory_attention(p, cfg, feat, pos16, mem_all, pos_all,
                                 ptr_tokens)
    decided: Dict[str, torch.Tensor] = {}
    _, high_res, obj_ptr, _ = forward_sam_heads(
        p, cfg, cond_feat, s0, s1, None, multimask_output=True,
        decided=decided)
    mask_for_mem = torch.sigmoid(high_res) * cfg.sigmoid_scale_mem \
        + cfg.sigmoid_bias_mem
    return (decided["picked"],
            torch.stack([decided["best"].float(), decided["obj"].float()]),
            encode_memory(p, cfg, feat, mask_for_mem), obj_ptr.float())


def _use_graph(device: torch.device) -> bool:
    return device.type == "cuda"


def _graphed(fn, device: torch.device, pool=None):
    """(``fn()`` run once for real on a side stream, as capture asks of a
    warm-up; a replay of ``fn``'s launches as one CUDA graph captured there,
    which returns the graph's output buffers; the graph's memory pool, which
    later captures may share). The capture is begun by hand:
    ``torch.cuda.graph`` would first synchronise, collect garbage and empty
    the allocator's cache, which the next clip would fill again."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        first = fn()
        graph.capture_begin(*(() if pool is None else (pool,)))
        try:
            out = fn()
        finally:
            graph.capture_end()
    torch.cuda.current_stream(device).wait_stream(side)

    def replay():
        graph.replay()
        return out

    return first, replay, graph.pool()


class _FrameGraph:
    """``frame_step`` at one shape of the bank (its memories and pointers)
    as a CUDA graph. A clip's bank takes 16 shapes (1 to 7 memories, 1 to
    16 pointers), each met first in the first clip, which captures it;
    every later frame of that shape replays it: before, the host's enqueue
    of a frame's ~700 launches, not the device, set a frame's time. The
    inputs are copied into the graph's buffers and the outputs cloned out
    of them, so a replay computes what ``frame_step`` computes."""

    def __init__(self, p: Params, cfg: SAM2Config, pos16: torch.Tensor,
                 inputs, pool=None):
        self.p, self.cfg, self.pos16 = p, cfg, pos16
        self.inputs = [x.clone() for x in inputs]
        self.first, self.replay, self.pool = _graphed(self._step,
                                                      pos16.device, pool)

    def _step(self):
        feat, s0, s1, mems, pos_all, ptrs = self.inputs
        return frame_step(self.p, self.cfg, feat, self.pos16, s0, s1, mems,
                          pos_all, ptrs.reshape(-1, self.cfg.mem_dim))

    def __call__(self, inputs):
        for dst, src in zip(self.inputs, inputs):
            dst.copy_(src)
        return tuple(x.clone() for x in self.replay())


class SAM2VideoPredictor:
    """init_state / add_new_points / propagate_in_video. Propagation covers
    the frames after (forward) or before (reverse) the conditioning frame;
    that frame keeps its prompted mask. A ``record`` (``TrackRecord``), if
    set, takes the calls' decisions, marks and counters."""

    def __init__(self, params: Params, cfg: SAM2Config):
        self.p = params
        self.cfg = cfg
        leaf = params["no_mem_embed"]
        self.device, self.dtype = leaf.device, leaf.dtype
        self._feats = None
        self._orig = None
        self._cond: Optional[Dict[str, Any]] = None
        self.record: Optional[TrackRecord] = None
        # CUDA graphs of the frame step by the bank's (memories, pointers)
        self._graphs: Dict[tuple, _FrameGraph] = {}

    def _copied(self, direction: str, nbytes: int) -> None:
        if self.record is not None:
            self.record.clock.copied(direction, nbytes)

    def init_state(self, frames: List[np.ndarray], enc_chunk: int = 8) -> None:
        """frames: (H, W, 3) uint8 RGB, uploaded once as they are, then
        resized on the device to the square model input with OpenCV's
        INTER_LINEAR arithmetic (``utils/frames.py::cv_resize``, equal to
        ``cv2.resize`` in every bit) and ImageNet-normalised, encoded
        ``enc_chunk`` frames a call (the last chunk may be shorter: chunks
        only bound the memory). Nothing in the encode waits for the
        device."""
        s = self.cfg.image_size
        self._orig = frames[0].shape[:2]
        mean = torch.from_numpy(IMG_MEAN).to(self.device)
        std = torch.from_numpy(IMG_STD).to(self.device)
        clip = FU.upload_frames(frames, self.device)
        self._copied("h2d", clip.nbytes)
        passes = hiera_passes()
        parts = []
        for i in range(0, len(frames), enc_chunk):
            batch = FU.cv_resize(clip[i:i + enc_chunk], s, s,
                                 area=False).float()
            px = ((batch / 255.0 - mean) / std).to(self.dtype)
            parts.append(encode_frames(self.p, self.cfg, px))
        del clip
        if self.record is not None:
            self.record.hiera = {k: v - passes[k]
                                 for k, v in hiera_passes().items()}
        pos16 = parts[0][3]
        self._feats = tuple(torch.cat([pt[j] for pt in parts])
                            for j in range(3)) + (pos16,)
        self._cond = None

    def add_new_points(self, frame_idx: int, points: np.ndarray,
                       labels: np.ndarray) -> np.ndarray:
        """Prompt one frame: returns its mask at the frames' resolution and
        keeps the conditioning memory and object pointer."""
        cfg = self.cfg
        h, w = self._orig
        s = cfg.image_size
        pts = torch.from_numpy(np.asarray(points, np.float32) / [w, h] * s
                               ).float()[None].to(self.device)
        lbl = torch.from_numpy(np.asarray(labels, np.int32))[None].to(
            self.device)
        self._copied("h2d", pts.nbytes + lbl.nbytes)
        feat16, s1, s0, _ = self._feats
        feat = feat16[frame_idx] + self.p["no_mem_embed"].to(feat16.dtype)
        decided: Dict[str, torch.Tensor] = {}
        low_res, high_res, obj_ptr, _ = forward_sam_heads(
            self.p, cfg, feat, s0[frame_idx], s1[frame_idx],
            encode_points(self.p, cfg, pts, lbl),
            multimask_output=len(labels) <= 1, decided=decided)
        # the conditioning memory from the binarised mask (no sigmoid)
        binary = high_res > 0
        mask_for_mem = binary.float() * cfg.sigmoid_scale_mem \
            + cfg.sigmoid_bias_mem
        mem = encode_memory(self.p, cfg, feat16[frame_idx], mask_for_mem)
        self._cond = {"frame": frame_idx, "mem": mem, "ptr": obj_ptr.float(),
                      "low_res": low_res}
        if self.record is not None:
            self.record.prompt = dict(decided, frame=frame_idx, mask=binary)
        out = self._mask_to_orig(low_res[None])[0]
        self._copied("d2h", out.nbytes)
        return out

    def _mask_to_orig(self, logits: torch.Tensor) -> np.ndarray:
        h, w = self._orig
        return (resize_logits(logits, h, w) > 0).cpu().numpy()

    def propagate_logits(self, order: List[int]) -> torch.Tensor:
        """Track through ``order`` (the frame indices after the
        conditioning one, in traversal order, at least one): (len(order),
        4g, 4g) fp32 low-res logits. Each frame's enqueue runs in a
        profiler range ``track.frame``; on CUDA each frame replays the
        graph of its bank's shape (``_FrameGraph``)."""
        cfg = self.cfg
        rec = self.record
        feat16, s1, s0, pos16 = self._feats
        g = feat16.shape[1]
        md = cfg.mem_dim
        recent, max_ptrs = cfg.num_maskmem - 1, cfg.max_obj_ptrs - 1
        sine = sine_on(g, md, str(self.device), torch.float32)
        tpos = self.p["maskmem_tpos_enc"].float()
        # the bank's positions by its count of recent memories: the
        # conditioning one, then ages n .. 1 (oldest first)
        bank_pos = [torch.stack([sine + tpos[cfg.num_maskmem - 1]]
                                + [sine + tpos[a - 1]
                                   for a in range(n, 0, -1)])
                    for n in range(recent + 1)]
        graph = _use_graph(self.device)
        mems: List[torch.Tensor] = []          # newest last
        ptrs: List[torch.Tensor] = []
        out, decisions = [], []
        for t in order:
            with profiling.annotate("track.frame"):
                inputs = (feat16[t], s0[t], s1[t],
                          torch.stack([self._cond["mem"]] + mems),
                          bank_pos[len(mems)],
                          torch.stack([self._cond["ptr"]] + ptrs))
                slots, n_ptr = 1 + len(mems), 1 + len(ptrs)
                if not graph:
                    step = frame_step(self.p, cfg, inputs[0], pos16,
                                      *inputs[1:5],
                                      inputs[5].reshape(-1, md))
                elif (slots, n_ptr) in self._graphs:
                    step = self._graphs[slots, n_ptr](inputs)
                else:
                    pool = next(iter(self._graphs.values())).pool \
                        if self._graphs else None
                    made = _FrameGraph(self.p, cfg, pos16, inputs, pool)
                    self._graphs[slots, n_ptr] = made
                    step = made.first
                picked, decided, mem, ptr = step
                mems = (mems + [mem])[-recent:]
                ptrs = (ptrs + [ptr])[-max_ptrs:]
                out.append(picked)
                decisions.append(decided)
            if rec is not None:
                tokens = n_ptr * cfg.dim // md
                rec.add_frame(slots=slots, keys=slots * g * g + tokens,
                              ptr_tokens=tokens)
        picked, decided = torch.stack(out), torch.stack(decisions)
        if rec is not None:
            rec.add_direction(order, picked, decided)
        # the object gate: a frame whose object logit is not > 0 has none
        return picked.masked_fill(~(decided[:, 1] > 0)[:, None, None],
                                  NO_OBJ_SCORE)

    def propagate_in_video(self, reverse: bool = False) -> np.ndarray:
        """(T, H, W) bool masks; frames on the untracked side of the
        conditioning frame are False. With a record, the host waits for the
        last frame before the span ``track.masks`` (the logits of the whole
        clip, their resize to the frames' size, the threshold and the copy
        back), as ``Runner.to_host`` does before ``entry.output``."""
        assert self._cond is not None, "add_new_points first"
        feat16 = self._feats[0]
        n = feat16.shape[0]
        start = self._cond["frame"]
        order = list(range(start - 1, -1, -1)) if reverse \
            else list(range(start + 1, n))
        tracked = self.propagate_logits(order) if order else None
        if self.record is None:
            return self._video_masks(start, order, tracked)
        self.record.clock.durations_ms()
        with self.record.clock.span("track.masks"):
            masks = self._video_masks(start, order, tracked)
        self._copied("d2h", masks.nbytes)
        return masks

    def _video_masks(self, start: int, order: List[int],
                     tracked: Optional[torch.Tensor]) -> np.ndarray:
        g4 = self._cond["low_res"].shape[-1]
        n = self._feats[0].shape[0]
        logits = torch.full((n, g4, g4), NO_OBJ_SCORE, device=self.device)
        logits[start] = self._cond["low_res"]
        if order:
            logits[torch.as_tensor(order, device=self.device)] = tracked
        return self._mask_to_orig(logits)


def track_object(params: Params, cfg: SAM2Config, frames: List[np.ndarray],
                 points: np.ndarray, labels: np.ndarray,
                 prompt_frame: int = 0) -> np.ndarray:
    """init -> prompt -> propagate forward and backward, OR-merged."""
    pred = SAM2VideoPredictor(params, cfg)
    pred.init_state(frames)
    pred.add_new_points(prompt_frame, points, labels)
    return pred.propagate_in_video(reverse=False) \
        | pred.propagate_in_video(reverse=True)
