"""SAM (Segment Anything): image encoder, prompt encoder, two-way mask
decoder, predictor and automatic mask generation.

Counterpart of ``mimo_tpu/decomp/sam.py`` (ViT-H at 1024^2 by default:
1280 wide, 32 deep, 16 heads, windows of 14, global blocks 7 / 15 / 23 /
31, decomposed rel-pos; prompt dim 256; two decoder blocks of 8 heads). It
gives the first-frame person mask from a box prompt and the automatic
masks that propose people to the detector.

The decoder's attentions run at the param dtype through
``models/layers.sdpa``: the image -> token attention (4096 image tokens at
1024^2 against 5-7 prompt tokens, 8 heads of 16) reaches the flash kernel
on the card.

Fault R2 of the JAX package, kept: ``automatic_masks`` measures the NMS IoU
on the decoder's low-res grid (one device matmul of the binarised logits)
and applies ``min_area`` after NMS at full resolution, where the published
SAM filters first and compares full-resolution masks. The port matches
``mimo_tpu``, not the published SAM.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from mimo_tpu_torch.decomp.vit import (ViTConfig, _normal, gelu,
                                       tokens_to_grid, vit_apply, vit_init)
from mimo_tpu_torch.decomp.vitpose import deconv2d, deconv_init
from mimo_tpu_torch.models import layers as L
from mimo_tpu_torch.utils.frames import resize_linear

Params = Dict[str, Any]


@dataclass(frozen=True)
class SAMConfig:
    encoder: ViTConfig = field(default_factory=lambda: ViTConfig(
        img_size=(1024, 1024), patch_size=16, dim=1280, depth=32,
        num_heads=16, window_size=14, global_blocks=(7, 15, 23, 31),
        use_rel_pos=True, ln_eps=1e-6))     # ViT-H
    prompt_dim: int = 256
    image_embed_size: int = 64              # 1024 / 16
    decoder_depth: int = 2
    decoder_heads: int = 8
    num_mask_tokens: int = 4                # 1 whole + 3 multimask


def tiny_sam_config() -> SAMConfig:
    return SAMConfig(
        encoder=ViTConfig(img_size=(64, 64), patch_size=16, dim=32, depth=2,
                          num_heads=4, window_size=2, global_blocks=(1,),
                          use_rel_pos=True, ln_eps=1e-6),
        prompt_dim=32, image_embed_size=4, decoder_heads=4)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def mlp3_init(gen: torch.Generator, d_in: int, d_hidden: int, d_out: int,
              dtype: torch.dtype) -> Params:
    return {"fc1": L.linear_init(gen, d_in, d_hidden, dtype=dtype),
            "fc2": L.linear_init(gen, d_hidden, d_hidden, dtype=dtype),
            "fc3": L.linear_init(gen, d_hidden, d_out, dtype=dtype)}


def mlp3(p: Params, x: torch.Tensor) -> torch.Tensor:
    x = torch.relu(L.linear(p["fc1"], x))
    x = torch.relu(L.linear(p["fc2"], x))
    return L.linear(p["fc3"], x)


def sam_attn_init(gen: torch.Generator, d: int, inner: int,
                  dtype: torch.dtype) -> Params:
    """Decoder attention: every projection with a bias, optionally
    downsampled to ``inner``."""
    return {"to_q": L.linear_init(gen, d, inner, dtype=dtype),
            "to_k": L.linear_init(gen, d, inner, dtype=dtype),
            "to_v": L.linear_init(gen, d, inner, dtype=dtype),
            "to_out": L.linear_init(gen, inner, d, dtype=dtype)}


def twoway_block_init(gen: torch.Generator, d: int,
                      dtype: torch.dtype) -> Params:
    dev = gen.device
    return {
        "self_attn": sam_attn_init(gen, d, d, dtype),
        "ln1": L.layer_norm_init(d, dtype, dev),
        "t2i": sam_attn_init(gen, d, d // 2, dtype),
        "ln2": L.layer_norm_init(d, dtype, dev),
        "mlp_fc1": L.linear_init(gen, d, 8 * d, dtype=dtype),
        "mlp_fc2": L.linear_init(gen, 8 * d, d, dtype=dtype),
        "ln3": L.layer_norm_init(d, dtype, dev),
        "i2t": sam_attn_init(gen, d, d // 2, dtype),
        "ln4": L.layer_norm_init(d, dtype, dev),
    }


def sam_init(gen: torch.Generator, cfg: SAMConfig,
             dtype: torch.dtype = torch.float32) -> Params:
    d = cfg.prompt_dim
    dev = gen.device
    nm = cfg.num_mask_tokens
    return {
        "encoder": vit_init(gen, cfg.encoder, dtype),
        "neck_conv1": L.conv2d_init(gen, 1, 1, cfg.encoder.dim, d,
                                    bias=False, dtype=dtype),
        "neck_ln1": L.layer_norm_init(d, dtype, dev),
        "neck_conv2": L.conv2d_init(gen, 3, 3, d, d, bias=False,
                                    dtype=dtype),
        "neck_ln2": L.layer_norm_init(d, dtype, dev),
        "pe_gaussian": _normal(gen, (2, d // 2), 1.0, dtype),
        "point_embed": _normal(gen, (4, d), 0.02, dtype),
        "not_a_point": _normal(gen, (d,), 0.02, dtype),
        "no_mask_embed": _normal(gen, (d,), 0.02, dtype),
        "iou_token": _normal(gen, (d,), 0.02, dtype),
        "mask_tokens": _normal(gen, (nm, d), 0.02, dtype),
        "decoder": [twoway_block_init(gen, d, dtype)
                    for _ in range(cfg.decoder_depth)],
        "final_attn": sam_attn_init(gen, d, d // 2, dtype),
        "final_ln": L.layer_norm_init(d, dtype, dev),
        "up1": deconv_init(gen, d, d // 4, 2, dtype),
        "up_ln": L.layer_norm_init(d // 4, dtype, dev),
        "up2": deconv_init(gen, d // 4, d // 8, 2, dtype),
        "mask_mlps": [mlp3_init(gen, d, d, d // 8, dtype)
                      for _ in range(nm)],
        "iou_mlp": mlp3_init(gen, d, d, nm, dtype),
    }


# ---------------------------------------------------------------------------
# forward pieces
# ---------------------------------------------------------------------------


def encode_image(p: Params, cfg: SAMConfig,
                 pixels: torch.Tensor) -> torch.Tensor:
    """pixels: (B, S, S, 3) SAM-normalised -> (B, g, g, prompt_dim)."""
    enc = cfg.encoder
    x = tokens_to_grid(vit_apply(p["encoder"], enc, pixels), enc,
                       enc.img_size[0] // enc.patch_size,
                       enc.img_size[1] // enc.patch_size)
    x = L.conv2d(p["neck_conv1"], x, padding=0)
    x = L.layer_norm(p["neck_ln1"], x, 1e-6)
    x = L.conv2d(p["neck_conv2"], x, padding=1)
    return L.layer_norm(p["neck_ln2"], x, 1e-6)


def pe_encode(p: Params, coords01: torch.Tensor) -> torch.Tensor:
    """Random-fourier encoding of [0, 1] coords (..., 2) -> (..., d)."""
    x = (2.0 * coords01 - 1.0) @ p["pe_gaussian"].to(coords01.dtype)
    x = 2 * math.pi * x
    return torch.cat([torch.sin(x), torch.cos(x)], dim=-1)


def dense_pe(p: Params, g: int, dtype: torch.dtype,
             device) -> torch.Tensor:
    """The encoding of the g x g pixel-centre grid: (g, g, d)."""
    ys = (torch.arange(g, dtype=torch.float32, device=device) + 0.5) / g
    grid = torch.stack(torch.meshgrid(ys, ys, indexing="xy"), dim=-1)
    return pe_encode(p, grid.to(dtype))


def embed_points(p: Params, pe: torch.Tensor,
                 labels: torch.Tensor) -> torch.Tensor:
    """Per-label embeddings added to the points' encodings: labels -1 pad,
    0 negative, 1 positive, 2 / 3 box corners."""
    emb = p["point_embed"].to(pe.dtype)
    lab = labels[..., None]
    out = pe
    for i in range(4):
        out = out + torch.where(lab == i, emb[i], torch.zeros_like(emb[i]))
    return torch.where(lab == -1, p["not_a_point"].to(pe.dtype), out)


def encode_points(p: Params, points01: torch.Tensor,
                  labels: torch.Tensor) -> torch.Tensor:
    """points01: (B, N, 2) in [0, 1]; labels (B, N). -> (B, N, d)."""
    return embed_points(p, pe_encode(p, points01), labels)


def xattn(p_attn: Params, q: torch.Tensor, kv_k: torch.Tensor,
          kv_v: torch.Tensor, heads: int) -> torch.Tensor:
    """Decoder attention in the param dtype (the fp32 prompt encodings
    would otherwise give mixed-dtype q/k/v)."""
    dt = p_attn["to_q"]["kernel"].dtype
    qq = L.linear(p_attn["to_q"], q.to(dt))
    kk = L.linear(p_attn["to_k"], kv_k.to(dt))
    vv = L.linear(p_attn["to_v"], kv_v.to(dt))
    return L.linear(p_attn["to_out"], L.sdpa(qq, kk, vv, heads))


def twoway_transformer(blocks, final_attn: Params, final_ln: Params,
                       tokens: torch.Tensor, src: torch.Tensor,
                       pos: torch.Tensor, heads: int):
    """SAM's TwoWayTransformer: post-norm, PEs added to q / k each layer,
    never to v, the first self-attention without PE. Returns (tokens,
    image tokens)."""
    q = tokens
    token_pe = tokens
    for i, blk in enumerate(blocks):
        if i == 0:
            q = xattn(blk["self_attn"], q, q, q, heads)
        else:
            qq = q + token_pe
            q = q + xattn(blk["self_attn"], qq, qq, q, heads)
        q = L.layer_norm(blk["ln1"], q)
        attn = xattn(blk["t2i"], q + token_pe, src + pos, src, heads)
        q = L.layer_norm(blk["ln2"], q + attn)
        m = L.linear(blk["mlp_fc2"], torch.relu(L.linear(blk["mlp_fc1"], q)))
        q = L.layer_norm(blk["ln3"], q + m)
        attn_i = xattn(blk["i2t"], src + pos, q + token_pe, q, heads)
        src = L.layer_norm(blk["ln4"], src + attn_i)
    q = q + xattn(final_attn, q + token_pe, src + pos, src, heads)
    return L.layer_norm(final_ln, q), src


def decode_masks(p: Params, cfg: SAMConfig, image_embed: torch.Tensor,
                 sparse: torch.Tensor):
    """image_embed: (g, g, d) of one image; sparse: (B, N, d) prompts.
    Returns (masks (B, M, 4g, 4g), iou (B, M))."""
    g = image_embed.shape[0]
    d = cfg.prompt_dim
    nm = cfg.num_mask_tokens
    b = sparse.shape[0]
    tokens = torch.cat([
        p["iou_token"].to(sparse.dtype).expand(b, 1, d),
        p["mask_tokens"].to(sparse.dtype).expand(b, nm, d),
        sparse], dim=1)
    src = (image_embed + p["no_mask_embed"].to(image_embed.dtype)
           ).reshape(1, g * g, d).expand(b, -1, -1)
    pos = dense_pe(p, g, image_embed.dtype, image_embed.device).reshape(
        1, g * g, d).expand(b, -1, -1)
    q, src = twoway_transformer(p["decoder"], p["final_attn"],
                                p["final_ln"], tokens, src, pos,
                                cfg.decoder_heads)
    up = deconv2d(p["up1"], src.reshape(b, g, g, d), 2, 0)
    up = gelu(L.layer_norm(p["up_ln"], up))
    up = gelu(deconv2d(p["up2"], up, 2, 0))                 # (B, 4g, 4g, d/8)
    mask_embeds = torch.stack([mlp3(p["mask_mlps"][i], q[:, 1 + i])
                               for i in range(nm)], dim=1)  # (B, M, d/8)
    masks = torch.einsum("bmc,bhwc->bmhw", mask_embeds,
                         up.to(mask_embeds.dtype))
    return masks, mlp3(p["iou_mlp"], q[:, 0])


# ---------------------------------------------------------------------------
# predictor
# ---------------------------------------------------------------------------

SAM_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
SAM_STD = np.array([58.395, 57.12, 57.375], np.float32)


def resize_logits(m: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(..., H, W) float maps to (..., h, w): bilinear with half-pixel
    centres and clamped edges, OpenCV's INTER_LINEAR on floats."""
    lead = m.shape[:-2]
    y = F.interpolate(m.reshape(-1, 1, *m.shape[-2:]).float(), size=(h, w),
                      mode="bilinear", align_corners=False)
    return y.reshape(*lead, h, w)


class SamPredictor:
    """set_image once, predict many prompts."""

    def __init__(self, params: Params, cfg: SAMConfig):
        self.params = params
        self.cfg = cfg
        leaf = params["iou_token"]
        self.device, self.dtype = leaf.device, leaf.dtype
        self._embed = None
        self._orig_size = None
        self._scaled = None

    def set_image(self, image: np.ndarray) -> None:
        """image: (H, W, 3) uint8 RGB, its long side resized (bilinear,
        OpenCV's INTER_LINEAR, on the device without OpenCV) to the encoder
        size, normalised and padded bottom / right."""
        s = self.cfg.encoder.img_size[0]
        h, w = image.shape[:2]
        scale = s / max(h, w)
        nh, nw = int(round(h * scale)), int(round(w * scale))
        resized = resize_linear(image, nw, nh, self.device).float()
        canvas = torch.zeros((s, s, 3), dtype=torch.float32,
                             device=self.device)
        canvas[:nh, :nw] = ((resized - torch.from_numpy(SAM_MEAN).to(
            self.device)) / torch.from_numpy(SAM_STD).to(self.device))
        px = canvas[None].to(self.dtype)
        self._embed = encode_image(self.params, self.cfg, px)[0]
        self._orig_size = (h, w)
        self._scaled = (nh, nw)

    def decode(self, points01: torch.Tensor, labels: torch.Tensor):
        """Prompts (B, N, 2) in [0, 1] of the encoder frame -> (masks (B, M,
        4g, 4g), iou (B, M)) on the device."""
        return decode_masks(self.params, self.cfg, self._embed,
                            encode_points(self.params, points01, labels))

    def predict(self, points: Optional[np.ndarray] = None,
                labels: Optional[np.ndarray] = None,
                box: Optional[np.ndarray] = None):
        """points (N, 2) xy pixels with labels (N,); box (4,) xyxy. Returns
        (masks (M, H, W) bool, iou (M,)) at the image's resolution."""
        assert self._embed is not None, "call set_image first"
        h, w = self._orig_size
        nh, nw = self._scaled
        s = self.cfg.encoder.img_size[0]
        prompts, lbls = [], []
        if points is not None:
            prompts.append(np.asarray(points, np.float32) * [nw / w, nh / h]
                           / s)
            lbls.append(np.asarray(labels, np.int32))
        if box is not None:
            bx = np.asarray(box, np.float32).reshape(2, 2) * [nw / w, nh / h]
            prompts.append(bx / s)
            lbls.append(np.array([2, 3], np.int32))
        pts = torch.from_numpy(np.concatenate(prompts, 0)[None]).to(
            self.device)
        lbl = torch.from_numpy(np.concatenate(lbls, 0)[None]).to(self.device)
        masks, iou = self.decode(pts.float(), lbl)
        mg = masks.shape[-1]
        valid = masks[0, :, :int(round(mg * nh / s)), :int(round(mg * nw / s))]
        out = resize_logits(valid, h, w) > 0
        return out.cpu().numpy(), iou[0].float().cpu().numpy()


def nms_stats(cand: torch.Tensor, valid: torch.Tensor):
    """Areas and the pairwise intersection matrix of binarised candidate
    logits inside ``valid``, as one matmul of 0/1 values with fp32 sums
    (exact: the counts stay far below 2^24)."""
    b = ((cand > 0) & valid).reshape(cand.shape[0], -1).float()
    inter = b @ b.T
    return torch.diagonal(inter), inter


def automatic_masks(predictor: SamPredictor, image: np.ndarray,
                    points_per_side: int = 32, pred_iou_thresh: float = 0.88,
                    nms_iou: float = 0.7,
                    min_area: int = 0) -> List[Dict[str, Any]]:
    """SAM automatic masks: a regular point grid prompts the decoder in
    chunks of 256 prompts, the three multimask outputs of each become
    candidates, filtered by predicted IoU, then a greedy NMS on the low-res
    grid (one device matmul of the binarised candidates) and only the kept
    masks are resized to full resolution (fault R2, module docstring)."""
    predictor.set_image(image)
    h, w = image.shape[:2]
    nh, nw = predictor._scaled
    s = predictor.cfg.encoder.img_size[0]
    dev = predictor.device

    xs = (np.arange(points_per_side) + 0.5) / points_per_side
    grid = np.stack(np.meshgrid(xs, xs, indexing="xy"), -1).reshape(-1, 2)
    pts = torch.from_numpy((grid * [nw / s, nh / s]).astype(np.float32)
                           )[:, None, :].to(dev)
    lbl = torch.ones((pts.shape[0], 1), dtype=torch.int32, device=dev)
    chunk = min(256, pts.shape[0])
    parts = [predictor.decode(pts[i:i + chunk], lbl[i:i + chunk])
             for i in range(0, pts.shape[0], chunk)]
    masks = torch.cat([m for m, _ in parts])
    iou = torch.cat([i for _, i in parts])

    # the multimask outputs (tokens 1..3) as candidates
    g4 = masks.shape[-1]
    cand = masks[:, 1:].reshape(-1, g4, g4)
    cand_iou = iou[:, 1:].reshape(-1).float().cpu().numpy()
    vh, vw = int(round(g4 * nh / s)), int(round(g4 * nw / s))
    valid = torch.zeros((g4, g4), dtype=torch.bool, device=dev)
    valid[:vh, :vw] = True
    areas, inter = nms_stats(cand, valid)
    areas, inter = areas.cpu().numpy(), inter.cpu().numpy()

    ok = (cand_iou > pred_iou_thresh) & (areas > 0)
    kept: List[int] = []
    for i in np.argsort(-cand_iou, kind="stable"):
        if not ok[i]:
            continue
        dup = False
        for j in kept:
            u = areas[i] + areas[j] - inter[i, j]
            if u > 0 and inter[i, j] / u > nms_iou:
                dup = True
                break
        if not dup:
            kept.append(int(i))
    if not kept:
        return []

    idx = torch.as_tensor(kept, device=dev)
    binary = (cand.index_select(0, idx)[:, :vh, :vw] > 0).float()
    full = (resize_logits(binary, h, w) > 0.5).cpu().numpy()
    results = []
    for mm, i in zip(full, kept):
        area = int(mm.sum())
        if area <= min_area:
            continue
        results.append({"segmentation": mm, "area": area,
                        "predicted_iou": float(cand_iou[i])})
    return results


def mask_nms(results: List[Dict[str, Any]],
             iou_thresh: float = 0.7) -> List[Dict[str, Any]]:
    """Greedy mask-overlap NMS over full-resolution masks."""
    results = sorted(results, key=lambda r: -r["predicted_iou"])
    kept: List[Dict[str, Any]] = []
    for r in results:
        seg = r["segmentation"]
        ok = True
        for kr in kept:
            inter = np.logical_and(seg, kr["segmentation"]).sum()
            union = np.logical_or(seg, kr["segmentation"]).sum()
            if union and inter / union > iou_thresh:
                ok = False
                break
        if ok:
            kept.append(r)
    return kept
