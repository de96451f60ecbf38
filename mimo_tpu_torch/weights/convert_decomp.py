"""Decomposition checkpoints -> the npz bundles of ``decomp.factory``.

The port's own copy of ``mimo_tpu/weights/convert_decomp.py`` for the
models of the ported stages: the same functions and the same flat tree,
with the configs from the port's decomposition modules, so a machine
without JAX can go from the published checkpoints to the bundles that
``decomp.factory.build_decomp_models`` reads:

- SAM ViT-H (``sam_vit_h_*.pth``)            -> ``sam.npz``
- SAM2.1 Hiera-L (``sam2.1_hiera_large.pt``) -> ``sam2.npz``
- ViTPose-H wholebody (mmpose ``.pth``)      -> ``vitpose.npz``
- HMR2 (4D-Humans ``epoch=35`` checkpoint)   -> ``hmr.npz``
- HaMeR (``hamer.ckpt``)                     -> ``hamer.npz``
- RAFT (``raft-things.pth``)                 -> ``raft.npz``
- ProPainter (``ProPainter.pth`` with
  ``recurrent_flow_completion.pth``)         -> ``propainter.npz``
- DINOv2-L, DepthAnythingV2's encoder         -> ``convert_dinov2``, a
  function only: neither package converts the DPT head, so no
  ``depth.npz`` is written

Transforms: Linear (out, in) -> (in, out); Conv OIHW -> HWIO;
ConvTranspose (in, out, kh, kw) -> spatially flipped (kh, kw, in, out), the
JAX package's layout, which the weights bridge (``kind=``) turns back into
``F.conv_transpose2d``'s. The SMPL-H model (``smpl.npz`` / ``smpl.pkl``)
is read as published (``decomp/smpl.py``) and needs no conversion.

Usage:

    python -m mimo_tpu_torch.weights.convert_decomp --out-dir DIR \
        [--sam SAM.pth] [--sam2 SAM2.pt] [--vitpose VITPOSE.pth] \
        [--hmr2 HMR2.ckpt] [--hamer HAMER.ckpt] [--raft RAFT.pth] \
        [--propainter ProPainter.pth --flow-complete FLOW.pth]
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Dict, Mapping

import numpy as np

from mimo_tpu_torch.weights.convert import (_SD, _linear, _norm, _np,
                                            flatten_tree, load_state_dict,
                                            save_npz)


def _t_conv(w):
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def _t_deconv(w):
    """torch ConvTranspose2d (in, out, kh, kw) -> HWIO with a spatial flip
    (``lax.conv_transpose`` without ``transpose_kernel``)."""
    return np.ascontiguousarray(
        np.transpose(w, (2, 3, 0, 1))[::-1, ::-1])


def _conv(sd: _SD, prefix: str) -> Dict[str, np.ndarray]:
    p = {"kernel": _t_conv(sd.get(prefix + ".weight"))}
    if sd.has(prefix + ".bias"):
        p["bias"] = sd.get(prefix + ".bias")
    return p


def _deconv(sd: _SD, prefix: str) -> Dict[str, np.ndarray]:
    p = {"kernel": _t_deconv(sd.get(prefix + ".weight"))}
    if sd.has(prefix + ".bias"):
        p["bias"] = sd.get(prefix + ".bias")
    else:
        p["bias"] = np.zeros(p["kernel"].shape[-1], np.float32)
    return p


def _vit_block(sd: _SD, prefix: str, mlp_names=("mlp.lin1", "mlp.lin2")
               ) -> Dict[str, Any]:
    """One ViT block (SAM / ViTPose naming: blocks.{i}.*)."""
    blk = {
        "ln1": _norm(sd, f"{prefix}.norm1"),
        "qkv": _linear(sd, f"{prefix}.attn.qkv"),
        "proj": _linear(sd, f"{prefix}.attn.proj"),
        "ln2": _norm(sd, f"{prefix}.norm2"),
        "fc1": _linear(sd, f"{prefix}.{mlp_names[0]}"),
        "fc2": _linear(sd, f"{prefix}.{mlp_names[1]}"),
    }
    if sd.has(f"{prefix}.attn.rel_pos_h"):
        blk["rel_pos_h"] = sd.get(f"{prefix}.attn.rel_pos_h")
        blk["rel_pos_w"] = sd.get(f"{prefix}.attn.rel_pos_w")
    if sd.has(f"{prefix}.ls1.gamma"):
        blk["ls1"] = sd.get(f"{prefix}.ls1.gamma")
        blk["ls2"] = sd.get(f"{prefix}.ls2.gamma")
    return blk


def _sam_decoder_attn(sd: _SD, prefix: str) -> Dict[str, Any]:
    return {
        "to_q": _linear(sd, f"{prefix}.q_proj"),
        "to_k": _linear(sd, f"{prefix}.k_proj"),
        "to_v": _linear(sd, f"{prefix}.v_proj"),
        "to_out": _linear(sd, f"{prefix}.out_proj"),
    }


def _mlp3(sd: _SD, prefix: str) -> Dict[str, Any]:
    return {"fc1": _linear(sd, f"{prefix}.layers.0"),
            "fc2": _linear(sd, f"{prefix}.layers.1"),
            "fc3": _linear(sd, f"{prefix}.layers.2")}


def _two_way_layer(sd: _SD, lp: str, mlp_names) -> Dict[str, Any]:
    return {
        "self_attn": _sam_decoder_attn(sd, f"{lp}.self_attn"),
        "ln1": _norm(sd, f"{lp}.norm1"),
        "t2i": _sam_decoder_attn(sd, f"{lp}.cross_attn_token_to_image"),
        "ln2": _norm(sd, f"{lp}.norm2"),
        "mlp_fc1": _linear(sd, f"{lp}.mlp.{mlp_names[0]}"),
        "mlp_fc2": _linear(sd, f"{lp}.mlp.{mlp_names[1]}"),
        "ln3": _norm(sd, f"{lp}.norm3"),
        "i2t": _sam_decoder_attn(sd, f"{lp}.cross_attn_image_to_token"),
        "ln4": _norm(sd, f"{lp}.norm4"),
    }


def convert_sam(state_dict: Mapping[str, Any], cfg) -> Dict[str, Any]:
    """SAM ViT-H -> ``decomp.sam`` params (``cfg``: a ``SAMConfig``)."""
    sd = _SD(state_dict)
    enc = "image_encoder"
    encoder = {
        "patch_embed": _conv(sd, f"{enc}.patch_embed.proj"),
        "pos_embed": _np(sd.get(f"{enc}.pos_embed")).reshape(-1,
                                                             cfg.encoder.dim),
        "blocks": [_vit_block(sd, f"{enc}.blocks.{i}")
                   for i in range(cfg.encoder.depth)],
        # SAM has no final encoder LN; identity keeps the tree uniform
        "ln_out": {"scale": np.ones(cfg.encoder.dim, np.float32),
                   "bias": np.zeros(cfg.encoder.dim, np.float32)},
    }
    dec = "mask_decoder.transformer"
    return {
        "encoder": encoder,
        "neck_conv1": {"kernel": _t_conv(sd.get(f"{enc}.neck.0.weight"))},
        "neck_ln1": _norm(sd, f"{enc}.neck.1"),
        "neck_conv2": {"kernel": _t_conv(sd.get(f"{enc}.neck.2.weight"))},
        "neck_ln2": _norm(sd, f"{enc}.neck.3"),
        "pe_gaussian": sd.get(
            "prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"),
        "point_embed": np.stack([
            sd.get(f"prompt_encoder.point_embeddings.{i}.weight")[0]
            for i in range(4)]),
        "not_a_point": sd.get("prompt_encoder.not_a_point_embed.weight")[0],
        "no_mask_embed": sd.get("prompt_encoder.no_mask_embed.weight")[0],
        "iou_token": sd.get("mask_decoder.iou_token.weight")[0],
        "mask_tokens": sd.get("mask_decoder.mask_tokens.weight"),
        "decoder": [_two_way_layer(sd, f"{dec}.layers.{i}",
                                   ("lin1", "lin2"))
                    for i in range(cfg.decoder_depth)],
        "final_attn": _sam_decoder_attn(
            sd, f"{dec}.final_attn_token_to_image"),
        "final_ln": _norm(sd, f"{dec}.norm_final_attn"),
        "up1": _deconv(sd, "mask_decoder.output_upscaling.0"),
        "up_ln": _norm(sd, "mask_decoder.output_upscaling.1"),
        "up2": _deconv(sd, "mask_decoder.output_upscaling.3"),
        "mask_mlps": [_mlp3(sd, f"mask_decoder.output_hypernetworks_mlps.{i}")
                      for i in range(cfg.num_mask_tokens)],
        "iou_mlp": _mlp3(sd, "mask_decoder.iou_prediction_head"),
    }


def load_smpl_mean_params(path: str) -> Dict[str, np.ndarray]:
    """Published smpl_mean_params.npz (HMR lineage): the IEF heads' initial
    pose (24 x 6D), shape (10) and camera (3), the ``mean_*`` leaves of an
    ``hmr.npz`` tree (the HMR2 checkpoint carries its own)."""
    with np.load(path, allow_pickle=True) as f:
        return {
            "mean_pose": np.asarray(f["pose"], np.float32).reshape(-1),
            "mean_betas": np.asarray(f["shape"], np.float32).reshape(-1),
            "mean_cam": np.asarray(f["cam"], np.float32).reshape(-1),
        }


def _vitpose_backbone(sd: _SD, depth: int) -> Dict[str, Any]:
    """ViTPose-style ViT under ``backbone.*``; pos_embed keeps its cls slot
    (the forward adds it to every token, ``cls_pos_to_all``)."""
    bb = "backbone"
    return {
        "patch_embed": _conv(sd, f"{bb}.patch_embed.proj"),
        "pos_embed": _np(sd.get(f"{bb}.pos_embed"))[0],
        "blocks": [_vit_block(sd, f"{bb}.blocks.{i}",
                              mlp_names=("mlp.fc1", "mlp.fc2"))
                   for i in range(depth)],
        "ln_out": _norm(sd, f"{bb}.last_norm"),
    }


def convert_vitpose(state_dict: Mapping[str, Any], cfg) -> Dict[str, Any]:
    """mmpose TopDown checkpoint (backbone.* + keypoint_head.*) ->
    ``decomp.vitpose`` params (``cfg``: a ``ViTPoseConfig``)."""
    sd = _SD(state_dict)
    deconvs = []
    for i in range(cfg.num_deconv):
        bn = f"keypoint_head.deconv_layers.{3 * i + 1}"
        deconvs.append({
            "deconv": _deconv(sd, f"keypoint_head.deconv_layers.{3 * i}"),
            "bn_scale": sd.get(f"{bn}.weight"),
            "bn_bias": sd.get(f"{bn}.bias"),
            "bn_mean": sd.get(f"{bn}.running_mean"),
            "bn_var": sd.get(f"{bn}.running_var"),
        })
    return {
        "backbone": _vitpose_backbone(sd, cfg.backbone.depth),
        "deconvs": deconvs,
        "final": _conv(sd, "keypoint_head.final_layer"),
    }


def _sam2_attn(sd: _SD, prefix: str) -> Dict[str, Any]:
    """sam/transformer.py Attention / RoPEAttention {q,k,v,out}_proj."""
    return {"q": _linear(sd, f"{prefix}.q_proj"),
            "k": _linear(sd, f"{prefix}.k_proj"),
            "v": _linear(sd, f"{prefix}.v_proj"),
            "out": _linear(sd, f"{prefix}.out_proj")}


def convert_sam2(state_dict: Mapping[str, Any], cfg) -> Dict[str, Any]:
    """Published SAM2.1 checkpoint (state dict under "model") ->
    ``decomp.sam2`` params (``cfg``: a ``SAM2Config``): the Hiera trunk and
    FPN neck, the memory attention, the memory encoder, the prompt encoder
    and the mask decoder with its object-score head."""
    sd = _SD(state_dict.get("model", state_dict))

    tk = "image_encoder.trunk"
    blocks = []
    for i, (din, dout, _, _, _) in enumerate(cfg.hiera.block_plan()):
        bp = f"{tk}.blocks.{i}"
        blk = {
            "ln1": _norm(sd, f"{bp}.norm1"),
            "qkv": _linear(sd, f"{bp}.attn.qkv"),
            "proj_attn": _linear(sd, f"{bp}.attn.proj"),
            "ln2": _norm(sd, f"{bp}.norm2"),
            "fc1": _linear(sd, f"{bp}.mlp.layers.0"),
            "fc2": _linear(sd, f"{bp}.mlp.layers.1"),
        }
        if din != dout:
            blk["proj"] = _linear(sd, f"{bp}.proj")
        blocks.append(blk)
    trunk = {
        "patch_embed": _conv(sd, f"{tk}.patch_embed.proj"),
        "pos_bkg": np.transpose(_np(sd.get(f"{tk}.pos_embed"))[0],
                                (1, 2, 0)),
        "pos_win": np.transpose(_np(sd.get(f"{tk}.pos_embed_window"))[0],
                                (1, 2, 0)),
        "blocks": blocks,
        "neck": [_conv(sd, f"image_encoder.neck.convs.{i}.conv")
                 for i in range(len(cfg.hiera.stages))],
    }

    ma = "memory_attention"
    mem_layers = []
    for i in range(cfg.mem_layers):
        lp = f"{ma}.layers.{i}"
        mem_layers.append({
            "norm1": _norm(sd, f"{lp}.norm1"),
            "self": _sam2_attn(sd, f"{lp}.self_attn"),
            "norm2": _norm(sd, f"{lp}.norm2"),
            "cross": _sam2_attn(sd, f"{lp}.cross_attn_image"),
            "norm3": _norm(sd, f"{lp}.norm3"),
            "lin1": _linear(sd, f"{lp}.linear1"),
            "lin2": _linear(sd, f"{lp}.linear2"),
        })

    me = "memory_encoder"
    mask_down = [_conv(sd, f"{me}.mask_downsampler.encoder.{3 * i}")
                 for i in range(4)]
    mask_down.append(_conv(sd, f"{me}.mask_downsampler.encoder.12"))
    fuser = []
    for i in range(2):
        fp = f"{me}.fuser.layers.{i}"
        fuser.append({
            "dwconv": _conv(sd, f"{fp}.dwconv"),
            "norm": _norm(sd, f"{fp}.norm"),
            "pw1": _linear(sd, f"{fp}.pwconv1"),
            "pw2": _linear(sd, f"{fp}.pwconv2"),
            "gamma": sd.get(f"{fp}.gamma"),
        })

    pe = "sam_prompt_encoder"
    prompt = {
        "pe_gaussian": sd.get(
            f"{pe}.pe_layer.positional_encoding_gaussian_matrix"),
        "point_embed": np.concatenate(
            [sd.get(f"{pe}.point_embeddings.{i}.weight")
             for i in range(4)], axis=0),
        "not_a_point": sd.get(f"{pe}.not_a_point_embed.weight")[0],
        "no_mask_embed": sd.get(f"{pe}.no_mask_embed.weight")[0],
        "mask_down": [_conv(sd, f"{pe}.mask_downscaling.0"),
                      _conv(sd, f"{pe}.mask_downscaling.3"),
                      _conv(sd, f"{pe}.mask_downscaling.6")],
        "mask_down_ln": [_norm(sd, f"{pe}.mask_downscaling.1"),
                         _norm(sd, f"{pe}.mask_downscaling.4")],
    }

    md = "sam_mask_decoder"
    decoder = {
        "obj_token": sd.get(f"{md}.obj_score_token.weight")[0],
        "iou_token": sd.get(f"{md}.iou_token.weight")[0],
        "mask_tokens": sd.get(f"{md}.mask_tokens.weight"),
        "transformer": [_two_way_layer(sd, f"{md}.transformer.layers.{i}",
                                       ("layers.0", "layers.1"))
                        for i in range(2)],
        "final_attn": _sam_decoder_attn(
            sd, f"{md}.transformer.final_attn_token_to_image"),
        "final_ln": _norm(sd, f"{md}.transformer.norm_final_attn"),
        "up1": _deconv(sd, f"{md}.output_upscaling.0"),
        "up_ln": _norm(sd, f"{md}.output_upscaling.1"),
        "up2": _deconv(sd, f"{md}.output_upscaling.3"),
        "conv_s0": _conv(sd, f"{md}.conv_s0"),
        "conv_s1": _conv(sd, f"{md}.conv_s1"),
        "mask_mlps": [_mlp3(sd, f"{md}.output_hypernetworks_mlps.{i}")
                      for i in range(cfg.num_mask_tokens)],
        "iou_mlp": _mlp3(sd, f"{md}.iou_prediction_head"),
        "obj_mlp": _mlp3(sd, f"{md}.pred_obj_score_head"),
    }

    # the stride-4 conv of the mask-input-as-output path, when present
    extras = {}
    if sd.has("mask_downsample.weight"):
        extras["mask_downsample"] = _conv(sd, "mask_downsample")

    return {
        "trunk": trunk,
        "mem_attn": {"layers": mem_layers, "norm": _norm(sd, f"{ma}.norm")},
        "mem_enc": {
            "mask_down": mask_down,
            "mask_down_ln": [
                _norm(sd, f"{me}.mask_downsampler.encoder.{3 * i + 1}")
                for i in range(4)],
            "pix_proj": _conv(sd, f"{me}.pix_feat_proj"),
            "fuser": fuser,
            "out_proj": _conv(sd, f"{me}.out_proj"),
        },
        "maskmem_tpos_enc": _np(
            sd.get("maskmem_tpos_enc")).reshape(cfg.num_maskmem, -1),
        "no_mem_embed": _np(sd.get("no_mem_embed")).reshape(-1),
        "no_mem_pos_enc": _np(sd.get("no_mem_pos_enc")).reshape(-1),
        "no_obj_ptr": _np(sd.get("no_obj_ptr")).reshape(-1),
        "obj_ptr_proj": _mlp3(sd, "obj_ptr_proj"),
        "prompt": prompt,
        "decoder": decoder,
        **extras,
    }


def convert_hmr2(state_dict: Mapping[str, Any], cfg,
                 head_prefix: str = "smpl_head",
                 pose_buffer: str = "init_body_pose") -> Dict[str, Any]:
    """HMR2 lightning checkpoint state dict -> ``decomp.hmr`` params
    (``cfg``: an ``HMRConfig``).

    backbone.* is the ViTPose-style ViT; {head_prefix}.transformer is
    pose_transformer.py's TransformerDecoder (to_token_embedding,
    pos_embedding, transformer.layers.{i}.{0,1,2} = PreNorm(self-attention
    / cross-attention / FeedForward)); decpose / decshape / deccam; the IEF
    anchors are the registered buffers init_*_pose / init_betas / init_cam.
    Training-only keys (discriminator, body-model buffers) are ignored.
    HaMeR: ``head_prefix='mano_head'``, ``pose_buffer='init_hand_pose'``.
    """
    sd = _SD({k: v for k, v in state_dict.items()
              if k.startswith(("backbone.", head_prefix + "."))})
    tr = f"{head_prefix}.transformer"
    layers = []
    for i in range(cfg.head_layers):
        lp = f"{tr}.transformer.layers.{i}"
        layers.append({
            "ln1": _norm(sd, f"{lp}.0.norm"),
            "qkv": _linear(sd, f"{lp}.0.fn.to_qkv", bias=False),
            "attn_out": _linear(sd, f"{lp}.0.fn.to_out.0"),
            "ln2": _norm(sd, f"{lp}.1.norm"),
            "to_q": _linear(sd, f"{lp}.1.fn.to_q", bias=False),
            "to_kv": _linear(sd, f"{lp}.1.fn.to_kv", bias=False),
            "cross_out": _linear(sd, f"{lp}.1.fn.to_out.0"),
            "ln3": _norm(sd, f"{lp}.2.norm"),
            "fc1": _linear(sd, f"{lp}.2.fn.net.0"),
            "fc2": _linear(sd, f"{lp}.2.fn.net.3"),
        })
    return {
        "backbone": _vitpose_backbone(sd, cfg.backbone.depth),
        "token_embed": _linear(sd, f"{tr}.to_token_embedding"),
        "pos_embed": _np(sd.get(f"{tr}.pos_embedding"))[0],
        "layers": layers,
        "dec_pose": _linear(sd, f"{head_prefix}.decpose"),
        "dec_betas": _linear(sd, f"{head_prefix}.decshape"),
        "dec_cam": _linear(sd, f"{head_prefix}.deccam"),
        "mean_pose": _np(sd.get(f"{head_prefix}.{pose_buffer}"))[0],
        "mean_betas": _np(sd.get(f"{head_prefix}.init_betas"))[0],
        "mean_cam": _np(sd.get(f"{head_prefix}.init_cam"))[0],
    }


def convert_hamer(state_dict: Mapping[str, Any], cfg) -> Dict[str, Any]:
    """HaMeR checkpoint -> ``decomp.hmr`` params (MANO head naming)."""
    return convert_hmr2(state_dict, cfg, head_prefix="mano_head",
                        pose_buffer="init_hand_pose")


def convert_dinov2(state_dict: Mapping[str, Any], depth: int,
                   prefix: str = "pretrained") -> Dict[str, Any]:
    """DINOv2 encoder (DepthAnythingV2's ``pretrained.*`` keys) ->
    ``decomp.vit`` params: cls token, LayerScale (ls1 / ls2 gamma), packed
    qkv. The DPT head has no converter (in neither package)."""
    sd = _SD(state_dict)
    blocks = []
    for i in range(depth):
        bp = f"{prefix}.blocks.{i}"
        blocks.append({
            "ln1": _norm(sd, f"{bp}.norm1"),
            "qkv": _linear(sd, f"{bp}.attn.qkv"),
            "proj": _linear(sd, f"{bp}.attn.proj"),
            "ln2": _norm(sd, f"{bp}.norm2"),
            "fc1": _linear(sd, f"{bp}.mlp.fc1"),
            "fc2": _linear(sd, f"{bp}.mlp.fc2"),
            "ls1": sd.get(f"{bp}.ls1.gamma"),
            "ls2": sd.get(f"{bp}.ls2.gamma"),
        })
    pos = _np(sd.get(f"{prefix}.pos_embed"))[0]  # (1+S, D) incl cls
    return {
        "patch_embed": _conv(sd, f"{prefix}.patch_embed.proj"),
        "cls_token": _np(sd.get(f"{prefix}.cls_token"))[0, 0],
        "pos_embed": pos,
        "blocks": blocks,
        "ln_out": _norm(sd, f"{prefix}.norm"),
    }


# ---------------------------------------------------------------------------
# RAFT (raft-things.pth lineage; keys may carry a DataParallel "module." prefix)
# ---------------------------------------------------------------------------


def convert_raft(state_dict: Mapping[str, Any], cfg) -> Dict[str, Any]:
    """Published RAFT checkpoint -> ``decomp.raft`` params (``cfg``: a
    ``RAFTConfig``).

    fnet and cnet are BasicEncoders (conv1 + norm1 stem, layer{1,2,3}.{0,1}
    residual blocks with an optional downsample, conv2 head); the update
    block is the motion encoder (convc1 / convc2 / convf1 / convf2 / conv),
    the SepConvGRU (convz1 / r1 / q1 horizontal, convz2 / r2 / q2
    vertical), the flow head and the mask head (mask.0 / mask.2). fnet's
    instance norms have no parameters (identity scale and bias); cnet's
    eval-mode BatchNorm2d folds into a fixed affine, scale = weight /
    sqrt(running_var + eps), bias = bias - running_mean * scale."""
    sd = _SD({k[len("module."):] if k.startswith("module.") else k: v
              for k, v in state_dict.items()})

    def inorm(c):
        return {"scale": np.ones((c,), np.float32),
                "bias": np.zeros((c,), np.float32)}

    def bnorm(prefix, c):
        w = _np(sd.get(f"{prefix}.weight")).astype(np.float32)
        b = _np(sd.get(f"{prefix}.bias")).astype(np.float32)
        rm = _np(sd.get(f"{prefix}.running_mean")).astype(np.float32)
        rv = _np(sd.get(f"{prefix}.running_var")).astype(np.float32)
        if sd.has(f"{prefix}.num_batches_tracked"):
            sd.get(f"{prefix}.num_batches_tracked")  # consume the buffer
        scale = w / np.sqrt(rv + 1e-5)
        return {"scale": scale, "bias": b - rm * scale}

    def resunit(prefix, c_out, stride, norm):
        p = {
            "conv1": _conv(sd, f"{prefix}.conv1"),
            "n1": norm(f"{prefix}.norm1", c_out),
            "conv2": _conv(sd, f"{prefix}.conv2"),
            "n2": norm(f"{prefix}.norm2", c_out),
            "stride": stride,
        }
        if sd.has(f"{prefix}.downsample.0.weight"):
            p["down"] = _conv(sd, f"{prefix}.downsample.0")
            p["dn"] = norm(f"{prefix}.norm3", c_out)
        return p

    def encoder(prefix, norm_fn):
        norm = (lambda pre, c: inorm(c)) if norm_fn == "instance" else bnorm
        d1, d2, d3 = cfg.enc_dims
        return {
            "stem": _conv(sd, f"{prefix}.conv1"),
            "stem_n": norm(f"{prefix}.norm1", d1),
            "layer1": [resunit(f"{prefix}.layer1.0", d1, 1, norm),
                       resunit(f"{prefix}.layer1.1", d1, 1, norm)],
            "layer2": [resunit(f"{prefix}.layer2.0", d2, 2, norm),
                       resunit(f"{prefix}.layer2.1", d2, 1, norm)],
            "layer3": [resunit(f"{prefix}.layer3.0", d3, 2, norm),
                       resunit(f"{prefix}.layer3.1", d3, 1, norm)],
            "head": _conv(sd, f"{prefix}.conv2"),
        }

    ub = "update_block"
    return {
        "fnet": encoder("fnet", "instance"),
        "cnet": encoder("cnet", "batch"),
        "update": {
            "mc1": _conv(sd, f"{ub}.encoder.convc1"),
            "mc2": _conv(sd, f"{ub}.encoder.convc2"),
            "mf1": _conv(sd, f"{ub}.encoder.convf1"),
            "mf2": _conv(sd, f"{ub}.encoder.convf2"),
            "mout": _conv(sd, f"{ub}.encoder.conv"),
            "gru": {k: _conv(sd, f"{ub}.gru.conv{k}")
                    for k in ("z1", "r1", "q1", "z2", "r2", "q2")},
            "fh1": _conv(sd, f"{ub}.flow_head.conv1"),
            "fh2": _conv(sd, f"{ub}.flow_head.conv2"),
            "up1": _conv(sd, f"{ub}.mask.0"),
            "up2": _conv(sd, f"{ub}.mask.2"),
        },
    }


# ---------------------------------------------------------------------------
# ProPainter (ProPainter.pth + recurrent_flow_completion.pth)
# ---------------------------------------------------------------------------


def _conv3d_spatial(sd: _SD, prefix: str) -> Dict[str, np.ndarray]:
    """Conv3d with kt = 1 (C_out, C_in, 1, kh, kw) -> a 2-D HWIO conv."""
    w = _np(sd.get(prefix + ".weight"))[:, :, 0]
    p = {"kernel": _t_conv(w)}
    if sd.has(prefix + ".bias"):
        p["bias"] = sd.get(prefix + ".bias")
    return p


def _conv3d_temporal(sd: _SD, prefix: str) -> Dict[str, np.ndarray]:
    """Conv3d (C_out, C_in, 3, 1, 1) -> the (3, C_in, C_out) kernel."""
    w = _np(sd.get(prefix + ".weight"))[:, :, :, 0, 0]
    return {"kernel": np.transpose(w, (2, 1, 0)),
            "bias": _np(sd.get(prefix + ".bias"))}


def _offset_stack_from(sd: _SD, prefix: str) -> Dict[str, Any]:
    return {"c1": _conv(sd, f"{prefix}.0"), "c2": _conv(sd, f"{prefix}.2"),
            "c3": _conv(sd, f"{prefix}.4"), "c4": _conv(sd, f"{prefix}.6")}


def _deform_align_from(sd: _SD, prefix: str) -> Dict[str, Any]:
    return {
        "offset": _offset_stack_from(sd, f"{prefix}.conv_offset"),
        "kernel": _t_conv(sd.get(f"{prefix}.weight")),
        "bias": sd.get(f"{prefix}.bias"),
    }


def _p3d_from(sd: _SD, prefix: str) -> Dict[str, Any]:
    return {"spatial": _conv3d_spatial(sd, f"{prefix}.conv1.0"),
            "temporal": _conv3d_temporal(sd, f"{prefix}.conv2.0")}


def convert_propainter(gen_sd: Mapping[str, Any],
                       flow_sd: Mapping[str, Any], cfg) -> Dict[str, Any]:
    """Published ProPainter checkpoints -> ``decomp.propainter`` params
    (``cfg``: a ``ProPainterConfig``). gen_sd: ``ProPainter.pth`` (the
    InpaintGenerator); flow_sd: ``recurrent_flow_completion.pth`` (the
    RecurrentFlowCompleteNet), whose training-only edge detector is read
    and dropped."""
    fs = _SD(flow_sd)
    fp = "feat_prop_module"
    flow = {
        "down": _conv3d_spatial(fs, "downsample.0"),
        "enc1a": _p3d_from(fs, "encoder1.0"),
        "enc1b": _p3d_from(fs, "encoder1.2"),
        "enc2a": _p3d_from(fs, "encoder2.0"),
        "enc2b": _p3d_from(fs, "encoder2.2"),
        "mid": [_conv3d_spatial(fs, f"mid_dilation.{2 * i}")
                for i in range(3)],
        "prop": {
            "align_bwd": _deform_align_from(
                fs, f"{fp}.deform_align.backward_"),
            "align_fwd": _deform_align_from(
                fs, f"{fp}.deform_align.forward_"),
            "backbone_bwd": [_conv(fs, f"{fp}.backbone.backward_.0"),
                             _conv(fs, f"{fp}.backbone.backward_.2")],
            "backbone_fwd": [_conv(fs, f"{fp}.backbone.forward_.0"),
                             _conv(fs, f"{fp}.backbone.forward_.2")],
            "fusion": _conv(fs, f"{fp}.fusion"),
        },
        "dec2": [_conv(fs, "decoder2.0"), _conv(fs, "decoder2.2.conv")],
        "dec1": [_conv(fs, "decoder1.0"), _conv(fs, "decoder1.2.conv")],
        "up": [_conv(fs, "upsample.0"), _conv(fs, "upsample.2.conv")],
    }
    for k in list(fs.sd):
        if k.startswith("edgeDetector."):
            fs.get(k)  # training-only head: read, unused at inference

    gs = _SD(gen_sd)
    enc = [_conv(gs, f"encoder.layers.{2 * i}") for i in range(9)]
    blocks = []
    for i in range(cfg.depths):
        tp = f"transformers.transformer.{i}"
        if gs.has(f"{tp}.attention.valid_ind_rolled"):
            gs.get(f"{tp}.attention.valid_ind_rolled")  # a static buffer
        blocks.append({
            "ln1": _norm(gs, f"{tp}.norm1"),
            "q": _linear(gs, f"{tp}.attention.query"),
            "k": _linear(gs, f"{tp}.attention.key"),
            "v": _linear(gs, f"{tp}.attention.value"),
            "proj": _linear(gs, f"{tp}.attention.proj"),
            "pool": _conv(gs, f"{tp}.attention.pool_layer"),
            "ln2": _norm(gs, f"{tp}.norm2"),
            "ff1": _linear(gs, f"{tp}.mlp.fc1.0"),
            "ff2": _linear(gs, f"{tp}.mlp.fc2.1"),
        })
    gen = {
        "enc": enc,
        "ss": _linear(gs, "ss.embedding"),
        "sc": _linear(gs, "sc.embedding"),
        "sc_bias": _conv(gs, "sc.bias_conv"),
        "blocks": blocks,
        "align_bwd": _deform_align_from(gs, f"{fp}.deform_align.backward_1"),
        "align_fwd": _deform_align_from(gs, f"{fp}.deform_align.forward_1"),
        "backbone_bwd": [_conv(gs, f"{fp}.backbone.backward_1.0"),
                         _conv(gs, f"{fp}.backbone.backward_1.2")],
        "backbone_fwd": [_conv(gs, f"{fp}.backbone.forward_1.0"),
                         _conv(gs, f"{fp}.backbone.forward_1.2")],
        "fuse": [_conv(gs, f"{fp}.fuse.0"), _conv(gs, f"{fp}.fuse.2")],
        "dec": [_conv(gs, "decoder.0.conv"), _conv(gs, "decoder.2"),
                _conv(gs, "decoder.4.conv"), _conv(gs, "decoder.6")],
    }
    return {"flow": flow, "gen": gen}


def convert_bundles(out_dir: str, *, sam: str = None, sam2: str = None,
                    vitpose: str = None, hmr2: str = None,
                    hamer: str = None, raft: str = None,
                    propainter: str = None,
                    flow_complete: str = None) -> Dict[str, str]:
    """Convert each checkpoint given into ``out_dir/<bundle>.npz`` at the
    published widths; returns {bundle: path}. ``propainter`` (the
    generator) needs ``flow_complete`` (the flow completion net) beside
    it."""
    from mimo_tpu_torch.decomp import factory
    cfg = dict(zip(factory.BUNDLES, factory.configs(tiny=False)))
    if (propainter is None) != (flow_complete is None):
        raise ValueError("propainter and flow_complete go together")
    jobs = {"sam": (sam, convert_sam), "sam2": (sam2, convert_sam2),
            "vitpose": (vitpose, convert_vitpose),
            "hmr": (hmr2, convert_hmr2), "hamer": (hamer, convert_hamer),
            "raft": (raft, convert_raft),
            "propainter": (propainter, lambda sd, c: convert_propainter(
                sd, load_state_dict(flow_complete), c))}
    os.makedirs(out_dir, exist_ok=True)
    written = {}
    for name, (path, convert) in jobs.items():
        if path is None:
            continue
        tree = convert(load_state_dict(path), cfg[name])
        written[name] = os.path.join(out_dir, f"{name}.npz")
        save_npz(tree, written[name])
        print(f"wrote {len(flatten_tree(tree))} arrays to {written[name]}")
    return written


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Convert the decomposition models' published checkpoints "
                    "into the npz bundles that "
                    "mimo_tpu_torch.decomp.factory.build_decomp_models reads.")
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--sam", help="SAM ViT-H .pth -> sam.npz")
    ap.add_argument("--sam2", help="SAM2.1 Hiera-L .pt -> sam2.npz")
    ap.add_argument("--vitpose", help="ViTPose-H wholebody .pth -> vitpose.npz")
    ap.add_argument("--hmr2", help="HMR2 checkpoint -> hmr.npz")
    ap.add_argument("--hamer", help="HaMeR checkpoint -> hamer.npz")
    ap.add_argument("--raft", help="RAFT raft-things.pth -> raft.npz")
    ap.add_argument("--propainter", help="ProPainter.pth -> propainter.npz "
                    "(with --flow-complete)")
    ap.add_argument("--flow-complete",
                    help="recurrent_flow_completion.pth (with --propainter)")
    args = ap.parse_args(argv)
    names = ("sam", "sam2", "vitpose", "hmr2", "hamer", "raft", "propainter",
             "flow_complete")
    given = {k: getattr(args, k) for k in names}
    if not any(given.values()):
        ap.error("no checkpoint given")
    if (args.propainter is None) != (args.flow_complete is None):
        ap.error("--propainter and --flow-complete go together")
    convert_bundles(args.out_dir, **given)


if __name__ == "__main__":
    main()
