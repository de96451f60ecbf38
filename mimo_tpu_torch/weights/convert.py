"""PyTorch checkpoints -> the flat npz weight bundle of the port.

The port's own copy of ``mimo_tpu/weights/convert.py``: the same functions
and the same output tree, with its configs from ``mimo_tpu_torch.config``,
so a machine without JAX can go from the reference's checkpoints
(README.md:98-117: SD1.5 UNet for both UNet roles, sd-vae-ft-mse, CLIP
image encoder, and MIMO's own denoising_unet.pth / reference_unet.pth /
pose_guider.pth / motion_module.pth) to the bundle that
``entry.runner.load_params`` (``weights/bridge.py``) reads and the
``--weights`` option of ``entry/animate.py`` takes.

Key transforms (the reference converter's):
- torch Linear (out, in) -> (in, out)
- torch Conv2d OIHW -> HWIO (the bridge turns conv kernels back to OIHW)
- diffusers UNet key naming -> the nested tree of ``models/unet.py``
- conv_in channel padding 4 -> 8 for the denoising UNet when starting from
  stock SD weights (the reference zero-pads the extra background-latent
  channels, unet_3d_edit_bkfill.py:663-670)

Usage:

    python -m mimo_tpu_torch.weights.convert --sd-unet SD15_UNET \
        --denoising-unet denoising_unet.pth --reference-unet \
        reference_unet.pth --motion-module motion_module.pth \
        --pose-guider pose_guider.pth --vae VAE --clip CLIP --out bundle.npz

A tensor checkpoint is read with ``torch.load`` (``weights_only``) on the
CPU, a ``.safetensors`` one with ``safetensors.numpy``.
"""

from __future__ import annotations

import argparse
import re
from typing import Any, Dict, Mapping

import numpy as np

from mimo_tpu_torch.config import (CLIPVisionConfig, MIMOConfig,
                                   PoseGuiderConfig, UNetConfig, VAEConfig)


def _t_linear(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w.T)


def _t_conv(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        return x.detach().cpu().float().numpy()
    return np.asarray(x, dtype=np.float32)


class _SD:
    """Source state-dict view with key tracking."""

    def __init__(self, sd: Mapping[str, Any]):
        self.sd = {k: v for k, v in sd.items()}
        self.used = set()

    def get(self, key: str) -> np.ndarray:
        self.used.add(key)
        return _np(self.sd[key])

    def has(self, key: str) -> bool:
        return key in self.sd

    def unused(self):
        return sorted(set(self.sd) - self.used)


def _linear(sd: _SD, prefix: str, bias: bool = True) -> Dict[str, np.ndarray]:
    p = {"kernel": _t_linear(sd.get(prefix + ".weight"))}
    if bias and sd.has(prefix + ".bias"):
        p["bias"] = sd.get(prefix + ".bias")
    return p


def _conv(sd: _SD, prefix: str) -> Dict[str, np.ndarray]:
    p = {"kernel": _t_conv(sd.get(prefix + ".weight"))}
    if sd.has(prefix + ".bias"):
        p["bias"] = sd.get(prefix + ".bias")
    return p


def _norm(sd: _SD, prefix: str) -> Dict[str, np.ndarray]:
    return {"scale": sd.get(prefix + ".weight"),
            "bias": sd.get(prefix + ".bias")}


def _resnet(sd: _SD, prefix: str, has_temb: bool) -> Dict[str, Any]:
    p = {
        "norm1": _norm(sd, f"{prefix}.norm1"),
        "conv1": _conv(sd, f"{prefix}.conv1"),
        "norm2": _norm(sd, f"{prefix}.norm2"),
        "conv2": _conv(sd, f"{prefix}.conv2"),
    }
    if has_temb and sd.has(f"{prefix}.time_emb_proj.weight"):
        p["temb_proj"] = _linear(sd, f"{prefix}.time_emb_proj")
    if sd.has(f"{prefix}.conv_shortcut.weight"):
        p["shortcut"] = _conv(sd, f"{prefix}.conv_shortcut")
    if sd.has(f"{prefix}.nin_shortcut.weight"):
        p["shortcut"] = _conv(sd, f"{prefix}.nin_shortcut")
    return p


def _mha(sd: _SD, prefix: str) -> Dict[str, Any]:
    return {
        "to_q": _linear(sd, f"{prefix}.to_q"),
        "to_k": _linear(sd, f"{prefix}.to_k"),
        "to_v": _linear(sd, f"{prefix}.to_v"),
        "to_out": _linear(sd, f"{prefix}.to_out.0"),
    }


def _geglu_ff(sd: _SD, prefix: str) -> Dict[str, Any]:
    return {
        "proj_in": _linear(sd, f"{prefix}.net.0.proj"),
        "proj_out": _linear(sd, f"{prefix}.net.2"),
    }


def _spatial_transformer(sd: _SD, prefix: str) -> Dict[str, Any]:
    blk = f"{prefix}.transformer_blocks.0"
    return {
        "norm": _norm(sd, f"{prefix}.norm"),
        "proj_in": _conv(sd, f"{prefix}.proj_in"),
        "norm1": _norm(sd, f"{blk}.norm1"),
        "attn1": _mha(sd, f"{blk}.attn1"),
        "norm2": _norm(sd, f"{blk}.norm2"),
        "attn2": _mha(sd, f"{blk}.attn2"),
        "norm3": _norm(sd, f"{blk}.norm3"),
        "ff": _geglu_ff(sd, f"{blk}.ff"),
        "proj_out": _conv(sd, f"{prefix}.proj_out"),
    }


def _motion_module(sd: _SD, prefix: str, n_blocks: int,
                   n_attns: int) -> Dict[str, Any]:
    tt = f"{prefix}.temporal_transformer"
    blocks = []
    for k in range(n_blocks):
        bp = f"{tt}.transformer_blocks.{k}"
        attns = []
        for a in range(n_attns):
            attns.append({
                "norm": _norm(sd, f"{bp}.norms.{a}"),
                "attn": _mha(sd, f"{bp}.attention_blocks.{a}"),
            })
        blocks.append({
            "attns": attns,
            "ff_norm": _norm(sd, f"{bp}.ff_norm"),
            "ff": _geglu_ff(sd, f"{bp}.ff"),
        })
    return {
        "norm": _norm(sd, f"{tt}.norm"),
        "proj_in": _linear(sd, f"{tt}.proj_in"),
        "blocks": blocks,
        "proj_out": _linear(sd, f"{tt}.proj_out"),
    }


def convert_unet(state_dict: Mapping[str, Any], cfg: UNetConfig,
                 strict: bool = False) -> Dict[str, Any]:
    """diffusers UNet2DConditionModel naming (+ optional motion_modules) →
    our tree. Handles both UNet roles; pads conv_in 4→8 channels if needed."""
    sd = _SD(state_dict)
    mm = cfg.use_motion_module
    nb, na = cfg.motion.num_transformer_blocks, cfg.motion.attentions_per_block

    conv_in = _conv(sd, "conv_in")
    cin_have = conv_in["kernel"].shape[2]
    if cin_have < cfg.in_channels:
        # zero-pad extra input channels (reference unet_3d_edit_bkfill.py:663-670)
        pad = np.zeros(conv_in["kernel"].shape[:2]
                       + (cfg.in_channels - cin_have,)
                       + conv_in["kernel"].shape[3:], np.float32)
        conv_in["kernel"] = np.concatenate([conv_in["kernel"], pad], axis=2)

    p: Dict[str, Any] = {
        "conv_in": conv_in,
        "time_mlp": {"fc1": _linear(sd, "time_embedding.linear_1"),
                     "fc2": _linear(sd, "time_embedding.linear_2")},
    }

    down = []
    for i in range(cfg.num_blocks):
        has_attn = cfg.cross_attn_blocks[i]
        blk: Dict[str, Any] = {"resnets": [], "attns": [] if has_attn else None,
                               "motions": [] if mm else None}
        for j in range(cfg.layers_per_block):
            blk["resnets"].append(
                _resnet(sd, f"down_blocks.{i}.resnets.{j}", True))
            if has_attn:
                blk["attns"].append(_spatial_transformer(
                    sd, f"down_blocks.{i}.attentions.{j}"))
            if mm:
                blk["motions"].append(_motion_module(
                    sd, f"down_blocks.{i}.motion_modules.{j}", nb, na))
        blk["downsample"] = (
            _conv(sd, f"down_blocks.{i}.downsamplers.0.conv")
            if sd.has(f"down_blocks.{i}.downsamplers.0.conv.weight") else None)
        down.append(blk)
    p["down"] = down

    p["mid"] = {
        "resnets": [_resnet(sd, "mid_block.resnets.0", True),
                    _resnet(sd, "mid_block.resnets.1", True)],
        "attns": [_spatial_transformer(sd, "mid_block.attentions.0")],
        "motions": ([_motion_module(sd, "mid_block.motion_modules.0", nb, na)]
                    if (mm and cfg.motion_module_mid_block
                        and sd.has("mid_block.motion_modules.0."
                                   "temporal_transformer.proj_in.weight"))
                    else None),
    }

    up = []
    for i in range(cfg.num_blocks):
        has_attn = list(reversed(cfg.cross_attn_blocks))[i]
        blk = {"resnets": [], "attns": [] if has_attn else None,
               "motions": [] if mm else None}
        for j in range(cfg.layers_per_block + 1):
            blk["resnets"].append(
                _resnet(sd, f"up_blocks.{i}.resnets.{j}", True))
            if has_attn:
                blk["attns"].append(_spatial_transformer(
                    sd, f"up_blocks.{i}.attentions.{j}"))
            if mm:
                blk["motions"].append(_motion_module(
                    sd, f"up_blocks.{i}.motion_modules.{j}", nb, na))
        blk["upsample"] = (
            _conv(sd, f"up_blocks.{i}.upsamplers.0.conv")
            if sd.has(f"up_blocks.{i}.upsamplers.0.conv.weight") else None)
        up.append(blk)
    p["up"] = up

    p["norm_out"] = _norm(sd, "conv_norm_out")
    p["conv_out"] = _conv(sd, "conv_out")

    if strict:
        # known non-parameter buffers in real checkpoints: CLIP's integer
        # position_ids-style buffers and the motion module's persistent
        # sinusoidal PE (reference motion_module.py:275 register_buffer)
        leftovers = [k for k in sd.unused()
                     if not k.endswith("position_embedding")
                     and not k.endswith("pos_encoder.pe")]
        assert not leftovers, f"unconverted keys: {leftovers[:10]}"
    return p


def convert_vae(state_dict: Mapping[str, Any], cfg: VAEConfig) -> Dict[str, Any]:
    sd = _SD(state_dict)
    n = len(cfg.block_out_channels)

    def vae_attn(prefix):
        return {
            "norm": _norm(sd, f"{prefix}.group_norm"),
            "to_q": _linear(sd, f"{prefix}.to_q"),
            "to_k": _linear(sd, f"{prefix}.to_k"),
            "to_v": _linear(sd, f"{prefix}.to_v"),
            "to_out": _linear(sd, f"{prefix}.to_out.0"),
        }

    def mid(prefix):
        return {
            "resnet1": _resnet(sd, f"{prefix}.resnets.0", False),
            "attn": vae_attn(f"{prefix}.attentions.0"),
            "resnet2": _resnet(sd, f"{prefix}.resnets.1", False),
        }

    enc: Dict[str, Any] = {"conv_in": _conv(sd, "encoder.conv_in")}
    downs = []
    for i in range(n):
        blk = {"resnets": [_resnet(sd, f"encoder.down_blocks.{i}.resnets.{j}",
                                   False)
                           for j in range(cfg.layers_per_block)]}
        key = f"encoder.down_blocks.{i}.downsamplers.0.conv"
        blk["downsample"] = _conv(sd, key) if sd.has(key + ".weight") else None
        downs.append(blk)
    enc["down"] = downs
    enc["mid"] = mid("encoder.mid_block")
    enc["norm_out"] = _norm(sd, "encoder.conv_norm_out")
    enc["conv_out"] = _conv(sd, "encoder.conv_out")

    dec: Dict[str, Any] = {"conv_in": _conv(sd, "decoder.conv_in")}
    dec["mid"] = mid("decoder.mid_block")
    ups = []
    for i in range(n):
        blk = {"resnets": [_resnet(sd, f"decoder.up_blocks.{i}.resnets.{j}",
                                   False)
                           for j in range(cfg.layers_per_block + 1)]}
        key = f"decoder.up_blocks.{i}.upsamplers.0.conv"
        blk["upsample"] = _conv(sd, key) if sd.has(key + ".weight") else None
        ups.append(blk)
    dec["up"] = ups
    dec["norm_out"] = _norm(sd, "decoder.conv_norm_out")
    dec["conv_out"] = _conv(sd, "decoder.conv_out")

    return {
        "encoder": enc,
        "decoder": dec,
        "quant_conv": _conv(sd, "quant_conv"),
        "post_quant_conv": _conv(sd, "post_quant_conv"),
    }


def convert_pose_guider(state_dict: Mapping[str, Any],
                        cfg: PoseGuiderConfig) -> Dict[str, Any]:
    sd = _SD(state_dict)
    n = len(cfg.block_out_channels)
    blocks = []
    for i in range(n - 1):
        blocks.append({
            "conv_a": _conv(sd, f"blocks.{2 * i}"),
            "conv_b": _conv(sd, f"blocks.{2 * i + 1}"),
        })
    return {
        "conv_in": _conv(sd, "conv_in"),
        "blocks": blocks,
        "conv_out": _conv(sd, "conv_out"),
    }


def convert_clip_vision(state_dict: Mapping[str, Any],
                        cfg: CLIPVisionConfig) -> Dict[str, Any]:
    sd = _SD(state_dict)
    vm = "vision_model"
    layers = []
    for i in range(cfg.num_layers):
        lp = f"{vm}.encoder.layers.{i}"
        layers.append({
            "ln1": _norm(sd, f"{lp}.layer_norm1"),
            "q": _linear(sd, f"{lp}.self_attn.q_proj"),
            "k": _linear(sd, f"{lp}.self_attn.k_proj"),
            "v": _linear(sd, f"{lp}.self_attn.v_proj"),
            "out": _linear(sd, f"{lp}.self_attn.out_proj"),
            "ln2": _norm(sd, f"{lp}.layer_norm2"),
            "fc1": _linear(sd, f"{lp}.mlp.fc1"),
            "fc2": _linear(sd, f"{lp}.mlp.fc2"),
        })
    # HF CLIP has a historical typo: "pre_layrnorm"
    pre_ln_key = (f"{vm}.pre_layrnorm" if sd.has(f"{vm}.pre_layrnorm.weight")
                  else f"{vm}.pre_layernorm")
    return {
        "patch_embed": {"kernel": _t_conv(
            sd.get(f"{vm}.embeddings.patch_embedding.weight"))},
        "class_embed": sd.get(f"{vm}.embeddings.class_embedding"),
        "pos_embed": sd.get(f"{vm}.embeddings.position_embedding.weight"),
        "pre_ln": _norm(sd, pre_ln_key),
        "layers": layers,
        "post_ln": _norm(sd, f"{vm}.post_layernorm"),
        "projection": _linear(sd, "visual_projection", bias=False),
    }


# ---------------------------------------------------------------------------
# top-level loaders
# ---------------------------------------------------------------------------


def _load_torch(path: str) -> Dict[str, Any]:
    import torch
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return obj


def _load_safetensors(path: str) -> Dict[str, Any]:
    from safetensors.numpy import load_file
    return load_file(path)


def load_state_dict(path: str) -> Dict[str, Any]:
    if path.endswith(".safetensors"):
        return _load_safetensors(path)
    return _load_torch(path)


def merge_state_dicts(*sds: Mapping[str, Any]) -> Dict[str, Any]:
    """Later dicts override earlier (the reference merges SD1.5 +
    motion_module.pth then overrides with denoising_unet.pth,
    unet_3d_edit_bkfill.py:639-661 + run_edit.py:105-108)."""
    out: Dict[str, Any] = {}
    for sd in sds:
        out.update(sd)
    return out


def convert_mimo_checkpoints(cfg: MIMOConfig, *, sd_unet_path: str,
                             denoising_unet_path: str,
                             reference_unet_path: str,
                             motion_module_path: str, pose_guider_path: str,
                             vae_path: str, clip_path: str) -> Dict[str, Any]:
    """Full bundle conversion mirroring run_edit.py:60-114 load order."""
    sd_unet = load_state_dict(sd_unet_path)
    den = merge_state_dicts(sd_unet, load_state_dict(motion_module_path),
                            load_state_dict(denoising_unet_path))
    ref = merge_state_dicts(sd_unet, load_state_dict(reference_unet_path))
    return {
        "denoising_unet": convert_unet(den, cfg.denoising_unet),
        "reference_unet": convert_unet(ref, cfg.reference_unet),
        "pose_guider": convert_pose_guider(load_state_dict(pose_guider_path),
                                           cfg.pose_guider),
        "vae": convert_vae(load_state_dict(vae_path), cfg.vae),
        "clip": convert_clip_vision(load_state_dict(clip_path),
                                    cfg.clip_vision),
    }


# ---------------------------------------------------------------------------
# flat (de)serialization without torch
# ---------------------------------------------------------------------------


def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_tree(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten_tree(v, f"{prefix}{i}/"))
    elif tree is None:
        out[prefix[:-1] + "#none"] = np.zeros((0,), np.float32)
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def unflatten_tree(flat: Mapping[str, np.ndarray]) -> Any:
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        if key.endswith("#none"):
            parts = key[: -len("#none")].split("/")
            leaf = None
        else:
            parts = key.split("/")
            leaf = val
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf

    def listify(node):
        if isinstance(node, dict):
            keys = list(node)
            if keys and all(re.fullmatch(r"\d+", k) for k in keys):
                return [listify(node[str(i)]) for i in range(len(keys))]
            return {k: listify(v) for k, v in node.items()}
        return node

    return listify(root)


def save_npz(tree: Any, path: str) -> None:
    np.savez(path, **flatten_tree(tree))


def load_npz(path: str) -> Any:
    with np.load(path) as f:
        return unflatten_tree({k: f[k] for k in f.files})


# the seven checkpoints of convert_mimo_checkpoints, as CLI options
CHECKPOINTS = ("sd_unet", "denoising_unet", "reference_unet", "motion_module",
               "pose_guider", "vae", "clip")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Convert MIMO's PyTorch checkpoints into the npz bundle "
                    "that `python -m mimo_tpu_torch.entry.animate --weights` "
                    "reads (MIMOConfig() widths).")
    for name in CHECKPOINTS:
        ap.add_argument("--" + name.replace("_", "-"), required=True,
                        help=f"{name} checkpoint (.pth/.bin/.safetensors)")
    ap.add_argument("--out", required=True, help="output .npz path")
    args = ap.parse_args(argv)
    tree = convert_mimo_checkpoints(
        MIMOConfig(), **{f"{name}_path": getattr(args, name)
                         for name in CHECKPOINTS})
    save_npz(tree, args.out)
    print(f"wrote {len(flatten_tree(tree))} arrays to {args.out}")


if __name__ == "__main__":
    main()
