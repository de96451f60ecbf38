"""The port's weight converter (mimo_tpu_torch/weights/convert.py) against
the reference's (mimo_tpu/weights/convert.py): diffusers-style state dicts
emitted from tiny-config JAX parameters go through both, and the flat trees
must be equal in every bit (same keys, dtypes, shapes and values); the
bundle the port writes loads through ``entry.runner.load_params``.

The UNet and pose guider state dicts come from tests/test_convert.py's
emitters; the VAE and CLIP ones from this file's (that file emits them
inline).
"""

import jax
import numpy as np
import pytest
import torch

from mimo_tpu import config as JC
from mimo_tpu.models import clip_vision as JCV
from mimo_tpu.models import pose_guider as JPG
from mimo_tpu.models import unet as JU
from mimo_tpu.models import vae as JV
from mimo_tpu.weights import convert as JW
from mimo_tpu_torch import config as C
from mimo_tpu_torch.entry import runner
from mimo_tpu_torch.weights import convert as W
from tests.test_convert import (_emit_conv, _emit_linear, _emit_norm,
                                _emit_resnet, _emit_unet)


def _emit_pose_guider(params):
    sd = {}
    _emit_conv(sd, "conv_in", params["conv_in"])
    for i, blk in enumerate(params["blocks"]):
        _emit_conv(sd, f"blocks.{2 * i}", blk["conv_a"])
        _emit_conv(sd, f"blocks.{2 * i + 1}", blk["conv_b"])
    _emit_conv(sd, "conv_out", params["conv_out"])
    return sd


def _emit_vae_mid(sd, prefix, p):
    _emit_resnet(sd, f"{prefix}.resnets.0", p["resnet1"])
    _emit_norm(sd, f"{prefix}.attentions.0.group_norm", p["attn"]["norm"])
    for name in ("to_q", "to_k", "to_v"):
        _emit_linear(sd, f"{prefix}.attentions.0.{name}", p["attn"][name])
    _emit_linear(sd, f"{prefix}.attentions.0.to_out.0", p["attn"]["to_out"])
    _emit_resnet(sd, f"{prefix}.resnets.1", p["resnet2"])


def _emit_vae(params):
    """diffusers AutoencoderKL naming (the encoder's down path, the
    decoder's up path, both mid blocks, the quant convs)."""
    sd = {}
    enc, dec = params["encoder"], params["decoder"]
    _emit_conv(sd, "encoder.conv_in", enc["conv_in"])
    for i, blk in enumerate(enc["down"]):
        for j, rp in enumerate(blk["resnets"]):
            _emit_resnet(sd, f"encoder.down_blocks.{i}.resnets.{j}", rp)
        if blk["downsample"] is not None:
            _emit_conv(sd, f"encoder.down_blocks.{i}.downsamplers.0.conv",
                       blk["downsample"])
    _emit_vae_mid(sd, "encoder.mid_block", enc["mid"])
    _emit_norm(sd, "encoder.conv_norm_out", enc["norm_out"])
    _emit_conv(sd, "encoder.conv_out", enc["conv_out"])
    _emit_conv(sd, "quant_conv", params["quant_conv"])
    _emit_conv(sd, "post_quant_conv", params["post_quant_conv"])
    _emit_conv(sd, "decoder.conv_in", dec["conv_in"])
    _emit_vae_mid(sd, "decoder.mid_block", dec["mid"])
    for i, blk in enumerate(dec["up"]):
        for j, rp in enumerate(blk["resnets"]):
            _emit_resnet(sd, f"decoder.up_blocks.{i}.resnets.{j}", rp)
        if blk["upsample"] is not None:
            _emit_conv(sd, f"decoder.up_blocks.{i}.upsamplers.0.conv",
                       blk["upsample"])
    _emit_norm(sd, "decoder.conv_norm_out", dec["norm_out"])
    _emit_conv(sd, "decoder.conv_out", dec["conv_out"])
    return sd


def _emit_clip(params):
    """transformers CLIPVisionModelWithProjection naming."""
    sd = {}
    vm = "vision_model"
    sd[f"{vm}.embeddings.patch_embedding.weight"] = np.transpose(
        np.asarray(params["patch_embed"]["kernel"]), (3, 2, 0, 1))
    sd[f"{vm}.embeddings.class_embedding"] = np.asarray(params["class_embed"])
    sd[f"{vm}.embeddings.position_embedding.weight"] = np.asarray(
        params["pos_embed"])
    _emit_norm(sd, f"{vm}.pre_layrnorm", params["pre_ln"])
    for i, lp in enumerate(params["layers"]):
        pre = f"{vm}.encoder.layers.{i}"
        _emit_norm(sd, f"{pre}.layer_norm1", lp["ln1"])
        for ours, theirs in (("q", "q_proj"), ("k", "k_proj"),
                             ("v", "v_proj"), ("out", "out_proj")):
            _emit_linear(sd, f"{pre}.self_attn.{theirs}", lp[ours])
        _emit_norm(sd, f"{pre}.layer_norm2", lp["ln2"])
        _emit_linear(sd, f"{pre}.mlp.fc1", lp["fc1"])
        _emit_linear(sd, f"{pre}.mlp.fc2", lp["fc2"])
    _emit_norm(sd, f"{vm}.post_layernorm", params["post_ln"])
    _emit_linear(sd, "visual_projection", params["projection"])
    return sd


def _unet_case(in_ch, motion, init_ch=None, seed=0):
    """(state dict, JAX config, port config) of a tiny UNet; ``init_ch``
    emits a UNet of that many input channels (stock SD's 4 into the
    denoising UNet's 8: conv_in is zero-padded)."""
    src = JC.tiny_unet_config(init_ch or in_ch, motion)
    sd = _emit_unet(JU.unet_init(jax.random.PRNGKey(seed), src), src)
    return (sd, JC.tiny_unet_config(in_ch, motion),
            C.tiny_unet_config(in_ch, motion))


def _case(name):
    """(reference converter, port converter, state dict, JAX cfg, port cfg)"""
    if name == "unet_2d":
        return (JW.convert_unet, W.convert_unet) + _unet_case(4, False)
    if name == "unet_3d_motion":
        return (JW.convert_unet, W.convert_unet) + _unet_case(8, True, seed=1)
    if name == "unet_conv_in_4_to_8":
        return ((JW.convert_unet, W.convert_unet)
                + _unet_case(8, False, init_ch=4, seed=2))
    if name == "vae":
        sd = _emit_vae(JV.vae_init(jax.random.PRNGKey(3),
                                   JC.tiny_vae_config()))
        return (JW.convert_vae, W.convert_vae, sd, JC.tiny_vae_config(),
                C.tiny_vae_config())
    if name == "pose_guider":
        jcfg = JC.PoseGuiderConfig(block_out_channels=(8, 8, 16, 16),
                                   embedding_channels=32)
        sd = _emit_pose_guider(JPG.pose_guider_init(jax.random.PRNGKey(4),
                                                    jcfg))
        return (JW.convert_pose_guider, W.convert_pose_guider, sd, jcfg,
                C.PoseGuiderConfig(block_out_channels=(8, 8, 16, 16),
                                   embedding_channels=32))
    assert name == "clip"
    sd = _emit_clip(JCV.clip_vision_init(jax.random.PRNGKey(5),
                                         JC.tiny_clip_config()))
    return (JW.convert_clip_vision, W.convert_clip_vision, sd,
            JC.tiny_clip_config(), C.tiny_clip_config())


def _assert_flat_equal(got, want):
    """Two flat trees with the same keys, dtypes, shapes and bits."""
    assert sorted(got) == sorted(want), set(got) ^ set(want)
    for key, ref in want.items():
        val = got[key]
        assert val.dtype == ref.dtype and val.shape == ref.shape, key
        np.testing.assert_array_equal(val, ref, err_msg=key)


@pytest.mark.parametrize("name", ["unet_2d", "unet_3d_motion",
                                  "unet_conv_in_4_to_8", "vae",
                                  "pose_guider", "clip"])
def test_converter_matches_reference(name):
    ref_fn, port_fn, sd, jcfg, cfg = _case(name)
    want = JW.flatten_tree(ref_fn(sd, jcfg))
    got = W.flatten_tree(port_fn(sd, cfg))
    assert got
    _assert_flat_equal(got, want)


def _save_pt(path, sd):
    torch.save({k: torch.from_numpy(np.array(v, copy=True))
                for k, v in sd.items()}, path)
    return str(path)


def _checkpoint_files(tmp_path):
    """The seven checkpoints of a tiny MIMO bundle as .pt files: stock SD
    (4-channel 2-D UNet), the motion modules and the rest of the denoising
    UNet (8 channels) apart, the reference UNet, pose guider, VAE, CLIP."""
    jcfg = JC.tiny_mimo_config()
    sd_unet = _emit_unet(JU.unet_init(jax.random.PRNGKey(10),
                                      jcfg.reference_unet),
                         jcfg.reference_unet)
    den = _emit_unet(JU.unet_init(jax.random.PRNGKey(11),
                                  jcfg.denoising_unet), jcfg.denoising_unet)
    ref = _emit_unet(JU.unet_init(jax.random.PRNGKey(12),
                                  jcfg.reference_unet), jcfg.reference_unet)
    motion = {k: v for k, v in den.items() if "motion_modules" in k}
    files = {
        "sd_unet_path": sd_unet,
        "motion_module_path": motion,
        "denoising_unet_path": {k: v for k, v in den.items()
                                if k not in motion},
        "reference_unet_path": ref,
        "pose_guider_path": _emit_pose_guider(JPG.pose_guider_init(
            jax.random.PRNGKey(13), jcfg.pose_guider)),
        "vae_path": _emit_vae(JV.vae_init(jax.random.PRNGKey(14), jcfg.vae)),
        "clip_path": _emit_clip(JCV.clip_vision_init(jax.random.PRNGKey(15),
                                                     jcfg.clip_vision)),
    }
    return {k: _save_pt(tmp_path / f"{k[:-5]}.pt", sd)
            for k, sd in files.items()}


def test_convert_mimo_checkpoints_matches_reference(tmp_path):
    paths = _checkpoint_files(tmp_path)
    want = JW.flatten_tree(JW.convert_mimo_checkpoints(JC.tiny_mimo_config(),
                                                       **paths))
    got = W.flatten_tree(W.convert_mimo_checkpoints(C.tiny_mimo_config(),
                                                    **paths))
    assert any(k.startswith("denoising_unet/") and "motions" in k
               for k in got)
    _assert_flat_equal(got, want)


def test_cli_writes_the_reference_bundle(tmp_path, monkeypatch):
    """``python -m mimo_tpu_torch.weights.convert`` on the seven files
    (at the tiny config) writes the npz the reference converter's
    ``save_npz`` writes."""
    paths = _checkpoint_files(tmp_path)
    monkeypatch.setattr(W, "MIMOConfig", C.tiny_mimo_config)
    out = tmp_path / "bundle.npz"
    argv = [f"--{k[:-5].replace('_', '-')}={v}" for k, v in paths.items()]
    W.main(argv + [f"--out={out}"])
    ref = tmp_path / "ref.npz"
    JW.save_npz(JW.convert_mimo_checkpoints(JC.tiny_mimo_config(), **paths),
                str(ref))
    with np.load(out) as got, np.load(ref) as want:
        _assert_flat_equal({k: got[k] for k in got.files},
                           {k: want[k] for k in want.files})


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def test_save_npz_loads_through_load_params(tmp_path):
    """The port's bundle, read by ``load_params(device="cpu")``, gives the
    converted arrays back: the same tree, conv kernels HWIO -> OIHW."""
    _, _, sd, _, cfg = _case("unet_3d_motion")
    tree = {"denoising_unet": W.convert_unet(sd, cfg)}
    path = str(tmp_path / "w.npz")
    W.save_npz(tree, path)
    loaded = dict(_leaves(runner.load_params(path, device="cpu",
                                             dtype=torch.float32)))
    want = dict(_leaves(tree))
    assert sorted(loaded) == sorted(want)
    for key, ref in want.items():
        got = loaded[key]
        if ref is None:
            assert got is None, key
            continue
        assert got.device.type == "cpu" and got.dtype == torch.float32, key
        if key.endswith("/kernel") and ref.ndim == 4:
            ref = np.transpose(ref, (3, 2, 0, 1))   # HWIO -> OIHW
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=key)
