"""The port's VAE, CLIP vision tower and pose guider against the JAX models
on tiny configs, fp32 on the CPU, JAX parameters carried over by the weights
bridge; plus the bridge's own layout and dtype handling.

Tolerance: atol/rtol 1e-4 (fp32 on both sides; summation order differs
through up to ~30 layers), 1e-5 for the shallow pose guider.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import ml_dtypes
import torch

from mimo_tpu import config as JC
from mimo_tpu.models import clip_vision as JCV
from mimo_tpu.models import pose_guider as JPG
from mimo_tpu.models import vae as JV
from mimo_tpu.weights.convert import flatten_tree, save_npz
from mimo_tpu_torch import config as C
from mimo_tpu_torch.models import clip_vision as CV
from mimo_tpu_torch.models import pose_guider as PG
from mimo_tpu_torch.models import vae as V
from mimo_tpu_torch.weights import bridge
from tests.test_torch_helpers import bridge_params, nn, set_fp32_matmuls, tt

set_fp32_matmuls()

TOL = dict(atol=1e-4, rtol=1e-4)


def _rng(seed):
    return np.random.default_rng(seed)


def test_vae_encode_decode_match_jax():
    cfg = JC.tiny_vae_config()
    p = JV.vae_init(jax.random.PRNGKey(0), cfg)
    pt = bridge_params(p)
    x = _rng(0).uniform(-1, 1, (2, 32, 24, 3)).astype(np.float32)
    z_j = JV.encode_mean(p, cfg, jnp.asarray(x))
    z_t = V.encode_mean(pt, C.tiny_vae_config(), tt(x))
    np.testing.assert_allclose(nn(z_t), nn(z_j), **TOL)
    z = _rng(1).standard_normal((2, 4, 3, 4)).astype(np.float32)
    np.testing.assert_allclose(
        nn(V.decode(pt, C.tiny_vae_config(), tt(z))),
        nn(JV.decode(p, cfg, jnp.asarray(z))), **TOL)


def test_vae_mid_attention_over_long_sequence_matches_jax():
    """The single-head mid-block attention at a sequence long enough that
    the JAX package routed it to flash on the TPU (32x32 latent -> 1024
    tokens, d = 32 channels: flash_attention_nt on the card, its plain
    version here)."""
    cfg = JC.tiny_vae_config()
    p = JV.vae_init(jax.random.PRNGKey(1), cfg)
    z = _rng(2).standard_normal((1, 32, 32, 4)).astype(np.float32)
    np.testing.assert_allclose(
        nn(V.decode(bridge_params(p), C.tiny_vae_config(), tt(z))),
        nn(JV.decode(p, cfg, jnp.asarray(z))), **TOL)


def test_vae_mid_block_attention_at_512_channels_matches_jax():
    """The mid block's attention module (GroupNorm, q/k/v projections, one
    head of d = 512, output projection, residual) at the real VAE's 512
    channels over one 32x32 latent (1024 tokens): the wide branch of the
    dispatch (flash_attention_wide on the card, its plain version here)
    against mimo_tpu's module; the GroupNorm's scale and bias drawn so the
    affine part is live."""
    channels, groups = 512, 32
    p = JV._attn_init(jax.random.PRNGKey(5), channels)
    rng = _rng(6)
    p["norm"] = {"scale": jnp.asarray(rng.uniform(0.5, 1.5, channels),
                                      jnp.float32),
                 "bias": jnp.asarray(rng.normal(0, 0.1, channels),
                                     jnp.float32)}
    x = rng.standard_normal((1, 32, 32, channels)).astype(np.float32)
    from mimo_tpu_torch.ops import attention as A
    assert A.sdpa_route(32 * 32, channels, cuda=True) == "wide"
    np.testing.assert_allclose(
        nn(V._attn_apply(bridge_params(p), tt(x), groups)),
        nn(JV._attn_apply(p, jnp.asarray(x), groups)), **TOL)


def test_clip_image_embed_matches_jax():
    cfg = JC.tiny_clip_config()
    p = JCV.clip_vision_init(jax.random.PRNGKey(2), cfg)
    img = _rng(3).uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    px_j = JCV.clip_preprocess(jnp.asarray(img))
    px_t = CV.clip_preprocess(tt(img))
    np.testing.assert_allclose(nn(px_t), nn(px_j), atol=1e-6)
    np.testing.assert_allclose(
        nn(CV.clip_image_embed(bridge_params(p), C.tiny_clip_config(), px_t)),
        nn(JCV.clip_image_embed(p, cfg, px_j)), **TOL)


def test_pose_guider_matches_jax():
    cfg = JC.tiny_mimo_config().pose_guider
    p = JPG.pose_guider_init(jax.random.PRNGKey(3), cfg)
    # conv_out is zero-initialised; give it weights so the path is live
    p["conv_out"] = {
        "kernel": jnp.asarray(_rng(4).standard_normal(
            p["conv_out"]["kernel"].shape).astype(np.float32) * 0.1),
        "bias": jnp.asarray(_rng(5).standard_normal(
            p["conv_out"]["bias"].shape).astype(np.float32))}
    x = _rng(6).uniform(0, 1, (1, 3, 32, 40, 3)).astype(np.float32)
    np.testing.assert_allclose(
        nn(PG.pose_guider_apply(bridge_params(p), tt(x))),
        nn(JPG.pose_guider_apply(p, jnp.asarray(x))), atol=1e-5, rtol=1e-5)


def test_bridge_layouts_and_none_subtrees():
    """Conv kernels HWIO -> OIHW (channels_last), linear kernels unchanged,
    lists and None subtrees rebuilt."""
    tree = {"conv": {"kernel": np.arange(2 * 3 * 4 * 5, dtype=np.float32)
                     .reshape(2, 3, 4, 5), "bias": np.ones(5, np.float32)},
            "lin": {"kernel": np.arange(6, dtype=np.float32).reshape(2, 3)},
            "blocks": [{"a": np.zeros(1, np.float32)}, None],
            "skip": None}
    got = bridge.from_flat(flatten_tree(tree))
    assert got["skip"] is None and got["blocks"][1] is None
    np.testing.assert_array_equal(got["conv"]["kernel"].numpy(),
                                  np.transpose(tree["conv"]["kernel"],
                                               (3, 2, 0, 1)))
    assert got["conv"]["kernel"].is_contiguous(
        memory_format=torch.channels_last)
    np.testing.assert_array_equal(got["lin"]["kernel"].numpy(),
                                  tree["lin"]["kernel"])


@pytest.mark.parametrize("via_npz", [False, True])
def test_bridge_bf16_leaves(via_npz, tmp_path):
    """bf16 leaves (ml_dtypes arrays, or their raw records read back from an
    .npz) convert exactly, and the target dtype is applied."""
    w = (np.arange(12, dtype=np.float32) / 7).reshape(3, 4)
    tree = {"lin": {"kernel": w.astype(ml_dtypes.bfloat16)}}
    if via_npz:
        save_npz(tree, str(tmp_path / "w.npz"))
        got = bridge.load_npz(str(tmp_path / "w.npz"), dtype=torch.bfloat16)
    else:
        got = bridge.from_flat(flatten_tree(tree), dtype=torch.bfloat16)
    k = got["lin"]["kernel"]
    assert k.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        k.float().numpy(), w.astype(ml_dtypes.bfloat16).astype(np.float32))


def test_init_bounds_mirror_jax():
    """The port's random init draws from the JAX initialisers' ranges, so
    full-width activations stay where the JAX bench ran."""
    from mimo_tpu.models import layers as JL
    from mimo_tpu_torch.models import layers as L
    gen = torch.Generator().manual_seed(0)
    lin = L.linear_init(gen, 320, 640)
    conv = L.conv2d_init(gen, 3, 3, 320, 640)
    j_lin = JL.linear_init(jax.random.PRNGKey(0), 320, 640)
    j_conv = JL.conv2d_init(jax.random.PRNGKey(0), 3, 3, 320, 640)
    for got, ref in ((lin, j_lin), (conv, j_conv)):
        for name in ("kernel", "bias"):
            g, r = got[name].numpy(), np.asarray(ref[name])
            assert g.size == r.size
            bound = float(np.abs(r).max())
            assert float(np.abs(g).max()) <= bound * 1.01
            assert float(np.abs(g).max()) >= bound * 0.9
