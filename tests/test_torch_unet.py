"""The port's UNet blocks and UNets against mimo_tpu/models/unet.py on tiny
configs (config.tiny_mimo_config), fp32 on the CPU, with the JAX
parameters carried over by the weights bridge.

Tolerance: atol/rtol 1e-4. Both sides run fp32 with full-precision
products; the difference is summation order (XLA vs PyTorch's CPU
kernels, ~1e-6 relative per op) compounded through up to ~40 layers of
random-weight activations of order 1.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from mimo_tpu import config as JC
from mimo_tpu.models import unet as JU
from mimo_tpu_torch import config as C
from mimo_tpu_torch.models import unet as U
from tests.test_torch_helpers import bridge_params, nn, set_fp32_matmuls, tt

set_fp32_matmuls()

TOL = dict(atol=1e-4, rtol=1e-4)


def _key(i):
    return jax.random.PRNGKey(i)


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("c_in,c_out,temb", [(32, 32, True), (32, 64, True),
                                             (16, 32, False)])
def test_resnet_matches_jax(c_in, c_out, temb):
    rng = np.random.default_rng(0)
    p = JU.resnet_init(_key(0), c_in, c_out, 24 if temb else None)
    x = _randn(rng, 3, 5, 7, c_in)
    t = _randn(rng, 3, 24) if temb else None
    ref = JU.resnet_apply(p, jnp.asarray(x),
                          None if t is None else jnp.asarray(t), 8, 1e-5,
                          fused_gn=True)
    got = U.resnet_apply(bridge_params(p), tt(x),
                         None if t is None else tt(t), 8, 1e-5)
    np.testing.assert_allclose(nn(got), nn(ref), **TOL)


@pytest.mark.parametrize("ctx_len", [1, 3])
def test_spatial_transformer_write_mode_matches_jax(ctx_len):
    """Reference-UNet role: the bank gets the normed pre-attention tokens;
    ctx_len 1 takes the single-token cross-attention shortcut."""
    cfg = JC.tiny_unet_config()
    rng = np.random.default_rng(1)
    p = JU.spatial_transformer_init(_key(1), 32, cfg.cross_attention_dim)
    x = _randn(rng, 2, 4, 6, 32)
    ctx = _randn(rng, 2, ctx_len, cfg.cross_attention_dim)
    banks_j, banks_t = [], []
    ref = JU.spatial_transformer_apply(p, jnp.asarray(x), jnp.asarray(ctx),
                                       cfg, bank_out=banks_j)
    got = U.spatial_transformer_apply(bridge_params(p), tt(x), tt(ctx),
                                      C.tiny_unet_config(), bank_out=banks_t)
    np.testing.assert_allclose(nn(got), nn(ref), **TOL)
    assert len(banks_t) == len(banks_j) == 1
    np.testing.assert_allclose(nn(banks_t[0]), nn(banks_j[0]), **TOL)


@pytest.mark.parametrize("cfg_split", [False, True])
def test_spatial_transformer_read_mode_matches_jax(cfg_split):
    """Denoiser role: the cond half (or every row) attends over
    [self ‖ bank]; the uncond half under CFG is plain self-attention."""
    cfg = JC.tiny_unet_config()
    rng = np.random.default_rng(2)
    p = JU.spatial_transformer_init(_key(2), 32, cfg.cross_attention_dim)
    x = _randn(rng, 4, 4, 6, 32)
    ctx = _randn(rng, 4, 1, cfg.cross_attention_dim)
    bank = _randn(rng, 24, 32)
    ref = JU.spatial_transformer_apply(p, jnp.asarray(x), jnp.asarray(ctx),
                                       cfg, bank_in=jnp.asarray(bank),
                                       cfg_split=cfg_split)
    got = U.spatial_transformer_apply(bridge_params(p), tt(x), tt(ctx),
                                      C.tiny_unet_config(), bank_in=tt(bank),
                                      cfg_split=cfg_split)
    np.testing.assert_allclose(nn(got), nn(ref), **TOL)


def test_motion_module_matches_jax():
    cfg = JC.tiny_unet_config(8, True)
    rng = np.random.default_rng(3)
    p = JU.motion_module_init(_key(3), 32, cfg.motion)
    # proj_out is zero-initialised; give it weights so the path is live
    p["proj_out"] = {"kernel": jnp.asarray(_randn(rng, 32, 32) * 0.2),
                     "bias": jnp.asarray(_randn(rng, 32))}
    frames = 5
    x = _randn(rng, 2 * frames, 3, 4, 32)
    ref = JU.motion_module_apply(p, jnp.asarray(x), frames, cfg.motion)
    got = U.motion_module_apply(bridge_params(p), tt(x), frames,
                                C.tiny_unet_config(8, True).motion)
    np.testing.assert_allclose(nn(got), nn(ref), **TOL)


def test_temporal_pe_matches_jax():
    got = U._temporal_pe(24, 40, torch.float32, "cpu")
    ref = JU._temporal_pe(24, 40, jnp.float32)
    np.testing.assert_allclose(nn(got), nn(ref), atol=1e-6)


def _unet_inputs(seed, frames=4, h=8, w=8, cfg_b=2):
    rng = np.random.default_rng(seed)
    cfg = JC.tiny_mimo_config()
    x = _randn(rng, cfg_b, frames, h, w, 8)
    ctx = _randn(rng, cfg_b, 1, cfg.denoising_unet.cross_attention_dim)
    pose = _randn(rng, cfg_b, frames, h, w,
                  cfg.denoising_unet.block_out_channels[0])
    ref_lat = _randn(rng, 2, h, w, 4)
    return x, ctx, pose, ref_lat


def test_unet2d_banks_match_jax():
    cfg = JC.tiny_mimo_config()
    p = JU.unet_init(_key(4), cfg.reference_unet)
    x, ctx, _, ref_lat = _unet_inputs(4)
    banks_j = JU.unet2d_apply(p, cfg.reference_unet, jnp.asarray(ref_lat),
                              jnp.zeros((), jnp.int32), jnp.asarray(ctx))
    banks_t = U.unet2d_apply(bridge_params(p), C.tiny_mimo_config()
                             .reference_unet, tt(ref_lat), 0.0, tt(ctx))
    assert len(banks_t) == len(banks_j) == JU.num_banks(cfg.reference_unet)
    assert U.num_banks(C.tiny_mimo_config().reference_unet) == len(banks_j)
    for bt, bj in zip(banks_t, banks_j):
        np.testing.assert_allclose(nn(bt), nn(bj), **TOL)


def _taps(module, run):
    taps = {}
    module._TAP = lambda name, h: taps.__setitem__(name, nn(h))
    try:
        out = run()
    finally:
        module._TAP = None
    taps["out"] = nn(out)
    return taps


def test_unet3d_matches_jax_at_every_tap():
    """The denoising UNet with pose features, banks from the reference UNet
    and the CFG split, compared after every down block, the mid and every
    up block (the _tap points of tests/test_golden.py) and at the output."""
    cfg = JC.tiny_mimo_config()
    cfg_t = C.tiny_mimo_config()
    p_ref = JU.unet_init(_key(5), cfg.reference_unet)
    p_den = JU.unet_init(_key(6), cfg.denoising_unet)
    # the motion modules' zero-init proj_out would hide them: give weights
    rng = np.random.default_rng(6)
    for blk in p_den["down"] + p_den["up"] + [p_den["mid"]]:
        for mm in blk["motions"] or []:
            c = mm["proj_out"]["kernel"].shape[0]
            mm["proj_out"] = {"kernel": jnp.asarray(_randn(rng, c, c) * 0.1),
                              "bias": jnp.asarray(_randn(rng, c) * 0.1)}
    x, ctx, pose, ref_lat = _unet_inputs(7)
    banks_j = JU.unet2d_apply(p_ref, cfg.reference_unet, jnp.asarray(ref_lat),
                              jnp.zeros((), jnp.int32), jnp.asarray(ctx))
    cond_j = [b[-1] for b in banks_j]
    t = 421.0

    taps_j = _taps(JU, lambda: JU.unet3d_apply(
        p_den, cfg.denoising_unet, jnp.asarray(x), jnp.asarray(t),
        jnp.asarray(ctx), jnp.asarray(pose), cond_j, cfg_split=True))
    pt_ref, pt_den = bridge_params(p_ref), bridge_params(p_den)
    banks_t = U.unet2d_apply(pt_ref, cfg_t.reference_unet, tt(ref_lat), 0.0,
                             tt(ctx))
    taps_t = _taps(U, lambda: U.unet3d_apply(
        pt_den, cfg_t.denoising_unet, tt(x), t, tt(ctx), tt(pose),
        [b[-1] for b in banks_t], cfg_split=True))
    assert set(taps_t) == set(taps_j)
    for name in taps_j:
        np.testing.assert_allclose(taps_t[name], taps_j[name], err_msg=name,
                                   **TOL)


def test_unet3d_matches_golden_blocks():
    """The port on the parameters and inputs of
    tests/test_golden.py::test_per_block_activation_goldens, against the
    recorded per-block (mean, mean|x|). atol 2e-5: the goldens were recorded
    from XLA at 2e-6; the port sums in another order."""
    from tests.test_golden import GOLDEN_BLOCKS
    cfg = JC.tiny_mimo_config()
    params = JU.unet_init(jax.random.split(_key(1), 1)[0],
                          cfg.denoising_unet)
    kk = jax.random.split(_key(2), 4)
    x = jax.random.normal(kk[0], (1, 4, 8, 8, 8))
    ctx = jax.random.normal(kk[1], (1, 1, cfg.denoising_unet
                                    .cross_attention_dim))
    taps = _taps(U, lambda: U.unet3d_apply(
        bridge_params(params), C.tiny_mimo_config().denoising_unet, tt(x),
        421.0, tt(ctx), None, None))
    assert set(taps) == set(GOLDEN_BLOCKS)
    for name, (gm, ga) in GOLDEN_BLOCKS.items():
        np.testing.assert_allclose(taps[name].mean(), gm, atol=2e-5,
                                   err_msg=name)
        np.testing.assert_allclose(np.abs(taps[name]).mean(), ga, atol=2e-5,
                                   err_msg=name)


def test_upsample_nearest_to_matches_jax():
    """Floor indexing on the odd sizes 13→25→49→98 and the exact 2x case."""
    from mimo_tpu.models import layers as JL
    from mimo_tpu_torch.models import layers as L
    rng = np.random.default_rng(8)
    for (h, w), (th, tw) in [((13, 7), (25, 13)), ((25, 13), (49, 25)),
                             ((49, 25), (98, 49)), ((4, 5), (8, 10))]:
        x = _randn(rng, 2, h, w, 3)
        np.testing.assert_array_equal(
            nn(L.upsample_nearest_to(tt(x), th, tw)),
            nn(JL.upsample_nearest_to(jnp.asarray(x), th, tw)))
