"""The port's Hiera trunk and FPN neck (mimo_tpu_torch/decomp/hiera.py)
against mimo_tpu/decomp/hiera.py on the same numpy-seeded inputs, JAX
parameters carried over by the weights bridge, fp32 on the CPU.

Tolerance: atol/rtol 1e-4 (fp32 on both sides, summation order differs
through the blocks); the resize weights and pos embeds 1e-6.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from mimo_tpu.decomp import hiera as JH
from mimo_tpu_torch.decomp import hiera as H
from mimo_tpu_torch.decomp import vit as V
from mimo_tpu_torch.models import layers as L
from tests.test_torch_helpers import bridge_params, nn, set_fp32_matmuls, tt

set_fp32_matmuls()

TOL = dict(atol=1e-4, rtol=1e-4)


def _port_cfg(cfg):
    return H.HieraConfig(**{f: getattr(cfg, f) for f in (
        "embed_dim", "num_heads", "stages", "window_spec", "global_blocks",
        "input_size", "pos_bkg_size", "mlp_ratio", "neck_dim", "ln_eps")})


@pytest.mark.parametrize("n_in,n_out,method", [
    (7, 16, "bicubic"), (7, 256, "bicubic"), (16, 7, "bicubic"),
    (5, 12, "bilinear"), (12, 5, "bilinear")])
def test_resize_matrix_matches_jax_image_resize(n_in, n_out, method):
    x = np.random.default_rng(0).standard_normal((n_in, 3, 2)).astype(
        np.float32)
    want = jax.image.resize(jnp.asarray(x), (n_out, 3, 2), method=method)
    got = np.einsum("oi,ijk->ojk", V.resize_matrix(n_in, n_out, method), x)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6)


def test_block_plan_and_pos_embed_match_jax():
    for cfg in (JH.HieraConfig(), JH.tiny_hiera_config()):
        assert _port_cfg(cfg).block_plan() == cfg.block_plan()
    cfg = JH.tiny_hiera_config()
    p = JH.hiera_init(jax.random.PRNGKey(0), cfg)
    np.testing.assert_allclose(
        nn(H.hiera_pos_embed(bridge_params(p), _port_cfg(cfg), 16, 16)),
        nn(JH.hiera_pos_embed(p, cfg, 16, 16)), atol=1e-6)
    np.testing.assert_allclose(H.sine_pos_embed(4, 6, 32),
                               JH.sine_pos_embed(4, 6, 32), atol=0)


@pytest.mark.parametrize("global_blocks", [(3,), (0, 2)])
def test_hiera_trunk_and_neck_match_jax(global_blocks):
    """Every stage output and the neck, pooling blocks windowed and global
    (global_blocks (0, 2): a global block before a stage transition and a
    global pooling block)."""
    cfg = JH.HieraConfig(embed_dim=16, num_heads=2, stages=(1, 1, 1, 1),
                         window_spec=(2, 2, 2, 2),
                         global_blocks=global_blocks, input_size=(64, 64),
                         neck_dim=32)
    p = JH.hiera_init(jax.random.PRNGKey(1), cfg)
    pt = bridge_params(p)
    x = np.random.default_rng(2).standard_normal((2, 64, 64, 3)).astype(
        np.float32)
    feats_j = JH.hiera_apply(p, cfg, jnp.asarray(x))
    feats_t = H.hiera_apply(pt, _port_cfg(cfg), tt(x))
    for a, b in zip(feats_t, feats_j):
        np.testing.assert_allclose(nn(a), nn(b), **TOL)
    neck_j, pos_j = JH.hiera_neck(p, cfg, feats_j)
    neck_t, pos_t = H.hiera_neck(pt, _port_cfg(cfg), feats_t)
    for a, b in zip(neck_t, neck_j):
        np.testing.assert_allclose(nn(a), nn(b), **TOL)
    for a, b in zip(pos_t, pos_j):
        np.testing.assert_allclose(a, b, atol=0)
    np.testing.assert_allclose(
        nn(H.encode_image_hiera(pt, _port_cfg(cfg), tt(x))),
        nn(JH.encode_image_hiera(p, cfg, jnp.asarray(x))), **TOL)


def test_global_block_over_1024_queries_takes_the_flash_dispatch(monkeypatch):
    """A global block with >= 1024 queries (the stage-3 global blocks at
    1024^2) hands dispatch_sdpa q/k/v as strided views of one q|k|v product,
    and agrees with the JAX block (which dispatches the same way) once its
    output projection is applied (``hiera_apply`` leaves that to the
    product and the row pass after ``_attn``)."""
    from mimo_tpu.models import layers as JL
    din = dout = 32
    heads, g = 4, 32
    blk = {"qkv": JL.linear_init(jax.random.PRNGKey(3), din, 3 * dout),
           "proj_attn": JL.linear_init(jax.random.PRNGKey(4), dout, dout)}
    x = np.random.default_rng(5).standard_normal((1, g * g, din)).astype(
        np.float32)
    seen = []
    real = H.dispatch_sdpa

    def spy(q, k, v, h):
        seen.append((q.stride(), k.data_ptr() - q.data_ptr()))
        return real(q, k, v, h)

    monkeypatch.setattr(H, "dispatch_sdpa", spy)
    pt = bridge_params(blk)
    o, oh, ow = H._attn(pt, tt(x), heads, dout, False, g, g)
    got = L.linear(pt["proj_attn"], o)
    want, _, _ = JH._attn(blk, jnp.asarray(x), heads, dout, False, g, g)
    np.testing.assert_allclose(nn(got), nn(want), **TOL)
    assert (oh, ow) == (g, g)
    assert seen == [((g * g * 3 * dout, 3 * dout, 1), dout * 4)]
