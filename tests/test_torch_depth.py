"""The port's DepthAnythingV2 (mimo_tpu_torch/decomp/depth_anything.py)
against mimo_tpu/decomp/depth_anything.py on the tiny config, fp32 on the
CPU, with JAX-initialised params carried over by the weights bridge (the
resize kinds stay strings; LayerScale given live values): depth_forward at
the config's square size and at a non-square one (the pos embed
interpolated), and infer_depth on a 45x30 frame, whose network input is
84x56, so the last resize shrinks and antialiases.

Tolerance: atol 1e-4 relative to the depth's scale (fp32 on both sides,
sums in another order).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from mimo_tpu.decomp import depth_anything as JD
from mimo_tpu_torch.decomp import depth_anything as D
from tests.test_torch_helpers import bridge_params, nn, set_fp32_matmuls, tt

set_fp32_matmuls()


@pytest.fixture(scope="module")
def depth():
    cfg = JD.tiny_depth_config()
    p = JD.depth_anything_init(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(0)
    for blk in p["encoder"]["blocks"]:           # LayerScale away from 1e-5
        for k in ("ls1", "ls2"):
            blk[k] = jnp.asarray(rng.uniform(0.5, 1.5, blk[k].shape),
                                 jnp.float32)
    pt = bridge_params(p)
    assert [r["kind"] for r in pt["resize"]] == list(D.RESIZE_KINDS)
    return cfg, p, pt


def _close(got, want):
    scale = max(1.0, float(np.abs(nn(want)).max()))
    np.testing.assert_allclose(nn(got), nn(want), atol=1e-4 * scale)


@pytest.mark.parametrize("hw", [(56, 56), (70, 42)])
def test_depth_forward_matches_jax(depth, hw):
    cfg, p, pt = depth
    px = np.random.default_rng(1).standard_normal((2, *hw, 3)).astype(
        np.float32)
    want = JD.depth_forward(p, cfg, jnp.asarray(px))
    got = D.depth_forward(pt, cfg, tt(px))
    assert got.shape == (2, *hw)
    _close(got, want)
    assert float(got.min()) >= 0


def test_infer_depth_shrinks_like_jax(depth):
    cfg, p, pt = depth
    img = np.random.default_rng(2).uniform(0, 1, (45, 30, 3)).astype(
        np.float32)
    assert D.infer_size(45, 30, 14, 56) == (84, 56)
    want = JD.infer_depth(p, cfg, jnp.asarray(img), input_size=56)
    got = D.infer_depth(pt, cfg, tt(img), input_size=56)
    assert got.shape == (45, 30) and got.dtype == torch.float32
    _close(got, want)


def test_init_tree_matches_jax():
    cfg = D.tiny_depth_config()
    got = D.depth_anything_init(torch.Generator().manual_seed(0), cfg)
    want = bridge_params(JD.depth_anything_init(jax.random.PRNGKey(0), cfg))

    def walk(a, b, path=""):
        if isinstance(b, dict):
            assert sorted(a) == sorted(b), path
            for k in b:
                walk(a[k], b[k], f"{path}/{k}")
        elif isinstance(b, list):
            assert len(a) == len(b), path
            for x, y in zip(a, b):
                walk(x, y, path)
        elif isinstance(b, str):
            assert a == b, path
        else:
            assert tuple(a.shape) == tuple(b.shape), path
    walk(got, want)
