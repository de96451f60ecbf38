"""The port's RAFT (mimo_tpu_torch/decomp/raft.py) against
mimo_tpu/decomp/raft.py on the tiny config, fp32 on the CPU, with
JAX-initialised params carried over by the weights bridge (the context
encoder's folded-BN affine given non-trivial values): the correlation
pyramid, the lookup (the port's grid_sample against the JAX package's
one-hot matmuls, at coordinates inside, on integers and outside the
volume), raft_flow and raft_bi.

Tolerance: pyramid and lookup atol 1e-5; the flows atol 2e-4 (3 refinement
steps of fp32 convs summed in another order, flows of a few pixels).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from mimo_tpu.decomp import raft as JR
from mimo_tpu_torch.decomp import raft as R
from tests.test_torch_helpers import bridge_params, nn, set_fp32_matmuls, tt

set_fp32_matmuls()


def _live_affine(tree, rng):
    """The context encoder's norms given random folded-BN values."""
    if isinstance(tree, dict):
        if set(tree) == {"scale", "bias"}:
            return {k: jnp.asarray(rng.uniform(0.5, 1.5, v.shape)
                                   if k == "scale" else
                                   rng.normal(0, 0.2, v.shape), jnp.float32)
                    for k, v in tree.items()}
        return {k: _live_affine(v, rng) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_live_affine(v, rng) for v in tree]
    return tree


@pytest.fixture(scope="module")
def raft():
    cfg = JR.tiny_raft_config()
    p = JR.raft_init(jax.random.PRNGKey(0), cfg)
    p["cnet"] = _live_affine(p["cnet"], np.random.default_rng(5))
    rng = np.random.default_rng(0)
    frames = rng.uniform(-1, 1, (3, 32, 40, 3)).astype(np.float32)
    return cfg, p, bridge_params(p), frames


def test_pyramid_and_lookup_match_jax():
    rng = np.random.default_rng(1)
    f1 = rng.standard_normal((2, 6, 5, 8)).astype(np.float32)
    f2 = rng.standard_normal((2, 6, 5, 8)).astype(np.float32)
    jp = JR._corr_pyramid(jnp.asarray(f1), jnp.asarray(f2), 3)
    tp = R._corr_pyramid(tt(f1), tt(f2), 3)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(nn(a)[:, 0], nn(b)[..., 0], atol=1e-5)
    coords = rng.uniform(-3, 8, (2, 6, 5, 2)).astype(np.float32)
    coords[0, :2] = np.round(coords[0, :2])
    want = JR._corr_lookup(jp, jnp.asarray(coords), 2)
    got = R._corr_lookup(tp, tt(coords), 2)
    assert got.shape == (2, 6, 5, 3 * 25)
    np.testing.assert_allclose(nn(got), nn(want), atol=1e-5)


def test_raft_flow_matches_jax(raft):
    cfg, p, pt, frames = raft
    want = JR.raft_flow(p, cfg, jnp.asarray(frames[:2]),
                        jnp.asarray(frames[1:]))
    got = R.raft_flow(pt, cfg, tt(frames[:2]), tt(frames[1:]))
    assert got.shape == (2, 32, 40, 2)
    np.testing.assert_allclose(nn(got), nn(want), atol=2e-4)


def test_raft_bi_matches_jax(raft):
    cfg, p, pt, frames = raft
    wf, wb = JR.raft_bi(p, cfg, jnp.asarray(frames))
    gf, gb = R.raft_bi(pt, cfg, tt(frames))
    assert gf.shape == gb.shape == (2, 32, 40, 2)
    np.testing.assert_allclose(nn(gf), nn(wf), atol=2e-4)
    np.testing.assert_allclose(nn(gb), nn(wb), atol=2e-4)


def test_init_tree_matches_jax():
    """The port's seeded init builds the JAX package's tree: same keys,
    shapes (conv kernels in the port's OIHW) and architectural strides."""
    import torch
    cfg = R.tiny_raft_config()
    got = R.raft_init(torch.Generator().manual_seed(0), cfg)
    want = bridge_params(JR.raft_init(jax.random.PRNGKey(0), cfg))

    def walk(a, b, path=""):
        if isinstance(b, dict):
            assert sorted(a) == sorted(b), path
            for k in b:
                walk(a[k], b[k], f"{path}/{k}")
        elif isinstance(b, list):
            assert len(a) == len(b), path
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{path}/{i}")
        elif isinstance(a, int):
            assert a == int(b), path
        else:
            assert tuple(a.shape) == tuple(b.shape), path
    walk(got, want)
