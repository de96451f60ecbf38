"""The port's latent interpolation (mimo_tpu_torch/pipelines/interp.py)
against mimo_tpu/pipelines/interp.py on the same numpy inputs, fp32 on the
CPU, with the cases of tests/test_misc_components.py.

Tolerance: atol 1e-6 (fp32 on both sides; arccos/sin and the norms may
round differently in the last bit).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from mimo_tpu.pipelines import interp as JI
from mimo_tpu_torch.pipelines import interp as I
from tests.test_torch_helpers import nn, tt

ATOL = 1e-6


def _pair(seed, shape=(4, 4)):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("t", [0.0, 0.25, 0.5, 1.0])
def test_lerp_matches_jax(t):
    a, b = _pair(0)
    np.testing.assert_allclose(nn(I.lerp(tt(a), tt(b), t)),
                               nn(JI.lerp(jnp.asarray(a), jnp.asarray(b), t)),
                               atol=ATOL)


@pytest.mark.parametrize("t", [0.0, 0.5, 1.0, 1 / 3])
def test_slerp_matches_jax(t):
    a, b = _pair(1)
    got = I.slerp(tt(a), tt(b), t)
    np.testing.assert_allclose(
        nn(got), nn(JI.slerp(jnp.asarray(a), jnp.asarray(b), t)), atol=ATOL)
    assert torch.isfinite(got).all()
    if t in (0.0, 1.0):   # endpoints
        np.testing.assert_allclose(nn(got), a if t == 0.0 else b, atol=1e-5)


def test_slerp_parallel_falls_back_to_lerp():
    a = np.ones((3, 3), np.float32)
    got = I.slerp(tt(a), tt(a * 2.0), 0.5)
    np.testing.assert_allclose(nn(got), 1.5, atol=1e-5)
    np.testing.assert_allclose(
        nn(got), nn(JI.slerp(jnp.asarray(a), jnp.asarray(a * 2.0), 0.5)),
        atol=ATOL)


def test_slerp_keeps_dtype():
    a, b = _pair(2)
    got = I.slerp(tt(a).bfloat16(), tt(b).bfloat16(), 0.5)
    assert got.dtype == torch.bfloat16 and got.shape == (4, 4)


@pytest.mark.parametrize("factor", [0, 1, 2, 3])
@pytest.mark.parametrize("mode", ["slerp", "linear"])
def test_interpolate_latents_matches_jax(factor, mode):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 2, 3, 4)).astype(np.float32)
    got = I.interpolate_latents(tt(x), factor, mode=mode)
    ref = JI.interpolate_latents(jnp.asarray(x), factor, mode=mode)
    frames = 4 if factor < 2 else 3 * factor + 1
    assert got.shape == (frames, 2, 3, 4)
    np.testing.assert_allclose(nn(got), nn(ref), atol=ATOL)
    # the original frames stay at every factor-th position
    np.testing.assert_array_equal(nn(got)[::max(factor, 1)], x)


def test_interpolate_linear_counts_and_values():
    x = torch.stack([torch.zeros((2, 2, 1)), torch.ones((2, 2, 1))])
    out = I.interpolate_latents(x, 2, mode="linear")
    assert out.shape[0] == 3
    np.testing.assert_allclose(nn(out[1]), 0.5)
