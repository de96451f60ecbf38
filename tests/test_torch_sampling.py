"""The port's sampling ops (mimo_tpu_torch/ops/sampling.py) against
mimo_tpu/ops/sampling.py on the CPU in fp32: bilinear sampling in both
padding modes (points inside, on the edges, exactly on integers and far
outside), flow_warp, and deform_conv2d / deform_conv2d_window against both
JAX deform convs (the gather form and the static-window form).

Tolerance: atol 2e-5 / rtol 1e-5 for sampling (grid_sample's coordinate
normalisation rounds the position by ~1e-7 pixel); 1e-4 for the deform
convs (a 72-column fp32 product in another order).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from mimo_tpu.ops import sampling as JS
from mimo_tpu_torch.ops import sampling as S
from tests.test_torch_helpers import nn, set_fp32_matmuls, tt

set_fp32_matmuls()


def _coords(rng, n, h, w):
    """Points inside, outside by up to 3 pixels, on integers and edges."""
    pts = rng.uniform([-3, -3], [w + 2, h + 2], (n, 2))
    pts[: n // 4] = np.round(pts[: n // 4])
    pts[0] = [0, 0]
    pts[1] = [w - 1, h - 1]
    pts[2] = [w - 1, 0.5]
    pts[3] = [-1, h - 1]
    return pts.astype(np.float32)


@pytest.mark.parametrize("zero_outside", [False, True])
@pytest.mark.parametrize("h,w", [(7, 9), (1, 6), (5, 1)])
def test_bilinear_sample_matches_jax(zero_outside, h, w):
    rng = np.random.default_rng(h * 10 + w)
    imgs = rng.standard_normal((2, h, w, 3)).astype(np.float32)
    pts = np.stack([_coords(rng, 40, h, w) for _ in range(2)]).reshape(
        2, 5, 8, 2)
    want = JS.bilinear_sample_batch(jnp.asarray(imgs), jnp.asarray(pts),
                                    zero_outside)
    got = S.bilinear_sample_batch(tt(imgs), tt(pts), zero_outside)
    assert got.shape == (2, 5, 8, 3)
    np.testing.assert_allclose(nn(got), nn(want), atol=2e-5, rtol=1e-5)
    one = S.bilinear_sample(tt(imgs[0]), tt(pts[0]), zero_outside)
    np.testing.assert_allclose(nn(one), nn(want)[0], atol=2e-5, rtol=1e-5)


def test_flow_warp_matches_jax():
    rng = np.random.default_rng(3)
    img = rng.standard_normal((2, 12, 16, 4)).astype(np.float32)
    flow = (rng.standard_normal((2, 12, 16, 2)) * 4).astype(np.float32)
    flow[0, :3, :3] = np.round(flow[0, :3, :3])
    want = JS.flow_warp(jnp.asarray(img), jnp.asarray(flow))
    got = S.flow_warp(tt(img), tt(flow))
    np.testing.assert_allclose(nn(got), nn(want), atol=2e-5, rtol=1e-5)
    # the identity flow returns the image
    np.testing.assert_allclose(nn(S.flow_warp(tt(img), tt(flow * 0))), img,
                               atol=1e-5)


@pytest.mark.parametrize("groups,with_mask,bound", [(1, False, 3.0),
                                                    (2, True, 3.0),
                                                    (4, True, 5.0)])
def test_deform_conv2d_matches_both_jax_forms(groups, with_mask, bound):
    rng = np.random.default_rng(groups)
    b, h, w, cin, cout, kh = 2, 9, 11, 8, 6, 3
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    kernel = (rng.standard_normal((kh, kh, cin, cout)) * 0.2).astype(
        np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    off = rng.uniform(-bound, bound, (b, h, w, groups * 9 * 2)).astype(
        np.float32)
    off[0, 0, 0, 0] = 2.0                   # an exact integer corner
    mask = rng.uniform(0, 1, (b, h, w, groups * 9)).astype(np.float32) \
        if with_mask else None
    jm = None if mask is None else jnp.asarray(mask)
    want_gather = JS.deform_conv2d(jnp.asarray(x), jnp.asarray(off),
                                   jnp.asarray(kernel), jnp.asarray(bias),
                                   mask=jm, deform_groups=groups)
    want_window = JS.deform_conv2d_window(
        jnp.asarray(x), jnp.asarray(off), jnp.asarray(kernel),
        jnp.asarray(bias), mask=jm, deform_groups=groups,
        max_abs_offset=bound)
    k_oihw = tt(kernel).permute(3, 2, 0, 1)     # the bridge's conv layout
    tm = None if mask is None else tt(mask)
    got = S.deform_conv2d(tt(x), tt(off), k_oihw, tt(bias), mask=tm,
                          deform_groups=groups)
    got_w = S.deform_conv2d_window(tt(x), tt(off), k_oihw, tt(bias),
                                   mask=tm, deform_groups=groups,
                                   max_abs_offset=bound)
    for want in (want_gather, want_window):
        np.testing.assert_allclose(nn(got), nn(want), atol=1e-4, rtol=1e-4)
    assert torch.equal(got, got_w)
