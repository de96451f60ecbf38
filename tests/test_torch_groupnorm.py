"""The port's GroupNorm (plain version, as the wrapper runs it on CPU
tensors) against the JAX package: the Pallas kernels ``_gn_pallas``
(resident and two-phase) and ``_gn_pallas_snc`` in interpret mode, and
``layers.group_norm``; with row_add, SiLU and both eps values.

Tolerance: atol 1e-4, the one tests/test_groupnorm_kernel.py holds the
Pallas kernels to against XLA (fp32 statistics; E[x²]−E[x]² in fp32 over
up to a few thousand elements per group loses a few more digits than a
centred variance, and the two sides sum in other orders).
"""

import numpy as np
import pytest
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from mimo_tpu.models import layers as JL
from mimo_tpu.ops import groupnorm as JG
from mimo_tpu_torch.models import layers as L
from mimo_tpu_torch.ops import groupnorm as G
from tests.test_torch_helpers import nn, set_fp32_matmuls, tt

set_fp32_matmuls()

ATOL = 1e-4

CASES = [
    # shape, groups, eps, row_add, silu
    ((2, 35, 41, 320), 32, 1e-5, True, True),    # UNet resnet norm2
    ((3, 8, 8, 64), 8, 1e-6, False, False),      # transformer / motion norm
    ((1, 130, 7, 256), 32, 1e-6, False, True),   # VAE norm, ragged rows
    ((3, 9, 5, 64), 8, 1e-5, True, False),
]


def _inputs(shape, radd, seed):
    rng = np.random.default_rng(seed)
    n, c = shape[0], shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    scale = rng.standard_normal(c).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    row_add = rng.standard_normal((n, c)).astype(np.float32) if radd else None
    return x, scale, bias, row_add


def _port(x, scale, bias, groups, eps, silu, row_add):
    return nn(G.group_norm_fused(tt(x), tt(scale), tt(bias), groups, eps,
                                 fuse_silu=silu,
                                 row_add=None if row_add is None
                                 else tt(row_add)))


@pytest.mark.parametrize("shape,groups,eps,radd,silu", CASES)
@pytest.mark.parametrize("two_phase", [False, True])
def test_matches_pallas_gn(shape, groups, eps, radd, silu, two_phase):
    x, scale, bias, row_add = _inputs(shape, radd, 0)
    n, c = shape[0], shape[-1]
    s = x.size // (n * c)
    with pltpu.force_tpu_interpret_mode():
        ref = JG._gn_pallas(jnp.asarray(x.reshape(n, s, c)),
                            jnp.asarray(scale), jnp.asarray(bias), groups,
                            eps, silu, force_two_phase=two_phase,
                            row_add=None if row_add is None
                            else jnp.asarray(row_add))
    got = _port(x, scale, bias, groups, eps, silu, row_add)
    np.testing.assert_allclose(got, np.asarray(ref).reshape(shape),
                               atol=ATOL)


@pytest.mark.parametrize("shape,groups,eps,radd,silu", CASES)
def test_matches_pallas_gn_snc(shape, groups, eps, radd, silu):
    x, scale, bias, row_add = _inputs(shape, radd, 1)
    n, c = shape[0], shape[-1]
    s = x.size // (n * c)
    x_t = np.transpose(x.reshape(n, s, c), (1, 0, 2))
    with pltpu.force_tpu_interpret_mode():
        y_t = JG._gn_pallas_snc(jnp.asarray(x_t), jnp.asarray(scale),
                                jnp.asarray(bias), groups, eps, silu,
                                row_add=None if row_add is None
                                else jnp.asarray(row_add))
    ref = np.transpose(np.asarray(y_t), (1, 0, 2)).reshape(shape)
    got = _port(x, scale, bias, groups, eps, silu, row_add)
    np.testing.assert_allclose(got, ref, atol=ATOL)


@pytest.mark.parametrize("shape,groups,eps,radd,silu", CASES)
def test_layers_group_norm_matches_jax(shape, groups, eps, radd, silu):
    """layers.group_norm against the JAX layers.group_norm (its XLA path on
    CPU)."""
    x, scale, bias, row_add = _inputs(shape, radd, 2)
    ref = JL.group_norm({"scale": jnp.asarray(scale),
                         "bias": jnp.asarray(bias)}, jnp.asarray(x), groups,
                        eps, fuse_silu=silu,
                        row_add=None if row_add is None
                        else jnp.asarray(row_add))
    got = L.group_norm({"scale": tt(scale), "bias": tt(bias)}, tt(x), groups,
                       eps, fuse_silu=silu,
                       row_add=None if row_add is None else tt(row_add))
    np.testing.assert_allclose(nn(got), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("n,s,c", [
    (48, 6272, 320), (48, 104, 1280), (8, 401408, 128), (1, 3, 2560),
])
def test_stats_chunking_covers_every_row(n, s, c):
    """The split-S plan of the kernel: every row in exactly one chunk, no
    empty chunk, and the block count fills the card."""
    nchunk, rows = G.stats_chunking(n, s, c)
    assert nchunk >= 1 and rows >= 1
    assert (nchunk - 1) * rows < s <= nchunk * rows


def test_wrapper_counts_only_kernel_launches():
    x, scale, bias, _ = _inputs((2, 4, 4, 64), False, 4)
    before = G.group_norm_fused.launches
    G.group_norm_fused(tt(x), tt(scale), tt(bias), 8, 1e-5)
    assert G.group_norm_fused.launches == before
