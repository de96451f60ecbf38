"""The port's temporal attention (plain version, as the wrapper runs it on
CPU tensors) against mimo_tpu/ops/temporal_attention.py's
``temporal_attention_fused`` in interpret mode: the full
``x + to_out(attn(LN(x) + pe))`` chain and the attention alone, on ragged
S and several (F, heads, C).

Tolerance: atol 5e-5 for the chain and 3e-5 for the attention alone, the
ones tests/test_temporal_attention.py holds the Pallas kernel to against
the einsum path (fp32; the kernel folds the softmax scale into q in the
exp2 domain and takes E[x²]−E[x]² in its LN).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from mimo_tpu.ops import temporal_attention as JT
from mimo_tpu_torch.ops import temporal_attention as T
from tests.test_torch_helpers import nn, set_fp32_matmuls, tt

set_fp32_matmuls()


def _params(rng, c):
    p = {name: {"kernel": (rng.standard_normal((c, c)) / np.sqrt(c))
                .astype(np.float32)}
         for name in ("to_q", "to_k", "to_v", "to_out")}
    p["to_out"]["bias"] = rng.standard_normal(c).astype(np.float32) * 0.1
    return p


def _jax_weights(p):
    return [jnp.asarray(p[k]["kernel"]) for k in
            ("to_q", "to_k", "to_v", "to_out")] + [jnp.asarray(
                p["to_out"]["bias"])]


def _torch(p):
    return {k: {kk: tt(vv) for kk, vv in v.items()} for k, v in p.items()}


@pytest.mark.parametrize("b,f,s,c,heads", [
    (2, 8, 48, 64, 4),
    (1, 6, 100, 48, 3),      # ragged s tail of the Pallas block
    (1, 24, 16, 32, 2),      # the main path's 24 frames
])
def test_chain_matches_pallas(b, f, s, c, heads):
    rng = np.random.default_rng(0)
    p = _params(rng, c)
    ln_p = {"scale": rng.standard_normal(c).astype(np.float32),
            "bias": rng.standard_normal(c).astype(np.float32)}
    pe = rng.standard_normal((f, c)).astype(np.float32)
    x = rng.standard_normal((b, f, s, c)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = JT.temporal_attention_fused(
            jnp.asarray(x), jnp.asarray(ln_p["scale"]),
            jnp.asarray(ln_p["bias"]), jnp.asarray(pe), *_jax_weights(p),
            frames=f, heads=heads, ln=True, residual=True)
    got = T.temporal_attention_ln(_torch(p), {k: tt(v) for k, v in
                                              ln_p.items()},
                                  tt(pe), tt(x), heads)
    np.testing.assert_allclose(nn(got), nn(ref), atol=5e-5)


@pytest.mark.parametrize("b,f,s,c,heads", [
    (2, 8, 48, 64, 4),
    (1, 16, 32, 32, 2),
])
def test_attention_matches_pallas(b, f, s, c, heads):
    rng = np.random.default_rng(1)
    p = _params(rng, c)
    x = rng.standard_normal((b, f, s, c)).astype(np.float32)
    z = jnp.zeros((c,), jnp.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = JT.temporal_attention_fused(
            jnp.asarray(x), z, z, jnp.zeros((f, c), jnp.float32),
            *_jax_weights(p), frames=f, heads=heads, ln=False,
            residual=False)
    got = T.temporal_attn_plain(_torch(p), tt(x), heads)
    np.testing.assert_allclose(nn(got), nn(ref), atol=3e-5)


def test_wrapper_counts_only_kernel_launches():
    rng = np.random.default_rng(2)
    p = _torch(_params(rng, 32))
    ln_p = {"scale": torch.ones(32), "bias": torch.zeros(32)}
    before = T.temporal_attention_ln.launches
    T.temporal_attention_ln(p, ln_p, torch.zeros(4, 32),
                            tt(rng.standard_normal((1, 4, 6, 32))), 4)
    assert T.temporal_attention_ln.launches == before
