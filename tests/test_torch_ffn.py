"""The port's GEMM-chain ops (plain versions, as the wrappers run them on CPU
tensors) against the Pallas kernels of mimo_tpu/ops/ffn.py in interpret
mode: LN + GEGLU FF + residual, LN + q|k|v, out-projection + residual and
bias-only projection, each in its row-major and SNC form.

Tolerance: atol 2e-4, the one tests/test_ffn_kernel.py holds the Pallas
kernels to against the unfused XLA path (fp32; the kernels' LN takes
E[x²]−E[x]² where the port centres first, and the Pallas gelu uses a
rational erf good to 1.5e-7).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from mimo_tpu.ops import ffn as JF
from mimo_tpu_torch.ops import ffn as FF
from tests.test_torch_helpers import nn, set_fp32_matmuls, tt

set_fp32_matmuls()

ATOL = 2e-4


def _lin(rng, k, n, bias=True):
    p = {"kernel": (rng.standard_normal((k, n)) / np.sqrt(k))
         .astype(np.float32)}
    if bias:
        p["bias"] = rng.standard_normal(n).astype(np.float32) * 0.1
    return p


def _ln(rng, c):
    return {"scale": rng.standard_normal(c).astype(np.float32),
            "bias": rng.standard_normal(c).astype(np.float32)}


def _t(tree):
    return {k: _t(v) if isinstance(v, dict) else tt(v)
            for k, v in tree.items()}


def _j(tree):
    return {k: _j(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in tree.items()}


def _ff(rng, c, mult):
    return {"proj_in": _lin(rng, c, 2 * mult * c),
            "proj_out": _lin(rng, mult * c, c)}


def _attn(rng, c):
    return {name: _lin(rng, c, c, bias=False)
            for name in ("to_q", "to_k", "to_v")}


def _w3(attn_p):
    return jnp.concatenate([jnp.asarray(attn_p[k]["kernel"])
                            for k in ("to_q", "to_k", "to_v")], axis=1)


@pytest.mark.parametrize("shape,mult", [
    ((3, 40, 64), 2),        # 3-D tokens
    ((2, 5, 24, 128), 2),    # 4-D motion-module tokens
    ((3, 41, 64), 4),        # 123 rows: a ragged row block
])
def test_ffn_matches_pallas_nsc(shape, mult):
    rng = np.random.default_rng(0)
    c = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    ln_p, ff_p = _ln(rng, c), _ff(rng, c, mult)
    with pltpu.force_tpu_interpret_mode():
        ref = JF._ffn_pallas_nsc(
            jnp.asarray(x.reshape(-1, c)), ln_p["scale"], ln_p["bias"],
            ff_p["proj_in"]["kernel"], ff_p["proj_in"]["bias"],
            ff_p["proj_out"]["kernel"], ff_p["proj_out"]["bias"], 1e-5)
    got = FF.ffn_ln_geglu_fused(tt(x), _t(ln_p), _t(ff_p))
    np.testing.assert_allclose(nn(got), nn(ref).reshape(shape), atol=ATOL)


def test_ffn_matches_pallas_snc():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((5, 40, 64)).astype(np.float32)
    ln_p, ff_p = _ln(rng, 64), _ff(rng, 64, 2)
    with pltpu.force_tpu_interpret_mode():
        y_t = JF._ffn_pallas_snc(
            jnp.asarray(np.transpose(x, (1, 0, 2))), ln_p["scale"],
            ln_p["bias"], ff_p["proj_in"]["kernel"], ff_p["proj_in"]["bias"],
            ff_p["proj_out"]["kernel"], ff_p["proj_out"]["bias"], 1e-5)
    got = FF.ffn_ln_geglu_fused(tt(x), _t(ln_p), _t(ff_p))
    np.testing.assert_allclose(nn(got), np.transpose(nn(y_t), (1, 0, 2)),
                               atol=ATOL)


@pytest.mark.parametrize("snc", [False, True])
@pytest.mark.parametrize("s", [40, 44])          # 44: ragged S block
def test_qkv_ln_matches_pallas(snc, s):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, s, 64)).astype(np.float32)
    ln_p, attn_p = _ln(rng, 64), _attn(rng, 64)
    with pltpu.force_tpu_interpret_mode():
        if snc:
            ref = JF._qkv_ln_pallas_snc(
                jnp.asarray(np.transpose(x, (1, 0, 2))), ln_p["scale"],
                ln_p["bias"], _w3(attn_p), 1e-5)
        else:
            ref = JF._qkv_ln_pallas(jnp.asarray(x.reshape(-1, 64)),
                                    ln_p["scale"], ln_p["bias"],
                                    _w3(attn_p), 1e-5)
    got = FF.qkv_ln_fused(tt(x), _t(ln_p), _t(attn_p))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(nn(g), nn(r).reshape(x.shape), atol=ATOL)


@pytest.mark.parametrize("snc", [False, True])
def test_matmul_bias_residual_matches_pallas(snc):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 40, 64)).astype(np.float32)
    res = rng.standard_normal((3, 40, 96)).astype(np.float32)
    lin = _lin(rng, 64, 96)
    with pltpu.force_tpu_interpret_mode():
        if snc:
            ref = np.transpose(nn(JF._matmul_res_pallas_snc(
                jnp.asarray(x), lin["kernel"], lin["bias"],
                jnp.asarray(np.transpose(res, (1, 0, 2))))), (1, 0, 2))
        else:
            ref = nn(JF._matmul_res_pallas(
                jnp.asarray(x.reshape(-1, 64)), lin["kernel"], lin["bias"],
                jnp.asarray(res.reshape(-1, 96)))).reshape(res.shape)
    got = FF.matmul_bias_residual(tt(x), _t(lin), tt(res))
    np.testing.assert_allclose(nn(got), ref, atol=ATOL)


@pytest.mark.parametrize("snc", [False, True])
def test_matmul_bias_matches_pallas(snc):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 40, 64)).astype(np.float32)
    lin = _lin(rng, 64, 96)
    with pltpu.force_tpu_interpret_mode():
        if snc:
            ref = np.transpose(nn(JF._matmul_pallas_snc(
                jnp.asarray(np.transpose(x, (1, 0, 2))), lin["kernel"],
                lin["bias"])), (1, 0, 2))
        else:
            ref = nn(JF._matmul_pallas(jnp.asarray(x.reshape(-1, 64)),
                                       lin["kernel"], lin["bias"]))
    got = FF.matmul_bias(tt(x), _t(lin))
    np.testing.assert_allclose(nn(got), ref.reshape(3, 40, 96), atol=ATOL)


def test_wrappers_count_only_kernel_launches():
    rng = np.random.default_rng(5)
    x = tt(rng.standard_normal((2, 8, 32)))
    ln_p, ff_p, attn_p = _t(_ln(rng, 32)), _t(_ff(rng, 32, 2)), \
        _t(_attn(rng, 32))
    lin = _t(_lin(rng, 32, 32))
    wrappers = (FF.ffn_ln_geglu_fused, FF.qkv_ln_fused,
                FF.matmul_bias_residual, FF.matmul_bias)
    before = [w.launches for w in wrappers]
    FF.ffn_ln_geglu_fused(x, ln_p, ff_p)
    FF.qkv_ln_fused(x, ln_p, attn_p)
    FF.matmul_bias_residual(x, lin, x)
    FF.matmul_bias(x, lin)
    assert [w.launches for w in wrappers] == before


def test_gemm_refuses_cpu_tensors():
    """The kernel entry never computes on the CPU: it raises."""
    x = torch.zeros((8, 16), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        FF.gemm(x, torch.zeros((16, 8), dtype=torch.bfloat16))
