"""The temporal attention core (csrc/temporal_attention.cu) on the CPU: its
plain version against mimo_tpu, the kernel's tile math emulated item by
item and problem by problem, and the plan it is launched with.

Tolerances:
- plain core + to_out against mimo_tpu (``_temporal_attn``'s einsum path
  and ``temporal_attention_fused`` in interpret mode): atol 3e-5, fp32 on
  both sides, the one tests/test_torch_temporal_attention.py holds the
  attention to (only the summation order differs);
- the emulation against the plain core, both on the same bf16 q|k|v:
  atol 2^-7·max|v|. The logits' fp32 sums run in another order and the
  kernel takes exp2 where the plain core takes exp, so a weight can round
  to the neighbouring bf16 value (at most 2^-8 of itself: at most
  2^-8·max|v| on the output), and the bf16 output can round the other way
  (2^-8·max|v| more).
"""

import math

import numpy as np
import pytest
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from mimo_tpu.models import unet as JU
from mimo_tpu.ops import temporal_attention as JT
from mimo_tpu_torch.models.layers import linear
from mimo_tpu_torch.ops import temporal_attention as T
from mimo_tpu_torch.ops.ffn import qkv_weights
from tests.test_torch_helpers import nn, set_fp32_matmuls, tt

set_fp32_matmuls()

BF = torch.bfloat16
# (S, C) of the motion modules at UNet levels 0-3, 8 heads (MIMOConfig()):
# 64x98 latents (512x784 frames), then the edit path's 98x98 (784x784)
LEVELS = [(6272, 320), (1568, 640), (400, 1280), (104, 1280),
          (9604, 320), (2401, 640), (625, 1280), (169, 1280)]


def _params(rng, c):
    p = {name: {"kernel": (rng.standard_normal((c, c)) / np.sqrt(c))
                .astype(np.float32)}
         for name in ("to_q", "to_k", "to_v", "to_out")}
    p["to_out"]["bias"] = rng.standard_normal(c).astype(np.float32) * 0.1
    return p


@pytest.mark.parametrize("b,f,s,c,heads", [
    (2, 8, 48, 64, 4),
    (1, 24, 16, 32, 2),      # the main path's 24 frames
    (1, 5, 128, 48, 3),      # a short window (the Pallas block: 128 s)
])
def test_core_plain_matches_jax(b, f, s, c, heads):
    """The (B·F·S, 3C) core between the port's own q|k|v projection and
    to_out, against both mimo_tpu paths of the attention alone."""
    rng = np.random.default_rng(f)
    p = _params(rng, c)
    x = rng.standard_normal((b, f, s, c)).astype(np.float32)
    pt = {k: {kk: tt(vv) for kk, vv in v.items()} for k, v in p.items()}
    qkv = tt(x).reshape(-1, c) @ torch.cat(qkv_weights(pt), dim=1)
    o = T.temporal_attn_core_plain(qkv, b, f, s, heads)
    got = linear(pt["to_out"], o).reshape(b, f, s, c)

    pj = {k: {kk: jnp.asarray(vv) for kk, vv in v.items()}
          for k, v in p.items()}
    einsum = JU._temporal_attn(pj, jnp.asarray(x), f, heads)
    z = jnp.zeros((c,), jnp.float32)
    with pltpu.force_tpu_interpret_mode():
        fused = JT.temporal_attention_fused(
            jnp.asarray(x), z, z, jnp.zeros((f, c), jnp.float32),
            pj["to_q"]["kernel"], pj["to_k"]["kernel"], pj["to_v"]["kernel"],
            pj["to_out"]["kernel"], pj["to_out"]["bias"], frames=f,
            heads=heads, ln=False, residual=False)
    np.testing.assert_allclose(nn(got), nn(einsum), atol=3e-5)
    np.testing.assert_allclose(nn(got), nn(fused), atol=3e-5)


def _tile_math(q, k, v, f, d, sl):
    """One warp's problem: q, k, v (32, d) bf16, rows past F already read
    as row F - 1. Q.K^T in k16 steps and a k8 step (fp32 sums), keys >= F
    masked, p = exp2(l·c − max·c), normalised and rounded to bf16, P.V in
    16-key steps (fp32 sums), o rounded to bf16."""
    qf, kf, vf = q.float(), k.float(), v.float()
    logits = torch.zeros(32, 32)
    for k0 in range(0, d, 16):
        logits = logits + qf[:, k0:k0 + 16] @ kf[:, k0:k0 + 16].T
    logits[:, f:] = -math.inf
    mx = logits.max(dim=1, keepdim=True).values
    p = torch.exp2(logits * sl - mx * sl)
    p = (p / p.sum(dim=1, keepdim=True)).to(BF).float()
    o = torch.zeros(32, d)
    for j in range(0, 32, 16):
        o = o + p[:, j:j + 16] @ vf[j:j + 16]
    return o.to(BF)


def kernel_core(qkv, b, f, s, heads):
    """What tattn_kernel computes, in its order: each item (batch row, run
    of positions, head group) copied span by span into a stage of
    ``row_stride``-wide rows (p·F + f), each (position, head) problem read
    from the stage, its o written over q, then the o rows stored."""
    c = qkv.shape[1] // 3
    d = c // heads
    plan = T.core_plan(f, s, heads, d)
    g, cw, rs = plan.group, plan.group * d, plan.row_stride
    sl = T.LOG2E / math.sqrt(d)
    clamp = torch.clamp(torch.arange(32), max=f - 1)    # frames past F
    out = torch.full((b * f * s, c), math.nan, dtype=BF)
    for bi in range(b):
        for s0 in range(0, s, plan.positions):
            np_ = min(plan.positions, s - s0)
            # global row of staged row p·F + f
            rows = torch.tensor([(bi * f + fi) * s + s0 + p
                                 for p in range(np_) for fi in range(f)])
            for h0 in range(0, heads, g):
                stage = torch.zeros(plan.positions * f, rs, dtype=BF)
                for seg in range(3):
                    col = seg * c + h0 * d
                    stage[:len(rows), seg * cw:(seg + 1) * cw] = \
                        qkv[rows, col:col + cw]
                for p in range(np_):
                    for hj in range(g):
                        r = p * f + clamp
                        q, k, v = (stage[r, seg * cw + hj * d:
                                         seg * cw + (hj + 1) * d]
                                   for seg in range(3))
                        o = _tile_math(q, k, v, f, d, sl)
                        stage[p * f:(p + 1) * f, hj * d:(hj + 1) * d] = o[:f]
                out[rows, h0 * d:h0 * d + cw] = stage[:len(rows), :cw]
    return out


@pytest.mark.parametrize("d", [8, 40, 80, 160])
@pytest.mark.parametrize("f", [1, 5, 16, 24, 32])
def test_tile_emulation_matches_plain(f, d):
    heads, b, s = 2, 2, 3
    gen = torch.Generator().manual_seed(f * 1000 + d)
    qkv = (torch.randn((b * f * s, 3 * heads * d), generator=gen) * 2).to(BF)
    got = kernel_core(qkv, b, f, s, heads)
    want = T.temporal_attn_core_plain(qkv, b, f, s, heads)
    v_max = float(qkv[:, 2 * heads * d:].float().abs().max())
    assert torch.isfinite(got.float()).all()      # every row stored
    np.testing.assert_allclose(nn(got), nn(want), rtol=0, atol=2 ** -7 * v_max)


@pytest.mark.parametrize("s,c", LEVELS)
def test_plan_at_main_path_shapes(s, c):
    """For every F the kernel takes, at each level: the ring fits one H100
    block with two or more stages, the head group divides the heads and is
    the widest that leaves two stages, a staged row holds the group's q|k|v
    in an odd number of 16-byte chunks, and a stage's bytes fit an
    mbarrier's transaction count."""
    heads = 8
    d = c // heads
    for f in range(1, T.MAX_FRAMES + 1):
        plan = T.core_plan(f, s, heads, d)
        stage = plan.positions * f * plan.row_stride * 2
        assert 2 <= plan.stages <= T.MAX_STAGES
        assert T.BAR_BYTES + plan.stages * stage <= T.SMEM_LIMIT
        assert heads % plan.group == 0
        wider = [g for g in range(plan.group + 1, heads + 1) if heads % g == 0]
        if wider:
            rs = (3 * wider[0] * d // 8 | 1) * 8
            assert T.BAR_BYTES + 2 * f * rs * 2 > T.SMEM_LIMIT
        assert plan.row_stride >= 3 * plan.group * d
        assert plan.row_stride % 8 == 0 and (plan.row_stride // 8) % 2 == 1
        assert 1 <= plan.positions <= s
        assert stage < 1 << 20


@pytest.mark.parametrize("f,d", [(0, 40), (33, 40), (24, 12), (24, 168)])
def test_plan_refuses_what_the_kernel_does_not_take(f, d):
    with pytest.raises(ValueError, match="temporal attention kernel"):
        T.core_plan(f, 100, 8, d)


def test_core_wrapper_takes_the_plain_version_on_cpu():
    gen = torch.Generator().manual_seed(3)
    qkv = torch.randn((2 * 5 * 4, 3 * 32), generator=gen)
    before = T.temporal_attn_core.launches
    got = T.temporal_attn_core(qkv, 2, 5, 4, 2)
    assert T.temporal_attn_core.launches == before
    torch.testing.assert_close(got, T.temporal_attn_core_plain(qkv, 2, 5, 4,
                                                               2))
