"""Temporal attention of the motion modules, ``x + to_out(attn_F×F(LN(x) +
pe))``: the CUDA kernels and the plain PyTorch version.

Counterpart of ``mimo_tpu/ops/temporal_attention.py``
(``temporal_attention_fused`` with ``ln=True, residual=True``, dispatched by
``temporal_attention_ln``). On the card the chain is three launches over the
(B, F, S, C) token tensor, none of which transposes it:

1. the GEMM tile core (``csrc/gemm.cu``) with the LayerNorm + PE prologue
   and one (C, 3C) product writes q|k|v as (B·F·S, 3C);
2. ``temporal_attn_core`` (``csrc/temporal_attention.cu``) runs the F×F
   softmax attention of every (b, s, head) and writes (B·F·S, C);
3. the GEMM tile core with the bias + residual epilogue applies ``to_out``
   and adds x.

Numerics are those of the einsum path of ``mimo_tpu/models/unet.py``
(``_temporal_attn``): logits and softmax in fp32, the weights rounded to the
activation dtype before the product with v.

``temporal_attention_ln`` and ``temporal_attn_core`` take their plain
versions for CPU tensors only. For a CUDA tensor they launch the kernels or
raise; their ``launches`` count the calls that launched them.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Any, Dict, NamedTuple

import torch

from mimo_tpu_torch.models.layers import layer_norm, linear
from mimo_tpu_torch.ops import _build
from mimo_tpu_torch.ops.ffn import gemm, qkv_weights

Params = Dict[str, Any]

LOG2E = 1.4426950408889634
MAX_FRAMES = 32
MAX_HEAD_DIM = 160
# the core kernel's ring (csrc/temporal_attention.cu: kSmemLimit, kBarBytes,
# kMaxStages): one block per SM, mbarriers first, then the stages
SMEM_LIMIT = 232448
BAR_BYTES = 1024
MAX_STAGES = 8
STAGE_BYTES = 48 * 1024   # what a stage is sized to, at least one position


def temporal_attn_core_plain(qkv: torch.Tensor, b: int, f: int, s: int,
                             heads: int) -> torch.Tensor:
    """The F×F softmax attention of every (b, s, head) on the (B·F·S, 3C)
    q|k|v rows (row (b·F + f)·S + s), -> (B·F·S, C) in the same rows:
    logits and softmax in fp32, the weights rounded to qkv's dtype before
    the product with v."""
    c = qkv.shape[1] // 3
    d = c // heads
    q, k, v = qkv.reshape(b, f, s, 3, heads, d).unbind(3)
    logits = torch.einsum("bfshd,bgshd->bhfgs", q.float(), k.float())
    w = torch.softmax(logits * (1.0 / math.sqrt(d)), dim=3).to(qkv.dtype)
    return torch.einsum("bhfgs,bgshd->bfshd", w, v).reshape(b * f * s, c)


def temporal_attn_plain(p_attn: Params, x_norm: torch.Tensor,
                        heads: int) -> torch.Tensor:
    """to_out(attn_F×F(x_norm)) in the (B, F, S, C) layout: the frame-axis
    contraction happens inside einsums, logits in fp32."""
    b, f, s, c = x_norm.shape
    qkv = torch.cat([linear(p_attn[k], x_norm)
                     for k in ("to_q", "to_k", "to_v")], dim=-1)
    o = temporal_attn_core_plain(qkv.reshape(b * f * s, 3 * c), b, f, s,
                                 heads)
    return linear(p_attn["to_out"], o.reshape(b, f, s, c))


def temporal_attention_plain(p_attn: Params, ln_p: Params, pe: torch.Tensor,
                             x: torch.Tensor, heads: int,
                             eps: float = 1e-5) -> torch.Tensor:
    """x + to_out(attn(LN(x) + pe)); x (B, F, S, C), pe (F, C). The PE is
    added to the normed states (reference motion_module.py:361-368)."""
    normed = layer_norm(ln_p, x, eps) + pe.to(x.dtype)[None, :, None, :]
    return x + temporal_attn_plain(p_attn, normed, heads)


class CorePlan(NamedTuple):
    """How the core kernel cuts its work: an item is ``positions``
    consecutive positions × ``group`` heads × all frames of one batch row;
    a staged (position, frame) row holds the item's q | k | v columns at
    ``row_stride`` elements; the ring has ``stages`` stages."""

    group: int
    positions: int
    row_stride: int
    stages: int


@lru_cache(maxsize=None)
def core_plan(f: int, s: int, heads: int, d: int) -> CorePlan:
    """The core kernel's plan for F frames, S positions, ``heads`` heads of
    width d. Raises ValueError where the kernel does not apply."""
    if not (1 <= f <= MAX_FRAMES and d % 8 == 0 and 8 <= d <= MAX_HEAD_DIM
            and heads >= 1 and s >= 1):
        raise ValueError(f"temporal attention kernel: needs 1 <= F <= "
                         f"{MAX_FRAMES} and a head dim d % 8 == 0, 8 <= d <= "
                         f"{MAX_HEAD_DIM} (F={f}, d={d}, heads={heads})")

    def row_stride(g):
        # q | k | v of g heads in an odd number of 16-byte chunks: the 8
        # frame rows one ldmatrix reads fall on distinct banks
        return (3 * g * d // 8 | 1) * 8

    # the most heads (a divisor of heads) whose position still fits two
    # stages: the fewer and longer the copies, the less the producer spends
    # on each byte
    room = SMEM_LIMIT - BAR_BYTES
    group = max(g for g in range(1, heads + 1)
                if heads % g == 0 and (g == 1 or 2 * f * row_stride(g) * 2
                                       <= room))
    per_position = f * row_stride(group) * 2
    positions = max(1, min(s, STAGE_BYTES // per_position))
    stages = min(MAX_STAGES, room // (positions * per_position))
    return CorePlan(group, positions, row_stride(group), stages)


def temporal_attn_core(qkv: torch.Tensor, b: int, f: int, s: int,
                       heads: int) -> torch.Tensor:
    """``temporal_attn_core_plain`` on the card: the kernel of
    ``csrc/temporal_attention.cu`` for a CUDA tensor (bf16, contiguous),
    the plain version for a CPU tensor."""
    if not qkv.is_cuda:
        return temporal_attn_core_plain(qkv, b, f, s, heads)
    c = qkv.shape[1] // 3
    d = c // heads
    if (qkv.dtype != torch.bfloat16 or not qkv.is_contiguous()
            or tuple(qkv.shape) != (b * f * s, 3 * c) or d * heads != c
            or qkv.data_ptr() % 16):
        raise ValueError(f"temporal attention kernel: needs contiguous, "
                         f"16-byte aligned bf16 q|k|v of shape ({b * f * s}, "
                         f"3 * heads * d), got {qkv.dtype} "
                         f"{tuple(qkv.shape)} with heads={heads}")
    plan = core_plan(f, s, heads, d)
    out = torch.empty((qkv.shape[0], c), dtype=qkv.dtype, device=qkv.device)
    err = _build.load_library().mimo_temporal_attention_fwd(
        qkv.data_ptr(), out.data_ptr(), b, f, s, heads, d, *plan,
        LOG2E / math.sqrt(d),
        torch.cuda.current_stream(qkv.device).cuda_stream)
    _build.check(err, "temporal_attn_core")
    temporal_attn_core.launches += 1
    return out


temporal_attn_core.launches = 0


def temporal_attention_ln(p_attn: Params, ln_p: Params, pe: torch.Tensor,
                          x: torch.Tensor, heads: int,
                          eps: float = 1e-5) -> torch.Tensor:
    """x + to_out(attn_F×F(LN(x) + pe)) over x (B, F, S, C), pe (F, C)."""
    if not x.is_cuda:
        return temporal_attention_plain(p_attn, ln_p, pe, x, heads, eps)
    b, f, s, c = x.shape
    if pe.shape != (f, c):
        raise ValueError(f"temporal attention: pe {tuple(pe.shape)}, "
                         f"expected ({f}, {c})")
    qkv = gemm(x, qkv_weights(p_attn), ln=(ln_p["scale"], ln_p["bias"], eps),
               pe=pe, pe_div=s)
    o = temporal_attn_core(qkv, b, f, s, heads)
    y = gemm(o, p_attn["to_out"]["kernel"], bias=p_attn["to_out"].get("bias"),
             res=x)
    temporal_attention_ln.launches += 1
    return y.reshape(x.shape)


temporal_attention_ln.launches = 0
