"""Temporal attention of the motion modules, ``x + to_out(attn_F×F(LN(x) +
pe))``: the CUDA kernels and the plain PyTorch version.

Counterpart of ``mimo_tpu/ops/temporal_attention.py``
(``temporal_attention_fused`` with ``ln=True, residual=True``, dispatched by
``temporal_attention_ln``). On the card the chain is three launches over the
(B, F, S, C) token tensor, none of which transposes it:

1. the GEMM tile core (``csrc/gemm.cu``) with the LayerNorm + PE prologue
   and one (C, 3C) product writes q|k|v as (B·F·S, 3C);
2. ``csrc/temporal_attention.cu`` runs the F×F softmax attention of every
   (b, s, head) and writes (B·F·S, C);
3. the GEMM tile core with the bias + residual epilogue applies ``to_out``
   and adds x.

Numerics are those of the einsum path of ``mimo_tpu/models/unet.py``
(``_temporal_attn``): logits and softmax in fp32, the weights rounded to the
activation dtype before the product with v.

``temporal_attention_ln`` takes the plain version for CPU tensors only. For
a CUDA tensor it launches the kernels or raises;
``temporal_attention_ln.launches`` counts the calls that launched them.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch

from mimo_tpu_torch.models.layers import layer_norm, linear
from mimo_tpu_torch.ops import _build
from mimo_tpu_torch.ops.ffn import gemm, qkv_weights

Params = Dict[str, Any]

LOG2E = 1.4426950408889634
MAX_FRAMES = 32


def temporal_attn_plain(p_attn: Params, x_norm: torch.Tensor,
                        heads: int) -> torch.Tensor:
    """to_out(attn_F×F(x_norm)) in the (B, F, S, C) layout: the frame-axis
    contraction happens inside einsums, logits in fp32."""
    b, f, s, c = x_norm.shape
    d = c // heads
    q = linear(p_attn["to_q"], x_norm).reshape(b, f, s, heads, d)
    k = linear(p_attn["to_k"], x_norm).reshape(b, f, s, heads, d)
    v = linear(p_attn["to_v"], x_norm).reshape(b, f, s, heads, d)
    logits = torch.einsum("bfshd,bgshd->bhfgs", q.float(), k.float())
    w = torch.softmax(logits * (1.0 / math.sqrt(d)), dim=3).to(x_norm.dtype)
    o = torch.einsum("bhfgs,bgshd->bfshd", w, v).reshape(b, f, s, c)
    return linear(p_attn["to_out"], o)


def temporal_attention_plain(p_attn: Params, ln_p: Params, pe: torch.Tensor,
                             x: torch.Tensor, heads: int,
                             eps: float = 1e-5) -> torch.Tensor:
    """x + to_out(attn(LN(x) + pe)); x (B, F, S, C), pe (F, C). The PE is
    added to the normed states (reference motion_module.py:361-368)."""
    normed = layer_norm(ln_p, x, eps) + pe.to(x.dtype)[None, :, None, :]
    return x + temporal_attn_plain(p_attn, normed, heads)


def _attention_core_cuda(qkv: torch.Tensor, b: int, f: int, s: int,
                         heads: int) -> torch.Tensor:
    c = qkv.shape[1] // 3
    d = c // heads
    if f > MAX_FRAMES or d * heads != c or d % 8:
        raise ValueError(f"temporal attention kernel: needs F <= {MAX_FRAMES} "
                         f"and a head dim divisible by 8 (F={f}, C={c}, "
                         f"heads={heads})")
    out = torch.empty((qkv.shape[0], c), dtype=qkv.dtype, device=qkv.device)
    err = _build.load_library().mimo_temporal_attention_fwd(
        qkv.data_ptr(), out.data_ptr(), b, f, s, heads, d,
        LOG2E / math.sqrt(d), torch.cuda.current_stream(qkv.device).cuda_stream)
    _build.check(err, "temporal_attention_ln")
    return out


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
    o = _attention_core_cuda(qkv, b, f, s, heads)
    y = gemm(o, p_attn["to_out"]["kernel"], bias=p_attn["to_out"].get("bias"),
             res=x)
    temporal_attention_ln.launches += 1
    return y.reshape(x.shape)


temporal_attention_ln.launches = 0
