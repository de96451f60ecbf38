"""Functional NN primitives over parameter dicts, NHWC at the public surface.

Counterpart of ``mimo_tpu/models/layers.py``, with the same conventions:

- feature maps are ``(N, H, W, C)``; videos fold frames into the batch;
- linear kernels are ``(in, out)``; norms and softmax statistics
  accumulate in fp32 whatever the compute dtype.

One layout differs: conv kernels are stored OIHW in ``channels_last``
memory format (PyTorch's), where the JAX package stores HWIO. The weights
bridge transposes them once at load. ``conv2d`` hands the NHWC activation
to ``F.conv2d`` as a ``channels_last`` NCHW view, so no layout copy is made
on either side.

Each ``*_init`` draws from an explicit ``torch.Generator`` (on the
generator's device) with the bounds of the JAX initialisers, so random-init
activations at full width stay in the range the JAX bench ran at.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Union

import torch
import torch.nn.functional as F

from mimo_tpu_torch.ops.attention import dispatch_sdpa
from mimo_tpu_torch.ops.groupnorm import group_norm_fused

Params = Dict[str, Any]


def _uniform(gen: torch.Generator, shape, bound: float,
             dtype: torch.dtype) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=gen.device,
                   dtype=torch.float32)
    return (u * (2.0 * bound) - bound).to(dtype)


def _channels_last(w: torch.Tensor) -> torch.Tensor:
    return w.contiguous(memory_format=torch.channels_last)


# ---------------------------------------------------------------------------
# linear
# ---------------------------------------------------------------------------


def linear_init(gen: torch.Generator, d_in: int, d_out: int, bias: bool = True,
                dtype: torch.dtype = torch.float32) -> Params:
    bound = 1.0 / math.sqrt(d_in)
    p = {"kernel": _uniform(gen, (d_in, d_out), bound, dtype)}
    if bias:
        p["bias"] = _uniform(gen, (d_out,), bound, dtype)
    return p


def linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = torch.matmul(x, p["kernel"].to(x.dtype))
    if "bias" in p:
        y = y + p["bias"].to(x.dtype)
    return y


# ---------------------------------------------------------------------------
# conv2d (NHWC activations, OIHW channels_last kernels)
# ---------------------------------------------------------------------------


def conv2d_init(gen: torch.Generator, kh: int, kw: int, c_in: int, c_out: int,
                bias: bool = True, dtype: torch.dtype = torch.float32,
                zero: bool = False, groups: int = 1) -> Params:
    c_in = c_in // groups
    shape = (c_out, c_in, kh, kw)
    dev = gen.device
    if zero:
        p = {"kernel": _channels_last(torch.zeros(shape, dtype=dtype,
                                                  device=dev))}
        if bias:
            p["bias"] = torch.zeros((c_out,), dtype=dtype, device=dev)
        return p
    bound = 1.0 / math.sqrt(c_in * kh * kw)
    p = {"kernel": _channels_last(_uniform(gen, shape, bound, dtype))}
    if bias:
        p["bias"] = _uniform(gen, (c_out,), bound, dtype)
    return p


def conv2d(p: Params, x: torch.Tensor, stride: int = 1,
           padding: Union[int, str] = "SAME", groups: int = 1) -> torch.Tensor:
    """x: (N, H, W, C) -> (N, H', W', C_out). ``padding`` is an int, "SAME"
    (stride 1) or "VALID"."""
    if isinstance(padding, str):
        padding = {"SAME": "same", "VALID": 0}[padding]
    w = p["kernel"].to(x.dtype)
    b = p["bias"].to(x.dtype) if "bias" in p else None
    xn = x.permute(0, 3, 1, 2)            # channels_last view, no copy
    y = F.conv2d(xn, w, b, stride=stride, padding=padding, groups=groups)
    return y.permute(0, 2, 3, 1).contiguous()


# ---------------------------------------------------------------------------
# norms (fp32 statistics)
# ---------------------------------------------------------------------------


def group_norm_init(channels: int, dtype: torch.dtype = torch.float32,
                    device=None) -> Params:
    return {"scale": torch.ones((channels,), dtype=dtype, device=device),
            "bias": torch.zeros((channels,), dtype=dtype, device=device)}


def group_norm(p: Params, x: torch.Tensor, groups: int, eps: float = 1e-5,
               fuse_silu: bool = False,
               row_add: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GroupNorm over the trailing channel axis of an (N, ..., C) tensor;
    statistics per (N, group) in fp32, through the GroupNorm kernel on
    CUDA tensors (ops/groupnorm.py). ``row_add`` (N, C) is added to x
    before the statistics (the resnet time embedding); ``fuse_silu``
    applies SiLU to the result."""
    return group_norm_fused(x, p["scale"], p["bias"], groups, eps,
                            fuse_silu=fuse_silu, row_add=row_add)


def layer_norm_init(dim: int, dtype: torch.dtype = torch.float32,
                    device=None) -> Params:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device),
            "bias": torch.zeros((dim,), dtype=dtype, device=device)}


def layer_norm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    y = F.layer_norm(x.float(), (x.shape[-1],), p["scale"].float(),
                     p["bias"].float(), eps)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def mha_init(gen: torch.Generator, query_dim: int,
             context_dim: Optional[int] = None,
             inner_dim: Optional[int] = None, out_bias: bool = True,
             dtype: torch.dtype = torch.float32) -> Params:
    """diffusers-style Attention params: to_q/to_k/to_v (no bias) + to_out."""
    context_dim = context_dim or query_dim
    inner_dim = inner_dim or query_dim
    return {
        "to_q": linear_init(gen, query_dim, inner_dim, bias=False, dtype=dtype),
        "to_k": linear_init(gen, context_dim, inner_dim, bias=False,
                            dtype=dtype),
        "to_v": linear_init(gen, context_dim, inner_dim, bias=False,
                            dtype=dtype),
        "to_out": linear_init(gen, inner_dim, query_dim, bias=out_bias,
                              dtype=dtype),
    }


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         heads: int) -> torch.Tensor:
    """Scaled dot-product attention over (B, S, inner) tensors; long
    sequences dispatch to the flash kernel (ops/attention.py)."""
    return dispatch_sdpa(q, k, v, heads)


def mha(p: Params, x: torch.Tensor, context: Optional[torch.Tensor],
        heads: int) -> torch.Tensor:
    """Multi-head attention: x (B, Sq, Dq), context (B, Sk, Dk) or None."""
    ctx = x if context is None else context
    q = linear(p["to_q"], x)
    k = linear(p["to_k"], ctx)
    v = linear(p["to_v"], ctx)
    return linear(p["to_out"], sdpa(q, k, v, heads))


# ---------------------------------------------------------------------------
# feed-forward (GEGLU)
# ---------------------------------------------------------------------------


def geglu_ff_init(gen: torch.Generator, dim: int, mult: int = 4,
                  dtype: torch.dtype = torch.float32) -> Params:
    inner = dim * mult
    return {
        "proj_in": linear_init(gen, dim, inner * 2, dtype=dtype),
        "proj_out": linear_init(gen, inner, dim, dtype=dtype),
    }


def geglu_ff(p: Params, x: torch.Tensor) -> torch.Tensor:
    h, gate = linear(p["proj_in"], x).chunk(2, dim=-1)
    h = h * F.gelu(gate.float(), approximate="none").to(x.dtype)
    return linear(p["proj_out"], h)


# ---------------------------------------------------------------------------
# timestep embedding (diffusers Timesteps + TimestepEmbedding)
# ---------------------------------------------------------------------------


def sinusoidal_timestep_embedding(t: torch.Tensor, dim: int,
                                  flip_sin_to_cos: bool = True,
                                  freq_shift: float = 0.0,
                                  max_period: float = 10000.0) -> torch.Tensor:
    """t: (B,) -> (B, dim) fp32 (diffusers get_timestep_embedding)."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device)
    exponent = exponent / (half - freq_shift)
    emb = torch.exp(exponent)[None, :] * t.float()[:, None]
    sin, cos = torch.sin(emb), torch.cos(emb)
    if flip_sin_to_cos:
        return torch.cat([cos, sin], dim=-1)
    return torch.cat([sin, cos], dim=-1)


def time_mlp_init(gen: torch.Generator, in_dim: int, embed_dim: int,
                  dtype: torch.dtype = torch.float32) -> Params:
    return {
        "fc1": linear_init(gen, in_dim, embed_dim, dtype=dtype),
        "fc2": linear_init(gen, embed_dim, embed_dim, dtype=dtype),
    }


def time_mlp(p: Params, emb: torch.Tensor) -> torch.Tensor:
    return linear(p["fc2"], F.silu(linear(p["fc1"], emb)))


# ---------------------------------------------------------------------------
# resampling
# ---------------------------------------------------------------------------


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, 2H, 2W, C) nearest-neighbour."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def upsample_nearest_to(x: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """Nearest-neighbour resize to (th, tw) with floor(i*n/s) indexing
    (torch F.interpolate(size=..., mode='nearest') semantics, in integer
    arithmetic) — the odd latent sizes go 98→49→25→13 and back."""
    n, h, w, c = x.shape
    if (th, tw) == (2 * h, 2 * w):
        return upsample_nearest_2x(x)
    yi = torch.arange(th, device=x.device) * h // th
    xi = torch.arange(tw, device=x.device) * w // tw
    return x.index_select(1, yi).index_select(2, xi)


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)
