"""The Hiera block's elementwise chains as bf16 row passes: the kernels of
``csrc/hiera_rows.cu`` and the plain PyTorch version of each.

``decomp/hiera.py::hiera_apply`` calls them between its products (cuBLAS,
bias-free): ``bias_gelu`` after fc1, ``bias_residual`` after fc2 and after
proj_attn, the latter reading a windowed block's product through the
inverse window partition (``Unpartition``). Its LayerNorms go to
``ffn.ln_rows``.

Numerics are the eager chain's, equal in every bit: the bias added and
rounded to the activation dtype, then exact (erf) GELU in fp32 rounded
again, or the residual added and rounded.

Each wrapper takes its plain version for CPU tensors only, counted in
``<wrapper>.plain_calls``; for a CUDA tensor it launches the kernel
(counted in ``<wrapper>.launches``) or raises.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from mimo_tpu_torch.ops import _build
from mimo_tpu_torch.ops.ffn import _vec

# vectors (8 bf16) a call may hold: the kernels index them in 32 bits
MAX_VECTORS = 2 ** 31 - 1


class Unpartition(NamedTuple):
    """The inverse of ``decomp/vit.py::_window_partition``: the rows of a
    windowed (b · windows, ws², C) tensor, read as the (b, hgt · wid, C)
    grid, its bottom / right padding (the grid ``padded`` = (hp, wp))
    cropped."""

    hgt: int
    wid: int
    ws: int
    padded: Tuple[int, int]


def unpartition_rows(b: int, un: Unpartition,
                     device=None) -> torch.Tensor:
    """The windowed row that each output row of ``un`` reads, (b · hgt ·
    wid,) int64: the map ``hiera_bias_res_kernel<true>`` computes."""
    hgt, wid, ws, (hp, wp) = un
    r = torch.arange(b * hgt * wid, device=device)
    image, rem = r // (hgt * wid), r % (hgt * wid)
    h, w = rem // wid, rem % wid
    window = (image * (hp // ws) + h // ws) * (wp // ws) + w // ws
    return (window * ws + h % ws) * ws + w % ws


# ---------------------------------------------------------------------------
# plain versions (the eager chain)
# ---------------------------------------------------------------------------


def bias_gelu_plain(p: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    h = p + bias.to(p.dtype)
    return F.gelu(h.float(), approximate="none").to(h.dtype)


def bias_residual_plain(p: torch.Tensor, bias: torch.Tensor,
                        res: torch.Tensor,
                        un: Optional[Unpartition] = None) -> torch.Tensor:
    a = p + bias.to(p.dtype)
    if un is not None:
        a = a.reshape(-1, a.shape[-1])[
            unpartition_rows(res.shape[0], un, a.device)]
    return res + a.reshape(res.shape)


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------


def _operand(t: torch.Tensor, what: str) -> torch.Tensor:
    """t as a contiguous, 16-byte aligned bf16 CUDA tensor."""
    if not t.is_cuda or t.dtype != torch.bfloat16:
        raise ValueError(f"hiera rows kernel: {what} must be a bfloat16 CUDA "
                         f"tensor, got {t.dtype} on {t.device}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        t = t.clone(memory_format=torch.contiguous_format)
    return t


def _shape(p: torch.Tensor, rows: int) -> Tuple[int, int]:
    k = p.shape[-1]
    if k % 8 or rows < 1 or rows * (k // 8) > MAX_VECTORS:
        raise ValueError(f"hiera rows kernel: needs rows, K % 8 == 0 and at "
                         f"most {MAX_VECTORS} vectors, got {rows} x {k}")
    return rows, k


def bias_gelu_cuda(p: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """One launch of ``hiera_bias_gelu_kernel`` on a bf16 CUDA p (..., K)
    into a new tensor of p's shape; counts nothing."""
    p2 = _operand(p, "p")
    rows, k = _shape(p2, p2.numel() // p2.shape[-1])
    dev = p2.device
    y = torch.empty_like(p2)
    err = _build.load_library().mimo_hiera_bias_gelu(
        p2.data_ptr(), _vec(bias, k, dev).data_ptr(), y.data_ptr(), rows, k,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "hiera_bias_gelu")
    return y


def bias_residual_cuda(p: torch.Tensor, bias: torch.Tensor,
                       res: torch.Tensor,
                       un: Optional[Unpartition] = None) -> torch.Tensor:
    """One launch of ``hiera_bias_res_kernel`` on bf16 CUDA tensors into a
    new tensor of res's shape (b, hgt · wid, K) with ``un``; counts
    nothing."""
    p2, res2 = _operand(p, "p"), _operand(res, "res")
    rows, k = _shape(p2, res2.numel() // res2.shape[-1])
    if res2.shape[-1] != k:
        raise ValueError(f"hiera rows kernel: residual {tuple(res.shape)} "
                         f"against a product of {k} columns")
    geometry = (0, 0, 0, 0, 0)
    if un is None:
        if p2.numel() != res2.numel():
            raise ValueError(f"hiera rows kernel: product {tuple(p.shape)} "
                             f"against residual {tuple(res.shape)}")
    else:
        hgt, wid, ws, (hp, wp) = un
        b = res2.shape[0]
        if (res2.dim() != 3 or res2.shape[1] != hgt * wid or hp % ws
                or wp % ws or hgt > hp or wid > wp
                or p2.numel() != b * hp * wp * k):
            raise ValueError(f"hiera rows kernel: windowed product "
                             f"{tuple(p.shape)} does not unpartition as {un} "
                             f"onto {tuple(res.shape)}")
        geometry = (hgt, wid, ws, hp // ws, wp // ws)
    dev = p2.device
    y = torch.empty_like(res2)
    err = _build.load_library().mimo_hiera_bias_res(
        p2.data_ptr(), _vec(bias, k, dev).data_ptr(), res2.data_ptr(),
        y.data_ptr(), rows, k, *geometry,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "hiera_bias_res")
    return y


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def bias_gelu(p: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """gelu(p + bias) over p (..., K): fc1's chain."""
    if not p.is_cuda:
        bias_gelu.plain_calls += 1
        return bias_gelu_plain(p, bias)
    y = bias_gelu_cuda(p, bias)
    bias_gelu.launches += 1
    return y


def bias_residual(p: torch.Tensor, bias: torch.Tensor, res: torch.Tensor,
                  un: Optional[Unpartition] = None) -> torch.Tensor:
    """res + (p + bias), p read through ``un`` where given: fc2's and
    proj_attn's chains. The result has res's shape."""
    if not p.is_cuda:
        bias_residual.plain_calls += 1
        return bias_residual_plain(p, bias, res, un)
    y = bias_residual_cuda(p, bias, res, un)
    bias_residual.launches += 1
    return y


bias_gelu.launches = bias_gelu.plain_calls = 0
bias_residual.launches = bias_residual.plain_calls = 0
