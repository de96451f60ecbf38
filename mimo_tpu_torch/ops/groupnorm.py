"""Fused GroupNorm (+ per-row add, + SiLU): the CUDA kernel in
``csrc/groupnorm.cu`` and its plain PyTorch version.

Counterpart of ``mimo_tpu/ops/groupnorm.py`` (``group_norm_fused`` and its
three Pallas variants, which become one split-S design here). Statistics are
fp32 per (batch row, group) over every non-channel axis, with
var = E[x²] − E[x]²; the affine is fp32; SiLU runs in fp32 before the single
cast back; the optional (N, C) ``row_add`` (the resnet time-embedding add)
joins x before the statistics.

``group_norm_fused`` takes the plain version for CPU tensors only. For a
CUDA tensor it launches the kernel or raises. ``group_norm_fused.launches``
counts kernel launches.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from mimo_tpu_torch.ops import _build

_THREADS = 256
_TARGET_BLOCKS = 4 * 132      # about four stats blocks per H100 SM
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def group_norm_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     groups: int, eps: float, fuse_silu: bool = False,
                     row_add: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GroupNorm over the trailing channel axis of an (N, ..., C) tensor."""
    n, c = x.shape[0], x.shape[-1]
    xf = x.float()
    if row_add is not None:
        xf = xf + row_add.float().reshape(n, *([1] * (x.dim() - 2)), c)
    xg = xf.reshape(n, -1, groups, c // groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = xg.square().mean(dim=(1, 3), keepdim=True) - mean.square()
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    y = y * scale.float() + bias.float()
    if fuse_silu:
        y = F.silu(y)
    return y.to(x.dtype)


def stats_chunking(n: int, s: int, c: int) -> Tuple[int, int]:
    """(S-chunks, rows per chunk) of the stats pass: enough blocks to fill
    the card, each chunk covering at least one row per thread row."""
    cvecs = c // 8
    tx = min(cvecs, _THREADS)
    ty = _THREADS // tx
    ctiles = -(-cvecs // tx)
    nchunk = max(1, min(-(-s // ty), -(-_TARGET_BLOCKS // (n * ctiles))))
    rows = -(-s // nchunk)
    return -(-s // rows), rows


def _group_norm_cuda(x, scale, bias, groups, eps, fuse_silu, row_add):
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"group norm kernel takes float32 or bfloat16, got "
                         f"{x.dtype}")
    n, c = x.shape[0], x.shape[-1]
    if c % 8 or c % groups:
        raise ValueError(f"group norm kernel needs C % 8 == 0 and "
                         f"C % groups == 0 (C={c}, groups={groups})")
    xc = x.contiguous()
    s = xc.numel() // (n * c)
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    scale_f = scale.to(**f32).contiguous()
    bias_f = bias.to(**f32).contiguous()
    radd = None
    if row_add is not None:
        radd = row_add.reshape(n, c).to(**f32).contiguous()
    nchunk, rows = stats_chunking(n, s, c)
    part = torch.empty((n, nchunk, 2, c), **f32)
    coef = torch.empty((n, 2, c), **f32)
    y = torch.empty_like(xc)
    lib = _build.load_library()
    err = lib.mimo_group_norm_fwd(
        xc.data_ptr(), radd.data_ptr() if radd is not None else None,
        scale_f.data_ptr(), bias_f.data_ptr(), y.data_ptr(), part.data_ptr(),
        coef.data_ptr(), _DTYPE_CODE[x.dtype], n, s, c, groups, nchunk, rows,
        float(eps), int(fuse_silu),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "group_norm_fused")
    return y


def group_norm_fused(x: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, groups: int, eps: float,
                     fuse_silu: bool = False,
                     row_add: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GN(+SiLU) of x + row_add[:, None, ..., :] over an (N, ..., C)
    tensor, same shape and dtype out."""
    if not x.is_cuda:
        return group_norm_plain(x, scale, bias, groups, eps, fuse_silu,
                                row_add)
    y = _group_norm_cuda(x, scale, bias, groups, eps, fuse_silu, row_add)
    group_norm_fused.launches += 1
    return y


group_norm_fused.launches = 0
