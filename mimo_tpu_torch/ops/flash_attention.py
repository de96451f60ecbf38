"""Flash attention over the natural (B, S, H*d) layout: the CUDA kernels in
``csrc/flash_attention.cu`` and ``csrc/flash_wide.cu``, and their plain
PyTorch version.

Counterpart of ``mimo_tpu/ops/flash_transposed.py``: ``flash_attention_nt``
(self-attention) and ``flash_attention_nt_bank`` (keys ``[self (B, Sk1) ‖
bank (1, Sk2)]``, the bank shared by every batch row and never
concatenated). The names are kept so a reader can find the counterparts;
the port has no transposed compute and no block arguments. And of
``mimo_tpu/ops/attention.py::flash_sdpa`` (JAX's bundled Pallas flash
kernel, which the JAX package takes for wide heads): ``flash_attention_wide``
at d % 64 == 0, 160 < d <= 512 (the VAE's single-head d = 512 mid block).

Each wrapper takes the plain version for CPU tensors only. For a CUDA tensor
it launches the kernel or raises. ``<wrapper>.launches`` counts kernel
launches; ``<wrapper>.widths`` counts them by head width.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Optional

import torch

from mimo_tpu_torch.ops import _build

LOG2E = 1.4426950408889634


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    heads: int, kb: Optional[torch.Tensor] = None,
                    vb: Optional[torch.Tensor] = None,
                    q_chunk: int = 1024) -> torch.Tensor:
    """Exact multi-head attention, scale 1/sqrt(d), logits and softmax in
    fp32, result in q's dtype. q: (B, Sq, H*d); k/v: (B, Sk, H*d); optional
    kb/vb: (1, Sk2, H*d) appended to every row's keys. Queries run in chunks
    of ``q_chunk`` so the logits stay bounded."""
    b, sq, inner = q.shape
    d = inner // heads
    if kb is not None:
        k = torch.cat([k, kb.expand(b, -1, -1)], dim=1)
        v = torch.cat([v, vb.expand(b, -1, -1)], dim=1)
    sk = k.shape[1]
    kh = k.reshape(b, sk, heads, d).transpose(1, 2).float()
    vh = v.reshape(b, sk, heads, d).transpose(1, 2).float()
    out = torch.empty_like(q)
    scale = 1.0 / math.sqrt(d)
    for s0 in range(0, sq, q_chunk):
        qh = q[:, s0:s0 + q_chunk].reshape(b, -1, heads, d).transpose(1, 2)
        logits = torch.matmul(qh.float(), kh.transpose(-1, -2)) * scale
        o = torch.matmul(torch.softmax(logits, dim=-1), vh)
        out[:, s0:s0 + q_chunk] = o.transpose(1, 2).reshape(b, -1, inner)
    return out


def wide_width(d: int) -> bool:
    """The head widths ``flash_attention_wide``'s kernel takes."""
    return d % 64 == 0 and 160 < d <= 512


def _check_operand(name: str, x: torch.Tensor, batch: int) -> None:
    if not x.is_cuda or x.dtype != torch.bfloat16 or x.dim() != 3:
        raise ValueError(f"flash kernel: {name} must be a 3-D bfloat16 CUDA "
                         f"tensor, got {x.dtype} {tuple(x.shape)} "
                         f"on {x.device}")
    if x.stride(2) != 1 or x.stride(0) % 8 or x.stride(1) % 8 \
            or x.data_ptr() % 16:
        raise ValueError(f"flash kernel: {name} needs a contiguous last dim, "
                         f"batch/sequence strides divisible by 8 and a "
                         f"16-byte aligned start (strides {x.stride()})")
    if x.shape[0] != batch:
        raise ValueError(f"flash kernel: {name} has batch {x.shape[0]}, "
                         f"expected {batch}")


def _check_qkv(q, k, v, heads: int) -> int:
    """Raise unless q/k/v suit a flash kernel; returns the head dim."""
    b, _, inner = q.shape
    if inner % heads:
        raise ValueError(f"flash kernel: width {inner} not divisible by "
                         f"{heads} heads")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, x, b)
    if k.shape[2] != inner or v.shape[2] != inner or k.shape[1] != v.shape[1] \
            or k.shape[1] < 1:
        raise ValueError(f"flash kernel: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    return inner // heads


def _flash_cuda(q, k, v, kb, vb, heads: int) -> torch.Tensor:
    d = _check_qkv(q, k, v, heads)
    if d % 8 or d > 160:
        raise ValueError(f"flash kernel: head dim {d} must be a multiple of "
                         f"8 and at most 160")
    b, sq, inner = q.shape
    sk2 = 0
    if kb is not None:
        for name, x in (("kb", kb), ("vb", vb)):
            _check_operand(name, x, 1)
        if kb.shape != vb.shape or kb.shape[2] != inner:
            raise ValueError(f"flash kernel: bank {tuple(kb.shape)} / "
                             f"{tuple(vb.shape)} does not match q")
        sk2 = kb.shape[1]
    out = torch.empty((b, sq, inner), dtype=q.dtype, device=q.device)
    lib = _build.load_library()
    kb_ = kb if kb is not None else k
    vb_ = vb if vb is not None else v
    err = lib.mimo_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kb_.data_ptr(),
        vb_.data_ptr(), out.data_ptr(), b, heads, d, sq, k.shape[1], sk2,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), 0, kb_.stride(1), 0, vb_.stride(1),
        out.stride(0), out.stride(1), LOG2E / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention_nt")
    return out


def flash_attention_nt(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       heads: int) -> torch.Tensor:
    """Self-attention, q: (B, Sq, H*d), k/v: (B, Sk, H*d) -> (B, Sq, H*d).
    Any Sq and Sk; d % 8 == 0 and d <= 160 on the kernel."""
    if not q.is_cuda:
        return attention_plain(q, k, v, heads)
    out = _flash_cuda(q, k, v, None, None, heads)
    flash_attention_nt.launches += 1
    flash_attention_nt.widths[q.shape[2] // heads] += 1
    return out


def flash_attention_nt_bank(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, kb: torch.Tensor,
                            vb: torch.Tensor, heads: int) -> torch.Tensor:
    """Attention over keys [self (B, Sk1) ‖ bank (1, Sk2)]; the bank is read
    in place by every batch row (batch stride 0), never concatenated."""
    if not q.is_cuda:
        return attention_plain(q, k, v, heads, kb, vb)
    out = _flash_cuda(q, k, v, kb, vb, heads)
    flash_attention_nt_bank.launches += 1
    flash_attention_nt_bank.widths[q.shape[2] // heads] += 1
    return out


def _wide_cuda(q, k, v, heads: int) -> torch.Tensor:
    d = _check_qkv(q, k, v, heads)
    if not wide_width(d):
        raise ValueError(f"wide flash kernel: head dim {d} must be a "
                         f"multiple of 64 in (160, 512]")
    b, sq, inner = q.shape
    out = torch.empty((b, sq, inner), dtype=q.dtype, device=q.device)
    err = _build.load_library().mimo_flash_wide_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, heads,
        d, sq, k.shape[1], q.stride(0), q.stride(1), k.stride(0),
        k.stride(1), v.stride(0), v.stride(1), out.stride(0), out.stride(1),
        LOG2E / math.sqrt(d), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention_wide")
    return out


def flash_attention_wide(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         heads: int) -> torch.Tensor:
    """Self-attention at wide heads, q: (B, Sq, H*d), k/v: (B, Sk, H*d) ->
    (B, Sq, H*d). Any Sq and Sk; d % 64 == 0 and 160 < d <= 512 on the
    kernel, which never falls back to the plain version."""
    if not q.is_cuda:
        return attention_plain(q, k, v, heads)
    out = _wide_cuda(q, k, v, heads)
    flash_attention_wide.launches += 1
    flash_attention_wide.widths[q.shape[2] // heads] += 1
    return out


FLASH_WRAPPERS = (flash_attention_nt, flash_attention_nt_bank,
                  flash_attention_wide)
for _fn in FLASH_WRAPPERS:
    _fn.launches = 0
    _fn.widths = Counter()
