"""Attention dispatch: the flash kernel for long sequences, plain attention
otherwise.

Counterpart of ``mimo_tpu/ops/attention.py`` (``dispatch_sdpa`` and
``dispatch_sdpa_banked``) with the same applicability rule: Sq >= 1024,
d % 8 == 0 and d <= 160 go to the kernel. Plain attention at the UNet's top
level would materialise 24·8·6272·12544 logits per call (30 GB in bf16);
the flash kernel keeps them on chip. Every other shape (CLIP S=257, UNet
level 2 and mid, the VAE's single-head d=512 mid block) takes plain
attention, where the JAX package used XLA or a library flash kernel.

The TPU block pickers and ``batch=(start, count)`` windows are gone: the
CFG halves ``q[:h]`` and ``q[h:]`` are free views here.
"""

from __future__ import annotations

import torch

from mimo_tpu_torch.ops.flash_attention import (attention_plain,
                                                flash_attention_nt,
                                                flash_attention_nt_bank)

FLASH_MIN_Q = 1024


def flash_applies(sq: int, d: int) -> bool:
    return sq >= FLASH_MIN_Q and d % 8 == 0 and d <= 160


def dispatch_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  heads: int) -> torch.Tensor:
    """(B, Sq, H·d) x (B, Sk, H·d) -> (B, Sq, H·d), scale 1/sqrt(d)."""
    if flash_applies(q.shape[1], q.shape[2] // heads):
        return flash_attention_nt(q, k, v, heads)
    return attention_plain(q, k, v, heads)


def dispatch_sdpa_banked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kb: torch.Tensor, vb: torch.Tensor,
                         heads: int) -> torch.Tensor:
    """Attention over [self (B, Sk1) ‖ bank (1, Sk2)] keys."""
    if flash_applies(q.shape[1], q.shape[2] // heads):
        return flash_attention_nt_bank(q, k, v, kb, vb, heads)
    return attention_plain(q, k, v, heads, kb, vb)
