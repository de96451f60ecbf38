"""Attention dispatch: a flash kernel for long sequences, plain attention
otherwise.

Counterpart of ``mimo_tpu/ops/attention.py`` (``dispatch_sdpa`` and
``dispatch_sdpa_banked``) with its branches: at Sq >= 1024, d % 8 == 0 and
d <= 160 go to ``flash_attention_nt`` (the JAX package's transposed
kernels), and every other width to JAX's ``flash_sdpa``, whose counterpart
is ``flash_attention_wide`` at d % 64 == 0, 160 < d <= 512 (the VAE's
single-head d = 512 mid block). A width neither kernel takes (no path has
one) raises on CUDA. Plain attention at the UNet's top level would
materialise 24·8·6272·12544 logits per call (30 GB in bf16); the flash
kernels keep them on chip. Shorter sequences (CLIP S=257, UNet level 2 and
mid) take plain attention, where the JAX package used XLA's
``jax.nn.dot_product_attention``.

The TPU block pickers and ``batch=(start, count)`` windows are gone: the
CFG halves ``q[:h]`` and ``q[h:]`` are free views here.
"""

from __future__ import annotations

import torch

from mimo_tpu_torch.ops.flash_attention import (attention_plain,
                                                flash_attention_nt,
                                                flash_attention_nt_bank,
                                                flash_attention_wide,
                                                wide_width)

FLASH_MIN_Q = 1024


def flash_applies(sq: int, d: int) -> bool:
    """``flash_attention_nt`` takes it."""
    return sq >= FLASH_MIN_Q and d % 8 == 0 and d <= 160


def sdpa_route(sq: int, d: int, cuda: bool) -> str:
    """What ``dispatch_sdpa`` calls at Sq queries of head width d: "flash"
    (``flash_attention_nt``), "wide" (``flash_attention_wide``) or "plain"
    (``attention_plain``). On CUDA a shape the JAX package sends to
    ``flash_sdpa`` at a width no kernel here takes raises; on the CPU it is
    plain attention, as every wrapper's there."""
    if flash_applies(sq, d):
        return "flash"
    if sq < FLASH_MIN_Q:
        return "plain"
    if wide_width(d):
        return "wide"
    if cuda:
        raise ValueError(f"attention at Sq={sq}, d={d}: no flash kernel "
                         f"takes d={d} (flash_attention_nt: d % 8 == 0, "
                         f"d <= 160; flash_attention_wide: d % 64 == 0, "
                         f"160 < d <= 512)")
    return "plain"


def dispatch_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  heads: int) -> torch.Tensor:
    """(B, Sq, H·d) x (B, Sk, H·d) -> (B, Sq, H·d), scale 1/sqrt(d)."""
    route = sdpa_route(q.shape[1], q.shape[2] // heads, q.is_cuda)
    if route == "flash":
        return flash_attention_nt(q, k, v, heads)
    if route == "wide":
        return flash_attention_wide(q, k, v, heads)
    return attention_plain(q, k, v, heads)


def dispatch_sdpa_banked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kb: torch.Tensor, vb: torch.Tensor,
                         heads: int) -> torch.Tensor:
    """Attention over [self (B, Sk1) ‖ bank (1, Sk2)] keys; off the banked
    flash kernel the bank is concatenated and the keys dispatched as
    ``dispatch_sdpa``'s."""
    if flash_applies(q.shape[1], q.shape[2] // heads):
        return flash_attention_nt_bank(q, k, v, kb, vb, heads)
    b = q.shape[0]
    return dispatch_sdpa(q, torch.cat([k, kb.expand(b, -1, -1)], dim=1),
                         torch.cat([v, vb.expand(b, -1, -1)], dim=1), heads)
