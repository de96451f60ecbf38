"""The flash kernel's schedule (csrc/flash_attention.cu), emulated tile by
tile on the CPU in fp32, and its shared-memory plan.

The emulation follows the kernel: key tiles of kBK keys (read out of the
kernel source) over [self ‖ bank], zero-filled past each segment's end;
the Q.K^T contraction zero-padded to ceil(d/16)·16; the key mask applied
only on a segment's last tile and only when it is ragged; the running max
taken over raw logits; p = exp2(s·c − m·c) with c = log2(e)/sqrt(d); the
row sum over the fp32 p; P rounded to bf16 only as the operand of P·V.

Tolerances: with P kept in fp32 the schedule is exact attention, held to
``attention_plain`` and to the Pallas kernels of
``mimo_tpu/ops/flash_transposed.py`` in interpret mode at atol 2e-5 (as
tests/test_torch_attention.py holds them: fp32 on both sides, only the
summation order differs). With P rounded to bf16 each weight moves by at
most 2^-9 of itself, so the output moves by at most 2^-9·max|v|; it is held
to ``attention_plain`` at twice that.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from mimo_tpu.ops.flash_transposed import (flash_attention_nt,
                                           flash_attention_nt_bank)
from mimo_tpu_torch.ops import flash_attention as FA
from tests.test_torch_helpers import nn, set_fp32_matmuls, tt

set_fp32_matmuls()

# the kernel's tile plan lives in the flash body it shares with the
# ablation builds
SRC = "".join((Path(FA.__file__).parents[1] / "csrc" / name).read_text()
              for name in ("flash_body.cuh", "flash_attention.cu"))
SMEM_LIMIT = 232448          # dynamic shared memory of one H100 block
# every head dim the dispatch sends to the kernel (ops/attention.py)
KERNEL_DIMS = list(range(8, 161, 8))


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC)[1])


def block_k(d: int) -> int:
    """Keys a K/V tile, as FlashTile<D>::kBK in the kernel source."""
    limit, small_d, large_d = map(int, re.search(
        r"kBK = D <= (\d+) \? (\d+) : (\d+);", SRC).groups())
    return small_d if d <= limit else large_d


def test_ring_limits():
    """The ring is planned for one H100 block's 227 KB, and a K/V tile is a
    width wgmma takes. (FlashTile<D>'s static_assert checks the exact plan,
    >= 2 stages within the limit, for every width at build time.)"""
    assert _const("kSmemLimit") == SMEM_LIMIT
    assert {block_k(d) for d in KERNEL_DIMS} == {64, 128}
    # the widest tile of each kBK still fits the Q tile and two K/V stages
    # of 64-column (128-byte) boxes
    for d in (max(d for d in KERNEL_DIMS if block_k(d) == bk)
              for bk in (64, 128)):
        boxes = -(-d // _const("kBoxCols"))
        q_bytes = boxes * _const("kBlockQ") * 128
        assert q_bytes + 2 * 2 * boxes * block_k(d) * 128 <= SMEM_LIMIT


def _heads_first(x, heads):
    b, s, inner = x.shape
    return x.reshape(b, s, heads, inner // heads).transpose(1, 2)


def kernel_schedule(q, k, v, heads, kb=None, vb=None, round_p=True):
    """What flash_fwd_kernel computes, tile by tile, in fp32. Returns the
    (B, Sq, H·d) output and the number of tiles that were masked."""
    b, sq, inner = q.shape
    d = inner // heads
    dp = -(-d // 16) * 16
    bk = block_k(d)
    c = FA.LOG2E / math.sqrt(d)
    qh = torch.nn.functional.pad(_heads_first(q, heads), (0, dp - d))
    segments = [(k, v)]
    if kb is not None:
        segments.append((kb.expand(b, -1, -1), vb.expand(b, -1, -1)))
    m = torch.full((b, heads, sq, 1), -math.inf)
    l = torch.zeros((b, heads, sq, 1))
    o = torch.zeros((b, heads, sq, d))
    masked = 0
    for ks, vs in segments:
        kh, vh = _heads_first(ks, heads), _heads_first(vs, heads)
        n = kh.shape[2]
        for k0 in range(0, n, bk):
            valid = min(bk, n - k0)
            # the TMA box: rows past the segment and columns past d are 0
            kt = torch.zeros((b, heads, bk, dp))
            vt = torch.zeros((b, heads, bk, d))
            kt[:, :, :valid, :d] = kh[:, :, k0:k0 + valid]
            vt[:, :, :valid] = vh[:, :, k0:k0 + valid]
            s = qh @ kt.transpose(-1, -2)
            if valid < bk:                  # only a segment's ragged last tile
                s[..., valid:] = -math.inf
                masked += 1
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp2((m - m_new) * c)
            p = torch.exp2(s * c - m_new * c)
            l = l * alpha + p.sum(-1, keepdim=True)
            pv = p.bfloat16().float() if round_p else p
            o = o * alpha + pv @ vt
            m = m_new
    out = (o / l).transpose(1, 2).reshape(b, sq, inner)
    return out, masked


SQ, SK1, SK2, HEADS, BATCH = 130, 200, 77, 2, 2


def _inputs(d, banked, seed):
    rng = np.random.default_rng(seed)
    inner = HEADS * d
    q, k, v = (rng.standard_normal((BATCH, s, inner)).astype(np.float32)
               for s in (SQ, SK1, SK1))
    bank = tuple(rng.standard_normal((1, SK2, inner)).astype(np.float32)
                 for _ in range(2)) if banked else ()
    return q, k, v, bank


@pytest.mark.parametrize("banked", [False, True])
@pytest.mark.parametrize("d", [8, 40, 80, 160])
def test_schedule_matches_plain_and_pallas(d, banked):
    q, k, v, bank = _inputs(d, banked, seed=d + banked)
    args = [tt(x) for x in (q, k, v)]
    bank_t = [tt(x) for x in bank]
    exact, masked = kernel_schedule(*args, HEADS, *bank_t, round_p=False)
    # Sk1 = 200 and Sk2 = 77 are ragged at both tile widths: one masked
    # tile a segment
    assert masked == 1 + banked
    plain = FA.attention_plain(*args, HEADS, *bank_t)
    np.testing.assert_allclose(nn(exact), nn(plain), atol=2e-5)

    with pltpu.force_tpu_interpret_mode():
        if banked:
            ref = flash_attention_nt_bank(
                *(jnp.asarray(x) for x in (q, k, v, *bank)), HEADS,
                sm_scale=1.0 / math.sqrt(d), block_q=32, block_k=64)
        else:
            ref = flash_attention_nt(
                *(jnp.asarray(x) for x in (q, k, v)), HEADS,
                sm_scale=1.0 / math.sqrt(d), block_q=32, block_k=64)
    np.testing.assert_allclose(nn(exact), np.asarray(ref), atol=2e-5)

    rounded, _ = kernel_schedule(*args, HEADS, *bank_t, round_p=True)
    vmax = max(float(np.abs(x).max()) for x in (v, *bank[1:]))
    np.testing.assert_allclose(nn(rounded), nn(plain), rtol=0,
                               atol=2 * 2.0 ** -9 * vmax)
    assert not np.array_equal(nn(rounded), nn(exact))


@pytest.mark.parametrize("d", KERNEL_DIMS)
def test_schedule_every_width(d):
    """At every width the dispatch sends, the kernel's tile width and the
    contraction padded to ceil(d/16)·16 give exact attention over a ragged
    [self ‖ bank] (fp32 P; the same tolerance as above)."""
    rng = np.random.default_rng(100 + d)
    q, k, v = (tt(rng.standard_normal((1, s, HEADS * d)).astype(np.float32))
               for s in (33, 150, 150))
    kb, vb = (tt(rng.standard_normal((1, 70, HEADS * d)).astype(np.float32))
              for _ in range(2))
    got, masked = kernel_schedule(q, k, v, HEADS, kb, vb, round_p=False)
    assert masked == 2
    np.testing.assert_allclose(nn(got), nn(FA.attention_plain(
        q, k, v, HEADS, kb, vb)), atol=2e-5)


def test_schedule_masks_nothing_on_whole_tiles():
    """Segments that end on a tile edge take no mask at all."""
    d = 40
    bk = block_k(d)
    rng = np.random.default_rng(11)
    q = tt(rng.standard_normal((1, 70, HEADS * d)).astype(np.float32))
    k, v = (tt(rng.standard_normal((1, 2 * bk, HEADS * d)).astype(np.float32))
            for _ in range(2))
    kb, vb = (tt(rng.standard_normal((1, bk, HEADS * d)).astype(np.float32))
              for _ in range(2))
    got, masked = kernel_schedule(q, k, v, HEADS, kb, vb, round_p=False)
    assert masked == 0
    np.testing.assert_allclose(nn(got), nn(FA.attention_plain(
        q, k, v, HEADS, kb, vb)), atol=2e-5)
