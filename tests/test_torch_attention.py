"""The port's flash attention (plain version, as the wrapper runs it on CPU
tensors) and its dispatcher against the JAX package: the Pallas kernels
``flash_attention_nt`` / ``flash_attention_nt_bank`` in interpret mode,
called without ``global_shift``, and the numpy oracle of tests/test_ops.py.

Tolerance: atol 2e-5, the one tests/test_ops.py holds the Pallas kernels to
against the same oracle (fp32 on both sides; only summation order differs).
"""

import math

import numpy as np
import pytest
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from mimo_tpu.ops.flash_transposed import (flash_attention_nt,
                                           flash_attention_nt_bank)
from mimo_tpu_torch.ops import attention as A
from mimo_tpu_torch.ops import flash_attention as FA
from tests.test_torch_helpers import nn, set_fp32_matmuls, tt
from tests.test_ops import _sdpa_oracle

set_fp32_matmuls()

ATOL = 2e-5

# the ragged shapes of tests/test_ops.py (b, sq, sk, heads, d, bq, bk)
SELF_CASES = [
    (2, 40, 72, 2, 8, 16, 32),     # ragged both
    (1, 64, 64, 4, 8, 32, 64),     # exact blocks
    (1, 24, 128, 1, 16, 24, 128),  # single blocks
    (2, 48, 7, 8, 16, 16, 8),      # SAM / SAM2 decoder i2t: 7 keys, d=16
    (1, 40, 72, 8, 72, 16, 32),    # Hiera-L stage-3 global blocks: d=72
]
# (b, sq, sk1, sk2, heads, d, bq, bk)
BANK_CASES = [
    (2, 40, 72, 40, 2, 8, 16, 32),   # both segments ragged
    (1, 64, 64, 64, 4, 8, 32, 64),   # exact blocks
    (2, 32, 32, 96, 2, 8, 16, 32),   # bank longer than self
]


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("b,sq,sk,heads,d,bq,bk", SELF_CASES)
def test_flash_nt_plain_matches_pallas_and_oracle(b, sq, sk, heads, d, bq,
                                                   bk):
    rng = np.random.default_rng(1)
    q, k, v = (_rand(rng, b, s, heads * d) for s in (sq, sk, sk))
    got = nn(FA.flash_attention_nt(tt(q), tt(k), tt(v), heads))
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(flash_attention_nt(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads,
            sm_scale=1.0 / math.sqrt(d), block_q=bq, block_k=bk))
    np.testing.assert_allclose(got, ref, atol=ATOL)
    np.testing.assert_allclose(got, _sdpa_oracle(q, k, v, heads), atol=ATOL)


@pytest.mark.parametrize("b,sq,sk1,sk2,heads,d,bq,bk", BANK_CASES)
def test_flash_nt_bank_plain_matches_pallas_and_oracle(b, sq, sk1, sk2, heads,
                                                        d, bq, bk):
    rng = np.random.default_rng(2)
    q, k, v = (_rand(rng, b, s, heads * d) for s in (sq, sk1, sk1))
    kb, vb = _rand(rng, 1, sk2, heads * d), _rand(rng, 1, sk2, heads * d)
    got = nn(FA.flash_attention_nt_bank(tt(q), tt(k), tt(v), tt(kb), tt(vb),
                                        heads))
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(flash_attention_nt_bank(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kb),
            jnp.asarray(vb), heads, sm_scale=1.0 / math.sqrt(d),
            block_q=bq, block_k=bk))
    kcat = np.concatenate([k, np.broadcast_to(kb, (b,) + kb.shape[1:])], 1)
    vcat = np.concatenate([v, np.broadcast_to(vb, (b,) + vb.shape[1:])], 1)
    np.testing.assert_allclose(got, ref, atol=ATOL)
    np.testing.assert_allclose(got, _sdpa_oracle(q, kcat, vcat, heads),
                               atol=ATOL)


@pytest.mark.parametrize("banked", [False, True])
def test_dispatch_routes_long_queries_to_flash(banked, monkeypatch):
    """Sq >= 1024 with d % 8 == 0 goes through the flash wrapper (its
    plain version on CPU) and agrees with the Pallas kernel; the ragged key
    and query edges stay in."""
    rng = np.random.default_rng(3)
    b, sq, sk, sk2, heads, d = 1, 1030, 72, 40, 2, 8
    q, k, v = (_rand(rng, b, s, heads * d) for s in (sq, sk, sk))
    kb, vb = _rand(rng, 1, sk2, heads * d), _rand(rng, 1, sk2, heads * d)
    name = "flash_attention_nt_bank" if banked else "flash_attention_nt"
    calls = []
    real = getattr(A, name)
    monkeypatch.setattr(A, name,
                        lambda *a: calls.append(1) or real(*a))
    with pltpu.force_tpu_interpret_mode():
        if banked:
            got = A.dispatch_sdpa_banked(tt(q), tt(k), tt(v), tt(kb), tt(vb),
                                         heads)
            ref = flash_attention_nt_bank(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                jnp.asarray(kb), jnp.asarray(vb), heads,
                sm_scale=1.0 / math.sqrt(d), block_q=512, block_k=32)
        else:
            got = A.dispatch_sdpa(tt(q), tt(k), tt(v), heads)
            ref = flash_attention_nt(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads,
                sm_scale=1.0 / math.sqrt(d), block_q=512, block_k=32)
    assert calls == [1]
    np.testing.assert_allclose(nn(got), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("sq,d,flash", [
    (1024, 40, True), (1568, 80, True), (6272, 160, True),
    (1023, 40, False),                 # short: UNet level 2 / mid, CLIP
    (6272, 512, False),                # VAE mid block, single head
    (2048, 20, False),                 # d not a multiple of 8
])
def test_dispatch_rule_matches_jax(sq, d, flash):
    """The applicability rule of mimo_tpu/ops/attention.py."""
    from mimo_tpu.ops import attention as JA
    assert A.FLASH_MIN_Q == JA.FLASH_MIN_Q
    assert A.flash_applies(sq, d) is flash


def test_dispatch_short_sequence_matches_jax_xla_path():
    """Short sequences take plain attention, where the JAX package used
    jax.nn.dot_product_attention (tests/test_ops.py manual oracle)."""
    from mimo_tpu.ops import attention as JA
    rng = np.random.default_rng(4)
    b, sq, sk, heads, d = 2, 16, 24, 4, 8
    q, k, v = (_rand(rng, b, s, heads * d) for s in (sq, sk, sk))
    got = nn(A.dispatch_sdpa(tt(q), tt(k), tt(v), heads))
    ref = np.asarray(JA.dispatch_sdpa(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), heads))
    np.testing.assert_allclose(got, ref, atol=ATOL)
    np.testing.assert_allclose(got, _sdpa_oracle(q, k, v, heads), atol=ATOL)


def test_plain_query_chunking_matches_unchunked():
    """attention_plain's query chunks (which bound the logits at full
    size) do not change the result beyond fp32 rounding."""
    rng = np.random.default_rng(5)
    q, k, v = (tt(_rand(rng, 2, s, 16)) for s in (50, 30, 30))
    full = FA.attention_plain(q, k, v, 2, q_chunk=1024)
    chunked = FA.attention_plain(q, k, v, 2, q_chunk=7)
    # fp32 products of other shapes may round differently in the last bit
    np.testing.assert_allclose(nn(full), nn(chunked), atol=1e-6)


def test_wrappers_count_only_kernel_launches():
    """CPU tensors take the plain version, which is not a launch."""
    rng = np.random.default_rng(6)
    q, k, v = (tt(_rand(rng, 1, 8, 16)) for _ in range(3))
    before = (FA.flash_attention_nt.launches,
              FA.flash_attention_nt_bank.launches)
    FA.flash_attention_nt(q, k, v, 2)
    FA.flash_attention_nt_bank(q, k, v, k[:1], v[:1], 2)
    assert (FA.flash_attention_nt.launches,
            FA.flash_attention_nt_bank.launches) == before
