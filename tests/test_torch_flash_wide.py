"""The port's wide-head flash attention (``flash_attention_wide``: its plain
version, as the wrapper runs it on CPU tensors) and the dispatcher's branches
against the JAX package: ``mimo_tpu.ops.attention.flash_sdpa`` (JAX's bundled
Pallas flash kernel) in TPU interpret mode, and the numpy oracle of
tests/test_ops.py.

Tolerance: atol 2e-5, as tests/test_torch_attention.py holds the other flash
kernels (fp32 on both sides; only the summation order differs).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from mimo_tpu.ops import attention as JA
from mimo_tpu_torch.ops import _build
from mimo_tpu_torch.ops import attention as A
from mimo_tpu_torch.ops import flash_attention as FA
from mimo_tpu_torch.tools import time_flash_wide as TW
from tests.test_ops import _sdpa_oracle
from tests.test_torch_helpers import nn, set_fp32_matmuls, tt

set_fp32_matmuls()

ATOL = 2e-5


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# (b, sq, sk, heads, d): the VAE mid block's one head of 512 at ragged
# query and key counts (not multiples of the 128 the JAX kernel pads to, nor
# of the card kernel's 128-row query tiles or 64-key tiles), and two heads;
# 150 / 84: a last query tile of 22 rows (its second warpgroup's rows all
# past Sq) and a last key tile of 20 keys, at one head of 512 and two of
# 192 (3 boxes of columns split 2 / 1 between a tile's two blocks)
@pytest.mark.parametrize("b,sq,sk,heads,d", [
    (1, 200, 136, 1, 512),
    (2, 130, 260, 1, 512),
    (1, 72, 100, 2, 512),
    (1, 150, 84, 1, 512),
    (1, 150, 84, 2, 192),
])
def test_wide_plain_matches_flash_sdpa_and_oracle(b, sq, sk, heads, d):
    rng = np.random.default_rng(7)
    q, k, v = (_rand(rng, b, s, heads * d) for s in (sq, sk, sk))
    got = nn(FA.flash_attention_wide(tt(q), tt(k), tt(v), heads))
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(JA.flash_sdpa(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), heads))
    np.testing.assert_allclose(got, ref, atol=ATOL)
    np.testing.assert_allclose(got, _sdpa_oracle(q, k, v, heads), atol=ATOL)


def _jax_branch(sq: int, d: int) -> str:
    """The branch of mimo_tpu/ops/attention.py::dispatch_sdpa on the TPU:
    the transposed kernel (d % 8 == 0, d <= 160), ``flash_sdpa`` (any other
    width) at Sq >= FLASH_MIN_Q, XLA below."""
    if sq < JA.FLASH_MIN_Q:
        return "xla"
    return "flash_nt" if d % 8 == 0 and d <= 160 else "flash_sdpa"


# (sq, d, the port's route on CUDA; None: raises)
ROUTES = [
    (1024, 40, "flash"), (1568, 80, "flash"), (6272, 160, "flash"),
    (6272, 512, "wide"), (1024, 512, "wide"), (9604, 512, "wide"),
    (2048, 192, "wide"), (2048, 256, "wide"),
    (1023, 512, "plain"), (257, 1024, "plain"), (1023, 40, "plain"),
    (6272, 520, None), (6272, 576, None), (2048, 20, None),
]


@pytest.mark.parametrize("sq,d,route", ROUTES)
def test_route_mirrors_jax_branch(sq, d, route):
    """Each (Sq, d) reaches the port's counterpart of JAX's branch: the
    transposed kernel -> flash_attention_nt, flash_sdpa ->
    flash_attention_wide where its kernel takes d (else a ValueError on
    CUDA, plain attention on the CPU), XLA -> plain attention."""
    assert A.FLASH_MIN_Q == JA.FLASH_MIN_Q
    counterpart = {"flash_nt": {"flash"}, "xla": {"plain"},
                   "flash_sdpa": {"wide", None}}[_jax_branch(sq, d)]
    assert route in counterpart
    if route is None:
        with pytest.raises(ValueError, match=f"d={d}"):
            A.sdpa_route(sq, d, cuda=True)
        assert A.sdpa_route(sq, d, cuda=False) == "plain"
    else:
        assert A.sdpa_route(sq, d, cuda=True) == route
        assert A.sdpa_route(sq, d, cuda=False) == route


@pytest.mark.parametrize("banked", [False, True])
def test_dispatch_routes_wide_heads_to_wide_kernel(banked, monkeypatch):
    """Sq >= 1024 at d = 512 goes through flash_attention_wide (its plain
    version on the CPU), the bank concatenated first as the JAX package
    does; the result is the JAX dispatcher's (XLA on the CPU) and the
    oracle's."""
    rng = np.random.default_rng(8)
    b, sq, sk, sk2, heads, d = 1, 1030, 40, 24, 1, 512
    q, k, v = (_rand(rng, b, s, heads * d) for s in (sq, sk, sk))
    kb, vb = _rand(rng, 1, sk2, heads * d), _rand(rng, 1, sk2, heads * d)
    calls = []
    monkeypatch.setattr(A, "flash_attention_wide",
                        lambda *a: calls.append(1)
                        or FA.flash_attention_wide(*a))
    if banked:
        got = A.dispatch_sdpa_banked(tt(q), tt(k), tt(v), tt(kb), tt(vb),
                                     heads)
        ref = JA.dispatch_sdpa_banked(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), jnp.asarray(kb),
                                      jnp.asarray(vb), heads)
        k = np.concatenate([k, kb], 1)
        v = np.concatenate([v, vb], 1)
    else:
        got = A.dispatch_sdpa(tt(q), tt(k), tt(v), heads)
        ref = JA.dispatch_sdpa(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), heads)
    assert calls == [1]
    np.testing.assert_allclose(nn(got), np.asarray(ref), atol=ATOL)
    np.testing.assert_allclose(nn(got), _sdpa_oracle(q, k, v, heads),
                               atol=ATOL)


@pytest.mark.parametrize("d,ok", [(192, True), (256, True), (448, True),
                                  (512, True), (160, False), (200, False),
                                  (576, False), (128, False)])
def test_wide_widths(d, ok):
    """The kernel's widths: d % 64 == 0, 160 < d <= 512 (csrc/flash_wide.cu
    instantiates each)."""
    assert FA.wide_width(d) is ok


def test_wide_wrapper_counts_only_kernel_launches():
    """CPU tensors take the plain version, which is neither a launch nor a
    width's launch."""
    rng = np.random.default_rng(9)
    q, k, v = (tt(_rand(rng, 1, 8, 512)) for _ in range(3))
    before = (FA.flash_attention_wide.launches,
              dict(FA.flash_attention_wide.widths))
    FA.flash_attention_wide(q, k, v, 1)
    assert (FA.flash_attention_wide.launches,
            dict(FA.flash_attention_wide.widths)) == before


WIDE_SRC = (Path(FA.__file__).parents[1] / "csrc" / "flash_wide.cu").read_text()


def _wide_const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", WIDE_SRC)[1])


def test_fill_plan_matches_kernel():
    """tools/time_flash_wide.py's byte estimate sizes the kernel's tiles:
    kWideBQ query rows a block and kWideBK keys a K / V tile (the tiles'
    fit in shared memory is WideTile<D>'s static_assert, at build time)."""
    assert (TW.PLAN[0], TW.TILE) == (_wide_const("kWideBQ"),
                                     _wide_const("kWideBK"))


@pytest.mark.parametrize("plan,fill", [
    # B = 8, S = 6272, d = 512: 98 key tiles
    (TW.FIRST_PLAN, 784 * (64 * 1024 + 98 * 2 * 65536)),
    (TW.PLAN, 784 * (128 * 1024 + 98 * (65536 + 32768))),
])
def test_fill_bytes(plan, fill):
    """The shared-memory fill of one B = 8, S = 6272 call, counted by hand:
    784 blocks of 64 rows (the first design: each 64 KB of Q and 98 K and
    V tiles of 64 KB), or 784 blocks of 128 rows, a pair a query tile,
    each taking 128 KB of Q, 98 K tiles and 98 half V tiles."""
    assert TW.fill_bytes(8, 1, 512, 6272, 6272, plan) == fill


PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_19gn_kernelEv' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_19gn_kernelEv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers
ptxas info    : (C7519) warpgroup.arrive is injected in around line 399 by compiler to allow use of registers in GMMA in function '_ZN12_GLOBAL__N_117flash_wide_kernelILi512EEEv9FlashArgs'
ptxas info    : (C7520) Potential Performance Loss: wgmma.mma_async instructions are serialized due to program dependence on compiler-inserted WG.AR in divergent path in the function '_ZN12_GLOBAL__N_117flash_wide_kernelILi512EEEv9FlashArgs'
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_117flash_wide_kernelILi512EEEv9FlashArgs' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_117flash_wide_kernelILi512EEEv9FlashArgs
    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 186 registers, used 1 barriers, 432 bytes cmem[0]
"""


def test_registers_reads_ptxas_log():
    """The tool's ptxas summary (through _build.ptxas_report): each
    flash_wide_kernel<d>'s registers and spill line, and the notes of a
    performance loss that name it; other kernels and plain infos left
    out."""
    kernels, notes = _build.ptxas_report(PTXAS_LOG)
    assert [(n.split("_N_")[1][:20], r) for n, r, _ in kernels] == [
        ("19gn_kernelEv", "40 registers"),
        ("117flash_wide_kernel", "186 registers")]
    assert len(notes) == 1 and "(C7520)" in notes[0]
    assert TW.registers(PTXAS_LOG) == [
        notes[0], "d=512: 186 registers; 0 bytes stack frame, 8 bytes spill "
        "stores, 8 bytes spill loads"]
