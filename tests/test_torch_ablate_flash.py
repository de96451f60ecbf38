"""The port's flash-ablation tool (mimo_tpu_torch/tools/ablate_flash.py):
its plain versions, as ``run`` takes them for CPU tensors, against the JAX
tool tools/ablate_flash.py (Pallas, interpret mode) and the numpy oracle of
tests/test_ops.py, and the stand-in modes' bounds and data dependencies;
the tool's modes, tile and nopv key pick against the kernel source
(csrc/flash_body.cuh) and its accumulator layout.

Shapes: B=1, Sq=256, Sk=512, 2 heads, d=40 (the JAX tool at block_q=128,
block_k=256), plus ragged Sq=100 / Sk=150 (one whole BLOCK_K = 128-key
tile and a ragged one) for the per-tile stand-ins.
"""

import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mimo_tpu_torch.tools import ablate_flash as A
from tests.test_ops import _sdpa_oracle
from tests.test_torch_helpers import nn, set_fp32_matmuls, tt

set_fp32_matmuls()

B, SQ, SK, HEADS, D = 1, 256, 512, 2, 40
# the JAX tool computes exp2 on bf16 logits (and the Cauchy-Schwarz shift
# of its bf16 q), so it sits ~1e-2 from fp32 attention (0.0088 measured at
# this shape); the port's plain version is fp32 throughout
JAX_TOOL_ATOL = 2e-2
# fp32 attention on both sides, summation order only
ORACLE_ATOL = 1e-5
STAND_INS = [m for m in A.MODES if m not in A.ATTENTION_MODES]


@pytest.fixture(scope="module")
def jax_tool():
    """tools/ablate_flash.py, imported with the test run's compile-cache
    options restored (the tool points them at its own TPU cache)."""
    opts = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {o: getattr(jax.config, o) for o in opts}
    try:
        from tools import ablate_flash as tool
    finally:
        for o, val in saved.items():
            jax.config.update(o, val)
    return tool


def _inputs(seed, sq=SQ, sk=SK, heads=HEADS, d=D):
    """bf16-representable fp32 inputs (so both tools see the same values)."""
    rng = np.random.default_rng(seed)
    return [np.asarray(jnp.asarray(rng.standard_normal((B, s, heads * d)),
                                   jnp.bfloat16), np.float32)
            for s in (sq, sk, sk)]


def _t(x):
    """(B, S, C) numpy -> (B, C, S) numpy."""
    return np.ascontiguousarray(np.transpose(x, (0, 2, 1)))


@pytest.mark.parametrize("mode,pretransposed", [
    (mode, pre) for pre in (False, True) for mode in A.ATTENTION_MODES])
def test_attention_modes_match_jax_tool_and_oracle(jax_tool, mode,
                                                   pretransposed):
    q, k, v = _inputs(0)
    args = [_t(x) for x in (q, k, v)] if pretransposed else [q, k, v]
    got = nn(A.run_plain(*[tt(x) for x in args], HEADS, mode, pretransposed))
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax_tool.run(
            *[jnp.asarray(x, jnp.bfloat16) for x in args], HEADS,
            sm_scale=1.0 / math.sqrt(D), block_q=128, block_k=256, mode=mode,
            pretransposed=pretransposed), np.float32)
    assert got.shape == ref.shape == (B, SQ, HEADS * D)
    np.testing.assert_allclose(got, ref, atol=JAX_TOOL_ATOL)
    np.testing.assert_allclose(got, _sdpa_oracle(q, k, v, HEADS),
                               atol=ORACLE_ATOL)


@pytest.mark.parametrize("mode", STAND_INS)
@pytest.mark.parametrize("sq,sk", [(SQ, SK), (100, 150)])
def test_stand_ins_are_finite_and_bounded(mode, sq, sk):
    q, k, v = (tt(x) for x in _inputs(1, sq, sk))
    out = A.run_plain(q, k, v, HEADS, mode)
    assert out.shape == (B, sq, HEADS * D) and torch.isfinite(out).all()
    if mode in ("nopv", "nomxu"):
        # column c: the share of the softmax mass on one key per tile
        assert float(out.min()) >= 0.0 and float(out.max()) <= 1.0
        assert float(out.std()) > 0.0
    else:
        # weighted means of v rows with weights >= 0 and row sums > 0
        assert float(out.abs().max()) <= float(v.abs().max()) + 1e-5


@pytest.mark.parametrize("mode", STAND_INS)
def test_stand_ins_are_layout_independent(mode):
    q, k, v = _inputs(2, 100, 150)
    nat = A.run_plain(tt(q), tt(k), tt(v), HEADS, mode)
    pre = A.run_plain(*[A.pretranspose(tt(x)) for x in (q, k, v)], HEADS,
                      mode, pretransposed=True)
    # a product over operands of other strides may sum in another order
    np.testing.assert_allclose(nn(nat), nn(pre), atol=1e-7, rtol=0)


def _perturbed(mode, name, where):
    """Output change of ``mode`` when input ``name`` is moved at ``where``."""
    q, k, v = (tt(x) for x in _inputs(3, 100, 150))
    base = A.run_plain(q, k, v, HEADS, mode)
    x = {"q": q, "k": k, "v": v}
    x[name] = x[name].clone()
    x[name][where] += 0.75
    moved = A.run_plain(x["q"], x["k"], x["v"], HEADS, mode)
    return float((moved - base).abs().max())


# (mode, input, index, does the output depend on it)
DEPENDENCIES = [
    ("noexp", "q", (0, 5, 3), True), ("noexp", "k", (0, 7, 3), True),
    ("noexp", "v", (0, 7, 3), True),
    ("nosm", "q", (0, 5, 3), True), ("nosm", "k", (0, 7, 3), True),
    ("nosm", "v", (0, 7, 3), True),
    # no P.V: the output never reads v
    ("nopv", "q", (0, 5, 3), True), ("nopv", "k", (0, 7, 3), True),
    ("nopv", "v", (0, slice(None), slice(None)), False),
    # rank-1 logits: only column 0 of each head of q and k
    ("noqk", "q", (0, slice(None), 0), True),
    ("noqk", "k", (0, slice(None), D), True),
    ("noqk", "q", (0, slice(None), 3), False),
    ("noqk", "k", (0, slice(None), D + 3), False),
    ("noqk", "v", (0, 7, 3), True),
    ("nomxu", "q", (0, slice(None), D), True),
    ("nomxu", "k", (0, slice(None), 0), True),
    ("nomxu", "q", (0, slice(None), 1), False),
    ("nomxu", "v", (0, slice(None), slice(None)), False),
]


@pytest.mark.parametrize("mode,name,where,depends", DEPENDENCIES)
def test_stand_ins_depend_on_what_they_keep(mode, name, where, depends):
    change = _perturbed(mode, name, where)
    assert (change > 0.0) is depends, change


def test_noqk_is_attention_over_rank1_logits():
    """noqk = softmax(q[:, :, 0] k[:, :, 0]^T / sqrt(d)) V per head (the
    constant -8 cancels in the softmax), up to P's bf16 rounding."""
    q, k, v = _inputs(4, 100, 150)
    got = nn(A.run_plain(tt(q), tt(k), tt(v), HEADS, "noqk"))
    q1, k1 = np.zeros_like(q), np.zeros_like(k)
    for h in range(HEADS):
        q1[..., h * D] = q[..., h * D]
        k1[..., h * D] = k[..., h * D]
    # P in bf16 (relative 2^-9) on weighted means of v: |d| <= 2^-8 max|v|
    np.testing.assert_allclose(got, _sdpa_oracle(q1, k1, v, HEADS),
                               atol=float(np.abs(v).max()) / 256)


def test_run_on_cpu_takes_plain_and_counts_no_launch():
    q, k, v = (tt(x) for x in _inputs(6, 100, 150))
    before = A.run.launches
    for mode in A.MODES:
        np.testing.assert_array_equal(nn(A.run(q, k, v, HEADS, mode)),
                                      nn(A.run_plain(q, k, v, HEADS, mode)))
    assert A.run.launches == before


def test_unknown_mode_raises():
    q = torch.zeros((1, 8, 80))
    with pytest.raises(ValueError, match="unknown mode"):
        A.run(q, q, q, HEADS, "notrans")
    with pytest.raises(ValueError, match="unknown mode"):
        A.run_plain(q, q, q, HEADS, "nope")


def test_pretranspose_pads_the_channel_stride():
    x = torch.arange(2 * 11 * 3, dtype=torch.float32).reshape(2, 11, 3)
    t = A.pretranspose(x)
    assert t.shape == (2, 3, 11) and t.stride() == (48, 16, 1)
    np.testing.assert_array_equal(nn(t), nn(x.transpose(1, 2)))


BODY = (Path(A.__file__).parents[1] / "csrc" / "flash_body.cuh").read_text()


def test_modes_follow_the_kernel_enum():
    """MODES is the C interface's mode order: FlashMode of the body."""
    enum = re.search(r"enum FlashMode : int \{(.*?)\};", BODY, re.S)[1]
    names = [n.split("=")[0].strip() for n in enum.split(",") if n.strip()]
    assert names[-1] == "kNumModes"
    assert [n[1:].lower() for n in names[:-1]] == list(A.MODES)


def test_block_k_is_the_kernel_tile():
    """The stand-ins' tile is FlashTile<D>::kBK at every kernel width."""
    limit, small, large = map(int, re.search(
        r"kBK = D <= (\d+) \? (\d+) : (\d+);", BODY).groups())
    assert {small if d <= limit else large for d in A.KERNEL_DIMS} \
        == {A.BLOCK_K}


@pytest.mark.parametrize("d", A.KERNEL_DIMS)
def test_nopv_picks_the_key_of_the_kernel_registers(d):
    """In nopv the kernel adds s register j into o register j of the same
    thread. In the m64nN accumulator layout register 4i + 2h + e of lane
    ``lane`` of warp w is row 16w + lane/4 + 8h, column 8i + 2(lane % 4) +
    e: column c of o adds the logit of key c of the tile, which is what
    run_plain picks."""
    for h, e in ((0, 0), (0, 1), (1, 0), (1, 1)):
        j = f"i + {2 * h + e}" if 2 * h + e else "i"
        assert f"o[{j}] = fmaf(o[{j}], al{h}, s[{j}]);" in BODY
    want = A.nopv_key(torch.arange(d))
    for warp in range(4):
        for lane in range(32):
            for j in range(d // 2):
                i, h, e = j // 4, (j >> 1) & 1, j & 1
                row = 16 * warp + lane // 4 + 8 * h
                col = 8 * i + 2 * (lane % 4) + e   # o register j
                key = 8 * i + 2 * (lane % 4) + e   # s register j
                assert 0 <= row < 64 and key < A.BLOCK_K
                assert int(want[col]) == key
