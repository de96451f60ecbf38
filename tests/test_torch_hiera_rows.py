"""The Hiera block's row passes (``ops/rows.py``, csrc/hiera_rows.cu) and
their LayerNorm (``ops/ffn.py::ln_rows``) on the CPU: each wrapper's plain
version equal in every bit to the eager chain ``hiera_apply`` ran before
it (fp32 and bf16); the inverse window map the kernel computes equal to
``_window_unpartition`` (windowed, q-pooled at window // 2, padded);
``hiera_apply`` equal in every bit to that eager chain on a tiny config
whose grids do not divide their windows; the LN pass's plan and its
emulated kernels at Hiera-L's widths; the wrappers' counters."""

import numpy as np
import pytest
import torch

from mimo_tpu_torch.decomp import hiera as H
from mimo_tpu_torch.decomp.vit import (_window_partition, _window_unpartition,
                                       gelu)
from mimo_tpu_torch.models import layers as L
from mimo_tpu_torch.ops import ffn as FF
from mimo_tpu_torch.ops import rows as R
from tests.test_torch_ln_rows import (BF16_TOL, ln_rows_emulated,
                                      ln_rows_wide_emulated)

DTYPES = [torch.float32, torch.bfloat16]
# Hiera-L's stages at 1024^2: (tokens a frame, width)
HIERA_L = [(256 * 256, 144), (128 * 128, 288), (64 * 64, 576),
           (32 * 32, 1152)]


def _rand(shape, seed, dtype, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * scale).to(dtype)


def _linear(din, dout, seed, dtype):
    return {"kernel": _rand((din, dout), seed, dtype, din ** -0.5),
            "bias": _rand((dout,), seed + 1, dtype, 0.5)}


def _same(a: torch.Tensor, b: torch.Tensor) -> None:
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a, b), float((a.float() - b.float()).abs().max())


@pytest.mark.parametrize("dtype", DTYPES)
def test_bias_gelu_equals_the_eager_chain(dtype):
    """fc1's chain: gelu(linear(fc1, y)), the bias rounded to the dtype
    before the fp32 GELU, in every bit; counted as a plain call."""
    y = _rand((2, 37, 16), 0, dtype, 3.0)
    fc1 = _linear(16, 64, 1, dtype)
    before = (R.bias_gelu.launches, R.bias_gelu.plain_calls)
    got = R.bias_gelu(H._product(fc1, y), fc1["bias"])
    _same(got, gelu(L.linear(fc1, y)))
    assert (R.bias_gelu.launches, R.bias_gelu.plain_calls) == (
        before[0], before[1] + 1)


@pytest.mark.parametrize("dtype", DTYPES)
def test_bias_residual_equals_the_eager_chain(dtype):
    """fc2's chain: tokens + linear(fc2, h), in every bit."""
    h = _rand((2, 37, 64), 2, dtype)
    tokens = _rand((2, 37, 16), 3, dtype, 4.0)
    fc2 = _linear(64, 16, 4, dtype)
    before = R.bias_residual.plain_calls
    got = R.bias_residual(H._product(fc2, h), fc2["bias"], tokens)
    _same(got, tokens + L.linear(fc2, h))
    assert R.bias_residual.plain_calls == before + 1
    assert R.bias_residual.launches == R.bias_gelu.launches == 0


# (grid, window, q-pooled): grids that divide the window, that do not (the
# padding cropped), and q-pooled blocks that unpartition at window // 2
UNPARTITIONS = [((8, 8), 4, False), ((9, 11), 4, False), ((5, 3), 8, False),
                ((16, 8), 4, True), ((18, 22), 4, True), ((9, 7), 2, True),
                ((7, 7), 8, True)]


def _unpartition(grid, window, pooled):
    """The Unpartition hiera_apply builds for a windowed block at
    ``grid``."""
    gh, gw = grid
    hp, wp = -(-gh // window) * window, -(-gw // window) * window
    f = 2 if pooled else 1
    return R.Unpartition(gh // f, gw // f, window // f, (hp // f, wp // f))


@pytest.mark.parametrize("grid,window,pooled", UNPARTITIONS)
def test_unpartition_rows_equal_window_unpartition(grid, window, pooled):
    """The row map the kernel computes reads each output row where
    ``_window_unpartition`` puts it."""
    b, d = 2, 3
    un = _unpartition(grid, window, pooled)
    hp, wp = un.padded
    windows = b * hp * wp // un.ws ** 2
    x = torch.arange(windows * un.ws ** 2 * d, dtype=torch.float32).reshape(
        windows, un.ws ** 2, d)
    want = _window_unpartition(x, b, un.hgt, un.wid, un.ws, un.padded)
    got = x.reshape(-1, d)[R.unpartition_rows(b, un)].reshape(want.shape)
    _same(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("grid,window,pooled", UNPARTITIONS)
def test_windowed_bias_residual_equals_the_eager_chain(dtype, grid, window,
                                                       pooled):
    """proj_attn's chain in a windowed block: shortcut +
    unpartition(linear(proj_attn, o)), in every bit."""
    b, d = 2, 16
    un = _unpartition(grid, window, pooled)
    hp, wp = un.padded
    o = _rand((b * hp * wp // un.ws ** 2, un.ws ** 2, d), 5, dtype)
    proj = _linear(d, d, 6, dtype)
    shortcut = _rand((b, un.hgt * un.wid, d), 7, dtype, 2.0)
    got = R.bias_residual(H._product(proj, o), proj["bias"], shortcut, un)
    want = shortcut + _window_unpartition(L.linear(proj, o), b, un.hgt,
                                          un.wid, un.ws, un.padded)
    _same(got, want)


def hiera_apply_eager(p, cfg, pixels):
    """``hiera_apply`` as the eager chain computed it before the row
    passes: fp32 LayerNorm and GELU round trips, the bias, the residual
    and the window un-partition each a pass of their own."""
    b = pixels.shape[0]
    h = L.conv2d(p["patch_embed"], pixels, stride=4, padding=3)
    gh, gw = h.shape[1], h.shape[2]
    h = h + H.hiera_pos_embed(p, cfg, gh, gw).to(h.dtype)[None]
    tokens = h.reshape(b, gh * gw, cfg.embed_dim)
    stage_last = set((np.cumsum(cfg.stages) - 1).tolist())
    outputs = []
    for i, (blk, (din, dout, heads, window, q_pool)) in enumerate(
            zip(p["blocks"], cfg.block_plan())):
        y = L.layer_norm(blk["ln1"], tokens, cfg.ln_eps)
        if "proj" in blk:
            shortcut = L.linear(blk["proj"], y)
            if q_pool:
                shortcut = H._maxpool2(shortcut.reshape(b, gh, gw, dout))
                shortcut = shortcut.reshape(b, -1, dout)
        else:
            shortcut = tokens
        if window:
            yw, (hp, wp) = _window_partition(y, gh, gw, window)
            o, _, _ = H._attn(blk, yw, heads, dout, q_pool, window, window)
            aw = L.linear(blk["proj_attn"], o)
            if q_pool:
                oh, ow = gh // 2, gw // 2
                a = _window_unpartition(aw, b, oh, ow, window // 2,
                                        (hp // 2, wp // 2))
            else:
                oh, ow = gh, gw
                a = _window_unpartition(aw, b, gh, gw, window, (hp, wp))
        else:
            o, oh, ow = H._attn(blk, y, heads, dout, q_pool, gh, gw)
            a = L.linear(blk["proj_attn"], o)
        gh, gw = oh, ow
        tokens = shortcut + a
        y2 = L.layer_norm(blk["ln2"], tokens, cfg.ln_eps)
        tokens = tokens + L.linear(blk["fc2"],
                                   gelu(L.linear(blk["fc1"], y2)))
        if i in stage_last:
            outputs.append(tokens.reshape(b, gh, gw, dout))
    return outputs


# a grid of 18 (72 / 4) padded to 20 by the window of 4, q-pooled to 9 and
# padded to 10 at window 2, then to 12 at window 4; a pooled global block
RAGGED = H.HieraConfig(embed_dim=16, num_heads=2, stages=(1, 2, 1, 1),
                       window_spec=(4, 4, 2, 2), global_blocks=(4,),
                       input_size=(72, 72), neck_dim=32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cfg", [RAGGED, H.tiny_hiera_config()],
                         ids=["ragged", "tiny"])
def test_hiera_apply_equals_the_eager_chain(dtype, cfg):
    """Every stage output of ``hiera_apply`` on the CPU equals the eager
    chain's in every bit; a block runs 3 plain row passes and no
    kernel."""
    p = H.hiera_init(torch.Generator().manual_seed(8), cfg, dtype)
    s = cfg.input_size[0]
    x = _rand((2, s, s, 3), 9, dtype)
    plain = R.bias_gelu.plain_calls + R.bias_residual.plain_calls
    got = H.hiera_apply(p, cfg, x)
    assert (R.bias_gelu.plain_calls + R.bias_residual.plain_calls
            - plain) == 3 * cfg.depth
    assert R.bias_gelu.launches == R.bias_residual.launches == 0
    want = hiera_apply_eager(p, cfg, x)
    assert len(got) == len(want) == len(cfg.stages)
    for a, b in zip(got, want):
        _same(a, b)


def test_ragged_config_pads_its_windows():
    """The ragged config's windowed blocks crop padding, pooled and not."""
    plan = RAGGED.block_plan()
    grids, g = [], RAGGED.input_size[0] // 4
    for din, dout, heads, window, q_pool in plan:
        grids.append((g, window, q_pool))
        if q_pool:
            g //= 2
    assert any(w and g % w and not q for g, w, q in grids)
    assert any(w and g % w and q for g, w, q in grids)
    assert any(not w and q for g, w, q in grids)


@pytest.mark.parametrize("frames", [8, 6])
@pytest.mark.parametrize("m,k", HIERA_L)
def test_ln_rows_plan_at_hiera_widths(m, k, frames):
    """An encode chunk of 8 frames (a clip's last of 6) at each Hiera-L
    stage: a register plan whose lanes x vectors cover the row with the
    kernel's instantiations and whose warps cover every row once, or the
    wide-row kernel, a warp a row."""
    rows = frames * m
    plan = FF.ln_rows_plan(rows, k, 132)
    if plan.vectors:
        assert plan.lanes in FF.LN_LANES
        assert 1 <= plan.vectors <= FF.LN_MAX_VECTORS
        assert k // 8 <= plan.lanes * plan.vectors < k // 8 + plan.lanes
        steps = -(-rows // (32 // plan.lanes))
        assert plan.blocks * FF.LN_WARPS * plan.steps_per_warp >= steps
        assert (plan.blocks - 1) * FF.LN_WARPS * plan.steps_per_warp < steps
        assert plan.blocks <= FF.LN_BLOCKS_PER_SM * 132
    else:
        assert (plan.lanes, plan.steps_per_warp) == (32, 1)
        assert plan.blocks * FF.LN_WARPS >= rows
    # stage 1 (and stage 2 at 8 frames) hold enough row steps for the
    # register kernel
    assert bool(plan.vectors) == (k == 144 or (k == 288 and frames == 8))


@pytest.mark.parametrize("k", [k for _, k in HIERA_L])
def test_emulated_ln_rows_at_hiera_widths(k):
    """Both LN kernels, emulated, against the plain pass at Hiera's widths
    and eps."""
    g = torch.Generator().manual_seed(k)
    x = (torch.randn((150, k), generator=g) * 2 + 0.3).to(torch.bfloat16)
    scale = (torch.randn(k, generator=g) * 0.3 + 1).to(torch.bfloat16)
    bias = (torch.randn(k, generator=g) * 0.3).to(torch.bfloat16)
    eps = H.HieraConfig().ln_eps
    want = FF.ln_rows_plain(x, scale, bias, eps).float().numpy()
    for got in (ln_rows_emulated(x, scale, bias, eps),
                ln_rows_wide_emulated(x, scale, bias, eps)):
        np.testing.assert_allclose(got.float().numpy(), want,
                                   rtol=BF16_TOL, atol=BF16_TOL)


def test_kernel_route_refuses_cpu_tensors():
    """The kernel route never computes on the CPU: it raises."""
    p = torch.zeros((4, 16), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        R.bias_gelu_cuda(p, torch.zeros(16))
    with pytest.raises(ValueError, match="CUDA"):
        R.bias_residual_cuda(p, torch.zeros(16), p)
