"""The LayerNorm row pass (``ops/ffn.py::ln_rows``, csrc/ln_rows.cu), the
GEMM tile core's LN prologue, on the CPU: its plain version against the
JAX package's ``layers.layer_norm`` followed by the temporal chain's PE
add; its launch plan (lanes a row, vectors a lane, row steps a warp); a
torch emulation of the kernel's lane mapping, sums and PE stepping held to
the plain version; and the tile core fed by the emulated pass held to the
unfused compositions.

Tolerances: bf16 rows round twice (the normalised value, then the sum with
the PE), and the two sides take the statistics in another order (the
kernel and the Pallas kernels E[x²]−E[x]², XLA and PyTorch a centred
variance), which can move a value across a rounding boundary: |d| ≤ 2^-7
(|ref| + 1), two bf16 ulps. In fp32 the composition is held to
test_torch_ffn.py's atol 2e-4.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from mimo_tpu.models import layers as JL
from mimo_tpu_torch.models import layers as L
from mimo_tpu_torch.ops import ffn as FF
from tests.test_torch_gemm_plan import tile_core_emulated
from tests.test_torch_helpers import set_fp32_matmuls

set_fp32_matmuls()

BF16_TOL = 2.0 ** -7
ATOL = 2e-4
WIDTHS = [232, 320, 640, 1280]      # ragged K, then UNet levels 0-2/3


def _bf16(a: np.ndarray) -> np.ndarray:
    """a rounded to bf16, as fp32."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _inputs(k, b=2, f=3, s=5, seed=0):
    rng = np.random.default_rng(seed)
    x = _bf16((rng.standard_normal((b, f, s, k)) * 2 + 0.3).astype(np.float32))
    scale = _bf16((rng.standard_normal(k) * 0.3 + 1).astype(np.float32))
    bias = _bf16((rng.standard_normal(k) * 0.3).astype(np.float32))
    pe = _bf16((rng.standard_normal((f, k)) * 0.5).astype(np.float32))
    return x, scale, bias, pe


def _bt(a):
    return torch.from_numpy(a).to(torch.bfloat16)


@pytest.mark.parametrize("k", WIDTHS)
def test_plain_matches_jax_layer_norm_then_pe(k):
    """(B, F, S, K) motion-module tokens: LN rounded to bf16, + the frame's
    PE row, as the temporal chain adds it (rows (b·F + f)·S + s, so
    pe_div = S)."""
    x, scale, bias, pe = _inputs(k)
    b, f, s, _ = x.shape
    ln = JL.layer_norm({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                       jnp.asarray(x), 1e-5).astype(jnp.bfloat16)
    ref = ln + jnp.asarray(pe).astype(jnp.bfloat16)[None, :, None, :]
    got = FF.ln_rows_plain(_bt(x), _bt(scale), _bt(bias), 1e-5, _bt(pe), s)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    ref = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=BF16_TOL,
                               atol=BF16_TOL)
    # without the PE: the plain LN of the rows
    got = FF.ln_rows_plain(_bt(x), _bt(scale), _bt(bias), 1e-5)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ln.astype(jnp.float32)),
                               rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("k,lanes,vectors", [
    (320, 8, 5), (640, 16, 5), (1280, 32, 5), (232, 8, 4), (64, 8, 1),
    (1536, 32, 6), (2048, 32, 0)])
def test_plan_maps_lanes_to_vectors(k, lanes, vectors):
    """Lanes × vectors cover the row's K/8 vectors with the fewest idle
    slots the kernel's instantiations allow: none at the main path's
    widths; rows past 32 × 6 vectors take the wide-row kernel."""
    plan = FF.ln_rows_plan(48 * 6272, k, 132)
    assert (plan.lanes, plan.vectors) == (lanes, vectors)
    if vectors:
        assert plan.vectors <= FF.LN_MAX_VECTORS
        idle = plan.lanes * plan.vectors - k // 8
        assert 0 <= idle == min(
            lv * -(-(k // 8) // lv) - k // 8 for lv in FF.LN_LANES
            if -(-(k // 8) // lv) <= FF.LN_MAX_VECTORS)


@pytest.mark.parametrize("m,k", [(48 * 6272, 320), (48 * 1568, 640),
                                 (48 * 400, 1280), (48 * 104, 1280),
                                 (1000, 232), (7, 320),
                                 # the edit path's 98x98 latents
                                 (48 * 9604, 320), (48 * 2401, 640),
                                 (48 * 625, 1280), (48 * 169, 1280)])
def test_plan_covers_every_row_once(m, k):
    """The warps' runs of row steps cover every row once, two blocks an
    SM at most, the last run ragged; a short call (UNet levels 2-3 at
    64x98 latents, level 3 at 98x98: at most LN_SHORT_RUNS runs of the
    grid) takes the wide-row kernel, a warp a row."""
    plan = FF.ln_rows_plan(m, k, 132)
    rows_per_step = 32 // plan.lanes
    steps = -(-m // rows_per_step)
    warps = plan.blocks * FF.LN_WARPS
    assert warps * plan.steps_per_warp >= steps
    assert (plan.blocks - 1) * FF.LN_WARPS * plan.steps_per_warp < steps
    short = m <= 48 * 400 or m in (1000, 7, 48 * 169)
    assert (plan.vectors == 0) == short
    if short:
        assert (plan.lanes, plan.steps_per_warp) == (32, 1)
    else:
        assert plan.blocks <= FF.LN_BLOCKS_PER_SM * 132


def _rounded(t: torch.Tensor, dtype) -> torch.Tensor:
    return t.to(dtype).float()


def ln_rows_emulated(x, scale, bias, eps, pe=None, pe_div=1, sms=1):
    """What csrc/ln_rows.cu's register kernel computes for x (m, k) under
    ln_rows_plan (never the wide-row plan of a short call): lane
    l of a row sums its vectors l, l + lanes, ... element by element, the
    row's lanes combine in a butterfly, mean = sum · (1/k); the value is
    rounded to x's dtype, then the PE row of the frame the warp steps to
    (not divides for) is added and rounded again."""
    m, k = x.shape
    plan = FF.ln_rows_plan(m, k, sms, short_runs=0)
    lanes, vectors = plan.lanes, plan.vectors
    assert vectors > 0
    rows_per_step = 32 // lanes
    xf = torch.nn.functional.pad(x.float(), (0, lanes * vectors * 8 - k))
    # (m, vectors, lanes, 8): vector i·lanes + l of a row sits at [i, l]
    v = xf.reshape(m, vectors, lanes, 8)
    s1 = torch.zeros(m, lanes)
    s2 = torch.zeros(m, lanes)
    for i in range(vectors):
        for e in range(8):
            s1 = s1 + v[:, i, :, e]
            s2 = s2 + v[:, i, :, e] * v[:, i, :, e]
    idx = torch.arange(lanes)
    o = lanes // 2
    while o:
        s1, s2 = s1 + s1[:, idx ^ o], s2 + s2[:, idx ^ o]
        o //= 2
    inv_k = torch.tensor(1.0 / k, dtype=torch.float32)
    mean = s1[:, 0] * inv_k
    inv = torch.rsqrt(s2[:, 0] * inv_k - mean * mean + eps)
    y = _rounded((x.float() - mean[:, None]) * inv[:, None] * scale.float()
                 + bias.float(), x.dtype)
    if pe is None:
        return y.to(x.dtype)
    # each warp's run of steps: the frame divided out at its first row, then
    # stepped row group by row group
    frames = torch.full((m,), -1, dtype=torch.long)
    steps = -(-m // rows_per_step)
    for w in range(plan.blocks * FF.LN_WARPS):
        first = w * plan.steps_per_warp
        last = min(first + plan.steps_per_warp, steps)
        for g in range(rows_per_step):
            row = first * rows_per_step + g
            frame, rem = (row // pe_div) % pe.shape[0], row % pe_div
            for _ in range(first, last):
                if row < m:
                    assert frames[row] == -1     # one warp a row
                    frames[row] = frame
                row += rows_per_step
                rem += rows_per_step
                while rem >= pe_div:
                    rem -= pe_div
                    frame = (frame + 1) % pe.shape[0]
    assert (frames >= 0).all()
    return (y + pe.float()[frames]).to(x.dtype)


def ln_rows_wide_emulated(x, scale, bias, eps, pe=None, pe_div=1):
    """What csrc/ln_rows.cu's wide-row kernel computes for x (m, k): lane
    l of a row's warp sums its 8-value pieces l, l + 32, ... element by
    element, the warp combines them in a butterfly, mean = sum · (1/k);
    the value is rounded to x's dtype, then the PE row of the frame
    (r // pe_div) % F is added and rounded again."""
    m, k = x.shape
    pieces = -(-k // 256)
    xf = torch.nn.functional.pad(x.float(), (0, pieces * 256 - k))
    v = xf.reshape(m, pieces, 32, 8)
    s1 = torch.zeros(m, 32)
    s2 = torch.zeros(m, 32)
    for i in range(pieces):
        for e in range(8):
            s1 = s1 + v[:, i, :, e]
            s2 = s2 + v[:, i, :, e] * v[:, i, :, e]
    idx = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        s1, s2 = s1 + s1[:, idx ^ o], s2 + s2[:, idx ^ o]
    inv_k = torch.tensor(1.0 / k, dtype=torch.float32)
    mean = s1[:, 0] * inv_k
    inv = torch.rsqrt(s2[:, 0] * inv_k - mean * mean + eps)
    y = _rounded((x.float() - mean[:, None]) * inv[:, None] * scale.float()
                 + bias.float(), x.dtype)
    if pe is None:
        return y.to(x.dtype)
    frames = (torch.arange(m) // pe_div) % pe.shape[0]
    return (y + pe.float()[frames]).to(x.dtype)


@pytest.mark.parametrize("k", WIDTHS + [2048])
def test_emulated_wide_rows_match_plain(k):
    """The wide-row kernel (UNet levels 2-3 and K > 1536), with and
    without the PE."""
    x, scale, bias, pe = _inputs(k, b=2, f=4, s=37, seed=2)
    s = x.shape[2]
    x2 = _bt(x.reshape(-1, k))
    got = ln_rows_wide_emulated(x2, _bt(scale), _bt(bias), 1e-5, _bt(pe), s)
    want = FF.ln_rows_plain(x2, _bt(scale), _bt(bias), 1e-5, _bt(pe), s)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               rtol=BF16_TOL, atol=BF16_TOL)
    got = ln_rows_wide_emulated(x2, _bt(scale), _bt(bias), 1e-5)
    want = FF.ln_rows_plain(x2, _bt(scale), _bt(bias), 1e-5)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("k", WIDTHS)
@pytest.mark.parametrize("sms", [1, 132])
def test_emulated_lane_mapping_matches_plain(k, sms):
    """Many row steps a warp (one SM) and one (the H100's 132 SMs); the
    frame the warps step to is the frame (r // S) % F."""
    x, scale, bias, pe = _inputs(k, b=2, f=4, s=37, seed=1)
    s = x.shape[2]
    x2 = _bt(x.reshape(-1, k))
    got = ln_rows_emulated(x2, _bt(scale), _bt(bias), 1e-5, _bt(pe), s, sms)
    want = FF.ln_rows_plain(x2, _bt(scale), _bt(bias), 1e-5, _bt(pe), s)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               rtol=BF16_TOL, atol=BF16_TOL)
    got = ln_rows_emulated(x2, _bt(scale), _bt(bias), 1e-5, sms=sms)
    want = FF.ln_rows_plain(x2, _bt(scale), _bt(bias), 1e-5)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("rows,c", [(150, 232), (40, 64)])
def test_tile_core_after_emulated_ln_equals_unfused(rows, c):
    """gemm(..., ln=...) on the card is the LN pass, then the tile core on
    its output: both emulated (fp32) equal the unfused LN + q|k|v and
    LN + GEGLU FFN that the CPU path runs."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((rows, c)).astype(np.float32))
    ln_p = {"scale": torch.from_numpy(rng.standard_normal(c).astype(np.float32)),
            "bias": torch.from_numpy(rng.standard_normal(c).astype(np.float32))}
    w = [torch.from_numpy((rng.standard_normal((c, c)) / np.sqrt(c))
                          .astype(np.float32)) for _ in range(3)]
    attn = {k: {"kernel": wk} for k, wk in zip(("to_q", "to_k", "to_v"), w)}
    normed = ln_rows_emulated(x, ln_p["scale"], ln_p["bias"], 1e-5)
    qkv = tile_core_emulated(normed, FF.prepare_weight(w), 3 * c)
    for got, want in zip(qkv.split(c, dim=1), FF.qkv_ln_plain(x, ln_p, attn)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)
    # and the plain pass is the LN the plain compositions use
    np.testing.assert_allclose(
        FF.ln_rows(x, ln_p["scale"], ln_p["bias"], 1e-5).numpy(),
        L.layer_norm(ln_p, x).numpy(), atol=0)


def test_ln_rows_counts_only_kernel_launches():
    x, scale, bias, pe = _inputs(64)
    before = FF.ln_rows.launches
    y = FF.ln_rows(torch.from_numpy(x), torch.from_numpy(scale),
                   torch.from_numpy(bias), 1e-5, torch.from_numpy(pe), 5)
    assert FF.ln_rows.launches == before and y.shape == x.shape


def test_gemm_with_ln_refuses_cpu_tensors():
    """The kernel route (gemm with an LN prologue) never computes on the
    CPU: it raises."""
    x = torch.zeros((8, 16), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        FF.gemm(x, torch.zeros((16, 8), dtype=torch.bfloat16),
                ln=(torch.ones(16), torch.zeros(16), 1e-5))
