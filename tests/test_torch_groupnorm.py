"""The port's GroupNorm (plain version, as the wrapper runs it on CPU
tensors) against the JAX package: the Pallas kernels ``_gn_pallas``
(resident and two-phase) and ``_gn_pallas_snc`` in interpret mode, and
``layers.group_norm``; with row_add, SiLU and both eps values. Then the
CUDA kernels' launch plan (``gn_plan``: the tier it picks, and that tier's
cover of rows and channels) at every shape the main path gives it, and a
torch emulation of each tier's arithmetic in its order (the plan's split
of rows and channels, the fixed tree of partial sums, the coefficient
fold), held to the plain version and to the Pallas kernels.

Tolerance: atol 1e-4, the one tests/test_groupnorm_kernel.py holds the
Pallas kernels to against XLA (fp32 statistics; E[x²]−E[x]² in fp32 over
up to a few thousand elements per group loses a few more digits than a
centred variance, and the two sides sum in other orders).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from mimo_tpu.models import layers as JL
from mimo_tpu.ops import groupnorm as JG
from mimo_tpu_torch.models import layers as L
from mimo_tpu_torch.ops import groupnorm as G
from tests.test_torch_helpers import nn, set_fp32_matmuls, tt

set_fp32_matmuls()

ATOL = 1e-4

CASES = [
    # shape, groups, eps, row_add, silu
    ((2, 35, 41, 320), 32, 1e-5, True, True),    # UNet resnet norm2
    ((3, 8, 8, 64), 8, 1e-6, False, False),      # transformer / motion norm
    ((1, 130, 7, 256), 32, 1e-6, False, True),   # VAE norm, ragged rows
    ((3, 9, 5, 64), 8, 1e-5, True, False),
    ((2, 5, 7, 960), 32, 1e-5, False, True),    # up-block concat width:
                                                 # C/G = 30, not a multiple of 8
]


def _inputs(shape, radd, seed):
    rng = np.random.default_rng(seed)
    n, c = shape[0], shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    scale = rng.standard_normal(c).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    row_add = rng.standard_normal((n, c)).astype(np.float32) if radd else None
    return x, scale, bias, row_add


def _port(x, scale, bias, groups, eps, silu, row_add):
    return nn(G.group_norm_fused(tt(x), tt(scale), tt(bias), groups, eps,
                                 fuse_silu=silu,
                                 row_add=None if row_add is None
                                 else tt(row_add)))


@pytest.mark.parametrize("shape,groups,eps,radd,silu", CASES)
@pytest.mark.parametrize("two_phase", [False, True])
def test_matches_pallas_gn(shape, groups, eps, radd, silu, two_phase):
    x, scale, bias, row_add = _inputs(shape, radd, 0)
    n, c = shape[0], shape[-1]
    s = x.size // (n * c)
    with pltpu.force_tpu_interpret_mode():
        ref = JG._gn_pallas(jnp.asarray(x.reshape(n, s, c)),
                            jnp.asarray(scale), jnp.asarray(bias), groups,
                            eps, silu, force_two_phase=two_phase,
                            row_add=None if row_add is None
                            else jnp.asarray(row_add))
    got = _port(x, scale, bias, groups, eps, silu, row_add)
    np.testing.assert_allclose(got, np.asarray(ref).reshape(shape),
                               atol=ATOL)


@pytest.mark.parametrize("shape,groups,eps,radd,silu", CASES)
def test_matches_pallas_gn_snc(shape, groups, eps, radd, silu):
    x, scale, bias, row_add = _inputs(shape, radd, 1)
    n, c = shape[0], shape[-1]
    s = x.size // (n * c)
    x_t = np.transpose(x.reshape(n, s, c), (1, 0, 2))
    with pltpu.force_tpu_interpret_mode():
        y_t = JG._gn_pallas_snc(jnp.asarray(x_t), jnp.asarray(scale),
                                jnp.asarray(bias), groups, eps, silu,
                                row_add=None if row_add is None
                                else jnp.asarray(row_add))
    ref = np.transpose(np.asarray(y_t), (1, 0, 2)).reshape(shape)
    got = _port(x, scale, bias, groups, eps, silu, row_add)
    np.testing.assert_allclose(got, ref, atol=ATOL)


@pytest.mark.parametrize("shape,groups,eps,radd,silu", CASES)
def test_layers_group_norm_matches_jax(shape, groups, eps, radd, silu):
    """layers.group_norm against the JAX layers.group_norm (its XLA path on
    CPU)."""
    x, scale, bias, row_add = _inputs(shape, radd, 2)
    ref = JL.group_norm({"scale": jnp.asarray(scale),
                         "bias": jnp.asarray(bias)}, jnp.asarray(x), groups,
                        eps, fuse_silu=silu,
                        row_add=None if row_add is None
                        else jnp.asarray(row_add))
    got = L.group_norm({"scale": tt(scale), "bias": tt(bias)}, tt(x), groups,
                       eps, fuse_silu=silu,
                       row_add=None if row_add is None else tt(row_add))
    np.testing.assert_allclose(nn(got), np.asarray(ref), atol=ATOL)


# the GroupNorm calls of one UNet3D step (48 frames: 64x98 latents and
# 32x49, 16x25, 8x13 below; the up blocks' first norms see the concatenated
# skip channels) and of the VAE decoder (vae_chunk 8 frames, up to 512x784);
# then the same at the edit path's 784x784 (98x98 latents: 49x49, 25x25,
# 13x13 below)
UNET3D_SHAPES = (
    [(48, 6272, c) for c in (320, 640, 960)]
    + [(48, 1568, c) for c in (320, 640, 960, 1280, 1920)]
    + [(48, 400, c) for c in (640, 1280, 1920, 2560)]
    + [(48, 104, c) for c in (1280, 2560)]
    + [(48, 9604, c) for c in (320, 640, 960)]
    + [(48, 2401, c) for c in (320, 640, 960, 1280, 1920)]
    + [(48, 625, c) for c in (640, 1280, 1920, 2560)]
    + [(48, 169, c) for c in (1280, 2560)])
VAE_SHAPES = [(8, 6272, 512), (8, 25088, 512), (8, 100352, 512),
              (8, 100352, 256), (8, 401408, 256), (8, 401408, 128),
              (8, 9604, 512), (8, 38416, 512), (8, 153664, 512),
              (8, 153664, 256), (8, 614656, 256), (8, 614656, 128)]
H100_SMS = 132


def _check_plan(n, s, c, sms, groups=32):
    """The stream tier's plan for (n, s, c), checked."""
    plan = G.gn_plan(n, s, c, groups, 2, sms, tier="stream")
    assert isinstance(plan, G.StreamPlan)
    blocks = G.BLOCKS_PER_SM * sms
    # a cooperative grid: every block resident at once, two an SM
    assert plan.team * plan.teams <= blocks
    assert G.BLOCKS_PER_SM * (plan.smem(c, groups) + G.BLOCK_RESERVED) \
        <= G.SM_SMEM
    assert plan.tx * plan.ty <= plan.threads <= G.MAX_THREADS
    assert plan.threads % 32 == 0
    # every (batch row, row) once: teams walk n = t, t + teams, ...; block
    # b of a team takes rows b·rows ..., none empty
    assert plan.teams == min(n, blocks)
    assert (plan.team - 1) * plan.rows < s <= plan.team * plan.rows
    seen = np.zeros(n, int)
    for t in range(plan.teams):
        seen[t::plan.teams] += 1
    assert (seen == 1).all()
    # every 8-channel vector once: thread column j takes j + k·tx, k < vpt
    vecs = [j + k * plan.tx for j in range(plan.tx) for k in range(plan.vpt)]
    assert sorted(v for v in vecs if v < c // 8) == list(range(c // 8))
    return plan


def _check_resident(s, c, groups, itemsize):
    """The resident tier's plan for (·, s, c), checked: whole groups a
    chunk, whole 16-byte vectors and >= 128 bytes a chunk row, every row
    and channel once, one shared-memory block's worth at most."""
    plan = G.gn_plan(1, s, c, groups, itemsize, H100_SMS, tier="resident")
    assert isinstance(plan, G.ResidentPlan)
    cpg = c // groups
    assert plan.cw % 8 == 0 and plan.cw % cpg == 0 and c % plan.cw == 0
    assert plan.cw * itemsize >= G.MIN_CHUNK_BYTES or plan.cw == c
    assert plan.tx == plan.cw // 8
    assert plan.tx * plan.ty <= plan.threads <= G.MAX_THREADS
    # <= 8 blocks of 48 KB, else <= 16 of 64 KB
    block = plan.rows * plan.cw * itemsize
    assert (1 <= plan.cluster <= G.MAX_CLUSTER and block <= G.SLICE_BUDGET) \
        or (plan.cluster <= G.BIG_CLUSTER and block <= G.BIG_BUDGET)
    assert plan.smem(c, groups, itemsize) <= G.BLOCK_SMEM
    # block b of a cluster: rows b·rows ..., none empty; chunk j: channels
    # j·cw ...; thread (i, t): vector t of rows i, i + ty, ...
    covered = np.zeros((s, c), int)
    for j in range(c // plan.cw):
        for b in range(plan.cluster):
            r0 = b * plan.rows
            assert r0 < s
            for i in range(plan.ty):
                for t in range(plan.tx):
                    c0 = j * plan.cw + 8 * t
                    covered[r0 + i:min(r0 + plan.rows, s):plan.ty,
                            c0:c0 + 8] += 1
    assert (covered == 1).all()
    return plan


@pytest.mark.parametrize("n,s,c", UNET3D_SHAPES + VAE_SHAPES)
def test_plan_covers_main_path_in_one_round(n, s, c):
    """Every UNet3D and VAE-decoder GroupNorm is one launch: UNet levels
    1-3 in the resident tier (x read from HBM once), at 64x98 latents in
    clusters of <= 8 blocks, level 0 (but its concat width C = 960) and the
    VAE's 64x98 frames in clusters of <= 16; the edit path's level 1
    (49x49) in clusters of 8 or 9; the rest (the edit path's level 0 too)
    in the stream tier, every batch row at once (a team each) with at
    least 90% of the grid's blocks busy."""
    plan = G.gn_plan(n, s, c, 32, 2, H100_SMS)
    if s <= 2401 or (s == 6272 and c != 960):
        assert plan == _check_resident(s, c, 32, 2)
        if s != 2401:
            assert (plan.cluster <= G.MAX_CLUSTER) == (s <= 1568)
        return
    assert plan == _check_plan(n, s, c, H100_SMS)
    assert plan.teams == n
    assert plan.team * plan.teams >= 0.9 * G.BLOCKS_PER_SM * H100_SMS


@pytest.mark.parametrize("n,s,c", [
    (48, 6272, 320), (48, 104, 1280), (8, 401408, 128), (1, 3, 2560),
])
def test_stats_chunking_covers_every_row(n, s, c):
    """The stream plan's split of a batch row's S rows between a team's
    blocks: every row in exactly one block, no empty block."""
    plan = _check_plan(n, s, c, H100_SMS)
    covered = np.zeros(s, int)
    for b in range(plan.team):
        covered[b * plan.rows:(b + 1) * plan.rows] += 1
    assert (covered == 1).all()


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("s,c,groups", [
    (1568, 640, 32), (400, 2560, 32), (104, 1280, 32), (1, 960, 32),
    (6272, 512, 32), (35 * 41, 320, 32), (130 * 7, 256, 32), (3, 2560, 32),
    (45, 24, 3), (64, 64, 8), (6272, 960, 32), (401408, 128, 32),
])
def test_resident_plan_covers_every_row_and_channel(s, c, groups, itemsize):
    """The resident plan wherever it fits, bf16 and fp32: its cover of
    rows and channels, its limits; level 0's concat width and the VAE's
    full-resolution frames never fit it, and forcing it there raises."""
    if G.resident_plan(s, c, groups, itemsize, G.BIG_BUDGET,
                       G.BIG_CLUSTER) is None:
        cw = G.chunk_width(s, c, groups, itemsize)
        assert s * cw * itemsize > G.BIG_CLUSTER * G.BIG_BUDGET
        with pytest.raises(ValueError):
            G.gn_plan(1, s, c, groups, itemsize, H100_SMS, tier="resident")
        return
    _check_resident(s, c, groups, itemsize)


def _xor_tree(v: torch.Tensor) -> torch.Tensor:
    """A warp's butterfly sum over its 32 lanes (last axis): every lane
    ends with the same total, in the kernel's order."""
    idx = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = v + v[..., idx ^ o]
    return v[..., 0]


def _lane_sum(items: torch.Tensor) -> torch.Tensor:
    """Lane l sums items l, l + 32, ... of the last axis in order, then the
    warp's butterfly."""
    k = items.shape[-1]
    pad = torch.nn.functional.pad(items, (0, -k % 32))
    lanes = pad.reshape(*items.shape[:-1], -1, 32)
    acc = torch.zeros_like(lanes[..., 0, :])
    for i in range(lanes.shape[-2]):
        acc = acc + lanes[..., i, :]
    return _xor_tree(acc)


def gn_emulated(x, scale, bias, groups, eps, silu, row_add, plan):
    """What csrc/groupnorm.cu's stream tier computes for the (N, S, C) x
    under ``plan``,
    sum by sum in its order: a thread's rows in order, the thread rows of
    a channel in order, a warp per group over its channels, the last block
    over the team's slots; then mul / add per channel and one rounding."""
    n, s, c = x.shape
    cpg = c // groups
    out = torch.empty_like(x)
    for b in range(n):
        xa = x[b].float()
        if row_add is not None:
            xa = xa + row_add[b].float()
        # (team, rows, C), past S zero: a thread adds nothing there
        xa = torch.nn.functional.pad(xa, (0, 0, 0, plan.team * plan.rows - s))
        blocks = xa.reshape(plan.team, plan.rows, c)
        steps = -(-plan.rows // plan.ty)
        blocks = torch.nn.functional.pad(
            blocks, (0, 0, 0, steps * plan.ty - plan.rows))
        acc_s = torch.zeros(plan.team, plan.ty, c)
        acc_q = torch.zeros(plan.team, plan.ty, c)
        for i in range(steps):
            rows = blocks[:, i * plan.ty:(i + 1) * plan.ty]
            acc_s = acc_s + rows
            acc_q = acc_q + rows * rows
        ch_s, ch_q = acc_s[:, 0], acc_q[:, 0]
        for y in range(1, plan.ty):
            ch_s, ch_q = ch_s + acc_s[:, y], ch_q + acc_q[:, y]
        part_s = _lane_sum(ch_s.reshape(plan.team, groups, cpg))
        part_q = _lane_sum(ch_q.reshape(plan.team, groups, cpg))
        tot_s = _lane_sum(part_s.t())
        tot_q = _lane_sum(part_q.t())
        count = torch.tensor(float(s * cpg))
        mean = tot_s / count
        rstd = torch.rsqrt(tot_q / count - mean * mean + eps)
        g = torch.arange(c) // cpg
        mul = rstd[g] * scale.float()
        add = bias.float() - mean[g] * mul
        if row_add is not None:
            add = add + row_add[b].float() * mul
        y = x[b].float() * mul + add
        if silu:
            y = y / (1.0 + torch.exp(-y))
        out[b] = y.to(x.dtype)
    return out


def _emulate(x, scale, bias, groups, eps, silu, row_add, sms):
    n, c = x.shape[0], x.shape[-1]
    s = x.size // (n * c)
    plan = G.gn_plan(n, s, c, groups, 4, sms, tier="stream")
    return plan, nn(gn_emulated(
        tt(x.reshape(n, s, c)), tt(scale), tt(bias), groups, eps, silu,
        None if row_add is None else tt(row_add), plan)).reshape(x.shape)


# sms: the H100's 132 (a team of many blocks a batch row); 1, where teams
# of one or two blocks walk several batch rows
@pytest.mark.parametrize("sms", [H100_SMS, 1])
@pytest.mark.parametrize("shape,groups,eps,radd,silu", CASES)
def test_emulated_kernel_matches_plain(shape, groups, eps, radd, silu, sms):
    x, scale, bias, row_add = _inputs(shape, radd, 5)
    _, got = _emulate(x, scale, bias, groups, eps, silu, row_add, sms)
    want = _port(x, scale, bias, groups, eps, silu, row_add)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("shape,groups,eps,radd,silu", CASES)
def test_emulated_kernel_matches_pallas(shape, groups, eps, radd, silu):
    """The emulation against the three Pallas variants in interpret mode."""
    x, scale, bias, row_add = _inputs(shape, radd, 6)
    n, c = shape[0], shape[-1]
    s = x.size // (n * c)
    _, got = _emulate(x, scale, bias, groups, eps, silu, row_add, H100_SMS)
    ja = [jnp.asarray(scale), jnp.asarray(bias), groups, eps, silu]
    radd_j = None if row_add is None else jnp.asarray(row_add)
    x3 = jnp.asarray(x.reshape(n, s, c))
    with pltpu.force_tpu_interpret_mode():
        refs = [JG._gn_pallas(x3, *ja, force_two_phase=two, row_add=radd_j)
                for two in (False, True)]
        y_t = JG._gn_pallas_snc(jnp.transpose(x3, (1, 0, 2)), *ja,
                                row_add=radd_j)
    refs.append(jnp.transpose(y_t, (1, 0, 2)))
    for ref in refs:
        np.testing.assert_allclose(got, np.asarray(ref).reshape(shape),
                                   atol=ATOL)


def gn_resident_emulated(x, scale, bias, groups, eps, silu, row_add, plan):
    """What csrc/groupnorm.cu's resident tier computes for the (N, S, C) x
    under ``plan``, sum by sum in its order: a thread's rows of its block
    in order, the thread rows of a channel in order, a warp per group over
    its channels, then the cluster's blocks in rank order; then mul / add
    per channel and one rounding."""
    n, s, c = x.shape
    cpg = c // groups
    k, rows, ty = plan.cluster, plan.rows, plan.ty
    xa = x.float()
    if row_add is not None:
        xa = xa + row_add.float()[:, None, :]
    # (n, block, rows, C), past S zero: a thread adds nothing there
    xa = torch.nn.functional.pad(xa, (0, 0, 0, k * rows - s))
    steps = -(-rows // ty)
    blocks = torch.nn.functional.pad(xa.reshape(n, k, rows, c),
                                     (0, 0, 0, steps * ty - rows))
    blocks = blocks.reshape(n, k, steps, ty, c)
    acc_s = torch.zeros(n, k, ty, c)
    acc_q = torch.zeros(n, k, ty, c)
    for i in range(steps):
        acc_s = acc_s + blocks[:, :, i]
        acc_q = acc_q + blocks[:, :, i] * blocks[:, :, i]
    ch_s, ch_q = acc_s[:, :, 0], acc_q[:, :, 0]
    for y in range(1, ty):
        ch_s, ch_q = ch_s + acc_s[:, :, y], ch_q + acc_q[:, :, y]
    # a chunk is whole groups, so a block's partial of a group is over
    # that group's channels alone
    part_s = _lane_sum(ch_s.reshape(n, k, groups, cpg))
    part_q = _lane_sum(ch_q.reshape(n, k, groups, cpg))
    tot_s, tot_q = torch.zeros(n, groups), torch.zeros(n, groups)
    for b in range(k):
        tot_s, tot_q = tot_s + part_s[:, b], tot_q + part_q[:, b]
    count = torch.tensor(float(s) * float(cpg))
    mean = tot_s / count
    rstd = torch.rsqrt(tot_q / count - mean * mean + eps)
    g = torch.arange(c) // cpg
    mul = rstd[:, g] * scale.float()
    add = bias.float() - mean[:, g] * mul
    if row_add is not None:
        add = add + row_add.float() * mul
    y = x.float() * mul[:, None, :] + add[:, None, :]
    if silu:
        y = y / (1.0 + torch.exp(-y))
    return y.to(x.dtype)


def _emulate_resident(x, scale, bias, groups, eps, silu, row_add, itemsize):
    n, c = x.shape[0], x.shape[-1]
    s = x.size // (n * c)
    plan = G.gn_plan(n, s, c, groups, itemsize, H100_SMS, tier="resident")
    return plan, nn(gn_resident_emulated(
        tt(x.reshape(n, s, c)), tt(scale), tt(bias), groups, eps, silu,
        None if row_add is None else tt(row_add), plan)).reshape(x.shape)


# itemsize: the chunk of a bf16 (2) or an fp32 (4) call, which differ
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("shape,groups,eps,radd,silu", CASES)
def test_resident_emulated_matches_plain(shape, groups, eps, radd, silu,
                                         itemsize):
    x, scale, bias, row_add = _inputs(shape, radd, 7)
    plan, got = _emulate_resident(x, scale, bias, groups, eps, silu, row_add,
                                  itemsize)
    want = _port(x, scale, bias, groups, eps, silu, row_add)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_resident_emulation_spans_clusters():
    """A slice cut over a cluster of several blocks (the budget made
    small), each block's rows split over its thread rows with a ragged
    last block, against the plain version."""
    x, scale, bias, row_add = _inputs((2, 37, 9, 320), True, 8)
    n, s, c = 2, 37 * 9, 320
    plan = G.gn_plan(n, s, c, 32, 4, H100_SMS, tier="resident", budget=7000)
    assert plan.cluster == 8 and plan.cluster * plan.rows > s
    got = nn(gn_resident_emulated(tt(x.reshape(n, s, c)), tt(scale),
                                  tt(bias), 32, 1e-5, True, tt(row_add),
                                  plan)).reshape(x.shape)
    want = _port(x, scale, bias, 32, 1e-5, True, row_add)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("shape,groups,eps,radd,silu", CASES)
def test_resident_emulated_matches_pallas(shape, groups, eps, radd, silu):
    """The resident tier's emulation against the three Pallas variants in
    interpret mode."""
    x, scale, bias, row_add = _inputs(shape, radd, 9)
    n, c = shape[0], shape[-1]
    s = x.size // (n * c)
    _, got = _emulate_resident(x, scale, bias, groups, eps, silu, row_add, 2)
    ja = [jnp.asarray(scale), jnp.asarray(bias), groups, eps, silu]
    radd_j = None if row_add is None else jnp.asarray(row_add)
    x3 = jnp.asarray(x.reshape(n, s, c))
    with pltpu.force_tpu_interpret_mode():
        refs = [JG._gn_pallas(x3, *ja, force_two_phase=two, row_add=radd_j)
                for two in (False, True)]
        y_t = JG._gn_pallas_snc(jnp.transpose(x3, (1, 0, 2)), *ja,
                                row_add=radd_j)
    refs.append(jnp.transpose(y_t, (1, 0, 2)))
    for ref in refs:
        np.testing.assert_allclose(got, np.asarray(ref).reshape(shape),
                                   atol=ATOL)


def test_wrapper_counts_only_kernel_launches():
    x, scale, bias, _ = _inputs((2, 4, 4, 64), False, 4)
    before = G.group_norm_fused.launches
    G.group_norm_fused(tt(x), tt(scale), tt(bias), 8, 1e-5)
    assert G.group_norm_fused.launches == before
