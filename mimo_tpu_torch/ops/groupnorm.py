"""Fused GroupNorm (+ per-row add, + SiLU): the CUDA kernels in
``csrc/groupnorm.cu``, their launch plans and the plain PyTorch version.

Counterpart of ``mimo_tpu/ops/groupnorm.py`` (``group_norm_fused`` and its
three Pallas variants). Statistics are fp32 per (batch row, group) over
every non-channel axis, with var = E[x²] − E[x]²; the affine is fp32; SiLU
runs in fp32 before the single cast back; the optional (N, C) ``row_add``
(the resnet time-embedding add) joins x before the statistics.

One launch a call, in one of two tiers that ``gn_plan`` picks:

- *resident*, where the slice of a batch row and a chunk of whole groups
  fits a cluster of at most ``MAX_CLUSTER`` blocks of ``SLICE_BUDGET``
  bytes each (UNet levels 1-3), or else of ``BIG_CLUSTER`` blocks of
  ``BIG_BUDGET`` bytes (UNet level 0 but its concat width C = 960, the
  VAE's 64x98 frames): the cluster holds the slice in shared memory, adds
  its blocks' partial sums through distributed shared memory and
  normalises from shared memory, so x is read from HBM once;
- *stream*, elsewhere (level 0 at C = 960, the VAE's larger frames): a
  cooperative launch of co-resident blocks, a team of blocks a batch row,
  each block summing its share of the row's S rows and then, once the
  last block of the team has published the statistics, reading it again
  to normalise it.

``group_norm_fused`` takes the plain version for CPU tensors only. For a
CUDA tensor it launches the kernel or raises. ``group_norm_fused.launches``
counts kernel launches.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from mimo_tpu_torch.ops import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# csrc/groupnorm.cu: threads a block at most (kMaxThreads) and the blocks
# an SM holds at once in the stream tier (its __launch_bounds__), so every
# block of the cooperative grid is resident together
MAX_THREADS = 512
BLOCKS_PER_SM = 2
# the thread rows a block aims for: tx * ty near this many threads (the
# stream tier, the resident tier)
TARGET_THREADS = 256
RESIDENT_THREADS = 128
# shared memory of an H100 SM, the part the system keeps per block, and the
# most one block may take
SM_SMEM = 233472
BLOCK_RESERVED = 1024
BLOCK_SMEM = 232448
# the resident tier: blocks a cluster at most (the portable limit), bytes of
# the slice a block holds at most (3-5 blocks an SM with their scratch), and
# the fewest bytes of a chunk's row (whole 32-byte sectors for a warp)
MAX_CLUSTER = 8
SLICE_BUDGET = 48 * 1024
MIN_CHUNK_BYTES = 128
# where that does not fit: clusters of up to 16 blocks (a size the card
# allows only on request, one GPC's SMs) of up to 64 KB each (UNet level 0)
BIG_CLUSTER = 16
BIG_BUDGET = 64 * 1024


def group_norm_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     groups: int, eps: float, fuse_silu: bool = False,
                     row_add: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GroupNorm over the trailing channel axis of an (N, ..., C) tensor."""
    n, c = x.shape[0], x.shape[-1]
    xf = x.float()
    if row_add is not None:
        xf = xf + row_add.float().reshape(n, *([1] * (x.dim() - 2)), c)
    xg = xf.reshape(n, -1, groups, c // groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = xg.square().mean(dim=(1, 3), keepdim=True) - mean.square()
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    y = y * scale.float() + bias.float()
    if fuse_silu:
        y = F.silu(y)
    return y.to(x.dtype)


class StreamPlan(NamedTuple):
    """How the stream tier cuts an (N, S, C) call. A block's threads are
    ``ty`` rows of ``tx`` threads; thread (i, j) takes 8-channel vectors
    j, j + tx, … (``vpt`` of them, those below C/8) of the block's rows
    i, i + ty, …. A team of ``team`` blocks walks batch rows
    n = t, t + teams, …; block b of a team takes rows b·rows … of each."""

    tx: int
    ty: int
    vpt: int
    team: int
    teams: int
    rows: int

    @property
    def threads(self) -> int:
        """Threads a block (a whole number of warps)."""
        return -(-self.tx * self.ty // 32) * 32

    def smem(self, c: int, groups: int) -> int:
        """Dynamic shared memory of a block (csrc/groupnorm.cu: smem_bytes):
        the (ty, 2C) fp32 scratch of the per-channel sums and 2G fp32
        statistics."""
        return self.ty * 2 * c * 4 + -(-2 * groups * 4 // 16) * 16


class ResidentPlan(NamedTuple):
    """How the resident tier cuts an (N, S, C) call: a cluster of
    ``cluster`` blocks a (batch row, chunk of ``cw`` channels), block b of
    it holding rows b·rows … of the chunk; a block's threads are ``ty``
    rows of ``tx`` = cw/8 threads, thread (i, j) taking vector j of the
    block's rows i, i + ty, …."""

    cw: int
    cluster: int
    rows: int
    tx: int
    ty: int

    @property
    def threads(self) -> int:
        """Threads a block (a whole number of warps)."""
        return -(-self.tx * self.ty // 32) * 32

    def smem(self, c: int, groups: int, itemsize: int) -> int:
        """Dynamic shared memory of a block (csrc/groupnorm.cu:
        res_smem_bytes): the (rows, cw) slice, the (ty, 2cw) fp32 scratch
        and the chunk's 2 × cw/(C/G) fp32 partials."""
        def a16(b):
            return -(-b // 16) * 16
        return (a16(self.rows * self.cw * itemsize) + self.ty * 2 * self.cw * 4
                + a16(2 * (self.cw // (c // groups)) * 4))


GNPlan = Union[ResidentPlan, StreamPlan]


def _thread_rows(tx: int, threads: int = TARGET_THREADS) -> int:
    return max(1, min(MAX_THREADS // tx, round(threads / tx)))


def chunk_width(s: int, c: int, groups: int, itemsize: int,
                budget: int = SLICE_BUDGET, widen: bool = True) -> int:
    """The resident tier's chunk: the fewest whole groups whose channels
    are a multiple of 8 and take at least MIN_CHUNK_BYTES a row (all of C
    where no narrower chunk does); with ``widen``, where that chunk's s rows
    fit one block's ``budget``, the widest such chunk that still does
    (fewer, larger blocks: each block's barriers and sums cost the same
    whatever its size)."""
    cpg = c // groups
    unit = cpg * 8 // math.gcd(cpg, 8)
    widths = [cw for cw in range(unit, c + 1, unit)
              if c % cw == 0 and (cw * itemsize >= MIN_CHUNK_BYTES or cw == c)
              and cw // 8 <= MAX_THREADS]
    if not widths:
        return c
    fits = [cw for cw in widths if s * cw * itemsize <= budget]
    return fits[-1] if widen and fits else widths[0]


def resident_plan(s: int, c: int, groups: int, itemsize: int,
                  budget: int = SLICE_BUDGET, max_cluster: int = MAX_CLUSTER,
                  widen: bool = True, threads: int = RESIDENT_THREADS
                  ) -> Optional[ResidentPlan]:
    """The resident tier's plan for rows of s × c values, or None where a
    batch row's chunk does not fit ``max_cluster`` blocks of ``budget``
    bytes (or a block's shared memory)."""
    cw = chunk_width(s, c, groups, itemsize, budget, widen)
    tx = cw // 8
    if tx > MAX_THREADS:
        return None
    cluster = -(-s * cw * itemsize // budget)
    if cluster > max_cluster:
        return None
    rows = -(-s // cluster)
    plan = ResidentPlan(cw, -(-s // rows), rows, tx, _thread_rows(tx, threads))
    if plan.smem(c, groups, itemsize) > BLOCK_SMEM:
        return None
    return plan


def stream_plan(n: int, s: int, c: int, sms: int) -> StreamPlan:
    """The stream tier's plan for an (n, s, c) tensor on a card of ``sms``
    SMs: a team a batch row while the grid has blocks for them all (else
    teams walk several), each team as large as the grid allows, so every
    SM streams; a thread row of tx = C/8 threads (vpt vectors a thread past
    MAX_THREADS), ty thread rows near TARGET_THREADS threads."""
    vecs = c // 8
    vpt = -(-vecs // MAX_THREADS)
    tx = -(-vecs // vpt)
    blocks = BLOCKS_PER_SM * sms
    teams = min(n, blocks)
    team = max(1, min(s, blocks // teams))
    rows = -(-s // team)
    team = -(-s // rows)
    return StreamPlan(tx, _thread_rows(tx), vpt, team, teams, rows)


@lru_cache(maxsize=None)
def gn_plan(n: int, s: int, c: int, groups: int, itemsize: int, sms: int,
            tier: Optional[str] = None, budget: int = SLICE_BUDGET,
            max_cluster: int = MAX_CLUSTER, widen: bool = True,
            threads: int = RESIDENT_THREADS) -> GNPlan:
    """The plan for GroupNorm of an (n, s, c) tensor of ``itemsize``-byte
    values: the resident tier where it fits (``resident_plan``: ``budget``
    bytes a block in clusters of up to ``max_cluster`` blocks, else
    BIG_BUDGET in clusters of up to BIG_CLUSTER), else the stream tier.
    ``tier`` ("resident" or "stream") forces one, for timing the tiers
    against each other; a resident tier that does not fit raises."""
    res = resident_plan(s, c, groups, itemsize, budget, max_cluster, widen,
                        threads)
    if res is None:
        res = resident_plan(s, c, groups, itemsize, BIG_BUDGET, BIG_CLUSTER,
                            widen, threads)
    if tier == "resident" and res is None:
        raise ValueError(f"group norm: ({n}, {s}, {c}) does not fit the "
                         f"resident tier")
    if tier == "stream" or res is None:
        return stream_plan(n, s, c, sms)
    return res


class _Workspace(NamedTuple):
    """What a call's blocks share through global memory: ``teams`` arrival
    counters (all zero between calls: the kernel leaves them so), as many
    flags, and fp32 room for the partials and statistics."""

    counters: torch.Tensor
    floats: torch.Tensor


# (device index, stream) -> its calls' workspace (calls on one stream run
# one after another, so they share it)
_WORKSPACES: Dict[Tuple[int, int], _Workspace] = {}


def _workspace(dev: torch.device, stream: int, teams: int,
               floats: int) -> _Workspace:
    key = (dev.index, stream)
    ws = _WORKSPACES.get(key)
    if ws is None or ws.counters.numel() < 2 * teams \
            or ws.floats.numel() < floats:
        blocks = BLOCKS_PER_SM * _build.sm_count(dev)
        ws = _Workspace(
            torch.zeros(2 * max(teams, blocks), dtype=torch.int32, device=dev),
            torch.empty(max(floats, 2 * blocks * 64), dtype=torch.float32,
                        device=dev))
        _WORKSPACES[key] = ws
    return ws


def group_norm_cuda(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    groups: int, eps: float, fuse_silu: bool = False,
                    row_add: Optional[torch.Tensor] = None,
                    plan: Optional[GNPlan] = None) -> torch.Tensor:
    """One launch of the kernel on CUDA tensors under ``plan`` (by default
    ``gn_plan``'s); counts nothing (``group_norm_fused`` does)."""
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"group norm kernel takes float32 or bfloat16, got "
                         f"{x.dtype}")
    n, c = x.shape[0], x.shape[-1]
    if c % 8 or c % groups:
        raise ValueError(f"group norm kernel needs C % 8 == 0 and "
                         f"C % groups == 0 (C={c}, groups={groups})")
    xc = x.contiguous()
    if xc.data_ptr() % 16:
        xc = xc.clone()
    y = torch.empty_like(xc)
    s = xc.numel() // (n * c)
    if xc.numel() == 0:
        return y
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    scale_f = scale.to(**f32).contiguous()
    bias_f = bias.to(**f32).contiguous()
    radd = None
    if row_add is not None:
        radd = row_add.reshape(n, c).to(**f32).contiguous()
    if plan is None:
        plan = gn_plan(n, s, c, groups, xc.element_size(),
                       _build.sm_count(dev))
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _build.load_library()
    args = (xc.data_ptr(), radd.data_ptr() if radd is not None else None,
            scale_f.data_ptr(), bias_f.data_ptr(), y.data_ptr())
    shape = (_DTYPE_CODE[x.dtype], n, s, c, groups, float(eps),
             int(fuse_silu))
    if isinstance(plan, ResidentPlan):
        err = lib.mimo_group_norm_resident_fwd(
            *args, *shape, plan.cw, plan.cluster, plan.rows, plan.ty, stream)
        _build.check(err, "group_norm_fused")
        return y
    if plan.smem(c, groups) > SM_SMEM // BLOCKS_PER_SM - BLOCK_RESERVED:
        raise ValueError(f"group norm kernel: C={c} needs "
                         f"{plan.smem(c, groups)} bytes of shared memory a "
                         f"block, more than {BLOCKS_PER_SM} blocks an SM "
                         f"leave")
    # the partials (teams, team, 2G), then the statistics (teams, 2G)
    part_n = plan.teams * plan.team * 2 * groups
    ws = _workspace(dev, stream, plan.teams,
                    part_n + plan.teams * 2 * groups)
    floats, counters = ws.floats.data_ptr(), ws.counters.data_ptr()
    err = lib.mimo_group_norm_fwd(
        *args, floats, floats + 4 * part_n, counters,
        counters + 2 * ws.counters.numel(), *shape, *plan, stream)
    _build.check(err, "group_norm_fused")
    return y


def group_norm_fused(x: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, groups: int, eps: float,
                     fuse_silu: bool = False,
                     row_add: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GN(+SiLU) of x + row_add[:, None, ..., :] over an (N, ..., C)
    tensor, same shape and dtype out."""
    if not x.is_cuda:
        return group_norm_plain(x, scale, bias, groups, eps, fuse_silu,
                                row_add)
    y = group_norm_cuda(x, scale, bias, groups, eps, fuse_silu, row_add)
    group_norm_fused.launches += 1
    return y


group_norm_fused.launches = 0
