"""The GEMM-chain ops of the transformer and motion blocks: the CUDA tile
core in ``csrc/gemm.cu``, the LayerNorm row pass in ``csrc/ln_rows.cu``
and the plain PyTorch version of each op.

Counterpart of ``mimo_tpu/ops/ffn.py``. Every Pallas kernel there becomes one
or two launches of one GEMM kernel with a bias, bias + residual or GEGLU
epilogue, after the LayerNorm row pass (``ln_rows``) where the kernel
starts with a LayerNorm:

- ``ffn_ln_geglu_fused``: ``x + W_d·(h·gelu_erf(g)) + b_d`` with
  ``[h ‖ g] = W_u·LN(x) + b_u`` (``_ffn_pallas_nsc``/``_snc``): an
  LN + GEGLU launch writes the (R, inner) gated activation, a bias +
  residual launch the result;
- ``qkv_ln_fused``: LN, then one bias-free (C, 3C) product
  (``_qkv_ln_pallas``/``_snc``);
- ``matmul_bias_residual``: ``res + x·W + b`` (``_matmul_res_pallas``/``_snc``);
- ``matmul_bias``: ``x·W + b`` (``_matmul_pallas``/``_snc``).

The tile core reads each weight as a K-major copy cut into tiles
(``prepare_weight``), made once per parameter and kept while the parameter
lives unchanged. The plain versions read the parameter tree as it is.

The SNC layout variants existed for XLA's conv layouts and have no
counterpart: PyTorch hands the token tensors over row-major.

Numerics are those of the unfused composition, which the plain versions
compute: LN statistics and affine in fp32, rounded to the activation dtype;
each product rounded before its bias; bias, residual and gate applied in
the activation dtype; exact (erf) gelu in fp32.

Each wrapper takes its plain version for CPU tensors only. For a CUDA tensor
it launches the kernel or raises; ``<wrapper>.launches`` counts the calls
that launched it (``ln_rows.launches`` counts the LN passes, its own and
those ``gemm`` runs).
"""

from __future__ import annotations

import weakref
from functools import lru_cache
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from mimo_tpu_torch.models.layers import geglu_ff, layer_norm, linear
from mimo_tpu_torch.ops import _build

Params = Dict[str, Any]

_EPI_BIAS, _EPI_BIAS_RES, _EPI_GEGLU = 0, 1, 2


# ---------------------------------------------------------------------------
# plain versions (the unfused composition)
# ---------------------------------------------------------------------------


def ffn_ln_geglu_plain(x: torch.Tensor, ln_p: Params, ff_p: Params,
                       eps: float = 1e-5) -> torch.Tensor:
    return x + geglu_ff(ff_p, layer_norm(ln_p, x, eps))


def qkv_ln_plain(x: torch.Tensor, ln_p: Params, attn_p: Params,
                 eps: float = 1e-5) -> Tuple[torch.Tensor, ...]:
    norm = layer_norm(ln_p, x, eps)
    return tuple(linear(attn_p[k], norm) for k in ("to_q", "to_k", "to_v"))


def matmul_bias_residual_plain(x: torch.Tensor, lin_p: Params,
                               res: torch.Tensor) -> torch.Tensor:
    return res + linear(lin_p, x)


def matmul_bias_plain(x: torch.Tensor, lin_p: Params) -> torch.Tensor:
    return linear(lin_p, x)


def ln_rows_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  eps: float, pe: Optional[torch.Tensor] = None,
                  pe_div: int = 1) -> torch.Tensor:
    """LayerNorm of each row of x (..., K), rounded to x's dtype, then + the
    PE row (pe (F, K)) of its frame: row r of the (R, K) view belongs to
    frame (r // pe_div) % F."""
    y = layer_norm({"scale": scale, "bias": bias}, x, eps)
    if pe is None:
        return y
    k = x.shape[-1]
    frames = (torch.arange(y.numel() // k, device=x.device) // pe_div) \
        % pe.shape[0]
    return (y.reshape(-1, k) + pe.to(y.dtype)[frames]).reshape(y.shape)


# ---------------------------------------------------------------------------
# the prepared weight: what the CUDA tile core reads
# ---------------------------------------------------------------------------

# weight rows of a tile, the wgmma N (kBN in csrc/gemm.cu): for GEGLU 80
# value columns and their 80 gate columns
TILE_N = 160


def col_tiles(n: int, geglu: bool = False) -> int:
    """Tiles across n output columns (value columns with ``geglu``). Every
    N of the main path is a whole number of tiles; other N pad the last."""
    return -(-n // (TILE_N // 2 if geglu else TILE_N))


def prepare_weight(ws: Sequence[torch.Tensor],
                   geglu: bool = False) -> torch.Tensor:
    """The weight as the tile core reads it: the (K, ·) weights ``ws``
    side by side (q|k|v), transposed to K-major (col_tiles·TILE_N, K) and
    zero-padded to whole tiles. For GEGLU (``ws`` one (K, 2n) [value |
    gate] weight) tile j holds value columns j·TILE_N/2 …
    (j+1)·TILE_N/2 − 1, then their gate columns, so one load brings
    both."""
    w = torch.cat(list(ws), dim=1) if len(ws) > 1 else ws[0]
    k = w.shape[0]
    if geglu:
        n, cols = w.shape[1] // 2, TILE_N // 2
        parts = (w[:, :n], w[:, n:])
    else:
        n, cols = w.shape[1], TILE_N
        parts = (w,)
    tiles = col_tiles(n, geglu)
    parts = [F.pad(p, (0, tiles * cols - n)).reshape(k, tiles, 1, cols)
             for p in parts]
    return torch.cat(parts, dim=2).reshape(k, tiles * TILE_N).t().contiguous()


# (tag, id of each source) -> (weak refs, versions, derived tensor)
_DERIVED: Dict[tuple, tuple] = {}


def _once(tensors: Sequence[torch.Tensor], tag, build):
    """build(), once per set of source tensors and tag: the result is kept
    while the sources live and stay unchanged (same objects, same
    ``_version``), so each parameter is prepared once, not per call.
    Inference tensors keep no version, so a change made in place could not
    be seen: they are refused (make parameters outside inference mode)."""
    for t in tensors:
        if t.is_inference():
            raise ValueError(
                "gemm kernel: a weight or vector the kernel reads in its own "
                "layout is an inference tensor, whose in-place changes cannot "
                "be tracked; create the parameters outside "
                "torch.inference_mode")
    key = (tag,) + tuple(id(t) for t in tensors)
    versions = tuple(t._version for t in tensors)
    hit = _DERIVED.get(key)
    if (hit is not None and hit[1] == versions
            and all(r() is t for r, t in zip(hit[0], tensors))):
        return hit[2]
    value = build()
    refs = tuple(weakref.ref(t, lambda _, key=key: _DERIVED.pop(key, None))
                 for t in tensors)
    _DERIVED[key] = (refs, versions, value)
    return value


# ---------------------------------------------------------------------------
# the LN row pass's plan (csrc/ln_rows.cu)
# ---------------------------------------------------------------------------

# lanes that share a row, and vectors (8 bf16) a lane holds at most
LN_LANES = (8, 16, 32)
LN_MAX_VECTORS = 6
LN_WARPS = 8              # warps a block (kThreads / 32)
LN_BLOCKS_PER_SM = 2      # its __launch_bounds__
LN_SHORT_RUNS = 12        # runs of the grid's row steps below which a
                          # call takes the wide-row kernel


class LnPlan(NamedTuple):
    """How ``ln_rows`` cuts an (m, k) call: ``lanes`` lanes share a row,
    lane l of a row holding its vectors l, l + lanes, … (``vectors`` of
    them, 0 for the wide-row kernel that reads a row twice); a warp takes
    32 / lanes rows a step and walks ``steps_per_warp`` steps;
    ``blocks`` blocks of LN_WARPS warps."""

    lanes: int
    vectors: int
    steps_per_warp: int
    blocks: int


@lru_cache(maxsize=None)
def ln_rows_plan(m: int, k: int, sms: int,
                 short_runs: int = LN_SHORT_RUNS) -> LnPlan:
    """The LN row pass's plan for m rows of k values on ``sms`` SMs: the
    (lanes, vectors) that cover k/8 vectors with the fewest idle slots (then
    the most vectors a lane), and a grid two blocks an SM deep whose warps
    take equal runs of row steps. A call of at most ``short_runs`` such
    grids of steps (UNet levels 2-3), and rows past 32 × LN_MAX_VECTORS
    vectors, take the wide-row kernel instead: a warp a row, many blocks an
    SM, which there beats the register kernel's two blocks an SM (each row
    read from HBM once, then again from L1)."""
    vecs = k // 8
    wide = LnPlan(32, 0, 1, -(-m // LN_WARPS))
    if vecs > LN_LANES[-1] * LN_MAX_VECTORS:
        return wide
    lanes, vectors = min(
        ((lanes, -(-vecs // lanes)) for lanes in LN_LANES
         if -(-vecs // lanes) <= LN_MAX_VECTORS),
        key=lambda lv: (lv[0] * lv[1] - vecs, lv[0]))
    steps = -(-m // (32 // lanes))
    grid_warps = LN_BLOCKS_PER_SM * LN_WARPS * sms
    if steps <= short_runs * grid_warps:
        return wide
    per = -(-steps // min(steps, grid_warps))
    warps = -(-steps // per)
    return LnPlan(lanes, vectors, per, -(-warps // LN_WARPS))


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------


def _rows(x: torch.Tensor, what: str) -> torch.Tensor:
    """x as a row-major (R, K) bf16 CUDA matrix the kernel can read."""
    if not x.is_cuda or x.dtype != torch.bfloat16:
        raise ValueError(f"gemm kernel: {what} must be a bfloat16 CUDA tensor, "
                         f"got {x.dtype} on {x.device}")
    x2 = x.reshape(-1, x.shape[-1])
    if x2.stride(1) != 1 or x2.stride(0) % 8 or x2.data_ptr() % 16:
        x2 = x2.contiguous()
    return x2


def _vec(t: Optional[torch.Tensor], n: int, dev) -> Optional[torch.Tensor]:
    """A bias / LN / PE tensor as the kernel reads it: bf16, contiguous,
    on ``dev`` (converted once per parameter where it is not)."""
    if t is None:
        return None
    if t.shape[-1] != n:
        raise ValueError(f"gemm kernel: vector of {t.shape[-1]} values, "
                         f"expected {n}")
    if t.device == dev and t.dtype == torch.bfloat16 and t.is_contiguous():
        return t
    return _once((t,), ("vec", dev),
                 lambda: t.to(device=dev, dtype=torch.bfloat16).contiguous())


def ln_rows_cuda(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                 eps: float, pe: Optional[torch.Tensor] = None,
                 pe_div: int = 1, plan: Optional[LnPlan] = None
                 ) -> torch.Tensor:
    """One launch of the kernel of ``csrc/ln_rows.cu`` on a bf16 CUDA x
    (..., K) (rows may be strided) under ``plan`` (by default
    ``ln_rows_plan``'s), into a new contiguous bf16 tensor of x's shape;
    counts nothing (``ln_rows`` does)."""
    x2 = _rows(x, "x")
    r, k = x2.shape
    if k % 8 or r == 0:
        raise ValueError(f"ln_rows kernel: needs rows and K % 8 == 0, got "
                         f"{tuple(x.shape)}")
    dev = x2.device
    scale_c, bias_c = _vec(scale, k, dev), _vec(bias, k, dev)
    pe_c = None
    if pe is not None:
        if pe.dim() != 2 or pe_div < 1:
            raise ValueError("ln_rows kernel: pe must be (F, K), pe_div >= 1")
        pe_c = _vec(pe, k, dev)
    if plan is None:
        plan = ln_rows_plan(r, k, _build.sm_count(dev))
    y = torch.empty((r, k), dtype=torch.bfloat16, device=dev)
    err = _build.load_library().mimo_ln_rows_fwd(
        x2.data_ptr(), x2.stride(0), r, k, scale_c.data_ptr(),
        bias_c.data_ptr(), float(eps),
        pe_c.data_ptr() if pe_c is not None else None, int(pe_div),
        pe_c.shape[0] if pe_c is not None else 1, y.data_ptr(), *plan,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "ln_rows")
    return y.reshape(x.shape)


def ln_rows(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
            eps: float, pe: Optional[torch.Tensor] = None,
            pe_div: int = 1) -> torch.Tensor:
    """``ln_rows_plain`` of x (..., K): on the card the kernel
    (``ln_rows_cuda``, x bf16), the plain version for a CPU tensor."""
    if not x.is_cuda:
        return ln_rows_plain(x, scale, bias, eps, pe, pe_div)
    y = ln_rows_cuda(x, scale, bias, eps, pe, pe_div)
    ln_rows.launches += 1
    return y


def gemm(a: torch.Tensor, w, *, bias: Optional[torch.Tensor] = None,
         res: Optional[torch.Tensor] = None, geglu: bool = False,
         ln: Optional[Tuple[torch.Tensor, torch.Tensor, float]] = None,
         pe: Optional[torch.Tensor] = None, pe_div: int = 1) -> torch.Tensor:
    """(R, n) = epilogue(prologue(a) · w) through ``mimo_gemm_fwd``: the
    tile core, after ``ln_rows`` when ``ln`` is given.

    a: (..., K) bf16 CUDA; w: (K, n), a tuple of (K, ·) weights read side
    by side, or (K, 2n) with ``geglu`` (value columns, then gate columns),
    all bf16 CUDA, in the JAX layout (the K-major copy the core reads is
    made once per weight); ``ln = (scale, bias, eps)`` normalises each row
    of a first (into an (R, K) workspace); ``pe`` (F, K) is added to the
    normalised row r, which belongs to frame (r // pe_div) % F. Epilogue:
    + bias, + bias + res (res (R, n)), or GEGLU with bias (2n,)."""
    if pe is not None and ln is None:
        raise ValueError("gemm kernel: pe needs ln")
    a2 = _rows(a, "a")
    if ln is not None:
        a2 = ln_rows(a2, ln[0], ln[1], ln[2], pe, pe_div)
    r, k = a2.shape
    ws = tuple(w) if isinstance(w, (tuple, list)) else (w,)
    for t in ws:
        if not t.is_cuda or t.dtype != torch.bfloat16 or t.dim() != 2 \
                or t.shape[0] != k:
            raise ValueError(f"gemm kernel: weight {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}; expected bf16 CUDA "
                             f"({k}, ·)")
    n_cols = sum(t.shape[1] for t in ws)
    n = n_cols // 2 if geglu else n_cols
    if k % 8 or n % 8:
        raise ValueError(f"gemm kernel: K={k} and N={n} must be multiples of 8")
    dev = a2.device
    wp = _once(ws, ("tiles", geglu), lambda: prepare_weight(ws, geglu))
    bias_c = _vec(bias, 2 * n if geglu else n, dev)
    res2 = None
    if res is not None:
        res2 = _rows(res, "res")
        if res2.shape != (r, n):
            raise ValueError(f"gemm kernel: residual {tuple(res.shape)} does "
                             f"not match the ({r}, {n}) output")
    if geglu and bias_c is None:
        raise ValueError("gemm kernel: the GEGLU epilogue needs its bias")
    epi = _EPI_GEGLU if geglu else (_EPI_BIAS_RES if res2 is not None
                                    else _EPI_BIAS)
    out = torch.empty((r, n), dtype=torch.bfloat16, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = _build.load_library().mimo_gemm_fwd(
        a2.data_ptr(), a2.stride(0), wp.data_ptr(), ptr(bias_c), ptr(res2),
        res2.stride(0) if res2 is not None else 0, out.data_ptr(),
        out.stride(0), r, n, k, epi,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "gemm")
    return out


def qkv_weights(attn_p: Params) -> Tuple[torch.Tensor, ...]:
    """(W_q, W_k, W_v), each (C, C), of a bias-free diffusers Attention:
    the tile core reads them side by side as one (C, 3C) weight."""
    if any("bias" in attn_p[k] for k in ("to_q", "to_k", "to_v")):
        raise ValueError("qkv kernel: to_q/to_k/to_v must be bias-free")
    return tuple(attn_p[k]["kernel"] for k in ("to_q", "to_k", "to_v"))


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def ffn_ln_geglu_fused(x: torch.Tensor, ln_p: Params, ff_p: Params,
                       eps: float = 1e-5) -> torch.Tensor:
    """x + proj_out(geglu(proj_in(LN(x)))) over the trailing axis."""
    if not x.is_cuda:
        return ffn_ln_geglu_plain(x, ln_p, ff_p, eps)
    h = gemm(x, ff_p["proj_in"]["kernel"], geglu=True,
             bias=ff_p["proj_in"]["bias"],
             ln=(ln_p["scale"], ln_p["bias"], eps))
    y = gemm(h, ff_p["proj_out"]["kernel"], bias=ff_p["proj_out"]["bias"],
             res=x)
    ffn_ln_geglu_fused.launches += 1
    return y.reshape(x.shape)


def qkv_ln_fused(x: torch.Tensor, ln_p: Params, attn_p: Params,
                 eps: float = 1e-5) -> Tuple[torch.Tensor, ...]:
    """(q, k, v) = to_{q,k,v}(LN(x)) over an (N, S, C) token tensor. On the
    card the three are column views of one (N, S, 3C) result."""
    if not x.is_cuda:
        return qkv_ln_plain(x, ln_p, attn_p, eps)
    c = x.shape[-1]
    out = gemm(x, qkv_weights(attn_p), ln=(ln_p["scale"], ln_p["bias"], eps))
    out = out.reshape(*x.shape[:-1], 3 * c)
    qkv_ln_fused.launches += 1
    return out[..., :c], out[..., c:2 * c], out[..., 2 * c:]


def matmul_bias_residual(x: torch.Tensor, lin_p: Params,
                         res: torch.Tensor) -> torch.Tensor:
    """res + linear(lin_p, x) over (..., K); the result has res's shape."""
    if not x.is_cuda:
        return matmul_bias_residual_plain(x, lin_p, res)
    y = gemm(x, lin_p["kernel"], bias=lin_p.get("bias"), res=res)
    matmul_bias_residual.launches += 1
    return y.reshape(res.shape)


def matmul_bias(x: torch.Tensor, lin_p: Params) -> torch.Tensor:
    """linear(lin_p, x) over (..., K)."""
    if not x.is_cuda:
        return matmul_bias_plain(x, lin_p)
    y = gemm(x, lin_p["kernel"], bias=lin_p.get("bias"))
    matmul_bias.launches += 1
    return y.reshape(*x.shape[:-1], y.shape[-1])


ln_rows.launches = 0
ffn_ln_geglu_fused.launches = 0
qkv_ln_fused.launches = 0
matmul_bias_residual.launches = 0
matmul_bias.launches = 0
