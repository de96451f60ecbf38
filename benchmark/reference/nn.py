"""Plain float32 primitives of the reference: NHWC feature maps, (in, out)
linear kernels, OIHW conv kernels, every product in float32 with TF32 off.

Nothing here imports the program. Each function reads the parameter tree
as the benchmark drew it (any dtype) and computes in float32.

Two switches, both off by default:

- ``operands(fmt)``: every product's operands (activations, weights,
  attention probabilities) are rounded to ``fmt`` first ("fp8": e4m3 with
  a per-tensor scale, accumulation in float32). This is the control of the
  correctness check: the reference one precision below the configuration's
  bfloat16.
- ``recording(log)``: every linear product and attention call appends its
  shape to ``log`` (``benchmark/work/count.py`` turns them into bounds).
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F

Params = Dict[str, Any]

FP8_MAX = 448.0
_STATE: Dict[str, Any] = {"round": None, "log": None}


def fp32_only() -> None:
    """Products in true float32: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale (its absolute
    maximum maps to 448), returned in float32."""
    x = x.float()
    scale = FP8_MAX / x.abs().amax().clamp(min=1e-30)
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


@contextlib.contextmanager
def operands(fmt: Optional[str]):
    """Round every product's operands to ``fmt`` (None or "fp8")."""
    prev = _STATE["round"]
    _STATE["round"] = {None: None, "fp8": round_fp8}[fmt]
    try:
        yield
    finally:
        _STATE["round"] = prev


@contextlib.contextmanager
def recording(log: List[Dict[str, Any]]):
    """Append each linear product's and attention call's shape to log."""
    prev = _STATE["log"]
    _STATE["log"] = log
    try:
        yield
    finally:
        _STATE["log"] = prev


def _op(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    fn = _STATE["round"]
    return x if fn is None else fn(x)


def _record(**item) -> None:
    if _STATE["log"] is not None:
        _STATE["log"].append(item)


# ---------------------------------------------------------------------------
# products
# ---------------------------------------------------------------------------


def matmul(x: torch.Tensor, w: torch.Tensor, kind: Optional[str] = None,
           res: bool = False, geglu: bool = False) -> torch.Tensor:
    """x (..., K) @ w (K, N) in float32. ``kind`` names the product for the
    work log (the program's tile-core products carry one); ``res`` and
    ``geglu`` say what its epilogue does."""
    if kind is not None:
        m = x.numel() // x.shape[-1]
        _record(op="gemm", kind=kind, m=m, k=x.shape[-1], n=w.shape[-1],
                res=res, geglu=geglu)
    return torch.matmul(_op(x), _op(w))


def linear(p: Params, x: torch.Tensor, kind: Optional[str] = None,
           res: bool = False) -> torch.Tensor:
    y = matmul(x, p["kernel"], kind, res=res)
    if "bias" in p:
        y = y + p["bias"].float()
    return y


def conv2d(p: Params, x: torch.Tensor, stride: int = 1, padding=1
           ) -> torch.Tensor:
    """x (N, H, W, C) -> (N, H', W', C_out); kernel OIHW. ``padding`` an
    int or "VALID"."""
    if padding == "VALID":
        padding = 0
    b = p["bias"].float() if "bias" in p else None
    y = F.conv2d(_op(x).permute(0, 3, 1, 2), _op(p["kernel"]), b,
                 stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
              kb: Optional[torch.Tensor] = None,
              vb: Optional[torch.Tensor] = None,
              logits_budget: int = 1 << 30) -> torch.Tensor:
    """Softmax attention, scale 1/sqrt(d), in float32, over (B, S, H·d)
    tensors; kb / vb (1, Sb, H·d) are bank keys appended to every row's.
    The (batch·head) rows run in blocks of at most ``logits_budget``
    logits, so the logits stay bounded. The scale is the logits product's
    alpha, so the logits are written once, read and written once by the
    softmax, and read once by the product with V."""
    b, sq, inner = q.shape
    d = inner // heads
    _record(op="attn", b=b, heads=heads, d=d, sq=sq, sk=k.shape[1],
            bank=0 if kb is None else kb.shape[1])
    if kb is not None:
        k = torch.cat([k.float(), kb.float().expand(b, -1, -1)], dim=1)
        v = torch.cat([v.float(), vb.float().expand(b, -1, -1)], dim=1)
    sk = k.shape[1]

    def heads_first(t, s):
        return t.float().reshape(b, s, heads, d).transpose(1, 2).reshape(
            b * heads, s, d)

    qh, kh, vh = heads_first(q, sq), heads_first(k, sk), heads_first(v, sk)
    out = torch.empty((b * heads, sq, d), dtype=torch.float32,
                      device=q.device)
    rows = max(1, logits_budget // (sq * sk))
    scale = 1.0 / math.sqrt(d)
    logits = torch.empty((min(rows, b * heads), sq, sk), dtype=torch.float32,
                         device=q.device)
    for r0 in range(0, b * heads, rows):
        r1 = min(r0 + rows, b * heads)
        block = logits[:r1 - r0]
        torch.baddbmm(block, _op(qh[r0:r1]), _op(kh[r0:r1]).transpose(1, 2),
                      beta=0.0, alpha=scale, out=block)
        probs = torch.softmax(block, dim=-1)
        torch.bmm(_op(probs), _op(vh[r0:r1]), out=out[r0:r1])
        del probs
    return out.reshape(b, heads, sq, d).transpose(1, 2).reshape(b, sq, inner)


# ---------------------------------------------------------------------------
# norms and small pieces
# ---------------------------------------------------------------------------


def group_norm(p: Params, x: torch.Tensor, groups: int, eps: float,
               silu: bool = False,
               row_add: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GroupNorm over the trailing channel axis of (N, ..., C); row_add
    (N, C) is added first."""
    n, c = x.shape[0], x.shape[-1]
    x = x.float()
    if row_add is not None:
        x = x + row_add.float().reshape(n, *([1] * (x.dim() - 2)), c)
    xg = x.reshape(n, -1, groups, c // groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = ((xg - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    y = y * p["scale"].float() + p["bias"].float()
    return F.silu(y) if silu else y


def layer_norm(p: Params, x: torch.Tensor, eps: float = 1e-5
               ) -> torch.Tensor:
    return F.layer_norm(x.float(), (x.shape[-1],), p["scale"].float(),
                        p["bias"].float(), eps)


def geglu_ff(p: Params, x: torch.Tensor, res: torch.Tensor,
             kind: Optional[str] = None) -> torch.Tensor:
    """res + proj_out(h · gelu(g)), [h ‖ g] = proj_in(x)."""
    h, gate = linear(p["proj_in"], x).chunk(2, dim=-1)
    if kind is not None:   # the program's one GEGLU product
        _record(op="gemm", kind=kind, m=x.numel() // x.shape[-1],
                k=x.shape[-1], n=p["proj_in"]["kernel"].shape[-1],
                res=False, geglu=True)
        _record(op="gemm", kind=kind, m=h.numel() // h.shape[-1],
                k=h.shape[-1], n=p["proj_out"]["kernel"].shape[-1],
                res=True, geglu=False)
    return res + linear(p["proj_out"], h * F.gelu(gate))


def timestep_embedding(t: torch.Tensor, dim: int, flip_sin_to_cos: bool,
                       freq_shift: float) -> torch.Tensor:
    half = dim // 2
    exponent = -math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / (half - freq_shift)
    emb = torch.exp(exponent)[None, :] * t.float()[:, None]
    sin, cos = torch.sin(emb), torch.cos(emb)
    return torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)


def upsample_nearest_to(x: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """Nearest-neighbour resize with floor(i·n/s) indexing."""
    _, h, w, _ = x.shape
    yi = torch.arange(th, device=x.device) * h // th
    xi = torch.arange(tw, device=x.device) * w // tw
    return x.index_select(1, yi).index_select(2, xi)
