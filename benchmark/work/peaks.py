"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the 700 W limit), and the least time the card could
take for a piece of work: the larger of its bytes over the HBM rate and its
operations over the tensor-core rate. Attention's exponentials are not a
published rate and are not counted."""

from __future__ import annotations

PEAK_BF16 = 989e12     # tensor-core FLOP/s, bf16
PEAK_BYTES = 3.35e12   # HBM bytes/s
BF16_BYTES = 2


def bound_s(flops: float, nbytes: float, peak: float = PEAK_BF16) -> float:
    """Seconds: max(flops / peak, nbytes / PEAK_BYTES)."""
    return max(flops / peak, nbytes / PEAK_BYTES)


def flash_work(b: int, heads: int, d: int, sq: int, sk: int, bank: int = 0):
    """(FLOPs, bytes) of one attention call: Q·Kᵀ and P·V at 2 FLOP a
    multiply-add over sk + bank keys a query; q, k, v, the bank's k and v
    (shared by the batch) read once and the output written once, bf16."""
    logits = b * heads * sq * (sk + bank)
    elems = heads * d * (b * sq + 2 * b * sk + 2 * bank + b * sq)
    return 2 * 2 * logits * d, BF16_BYTES * elems


def gemm_work(m: int, k: int, n: int, res: bool, geglu: bool):
    """(FLOPs, bytes) of one tile-core product x (m, k) · W (k, n) + bias:
    the input, the weight and the bias read once, the residual read once
    where the epilogue adds it, the output written once (n / 2 columns
    under GEGLU, which gates the value half with the other), bf16."""
    out = n // 2 if geglu else n
    elems = m * k + k * n + n + m * out * (2 if res else 1)
    return 2 * m * k * n, BF16_BYTES * elems
