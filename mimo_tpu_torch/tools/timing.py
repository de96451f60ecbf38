"""Device-time helpers shared by the timing tools and chip_smoke.py:
profiler device time of a call, the card's name and power limit to print
beside every number, and the bound of a kernel (the least time the card
could take for its work). Needs CUDA."""

from __future__ import annotations

import functools
import subprocess
from typing import Callable, Optional, Sequence, Tuple

import torch

# published peaks of one H100 SXM (NVIDIA's data sheet, dense, 700 W)
PEAK_BF16 = 989e12     # tensor-core FLOP/s in bf16
PEAK_FP32 = 67e12      # fp32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12   # HBM bytes/s
# per SM and clock on sm_90 (CUDA C++ guide, arithmetic-instruction
# throughput table): exp2 results of the special-function unit (MUFU) and
# fp32 operations of the FMA pipes
SFU_PER_CLOCK, FMA_PER_CLOCK = 16, 128
# FMA-pipe operations each logit costs beside its exp2 (the FFMA of the
# folded scale, the add into the row sum), and the fewest an exp2 costs
# there instead of on the MUFU: floor, fraction, two FFMAs of a degree-2
# polynomial (relative error 1.8e-3, under bf16's half ulp of 2^-9, so
# enough for P); the exponent's integer add runs on another pipe
FMA_PER_LOGIT, FMA_PER_EXP2 = 2, 4


def card_line() -> str:
    """``name, power limit`` of card 0, as nvidia-smi prints them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def device_ms(fn: Callable[[], object], names: Optional[Sequence[str]] = None,
              n: int = 20) -> float:
    """Device time of one fn() in ms: the kernels of n calls whose names
    contain one of ``names`` (every kernel for None), summed by
    torch.profiler, over n (after one warm-up call). Host time does not
    count."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.self_device_time_total > 0
               and (names is None or any(k in e.key for k in names))) / n / 1e3


@functools.lru_cache(maxsize=None)
def sm_clock() -> Tuple[int, float]:
    """(SMs, maximum SM clock in MHz) of card 0."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    return (torch.cuda.get_device_properties(0).multi_processor_count,
            float(smi.stdout.strip().splitlines()[0]))


def exp2_ms(logits: float) -> float:
    """The least time for the exp2 of ``logits`` logits and the FMA-pipe
    work each logit needs anyway: x of the exp2s on the MUFU, the rest as
    polynomials on the FMA pipes, x chosen so both finish together."""
    sms, mhz = sm_clock()
    work = logits * (FMA_PER_LOGIT + FMA_PER_EXP2)
    rate = (FMA_PER_CLOCK + FMA_PER_EXP2 * SFU_PER_CLOCK) * sms * mhz * 1e6
    return work / rate * 1e3


def bound(flops: float, nbytes: float, peak: float = PEAK_BF16,
          logits: float = 0.0):
    """(ms, "bytes" or "operations", what): the least time the card could
    take to move nbytes and to do flops at ``peak`` and the exp2 of
    ``logits`` logits, whichever is larger; what names the term that
    decides ("bytes", "flops" or "exp2")."""
    times = {"bytes": nbytes / PEAK_BYTES * 1e3, "flops": flops / peak * 1e3,
             "exp2": exp2_ms(logits) if logits else 0.0}
    what = max(times, key=times.get)
    return times[what], "bytes" if what == "bytes" else "operations", what


def flash_work(b, heads, d, sq, sk, n_in, products=2, exp2=True):
    """FLOPs, bytes, peak and the logits whose exp2 is taken, of attention:
    ``products`` of the two (Q.K^T, P.V) at 2 FLOP a multiply-add; n_in
    input elements and the output, bf16; one exp2 a logit (none for the
    ablation modes that drop it)."""
    logits = b * heads * sq * sk
    return (products * 2 * logits * d, 2 * (n_in + b * sq * heads * d),
            PEAK_BF16, logits if exp2 else 0)
