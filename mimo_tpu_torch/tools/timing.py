"""Device-time helpers shared by the timing tools: profiler device time of
a call, and the card's name and power limit to print beside every number.
Needs CUDA."""

from __future__ import annotations

import subprocess
from typing import Callable, Optional, Sequence

import torch

PEAK_BYTES = 3.35e12   # HBM bytes/s of one H100 SXM (NVIDIA's data sheet)


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
