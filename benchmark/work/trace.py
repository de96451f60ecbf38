"""Reduction of a ``torch.profiler`` trace of one clip to the few numbers
the benchmark keeps: device time by kernel name, the seconds in which an
operation ran on the device, the traced window, the device operations that
took most time and the longest idle gaps, each named by the harness's range
around the entry call and the innermost CPU operation the profiler saw
when the gap began. The trace stays in memory; nothing is written."""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, List, Tuple

import torch

RANGE = "benchmark.clip"   # the harness's record_function around the entry
TOP = 10
NAME_CHARS = 120


def _events(prof) -> Tuple[list, list]:
    """(device operations, host events) as (name, start_ns, end_ns). A
    range's shadow on the device's timeline (``gpu_user_annotation``) is
    no operation and is left out."""
    dev, cpu = [], []
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        item = (e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
        if e.device_type() != cuda:
            cpu.append(item)
        elif not _annotation(e):
            dev.append(item)
    return dev, cpu


def _annotation(e) -> bool:
    """A range's shadow on the device (releases before 2.13 lack
    ``activity_type``; their shadows carry the range's name)."""
    if hasattr(e, "activity_type"):
        return e.activity_type() == "gpu_user_annotation"
    return e.name() == RANGE


def summarize(prof) -> Dict[str, Any]:
    """{"kernels": {name: seconds}, "busy_s", "window_s", "device_ops",
    "idle_gaps"} of the window of the RANGE range."""
    dev, cpu = _events(prof)
    ranges = [(s, e) for n, s, e in cpu if n == RANGE]
    if not ranges:
        raise RuntimeError(f"the trace holds no {RANGE!r} range")
    w0, w1 = ranges[0]
    by_name: Dict[str, float] = defaultdict(float)
    spans = []
    for name, s, e in dev:
        s, e = max(s, w0), min(e, w1)
        if e > s:
            by_name[name] += (e - s) / 1e9
            spans.append((s, e))
    spans.sort()
    busy, gaps = 0, []
    cur_s, cur_e = None, None
    last = w0
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            if s > last:
                gaps.append((last, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
        last = max(last, cur_e)
    if cur_e is not None:
        busy += cur_e - cur_s
    if w1 > last:
        gaps.append((last, w1))
    cpu_ops = sorted((s, e, n) for n, s, e in cpu
                     if n != RANGE and s < w1 and e > w0)

    def host_at(t):  # t: the middle of the gap
        inner = None
        for s, e, n in cpu_ops:
            if s > t:
                break
            if e > t and (inner is None or s >= inner[0]):
                inner = (s, n)
        return f"{RANGE}/{inner[1] if inner else 'host'}"[:NAME_CHARS]

    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {"kernels": dict(by_name), "busy_s": busy / 1e9,
            "window_s": (w1 - w0) / 1e9,
            "device_ops": [[n[:NAME_CHARS], s] for n, s in ops],
            "idle_gaps": [[host_at((s + e) // 2), (e - s) / 1e9]
                          for s, e in longest]}


def kernel_seconds(kernels: Dict[str, float], pattern: str) -> float:
    """Device seconds of the kernels whose name contains ``pattern``."""
    return sum(s for n, s in kernels.items() if pattern in n)
