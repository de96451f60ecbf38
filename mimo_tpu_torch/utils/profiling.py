"""Observability: hierarchical stage timers, profiler traces and an
environment snapshot.

Counterpart of ``mimo_tpu/utils/profiling.py``. ``StageTimer`` keeps the
same records and one-line JSON report; its ``sync`` takes a tensor (or a
sequence of tensors) and synchronises their CUDA device, as
``jax.block_until_ready`` waits for an array. ``trace`` is the counterpart
of ``xla_trace``: a ``torch.profiler`` trace of the CPU and, where there is
one, the CUDA device, written to a directory as a Chrome trace
(chrome://tracing, Perfetto or TensorBoard's profiler plugin).
``annotate`` opens a named range on the trace's host timeline; the clip's
span recorder (``pipelines.pose2vid.PhaseClock``) opens one a span.
"""

from __future__ import annotations

import contextlib
import json
import logging
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List

import torch

logger = logging.getLogger("mimo_tpu_torch")


def _synchronize(sync: Any) -> None:
    tensors = [sync] if isinstance(sync, torch.Tensor) else list(sync)
    for dev in {t.device for t in tensors if t.is_cuda}:
        torch.cuda.synchronize(dev)


@dataclass
class StageTimer:
    """Hierarchical wall-clock stage timing.

    with timer.stage("denoise"):
        ...
    print(timer.report())
    """

    records: List[Dict[str, Any]] = field(default_factory=list)
    _stack: List[str] = field(default_factory=list)

    @contextlib.contextmanager
    def stage(self, name: str, sync: Any = None):
        """Time a stage; pass a tensor (or a sequence of tensors) as `sync`
        to include the device's work on it in the measurement."""
        path = "/".join(self._stack + [name])
        self._stack.append(name)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                _synchronize(sync)
            dt = time.perf_counter() - t0
            self._stack.pop()
            self.records.append({"stage": path, "seconds": round(dt, 4)})
            logger.info("stage %s: %.3fs", path, dt)

    def report(self) -> str:
        return json.dumps(self.records)

    def total(self, prefix: str = "") -> float:
        return sum(r["seconds"] for r in self.records
                   if r["stage"].startswith(prefix))


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a torch.profiler trace of the CPU and the CUDA device into
    ``log_dir``."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


def annotate(name: str):
    """Named region on the host's timeline of a profiler trace, recorded
    only while a profiler runs. It is recorded as an operator is (function
    scope), not as a ``record_function`` user annotation: CUPTI casts a
    user annotation's shadow onto the device's timeline, an event of the
    range's name (before torch 2.13 with nothing to tell it from a kernel)
    that a sum of device time would count as work."""
    return torch._C._profiler._RecordFunctionFast(name)


def log_compile_options() -> Dict[str, Any]:
    """Environment snapshot useful when filing performance reports: the
    backend, device names, and the torch and CUDA versions."""
    cuda = torch.cuda.is_available()
    return {
        "backend": "cuda" if cuda else "cpu",
        "devices": ([torch.cuda.get_device_name(i)
                     for i in range(torch.cuda.device_count())]
                    if cuda else ["cpu"]),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
    }
