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
span recorder (``PhaseClock``) opens one a span.
"""

from __future__ import annotations

import contextlib
import json
import logging
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

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


class PhaseClock:
    """The span recorder of one clip: its device phases and its host spans.

    Device phases: ``mark`` records a CUDA event on the device's timeline
    when it runs on CUDA, the host clock otherwise; ``durations_ms`` turns
    the marks into phases and, the first time after the last mark, waits
    for that mark once. Recording an event does not synchronise.

    Host spans: ``span(name)`` opens a profiler range of that name
    (``annotate``), so a trace of the call names the host's work by it, and
    records ``{"name", "parent", "clip", "start", "end"}`` in ``spans``:
    the enclosing span's name (None for the root), the clip's id and the
    host clock in ms from the clock's creation. A span never synchronises.

    Copies: ``copied(direction, nbytes)`` counts the bytes the clip's host
    arrays put on the device ("h2d") and its device tensors brought back as
    host arrays ("d2h").

    ``record()`` gives the keys every clip's record carries; the user of
    the marks names the phases (``pipelines.pose2vid.clip_timings``,
    ``decomp.sam2.TrackRecord.timings``)."""

    def __init__(self, device: torch.device, clip: int = 0):
        self.cuda = torch.device(device).type == "cuda"
        self.clip = clip
        self.marks = []
        self.spans: List[Dict[str, Any]] = []
        self._open: List[str] = []
        self._t0 = time.perf_counter()
        self._durations: Optional[Dict[str, float]] = None
        self.bytes = {"h2d": 0, "d2h": 0}

    def copied(self, direction: str, nbytes: int) -> None:
        self.bytes[direction] += int(nbytes)

    def mark(self, name: str) -> None:
        self._durations = None
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append((name, ev))
        else:
            self.marks.append((name, time.perf_counter()))

    def durations_ms(self) -> Dict[str, float]:
        """{phase: ms} from each mark to the next."""
        if self._durations is None:
            if self.cuda:
                self.marks[-1][1].synchronize()
            self._durations = {
                name: (a.elapsed_time(b) if self.cuda else (b - a) * 1e3)
                for (_, a), (name, b) in zip(self.marks, self.marks[1:])}
        return dict(self._durations)

    @contextlib.contextmanager
    def span(self, name: str):
        rec = {"name": name, "parent": self._open[-1] if self._open else None,
               "clip": self.clip, "start": self._ms(), "end": None}
        self.spans.append(rec)
        self._open.append(name)
        try:
            with annotate(name):
                yield
        finally:
            self._open.pop()
            rec["end"] = self._ms()

    def _ms(self) -> float:
        return (time.perf_counter() - self._t0) * 1e3

    def record(self) -> Dict[str, Any]:
        """``clip``, ``spans`` (host) and ``h2d_bytes`` / ``d2h_bytes``
        (``copied``)."""
        return {"clip": self.clip, "spans": [dict(s) for s in self.spans],
                "h2d_bytes": self.bytes["h2d"],
                "d2h_bytes": self.bytes["d2h"]}


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
