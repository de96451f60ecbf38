"""The ``animate`` entry (MIMO's run_animate.py): a reference image and a
pose template in, the animated clip out.

Each entry module gives the harness (``run.py``) what it needs of one
entry: ``layout(cfg)``, the weights' shapes; ``Program``, the system under
test with ``clip(inp, steps=None)`` and ``timings()``; ``reference``, the
plain float32 reference's output for the same inputs; ``frames(inp)``,
the frames one generation of the clip makes; ``work(cfg, frames)``, the
counted work of such a generation."""

from __future__ import annotations

from typing import Any, Dict, Optional

from benchmark.entries._runner import RunnerProgram, layout, work
from benchmark.reference import pipeline as RP

__all__ = ["layout", "work", "Program", "reference", "frames"]


class Program(RunnerProgram):
    def clip(self, inp: Dict[str, Any], steps: Optional[int] = None):
        from mimo_tpu_torch.entry.animate import animate
        return animate(self.runner, inp["ref"], inp["sdc"],
                       **self.options(inp, steps))


def reference(cfg: Dict[str, Any], params, inp: Dict[str, Any], device):
    return RP.animate(params, cfg, inp["ref"], inp["sdc"], seed=inp["seed"],
                      device=device)


def frames(inp: Dict[str, Any]) -> int:
    """The template's frames."""
    return len(inp["sdc"])
