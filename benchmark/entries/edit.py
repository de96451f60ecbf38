"""The ``edit`` entry (MIMO's run_edit.py): a reference image and an edit
template (sdc, vid, bk, occ) in, the template's video with the character
replaced out. The interface is ``animate.py``'s."""

from __future__ import annotations

from typing import Any, Dict, Optional

from benchmark.entries._runner import RunnerProgram, layout, work
from benchmark.reference import frames as RF
from benchmark.reference import pipeline as RP

__all__ = ["layout", "work", "Program", "reference", "frames"]


class Program(RunnerProgram):
    def clip(self, inp: Dict[str, Any], steps: Optional[int] = None):
        from mimo_tpu_torch.entry.edit import edit
        from mimo_tpu_torch.entry.template import Template
        tpl = Template(path="in-memory", fps=30, sdc=inp["sdc"],
                       vid=inp["vid"], bk=inp["bk"], occ=inp["occ"])
        return edit(self.runner, inp["ref"], tpl, **self.options(inp, steps))


def reference(cfg: Dict[str, Any], params, inp: Dict[str, Any], device):
    return RP.edit(params, cfg, inp["ref"], inp["sdc"], inp["vid"],
                   inp["bk"], inp["occ"], seed=inp["seed"], device=device)


def frames(inp: Dict[str, Any]) -> int:
    """The frames of the template's ROI shots, summed."""
    return sum(len(s) for s in RF.roi_shots(inp["sdc"])[0])
