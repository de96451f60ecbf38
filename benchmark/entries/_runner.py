"""What the two MIMO entries share: the port's ``Runner`` as the system
under test, the weights' layout, and the work of a generation
(``work/count.py``)."""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional

import torch

from benchmark.reference import params as P
from benchmark.work import count

layout = P.layout
work = count.clip_work


class RunnerProgram:
    """The port's ``Runner`` over the benchmark's weights; ``clip`` is the
    entry's call, which each entry module gives."""

    def __init__(self, cfg: Dict[str, Any], cfg_path: Path, params,
                 device: torch.device, dtype: torch.dtype):
        from mimo_tpu_torch.config import load_json
        from mimo_tpu_torch.entry.runner import Runner
        self.cfg, self.pl = cfg, cfg["pipeline"]
        self.runner = Runner(cfg=load_json(str(cfg_path)), params=params,
                             device=device, dtype=dtype)

    def options(self, inp: Dict[str, Any], steps: Optional[int]) -> dict:
        return dict(width=self.pl["width"], height=self.pl["height"],
                    steps=steps or self.pl["num_inference_steps"],
                    cfg_scale=self.pl["guidance_scale"], seed=inp["seed"])

    def timings(self) -> Dict[str, Any]:
        """The last clip's phases: ``prepare``, ``step_mean``, ``decode``
        (ms, CUDA events) and ``steps``."""
        return dict(self.runner.last_timings)
