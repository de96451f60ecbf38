"""Video-template loading: a copy of ``mimo_tpu/entry/template.py`` (which
cannot be imported where there is no JAX).

A template directory holds sdc.mp4 (rendered SMPL pose, required) and
optionally vid.mp4, bk.mp4, occ.mp4 and config.json with keys
{fps, time_crop{start_idx,end_idx}, frame_crop, layer_recover}.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from mimo_tpu_torch.utils import video_io as VIO


@dataclass
class Template:
    path: str
    fps: float
    vid: List[np.ndarray] = field(default_factory=list)
    sdc: List[np.ndarray] = field(default_factory=list)
    bk: Optional[List[np.ndarray]] = None
    occ: Optional[List[np.ndarray]] = None
    config: dict = field(default_factory=dict)

    @property
    def num_frames(self) -> int:
        return len(self.sdc)


def load_template(path: str, max_frames: int = 150,
                  require_bk: bool = False) -> Template:
    """Load + time-crop a template (indices scaled by target_fps/30,
    clipped, then capped at max_frames)."""
    cfg_file = os.path.join(path, "config.json")
    config = {}
    if os.path.exists(cfg_file):
        with open(cfg_file) as f:
            config = json.load(f)
    fps = config.get("fps", 30)

    def load(name):
        p = os.path.join(path, name)
        return (VIO.load_video_fixed_fps(p, target_fps=fps)
                if os.path.exists(p) else None)

    sdc = load("sdc.mp4")
    if sdc is None:
        raise FileNotFoundError(f"{path}/sdc.mp4 (pose video) is required")
    vid = load("vid.mp4") or []
    bk = load("bk.mp4")
    occ = load("occ.mp4")
    if require_bk and bk is None:
        raise FileNotFoundError(f"{path}/bk.mp4 required for the edit flow")

    tc = config.get("time_crop", {})
    start = max(0, int(fps * tc.get("start_idx", 0) / 30))
    end = min(len(sdc), int(fps * tc.get("end_idx", len(sdc) * 30 // max(fps, 1)) / 30)) \
        if tc else len(sdc)
    end = max(start + 1, end)

    def crop(frames):
        if frames is None:
            return None
        return frames[start:end][:max_frames]

    return Template(path=path, fps=fps, vid=crop(vid) or [], sdc=crop(sdc),
                    bk=crop(bk), occ=crop(occ), config=config)
