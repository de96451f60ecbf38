"""Template extraction, the human-tracking stages: in-the-wild frames ->
the first mask -> masks over the clip -> per-frame boxes.

Counterpart of ``mimo_tpu/decomp/pipeline.py``'s ``DecompConfig``,
``DecompModels``, status codes and ``VideoProcessor.get_first_mask`` /
``get_human`` / ``get_bbox``. The models are injected callables
(``factory.build_decomp_models`` wires them), so the stage logic runs
without weights. The later stages (motion, background, occlusion) and
``run``, which persists every stage to a template directory, are not ported
yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np

from mimo_tpu_torch.ops.connected_components import clean_mask

# status codes of the reference's get_first_mask
CODE_OK = 0
CODE_NO_PERSON = 1
CODE_PERSON_TOO_SMALL = 2
CODE_HALF_BODY = 3


@dataclass
class DecompConfig:
    """The track stage's settings; each later stage adds its own."""

    mask_min_area: int = 256


@dataclass
class DecompModels:
    """Injected model callables of the track stage; any None disables its
    step.

    - detect_person(frame) -> (bbox_xyxy, score) or None
    - segment_box(frame, bbox) -> bool mask
    - track_video(frames, seed_mask, seed_frame) -> (T, H, W) bool
    - estimate_pose(frame, bbox) -> (K, 3) keypoints   [full-body check]
    - automask(frame) -> list of {"segmentation": ...}
    """

    detect_person: Optional[Callable] = None
    segment_box: Optional[Callable] = None
    track_video: Optional[Callable] = None
    estimate_pose: Optional[Callable] = None
    automask: Optional[Callable] = None


class VideoProcessor:
    def __init__(self, models: DecompModels,
                 cfg: DecompConfig = DecompConfig()):
        self.models = models
        self.cfg = cfg

    def get_first_mask(self, frame: np.ndarray):
        """(mask, code): detector + box-prompted segmentation + full-body
        check."""
        m = self.models
        if m.detect_person is None or m.segment_box is None:
            return None, CODE_NO_PERSON
        det = m.detect_person(frame)
        if det is None:
            return None, CODE_NO_PERSON
        bbox, _ = det
        x0, y0, x1, y1 = bbox
        if (x1 - x0) * (y1 - y0) / (frame.shape[0] * frame.shape[1]) < 0.02:
            return None, CODE_PERSON_TOO_SMALL
        if m.estimate_pose is not None:
            body = m.estimate_pose(frame, np.asarray(bbox))[:17]
            if (body[:, 2] > 0.3).sum() < 10:
                return None, CODE_HALF_BODY
        mask = m.segment_box(frame, np.asarray(bbox))
        return clean_mask(mask, min_area=self.cfg.mask_min_area), CODE_OK

    def get_human(self, frames: Sequence[np.ndarray]):
        """(masks (T, H, W) bool, code): the first mask tracked through the
        clip, each frame's mask cleaned."""
        first, code = self.get_first_mask(frames[0])
        if code != CODE_OK:
            return None, code
        if self.models.track_video is None:
            return np.stack([first] * len(frames)), CODE_OK
        masks = self.models.track_video(list(frames), first, 0)
        return np.stack([clean_mask(m, self.cfg.mask_min_area)
                         for m in masks]), CODE_OK

    @staticmethod
    def get_bbox(masks: np.ndarray) -> np.ndarray:
        """Per-frame xyxy boxes (exclusive max) of the masks; an empty mask
        takes the previous frame's box ([0, 0, 1, 1] before any)."""
        out = []
        prev = None
        for m in masks:
            ys, xs = np.nonzero(m)
            if len(xs) == 0:
                out.append(prev if prev is not None else [0, 0, 1, 1])
                continue
            prev = [int(xs.min()), int(ys.min()),
                    int(xs.max()) + 1, int(ys.max()) + 1]
            out.append(prev)
        return np.asarray(out, np.int64)
