"""Person detection producing (bbox, score).

Counterpart of ``mimo_tpu/decomp/detector.py``: ``PoseScoredDetector``
proposes person regions with SAM's automatic masks and scores each with the
ViTPose keypoints' confidence inside it; ``box_nms`` is the greedy IoU NMS
of box sets. Host-side numpy over the models' outputs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np


def box_nms(boxes: np.ndarray, scores: np.ndarray,
            iou_thresh: float = 0.5) -> List[int]:
    """Greedy NMS. boxes: (N, 4) xyxy. Returns the kept indices by
    descending score."""
    keep: List[int] = []
    for i in np.argsort(-scores):
        if all(_iou(boxes[i], boxes[j]) <= iou_thresh for j in keep):
            keep.append(int(i))
    return keep


def _iou(a, b) -> float:
    x0, y0 = max(a[0], b[0]), max(a[1], b[1])
    x1, y1 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(0.0, x1 - x0) * max(0.0, y1 - y0)
    union = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) \
        - inter
    return inter / union if union > 0 else 0.0


@dataclass
class PoseScoredDetector:
    """Person regions from auto-masks, scored by keypoint confidence
    (``estimate_pose(frame, bbox) -> (K, 3)``): the candidate of at least
    ``min_area_frac`` of the frame with at least ``min_kpts`` body
    keypoints above ``min_kpt_conf`` and the best mean body confidence."""

    automask: Callable[[np.ndarray], List[dict]]
    estimate_pose: Callable[[np.ndarray, np.ndarray], np.ndarray]
    min_area_frac: float = 0.02
    min_kpt_conf: float = 0.3
    min_kpts: int = 8

    def __call__(self, frame: np.ndarray
                 ) -> Optional[Tuple[np.ndarray, float]]:
        h, w = frame.shape[:2]
        best = None
        for cand in self.automask(frame):
            seg = cand["segmentation"]
            if seg.sum() < self.min_area_frac * h * w:
                continue
            ys, xs = np.nonzero(seg)
            bbox = np.array([xs.min(), ys.min(), xs.max(), ys.max()],
                            np.float32)
            body = self.estimate_pose(frame, bbox)[:17]
            if int((body[:, 2] > self.min_kpt_conf).sum()) < self.min_kpts:
                continue
            score = float(body[:, 2].mean())
            if best is None or score > best[1]:
                best = (bbox, score)
        return best
