"""The comparison that decides ``correct``: a clip the program returned in
the window against the plain float32 reference's video of the same inputs.

Both videos are read as frames in [0, 1] (the edit entry's uint8 frames
over 255). The numbers compared: ``mean_abs``, the mean absolute gap over
every pixel and channel, and ``p999_abs``, the 99.9th percentile of the
absolute gap. A video of another shape, or one that is not finite, reads
infinity on both.
"""

from __future__ import annotations

from typing import Dict, Sequence, Union

import numpy as np

Video = Union[np.ndarray, Sequence[np.ndarray]]
NUMBERS = ("mean_abs", "p999_abs")


def as_unit(video: Video) -> np.ndarray:
    v = np.asarray(np.stack(list(video)) if not isinstance(video, np.ndarray)
                   else video)
    if v.dtype == np.uint8:
        return v.astype(np.float32) / 255.0
    return v.astype(np.float32)


def gaps(program: Video, reference: Video) -> Dict[str, float]:
    a, b = as_unit(program), as_unit(reference)
    if a.shape != b.shape or not np.isfinite(a).all():
        return {k: float("inf") for k in NUMBERS}
    d = np.abs(a.astype(np.float64) - b.astype(np.float64)).ravel()
    return {"mean_abs": float(d.mean()),
            "p999_abs": float(np.quantile(d, 0.999))}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(numbers[k] <= limits[k] for k in limits)
