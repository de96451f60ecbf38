"""Occlusion extraction: find the objects in front of the person and build
the occ mask video.

Counterpart of ``mimo_tpu/decomp/occlusion.py`` (the reference's
``demo_occ.py`` and ``tools/util.py``), host numpy logic with its OpenCV
calls on ``ops/morphology.py`` (equal in every bit, no OpenCV needed):

- keyframes: the frames whose cleaned person mask has the most
  8-connected components, kept ``keyframe_interval`` apart;
- per keyframe, SAM's automatic masks ranked by area, the depth order
  against the person's average depth, the ground-layer and sdc gates
  (``find_occluders_in_frame``, the reference's get_obscure_obj);
- each occluder kept tracked through the clip with SAM2 and OR-merged,
  skipping seeds the merged mask already covers;
- per-frame refinement (a 5x5 ellipse close and open, then small
  components dropped).

The models (automask, depth, tracking) are injected callables, so the
stage runs without weights. ``sample_mask_points`` lives in
``decomp/factory.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from mimo_tpu_torch.ops import morphology as MO
from mimo_tpu_torch.ops.connected_components import clean_mask as cc_clean
from mimo_tpu_torch.utils import frames as FU


@dataclass(frozen=True)
class OcclusionConfig:
    """Thresholds, all the reference's literals.

    - overlap_threshold: the share of a candidate (outside the person) that
      must lie in the depth-obscure region;
    - ground_rows / ground_frac: a mask covering >= ground_frac of the
      bottom ground_rows rows is a ground layer;
    - sdc thresholds: the least overlap (pixels) of the candidate's obscure
      intersection with the sdc render: num_sdc * 0.1 for ground layers,
      600 for masks larger than the person, 100 otherwise;
    - person_inter_frac / cand_inter_frac: judge_obj_valid's "already
      covered" rejection.
    """
    num_keyframes: int = 5
    keyframe_interval: int = 20
    overlap_threshold: float = 0.4
    ground_rows: int = 10
    ground_frac: float = 0.9
    sdc_frac_ground: float = 0.1
    sdc_thresh_large: int = 600
    sdc_thresh_normal: int = 100
    person_inter_frac: float = 0.8
    cand_inter_frac: float = 0.5


def clean_mask(mask: np.ndarray) -> np.ndarray:
    """Morphological close (5x5 rect) then open (2x2 rect) of a 0/1 or
    0/255 mask, as uint8 (``utils/frames.clean_mask``)."""
    return FU.clean_mask(np.asarray(mask).astype(np.uint8))


def extract_mask_sdc(img: np.ndarray) -> np.ndarray:
    """Person-present mask of a rendered sdc frame: OpenCV's gray > 10
    (the threshold removes codec noise)."""
    return (MO.rgb_to_gray(img) > 10).astype(np.uint8)


def avg_depth_value(depth: np.ndarray, mask: np.ndarray) -> float:
    """Mean depth over the mask, over the strictly positive masked values
    only (the denominator is sum(depth * mask > 0), not the mask area)."""
    masked = depth * mask
    n = np.sum(masked > 0)
    if n == 0:
        return 0.0
    return float(np.sum(masked) / n)


def judge_obj_valid(obj_mask: np.ndarray, cur_mask: np.ndarray,
                    cfg: OcclusionConfig = OcclusionConfig()) -> bool:
    """False when obj_mask is (mostly) covered already: its intersection
    with cur_mask exceeds 80% of obj_mask's area or 50% of cur_mask's."""
    inter = np.logical_and(obj_mask > 0, cur_mask > 0).sum()
    num_obj = np.sum(obj_mask > 0)
    num_cur = np.sum(cur_mask > 0)
    return not (inter > num_obj * cfg.person_inter_frac
                or inter > num_cur * cfg.cand_inter_frac)


def pick_keyframes(person_masks: Sequence[np.ndarray],
                   cfg: OcclusionConfig = OcclusionConfig()) -> List[int]:
    """Frames ranked by the 8-connected component count of the cleaned
    person mask (more components: an occluder more likely splits the
    person); up to num_keyframes indices pairwise >= keyframe_interval
    apart, sorted."""
    n_comp = []
    for frame in person_masks:
        m = np.asarray(frame)
        if m.ndim == 3:
            m = m[..., 0]
        m = (m * 255) if m.max() <= 1 else m
        n_comp.append(MO.count_components_8(clean_mask(m.astype(np.uint8))))
    order = np.argsort(n_comp)[::-1]
    picked: List[int] = []
    for idx in order:
        if len(picked) >= cfg.num_keyframes:
            break
        if all(abs(int(idx) - v) >= cfg.keyframe_interval for v in picked):
            picked.append(int(idx))
    return sorted(picked) or [0]


def find_occluders_in_frame(
    candidates: Sequence[Dict], depth: np.ndarray, person_mask: np.ndarray,
    sdc_mask: np.ndarray, cfg: OcclusionConfig = OcclusionConfig(),
) -> List[np.ndarray]:
    """The reference's get_obscure_obj. candidates: SAM automask dicts
    {"segmentation": bool HxW, "area": int}; depth: (H, W) relative depth,
    larger = closer; person_mask, sdc_mask: (H, W) 0/1.

    Per candidate, the largest first: judge_obj_valid against the person;
    the ground-layer flag on the raw mask; clean_mask, minus the person;
    the depth gate (the candidate must overlap the region in front of the
    person's average depth by more than overlap_threshold of its area);
    the sdc gate (that intersection must overlap the sdc render by the
    ground / large / normal threshold)."""
    person = (np.asarray(person_mask) > 0).astype(np.uint8)
    avg = avg_depth_value(depth, person)
    new_depth = person * avg + (1 - person) * depth
    mask_obscure = (new_depth > avg).astype(np.uint8)

    num_sdc = int(np.sum(np.asarray(sdc_mask) > 0))
    num_person = int(np.sum(person > 0))
    inv_person = (1 - person).astype(np.uint8)
    sdc01 = (np.asarray(sdc_mask) > 0).astype(np.uint8)

    kept: List[np.ndarray] = []
    for ann in sorted(candidates, key=lambda a: a["area"], reverse=True):
        m = ann["segmentation"].astype(np.uint8)
        if not judge_obj_valid(person, m, cfg):
            continue
        gr = cfg.ground_rows
        is_ground = int(np.sum(m[-gr:, :] > 0)) \
            >= gr * m.shape[1] * cfg.ground_frac
        m = clean_mask(m) * inv_person
        num_valid = int(np.sum(m > 0))
        intersect = m * mask_obscure
        if np.sum(intersect) < cfg.overlap_threshold * num_valid:
            continue
        if is_ground:
            sdc_thresh = int(num_sdc * cfg.sdc_frac_ground)
        elif num_valid > num_person:
            sdc_thresh = cfg.sdc_thresh_large
        else:
            sdc_thresh = cfg.sdc_thresh_normal
        if np.sum((intersect * sdc01) > 0) < sdc_thresh:
            continue
        kept.append(m.astype(bool))
    return kept


def extract_occlusion_video(
    frames: Sequence[np.ndarray], person_masks: Sequence[np.ndarray],
    sdc_frames: Optional[Sequence[np.ndarray]],
    automask_fn: Callable[[np.ndarray], List[Dict]],
    depth_fn: Callable[[np.ndarray], np.ndarray],
    track_fn: Callable[[Sequence[np.ndarray], np.ndarray, int], np.ndarray],
    cfg: OcclusionConfig = OcclusionConfig(),
    stats: Optional[Dict] = None,
) -> Optional[np.ndarray]:
    """The occ stage: keyframes -> automask candidates -> the occluder
    filter -> each occluder tracked through the clip and OR-merged, seeds
    the merged mask already covers skipped. Returns (T, H, W) bool, or
    None when no occluder is found.

    sdc_frames: the rendered sdc video for the sdc gate; None falls back
    to the person masks. track_fn(frames, seed_mask, seed_frame) -> (T, H,
    W) bool. ``stats``, when given, receives the keyframes, the candidates
    and occluders of each, and the tracks run."""
    merged: Optional[np.ndarray] = None
    keyframes = pick_keyframes(person_masks, cfg)
    if stats is not None:
        stats.update(keyframes=keyframes, candidates=[], occluders=[],
                     tracks=0)
    for kf in keyframes:
        cands = automask_fn(frames[kf])
        depth = depth_fn(frames[kf])
        if sdc_frames is not None:
            sdc_mask = clean_mask(extract_mask_sdc(sdc_frames[kf]))
        else:
            sdc_mask = clean_mask((np.asarray(person_masks[kf]) > 0)
                                  .astype(np.uint8))
        occluders = find_occluders_in_frame(cands, depth, person_masks[kf],
                                            sdc_mask, cfg)
        if stats is not None:
            stats["candidates"].append(len(cands))
            stats["occluders"].append(len(occluders))
        for seg in occluders:
            if merged is not None and not judge_obj_valid(
                    seg.astype(np.uint8), merged[kf].astype(np.uint8), cfg):
                continue                      # a repeated object
            track = track_fn(frames, seg, kf)
            if stats is not None:
                stats["tracks"] += 1
            merged = track if merged is None else (merged | track)
    return merged


def refine_occ_mask(mask: np.ndarray, rgb: Optional[np.ndarray] = None,
                    min_area: int = 64) -> np.ndarray:
    """Per-frame occ mask refinement: a 5x5 ellipse close then open, then
    components under ``min_area`` dropped (the reference runs an
    unpublished ONNX model here)."""
    m = np.asarray(mask).astype(np.uint8)
    m = MO.open(MO.close(m, MO.ELLIPSE_5), MO.ELLIPSE_5)
    return cc_clean(m.astype(bool), min_area=min_area)
