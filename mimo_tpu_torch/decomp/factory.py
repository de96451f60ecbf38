"""Wire the decomposition models into a ``DecompModels`` bundle.

Counterpart of ``mimo_tpu/decomp/factory.py::build_decomp_models`` for the
bundles of the human-tracking stages:

  sam.npz      SAM ViT-H: the first-frame box segmentation, auto-masks
  sam2.npz     SAM2 Hiera-L: the video tracker
  vitpose.npz  ViTPose-H wholebody: the detector's person score and the
               full-body check

from a directory of npz bundles in the JAX package's flat format
(``tools/gen_decomp_weights.py``; the weights bridge turns them into the
port's trees), or, with no directory, seeded random weights at full width
(``chip_smoke.py`` and ``tools/profile_decomp.py`` run so). A missing
bundle leaves its stage disabled. The models run on the card unless the
caller passes a CPU device.

The SAM2 video encode is cached between ``track_video`` calls on one clip
(the occlusion stage tracks every occluder seed through the same frames);
the cache key is an explicit clip id or a digest of every frame's bytes,
where the JAX package keyed on ``id()`` and the first and last frames
(fault R3).
"""

from __future__ import annotations

import hashlib
import os
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from mimo_tpu_torch.decomp import pipeline as DP
from mimo_tpu_torch.decomp import sam as SAM
from mimo_tpu_torch.decomp import sam2 as SAM2
from mimo_tpu_torch.decomp import vitpose as VP
from mimo_tpu_torch.decomp.detector import PoseScoredDetector
from mimo_tpu_torch.weights import bridge

BUNDLES = ("sam", "sam2", "vitpose")


def sample_mask_points(mask: np.ndarray, n: int = 5,
                       seed: int = 0) -> np.ndarray:
    """Prompt points inside a mask: its centroid and n - 1 interior points
    drawn without replacement (``mimo_tpu/decomp/occlusion.py``'s)."""
    ys, xs = np.nonzero(mask)
    assert len(xs) > 0
    pts = [[xs.mean(), ys.mean()]]
    rng = np.random.default_rng(seed)
    for i in rng.choice(len(xs), size=min(n - 1, len(xs)), replace=False):
        pts.append([xs[i], ys[i]])
    return np.asarray(pts, np.float32)


def clip_key(frames: Sequence[np.ndarray]) -> str:
    """Digest of every frame's shape and bytes."""
    h = hashlib.sha1()
    for f in frames:
        f = np.ascontiguousarray(f)
        h.update(repr((f.shape, f.dtype.str)).encode())
        h.update(f.data)
    return h.hexdigest()


def configs(tiny: bool):
    """(SAMConfig, SAM2Config, ViTPoseConfig): full width or the tiny test
    configs of ``gen_decomp_weights.py --tiny``."""
    if tiny:
        return (SAM.tiny_sam_config(), SAM2.tiny_sam2_config(),
                VP.tiny_vitpose_config())
    return SAM.SAMConfig(), SAM2.SAM2Config(), VP.ViTPoseConfig()


def load_params(weights_dir: Optional[str], name: str, cfg, device,
                dtype: torch.dtype, seed: int):
    """One bundle's params: ``weights_dir/<name>.npz`` through the bridge,
    None if the file is missing, or seeded random weights without a
    directory."""
    if weights_dir is None:
        init = {"sam": SAM.sam_init, "sam2": SAM2.sam2_init,
                "vitpose": VP.vitpose_init}[name]
        gen = torch.Generator(device=device).manual_seed(
            seed + BUNDLES.index(name))
        return init(gen, cfg, dtype)
    path = os.path.join(weights_dir, f"{name}.npz")
    if not os.path.exists(path):
        return None
    return bridge.load_npz(path, device, dtype, kind=name)


def build_decomp_models(weights_dir: Optional[str] = None,
                        dtype: torch.dtype = torch.bfloat16,
                        tiny: bool = False, only: Optional[set] = None,
                        device=None, seed: int = 0,
                        params: Optional[Dict[str, Any]] = None
                        ) -> DP.DecompModels:
    """``only`` restricts the bundles built (names from ``BUNDLES``);
    ``device`` defaults to the card; ``params`` (trees by bundle name, as
    ``load_params`` makes them) are used as they are instead."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_decomp_models: no CUDA device; pass "
                           "device='cpu' to run on the CPU")
    sam_cfg, sam2_cfg, vp_cfg = configs(tiny)
    if params is None:
        params = {name: load_params(weights_dir, name, cfg, device, dtype,
                                    seed)
                  for name, cfg in zip(BUNDLES, (sam_cfg, sam2_cfg, vp_cfg))
                  if only is None or name in only}
    models = DP.DecompModels()

    if params.get("sam") is not None:
        predictor = SAM.SamPredictor(params["sam"], sam_cfg)

        def segment_box(frame, bbox):
            predictor.set_image(frame)
            masks, iou = predictor.predict(box=bbox)
            return masks[int(np.argmax(iou))]

        models.segment_box = segment_box
        models.automask = lambda frame: SAM.automatic_masks(
            predictor, frame, points_per_side=32)

    if params.get("sam2") is not None:
        tracker = SAM2.SAM2VideoPredictor(params["sam2"], sam2_cfg)
        cached = [None]

        def track(frames, seed_mask, seed_frame, clip_id=None):
            key = clip_id if clip_id is not None else clip_key(frames)
            if cached[0] != key:
                tracker.init_state(list(frames))
                cached[0] = key
            pts = sample_mask_points(seed_mask, n=5)
            tracker.add_new_points(seed_frame, pts,
                                   np.ones(len(pts), np.int32))
            return tracker.propagate_in_video(reverse=False) \
                | tracker.propagate_in_video(reverse=True)

        models.track_video = track

    if params.get("vitpose") is not None:
        models.estimate_pose = lambda frame, bbox: VP.estimate_pose(
            params["vitpose"], vp_cfg, frame, bbox)
        if models.automask is not None:
            models.detect_person = PoseScoredDetector(
                automask=models.automask, estimate_pose=models.estimate_pose)
    return models
