"""Template extraction: an in-the-wild video -> the first mask -> masks
over the clip -> per-frame boxes -> the rendered SMPL-H "sdc" video -> the
recovered background -> the occlusion masks, each stage written to a
template directory (vid / mask / sdc / bk / occ .mp4, bbox.npy,
config.json) that ``entry.template.load_template`` reads.

Counterpart of ``mimo_tpu/decomp/pipeline.py``: ``DecompConfig``,
``DecompModels``, the status codes and ``VideoProcessor`` (``run`` with its
stage files and resume, and the stages it calls). The models are injected
callables (``factory.build_decomp_models`` wires them), so the stage logic
runs without weights. The stage files go through ``utils/video_io.py``,
which needs no OpenCV.

The background stage's mask dilation, resizes and uint8 quantisation run on
the models' device (``DecompModels.device``) without OpenCV: the dilation
through ``ops/morphology.py``, the frames through
``utils/frames.resize_linear`` (OpenCV's INTER_LINEAR), the masks through
``F.interpolate(mode="nearest")`` (INTER_NEAREST's floor rule).
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from mimo_tpu_torch.decomp import occlusion as OCC
from mimo_tpu_torch.ops import morphology as MO
from mimo_tpu_torch.ops.connected_components import clean_mask
from mimo_tpu_torch.utils import video_io as VIO
from mimo_tpu_torch.utils.frames import resize_linear

# status codes of the reference's get_first_mask
CODE_OK = 0
CODE_NO_PERSON = 1
CODE_PERSON_TOO_SMALL = 2
CODE_HALF_BODY = 3


@dataclass
class DecompConfig:
    target_fps: int = 30
    max_frames: int = 150
    max_resolution: int = 720        # the longer side's cap
    mask_min_area: int = 256
    occ: OCC.OcclusionConfig = field(default_factory=OCC.OcclusionConfig)


@dataclass
class DecompModels:
    """Injected model callables; any None disables its step.

    - detect_person(frame) -> (bbox_xyxy, score) or None
    - segment_box(frame, bbox) -> bool mask
    - track_video(frames, seed_mask, seed_frame) -> (T, H, W) bool
    - estimate_pose(frame, bbox) -> (K, 3) keypoints   [full-body check]
    - estimate_pose_batch(frames, bboxes) -> (T, K, 3)  [the pose stage]
    - estimate_motion(frames, masks, bboxes) -> (T, H, W, 3) uint8 sdc
    - inpaint(frames01, masks) -> (T, H, W, 3) fp32 backgrounds in [0, 1]
      (tensors on ``device``: frames (T, H, W, 3), masks (T, H, W, 1))
    - automask(frame) -> list of {"segmentation": ...}
    - depth(frame) -> (H, W) float
    - device: where the background stage's tensors and ``run``'s resize
      live (None: the CPU)
    """

    detect_person: Optional[Callable] = None
    segment_box: Optional[Callable] = None
    track_video: Optional[Callable] = None
    estimate_pose: Optional[Callable] = None
    estimate_pose_batch: Optional[Callable] = None
    estimate_motion: Optional[Callable] = None
    inpaint: Optional[Callable] = None
    automask: Optional[Callable] = None
    depth: Optional[Callable] = None
    device: Optional[torch.device] = None


def _out_of_memory(e: BaseException) -> bool:
    return isinstance(e, torch.cuda.OutOfMemoryError) \
        or "out of memory" in str(e).lower()


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

    def get_motion(self, frames, masks, bboxes):
        """The sdc video (T, H, W, 3) uint8, or None without a motion
        model."""
        if self.models.estimate_motion is None:
            return None
        return self.models.estimate_motion(frames, masks, bboxes)

    def get_bk_recover(self, frames: Sequence[np.ndarray], masks: np.ndarray,
                       dilate: int = 4) -> Optional[np.ndarray]:
        """The background: ProPainter over the clip with the person masks
        dilated by a (2 dilate + 1)^2 square, at the frame's size rounded
        down to multiples of 8; after an out-of-memory error, again at 0.75x
        the size, down to a ratio of 0.3 (then the error propagates, as
        does any other). Returns (T, H, W, 3) uint8 (quantised on the
        device by truncation), resized back if the model ran smaller;
        ``self.bk_ratio`` keeps the ratio it ran at."""
        if self.models.inpaint is None:
            return None
        dev = torch.device(self.models.device or "cpu")
        m = torch.from_numpy(np.stack(masks).astype(np.uint8)).to(dev)
        dil = MO.dilate(m, MO.rect(2 * dilate + 1, 2 * dilate + 1))
        hgt, wid = frames[0].shape[:2]
        ratio = 1.0
        while True:
            try:
                h = max(16, int(hgt * ratio) // 8 * 8)
                w = max(16, int(wid * ratio) // 8 * 8)
                fr = torch.stack([resize_linear(f, w, h, dev)
                                  for f in frames])
                mr = F.interpolate(dil[:, None].float(), size=(h, w),
                                   mode="nearest")[:, 0, :, :, None]
                out = self.models.inpaint(fr.float() / 255.0, mr)
                out = (out.clamp(0.0, 1.0) * 255.0).to(torch.uint8)
                out = out.cpu().numpy()
                break
            except Exception as e:
                if not _out_of_memory(e) or ratio < 0.3:
                    raise
                ratio *= 0.75
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
        self.bk_ratio = ratio
        if out.shape[1:3] != (hgt, wid):
            out = np.stack([resize_linear(f, wid, hgt, dev).cpu().numpy()
                            for f in out])
        return out

    def get_occ(self, frames, person_masks, sdc=None,
                stats: Optional[Dict] = None) -> Optional[np.ndarray]:
        """The occlusion masks (T, H, W) bool, each frame refined, or None
        without the models or without an occluder. ``stats``: see
        ``occlusion.extract_occlusion_video``."""
        m = self.models
        if None in (m.automask, m.depth, m.track_video):
            return None
        occ = OCC.extract_occlusion_video(
            frames, person_masks, sdc, m.automask, m.depth,
            lambda fr, seed, kf: m.track_video(list(fr), seed, kf),
            self.cfg.occ, stats=stats)
        if occ is None:
            return None
        return np.stack([OCC.refine_occ_mask(o) for o in occ])

    def run(self, vid_path: str, save_dir: str,
            resume: bool = True) -> Dict[str, Any]:
        """The clip at ``vid_path`` (resampled to ``target_fps``, cut to
        ``max_frames``, its longer side capped at ``max_resolution``)
        through every stage into ``save_dir``. With ``resume``, an existing
        mask.mp4 and sdc.mp4 are read back instead of computed, and an
        existing bk.mp4 is kept; vid.mp4, bbox.npy, occ.mp4 and
        config.json are always written. Returns {"code"} (and
        "num_frames", "elapsed_s" when the code is CODE_OK)."""
        cfg = self.cfg
        os.makedirs(save_dir, exist_ok=True)
        t_start = time.time()

        frames = VIO.load_video_fixed_fps(vid_path, cfg.target_fps)
        frames = frames[: cfg.max_frames]
        h, w = frames[0].shape[:2]
        if max(h, w) > cfg.max_resolution:
            s = cfg.max_resolution / max(h, w)
            nh, nw = int(h * s) // 2 * 2, int(w * s) // 2 * 2
            dev = torch.device(self.models.device or "cpu")
            frames = [resize_linear(f, nw, nh, dev).cpu().numpy()
                      for f in frames]

        def stage_path(name):
            return os.path.join(save_dir, name)

        def save_masks(masks, name):
            VIO.save_video([(m * 255).astype(np.uint8)[..., None]
                            .repeat(3, -1) for m in masks],
                           stage_path(name), cfg.target_fps)

        result: Dict[str, Any] = {"code": CODE_OK}

        VIO.save_video(frames, stage_path("vid.mp4"), cfg.target_fps)

        if resume and os.path.exists(stage_path("mask.mp4")):
            masks = np.stack([f[..., 0] > 127 for f in
                              VIO.read_frames(stage_path("mask.mp4"))])
        else:
            masks, code = self.get_human(frames)
            if code != CODE_OK:
                result["code"] = code
                return result
            save_masks(masks, "mask.mp4")

        bboxes = self.get_bbox(masks)
        np.save(stage_path("bbox.npy"), bboxes)

        if resume and os.path.exists(stage_path("sdc.mp4")):
            sdc = np.stack(VIO.read_frames(stage_path("sdc.mp4")))
        else:
            sdc = self.get_motion(frames, masks, bboxes)
            if sdc is not None:
                VIO.save_video(list(sdc), stage_path("sdc.mp4"),
                               cfg.target_fps)

        if not (resume and os.path.exists(stage_path("bk.mp4"))):
            bk = self.get_bk_recover(frames, masks)
            if bk is not None:
                VIO.save_video(list(bk), stage_path("bk.mp4"),
                               cfg.target_fps)

        occ = self.get_occ(frames, masks, sdc)
        if occ is not None:
            save_masks(occ, "occ.mp4")

        config = {
            "fps": cfg.target_fps,
            "time_crop": {"start_idx": 0, "end_idx": len(frames)},
            "frame_crop": None,
            "layer_recover": True,
        }
        with open(stage_path("config.json"), "w") as f:
            json.dump(config, f)
        result["num_frames"] = len(frames)
        result["elapsed_s"] = time.time() - t_start
        return result
