"""Wire the decomposition models into a ``DecompModels`` bundle.

Counterpart of ``mimo_tpu/decomp/factory.py::build_decomp_models`` for the
bundles of the ported stages (track, pose, motion, bk, occ):

  sam.npz        SAM ViT-H: the first-frame box segmentation, auto-masks
  sam2.npz       SAM2 Hiera-L: the video tracker
  vitpose.npz    ViTPose-H wholebody: the detector's person score, the
                 full-body check, the pose stage and the motion stage's
                 hand boxes
  hmr.npz        HMR2: the body regression of the motion stage
  hamer.npz      HaMeR: its hand regression
  smpl.npz/.pkl  SMPL-H: the body model (sdc_info.npy, when present, its
                 sdc vertex colours)
  raft.npz, propainter.npz
                 RAFT and ProPainter: the background stage's ``inpaint``
  depth.npz      DepthAnythingV2: the occlusion stage's ``depth``

from a directory of npz bundles in the JAX package's flat format
(``weights/convert_decomp.py``, ``tools/gen_decomp_weights.py``; the
weights bridge turns them into the port's trees), or, with no directory,
seeded random weights at full width and the synthetic surface SMPL-H
(``smpl.surface_smplh``), as ``chip_smoke.py`` and
``tools/profile_decomp.py`` run. A missing bundle leaves its stage
disabled (the motion stage needs hmr and SMPL-H, the background stage raft
and propainter). The models run on the card unless the caller passes a CPU
device.

With a ``mesh`` (a ``parallel.ProcessMesh`` with a "data" axis, every rank
building the same models) the ViTPose flip-test heatmaps and the motion
stage's forwards and render split their crops or frames over the ranks
(``parallel/decomp.py``).

``main`` is the ``decomp`` command (``python -m mimo_tpu_torch decomp``):
a video in, a template directory out, through ``VideoProcessor.run``.

The SAM2 video encode is cached between ``track_video`` calls on one clip
(the occlusion stage tracks every occluder seed through the same frames);
the cache key is an explicit clip id or a digest of every frame's bytes,
where the JAX package keyed on ``id()`` and the first and last frames
(fault R3). ``track_video`` (``TrackVideo``) keeps its last call's record:
spans, device phases, the tracker's decisions and counters.
"""

from __future__ import annotations

import argparse
import hashlib
import os
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from mimo_tpu_torch.decomp import depth_anything as DA
from mimo_tpu_torch.decomp import hmr as HMR
from mimo_tpu_torch.decomp import motion as MO
from mimo_tpu_torch.decomp import pipeline as DP
from mimo_tpu_torch.decomp import propainter as PP
from mimo_tpu_torch.decomp import raft as RAFT
from mimo_tpu_torch.decomp import sam as SAM
from mimo_tpu_torch.decomp import sam2 as SAM2
from mimo_tpu_torch.decomp import smpl as SM
from mimo_tpu_torch.decomp import vitpose as VP
from mimo_tpu_torch.decomp.detector import PoseScoredDetector
from mimo_tpu_torch.parallel.decomp import frame_parallel
from mimo_tpu_torch.utils import profiling
from mimo_tpu_torch.weights import bridge

BUNDLES = ("sam", "sam2", "vitpose", "hmr", "hamer", "raft", "propainter",
           "depth")


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


class TrackVideo:
    """``DecompModels.track_video``: SAM2 tracks a seed mask through a
    clip, prompted with ``PROMPT_POINTS`` points of the mask
    (``sample_mask_points``, seed 0) on ``seed_frame``, forwards and
    backwards, the two directions' masks OR-merged. The clip's encode is
    cached between calls on one clip (the key: an explicit ``clip_id`` or
    ``clip_key``'s digest of every frame).

    Each call is one clip of its own recorder (``SAM2.TrackRecord`` over a
    ``PhaseClock``; ``last_record`` keeps the last call's, as
    ``Runner.last_timings`` keeps a generation's): host spans
    ``track.key`` (the digest) and, from the predictor, ``track.masks``;
    device phases from the marks "start", "encode" (``init_state`` in the
    range ``track.encode``), "prompt" (the points and ``add_new_points`` in
    the range ``track.prompt``) and one a propagated frame (``track.frame``).
    """

    PROMPT_POINTS = 5

    def __init__(self, tracker: SAM2.SAM2VideoPredictor):
        self.tracker = tracker
        self.cached: Optional[str] = None
        self.clip_id = 0
        self.last_record: Optional[SAM2.TrackRecord] = None

    def __call__(self, frames, seed_mask, seed_frame, clip_id=None):
        self.clip_id += 1
        rec = SAM2.TrackRecord(profiling.PhaseClock(self.tracker.device,
                                                    clip=self.clip_id))
        clock = rec.clock
        self.tracker.record = rec
        try:
            with clock.span("track.key"):
                key = clip_id if clip_id is not None else clip_key(frames)
            clock.mark("start")
            if self.cached != key:
                with profiling.annotate("track.encode"):
                    self.tracker.init_state(list(frames))
                self.cached = key
                clock.mark("encode")
            with profiling.annotate("track.prompt"):
                pts = sample_mask_points(seed_mask, n=self.PROMPT_POINTS)
                self.tracker.add_new_points(seed_frame, pts,
                                            np.ones(len(pts), np.int32))
            clock.mark("prompt")
            masks = self.tracker.propagate_in_video(reverse=False) \
                | self.tracker.propagate_in_video(reverse=True)
        finally:
            self.tracker.record = None
        self.last_record = rec
        return masks


def configs(tiny: bool):
    """The configs of ``BUNDLES``, in order: full width, or the tiny test
    configs of ``gen_decomp_weights.py --tiny``."""
    if tiny:
        return (SAM.tiny_sam_config(), SAM2.tiny_sam2_config(),
                VP.tiny_vitpose_config(), HMR.tiny_hmr_config(),
                HMR.tiny_hmr_config(), RAFT.tiny_raft_config(),
                PP.tiny_propainter_config(), DA.tiny_depth_config())
    return (SAM.SAMConfig(), SAM2.SAM2Config(), VP.ViTPoseConfig(),
            HMR.HMRConfig(), HMR.hamer_config(), RAFT.RAFTConfig(),
            PP.ProPainterConfig(), DA.DepthAnythingConfig())


def load_params(weights_dir: Optional[str], name: str, cfg, device,
                dtype: torch.dtype, seed: int):
    """One bundle's params: ``weights_dir/<name>.npz`` through the bridge,
    None if the file is missing, or seeded random weights without a
    directory."""
    if weights_dir is None:
        init = {"sam": SAM.sam_init, "sam2": SAM2.sam2_init,
                "vitpose": VP.vitpose_init, "hmr": HMR.hmr_init,
                "hamer": HMR.hmr_init, "raft": RAFT.raft_init,
                "propainter": PP.propainter_init,
                "depth": DA.depth_anything_init}[name]
        gen = torch.Generator(device=device).manual_seed(
            seed + BUNDLES.index(name))
        return init(gen, cfg, dtype)
    path = os.path.join(weights_dir, f"{name}.npz")
    if not os.path.exists(path):
        return None
    return bridge.load_npz(path, device, dtype,
                           kind=name if name in bridge.TRANSPOSED_CONVS
                           else None)


def load_smpl(weights_dir: Optional[str], device, seed: int = 0):
    """(SMPL-H model, sdc colours or None): ``smpl.npz`` or ``smpl.pkl`` and
    ``sdc_info.npy`` of ``weights_dir`` (None, None without the model), or
    the synthetic surface SMPL-H without a directory. fp32."""
    if weights_dir is None:
        return SM.surface_smplh(seed, device=device), None
    for name, load in (("smpl.npz", SM.load_smpl_npz),
                       ("smpl.pkl", SM.load_smpl_pickle)):
        path = os.path.join(weights_dir, name)
        if os.path.exists(path):
            sdc = os.path.join(weights_dir, "sdc_info.npy")
            return (load(path, device=device),
                    np.load(sdc) if os.path.exists(sdc) else None)
    return None, None


def build_decomp_models(weights_dir: Optional[str] = None,
                        dtype: torch.dtype = torch.bfloat16,
                        tiny: bool = False, only: Optional[set] = None,
                        device=None, seed: int = 0,
                        params: Optional[Dict[str, Any]] = None,
                        mesh=None) -> DP.DecompModels:
    """``only`` restricts the bundles built (names from ``BUNDLES``);
    ``device`` defaults to the card; ``params`` (trees by bundle name, as
    ``load_params`` makes them) are used as they are instead; ``mesh``
    turns on the frame-parallel forwards."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_decomp_models: no CUDA device; pass "
                           "device='cpu' to run on the CPU")
    cfgs = dict(zip(BUNDLES, configs(tiny)))
    sam_cfg, sam2_cfg, vp_cfg = cfgs["sam"], cfgs["sam2"], cfgs["vitpose"]
    if params is None:
        params = {name: load_params(weights_dir, name, cfg, device, dtype,
                                    seed)
                  for name, cfg in cfgs.items()
                  if only is None or name in only}
    models = DP.DecompModels(device=device)

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
        models.track_video = TrackVideo(
            SAM2.SAM2VideoPredictor(params["sam2"], sam2_cfg))

    if params.get("vitpose") is not None:
        def hm_fn(p, crops):
            return VP.heatmaps_flip_test(p, vp_cfg, crops)

        if mesh is not None:
            hm_fn = frame_parallel(hm_fn, mesh)
        models.estimate_pose = lambda frame, bbox: VP.estimate_pose(
            params["vitpose"], vp_cfg, frame, bbox, heatmap_fn=hm_fn)
        models.estimate_pose_batch = \
            lambda frames, bboxes, batch=8: VP.estimate_pose_batch(
                params["vitpose"], vp_cfg, frames, bboxes, batch,
                heatmap_fn=hm_fn)
        if models.automask is not None:
            models.detect_person = PoseScoredDetector(
                automask=models.automask, estimate_pose=models.estimate_pose)

    if params.get("hmr") is not None:
        smpl_model, sdc_colors = load_smpl(weights_dir, device, seed)
        if smpl_model is not None:
            # the estimator is the bound method's __self__
            models.estimate_motion = MO.MotionEstimator(
                vitpose_params=params.get("vitpose"), vitpose_cfg=vp_cfg,
                hmr_params=params["hmr"], hmr_cfg=cfgs["hmr"],
                hamer_params=params.get("hamer"), hamer_cfg=cfgs["hamer"],
                smpl_model=smpl_model, sdc_colors=sdc_colors, mesh=mesh
            ).estimate_motion

    if params.get("raft") is not None and params.get("propainter") is not None:
        def inpaint(frames01, masks, phases=None):
            return PP.inpaint_video(
                params["propainter"], cfgs["propainter"], params["raft"],
                cfgs["raft"], torch.as_tensor(frames01).to(device, dtype),
                torch.as_tensor(masks).to(device, dtype), phases=phases)

        models.inpaint = inpaint

    if params.get("depth") is not None:
        def depth(frame):
            image01 = torch.from_numpy(np.asarray(frame)).to(device).float() \
                / 255.0
            return DA.infer_depth(params["depth"], cfgs["depth"],
                                  image01).cpu().numpy()

        models.depth = depth
    return models


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="MIMO template extraction (PyTorch port)")
    ap.add_argument("--video", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--weights-dir", default=None,
                    help="directory of npz bundles from `python -m "
                         "mimo_tpu_torch.weights.convert_decomp` (seeded "
                         "random weights at full width and a synthetic "
                         "SMPL-H if omitted: smoke-test mode)")
    ap.add_argument("--fps", type=int, default=30)
    ap.add_argument("--max-frames", type=int, default=150)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA device)")
    args = ap.parse_args(argv)

    models = build_decomp_models(args.weights_dir,
                                 device="cpu" if args.cpu else None)
    cfg = DP.DecompConfig(target_fps=args.fps, max_frames=args.max_frames)
    result = DP.VideoProcessor(models, cfg).run(args.video, args.output)
    code = result["code"]
    msgs = {
        DP.CODE_OK: "ok",
        DP.CODE_NO_PERSON: "no person detected",
        DP.CODE_PERSON_TOO_SMALL: "person too small",
        DP.CODE_HALF_BODY: "person not fully visible",
    }
    print(f"decomposition: {msgs.get(code, code)} -> {args.output}")
    if code != DP.CODE_OK:
        raise SystemExit(code)


if __name__ == "__main__":
    main()
