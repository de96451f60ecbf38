"""Per-call profile of the decomposition half's ported stages on the card.

    python -m mimo_tpu_torch.tools.profile_decomp \
        --stages track,pose,motion,bk,occ [--weights-dir DIR] [--trace]

The port's counterpart of ``tools/profile_decomp.py``'s stages, at full
width (seeded random bf16 weights and the synthetic surface SMPL-H without
``--weights-dir``) on the same synthetic moving-figure clip
(``synth_frames``, 48 frames of 720x480, ``CLIP``):

- track: SAM ViT-H, SAM2 Hiera-L and ViTPose-H. Random weights reject
  every person, so the gating is bypassed as the JAX tool does: the
  figure's known box on frame 0 prompts SAM (``segment_box`` +
  ``clean_mask``), SAM2 tracks the figure's known frame-0 mask forwards and
  backwards, and ``get_bbox`` boxes the cleaned masks. One
  ``automatic_masks`` call and one ``PoseScoredDetector`` call on frame 0
  follow (the detector's path, run for its cost).
- pose: ``estimate_pose_batch`` (ViTPose-H, flip test) over the clip's
  known boxes.
- motion: ``estimate_motion`` (ViTPose-H, HMR2, HaMeR, the fuse and
  SMPL-H skinning, the z-buffer render) over the clip's known boxes; then
  HaMeR again through ``hand_params`` on keypoints drawn so that both hands
  are found on every frame (random weights may find none).
- bk: ``VideoProcessor.get_bk_recover`` (RAFT + ProPainter) with the
  figure's known masks; the times of its phases (RAFT, flow completion,
  image propagation, the windows) and the back-off ratio it ran at.
- occ: as the JAX tool, SAM's ``automatic_masks`` and the depth model
  (DINOv2-L, its attention the flash kernel at d = 64) on frames 0 and
  T // 2.

Each stage runs once untimed, then timed: each model call's time (CUDA
events around it; host work inside it counts), the host crop time apart
(``square_crop``, wall clock), the raster's candidate pixel tests a frame,
the peak device memory, the flash kernel's launches by head width and the
card's name and power limit; ``--trace`` adds the top kernels of one more
track pass by device time (torch.profiler) and the device's idle share.
"""

from __future__ import annotations

import argparse
import contextlib
import time
from collections import Counter
from typing import Callable, Dict, List

import numpy as np
import torch

from mimo_tpu_torch.tools.timing import card_line

STAGES = ("track", "pose", "motion", "bk", "occ")
# the bundles each stage needs
STAGE_BUNDLES = {"track": {"sam", "sam2", "vitpose"}, "pose": {"vitpose"},
                 "motion": {"vitpose", "hmr", "hamer"},
                 "bk": {"raft", "propainter"},
                 "occ": {"sam", "sam2", "depth"}}
BK_PHASES = ("raft", "flow_complete", "img_propagation", "windows")
CLIP = (48, 720, 480)               # frames, height, width


def synth_frames(t: int, h: int, w: int, seed: int = 0):
    """A moving person-ish figure over a textured background: (frames,
    masks (T, H, W) bool, boxes (T, 4) xyxy)."""
    rng = np.random.default_rng(seed)
    bg = rng.uniform(40, 200, (h, w, 3)).astype(np.uint8)
    frames, masks, boxes = [], [], []
    pw, ph = w // 4, int(h * 0.7)
    for i in range(t):
        f = bg.copy()
        x0 = int((w - pw) * (0.2 + 0.6 * i / max(1, t - 1)))
        y0 = int(h * 0.15)
        f[y0:y0 + ph, x0:x0 + pw] = (180, 140, 110)
        f[y0:y0 + ph // 5, x0 + pw // 4:x0 + 3 * pw // 4] = (210, 170, 140)
        m = np.zeros((h, w), bool)
        m[y0:y0 + ph, x0:x0 + pw] = True
        frames.append(f)
        masks.append(m)
        boxes.append([x0, y0, x0 + pw, y0 + ph])
    return frames, np.stack(masks), np.asarray(boxes, np.int64)


def timed(times: Dict[str, List[float]], name: str, fn: Callable):
    """Wrap fn so each call's CUDA-event time lands in times[name]."""
    def call(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args, **kwargs)
        end.record()
        end.synchronize()
        times.setdefault(name, []).append(start.elapsed_time(end))
        return out
    return call


@contextlib.contextmanager
def instrumented(models, times: Dict[str, List[float]]):
    """Within: the track stage's model calls, and SAM's image encode,
    SAM2's encode and the pieces of each propagation step, land their
    CUDA-event times in ``times``."""
    from mimo_tpu_torch.decomp import sam as SAM
    from mimo_tpu_torch.decomp import sam2 as SAM2
    saved = []

    def patch(obj, attr, name):
        fn = getattr(obj, attr)
        if fn is not None:
            saved.append((obj, attr, fn))
            setattr(obj, attr, timed(times, name, fn))

    det = models.detect_person
    for attr in ("segment_box", "track_video", "automask", "detect_person",
                 "estimate_pose"):
        patch(models, attr, attr)
    if det is not None:             # the detector calls the timed models
        for attr in ("automask", "estimate_pose"):
            saved.append((det, attr, getattr(det, attr)))
            setattr(det, attr, getattr(models, attr))
    patch(SAM, "encode_image", "sam encode_image")
    patch(SAM.SamPredictor, "decode", "sam decode (a prompt batch)")
    patch(SAM, "nms_stats", "sam nms_stats")
    patch(SAM2.SAM2VideoPredictor, "init_state",
          "sam2 init_state (resize + encode)")
    patch(SAM2, "encode_frames", "sam2 encode_frames (a chunk)")
    patch(SAM2.SAM2VideoPredictor, "propagate_in_video",
          "sam2 propagate_in_video (a direction)")
    patch(SAM2, "memory_attention", "sam2 memory_attention (a step)")
    patch(SAM2, "forward_sam_heads", "sam2 forward_sam_heads (a call)")
    patch(SAM2, "encode_memory", "sam2 encode_memory (a call)")
    try:
        yield
    finally:
        for obj, attr, fn in reversed(saved):
            setattr(obj, attr, fn)


def track_stage(models, frames, seed_masks, boxes, clip_id=None):
    """The track stage with its gating bypassed, as the JAX tool runs it:
    SAM segments the clip's known box on frame 0 (+ clean_mask), SAM2
    tracks the known mask of frame 0 forwards and backwards (random weights
    may give SAM an empty mask), each tracked mask is cleaned and boxed.
    Returns (masks (T, H, W), bboxes (T, 4), SAM's frame-0 mask). A new
    ``clip_id`` makes SAM2 encode the clip again."""
    from mimo_tpu_torch.decomp import pipeline as DP
    from mimo_tpu_torch.ops.connected_components import clean_mask
    cfg = DP.DecompConfig()
    first = clean_mask(models.segment_box(frames[0], boxes[0]),
                       min_area=cfg.mask_min_area)
    masks = models.track_video(frames, seed_masks[0], 0, clip_id=clip_id)
    masks = np.stack([clean_mask(m, cfg.mask_min_area) for m in masks])
    return masks, DP.VideoProcessor.get_bbox(masks), first


def build(weights_dir=None, stages=("track",)):
    """The models of ``stages`` on the card in bf16."""
    from mimo_tpu_torch.decomp.factory import build_decomp_models
    if not torch.cuda.is_available():
        raise SystemExit("profile_decomp: needs a CUDA device")
    t0 = time.perf_counter()
    models = build_decomp_models(weights_dir, dtype=torch.bfloat16,
                                 only=set().union(*(STAGE_BUNDLES[s]
                                                    for s in stages)))
    torch.cuda.synchronize()
    print(f"models built in {time.perf_counter() - t0:.1f} s ("
          f"{weights_dir or 'seeded random weights at full width, bf16'})",
          flush=True)
    return models


def warm_up(models, frames, seed_masks, boxes):
    """One untimed pass of what ``run`` times (first calls pay for cuDNN's
    and SDPA's per-shape set-up, e.g. each new memory-bank length of the
    first propagation steps). Returns its track-stage result."""
    out = track_stage(models, frames, seed_masks, boxes, clip_id="warm-up")
    models.automask(frames[0])
    models.detect_person(frames[0])
    torch.cuda.synchronize()
    return out


def run(models, frames, seed_masks, boxes) -> Dict[str, object]:
    """The track stage (the clip encoded again), one automask and one
    detector call on frame 0, timed after ``warm_up``; prints the profile
    and returns what it measured."""
    from mimo_tpu_torch.ops import connected_components as CC
    from mimo_tpu_torch.ops.flash_attention import flash_attention_nt
    times: Dict[str, List[float]] = {}
    torch.cuda.reset_peak_memory_stats()
    widths = Counter(flash_attention_nt.widths)
    with instrumented(models, times):
        t0 = time.perf_counter()
        masks, bboxes, first = track_stage(models, frames, seed_masks,
                                           boxes)
        track_s = time.perf_counter() - t0
        auto = models.automask(frames[0])
        det = models.detect_person(frames[0])
    widths = flash_attention_nt.widths - widths
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    t, h, w = len(frames), *frames[0].shape[:2]
    print(f"{card_line()}\ntrack stage: {t} frames {h}x{w}, {track_s:.2f} s "
          f"wall; automask on frame 0: {len(auto)} masks; detector: "
          f"{'no person' if det is None else 'box %s' % det[0].tolist()}; "
          f"clean_mask: {CC.backend()}", flush=True)
    for name, ts in times.items():
        ts_s = sorted(ts)
        print(f"  {name}: {len(ts)} call(s), mean {np.mean(ts):.2f} ms, "
              f"median {ts_s[len(ts) // 2]:.2f}, min {ts_s[0]:.2f}, max "
              f"{ts_s[-1]:.2f}, sum {np.sum(ts):.1f}", flush=True)
    print(f"  peak device memory {peak:.2f} GiB; flash_attention_nt "
          f"launches by head width {dict(sorted(widths.items()))}",
          flush=True)
    return dict(masks=masks, bboxes=bboxes, first=first, times=times,
                widths=dict(widths), peak_gib=peak, track_s=track_s,
                automask=len(auto), detector=det)


def host_timed(times: Dict[str, List[float]], name: str, fn: Callable):
    """Wrap a host function so each call's wall time (ms) lands in
    times[name]."""
    def call(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        times.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
        return out
    return call


@contextlib.contextmanager
def instrumented_motion(times: Dict[str, List[float]]):
    """Within: the pose and motion stages' model calls land their CUDA-event
    times in ``times`` (HMR2 and HaMeR apart), the host crops their wall
    time."""
    from mimo_tpu_torch.decomp import hmr as HM
    from mimo_tpu_torch.decomp import motion as MO
    from mimo_tpu_torch.decomp import renderer as REND
    from mimo_tpu_torch.decomp import smpl as SM
    from mimo_tpu_torch.decomp import vitpose as VP
    saved = [(mod, name, getattr(mod, name)) for mod, name in (
        (VP, "square_crop"), (VP, "heatmaps_flip_test"), (VP, "heatmaps"),
        (HM, "hmr_forward"), (MO, "fuse_pose_batch"), (SM, "lbs"),
        (REND, "render_frames"))]
    forward = HM.hmr_forward
    hmr2 = timed(times, "hmr2 hmr_forward (the clip's person crops)",
                 forward)
    hamer = timed(times, "hamer hmr_forward (the clip's hand crops)",
                  forward)
    VP.square_crop = host_timed(times, "host square_crop (a crop)",
                                VP.square_crop)
    VP.heatmaps_flip_test = timed(
        times, "vitpose heatmaps_flip_test (a batch)", VP.heatmaps_flip_test)
    VP.heatmaps = timed(times, "vitpose heatmaps (a call)", VP.heatmaps)
    HM.hmr_forward = lambda p, cfg, crops: (
        hamer if cfg.num_joints == 16 else hmr2)(p, cfg, crops)
    MO.fuse_pose_batch = timed(times, "fuse_pose_batch", MO.fuse_pose_batch)
    SM.lbs = timed(times, "smpl lbs (the clip)", SM.lbs)
    REND.render_frames = timed(times, "render_frames (the clip)",
                               REND.render_frames)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def hand_keypoints(boxes: np.ndarray, seed: int = 0) -> np.ndarray:
    """(T, 133, 3) wholebody keypoints whose two hands' 21 points are
    confident, spread over a patch a tenth of each person box wide at its
    left and right edges halfway down (the rest unconfident)."""
    rng = np.random.default_rng(seed)
    t = len(boxes)
    k = np.zeros((t, 133, 3))
    x0, y0, x1, y1 = (boxes[:, i, None].astype(np.float64) for i in range(4))
    k[..., 0], k[..., 1] = (x0 + x1) / 2, (y0 + y1) / 2
    for sl, cx in ((slice(-42, -21), x0), (slice(-21, None), x1)):
        r = (x1 - x0) / 20
        k[:, sl, 0] = cx + r * rng.uniform(-1, 1, (t, 21))
        k[:, sl, 1] = (y0 + y1) / 2 + r * rng.uniform(-1, 1, (t, 21))
        k[:, sl, 2] = 0.9
    return k


def motion_stage(models, frames, masks, boxes):
    """The sdc video, then HaMeR through ``hand_params`` on keypoints that
    find both hands on every frame. Returns (sdc, hand rotations, crops)."""
    sdc = models.estimate_motion(frames, masks, boxes)
    est = models.estimate_motion.__self__
    hands = est.hand_params(frames, hand_keypoints(boxes))
    return sdc, hands, est.hand_crops


def run_stage(stage: str, models, frames, masks, boxes) -> Dict[str, object]:
    """One timed pass of the pose or motion stage after an untimed one;
    prints the profile and returns what it measured, with both passes'
    outputs."""
    call = {"pose": lambda: models.estimate_pose_batch(frames, boxes),
            "motion": lambda: motion_stage(models, frames, masks, boxes)
            }[stage]
    first = call()
    torch.cuda.synchronize()
    times: Dict[str, List[float]] = {}
    torch.cuda.reset_peak_memory_stats()
    with instrumented_motion(times):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = call()
        end.record()
        end.synchronize()
    stage_ms = start.elapsed_time(end)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    t, h, w = len(frames), *frames[0].shape[:2]
    res = dict(out=out, warm_up=first, times=times, peak_gib=peak,
               stage_ms=stage_ms)
    print(f"{card_line()}\n{stage} stage: {t} frames {h}x{w}, "
          f"{stage_ms:.1f} ms", flush=True)
    if stage == "motion":
        est = models.estimate_motion.__self__
        st = dict(est.render_stats)
        res.update(render_stats=st, hand_crops=out[2])
        print(f"  raster: {st['tests'] / t:.0f} candidate pixel tests a "
              f"frame ({st['covered'] / t:.0f} covered) in {st['chunks']} "
              f"chunk(s), {times['render_frames (the clip)'][0] / t:.3f} ms "
              f"a frame; HaMeR crops on the drawn keypoints: {out[2]}",
              flush=True)
    for name, ts in times.items():
        ts_s = sorted(ts)
        print(f"  {name}: {len(ts)} call(s), mean {np.mean(ts):.2f} ms, "
              f"median {ts_s[len(ts) // 2]:.2f}, min {ts_s[0]:.2f}, max "
              f"{ts_s[-1]:.2f}, sum {np.sum(ts):.1f}", flush=True)
    print(f"  peak device memory {peak:.2f} GiB", flush=True)
    return res


def _event_phases(times: Dict[str, List[float]]):
    """``inpaint_video``'s ``phases``: each phase's CUDA-event time lands in
    times[phase]."""
    @contextlib.contextmanager
    def timer(name):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        yield
        end.record()
        end.synchronize()
        times.setdefault(name, []).append(start.elapsed_time(end))
    return {name: (lambda n=name: timer(n)) for name in BK_PHASES}


def bk_stage(models, frames, masks, times=None):
    """``get_bk_recover`` of the clip; with ``times``, ProPainter's phases
    timed into it. Returns (background, the back-off ratio)."""
    from mimo_tpu_torch.decomp import pipeline as DP
    inner = models.inpaint
    if times is not None:
        models.inpaint = lambda fr, m: inner(fr, m,
                                             phases=_event_phases(times))
    try:
        vp = DP.VideoProcessor(models)
        out = vp.get_bk_recover(frames, masks)
    finally:
        models.inpaint = inner
    return out, vp.bk_ratio


def run_bk(models, frames, masks) -> Dict[str, object]:
    """The bk stage untimed, then timed; prints the profile and returns
    what it measured, with both passes' backgrounds."""
    first, _ = bk_stage(models, frames, masks)
    torch.cuda.synchronize()
    times: Dict[str, List[float]] = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out, ratio = bk_stage(models, frames, masks, times)
    stage_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    t, h, w = len(frames), *frames[0].shape[:2]
    print(f"{card_line()}\nbk stage: {t} frames {h}x{w}, {stage_s:.2f} s "
          f"wall, back-off ratio {ratio}; peak device memory {peak:.2f} GiB",
          flush=True)
    for name in BK_PHASES:
        print(f"  {name}: {sum(times[name]):.1f} ms", flush=True)
    return dict(out=out, warm_up=first, times=times, peak_gib=peak,
                stage_s=stage_s, ratio=ratio)


def run_occ(models, frames) -> Dict[str, object]:
    """The JAX tool's occ stage: automask and depth on frames 0 and T // 2,
    an untimed pass then a timed one; prints each call's time and the
    flash launches by head width."""
    from mimo_tpu_torch.ops.flash_attention import flash_attention_nt

    def stage():
        return [(len(models.automask(frames[kf])), models.depth(frames[kf]))
                for kf in (0, len(frames) // 2)]

    first = stage()
    torch.cuda.synchronize()
    times: Dict[str, List[float]] = {}
    widths = Counter(flash_attention_nt.widths)
    torch.cuda.reset_peak_memory_stats()
    auto, depth = models.automask, models.depth
    models.automask = timed(times, "automask (a frame)", auto)
    models.depth = timed(times, "depth (a frame)", depth)
    try:
        out = stage()
    finally:
        models.automask, models.depth = auto, depth
    widths = flash_attention_nt.widths - widths
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"{card_line()}\nocc stage (automask + depth on frames 0 and "
          f"{len(frames) // 2}): masks {[n for n, _ in out]}; peak device "
          f"memory {peak:.2f} GiB; flash_attention_nt launches by head "
          f"width {dict(sorted(widths.items()))}", flush=True)
    for name, ts in times.items():
        print(f"  {name}: {len(ts)} call(s), " + ", ".join(
            f"{x:.1f}" for x in ts) + " ms", flush=True)
    return dict(out=out, warm_up=first, times=times, peak_gib=peak,
                widths=dict(widths))


def trace(models, frames, seed_masks, boxes, top: int = 25) -> None:
    """Device time by kernel of one track stage (the clip encoded again)
    and one automask call under torch.profiler: the top kernels, the
    device's busy time and its idle share of the wall time."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        track_stage(models, frames, seed_masks, boxes, clip_id="trace")
        models.automask(frames[0])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in rows) / 1e3
    print(f"traced track stage + automask: wall {wall:.1f} ms, device busy "
          f"{busy:.1f} ms, idle share {1 - busy / wall:.3f}; top kernels:",
          flush=True)
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"  {e.self_device_time_total / 1e3:9.2f} ms {e.count:6d}x "
              f"{e.key[:110]}", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stages", default="track",
                    help="comma-separated, of: " + ", ".join(STAGES))
    ap.add_argument("--weights-dir", default=None,
                    help="npz bundles (sam, sam2, vitpose, hmr, hamer, smpl, "
                         "raft, propainter, depth); random seeded weights "
                         "at full width without it")
    ap.add_argument("--trace", action="store_true",
                    help="also profile one track stage + automask and print "
                         "the top kernels by device time")
    args = ap.parse_args(argv)
    stages = args.stages.split(",")
    unknown = set(stages) - set(STAGES)
    if unknown:
        raise SystemExit(f"profile_decomp: unknown stage(s) "
                         f"{sorted(unknown)} (stages: {', '.join(STAGES)})")
    models = build(args.weights_dir, stages)
    clip = synth_frames(*CLIP)
    for stage in STAGES:
        if stage not in stages:
            continue
        if stage == "track":
            warm_up(models, *clip)
            run(models, *clip)
            if args.trace:
                trace(models, *clip)
        elif stage == "bk":
            run_bk(models, clip[0], clip[1])
        elif stage == "occ":
            run_occ(models, clip[0])
        else:
            run_stage(stage, models, *clip)


if __name__ == "__main__":
    main()
