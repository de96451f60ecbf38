"""Per-call profile of the decomposition half's human-tracking stage on the
card.

    python -m mimo_tpu_torch.tools.profile_decomp --stages track \
        [--weights-dir DIR] [--trace]

The port's counterpart of ``tools/profile_decomp.py``'s ``track`` stage,
the only stage ported so far: SAM ViT-H, SAM2 Hiera-L and ViTPose-H at full
width (seeded random bf16 weights without ``--weights-dir``) on the same
synthetic moving-figure clip (``synth_frames``, 48 frames of 720x480,
``CLIP``). Random weights reject
every person, so the gating is bypassed as the JAX tool does: the figure's
known box on frame 0 prompts SAM (``segment_box`` + ``clean_mask``), SAM2
tracks the figure's known frame-0 mask forwards and backwards, and
``get_bbox`` boxes the cleaned masks. One
``automatic_masks`` call and one ``PoseScoredDetector`` call on frame 0
follow (the detector's path, run for its cost).

After one untimed warm-up pass, prints each call's time (CUDA events
around it; host work inside it counts), the peak device memory, the flash
kernel's launches by head width and the card's name and power limit;
``--trace`` adds the top kernels of one more pass by device time
(torch.profiler) and the device's idle share.
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

STAGES = ("track",)
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
          "sam2 init_state (host resize + encode)")
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


def build(weights_dir=None):
    """The track stage's models (SAM, SAM2, ViTPose) on the card in bf16."""
    from mimo_tpu_torch.decomp.factory import build_decomp_models
    if not torch.cuda.is_available():
        raise SystemExit("profile_decomp: needs a CUDA device")
    t0 = time.perf_counter()
    models = build_decomp_models(weights_dir, dtype=torch.bfloat16,
                                 only={"sam", "sam2", "vitpose"})
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
                    help="comma-separated; ported: " + ", ".join(STAGES))
    ap.add_argument("--weights-dir", default=None,
                    help="npz bundles (sam, sam2, vitpose); random seeded "
                         "weights at full width without it")
    ap.add_argument("--trace", action="store_true",
                    help="also profile one track stage + automask and print "
                         "the top kernels by device time")
    args = ap.parse_args(argv)
    missing = set(args.stages.split(",")) - set(STAGES)
    if missing:
        raise SystemExit(f"profile_decomp: stage(s) {sorted(missing)} not "
                         f"ported yet (ported: {', '.join(STAGES)})")
    models = build(args.weights_dir)
    clip = synth_frames(*CLIP)
    warm_up(models, *clip)
    run(models, *clip)
    if args.trace:
        trace(models, *clip)


if __name__ == "__main__":
    main()
