"""Steady-state serving bench of the port: clips back to back on one card.

    python -m mimo_tpu_torch.tools.bench_serving [--clips 3] [--steps 30]
        [--frames 24] [--height 512] [--width 784] [--vae-chunk 8]

The counterpart of ``tools/bench_serving.py``. The single-clip bench
(``python -m mimo_tpu_torch bench``) charges every clip its own host gaps;
a serving loop can hide some of them behind work already queued on the
card. ``MIMOConfig()`` weights (bf16, random, seed 0), one warm-up clip
(inputs seeded 100), then ``--clips`` clips back to back: clip k's inputs
are drawn from a generator seeded k (``bench.make_inputs``), and clip
k+1's are drawn after clip k's ``generate_host_loop`` returns and before
the host waits for the card. Prints each clip's wall time on stderr ('#'
lines), then one JSON line: metric, value (clips x frames over the whole
wall time), unit, per_clip_s, vs_baseline.

Then one more clip's generation runs under
``torch.cuda.set_sync_debug_mode("warn")``, and the host synchronisations
it reports (each one keeps the host from running ahead of the card) are
printed by the line that made them, with their counts (a count of a
multiple of ``--steps`` is one a step). Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import warnings
from collections import Counter
from typing import Any, Callable, Dict, Optional

import torch

from mimo_tpu_torch import bench
from mimo_tpu_torch.pipelines import pose2vid


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.inference_mode()
def serve(params, st: pose2vid.Pose2VideoStatic, clips: int,
          draw_inputs: Callable[[int], Any],
          log: Callable[[str], None]) -> Dict[str, Any]:
    """One warm-up clip, then ``clips`` clips back to back, clip k on
    ``draw_inputs(k)``. Returns the JSON line and the clips' videos."""
    t0 = time.perf_counter()
    warm = draw_inputs(100)
    dev = warm[4].device
    pose2vid.generate_host_loop(params, st, *warm)
    _sync(dev)
    del warm
    log(f"warm-up clip: {time.perf_counter() - t0:.1f} s")

    per_clip, videos = [], []
    inputs = draw_inputs(0)
    t_all = time.perf_counter()
    for k in range(clips):
        t = time.perf_counter()
        out = pose2vid.generate_host_loop(params, st, *inputs)
        if k + 1 < clips:
            inputs = draw_inputs(k + 1)   # staged against the card's queue
        _sync(dev)
        per_clip.append(time.perf_counter() - t)
        videos.append(out)
        log(f"clip {k}: {per_clip[-1]:.3f} s = "
            f"{st.num_frames / per_clip[-1]:.4f} frames/s")
    total = time.perf_counter() - t_all
    fps = clips * st.num_frames / total
    line = {"metric": f"serving_steady_state_torch_{clips}clip_"
                      f"{st.num_frames}f_{st.height}x{st.width}_"
                      f"{st.num_inference_steps}step",
            "value": round(fps, 4), "unit": "frames/s",
            "per_clip_s": [round(t, 3) for t in per_clip],
            "vs_baseline": round(fps / bench.BASELINE_FPS, 4)}
    return dict(line=line, videos=videos)


def host_syncs(params, st: pose2vid.Pose2VideoStatic, inputs) -> Counter:
    """The host synchronisations of one generation on the card, by
    (file:line, message), from ``torch.cuda.set_sync_debug_mode("warn")``."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            pose2vid.generate_host_loop(params, st, *inputs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return Counter((f"{os.path.relpath(w.filename, root)}:{w.lineno}",
                    str(w.message).split(" (Triggered")[0])
                   for w in caught
                   if "called a synchronizing" in str(w.message))


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clips", type=int, default=3)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--width", type=int, default=784)
    ap.add_argument("--vae-chunk", type=int, default=8)
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("bench_serving needs a CUDA device "
                         "(torch.cuda.is_available() is False)")
    from mimo_tpu_torch.config import MIMOConfig
    from mimo_tpu_torch.entry.runner import init_random_params
    from mimo_tpu_torch.tools.timing import card_line
    log = bench.stderr_log(t0)
    log(f"card: {card_line()}")
    dev, dtype = torch.device("cuda"), torch.bfloat16
    cfg = MIMOConfig()
    params = init_random_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dtype=dtype)
    st = pose2vid.Pose2VideoStatic(
        cfg=cfg, num_frames=args.frames, height=args.height,
        width=args.width, num_inference_steps=args.steps,
        guidance_scale=bench.GUIDANCE, vae_chunk=args.vae_chunk)

    def draw(seed):
        return bench.make_inputs(cfg, args.frames, args.height, args.width,
                                 dev, dtype, seed)

    res = serve(params, st, args.clips, draw, log)
    print(json.dumps(res["line"]), flush=True)
    syncs = host_syncs(params, st, draw(args.clips))
    log(f"host synchronisations in one more clip's generation, "
        f"{args.steps} steps (torch.cuda.set_sync_debug_mode('warn')): "
        f"{sum(syncs.values())}")
    for (where, msg), n in syncs.most_common():
        log(f"  {n} at {where}: {msg}")


if __name__ == "__main__":
    main()
