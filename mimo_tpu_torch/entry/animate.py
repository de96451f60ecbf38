"""Character image animation (run_animate.py semantics): sdc-only template,
white background, global human crop, raw pipeline output.

Counterpart of ``mimo_tpu/entry/animate.py``. ``animate`` takes a template
directory or the sdc pose frames already in memory.

CLI: python -m mimo_tpu_torch.entry.animate --ref ref.png --template dir/ \
        --output out.mp4 [--weights bundle.npz] [--W 784 --H 784 ...]
The CLI runs on a CUDA device and raises without one.
"""

from __future__ import annotations

import argparse
import os
from typing import Sequence, Tuple, Union

import numpy as np
import torch

from mimo_tpu_torch.config import DTypePolicy, MIMOConfig
from mimo_tpu_torch.entry.runner import (Runner, init_random_params,
                                         load_params, prep_reference_image)
from mimo_tpu_torch.entry.template import load_template
from mimo_tpu_torch.utils import frames as FU
from mimo_tpu_torch.utils import video_io as VIO


def animate(runner: Runner, ref_img: np.ndarray,
            template: Union[str, os.PathLike, Sequence[np.ndarray]], *,
            width: int = 784, height: int = 784, steps: int = 25,
            cfg_scale: float = 3.5, seed: int = 42,
            max_frames: int = 150,
            interpolation_factor: int = 0) -> np.ndarray:
    """Returns the (F', height, width, 3) float video in [0, 1], F' = F or
    (F-1)*interpolation_factor + 1 when the factor is >= 2.
    ``template``: a template directory, or the sdc pose frames as (H, W, 3)
    uint8 arrays. The call is one clip of ``runner`` (``Runner.clip``):
    its spans and phases are in ``runner.last_timings`` when it returns."""
    with runner.clip("entry.animate") as clock:
        with clock.span("entry.template"):
            if isinstance(template, (str, os.PathLike)):
                pose_frames = load_template(os.fspath(template),
                                            max_frames=max_frames).sdc
            else:
                pose_frames = list(template)[:max_frames]
            if not pose_frames:
                raise ValueError("template has no pose frames")
            pose, bk = crop_template(runner, pose_frames, clock)
        with clock.span("entry.reference"):
            ref = prep_reference_image(ref_img)

        job = runner.inputs(ref, pose, bk, width=width, height=height,
                            steps=steps, cfg_scale=cfg_scale, seed=seed,
                            interpolation_factor=interpolation_factor,
                            clock=clock)
        # the template's frames leave the device before the pipeline
        del pose, bk
        return runner.to_host(runner.run(job, clock), clock)


def crop_template(runner: Runner, pose_frames: Sequence[np.ndarray],
                  clock) -> Tuple[torch.Tensor, torch.Tensor]:
    """The human crop of the sdc frames on the runner's device: uploaded
    once as uint8, boxed (``FU.sdc_rects``), cropped to the union box
    (``FU.union_box``) and padded black to a 16-multiple square; and the
    white background at the padded size, which is what ``FU.init_bk`` ->
    crop -> ``FU.pad_img`` makes. Returns the (F, S, S, 3) uint8 pose and
    background."""
    sdc = runner.upload(pose_frames, clock)
    rects = FU.sdc_rects(sdc, clock=clock)
    shape = sdc.shape[1:3]
    x, x_max, y, y_max = FU.union_box(FU.sdc_box(r, shape) for r in rects)
    pose, _ = FU.pad_frames(sdc[:, y:y_max, x:x_max], (0, 0, 0))
    return pose, torch.full_like(pose, 255)


def main(argv=None):
    ap = argparse.ArgumentParser(description="MIMO character animation "
                                             "(PyTorch port)")
    ap.add_argument("--ref", required=True)
    ap.add_argument("--template", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--weights", default=None,
                    help=".npz bundle from `python -m "
                         "mimo_tpu_torch.weights.convert` "
                         "(random init if omitted — smoke-test mode)")
    ap.add_argument("--W", type=int, default=784)
    ap.add_argument("--H", type=int, default=784)
    ap.add_argument("--steps", type=int, default=25)
    ap.add_argument("--cfg", type=float, default=3.5)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--max-frames", type=int, default=150)
    ap.add_argument("--interp", type=int, default=0,
                    help="latent interpolation factor (frame-rate "
                         "upsampling; reference pipeline "
                         "interpolation_factor)")
    args = ap.parse_args(argv)

    # validate inputs before the (slow) model init
    tpl_probe = load_template(args.template, max_frames=1)
    ref = VIO.load_image(args.ref)

    if not torch.cuda.is_available():
        raise RuntimeError("mimo_tpu_torch.entry.animate needs a CUDA device "
                           "(torch.cuda.is_available() is False); the "
                           "library API (Runner, animate) takes an explicit "
                           "device")
    device = torch.device("cuda")
    dtype = DTypePolicy.for_device(device).compute_dtype
    cfg = MIMOConfig()
    if args.weights:
        params = load_params(args.weights, device=device, dtype=dtype)
    else:
        gen = torch.Generator(device=device).manual_seed(0)
        params = init_random_params(cfg, gen, dtype=dtype)
    runner = Runner(cfg=cfg, params=params, device=device, dtype=dtype)
    video = animate(runner, ref, args.template, width=args.W, height=args.H,
                    steps=args.steps, cfg_scale=args.cfg, seed=args.seed,
                    max_frames=args.max_frames,
                    interpolation_factor=args.interp)
    VIO.save_video(video, args.output, fps=tpl_probe.fps)
    print(f"saved {video.shape[0]} frames to {args.output}")


if __name__ == "__main__":
    main()
