"""Where the time goes on the card: one timed generation and a profiled
denoise step of the port, at full MIMOConfig() width with random weights.

    python -m mimo_tpu_torch.entry.profile [--steps 30] [--frames 24]
        [--height 512] [--width 784] [--top 25]

Prints the card's name and power limit, the generation's phase times
(CUDA events: prepare, mean step, decode) and frames per second, then one
denoise step under torch.profiler: device time by kernel (top N), the
device-busy total and the step's wall time. Needs CUDA.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import torch

from mimo_tpu_torch.bench import make_inputs
from mimo_tpu_torch.config import MIMOConfig
from mimo_tpu_torch.entry.runner import init_random_params
from mimo_tpu_torch.pipelines import pose2vid


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--width", type=int, default=784)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)

    dev, dt = torch.device("cuda"), torch.bfloat16
    cfg = MIMOConfig()
    params = init_random_params(cfg, torch.Generator(device=dev).manual_seed(0),
                                dtype=dt)
    st = pose2vid.Pose2VideoStatic(
        cfg=cfg, num_frames=args.frames, height=args.height, width=args.width,
        num_inference_steps=args.steps, guidance_scale=3.5)
    inputs = make_inputs(cfg, args.frames, args.height, args.width, dev, dt)

    for run in ("warm-up", "timed"):
        clock = pose2vid.PhaseClock(dev)
        t0 = time.perf_counter()
        pose2vid.generate_host_loop(params, st, *inputs, clock=clock)
        tm = clock.timings()
        wall = time.perf_counter() - t0
        steps = tm["step_ms"]
        print(f"{run}: {args.frames} frames {args.height}x{args.width}, "
              f"{args.steps} steps: wall {wall:.3f} s = "
              f"{args.frames / wall:.4f} frames/s | prepare "
              f"{tm['prepare']:.1f} ms | step mean {tm['step_mean']:.1f} ms "
              f"(min {min(steps):.1f}, max {max(steps):.1f}) | decode "
              f"{tm['decode']:.1f} ms", flush=True)

    # one denoise step under the profiler
    with torch.inference_mode():
        cond = pose2vid.prepare_conditioning(params, st, *inputs[:4])
        win, wts = pose2vid.make_windows(st)
        counter = torch.as_tensor(
            pose2vid._window_counter(st.num_frames, win, wts), device=dev)
        lat = inputs[4]

        def step():
            return pose2vid._accumulate_step(
                params["denoising_unet"], st, cond, lat, 500.0, win, wts,
                counter)

        step()
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    # kernel rows only: a CPU op's row repeats the time of its kernels
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA")
              and e.self_device_time_total > 0]
    events.sort(key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in events) / 1e3
    print(f"profiled step: wall {wall_ms:.1f} ms, device busy {busy:.1f} ms "
          f"(idle share {max(0.0, 1 - busy / wall_ms):.3f})")
    print(f"{'device ms':>10} {'share':>6} {'calls':>6}  kernel")
    for e in events[:args.top]:
        t = e.self_device_time_total / 1e3
        print(f"{t:10.2f} {t / busy:6.3f} {e.count:6d}  {e.key[:110]}")


if __name__ == "__main__":
    main()
