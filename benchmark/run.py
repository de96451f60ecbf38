"""One run of one cell of the benchmark of ``mimo_tpu_torch`` (the PyTorch
and CUDA port of MIMO), on the machine it is started on:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

(``python -m benchmark.run`` works as well). A run:

1. set-up: imports the port, draws the weights on the card from the seed
   (``reference/params.py``), makes the traffic's inputs
   (``traffic/generator.py``), and warms up the cell's shapes with one
   1-step generation through the cell's entry; the kernel library is built
   once per checkout into ``mimo_tpu_torch/_build/``. ``setup_s`` is the
   time from the process's start to here; each phase's time is logged.
2. the window: clips back to back from one client (a closed loop), each
   through the user-facing entry that the configuration names
   (``entries/<entry>.py``: ``entry.animate.animate`` or ``entry.edit.edit``
   on a ``Runner``), numpy in and frames out; a clip
   starts only while the clip before it would still end inside
   ``--seconds``, and there is always one. The window runs from the first
   clip's hand-off to the last clip's return.
3. with ``--trace 1``, one more clip under ``torch.profiler`` (its inputs
   the next clip's), reduced in memory (``work/trace.py``), and the clip's
   work counted from its shapes (``work/count.py``).
4. the check: one clip of the window, drawn from the seed, against the
   plain float32 reference (``reference/``) on the same inputs, run once
   the window has closed, the peak has been read and the program's state
   is freed; the numbers and their limits (``workloads/<cell>.json``) are
   printed last on stderr and last in the result line.
5. the result: one JSON line on stdout with ``correct``, ``attempted``,
   ``failed`` (clips), ``metrics`` (the cell's end-to-end metrics, or its
   per-layer ones with ``--trace 1``, each read by ``metrics/<name>.py``),
   ``device``, ``breakdown`` (traced) and ``checks``.

It exits non-zero with no result where CUDA is missing or has fewer cards
than the cell asks for, and where ``jax``, ``jaxlib``, ``flax`` or the JAX
package ``mimo_tpu`` is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Any, Callable, Dict, List, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# every kernel cache at a fixed place inside the checkout
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[_var] = str(ROOT / "benchmark" / ".cache" / _sub)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import check  # noqa: E402
from benchmark import spec as S  # noqa: E402
from benchmark.reference import nn  # noqa: E402
from benchmark.reference import params as P  # noqa: E402
from benchmark.traffic import generator as G  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "mimo_tpu")


def log(msg: str) -> None:
    print(f"# [{time.perf_counter() - T_START:7.1f}s] {msg}",
          file=sys.stderr, flush=True)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is a forbidden one, whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return res.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi not readable"


def _frames_of(out) -> int:
    return 0 if out is None else len(out)


def run_cell(cell: str, seed: int, seconds: float, trace: bool, *,
             device: torch.device,
             cfg_path: Optional[Path] = None,
             traffic: Optional[Dict[str, Any]] = None,
             limits: Optional[Dict[str, float]] = None,
             bench: Optional[Dict[str, Any]] = None,
             t_start: float = T_START, check_clip: bool = True
             ) -> Dict[str, Any]:
    """One run; returns the result line. The keyword arguments other than
    ``device`` stand in for the cell's files (the CPU tests' tiny sizes).
    ``check_clip`` False skips the reference after the window (``sets.py``
    measuring spreads); ``correct`` is then None."""
    bench = bench or S.benchmark()
    w = S.workload(bench, cell)
    cfg_path = cfg_path or S.BENCH / "configs" / f"{w['config']}.json"
    cfg = S.load_json(cfg_path)
    entry = S.entry(cfg["entry"])
    traffic = traffic or G.load(w["traffic"])
    limits = limits or S.limits(cell)
    cuda = device.type == "cuda"
    dtype = torch.bfloat16 if cuda else torch.float32

    # set-up
    phases: Dict[str, float] = {"start": time.perf_counter() - t_start}
    t = time.perf_counter()

    def phase(name: str) -> None:
        nonlocal t
        sync(device)
        now = time.perf_counter()
        phases[name], t = now - t, now

    torch.zeros(1, device=device)
    phase("device")
    gen = torch.Generator(device=device).manual_seed(G.weights_seed(seed))
    params = P.draw(entry.layout(cfg), gen, dtype)
    phase("weights")
    program = entry.Program(cfg, cfg_path, params, device, dtype)
    phase("program")
    inputs = [G.clip_inputs(traffic, seed, k)
              for k in range(traffic["max_clips"])]
    warm = G.clip_inputs(traffic, seed, G.WARM)
    phase("inputs")
    program.clip(warm, steps=1)
    phase("warm_up")
    setup_s = time.perf_counter() - t_start
    log("set-up " + ", ".join(f"{k} {v:.3f} s" for k, v in phases.items())
        + f"; setup_s {setup_s:.3f}")
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    # the window
    clips: List[Dict[str, Any]] = []
    outputs: List[Any] = []
    t_open = time.perf_counter()
    for k, inp in enumerate(inputs):
        t0 = time.perf_counter()
        try:
            out = program.clip(inp)
        except Exception:  # a clip that fails counts, and the run goes on
            traceback.print_exc()
            out = None
        t1 = time.perf_counter()
        clips.append({"wall_s": t1 - t0, "frames": _frames_of(out),
                      "ok": out is not None, "timings": program.timings()})
        outputs.append(out)
        log(f"clip {k}: {t1 - t0:.4f} s, {_frames_of(out)} frames, "
            f"timings {clips[-1]['timings']}")
        if (t1 - t_open) + (t1 - t0) > seconds:
            break
    window_s = t1 - t_open
    sync(device)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    summary, work = None, None
    if trace:
        from benchmark.work import trace as TR
        inp = G.clip_inputs(traffic, seed, len(clips))
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function(TR.RANGE):
                program.clip(inp)
        t = time.perf_counter()
        summary = TR.summarize(prof)
        del prof
        log(f"trace reduced in {time.perf_counter() - t:.1f} s")
        from mimo_tpu_torch.ops import launch_counts
        log(f"kernel launches: {json.dumps(launch_counts())}")
        work = entry.work(cfg, entry.frames(inp))
        log(f"work of a clip: {json.dumps(work)}")

    # the program's state goes before the reference runs
    ref_params = _detached(params)
    del program, params
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    ok = [i for i, c in enumerate(clips) if c["ok"]]
    numbers = {k: float("inf") for k in check.NUMBERS}
    if ok and check_clip:
        j = ok[G.checked_clip(seed, len(ok))]
        nn.fp32_only()
        t = time.perf_counter()
        ref = entry.reference(cfg, ref_params, inputs[j], device)
        numbers = check.gaps(outputs[j], ref)
        log(f"reference of clip {j}: {time.perf_counter() - t:.1f} s")
    correct = len(ok) == len(clips) and check.judge(numbers, limits)

    rec = {"setup_s": setup_s, "window_s": window_s, "clips": clips,
           "peak_bytes": peak, "trace": summary, "work": work}
    metrics = {}
    for m in S.metrics_of(bench, cell, trace):
        value = S.reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    result: Dict[str, Any] = {
        "correct": correct if check_clip else None, "attempted": len(clips),
        "failed": len(clips) - len(ok), "metrics": metrics, "device": dev}
    if summary is not None:
        dev.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = {k: {"value": numbers[k], "limit": limits[k]}
                        for k in limits}
    return result


def _detached(tree):
    """The same tensors as new objects (the program's keyed copies of the
    old ones are dropped with them)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach()
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_detached(v) for v in tree]
    return tree


def main(argv: Optional[List[str]] = None,
         emit: Callable[[str], None] = print, check_clip: bool = True) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = S.benchmark()
    chips = S.workload(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), device=torch.device("cuda", 0),
                      bench=bench, check_clip=check_clip)
    log(f"card: {card_line()}")
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    emit(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
