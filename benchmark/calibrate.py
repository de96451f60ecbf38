"""Readings that the correctness limits of a cell are set from (not part of
a benchmark run):

    python3 benchmark/calibrate.py --workload <cell> --seeds 11,12,13 \\
        [--program 0|1] [--control 0|1]

For each seed, in one process: the weights and clip 0's inputs as a run of
that seed makes them; the float32 reference's video (TF32 off); with
``--program 1`` the program's video through the cell's entry and its gaps
to the reference; with ``--control 1`` the control's: the reference again
with every product's operands rounded to float8 e4m3 (``reference/nn.py``),
the precision below the configuration's bfloat16, and its gaps. Each
reading is one JSON line on stdout; the limits in ``workloads/<cell>.json``
lie between the program's largest and the control's smallest.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import check  # noqa: E402
from benchmark import run as R  # noqa: E402
from benchmark import spec as S  # noqa: E402
from benchmark.reference import nn  # noqa: E402
from benchmark.reference import params as P  # noqa: E402
from benchmark.traffic import generator as G  # noqa: E402


def spread(a, b) -> dict:
    """The compared numbers and a few more quantiles of |a - b|."""
    out = check.gaps(a, b)
    x, y = check.as_unit(a), check.as_unit(b)
    if x.shape == y.shape:
        d = np.abs(x.astype(np.float64) - y.astype(np.float64)).ravel()
        out.update(p99_abs=float(np.quantile(d, 0.99)),
                   max_abs=float(d.max()), rms=float(np.sqrt((d ** 2).mean())))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--program", type=int, default=1)
    ap.add_argument("--control", type=int, default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: needs CUDA", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    w = S.workload(S.benchmark(), args.workload)
    cfg_path = S.BENCH / "configs" / f"{w['config']}.json"
    cfg = S.load_json(cfg_path)
    entry = S.entry(cfg["entry"])
    traffic = G.load(w["traffic"])
    R.log(f"card: {R.card_line()}")
    for seed in (int(s) for s in args.seeds.split(",")):
        gen = torch.Generator(device=dev).manual_seed(G.weights_seed(seed))
        params = P.draw(entry.layout(cfg), gen, torch.bfloat16)
        inp = G.clip_inputs(traffic, seed, 0)
        line = {"workload": args.workload, "seed": seed}
        if args.program:
            program = entry.Program(cfg, cfg_path, params, dev,
                                    torch.bfloat16)
            t = time.perf_counter()
            out = program.clip(inp)
            line["program_s"] = time.perf_counter() - t
            del program
        ref_params = R._detached(params)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        nn.fp32_only()
        t = time.perf_counter()
        ref = entry.reference(cfg, ref_params, inp, dev)
        line["reference_s"] = time.perf_counter() - t
        if args.program:
            line["program"] = spread(out, ref)
        if args.control:
            t = time.perf_counter()
            with nn.operands("fp8"):
                ctl = entry.reference(cfg, ref_params, inp, dev)
            line["control_s"] = time.perf_counter() - t
            line["control"] = spread(ctl, ref)
        print(json.dumps(line), flush=True)
        del ref_params
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
