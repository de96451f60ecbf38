"""Sets of runs of one cell, the measurement that the bounds in
``BENCHMARK.json`` are set from (not part of a benchmark run):

    python3 benchmark/sets.py --workload <cell> --seeds 11,12,13,14,15,16 \\
        --seconds 34 --out chiprun_out/sets [--sets 2] [--check 1]

Every run is a fresh process, as the driver's are, and every set runs the
same seeds in the same order. Each run's standard output and error go to
``<out>/<set>_<seed>.out`` and ``.err``. The last line of standard output is
a JSON summary: for each end-to-end metric each set's values, median and
quartile spread (``statistics.quantiles(values, n=4)``, q3 less q1 over the
median), the widest spread, five times it, and the second set's median over
the first's. With ``--check 0`` the runs leave out the reference after the
window: it runs once the window has closed and the peak has been read, so
it changes no metric, and their ``correct`` is null.
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import run as R  # noqa: E402  (its import starts setup_s)

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402


def spread(values: List[float]) -> float:
    """The quartile spread as a share of the median (0 where the median
    is)."""
    if len(values) < 2:
        return 0.0
    q1, _, q3 = statistics.quantiles(values, n=4)
    med = statistics.median(values)
    return (q3 - q1) / med if med else 0.0


def summarize(runs: Dict[str, List[dict]]) -> dict:
    """``runs``: set name -> result lines, in seed order."""
    names = sorted({m for lines in runs.values() for line in lines
                    for m in line["metrics"]})
    out: Dict[str, dict] = {}
    for name in names:
        per_set = {}
        for s, lines in runs.items():
            vals = [line["metrics"][name]["value"] for line in lines
                    if name in line["metrics"]]
            per_set[s] = {"values": vals,
                          "median": statistics.median(vals) if vals else None,
                          "spread": spread(vals)}
        widest = max(v["spread"] for v in per_set.values())
        meds = [v["median"] for v in per_set.values()]
        out[name] = {"sets": per_set, "widest_spread": widest,
                     "five_times": 5 * widest,
                     "second_over_first": (meds[1] / meds[0]
                                           if len(meds) > 1 and meds[0]
                                           else None)}
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--check", type=int, choices=(0, 1), default=1)
    ap.add_argument("--one", action="store_true",
                    help="one run in this process (what each run spawns)")
    args = ap.parse_args(argv)
    run_args = ["--workload", args.workload, "--seconds", args.seconds,
                "--trace", "0"]
    if args.one:
        return R.main(run_args + ["--seed", args.seeds],
                      check_clip=bool(args.check))
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    runs: Dict[str, List[dict]] = {}
    for k in range(args.sets):
        name = "AB"[k] if args.sets <= 2 else f"S{k}"
        runs[name] = []
        for seed in args.seeds.split(","):
            base = out / f"{name}_{seed}"
            with open(f"{base}.out", "w") as fo, \
                    open(f"{base}.err", "w") as fe:
                rc = subprocess.run(
                    [sys.executable, str(Path(__file__).resolve()), "--one",
                     "--workload", args.workload, "--seeds", seed,
                     "--seconds", args.seconds, "--out", args.out,
                     "--check", str(args.check)],
                    stdout=fo, stderr=fe, cwd=ROOT).returncode
            lines = Path(f"{base}.out").read_text().strip().splitlines()
            print(f"set {name} seed {seed} rc={rc}: "
                  f"{lines[-1][:600] if lines else 'no result'}", flush=True)
            if rc == 0 and lines:
                runs[name].append(json.loads(lines[-1]))
    print(json.dumps({"workload": args.workload, "seconds": args.seconds,
                      "check": args.check, "metrics": summarize(runs)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
