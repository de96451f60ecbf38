"""A whole run of each cell at the tiny sizes on the CPU (the harness's look
for a card skipped): sound, it comes out correct; with the timed path
broken underneath, not; the control reads above the cell's limits; the
window rule and the metric arithmetic on a fake entry; the result line's
keys; and the imports of the harness and the reference."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from benchmark import check
from benchmark import run as R
from benchmark import spec as S
from benchmark.reference import nn
from benchmark.reference import params as P
from benchmark.traffic import generator as G

import bench_tiny

from mimo_tpu_torch.pipelines import pose2vid
from mimo_tpu_torch.schedulers import ddim

CPU = torch.device("cpu")
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def tiny_run(entry, tmp_path, seed=2 ** 31 + 11, seconds=0.0, trace=False):
    return R.run_cell(bench_tiny.CELLS[entry], seed, seconds, trace,
                      device=CPU,
                      cfg_path=bench_tiny.config_file(entry, tmp_path),
                      traffic=bench_tiny.traffic(entry))


@pytest.mark.parametrize("entry", ["animate", "edit"])
@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(entry, trace, tmp_path):
    res = tiny_run(entry, tmp_path, trace=trace)
    assert res["correct"] and res["attempted"] == 1 and res["failed"] == 0
    keys = list(res)
    assert keys[:5] == RESULT_KEYS and keys[-1] == "checks"
    assert ("breakdown" in res) == trace
    bench = S.benchmark()
    names = {m["name"] for m in S.metrics_of(bench, bench_tiny.CELLS[entry],
                                             trace)}
    if trace:   # no card: the device's metrics find nothing to read
        names -= {"kernels.flash40_roofline", "kernels.gemm_roofline"}
        assert set(res["device"]) >= {"busy_s", "window_s"}
    assert set(res["metrics"]) == names
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and np.isfinite(m["value"])
    for c in res["checks"].values():
        assert c["value"] <= c["limit"]


def _halve_frames(orig):
    """The UNet on the first half of each window's frames, its result
    repeated over the rest."""
    def run(params_du, st, cond, latents, t, w_idx, *a, **kw):
        half = w_idx.shape[1] // 2
        pred = orig(params_du, st, cond, latents, t, w_idx[:, :half], *a,
                    **kw)
        return torch.cat([pred, pred[:, :w_idx.shape[1] - half]], dim=1)
    return run


def _alter_frame(orig):
    """Frame 0 of the decoded video mirrored where it is produced."""
    def decode(params, st, latents):
        video = orig(params, st, latents).clone()
        video[0] = video[0].flip(1)
        return video
    return decode


FAULTS = {
    "step_returns_state": lambda mp: mp.setattr(
        ddim.DDIM, "step_v", lambda self, v, i, x, *a, **k: x),
    "half_the_frames": lambda mp: mp.setattr(
        pose2vid, "_run_unet_window_chunk",
        _halve_frames(pose2vid._run_unet_window_chunk)),
    "answer_altered": lambda mp: mp.setattr(
        pose2vid, "decode_frames", _alter_frame(pose2vid.decode_frames)),
}


@pytest.mark.parametrize("entry", ["animate", "edit"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_timed_path_is_not_correct(entry, fault, tmp_path,
                                          monkeypatch):
    FAULTS[fault](monkeypatch)
    res = tiny_run(entry, tmp_path)
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


@pytest.mark.parametrize("entry", ["animate", "edit"])
def test_control_reads_above_the_limits(entry):
    """The reference one precision below the configuration's (float8
    operands) in the program's place fails the cell's limits."""
    cfg = bench_tiny.config(entry)
    limits = S.limits(bench_tiny.CELLS[entry])
    E = S.entry(entry)
    for seed in (1, 2, 3):
        params = P.draw(E.layout(cfg), torch.Generator().manual_seed(seed),
                        torch.float32)
        inp = G.clip_inputs(bench_tiny.traffic(entry), seed, 0)
        ref = E.reference(cfg, params, inp, CPU)
        with nn.operands("fp8"):
            ctl = E.reference(cfg, params, inp, CPU)
        assert not check.judge(check.gaps(ctl, ref), limits)


TIMINGS = {"prepare": 10.0, "step_mean": 5.0, "decode": 10.0, "steps": 2}


class FakeEntry:
    """An entry that takes 0.1 s a clip and returns 3 frames."""

    layout = staticmethod(P.layout)

    class Program:
        def __init__(self, *a, **k):
            pass

        def clip(self, inp, steps=None):
            time.sleep(0.1 if steps is None else 0.0)
            return np.zeros((3, 4, 4, 3), np.float32)

        def timings(self):
            return dict(TIMINGS)

    @staticmethod
    def reference(*a):
        return np.zeros((3, 4, 4, 3), np.float32)


def test_window_rule_and_metric_arithmetic(tmp_path, monkeypatch):
    monkeypatch.setattr(S, "entry", lambda name: FakeEntry)
    t0 = time.perf_counter()
    res = R.run_cell(bench_tiny.CELLS["animate"], 5, 0.25, False,
                     device=CPU,
                     cfg_path=bench_tiny.config_file("animate", tmp_path),
                     traffic=bench_tiny.traffic("animate"), t_start=t0)
    # a clip starts only while the one before would end inside 0.25 s
    assert res["attempted"] == 2 and res["correct"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert m["clip_s_max"] == pytest.approx(0.1, abs=0.03)
    assert m["frames_per_s"] == pytest.approx(6 / 0.2, rel=0.15)
    assert m["setup_s"] < m["clip_s_max"] + 5
    at_least_one = R.run_cell(bench_tiny.CELLS["animate"], 5, 0.0, False,
                              device=CPU,
                              cfg_path=bench_tiny.config_file("animate",
                                                              tmp_path),
                              traffic=bench_tiny.traffic("animate"))
    assert at_least_one["attempted"] == 1
    rec = {"clips": [{"ok": True, "wall_s": 0.1, "frames": 3,
                      "timings": TIMINGS}] * 2}
    assert S.reader("entry.host_ms")(rec) == pytest.approx(70.0)
    assert S.reader("pipeline.step_ms")(rec) == 5.0


@pytest.mark.parametrize("typed", [True, False])
def test_trace_reduction_on_known_events(typed):
    """Busy time is the union of device operations inside the range; gaps
    are named by the innermost host event at their middle. ``typed``: the
    events say their activity type (torch 2.13 on), or they do not."""
    class E:
        def __init__(self, name, s, e, cuda=False, act="kernel"):
            self._n, self._s, self._d = name, s, e - s
            self._cuda = cuda
            if typed:
                self.activity_type = lambda: act

        def name(self):
            return self._n

        def start_ns(self):
            return self._s

        def duration_ns(self):
            return self._d

        def device_type(self):
            return (torch.autograd.DeviceType.CUDA if self._cuda
                    else torch.autograd.DeviceType.CPU)

    events = [E("benchmark.clip", 0, 1000),
              E("benchmark.clip", 0, 1000, True, "gpu_user_annotation"),
              E("aten::resize", 0, 300), E("numpy_thing", 50, 100),
              E("k1", 300, 500, True), E("k2", 400, 600, True),
              E("k1", 800, 900, True)]

    class Prof:
        class profiler:
            class kineto_results:
                @staticmethod
                def events():
                    return events

    from benchmark.work import trace
    s = trace.summarize(Prof)
    assert s["window_s"] == pytest.approx(1e-6)
    assert s["busy_s"] == pytest.approx(4e-7)
    assert s["kernels"] == {"k1": pytest.approx(3e-7),
                            "k2": pytest.approx(2e-7)}
    assert s["idle_gaps"][0] == ["benchmark.clip/aten::resize",
                                 pytest.approx(3e-7)]
    assert [g[1] for g in s["idle_gaps"]] == pytest.approx(
        [3e-7, 2e-7, 1e-7])


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    lines = []
    rc = R.main(["--workload", "animate-24f-512x784", "--seed", "1",
                 "--seconds", "1"], emit=lines.append)
    assert rc != 0 and lines == []


FORBIDDEN_CHECK = r"""
import sys
sys.path.insert(0, {root!r})
import benchmark.run, benchmark.calibrate, benchmark.work.count
import benchmark.work.trace, benchmark.sets
import benchmark.entries.animate, benchmark.entries.edit
bad = sorted({{m.split('.')[0] for m in sys.modules}}
             & {{'jax', 'jaxlib', 'flax', 'mimo_tpu'}})
port = sorted(m for m in sys.modules if m.split('.')[0] == 'mimo_tpu_torch')
print(bad, port)
"""

REFERENCE_ONLY = r"""
import sys
sys.path.insert(0, {root!r})
import benchmark.reference.pipeline, benchmark.reference.params
import benchmark.check, benchmark.traffic.generator
print(sorted({{m.split('.')[0] for m in sys.modules}}
             & {{'jax', 'jaxlib', 'flax', 'mimo_tpu', 'mimo_tpu_torch'}}))
"""


def _fresh(code):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c",
                          code.format(root=str(S.ROOT))],
                         capture_output=True, text=True, env=env,
                         timeout=300, check=True)
    return out.stdout.strip().splitlines()[-1]


def test_harness_loads_no_jax_and_reference_no_program():
    assert _fresh(REFERENCE_ONLY) == "[]"
    assert _fresh(FORBIDDEN_CHECK).startswith("[] ")
    assert R.forbidden_modules() == [] or "jax" in sys.modules


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "mimo_tpu_torch_x", sys)
    assert "mimo_tpu" not in R.forbidden_modules()
    monkeypatch.setitem(sys.modules, "mimo_tpu.config", sys)
    assert "mimo_tpu" in R.forbidden_modules()


@pytest.mark.card
def test_cell_runs_on_the_card():
    """One short run of each cell through the command, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for cell in [w["name"] for w in S.benchmark()["workloads"]]:
        out = subprocess.run(
            [sys.executable, "benchmark/run.py", "--workload", cell,
             "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
            cwd=S.ROOT, capture_output=True, text=True, timeout=360,
            check=True)
        assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]


def test_run_without_the_check_reads_the_same_metrics(tmp_path):
    """``sets.py --check 0``: the reference is left out after the window,
    the metrics are read as in a checked run, ``correct`` is None."""
    res = R.run_cell(bench_tiny.CELLS["animate"], 2 ** 31 + 11, 0.0, False,
                     device=CPU,
                     cfg_path=bench_tiny.config_file("animate", tmp_path),
                     traffic=bench_tiny.traffic("animate"), check_clip=False)
    assert res["correct"] is None and res["attempted"] == 1
    names = {m["name"] for m in S.metrics_of(S.benchmark(),
                                             bench_tiny.CELLS["animate"],
                                             False)}
    assert set(res["metrics"]) == names


def test_sets_spread_is_the_quartile_rule():
    from benchmark import sets
    vals = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    # statistics' exclusive method: q1 at 1.75 of 7 places, q3 at 5.25
    assert sets.spread(vals) == pytest.approx((14.25 - 10.75) / 12.5)
    line = lambda v: {"metrics": {"m": {"value": v, "unit": "s"}}}  # noqa
    s = sets.summarize({"A": [line(v) for v in vals],
                        "B": [line(2 * v) for v in vals]})["m"]
    assert s["widest_spread"] == pytest.approx(sets.spread(vals))
    assert s["five_times"] == pytest.approx(5 * s["widest_spread"])
    assert s["second_over_first"] == pytest.approx(2.0)
