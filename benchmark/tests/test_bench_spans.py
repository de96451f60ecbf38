"""The harness reading the clip's spans: a traced run of each cell at the
tiny sizes on the CPU reports ``entry.prep_ms``, ``entry.finish_ms`` and
``pipeline.step_ms_max`` beside ``entry.host_ms``; the spans account for
the host work that ``entry.host_ms`` measures from outside; and the traced
clip's idle gap is named by a span or an operator inside one, not by the
harness's range or the entry's root span alone."""

import pytest
import torch

from benchmark import run as R

import bench_tiny

CPU = torch.device("cpu")
SPAN_METRICS = ("entry.prep_ms", "entry.finish_ms", "pipeline.step_ms_max")


@pytest.mark.parametrize("entry", ["animate", "edit"])
def test_traced_run_reads_the_spans(entry, tmp_path):
    res = R.run_cell(bench_tiny.CELLS[entry], 2 ** 31 + 13, 0.0, True,
                     device=CPU,
                     cfg_path=bench_tiny.config_file(entry, tmp_path),
                     traffic=bench_tiny.traffic(entry))
    assert res["correct"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    for name in SPAN_METRICS + ("entry.host_ms", "pipeline.step_ms"):
        assert m[name] > 0, name
        assert res["metrics"][name]["unit"] == "ms"
    assert m["pipeline.step_ms_max"] >= m["pipeline.step_ms"]
    spans = m["entry.prep_ms"] + m["entry.finish_ms"]
    assert abs(spans - m["entry.host_ms"]) <= max(0.1 * m["entry.host_ms"],
                                                  50.0)
    for name, _ in res["breakdown"]["idle_gaps"]:
        assert not name.endswith(("/host", f"/entry.{entry}")), name
