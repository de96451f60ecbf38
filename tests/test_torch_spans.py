"""The clip's span recorder (``utils.profiling.PhaseClock``) alone, on
hand-made marks, spans and copies, and through the port's two entries on
the tiny CPU configuration: every span of a clip once, under the entry's
root span, with one clip id that grows from clip to clip; host spans nested
in time within their parents; the per-step times against their mean; the
profiler ranges of every span and phase inside the root's range; a clip run
again through the same Runner equal in every bit; and the benchmark's three
readers of the spans (``benchmark/metrics/``) on a hand-made record and on
one without spans. Each entry runs twice for the whole module
(``twice``), the second time inside the profiler."""

import numpy as np
import pytest
import torch

from benchmark import spec as S
from mimo_tpu_torch import config as C
from mimo_tpu_torch.entry.animate import animate
from mimo_tpu_torch.entry.edit import edit
from mimo_tpu_torch.entry.runner import Runner, init_random_params
from mimo_tpu_torch.entry.template import Template
from mimo_tpu_torch.pipelines import pose2vid
from mimo_tpu_torch.utils import profiling

STEPS = 2
HOST = {"animate": ["entry.template", "entry.reference", "entry.inputs",
                    "entry.output"],
        "edit": ["entry.template", "entry.reference", "entry.inputs",
                 "entry.paste_back"]}
RANGES = ["pipeline.prepare", "pipeline.prepare.clip",
          "pipeline.prepare.vae_encode", "pipeline.prepare.pose_guider",
          "pipeline.prepare.reference_unet", "pipeline.step",
          "pipeline.decode"]
NEW_KEYS = {"step_ms", "clip", "spans", "h2d_bytes", "d2h_bytes"}
OLD_KEYS = {"prepare", "step_mean", "decode", "steps"}


@pytest.fixture(scope="module")
def runner():
    cfg = C.tiny_mimo_config()
    params = init_random_params(cfg, torch.Generator().manual_seed(0),
                                dtype=torch.float32)
    return Runner(cfg=cfg, params=params, device=torch.device("cpu"),
                  dtype=torch.float32)


def _figure(h, w, x0):
    f = np.zeros((h, w, 3), np.uint8)
    f[14:44, x0:x0 + 10] = (120, 180, 90)
    f[8:14, x0 + 2:x0 + 8] = (200, 120, 80)
    return f


def _ref():
    ref = np.full((70, 50, 3), 255, np.uint8)
    ref[10:60, 15:35] = (30, 60, 160)
    return ref


def _clip(runner, entry):
    kw = dict(width=32, height=32, steps=STEPS, cfg_scale=3.5, seed=3)
    sdc = [_figure(56, 64, 10 + t) for t in range(5)]
    if entry == "animate":
        return animate(runner, _ref(), sdc, **kw)
    bk = np.full((56, 64, 3), 70, np.uint8)
    occ = np.zeros((56, 64, 3), np.uint8)
    occ[40:, :12] = 255
    tpl = Template(path="in-memory", fps=30, sdc=sdc,
                   vid=[np.maximum(bk, f) for f in sdc],
                   bk=[bk] * len(sdc), occ=[occ] * len(sdc))
    return edit(runner, _ref(), tpl, **kw)


def _host_ranges(prof):
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() != cuda]


@pytest.fixture(scope="module")
def twice(runner):
    """``twice(entry)``: the entry run twice through the module's Runner
    with the same arguments and seed, once for the module, the second run
    inside the profiler. Gives both runs' ``videos`` and ``timings``, the
    second run's host ``ranges`` and the Runner's ``clip_id`` after it."""
    done = {}

    def run(entry):
        if entry not in done:
            first = _clip(runner, entry)
            tm = runner.last_timings
            acts = [torch.profiler.ProfilerActivity.CPU]
            with torch.profiler.profile(activities=acts) as prof:
                second = _clip(runner, entry)
            done[entry] = {"videos": (first, second),
                           "timings": (tm, runner.last_timings),
                           "ranges": _host_ranges(prof),
                           "clip_id": runner.clip_id}
        return done[entry]
    return run


@pytest.mark.parametrize("entry", ["animate", "edit"])
def test_each_span_once_under_the_root_with_growing_clip_ids(twice, entry):
    runs = twice(entry)
    ids = []
    for tm in runs["timings"]:
        spans = tm["spans"]
        assert [s["name"] for s in spans] == [f"entry.{entry}"] + HOST[entry]
        root, children = spans[0], spans[1:]
        assert root["parent"] is None
        assert all(s["parent"] == root["name"] for s in children)
        assert {s["clip"] for s in spans} == {tm["clip"]}
        ids.append(tm["clip"])
    assert ids[1] == ids[0] + 1 and ids[1] == runs["clip_id"]


@pytest.mark.parametrize("entry", ["animate", "edit"])
def test_host_spans_nest_within_their_parents(twice, entry):
    for tm in twice(entry)["timings"]:
        spans = tm["spans"]
        by_name = {s["name"]: s for s in spans}
        for s in spans:
            assert 0.0 <= s["start"] <= s["end"]
            if s["parent"] is not None:
                p = by_name[s["parent"]]
                assert p["start"] <= s["start"] and s["end"] <= p["end"]
        # siblings follow one another: the host does one thing at a time
        children = spans[1:]
        for a, b in zip(children, children[1:]):
            assert a["end"] <= b["start"]


@pytest.mark.parametrize("entry", ["animate", "edit"])
def test_step_times_and_their_mean(twice, entry):
    for tm in twice(entry)["timings"]:
        assert set(tm) == OLD_KEYS | NEW_KEYS
        assert tm["steps"] == STEPS and len(tm["step_ms"]) == STEPS
        assert all(ms > 0 for ms in tm["step_ms"])
        assert np.mean(tm["step_ms"]) == pytest.approx(tm["step_mean"])
        assert tm["prepare"] > 0 and tm["decode"] > 0


@pytest.mark.parametrize("entry", ["animate", "edit"])
def test_profiler_holds_a_range_of_every_span(twice, entry):
    events = twice(entry)["ranges"]
    roots = [(s, e) for n, s, e in events if n == f"entry.{entry}"]
    assert len(roots) == 1
    r0, r1 = roots[0]
    inside = [n for n, s, e in events if r0 <= s and e <= r1]
    for name in HOST[entry] + RANGES:
        assert name in inside, name
    assert inside.count("pipeline.step") == STEPS


@pytest.mark.parametrize("entry", ["animate", "edit"])
def test_same_clip_twice_equal_in_every_bit(twice, entry):
    """A clip run again through the same Runner, with the same arguments
    and seed, gives the same video in every bit: the run repeats, and the
    Runner carries nothing from one clip into the next."""
    first, second = map(np.asarray, twice(entry)["videos"])
    assert first.dtype == second.dtype and first.std() > 0
    np.testing.assert_array_equal(first, second)


def test_generate_alone_is_a_clip_of_its_own(runner):
    """Runner.generate without an entry's recorder sets last_timings
    itself, under the next clip id, with its two host spans and no root."""
    before = runner.clip_id
    sdc = [_figure(32, 32, 8)] * 3
    runner.generate(_ref(), sdc, sdc, width=32, height=32, steps=1,
                    cfg_scale=1.0, seed=0)
    tm = runner.last_timings
    assert tm["clip"] == before + 1 and tm["steps"] == 1
    assert [(s["name"], s["parent"]) for s in tm["spans"]] == [
        ("entry.inputs", None), ("entry.output", None)]


def test_clock_marks_become_phases():
    """CPU marks give one phase a mark after the first; ``clip_timings``
    reads them as the pipeline's record. The durations are kept until the
    next mark."""
    clock = profiling.PhaseClock(torch.device("cpu"), clip=4)
    for name in ("start", "prepare", "step0", "step1", "decode"):
        clock.mark(name)
    ms = clock.durations_ms()
    assert list(ms) == ["prepare", "step0", "step1", "decode"]
    assert all(v >= 0.0 for v in ms.values())
    tm = pose2vid.clip_timings(clock)
    assert set(tm) == OLD_KEYS | NEW_KEYS
    assert tm["steps"] == 2 and tm["step_ms"] == [ms["step0"], ms["step1"]]
    assert tm["step_mean"] == pytest.approx(np.mean(tm["step_ms"]))
    assert (tm["prepare"], tm["decode"]) == (ms["prepare"], ms["decode"])
    assert tm["clip"] == 4 and tm["spans"] == []
    # kept until the next mark: a moved mark is not read again, and the
    # caller's dict is a copy
    ms["decode"] = -1.0
    name, t = clock.marks[-1]
    clock.marks[-1] = (name, t + 1.0)
    assert clock.durations_ms()["decode"] == tm["decode"]
    clock.mark("end")
    again = clock.durations_ms()
    assert list(again) == ["prepare", "step0", "step1", "decode", "end"]
    assert again["decode"] == pytest.approx(tm["decode"] + 1e3)


def test_clock_spans_nest_and_close_on_error():
    """Hand-opened spans carry the enclosing span's name and the clip id;
    a span whose body raises still ends, and so do the spans around it."""
    clock = profiling.PhaseClock(torch.device("cpu"), clip=9)
    with clock.span("root"):
        with clock.span("a"):
            pass
        with pytest.raises(ValueError):
            with clock.span("b"):
                with clock.span("c"):
                    raise ValueError("inside c")
        with clock.span("d"):
            pass
    with clock.span("after"):
        pass
    spans = clock.record()["spans"]
    assert [(s["name"], s["parent"]) for s in spans] == [
        ("root", None), ("a", "root"), ("b", "root"), ("c", "b"),
        ("d", "root"), ("after", None)]
    assert {s["clip"] for s in spans} == {9}
    by_name = {s["name"]: s for s in spans}
    for s in spans:
        assert s["end"] is not None and s["start"] <= s["end"]
        if s["parent"] is not None:
            assert s["end"] <= by_name[s["parent"]]["end"]
    assert by_name["c"]["end"] <= by_name["b"]["end"] <= by_name["d"]["start"]


def test_clock_counts_copies_by_direction():
    """``copied`` adds each direction's bytes into ``record()``, which
    hands out copies of the spans."""
    clock = profiling.PhaseClock(torch.device("cpu"), clip=2)
    assert clock.record() == {"clip": 2, "spans": [], "h2d_bytes": 0,
                              "d2h_bytes": 0}
    clock.copied("h2d", 10)
    clock.copied("d2h", 3)
    clock.copied("h2d", np.int64(5))
    with clock.span("x"):
        pass
    rec = clock.record()
    assert (rec["h2d_bytes"], rec["d2h_bytes"]) == (15, 3)
    assert type(rec["h2d_bytes"]) is int
    rec["spans"][0]["name"] = "changed"
    assert clock.record()["spans"][0]["name"] == "x"


def _timings(spans, step_ms=(4.0, 6.0)):
    return {"prepare": 10.0, "step_mean": sum(step_ms) / len(step_ms),
            "decode": 20.0, "steps": len(step_ms), "step_ms": list(step_ms),
            "clip": 1, "spans": [{"name": n, "parent": "entry.edit",
                                  "clip": 1, "start": a, "end": b}
                                 for n, a, b in spans]}


def test_readers_on_a_hand_made_record():
    first = _timings([("entry.edit", 0.0, 100.0),
                      ("entry.template", 1.0, 11.0),
                      ("entry.reference", 11.0, 16.0),
                      ("entry.inputs", 16.0, 31.0),
                      ("entry.output", 60.0, 62.0),
                      ("entry.paste_back", 62.0, 90.0)], step_ms=(4.0, 9.0))
    second = _timings([("entry.animate", 0.0, 50.0),
                       ("entry.template", 0.0, 5.0),
                       ("entry.reference", 5.0, 10.0),
                       ("entry.inputs", 10.0, 20.0),
                       ("entry.output", 40.0, 44.0)], step_ms=(5.0, 7.0))
    failed = _timings([("entry.inputs", 0.0, 1000.0)], step_ms=(99.0,))
    rec = {"clips": [{"ok": True, "timings": first},
                     {"ok": True, "timings": second},
                     {"ok": False, "timings": failed}]}
    # prep: (10 + 5 + 15) and (5 + 5 + 10); finish: (2 + 28) and (4 + 0)
    assert S.reader("entry.prep_ms")(rec) == pytest.approx(25.0)
    assert S.reader("entry.finish_ms")(rec) == pytest.approx(17.0)
    assert S.reader("pipeline.step_ms_max")(rec) == 9.0


@pytest.mark.parametrize("name", ["entry.prep_ms", "entry.finish_ms",
                                  "pipeline.step_ms_max"])
def test_readers_find_nothing_in_the_old_record(name):
    old = {"prepare": 10.0, "step_mean": 5.0, "decode": 20.0, "steps": 2}
    rec = {"clips": [{"ok": True, "timings": old, "wall_s": 0.1}]}
    assert S.reader(name)(rec) is None
    assert S.reader(name)({"clips": []}) is None
