"""The port's remaining synthesis modules on the CPU, held to their mimo_tpu
originals where both have one: checkpoints (weights/checkpoint.py), stage
timers (utils/profiling.py), the dispatcher (__main__.py), the web app
(serving/app.py) and the video I/O copy (utils/video_io.py).

Everything here is exact: the same tree back from a checkpoint, the same
pruned directories, the same timer records on one fake clock, the same
decoded frames and fps from one file."""

import json
import os

import numpy as np
import pytest
import torch

from mimo_tpu.utils import profiling as JP
from mimo_tpu.utils import video_io as JVIO
from mimo_tpu.weights import checkpoint as JCK
from mimo_tpu_torch import __main__ as M
from mimo_tpu_torch.entry import template as T
from mimo_tpu_torch.serving import app as APP
from mimo_tpu_torch.utils import profiling as P
from mimo_tpu_torch.utils import video_io as VIO
from mimo_tpu_torch.weights import checkpoint as CK


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _tree():
    g = torch.Generator().manual_seed(0)
    return {
        "unet": {"conv_in": {"kernel": torch.randn(8, 4, 3, 3, generator=g),
                             "bias": torch.zeros(8)},
                 "down": [{"norm": {"scale": torch.randn(8, generator=g)
                                    .to(torch.bfloat16)},
                           "motions": None},
                          {"norm": {"scale": torch.ones(8,
                                                        dtype=torch.bfloat16)},
                           "motions": [{"pe": torch.randn(24, 8,
                                                          generator=g)}]}]},
        "vae": {"scale": torch.tensor(0.18215)},
    }


def _assert_tree_equal(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_tree_equal(got[k], want[k])
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_tree_equal(g, w)
    elif want is None:
        assert got is None
    else:
        assert got.dtype == want.dtype and got.device.type == "cpu"
        assert torch.equal(got, want)


def test_checkpoint_roundtrip(tmp_path):
    """A nested bf16 / fp32 tree with lists and None comes back equal, and a
    second save into the same directory replaces the first."""
    tree = _tree()
    path = str(tmp_path / "checkpoint-10")
    CK.save({"old": torch.ones(2)}, path)
    CK.save(tree, path)
    assert os.listdir(path) == [CK.TREE_FILE]
    _assert_tree_equal(CK.load(path, device="cpu"), tree)


def test_checkpoint_load_needs_cuda_unless_asked_for_cpu(tmp_path,
                                                         monkeypatch):
    path = str(tmp_path / "ckpt")
    CK.save(_tree(), path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        CK.load(path)


@pytest.mark.parametrize("n_keep", [0, 2, 5])
def test_keep_latest_equals_original(tmp_path, n_keep):
    """Both packages prune identical directories alike: checkpoint-<step>
    dirs by step number (not by name), others untouched."""
    left = []
    for pkg, fn in (("jax", JCK.keep_latest), ("torch", CK.keep_latest)):
        root = tmp_path / pkg
        for step in (10, 9, 200, 30, 40):
            CK.save({"step": torch.tensor(step)}, str(root
                                                      / f"checkpoint-{step}"))
        (root / "other").mkdir()
        (root / "checkpoint-x").mkdir()
        fn(str(root), n_keep=n_keep)
        left.append(sorted(os.listdir(root)))
    assert left[0] == left[1]
    kept = sorted((10, 9, 200, 30, 40))[-n_keep:] if n_keep else []
    assert left[1] == sorted([f"checkpoint-{s}" for s in kept]
                             + ["checkpoint-x", "other"])
    CK.keep_latest(str(tmp_path / "missing"))       # no directory: no-op


# ---------------------------------------------------------------------------
# stage timers
# ---------------------------------------------------------------------------


def _stages(timer, sync):
    with timer.stage("edit"):
        with timer.stage("crop"):
            pass
        with timer.stage("generate", sync=sync):
            with timer.stage("prepare"):
                pass
            for i in range(2):
                with timer.stage(f"step{i}"):
                    pass
        with timer.stage("composite"):
            pass


def test_stage_timer_equals_original(monkeypatch):
    """One stage structure timed by both timers on one fake clock: the same
    records, report and totals."""
    import time

    def run(timer, sync):
        ticks = iter(np.arange(1000) * 0.125 + 7.0)
        monkeypatch.setattr(time, "perf_counter", lambda: float(next(ticks)))
        _stages(timer, sync)
        monkeypatch.undo()
        return timer

    import jax.numpy as jnp
    got = run(P.StageTimer(), torch.ones(3))
    want = run(JP.StageTimer(), jnp.ones(3))
    assert got.records == want.records
    assert got.report() == want.report()
    assert [r["stage"] for r in got.records] == [
        "edit/crop", "edit/generate/prepare", "edit/generate/step0",
        "edit/generate/step1", "edit/generate", "edit/composite", "edit"]
    for prefix in ("", "edit/generate", "edit/c"):
        assert got.total(prefix) == want.total(prefix)


def test_profiling_helpers(tmp_path):
    """The trace writes a Chrome trace with the annotated region; the
    environment snapshot names torch and the devices."""
    with P.trace(str(tmp_path)):
        with P.annotate("mimo_region"):
            torch.ones(4) + 1
    files = os.listdir(tmp_path)
    assert files and "mimo_region" in (tmp_path / files[0]).read_text()
    env = P.log_compile_options()
    assert env["torch_version"] == torch.__version__
    assert env["backend"] in ("cpu", "cuda") and env["devices"]


# ---------------------------------------------------------------------------
# the dispatcher
# ---------------------------------------------------------------------------


def test_dispatcher_help_and_unknown(capsys):
    for argv in ([], ["-h"], ["--help"]):
        with pytest.raises(SystemExit) as e:
            M.main(argv)
        assert e.value.code == 0
    assert "edit" in capsys.readouterr().out
    with pytest.raises(SystemExit) as e:
        M.main(["frobnicate"])
    assert e.value.code == 2


@pytest.mark.parametrize("cmd,module", [
    ("animate", "mimo_tpu_torch.entry.animate"),
    ("edit", "mimo_tpu_torch.entry.edit"),
    ("serve", "mimo_tpu_torch.serving.app")])
def test_dispatcher_routes(cmd, module, monkeypatch):
    import importlib
    seen = []
    monkeypatch.setattr(importlib.import_module(module), "main",
                        lambda argv: seen.append(argv))
    M.main([cmd, "--ref", "r.png"])
    assert seen == [["--ref", "r.png"]]


@pytest.mark.parametrize("cmd,item", [("decomp", "item 2"),
                                      ("bench", "item 1")])
def test_dispatcher_not_ported(cmd, item, capsys):
    with pytest.raises(SystemExit) as e:
        M.main([cmd])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "not ported" in err and "ROADMAP.md" in err and item in err


# ---------------------------------------------------------------------------
# the web app
# ---------------------------------------------------------------------------


def test_webapp_templates_and_gradio_gate(tmp_path):
    root = tmp_path / "tpls"
    (root / "a").mkdir(parents=True)
    (root / "a" / "sdc.mp4").write_bytes(b"x")
    (root / "b").mkdir()
    app = APP.WebApp(template_root=str(root))
    assert app.templates() == ["a"]
    assert APP.WebApp(template_root=str(tmp_path / "none")).templates() == []
    with pytest.raises(RuntimeError, match="gradio"):
        APP.build_app(app)


def test_webapp_runner_needs_cuda_unless_asked_for_cpu(tmp_path,
                                                       monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        APP.WebApp(template_root=str(tmp_path)).runner()


def test_run_process_writes_video_at_template_fps(tmp_path):
    """run_process with a stub runner: the edited frames of the template,
    written at config.json's fps."""
    from tests.test_torch_edit import StubRunner, _edit_template, \
        _ref_image, _write_template
    root = tmp_path / "tpls"
    root.mkdir()
    tpl = _edit_template()
    d = _write_template(root, tpl, name="walk")
    cfg = json.loads(open(os.path.join(d, "config.json")).read())
    cfg["fps"] = 24
    open(os.path.join(d, "config.json"), "w").write(json.dumps(cfg))
    app = APP.WebApp(template_root=str(root), width=32, height=32, steps=1)
    app._runner = StubRunner()
    out = app.run_process(_ref_image(), "walk", str(tmp_path / "o" / "x.mp4"))
    assert out == str(tmp_path / "o" / "x.mp4")
    assert abs(VIO.get_fps(out) - 24) < 1e-6
    frames = VIO.read_frames(out)
    # the template read at 24 fps: its frames resampled and time-cropped
    assert len(frames) == T.load_template(d).num_frames == 8
    assert frames[0].shape == (64, 64, 3)
    assert app._runner.calls[0][3]["width"] == 32


# ---------------------------------------------------------------------------
# video I/O
# ---------------------------------------------------------------------------


def _write_test_video(path, n=12, fps=30):
    frames = [np.full((32, 48, 3), i * 20 % 255, np.uint8) for i in range(n)]
    JVIO.save_video(frames, str(path), fps=fps)
    return frames


def test_read_frames_and_fps_equal_original(tmp_path):
    p = str(tmp_path / "v.mp4")
    frames = _write_test_video(p, fps=25)
    back = VIO.read_frames(p)
    want = JVIO.read_frames(p)
    assert len(back) == len(want) == len(frames)
    for a, b in zip(back, want):
        np.testing.assert_array_equal(a, b)
    assert VIO.get_fps(p) == JVIO.get_fps(p)
    assert abs(VIO.get_fps(p) - 25) < 1
    half = VIO.load_video_fixed_fps(p, target_fps=12.5)
    assert len(half) == len(JVIO.load_video_fixed_fps(p, target_fps=12.5))


def test_video_reader_equals_original(tmp_path):
    p = str(tmp_path / "v.mp4")
    _write_test_video(p)
    with VIO.VideoReader(p) as r, JVIO.VideoReader(p) as j:
        assert (len(r), r.fps, r.width, r.height) == \
            (len(j), j.fps, j.width, j.height) == (12, 30.0, 48, 32)
        np.testing.assert_array_equal(r.get_frame(5), j.get_frame(5))
        for a, b in zip(r.sample_clip(4, 2, 11), j.sample_clip(4, 2, 11)):
            np.testing.assert_array_equal(a, b)
        with pytest.raises(IndexError):
            r.get_frame(40)
    with pytest.raises(FileNotFoundError):
        VIO.VideoReader(str(tmp_path / "missing.mp4"))


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_save_image_equals_original(tmp_path, dtype):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (20, 30, 3)).astype(np.uint8)
    if dtype == np.float32:
        img = img.astype(np.float32) / 255
    VIO.save_image(img, str(tmp_path / "a.png"))
    JVIO.save_image(img, str(tmp_path / "b.png"))
    assert (tmp_path / "a.png").read_bytes() == \
        (tmp_path / "b.png").read_bytes()
    np.testing.assert_array_equal(VIO.load_image(str(tmp_path / "a.png")),
                                  JVIO.load_image(str(tmp_path / "b.png")))
