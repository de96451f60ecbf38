"""The port's stage 7 (mimo_tpu_torch/decomp/pipeline.py
``VideoProcessor.run``, decomp/factory.py ``main`` and the ``decomp``
command) against mimo_tpu/decomp/pipeline.py and factory.py on the CPU.

Both packages run the synthetic injected models of
tests/test_decomp_pipeline.py (the port's ``inpaint`` takes and returns
tensors, so it wraps the same numpy function) on a drawn clip where a
static object stands in front of a walking figure, and an sdc that renders
the figure's whole box, so the occlusion stage keeps the object:

- with OpenCV, the two ``run``s give equal codes, ``bbox.npy``,
  ``config.json`` and stage files decoded equal in every bit, on a first
  run and on a resumed one;
- without OpenCV (``cv2 = None`` in the port, as on the card), the port's
  in-memory stages equal mimo_tpu's, and its template (uncompressed AVI)
  loads through both packages' ``load_template`` equal in every bit to
  them; a resumed run reuses mask / sdc / bk and writes every file again
  byte for byte;
- the 720-pixel cap of a 1080x720 clip: equal to mimo_tpu's with OpenCV,
  within one level of ``cv2.resize`` without it (``resize_linear``'s torch
  path rounds the float bilinear where OpenCV uses fixed point);
- codes 1, 2 and 3 end both runs alike;
- the command on tiny bundles (only ``sam.npz`` and ``vitpose.npz``, the
  two the run reaches: random tiny weights find no person; the port's
  factory is given the tiny configs, as its command has no ``--tiny``):
  equal exit codes, message lines and ``vid.mp4``.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

import cv2
from mimo_tpu.decomp import factory as JF
from mimo_tpu.decomp import pipeline as JP
from mimo_tpu.entry import template as JT
from mimo_tpu.utils import video_io as JVIO
from mimo_tpu_torch import __main__ as M
from mimo_tpu_torch.decomp import factory as FA
from mimo_tpu_torch.decomp import pipeline as P
from mimo_tpu_torch.entry import template as T
from mimo_tpu_torch.utils import frames as FU
from mimo_tpu_torch.utils import video_io as VIO
from tests.test_decomp_pipeline import _models, _synthetic_video

STAGES = ("vid.mp4", "mask.mp4", "sdc.mp4", "bk.mp4", "occ.mp4")


def _occluded_clip(t=6, h=64, w=80):
    """The figure of tests/test_decomp_pipeline.py, taller, behind a static
    object that covers its legs."""
    frames = []
    for i in range(t):
        f = np.full((h, w, 3), 30, np.uint8)
        cx = 30 + 2 * i
        f[8:60, cx - 8:cx + 8] = [200, 150, 120]
        f[40:64, 26:44] = [90, 200, 90]
        frames.append(f)
    return frames


def _box_sdc(frames, masks, bboxes):
    """An sdc over each person box and 20 rows below it (the legs the
    object hides)."""
    out = np.zeros((len(frames),) + frames[0].shape, np.uint8)
    for i, (x0, y0, x1, y1) in enumerate(bboxes):
        out[i, y0:y1 + 20, x0:x1] = [128, 200, 90]
    return out


def _scene_models():
    ref = _models()
    ref.estimate_motion = _box_sdc
    return ref


def _port_models(ref) -> P.DecompModels:
    """The port's bundle of ``ref``'s callables; ``inpaint`` on tensors."""
    kw = {f.name: getattr(ref, f.name)
          for f in dataclasses.fields(JP.DecompModels)}
    inner = ref.inpaint
    kw["inpaint"] = lambda fr, m: torch.from_numpy(
        inner(fr.cpu().numpy(), m.cpu().numpy()))
    return P.DecompModels(**kw)


def _without_cv2(mp):
    mp.setattr(VIO, "cv2", None)
    mp.setattr(FU, "cv2", None)


def _clip_file(path, frames):
    """``frames`` as the port's uncompressed AVI, which both read."""
    with pytest.MonkeyPatch.context() as mp:
        _without_cv2(mp)
        VIO.save_video(frames, str(path), fps=30)
    return str(path)


def _outputs(d):
    """Every file of a template dir: stage videos decoded with OpenCV,
    bbox.npy, config.json."""
    out = {}
    for name in sorted(os.listdir(d)):
        p = os.path.join(d, name)
        if name.endswith(".mp4"):
            out[name] = np.stack(JVIO.read_frames(p))
        elif name.endswith(".npy"):
            out[name] = np.load(p)
        else:
            with open(p) as f:
                out[name] = json.load(f)
    return out


def _file_bytes(d):
    out = {}
    for name in os.listdir(d):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = f.read()
    return out


def _assert_same(a, b):
    assert sorted(a) == sorted(b)
    for name in a:
        if isinstance(a[name], np.ndarray):
            assert a[name].dtype == b[name].dtype, name
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)
        else:
            assert a[name] == b[name], name


def _recording(vp):
    """Record each stage's in-memory output on ``vp``."""
    seen = {}
    for name in ("get_human", "get_motion", "get_bk_recover", "get_occ"):
        def call(*args, _fn=getattr(vp, name), _name=name, **kwargs):
            seen[_name] = _fn(*args, **kwargs)
            return seen[_name]
        setattr(vp, name, call)
    return seen


def test_run_matches_mimo_tpu_with_opencv(tmp_path):
    vid = _clip_file(tmp_path / "in.mp4", _occluded_clip())
    ref = _scene_models()
    runs = {}
    for name, vp in (("jax", JP.VideoProcessor(ref)),
                     ("port", P.VideoProcessor(_port_models(ref)))):
        d = str(tmp_path / name)
        first = vp.run(vid, d)
        files = _outputs(d)
        again = vp.run(vid, d, resume=True)
        runs[name] = (first, files, again, _outputs(d))
    (jf, jfiles, ja, jafiles), (pf, pfiles, pa, pafiles) = \
        runs["jax"], runs["port"]
    assert pf["code"] == jf["code"] == P.CODE_OK
    assert pa["code"] == ja["code"] == P.CODE_OK
    assert pf["num_frames"] == jf["num_frames"] == 6
    assert sorted(pf) == sorted(jf) and sorted(pa) == sorted(ja)
    assert set(STAGES) <= set(pfiles)
    _assert_same(pfiles, jfiles)
    _assert_same(pafiles, jafiles)


@pytest.fixture(scope="module")
def nocv2_run(tmp_path_factory):
    """The port's run without OpenCV and mimo_tpu's (with it) on one
    uncompressed clip, each stage's in-memory output recorded."""
    root = tmp_path_factory.mktemp("nocv2")
    frames = _occluded_clip()
    vid = _clip_file(root / "in.mp4", frames)
    ref = _scene_models()
    jvp = JP.VideoProcessor(ref)
    jstages = _recording(jvp)
    jres = jvp.run(vid, str(root / "jax"))
    vp = P.VideoProcessor(_port_models(ref))
    stages = _recording(vp)
    with pytest.MonkeyPatch.context() as mp:
        _without_cv2(mp)
        res = vp.run(vid, str(root / "port"))
    return dict(vid=vid, frames=frames, res=res, stages=stages,
                jres=jres, jstages=jstages, dir=str(root / "port"),
                jdir=str(root / "jax"), vp=vp)


def test_in_memory_stages_without_opencv_match_mimo_tpu(nocv2_run):
    r = nocv2_run
    assert r["res"]["code"] == r["jres"]["code"] == P.CODE_OK
    s, j = r["stages"], r["jstages"]
    np.testing.assert_array_equal(s["get_human"][0], j["get_human"][0])
    for name in ("get_motion", "get_bk_recover", "get_occ"):
        assert s[name] is not None
        np.testing.assert_array_equal(s[name], j[name], err_msg=name)
    for name in ("bbox.npy", "config.json"):
        a = _outputs(r["dir"])[name]
        b = _outputs(r["jdir"])[name]
        _assert_same({name: a}, {name: b})


def test_template_without_opencv_loads_in_both_packages(nocv2_run,
                                                        monkeypatch):
    r = nocv2_run
    s = r["stages"]
    masks = s["get_human"][0]
    want = {"vid": r["frames"], "sdc": list(s["get_motion"]),
            "bk": list(s["get_bk_recover"]),
            "occ": [(o * 255).astype(np.uint8)[..., None].repeat(3, -1)
                    for o in s["get_occ"]]}
    jtpl = JT.load_template(r["dir"])           # mimo_tpu, with OpenCV
    _without_cv2(monkeypatch)
    tpl = T.load_template(r["dir"])
    for t in (tpl, jtpl):
        assert t.num_frames == r["res"]["num_frames"] == 6
        assert t.config == _outputs(r["dir"])["config.json"]
        for name, frames in want.items():
            got = getattr(t, name)
            assert len(got) == len(frames), name
            for a, b in zip(got, frames):
                np.testing.assert_array_equal(a, b, err_msg=name)
    read = np.stack([f[..., 0] > 127 for f in VIO.read_frames(
        os.path.join(r["dir"], "mask.mp4"))])
    np.testing.assert_array_equal(read, masks)


def test_resume_without_opencv_rewrites_the_same_bytes(nocv2_run,
                                                       monkeypatch):
    r = nocv2_run
    before = _file_bytes(r["dir"])
    vp = P.VideoProcessor(r["vp"].models)

    def refuse(*args, **kwargs):
        raise AssertionError("a resumed run recomputed a stage it has")
    for name in ("get_human", "get_motion", "get_bk_recover"):
        setattr(vp, name, refuse)
    _without_cv2(monkeypatch)
    res = vp.run(r["vid"], r["dir"], resume=True)
    assert res["code"] == P.CODE_OK and res["num_frames"] == 6
    after = _file_bytes(r["dir"])
    assert sorted(after) == sorted(before)
    assert set(STAGES) <= set(after)
    for name in before:
        assert after[name] == before[name], name


@pytest.mark.parametrize("opencv", [True, False])
def test_resolution_cap_of_a_1080x720_clip(tmp_path, monkeypatch, opencv):
    rng = np.random.default_rng(5)
    frames = [rng.integers(0, 256, (1080, 720, 3), dtype=np.uint8)
              for _ in range(2)]
    vid = _clip_file(tmp_path / "in.mp4", frames)
    jres = JP.VideoProcessor(JP.DecompModels()).run(vid, str(tmp_path / "j"))
    if not opencv:
        _without_cv2(monkeypatch)
    res = P.VideoProcessor(P.DecompModels()).run(vid, str(tmp_path / "p"))
    assert res == jres == {"code": P.CODE_NO_PERSON}
    got = VIO.read_frames(str(tmp_path / "p" / "vid.mp4"))
    assert [f.shape for f in got] == [(720, 480, 3)] * 2
    if opencv:
        for a, b in zip(got, JVIO.read_frames(str(tmp_path / "j" /
                                                  "vid.mp4"))):
            np.testing.assert_array_equal(a, b)
    else:
        for a, f in zip(got, frames):
            want = cv2.resize(f, (480, 720))
            assert np.abs(a.astype(int) - want.astype(int)).max() <= 1


def _tiny_box(frame):
    return np.array([30, 20, 34, 24]), 0.99


def _half_body(frame, bbox):
    k = np.zeros((133, 3))
    k[:5, 2] = 0.9
    return k


@pytest.mark.parametrize("case,code", [
    ("detect_person", P.CODE_NO_PERSON),
    ("no_one", P.CODE_NO_PERSON),
    ("tiny", P.CODE_PERSON_TOO_SMALL),
    ("half_body", P.CODE_HALF_BODY)])
def test_codes_end_the_run_as_in_mimo_tpu(tmp_path, case, code):
    vid = str(tmp_path / "in.mp4")
    _synthetic_video(vid)
    ref = _models()
    if case == "detect_person":
        ref.detect_person = None
    elif case == "no_one":
        ref.detect_person = lambda frame: None
    elif case == "tiny":
        ref.detect_person = _tiny_box
    else:
        ref.estimate_pose = _half_body
    jres = JP.VideoProcessor(ref).run(vid, str(tmp_path / "j"))
    res = P.VideoProcessor(_port_models(ref)).run(vid, str(tmp_path / "p"))
    assert res == jres == {"code": code}
    files = _outputs(str(tmp_path / "p"))
    assert list(files) == ["vid.mp4"]
    _assert_same(files, _outputs(str(tmp_path / "j")))


@pytest.fixture(scope="module")
def tiny_bundles(tmp_path_factory):
    """tools/gen_decomp_weights.py --tiny's sam.npz and vitpose.npz."""
    import jax
    from mimo_tpu.decomp import sam as JSAM
    from mimo_tpu.decomp import vitpose as JVP
    from tools.gen_decomp_weights import _save
    d = tmp_path_factory.mktemp("tiny_bundles")
    key = jax.random.PRNGKey(0)
    _save(JSAM.sam_init(key, JSAM.tiny_sam_config()), str(d / "sam.npz"))
    _save(JVP.vitpose_init(key, JVP.tiny_vitpose_config()),
          str(d / "vitpose.npz"))
    return str(d)


def _exit_code(fn):
    try:
        fn()
    except SystemExit as e:
        return e.code
    return 0


def test_decomp_command_matches_mimo_tpu(tmp_path, tiny_bundles,
                                         monkeypatch, capsys):
    frames = _synthetic_video(str(tmp_path / "drawn.mp4"), T=5)
    vid = _clip_file(tmp_path / "in.mp4", frames)

    def argv(out):
        return ["--video", vid, "--output", str(tmp_path / out),
                "--weights-dir", tiny_bundles, "--max-frames", "4", "--cpu"]

    monkeypatch.setattr(sys, "argv", ["decomp"] + argv("j") + ["--tiny"])
    jcode = _exit_code(JF.main)
    jout = capsys.readouterr().out.splitlines()
    tiny_cfgs = FA.configs(tiny=True)
    monkeypatch.setattr(FA, "configs", lambda tiny: tiny_cfgs)
    code = _exit_code(lambda: M.main(["decomp"] + argv("p")))
    out = capsys.readouterr().out.splitlines()
    assert code == jcode == P.CODE_NO_PERSON
    assert out == [line.replace(str(tmp_path / "j"), str(tmp_path / "p"))
                   for line in jout]
    assert out == [f"decomposition: no person detected -> {tmp_path / 'p'}"]
    got = _outputs(str(tmp_path / "p"))
    assert list(got) == ["vid.mp4"] and len(got["vid.mp4"]) == 4
    _assert_same(got, _outputs(str(tmp_path / "j")))


def test_decomp_command_needs_the_card_without_cpu(tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.main(["decomp", "--video", str(tmp_path / "in.mp4"), "--output",
                str(tmp_path / "out")])
