"""The port's edit path (mimo_tpu_torch.entry.edit and the edit helpers of
mimo_tpu_torch.utils.frames) held to mimo_tpu's on the CPU.

Tolerances:
- the frame helpers, ``composite_back`` and ``edit`` around one stub runner
  are numpy on the same inputs as their originals: equal in every bit;
- ``pose_adjust`` without OpenCV (torch area resize) against OpenCV: within
  1 uint8 level on an exact 2x shrink, the bound
  tests/test_torch_frames.py holds ``resize_frame`` to;
- the whole slice (tiny config, 64x64 frames, 32x32 generation, 2 DDIM
  steps, fp32): each package runs its own pipeline on the same bridged
  weights and the same noise (the JAX runner's
  ``jax.random.normal(PRNGKey(seed), ...)``, handed to the port's runner in
  place of its torch draw). The generations agree to ~2e-4 on [0, 1]
  pixels (tests/test_torch_pipeline.py), which the paste-back's truncation
  to uint8 can turn into one level: the composited frames agree to <= 1,
  and exactly where the paste-back does not read the generation (outside
  every shot's bbox, and inside the occlusion mask).
"""

import contextlib
import json
import types

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from mimo_tpu import config as JC
from mimo_tpu.entry import edit as JE
from mimo_tpu.entry import runner as JR
from mimo_tpu.entry import template as JT
from mimo_tpu.utils import frames as JFU
from mimo_tpu.utils import video_io as JVIO
from mimo_tpu_torch import config as C
from mimo_tpu_torch.entry import edit as E
from mimo_tpu_torch.entry import runner as R
from mimo_tpu_torch.entry import template as T
from mimo_tpu_torch.utils import frames as FU
from mimo_tpu_torch.utils import profiling as PR
from tests.test_pipeline import tiny_params
from tests.test_torch_helpers import bridge_params, set_fp32_matmuls

set_fp32_matmuls()


# ---------------------------------------------------------------------------
# templates
# ---------------------------------------------------------------------------

OCC = (slice(24, 44), slice(8, 20))      # the occlusion patch (rows, cols)


def _edit_template(n=10, h=64, w=64, occ=True, cls=T.Template):
    """A template in memory: a small figure (its padded bbox 16x16) that
    steps right, then jumps across the frame (two ROI shots), on a textured
    background; vid is the background with the figure; occ covers a fixed
    patch the figure stands in at first."""
    yy, xx = np.mgrid[0:h, 0:w]
    bk = np.stack([(yy * 3 + xx) % 256, (xx * 5) % 256,
                   (yy * 7 + 40) % 256], -1).astype(np.uint8)
    sdc, vid = [], []
    for t in range(n):
        x0 = 4 + t if t < n // 2 else 40 + t
        f = np.zeros((h, w, 3), np.uint8)
        f[26:36, x0:x0 + 6] = (120, 180, 90)
        f[22:26, x0 + 1:x0 + 5] = (200, 120, 80)
        sdc.append(f)
        v = bk.copy()
        v[f.any(-1)] = f[f.any(-1)] // 2 + 60
        vid.append(v)
    occ_frames = None
    if occ:
        m = np.zeros((h, w, 3), np.uint8)
        m[OCC] = 255
        occ_frames = [m.copy() for _ in range(n)]
    return cls(path="in-memory", fps=30, vid=vid, sdc=sdc,
               bk=[bk.copy() for _ in range(n)], occ=occ_frames)


def _ref_image():
    ref = np.full((80, 60, 3), 255, np.uint8)
    ref[16:70, 18:42] = [30, 60, 160]
    ref[6:16, 24:36] = [220, 170, 140]
    return ref


def _sdc_frame(h, w, y0, y1, x0, x1):
    f = np.zeros((h, w, 3), np.uint8)
    f[y0:y1, x0:x1] = 200
    return f


def _clip(name):
    """tests/test_frames.py's static and shot-split clips, and the clip of
    the edit tests below."""
    if name == "static":
        return [_sdc_frame(64, 64, 10, 50, 10, 40) for _ in range(6)]
    if name == "shot_split":
        return ([_sdc_frame(128, 128, 4, 60, 4, 40) for _ in range(5)]
                + [_sdc_frame(128, 128, 70, 124, 80, 124) for _ in range(5)])
    if name == "empty":      # no mask: the shot's whole-frame fallback
        return [np.zeros((40, 56, 3), np.uint8) for _ in range(5)]
    return _edit_template().sdc


def _assert_same(got, want):
    """Nested tuples / lists of arrays and ints, equal in every bit."""
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    else:
        assert got == want


@pytest.mark.parametrize("name", ["static", "shot_split", "edit", "empty"])
@pytest.mark.parametrize("overlay", [2, 4])
def test_roi_shots_equal_original(name, overlay):
    frames = _clip(name)
    vid = [f // 2 + 7 for f in frames]
    bk = [255 - f for f in frames]
    got = FU.crop_human_clip_auto_context(frames, vid, bk, overlay)
    want = JFU.crop_human_clip_auto_context(frames, vid, bk, overlay)
    _assert_same(got, want)
    if name in ("shot_split", "edit"):
        assert len(got[4]) >= 2        # the clip splits into shots


@pytest.mark.parametrize("shape", [(40, 40), (7, 90), (130, 3)])
@pytest.mark.parametrize("feather", [8, 32])
def test_feather_masks_equal_original(shape, feather):
    for mode in JFU.MASK_MODES:
        got = FU.make_feather_mask(shape, mode, feather)
        want = JFU.make_feather_mask(shape, mode, feather)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    assert FU.MASK_MODES == JFU.MASK_MODES


def test_mask_mode_and_bbox_pad_equal_original():
    """Every combination of touched frame sides (all 16 modes), the mask
    of each at a crop size, and bbox_pad at odd sizes and frame edges."""
    modes = set()
    for w_min in (0, 10):
        for w_max in (50, 100):
            for h_min in (-3, 10):
                for h_max in (50, 120):
                    bbox = (w_min, w_max, h_min, h_max)
                    mode = FU.get_mask_mode(bbox, (100, 110))
                    assert mode == JFU.get_mask_mode(bbox, (100, 110))
                    modes.add(mode)
                    np.testing.assert_array_equal(
                        FU.get_feather_mask(bbox, (100, 110), (33, 21)),
                        JFU.get_feather_mask(bbox, (100, 110), (33, 21)))
    assert modes == set(FU.MASK_MODES)
    for args in ((3, 40, 5, 71, (80, 60)), (0, 17, 0, 17, (17, 17)),
                 (20, 58, 30, 31, (64, 64)), (10, 10, 4, 4, (32, 32))):
        assert FU.bbox_pad(*args) == JFU.bbox_pad(*args)


@pytest.mark.parametrize("h,w,width,height", [
    (200, 100, 64, 96),      # pad the sides
    (100, 300, 64, 50),      # crop the sides
    (60, 90, 512, 784),      # growth
])
def test_pose_adjust_equals_original(h, w, width, height):
    rng = np.random.default_rng(h)
    img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    np.testing.assert_array_equal(FU.pose_adjust(img, width, height),
                                  JFU.pose_adjust(img, width, height))


@pytest.mark.parametrize("h,w,width,height", [
    (200, 100, 64, 100),     # exact 2x shrink, pad the sides
    (120, 300, 64, 60),      # exact 2x shrink, crop the sides
])
def test_pose_adjust_without_cv2_close_to_cv2(h, w, width, height,
                                              monkeypatch):
    rng = np.random.default_rng(w)
    img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    want = FU.pose_adjust(img, width, height)
    monkeypatch.setattr(FU, "cv2", None)
    got = FU.pose_adjust(img, width, height)
    assert got.shape == want.shape == (height, width, 3)
    assert got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


class StubRunner:
    """Records generate's inputs; returns a video made from them. The
    port's entry opens a clip on its runner (``Runner.clip``; the JAX
    package's does not), uploads its frames (``Runner.upload``) and hands
    ``inputs`` the clip's recorder, which the stub takes apart from the
    inputs it records; the port's frames, uint8 tensors a shot, are
    recorded as the numpy frames the JAX package's generate receives."""

    device = torch.device("cpu")
    upload = R.Runner.upload

    def __init__(self):
        self.calls = []

    @contextlib.contextmanager
    def clip(self, name):
        yield PR.PhaseClock(torch.device("cpu"))

    def inputs(self, ref, pose, bk, clock=None, **kw):
        def frames(x):
            if torch.is_tensor(x):
                x = [x]
            if isinstance(x, list) and x and torch.is_tensor(x[0]):
                return [f for b in x for f in b.numpy()]
            return x
        pose, bk = frames(pose), frames(bk)
        self.calls.append((ref, pose, bk, kw))
        return pose, kw

    def run(self, job, clock=None):
        pose, kw = job
        h, w = kw["height"], kw["width"]
        rng = np.random.default_rng(len(pose))
        video = rng.uniform(0, 1, (len(pose), h, w, 3)).astype(np.float32)
        return torch.from_numpy(video * 0.5 + np.stack([
            np.resize(p.astype(np.float32) / 510, (h, w, 3)) for p in pose]))

    def to_host(self, video, clock=None):
        return video.numpy()

    def generate(self, ref, pose, bk, clock=None, **kw):
        return self.run(self.inputs(ref, pose, bk, **kw)).numpy()


# ---------------------------------------------------------------------------
# composite_back and edit around a stub runner
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("occ", [True, False])
def test_composite_back_equals_original(occ):
    tpl = _edit_template(occ=occ)
    pose_c, _, bk_c, _, ctx, bboxes = FU.crop_human_clip_auto_context(
        tpl.sdc, tpl.vid, tpl.bk, E.OVERLAY)
    assert len(ctx) == 2
    pad_info = []
    for b in bk_c:
        bb, padding_v = FU.pad_img(b)
        pad_info.append((bb.shape[0], bb.shape[1], padding_v))
    rng = np.random.default_rng(3)
    video = rng.uniform(0, 1, (len(pose_c), 32, 32, 3)).astype(np.float32)
    args = (video, ctx, bboxes, pad_info, tpl.bk, tpl.vid, tpl.occ)
    got, want = E.composite_back(*args), JE.composite_back(*args)
    assert len(got) == len(want) == len(tpl.sdc)
    _assert_same(got, want)


def test_edit_with_stub_runner_equals_original(tmp_path, monkeypatch):
    """Both packages' edit() from one template directory around one stub
    runner: the same generate() inputs and the same frames; the port's
    edit from the Template in memory gives them too."""
    tpl = _edit_template()
    d = _write_template(tmp_path, tpl)
    kw = dict(width=32, height=48, steps=2, cfg_scale=3.5, seed=5,
              max_frames=7)
    jax_runner, port_runner, mem_runner = StubRunner(), StubRunner(), \
        StubRunner()
    want = JE.edit(jax_runner, _ref_image(), d, **kw)
    got = E.edit(port_runner, _ref_image(), d, **kw)
    loaded = T.load_template(d)
    mem = E.edit(mem_runner, _ref_image(), loaded, **kw)
    assert len(want) == 7
    _assert_same(got, want)
    _assert_same(mem, want)
    (jref, jpose, jbk, jkw), = jax_runner.calls
    for runner in (port_runner, mem_runner):
        (ref, pose, bk, pkw), = runner.calls
        assert pkw == jkw
        _assert_same((ref, pose, bk), (jref, jpose, jbk))


def _write_template(tmp_path, tpl, name="tpl"):
    d = tmp_path / name
    d.mkdir()
    for key in ("sdc", "vid", "bk", "occ"):
        frames = getattr(tpl, key)
        if frames:
            JVIO.save_video(frames, str(d / f"{key}.mp4"), fps=30)
    (d / "config.json").write_text(json.dumps(
        {"fps": 30, "time_crop": {"start_idx": 0, "end_idx": len(tpl.sdc)}}))
    return str(d)


# ---------------------------------------------------------------------------
# the whole slice against mimo_tpu
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runners():
    """A mimo_tpu runner and a port runner on the same tiny weights, fp32 on
    the CPU."""
    cfg = JC.tiny_mimo_config()
    params = tiny_params(cfg)
    jax_runner = JR.Runner(cfg=cfg, params=params, dtype=jnp.float32)
    port_runner = R.Runner(cfg=C.tiny_mimo_config(),
                           params=bridge_params(params),
                           device=torch.device("cpu"), dtype=torch.float32)
    return jax_runner, port_runner


def test_edit_matches_jax(runners, monkeypatch):
    jax_runner, port_runner = runners
    seed, kw = 11, dict(width=32, height=32, steps=2, cfg_scale=3.5)
    tpl = _edit_template()
    jtpl = _edit_template(cls=JT.Template)
    monkeypatch.setattr(JE, "load_template", lambda *a, **k: jtpl)
    want = JE.edit(jax_runner, _ref_image(), "in-memory", seed=seed, **kw)

    randn = torch.randn

    def jax_noise(shape, *args, **kwargs):
        """The JAX runner's noise, where the port's runner draws its own."""
        assert "generator" in kwargs and shape[-1] == 4
        return torch.from_numpy(np.array(
            jax.random.normal(jax.random.PRNGKey(seed), shape), np.float32))

    monkeypatch.setattr(torch, "randn", jax_noise)
    got = E.edit(port_runner, _ref_image(), tpl, seed=seed, **kw)
    monkeypatch.setattr(torch, "randn", randn)

    assert len(got) == len(want) == len(tpl.sdc)
    _, _, _, _, ctx, bboxes = FU.crop_human_clip_auto_context(
        tpl.sdc, tpl.vid, tpl.bk, E.OVERLAY)
    assert len(ctx) == 2
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype == np.uint8 and g.shape == w.shape
        diff = np.abs(g.astype(int) - w.astype(int))
        assert diff.max() <= 1, i
        # where the paste-back reads no generation, equal in every bit
        inside = np.zeros(g.shape[:2], bool)
        for c, (x0, x1, y0, y1) in zip(ctx, bboxes):
            if i in c:
                inside[y0:y1, x0:x1] = True
        outside = ~inside
        outside[OCC] = True
        assert not diff[outside].any(), i
        # the pasted region follows the generation, not the background
        assert np.abs(g[inside].astype(int) - tpl.bk[i][inside]).max() > 20
    # occluded pixels show the source video (a cross-faded frame may lose
    # one level to truncation)
    for i in (0, 3, 7):
        assert np.abs(got[i][OCC].astype(int)
                      - tpl.vid[i][OCC]).max() <= 1


# ---------------------------------------------------------------------------
# the reference's entry-flow cases and the CLI on the port
# ---------------------------------------------------------------------------


def test_edit_flow_with_occ(runners, tmp_path):
    """tests/test_entry_flows.py's occlusion case through the port's edit:
    the occluded corner shows the source video, not the background."""
    h = w = 64
    n = 5
    sdc = []
    for t in range(n):
        f = np.zeros((h, w, 3), np.uint8)
        cx = 24 + 2 * t
        f[16:52, cx - 8:cx + 8] = [120, 180, 90]
        sdc.append(f)
    occ = np.zeros((n, h, w, 3), np.uint8)
    occ[:, 48:, :16] = 255
    tpl = T.Template(path="in-memory", fps=30, sdc=sdc,
                     vid=[np.full((h, w, 3), 90, np.uint8)] * n,
                     bk=[np.full((h, w, 3), 40, np.uint8)] * n,
                     occ=list(occ))
    frames = E.edit(runners[1], _ref_image(), tpl, width=32, height=32,
                    steps=2, cfg_scale=3.5, seed=0)
    assert len(frames) == n
    assert frames[0].dtype == np.uint8
    assert abs(int(frames[0][60, 8, 0]) - 90) < 25


@pytest.mark.parametrize("in_memory", [False, True])
def test_edit_requires_bk(runners, tmp_path, in_memory):
    tpl = _edit_template()
    tpl.bk = None
    template = tpl if in_memory else _write_template(tmp_path, tpl)
    with pytest.raises(FileNotFoundError, match="bk.mp4"):
        E.edit(runners[1], _ref_image(), template, width=32, height=32,
               steps=1, cfg_scale=1.0, seed=0)


def test_cli_validates_template_before_model_init(tmp_path):
    with pytest.raises(FileNotFoundError, match="sdc.mp4"):
        E.main(["--ref", str(tmp_path / "ref.png"), "--template",
                str(tmp_path / "missing"), "--output",
                str(tmp_path / "out.mp4")])
    tpl = _edit_template()
    tpl.bk = None
    d = _write_template(tmp_path, tpl)
    with pytest.raises(FileNotFoundError, match="bk.mp4"):
        E.main(["--ref", str(tmp_path / "ref.png"), "--template", d,
                "--output", str(tmp_path / "out.mp4")])


def test_cli_needs_cuda_after_input_checks(tmp_path, monkeypatch):
    """With valid inputs and no CUDA device, the CLI raises a RuntimeError
    that names CUDA, and builds no weights: no CPU fallback."""
    monkeypatch.setattr(E, "load_template",
                        lambda path, max_frames, require_bk:
                        types.SimpleNamespace(fps=30))
    monkeypatch.setattr(E.VIO, "load_image",
                        lambda path: np.zeros((8, 8, 3), np.uint8))
    built = []
    monkeypatch.setattr(E, "init_random_params",
                        lambda *a, **k: built.append("random"))
    monkeypatch.setattr(E, "load_params", lambda *a, **k: built.append("npz"))
    monkeypatch.setattr(E.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        E.main(["--ref", str(tmp_path / "ref.png"), "--template",
                str(tmp_path / "tpl"), "--output", str(tmp_path / "o.mp4"),
                "--steps", "2"])
    assert built == []
