"""The entries' per-pixel work as batched tensor ops on the Runner's device
(``utils/frames.py``'s device functions, ``entry.animate.crop_template``,
``entry.edit.crop_shots`` and ``entry.edit.paste_back``) held to the
port's numpy functions, their oracle, in every bit on the CPU: the sdc mask
at the gray threshold, the union crop and animate's white background, the
shot split's boxes and crops, the pads, the batched resizes, the
paste-back with and without occlusion and across a cross-fade; both
entries through the dispatcher around a stub runner against the JAX
package's; the byte counters of a clip; and the template's uploads gone
from the device before the pipeline runs.

Where a resize is involved each case runs with OpenCV (the numpy path's
resizes through it on the host) and without it (through ``cv_resize``, as
the tensors always are); ``cv_resize`` itself is held to ``cv2.resize`` in
every bit over shrinks, growths and mixed scales."""

import gc
import weakref

import cv2
import numpy as np
import pytest
import torch

from mimo_tpu.entry import animate as JA
from mimo_tpu.entry import edit as JE
from mimo_tpu_torch import __main__ as M
from mimo_tpu_torch import config as C
from mimo_tpu_torch.entry import animate as AN
from mimo_tpu_torch.entry import edit as E
from mimo_tpu_torch.entry import runner as R
from mimo_tpu_torch.entry import template as T
from mimo_tpu_torch.utils import frames as FU
from mimo_tpu_torch.utils import profiling as PR
from mimo_tpu_torch.utils import video_io as VIO
from tests.test_torch_edit import (StubRunner, _assert_same, _clip,
                                   _edit_template, _ref_image,
                                   _write_template)

CPU = torch.device("cpu")


@pytest.fixture(params=["opencv", "no-opencv"])
def opencv(request, monkeypatch):
    """Both resize paths of the numpy functions: OpenCV's, and
    ``cv_resize`` where OpenCV does not import."""
    if request.param == "no-opencv":
        monkeypatch.setattr(FU, "cv2", None)
    return request.param


def _bare_runner():
    """A Runner that only uploads (the template's stages need no
    weights)."""
    return R.Runner(cfg=C.tiny_mimo_config(), params={}, device=CPU,
                    dtype=torch.float32)


def _clock():
    return PR.PhaseClock(CPU)


def _clips():
    return {"static": _clip("static"), "shot_split": _clip("shot_split"),
            "edit": _clip("edit"), "empty": _clip("empty"),
            "pixel": [_dot(40, 56, 3 + t, 50 - 2 * t) for t in range(6)]}


def _dot(h, w, y, x):
    f = np.zeros((h, w, 3), np.uint8)
    f[y, x] = (90, 40, 12)
    return f


# ---------------------------------------------------------------------------
# masks, boxes, pads, resizes
# ---------------------------------------------------------------------------


def _threshold_frame():
    """Every colour with channels in [0, 48): the gray levels on both sides
    of 10, and on it ((10, 10, 10) is 10.0, not in the mask)."""
    c = np.arange(48)
    r, g, b = np.meshgrid(c, c, c, indexing="ij")
    return np.stack([r, g, b], -1).reshape(48 * 48, 48, 3).astype(np.uint8)


@pytest.mark.parametrize("clean", [False, True])
def test_sdc_mask_at_the_threshold(clean):
    img = _threshold_frame()
    want = FU.extract_mask_sdc(img)
    if clean:
        want = FU.clean_mask(want)
    got = FU.sdc_masks(torch.from_numpy(img)[None], clean=clean)[0]
    assert 0 < want.astype(bool).sum() < want.size
    assert not want[10 * 48 + 10, 10]        # the colour (10, 10, 10)
    np.testing.assert_array_equal(got.numpy(), want > 0)


@pytest.mark.parametrize("name", sorted(_clips()))
@pytest.mark.parametrize("clean", [False, True])
def test_sdc_rects_equal_mask_bbox(name, clean):
    frames = _clips()[name]
    want = []
    for f in frames:
        m = FU.extract_mask_sdc(f)
        want.append(FU.mask_bbox(FU.clean_mask(m) if clean else m))
    got = FU.sdc_rects(torch.from_numpy(np.stack(frames)), clean=clean)
    assert got == want
    assert all(type(v) is int for r in got for v in r)


@pytest.mark.parametrize("shape", [(40, 40), (7, 90), (130, 3), (32, 17)])
@pytest.mark.parametrize("color", [(0, 0, 0), (255, 255, 255), (9, 80, 200)])
def test_pad_frames_equal_pad_img(shape, color):
    rng = np.random.default_rng(shape[0])
    frames = rng.integers(0, 256, (3,) + shape + (3,)).astype(np.uint8)
    got, padding = FU.pad_frames(torch.from_numpy(frames), color)
    for g, f in zip(got.numpy(), frames):
        want, want_padding = FU.pad_img(f, color)
        assert padding == want_padding
        np.testing.assert_array_equal(g, want)


RESIZES = [
    (60, 64, 30, 24),       # INTER_AREA, both shrink, non-whole scales
    (64, 64, 32, 32),       # INTER_AREA halving: resizeAreaFast's (+2) >> 2
    (96, 96, 32, 48),       # whole scales 3 and 2: resizeAreaFast's float
    (60, 64, 100, 40),      # the width shrinks, the height grows: area taps
    (60, 64, 120, 96),      # INTER_LINEAR growth
    (60, 64, 30, 64),       # the width kept, the height halved: linear
    (33, 47, 100, 61),      # odd sizes
    (61, 100, 33, 47),
    (128, 128, 64, 64),
    (704, 704, 784, 512),   # an animate crop to the generation's size
    (720, 720, 784, 784),   # an edit shot to the generation's size
    (784, 784, 704, 704),   # the generation back to an edit shot
    (1280, 1280, 784, 512),
]


@pytest.mark.parametrize("src_h,src_w,h,w", RESIZES)
@pytest.mark.parametrize("area", [True, False])
def test_cv_resize_equals_opencv(src_h, src_w, h, w, area):
    rng = np.random.default_rng(src_h * w)
    frames = rng.integers(0, 256, (2, src_h, src_w, 3)).astype(np.uint8)
    frames[1] = np.clip(np.arange(src_w)[None, :, None] * 3
                        + np.arange(src_h)[:, None, None] * 2, 0, 255)
    interp = cv2.INTER_AREA if area else cv2.INTER_LINEAR
    got = FU.cv_resize(torch.from_numpy(frames), w, h, area)
    assert got.dtype == torch.uint8 and got.shape == (2, h, w, 3)
    for g, f in zip(got.numpy(), frames):
        np.testing.assert_array_equal(
            g, cv2.resize(f, (w, h), interpolation=interp))


def test_cv_resize_equals_opencv_at_random_sizes():
    rng = np.random.default_rng(21)
    for _ in range(24):
        src_h, src_w = (int(v) for v in rng.integers(2, 200, 2))
        h, w = (int(v) for v in rng.integers(2, 260, 2))
        f = rng.integers(0, 256, (src_h, src_w, 3)).astype(np.uint8)
        for area in (True, False):
            interp = cv2.INTER_AREA if area else cv2.INTER_LINEAR
            got = FU.cv_resize(torch.from_numpy(f)[None], w, h, area)[0]
            np.testing.assert_array_equal(
                got.numpy(), cv2.resize(f, (w, h), interpolation=interp),
                err_msg=f"{(src_h, src_w)} -> {(h, w)}, area {area}")


@pytest.mark.parametrize("w,h", [
    (24, 30),      # shrink both
    (96, 120),     # grow both
    (40, 100),     # shrink the width, grow the height: INTER_AREA
    (64, 30),      # the width kept: INTER_LINEAR
])
def test_resize_frames_equal_frame_by_frame(w, h, opencv):
    """The batch on the device against ``resize_frame`` frame by frame on
    the host, and both against OpenCV."""
    rng = np.random.default_rng(w)
    frames = rng.integers(0, 256, (4, 60, 64, 3)).astype(np.uint8)
    got = FU.resize_frames(torch.from_numpy(frames), w, h)
    assert got.dtype == torch.uint8 and got.shape == (4, h, w, 3)
    interp = cv2.INTER_AREA if w < 64 else cv2.INTER_LINEAR
    for g, f in zip(got.numpy(), frames):
        want = cv2.resize(f, (w, h), interpolation=interp)
        np.testing.assert_array_equal(FU.resize_frame(f, w, h), want)
        np.testing.assert_array_equal(g, want)


def test_to_unit_is_true_division():
    x = np.arange(256, dtype=np.uint8)
    want = x.astype(np.float32) / 255.0
    got = FU.to_unit(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # the product with the reciprocal, which CUDA makes of a division by a
    # Python number, would not do
    assert (x.astype(np.float32) * (np.float32(1) / 255) != want).any()


def test_upload_frames_views_and_counts():
    frames = [np.arange(24, dtype=np.uint8).reshape(2, 4, 3) + i
              for i in range(3)]
    clock = _clock()
    got = _bare_runner().upload([f[..., 0] for f in frames], clock)
    np.testing.assert_array_equal(got.numpy(),
                                  np.stack([f[..., 0] for f in frames]))
    assert clock.bytes == {"h2d": 3 * 8, "d2h": 0}


# ---------------------------------------------------------------------------
# the template stages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["static", "shot_split", "edit", "pixel"])
def test_crop_template_equals_crop_human(name):
    """animate's union crop, its pads, and the white background that
    init_bk -> crop -> pad_img makes."""
    frames = _clips()[name]
    bk = FU.init_bk(len(frames), *frames[0].shape[:2])
    pose_c, bk_c, _ = FU.crop_human(frames, bk)
    clock = _clock()
    pose, back = AN.crop_template(_bare_runner(), frames, clock)
    assert pose.dtype == back.dtype == torch.uint8
    for g, p in zip(pose.numpy(), pose_c):
        np.testing.assert_array_equal(g, FU.pad_img(p, (0, 0, 0))[0])
    for g, b in zip(back.numpy(), bk_c):
        np.testing.assert_array_equal(g, FU.pad_img(b, (255, 255, 255))[0])
    assert clock.bytes == {"h2d": sum(f.nbytes for f in frames),
                           "d2h": 4 * 8 * len(frames)}


@pytest.mark.parametrize("name", ["static", "shot_split", "edit", "empty"])
def test_crop_shots_equal_shot_split(name):
    """edit's shot split from the device's boxes: the same shots, bboxes,
    crops, pads and pad_info as crop_human_clip_auto_context and pad_img
    on the host ('empty': no mask, the whole-frame fallback)."""
    frames = _clips()[name]
    bk = [255 - f // 2 for f in frames]
    pose_c, _, bk_c, _, ctx, bboxes = FU.crop_human_clip_auto_context(
        frames, frames, bk, E.OVERLAY)
    pose, back, pad_info, got_ctx, got_bboxes = E.crop_shots(
        _bare_runner(), frames, bk, _clock())
    assert (got_ctx, got_bboxes) == (ctx, bboxes)
    assert [len(p) for p in pose] == [len(c) for c in ctx]
    pose = [f for b in pose for f in b.numpy()]
    back = [f for b in back for f in b.numpy()]
    want_info = []
    for g, p in zip(pose, pose_c):
        np.testing.assert_array_equal(g, FU.pad_img(p, (0, 0, 0))[0])
    for g, b in zip(back, bk_c):
        bb, padding_v = FU.pad_img(b, (255, 255, 255))
        np.testing.assert_array_equal(g, bb)
        want_info.append((bb.shape[0], bb.shape[1], padding_v))
    assert pad_info == want_info


# ---------------------------------------------------------------------------
# the paste-back
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("occ", [True, False])
def test_paste_back_equals_composite_back(occ, opencv):
    """Two shots sharing OVERLAY frames (a cross-fade), the feather masks,
    the occlusion alpha-over: equal in every bit to the numpy paste-back
    on the same resize path."""
    tpl = _edit_template(occ=occ)
    pose_c, _, bk_c, _, ctx, bboxes = FU.crop_human_clip_auto_context(
        tpl.sdc, tpl.vid, tpl.bk, E.OVERLAY)
    assert len(ctx) == 2 and set(ctx[0]) & set(ctx[1])
    pad_info = []
    for b in bk_c:
        bb, padding_v = FU.pad_img(b)
        pad_info.append((bb.shape[0], bb.shape[1], padding_v))
    rng = np.random.default_rng(3)
    video = rng.uniform(0, 1, (len(pose_c), 32, 32, 3)).astype(np.float32)
    want = E.composite_back(video, ctx, bboxes, pad_info, tpl.bk, tpl.vid,
                            tpl.occ)
    occ_t = (torch.from_numpy(np.stack([o[..., 0] for o in tpl.occ]))
             if occ else None)
    got = E.paste_back(torch.from_numpy(video), ctx, bboxes, pad_info,
                       torch.from_numpy(np.stack(tpl.bk)),
                       torch.from_numpy(np.stack(tpl.vid)), occ_t)
    assert got.dtype == torch.uint8
    _assert_same(list(got.numpy()), want)


def test_paste_back_drops_frames_no_shot_covers():
    tpl = _edit_template(n=6, occ=False)
    bk = torch.from_numpy(np.stack(tpl.bk))
    ctx, bboxes = [[1, 2, 3]], [(8, 40, 16, 48)]
    pad_info = [(32, 32, (0, 0, 0, 0))] * 3
    video = np.random.default_rng(0).uniform(
        0, 1, (3, 16, 16, 3)).astype(np.float32)
    want = E.composite_back(video, ctx, bboxes, pad_info, tpl.bk, tpl.vid,
                            None)
    got = E.paste_back(torch.from_numpy(video), ctx, bboxes, pad_info, bk,
                       torch.from_numpy(np.stack(tpl.vid)), None)
    assert len(want) == 3
    _assert_same(list(got.numpy()), want)


# ---------------------------------------------------------------------------
# both entries through the dispatcher, around a stub runner
# ---------------------------------------------------------------------------


def _through_dispatcher(cmd, module, tmp_path, template, monkeypatch):
    """``python -m mimo_tpu_torch <cmd>`` on a template directory, with a
    stub in place of the model: the CLI's CUDA gate passed, no weights
    built. Returns the stub and the frames the command wrote."""
    stub = StubRunner()
    generator = torch.Generator
    monkeypatch.setattr(module.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(module.torch, "Generator",
                        lambda device=None: generator())
    monkeypatch.setattr(module, "init_random_params", lambda *a, **k: {})
    monkeypatch.setattr(module, "Runner", lambda **kw: stub)
    ref = str(tmp_path / "ref.png")
    VIO.save_image(_ref_image(), ref)
    out = str(tmp_path / f"{cmd}.mp4")
    M.main([cmd, "--ref", ref, "--template", template, "--output", out,
            "--W", "32", "--H", "48", "--steps", "2", "--seed", "5"])
    return stub, VIO.read_frames(out)


@pytest.mark.parametrize("cmd", ["animate", "edit"])
def test_entries_through_dispatcher_equal_jax(cmd, tmp_path, monkeypatch):
    """The generation's inputs the port's entry hands its runner (uint8
    tensors made on the device) are the numpy frames the JAX package's
    entry hands generate, and the written videos are equal."""
    tpl = _edit_template()
    d = _write_template(tmp_path, tpl)
    kw = dict(width=32, height=48, steps=2, cfg_scale=3.5, seed=5)
    jax_stub = StubRunner()
    jax_entry = JA.animate if cmd == "animate" else JE.edit
    want = jax_entry(jax_stub, _ref_image(), d, **kw)
    module = AN if cmd == "animate" else E
    stub, written = _through_dispatcher(cmd, module, tmp_path, d,
                                        monkeypatch)
    (jref, jpose, jbk, jkw), = jax_stub.calls
    (ref, pose, bk, pkw), = stub.calls
    assert pkw == jkw
    _assert_same((ref, pose, bk), (jref, jpose, jbk))
    assert len(written) == len(want)
    back = VIO.read_frames(_save(tmp_path, want))
    _assert_same(written, back)


def _save(tmp_path, frames):
    p = str(tmp_path / "want.mp4")
    VIO.save_video(frames, p, fps=30)
    return p


# ---------------------------------------------------------------------------
# a clip's copies and the device's memory during the pipeline
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runner():
    cfg = C.tiny_mimo_config()
    params = R.init_random_params(cfg, torch.Generator().manual_seed(0),
                                  dtype=torch.float32)
    return R.Runner(cfg=cfg, params=params, device=CPU, dtype=torch.float32)


def _template(n=5):
    tpl = _edit_template(n=n)
    return T.Template(path="in-memory", fps=30, sdc=tpl.sdc, vid=tpl.vid,
                      bk=tpl.bk, occ=tpl.occ)


def _run(runner, entry, tpl):
    kw = dict(width=32, height=32, steps=1, cfg_scale=3.5, seed=3)
    if entry == "animate":
        return AN.animate(runner, _ref_image(), tpl.sdc, **kw)
    return E.edit(runner, _ref_image(), tpl, **kw)


@pytest.mark.parametrize("entry", ["animate", "edit"])
def test_clip_counts_its_copies(runner, entry):
    """Full frames go to the device once as uint8 (and edit's paste-back
    streams once more after the decode), the boxes come back as F x 4
    integers, and the video as animate's float32 array or edit's uint8
    frames: no float32 frame goes up."""
    tpl = _template()
    out = _run(runner, entry, tpl)
    tm = runner.last_timings
    n = len(tpl.sdc)
    frame = tpl.sdc[0].nbytes
    ref = R.prep_reference_image(_ref_image()).nbytes
    if entry == "animate":
        assert tm["h2d_bytes"] == n * frame + ref
        assert tm["d2h_bytes"] == 4 * 8 * n + out.nbytes
        assert out.dtype == np.float32
        return
    _, _, _, _, ctx, bboxes = FU.crop_human_clip_auto_context(
        tpl.sdc, tpl.vid, tpl.bk, E.OVERLAY)
    feathers = 0
    for c, (x0, x1, y0, y1) in zip(ctx, bboxes):
        feathers += 4 * (y1 - y0) * (x1 - x0)
    # sdc and bk for the crops, the reference; bk, vid and occ for the
    # paste-back; its feather masks
    assert tm["h2d_bytes"] == (2 * n * frame + ref + 3 * n * frame
                               + feathers)
    assert tm["d2h_bytes"] == 4 * 8 * n + sum(f.nbytes for f in out)
    assert all(f.dtype == np.uint8 for f in out)


@pytest.mark.parametrize("entry", ["animate", "edit"])
def test_template_uploads_leave_before_the_pipeline(runner, entry,
                                                    monkeypatch):
    """Every tensor the template stage uploaded or padded is freed when
    the pipeline starts, and the paste-back uploads nothing before it."""
    made = []
    for name in ("upload_frames", "pad_frames"):
        fn = getattr(FU, name)

        def tracked(*args, _fn=fn, **kwargs):
            out = _fn(*args, **kwargs)
            t = out[0] if isinstance(out, tuple) else out
            made.append(weakref.ref(t))
            return out

        monkeypatch.setattr(FU, name, tracked)
    alive = []
    run = R.Runner.run

    def checked(self, job, clock):
        gc.collect()
        alive.append(sum(r() is not None for r in made))
        return run(self, job, clock)

    monkeypatch.setattr(R.Runner, "run", checked)
    _run(runner, entry, _template())
    assert len(made) >= 2 and alive == [0]
