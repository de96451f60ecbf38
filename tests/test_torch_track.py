"""The port's human-tracking stage around the models: box_nms and
PoseScoredDetector (decomp/detector.py), clean_mask and label
(ops/connected_components.py, native and scipy), matting, the pipeline's
get_first_mask codes / get_human / get_bbox (decomp/pipeline.py), the
factory's build_decomp_models(only=...) from a tiny npz directory, its
SAM2 encode cache key (fault R3), and the track stage of
tools/profile_decomp.py at tiny size, each against mimo_tpu's
counterpart where there is one.

Tolerance: everything here is exact (host-side numpy on the same inputs,
or the same tiny fp32 models on both sides, where the masks may differ
only where |logit| < 1e-3, which these seeds do not reach).
"""

import numpy as np
import pytest
import jax
import torch

from mimo_tpu.decomp import detector as JD
from mimo_tpu.decomp import factory as JF
from mimo_tpu.decomp import matting as JM
from mimo_tpu.decomp import pipeline as JP
from mimo_tpu.decomp import sam as JS
from mimo_tpu.decomp import sam2 as JS2
from mimo_tpu.decomp import vitpose as JVP
from mimo_tpu.decomp.occlusion import sample_mask_points as j_sample_points
from mimo_tpu.ops import connected_components as JCC
from mimo_tpu.weights.convert import save_npz
from mimo_tpu_torch.decomp import detector as D
from mimo_tpu_torch.decomp import factory as FA
from mimo_tpu_torch.decomp import matting as M
from mimo_tpu_torch.decomp import pipeline as P
from mimo_tpu_torch.decomp import sam2 as S2
from mimo_tpu_torch.ops import connected_components as CC
from mimo_tpu_torch.tools import profile_decomp as PD
from tests.test_torch_helpers import set_fp32_matmuls

set_fp32_matmuls()


def test_box_nms_matches_jax():
    rng = np.random.default_rng(0)
    xy = rng.uniform(0, 50, (12, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 30, (12, 2))], 1)
    scores = rng.random(12)
    for thr in (0.1, 0.3, 0.5):
        assert D.box_nms(boxes, scores, thr) == JD.box_nms(boxes, scores,
                                                           thr)
    assert len(D.box_nms(boxes, scores, 0.1)) < 12


def _blobs(seed, h=40, w=56):
    rng = np.random.default_rng(seed)
    m = rng.random((h, w)) > 0.55
    m[5:25, 10:40] = True
    m[12:16, 20:24] = False                     # an interior hole
    return m


@pytest.fixture(params=["native", "scipy"])
def cc_backend(request, monkeypatch):
    if request.param == "scipy":
        monkeypatch.setitem(CC._STATE, "lib", None)
        monkeypatch.setitem(CC._STATE, "tried", True)
    else:
        assert CC.backend() == "native"          # g++ builds it here
    return request.param


@pytest.mark.parametrize("min_area,fill", [(64, True), (8, False),
                                           (256, True)])
def test_clean_mask_and_label_match_jax(cc_backend, min_area, fill):
    assert CC.backend() == cc_backend
    for seed in (1, 2):
        m = _blobs(seed)
        np.testing.assert_array_equal(
            CC.clean_mask(m, min_area, fill), JCC.clean_mask(m, min_area,
                                                             fill))
        lab, n = CC.label(m)
        lab_j, n_j = JCC.label(m)
        assert n == n_j
        # the same partition (label numbers may be assigned differently)
        pairs = set(zip(lab.ravel().tolist(), lab_j.ravel().tolist()))
        assert len(pairs) == n + 1


def test_native_library_builds_into_the_port_build_dir():
    CC._STATE.update(lib=None, tried=False)
    assert CC.backend() == "native"
    assert list(CC.BUILD_DIR.glob("libcc_labeling_*.so"))


def test_sample_mask_points_matches_jax():
    m = _blobs(3)
    np.testing.assert_array_equal(FA.sample_mask_points(m, n=5),
                                  j_sample_points(m, n=5))


def test_matting_matches_jax():
    rng = np.random.default_rng(4)
    img = np.full((48, 40, 3), 230, np.uint8)
    img[8:44, 12:30] = rng.integers(0, 90, (36, 18, 3))
    rgba, found = M.heuristic_matting(img)
    rgba_j, found_j = JM.heuristic_matting(img)
    np.testing.assert_array_equal(rgba, rgba_j)
    assert found == found_j is True
    np.testing.assert_array_equal(M.composite_on_white(rgba),
                                  JM.composite_on_white(rgba_j))


def _detector_inputs():
    def seg(y0, y1, x0, x1):
        m = np.zeros((60, 80), bool)
        m[y0:y1, x0:x1] = True
        return {"segmentation": m}
    cands = [seg(0, 3, 0, 3), seg(5, 55, 10, 40), seg(10, 50, 45, 75),
             seg(0, 60, 0, 20)]

    def pose(frame, bbox):
        k = np.zeros((133, 3))
        x0 = bbox[0]
        k[:17, 2] = {10: 0.8, 45: 0.9, 0: 0.1}.get(int(x0), 0.5)
        return k
    return (lambda frame: cands), pose


def test_pose_scored_detector_matches_jax():
    automask, pose = _detector_inputs()
    frame = np.zeros((60, 80, 3), np.uint8)
    got = D.PoseScoredDetector(automask, pose)(frame)
    want = JD.PoseScoredDetector(automask, pose)(frame)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] == pytest.approx(0.9)
    assert D.PoseScoredDetector(lambda f: [], pose)(frame) is None


def _stage_models(mod, kpt_conf=0.9, box=(10, 5, 50, 55)):
    def detect(frame):
        return np.array(box, np.float32), 0.99

    def segment(frame, bbox):
        m = _blobs(5, *frame.shape[:2])
        return m

    def track(frames, seed, kf):
        return np.stack([np.roll(seed, 2 * t, axis=1)
                         for t in range(len(frames))])

    def pose(frame, bbox):
        k = np.zeros((133, 3))
        k[:17, 2] = kpt_conf
        return k
    return mod.DecompModels(detect_person=detect, segment_box=segment,
                            track_video=track, estimate_pose=pose)


@pytest.mark.parametrize("case", ["ok", "no_person", "too_small",
                                  "half_body", "no_models"])
def test_get_first_mask_codes_match_jax(case):
    frame = np.zeros((40, 56, 3), np.uint8)
    kw = {"ok": {}, "too_small": dict(box=(10, 5, 12, 7)),
          "half_body": dict(kpt_conf=0.2)}.get(case, {})
    runs = []
    for mod in (P, JP):
        models = _stage_models(mod, **kw)
        if case == "no_person":
            models.detect_person = lambda f: None
        if case == "no_models":
            models.segment_box = None
        runs.append(mod.VideoProcessor(models).get_first_mask(frame))
    (m, code), (m_j, code_j) = runs
    assert code == code_j == {"ok": P.CODE_OK, "no_person": P.CODE_NO_PERSON,
                              "too_small": P.CODE_PERSON_TOO_SMALL,
                              "half_body": P.CODE_HALF_BODY,
                              "no_models": P.CODE_NO_PERSON}[case]
    if case == "ok":
        np.testing.assert_array_equal(m, m_j)
    else:
        assert m is None and m_j is None


def test_get_human_and_get_bbox_match_jax():
    frames = [np.zeros((40, 56, 3), np.uint8)] * 5
    masks, code = P.VideoProcessor(_stage_models(P)).get_human(frames)
    masks_j, code_j = JP.VideoProcessor(_stage_models(JP)).get_human(frames)
    assert code == code_j == P.CODE_OK
    np.testing.assert_array_equal(masks, masks_j)
    masks[2] = False                             # an empty frame
    masks[0] = False                             # ... and a first one
    np.testing.assert_array_equal(P.VideoProcessor.get_bbox(masks),
                                  JP.VideoProcessor.get_bbox(masks))
    untracked = _stage_models(P)
    untracked.track_video = None
    m, _ = P.VideoProcessor(untracked).get_human(frames)
    assert m.shape == (5, 40, 56) and (m == m[0]).all()


@pytest.fixture(scope="module")
def tiny_bundles(tmp_path_factory):
    d = tmp_path_factory.mktemp("decomp_weights")
    key = jax.random.PRNGKey(0)
    trees = {"sam": JS.sam_init(key, JS.tiny_sam_config()),
             "sam2": JS2.sam2_init(key, JS2.tiny_sam2_config()),
             "vitpose": JVP.vitpose_init(key, JVP.tiny_vitpose_config())}
    for name, tree in trees.items():
        save_npz(jax.tree.map(np.asarray, tree), str(d / f"{name}.npz"))
    return str(d)


def test_build_decomp_models_from_tiny_bundles_matches_jax(tiny_bundles):
    only = {"sam", "vitpose"}
    models = FA.build_decomp_models(tiny_bundles, dtype=torch.float32,
                                    tiny=True, only=only, device="cpu")
    models_j = JF.build_decomp_models(tiny_bundles, dtype=np.float32,
                                      tiny=True, only=only)
    for name in ("segment_box", "automask", "estimate_pose",
                 "detect_person"):
        assert (getattr(models, name) is None) == (
            getattr(models_j, name) is None), name
    assert models.track_video is None and models.segment_box is not None
    frame = np.random.default_rng(6).integers(0, 256, (64, 64, 3)).astype(
        np.uint8)
    bbox = np.array([8.0, 4.0, 50.0, 60.0])
    np.testing.assert_array_equal(models.segment_box(frame, bbox),
                                  models_j.segment_box(frame, bbox))
    np.testing.assert_allclose(models.estimate_pose(frame, bbox),
                               models_j.estimate_pose(frame, bbox),
                               atol=1e-4, rtol=1e-4)
    none = FA.build_decomp_models(tiny_bundles, tiny=True, only=set(),
                                  device="cpu")
    assert all(getattr(none, f) is None for f in (
        "segment_box", "track_video", "estimate_pose", "detect_person"))


def test_track_video_and_its_cache_key(tiny_bundles, monkeypatch):
    """track_video equals mimo_tpu's; the encode cache keys on every
    frame's content (or a clip id): two clips that share their first and
    last frames, the JAX key's fingerprint, are encoded apart (fault R3)."""
    models = FA.build_decomp_models(tiny_bundles, dtype=torch.float32,
                                    tiny=True, only={"sam2"}, device="cpu")
    models_j = JF.build_decomp_models(tiny_bundles, dtype=np.float32,
                                      tiny=True, only={"sam2"})
    rng = np.random.default_rng(7)
    frames = [rng.integers(0, 256, (64, 64, 3)).astype(np.uint8)
              for _ in range(4)]
    seed = np.zeros((64, 64), bool)
    seed[16:48, 20:44] = True
    np.testing.assert_array_equal(models.track_video(frames, seed, 0),
                                  models_j.track_video(frames, seed, 0))
    calls = []
    real = S2.SAM2VideoPredictor.init_state
    monkeypatch.setattr(S2.SAM2VideoPredictor, "init_state",
                        lambda self, fr, **kw: (calls.append(len(fr)),
                                                real(self, fr, **kw)))
    models.track_video(list(frames), seed, 0)          # same content: cached
    other = frames[:1] + [f[::-1].copy() for f in frames[1:3]] + frames[3:]
    models.track_video(other, seed, 0)                  # middle frames differ
    models.track_video(other, seed, 1, clip_id="clip a")
    models.track_video(frames, seed, 0, clip_id="clip a")   # id wins
    assert calls == [4, 4]
    assert FA.clip_key(frames) != FA.clip_key(other)


def test_profile_track_stage_at_tiny_size(tiny_bundles, monkeypatch):
    """The tool's track stage (known box -> segment_box + clean_mask;
    known mask -> track_video -> clean_mask -> get_bbox) on its synthetic
    clip, tiny models on the CPU: masks of the clip's shape, frame 0 the
    prompt frame's mask (cleaned), boxes inside the frame."""
    models = FA.build_decomp_models(tiny_bundles, dtype=torch.float32,
                                    tiny=True, only={"sam", "sam2"},
                                    device="cpu")
    prompted = []
    real = S2.SAM2VideoPredictor.add_new_points
    monkeypatch.setattr(S2.SAM2VideoPredictor, "add_new_points",
                        lambda self, *a: prompted.append(real(self, *a))
                        or prompted[-1])
    frames, seeds, boxes = PD.synth_frames(5, 72, 48)
    masks, bboxes, first = PD.track_stage(models, frames, seeds, boxes)
    assert masks.shape == (5, 72, 48) and masks.dtype == bool
    assert first.shape == (72, 48) and len(prompted) == 1
    np.testing.assert_array_equal(masks[0], CC.clean_mask(
        prompted[0], P.DecompConfig().mask_min_area))
    assert bboxes.shape == (5, 4)
    assert (bboxes[:, [0, 2]] <= 48).all() and (bboxes[:, [1, 3]] <= 72).all()
    assert (bboxes >= 0).all()
    with pytest.raises(SystemExit, match="not ported"):
        PD.main(["--stages", "track,pose"])
