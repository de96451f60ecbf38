"""The port's occlusion stage logic (mimo_tpu_torch/decomp/occlusion.py)
against mimo_tpu/decomp/occlusion.py, which calls OpenCV: the port computes
without it (its module imports no cv2, and the port's frames module is run
with cv2 = None), on the hand-built scenes of
tests/test_decomp_pipeline.py's occlusion cases (each held to the same
assertions and to the JAX package's result) and on seeded random masks:
clean_mask, extract_mask_sdc, pick_keyframes, refine_occ_mask and the whole
extract_occlusion_video with injected callables.

Tolerance: none. Every result is compared exactly (masks equal in every
pixel, the same keyframes and occluders).
"""

import numpy as np
import pytest

from mimo_tpu.decomp import occlusion as JO
from mimo_tpu_torch.decomp import occlusion as O
from mimo_tpu_torch.utils import frames as FU

_H, _W = 64, 80


@pytest.fixture(autouse=True)
def no_cv2(monkeypatch):
    monkeypatch.setattr(FU, "cv2", None)
    assert not hasattr(O, "cv2")


def _occ_scene():
    person = np.zeros((_H, _W), bool)
    person[10:50, 30:50] = True
    sdc = np.zeros((_H, _W), np.uint8)
    sdc[10:60, 30:50] = 1
    depth = np.full((_H, _W), 50, np.float64)
    depth[person] = 100
    return person, sdc, depth


def _cand(mask, depth):
    depth[mask & ~(depth == 100)] = 200       # the candidate is in front
    return {"segmentation": mask, "area": int(mask.sum())}


def _both(cands, depth, person, sdc):
    """The port's kept occluders, asserted equal to the JAX package's."""
    got = O.find_occluders_in_frame(cands, depth, person, sdc)
    want = JO.find_occluders_in_frame(cands, depth, person, sdc)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    return got


def _box(r0, r1, c0, c1):
    m = np.zeros((_H, _W), bool)
    m[r0:r1, c0:c1] = True
    return m


def test_avg_depth_value_denominator():
    depth = np.array([[0, 10], [20, 30]], np.float64)
    mask = np.array([[1, 1], [1, 0]], np.uint8)
    assert O.avg_depth_value(depth, mask) == 15.0 \
        == JO.avg_depth_value(depth, mask)


def test_occ_depth_gate():
    person, sdc, depth = _occ_scene()
    behind = _box(10, 44, 4, 28)
    cands = [_cand(_box(44, 60, 28, 52), depth),
             {"segmentation": behind, "area": int(behind.sum())}]
    kept = _both(cands, depth, person, sdc)
    assert len(kept) == 1 and not kept[0][20, 10]


def test_occ_normal_branch_sdc_100():
    person, sdc, depth = _occ_scene()
    assert len(_both([_cand(_box(44, 60, 28, 52), depth)], depth, person,
                     sdc)) == 1
    person, sdc, depth = _occ_scene()
    assert _both([_cand(_box(44, 60, 0, 24), depth)], depth, person,
                 sdc) == []


def test_occ_large_mask_branch_sdc_600():
    person, sdc, depth = _occ_scene()
    assert len(_both([_cand(_box(35, 60, 22, 45), depth)], depth, person,
                     sdc)) == 1
    person, sdc, depth = _occ_scene()
    assert _both([_cand(_box(10, 60, 10, 45), depth)], depth, person,
                 sdc) == []


def test_occ_ground_branch():
    person, sdc, depth = _occ_scene()
    assert len(_both([_cand(_box(48, 64, 0, _W), depth)], depth, person,
                     sdc)) == 1
    person, sdc, depth = _occ_scene()
    assert _both([_cand(_box(48, 64, 0, 70), depth)], depth, person,
                 sdc) == []


def test_occ_person_mask_rejected():
    person, sdc, depth = _occ_scene()
    cand = {"segmentation": person.copy(), "area": int(person.sum())}
    assert _both([cand], depth, person, sdc) == []


def test_pick_keyframes_component_ranked():
    masks = []
    for t in range(50):
        m = np.zeros((_H, _W), np.uint8)
        m[10:50, 30:50] = 1
        if t in (7, 8, 30):                  # an occluder splits the person
            m[25:32, :] = 0
        masks.append(m)
    cfg = O.OcclusionConfig(num_keyframes=2, keyframe_interval=20)
    picked = O.pick_keyframes(masks, cfg)
    assert picked == JO.pick_keyframes(masks, JO.OcclusionConfig(
        num_keyframes=2, keyframe_interval=20))
    assert len(picked) == 2
    assert any(p in (7, 8) for p in picked) and 30 in picked


def _blobs(rng, n, p=0.5):
    """Random masks of blobs with holes, touching the borders."""
    out = []
    for _ in range(n):
        m = rng.random((_H, _W)) < p
        m[rng.integers(0, _H):, :rng.integers(1, _W)] = True
        out.append(m)
    return out


def test_random_masks_match_jax():
    rng = np.random.default_rng(0)
    for m in _blobs(rng, 6):
        for scale in (1, 255):
            u8 = m.astype(np.uint8) * scale
            np.testing.assert_array_equal(O.clean_mask(u8),
                                          JO.clean_mask(u8))
        np.testing.assert_array_equal(O.refine_occ_mask(m),
                                      JO.refine_occ_mask(m))
    # gray near the threshold of 10: every (r, g, b) whose gray is 9-12
    v = np.arange(0, 48, dtype=np.uint8)
    img = np.stack(np.meshgrid(v, v, v, indexing="ij"), -1).reshape(
        48 * 48, 48, 3)
    np.testing.assert_array_equal(O.extract_mask_sdc(img),
                                  JO.extract_mask_sdc(img))
    masks = [m.astype(np.uint8) for m in _blobs(rng, 30, p=0.35)]
    cfg = dict(num_keyframes=4, keyframe_interval=5)
    assert O.pick_keyframes(masks, O.OcclusionConfig(**cfg)) \
        == JO.pick_keyframes(masks, JO.OcclusionConfig(**cfg))


def test_extract_occlusion_video_matches_jax():
    """The whole stage with injected models: two keyframes whose candidates
    pass (one twice, deduplicated against the merged mask), tracks OR-ed."""
    rng = np.random.default_rng(1)
    t = 30
    frames = [rng.integers(0, 255, (_H, _W, 3)).astype(np.uint8)
              for _ in range(t)]
    person, sdc, depth = _occ_scene()
    persons = [person.astype(np.uint8)] * t
    persons = [p.copy() for p in persons]
    for kf in (3, 26):
        persons[kf][25:32, :] = 0             # split: keyframes 3 and 26
    sdc_frames = [np.repeat(sdc[..., None] * 200, 3, -1).astype(np.uint8)] * t
    occ = _box(44, 60, 28, 52)
    depth_front = depth.copy()
    depth_front[occ & (depth != 100)] = 200

    def automask(frame):
        return [{"segmentation": occ.copy(), "area": int(occ.sum())},
                {"segmentation": person.copy(), "area": int(person.sum())}]

    def track(frs, seed, kf):
        out = np.zeros((len(frs), _H, _W), bool)
        out[:, seed.any(1)] = True            # the seed's rows on every frame
        out[kf] |= seed
        return out

    cfg = dict(num_keyframes=2, keyframe_interval=20)
    stats = {}
    got = O.extract_occlusion_video(frames, persons, sdc_frames, automask,
                                    lambda f: depth_front, track,
                                    O.OcclusionConfig(**cfg), stats=stats)
    want = JO.extract_occlusion_video(frames, persons, sdc_frames, automask,
                                      lambda f: depth_front, track,
                                      JO.OcclusionConfig(**cfg))
    np.testing.assert_array_equal(got, want)
    assert stats["keyframes"] == [3, 26] and stats["tracks"] == 1
    assert stats["occluders"] == [1, 1] and stats["candidates"] == [2, 2]
    # without sdc frames the person masks gate
    got = O.extract_occlusion_video(frames, persons, None, automask,
                                    lambda f: depth_front, track,
                                    O.OcclusionConfig(**cfg))
    want = JO.extract_occlusion_video(frames, persons, None, automask,
                                      lambda f: depth_front, track,
                                      JO.OcclusionConfig(**cfg))
    assert (got is None) == (want is None)
    if got is not None:
        np.testing.assert_array_equal(got, want)
