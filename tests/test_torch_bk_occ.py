"""The port's background and occlusion stages
(mimo_tpu_torch/decomp/pipeline.py get_bk_recover / get_occ) against
mimo_tpu/decomp/pipeline.py, both through their factories from one
directory of tiny JAX-initialised bundles (raft.npz, propainter.npz,
depth.npz; the counterpart of tests/test_factory.py's wiring test), fp32 on
the CPU:

- get_bk_recover on a 6-frame 36x44 clip (run at 32x40, resized back);
  then the 0.75x back-off after one torch.cuda.OutOfMemoryError (or an
  error whose text says "out of memory", the JAX package's rule), any
  other error propagating, and an out-of-memory error below a ratio of 0.3
  propagating;
- the factories' depth on one frame; get_occ with that depth and shared
  automask / track callables, whose occluders pass the gates.

Tolerance: backgrounds within one uint8 level (the fp32 composite, computed
in another order, is truncated to uint8), equal in >= 99% of the values;
depth atol 1e-4 of its scale; the occ masks equal.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from mimo_tpu.decomp import depth_anything as JD
from mimo_tpu.decomp import factory as JF
from mimo_tpu.decomp import pipeline as JP
from mimo_tpu.decomp import propainter as JPP
from mimo_tpu.decomp import raft as JR
from mimo_tpu.weights.convert import save_npz
from mimo_tpu_torch.decomp import factory as FA
from mimo_tpu_torch.decomp import pipeline as P
from tests.test_torch_helpers import set_fp32_matmuls

set_fp32_matmuls()

T, H, W = 6, 36, 44


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiny_bundles")
    save_npz(jax.tree.map(np.asarray, JR.raft_init(
        jax.random.PRNGKey(1), JR.tiny_raft_config())), str(d / "raft.npz"))
    pp = jax.tree.map(np.asarray, JPP.propainter_init(
        jax.random.PRNGKey(0), JPP.tiny_propainter_config()))
    rng = np.random.default_rng(3)
    for align in (pp["flow"]["prop"]["align_fwd"],
                  pp["flow"]["prop"]["align_bwd"], pp["gen"]["align_fwd"],
                  pp["gen"]["align_bwd"]):
        for k in ("kernel", "bias"):      # live offsets
            c4 = align["offset"]["c4"]
            c4[k] = rng.normal(0, 0.05, c4[k].shape).astype(np.float32)
    save_npz(pp, str(d / "propainter.npz"))
    dp = jax.tree.map(np.asarray, JD.depth_anything_init(
        jax.random.PRNGKey(2), JD.tiny_depth_config()))
    dp["head3"]["bias"] = dp["head3"]["bias"] + 0.5   # depth > 0 everywhere
    save_npz(dp, str(d / "depth.npz"))
    port = FA.build_decomp_models(str(d), dtype=torch.float32, tiny=True,
                                  device="cpu")
    ref = JF.build_decomp_models(str(d), dtype=jnp.float32, tiny=True)
    assert port.inpaint is not None and port.depth is not None
    return port, ref


@pytest.fixture(scope="module")
def clip():
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
              for _ in range(T)]
    masks = np.zeros((T, H, W), bool)
    for i in range(T):
        masks[i, 10:24, 8 + 2 * i:20 + 2 * i] = True
    return frames, masks


@pytest.fixture(scope="module")
def bk_ref(models, clip):
    """The JAX package's background, computed once."""
    return JP.VideoProcessor(models[1]).get_bk_recover(*clip)


def _within_one_level(got, want):
    assert got.shape == want.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1
    assert (diff == 0).mean() >= 0.99


def _failing(fn, exc, times):
    """fn, raising exc on its first ``times`` calls."""
    calls = []

    def call(*args, **kwargs):
        calls.append(1)
        if len(calls) <= times:
            raise exc
        return fn(*args, **kwargs)
    call.calls = calls
    return call


def test_get_bk_recover_matches_jax(models, clip, bk_ref):
    vp = P.VideoProcessor(models[0])
    got = vp.get_bk_recover(*clip)
    _within_one_level(got, bk_ref)
    assert vp.bk_ratio == 1.0
    frames, masks = clip
    # far from the dilated masks the source frame passes through (the
    # composite keeps it, the resizes at 36x44 <-> 32x40 blur it a little)
    far = np.ones((T, H, W), bool)
    far[:, 4:30, :] = False
    diff = np.abs(got.astype(int) - np.stack(frames).astype(int))[far]
    assert np.median(diff) <= 40


def test_bk_backs_off_after_out_of_memory(models, clip):
    """One out-of-memory error: the second call runs at 0.75x (36x44 ->
    24x32, multiples of 8) and the result is resized back."""
    port = models[0]
    shapes = []

    def inpaint(frames01, masks):
        shapes.append((tuple(frames01.shape), tuple(masks.shape)))
        return port.inpaint(frames01, masks)

    pm = P.DecompModels(inpaint=_failing(
        inpaint, torch.cuda.OutOfMemoryError("CUDA out of memory"), 1))
    vp = P.VideoProcessor(pm)
    got = vp.get_bk_recover(*clip)
    assert vp.bk_ratio == 0.75 and len(pm.inpaint.calls) == 2
    assert shapes == [((T, 24, 32, 3), (T, 24, 32, 1))]
    assert got.shape == (T, H, W, 3) and got.dtype == np.uint8
    # the JAX package's test for "out of memory" text in any error
    pm = P.DecompModels(inpaint=_failing(
        inpaint, RuntimeError("RESOURCE_EXHAUSTED: out of memory"), 1))
    P.VideoProcessor(pm).get_bk_recover(*clip)
    assert len(pm.inpaint.calls) == 2


def test_bk_other_errors_propagate(models, clip):
    port = models[0]
    pm = P.DecompModels(inpaint=_failing(port.inpaint, ValueError("bad"), 1))
    with pytest.raises(ValueError, match="bad"):
        P.VideoProcessor(pm).get_bk_recover(*clip)
    assert len(pm.inpaint.calls) == 1
    oom = torch.cuda.OutOfMemoryError("CUDA out of memory")
    pm = P.DecompModels(inpaint=_failing(port.inpaint, oom, 100))
    with pytest.raises(torch.cuda.OutOfMemoryError):
        P.VideoProcessor(pm).get_bk_recover(*clip)
    # ratios 1, 0.75, 0.5625, 0.42, 0.316, then 0.237 < 0.3 re-raises
    assert len(pm.inpaint.calls) == 6
    assert P.VideoProcessor(P.DecompModels()).get_bk_recover(*clip) is None


def test_depth_and_get_occ_match_jax(models):
    port, ref = models
    rng = np.random.default_rng(4)
    frames = [rng.integers(0, 256, (64, 64, 3)).astype(np.uint8)
              for _ in range(T)]
    got = port.depth(frames[0])
    want = ref.depth(frames[0])
    assert got.shape == want.shape == (64, 64)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4 * scale)

    # person in the middle, split on frame 2 (the keyframe); candidates: a
    # box over the person's legs, which the depth puts partly in front of
    # the person's average, and the person itself
    person = np.zeros((T, 64, 64), np.uint8)
    person[:, 12:52, 24:40] = 1
    person[2, 30:33] = 0
    d0 = port.depth(frames[2])
    box = np.zeros((64, 64), bool)
    box[44:62, 18:46] = True
    front = (d0 > P.OCC.avg_depth_value(d0, person[2])) & box \
        & (person[2] == 0)
    assert 0.05 * box.sum() < front.sum() < box.sum()
    cands = [{"segmentation": box, "area": int(box.sum())},
             {"segmentation": person[2] > 0, "area": int(person[2].sum())}]
    body = np.zeros((64, 64, 3), np.uint8)      # the render: legs too
    body[12:62, 20:44] = 200
    sdc = [body] * T

    def track(frs, seed, kf):
        return np.repeat(seed[None], len(frs), 0)

    cfg = dict(num_keyframes=1, sdc_thresh_normal=1, sdc_thresh_large=1,
               overlap_threshold=0.05)
    for m in (port, ref):
        m.automask = lambda frame: cands
        m.track_video = track
    got = P.VideoProcessor(port, P.DecompConfig(
        occ=P.OCC.OcclusionConfig(**cfg))).get_occ(frames, person, sdc)
    want = JP.VideoProcessor(ref, JP.DecompConfig(
        occ=JP.OCC.OcclusionConfig(**cfg))).get_occ(frames, person, sdc)
    assert want is not None and want.any()
    np.testing.assert_array_equal(got, want)
    port.automask = port.track_video = None
    assert P.VideoProcessor(port).get_occ(frames, person, sdc) is None
