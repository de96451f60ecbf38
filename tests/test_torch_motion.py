"""The pose and motion stages of the port (mimo_tpu_torch/decomp/{motion,
factory,pipeline}.py, vitpose.estimate_pose_batch) against mimo_tpu on
JAX-initialised tiny params through the weights bridge, fp32 on the CPU:
the SMPL-H pose fusion at J = 52 (per frame and batched, every hand
combination), HaMeR's hand path on keypoints that find both hands,
estimate_motion end to end on tests/test_motion.py's setup (random-topology
faces added so the sdc is not empty), the batched pose stage against JAX
and against the per-frame path, and the factory's seeded full motion stage.

Tolerances: poses 1e-5; HaMeR rotations 1e-4; vertices 1e-4; the sdc
within one uint8 level except at pixels near a face edge (the renderer's
tolerance, tests/test_torch_renderer.py); keypoints 1e-5.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from mimo_tpu.decomp import hmr as JHM
from mimo_tpu.decomp import motion as JMO
from mimo_tpu.decomp import smpl as JSM
from mimo_tpu.decomp import vitpose as JVP
from mimo_tpu.decomp.transforms import aa_to_rotmat
from mimo_tpu_torch.decomp import factory as FA
from mimo_tpu_torch.decomp import hmr as HM
from mimo_tpu_torch.decomp import motion as MO
from mimo_tpu_torch.decomp import pipeline as DP
from mimo_tpu_torch.decomp import smpl as SM
from mimo_tpu_torch.decomp import vit as V
from mimo_tpu_torch.decomp import vitpose as VP
from tests.test_torch_helpers import bridge_params, nn, set_fp32_matmuls, tt
from tests.test_torch_motion_core import _port_hmr_cfg, _port_model
from tests.test_torch_renderer import edges_and_areas

set_fp32_matmuls()


def _port_vp_cfg(cfg):
    return VP.ViTPoseConfig(backbone=V.ViTConfig(**cfg.backbone.__dict__),
                            **{f.name: getattr(cfg, f.name)
                               for f in dataclasses.fields(cfg)
                               if f.name != "backbone"})


def _rotmats(rng, n):
    return np.asarray(aa_to_rotmat(jnp.asarray(
        rng.standard_normal((n, 3)).astype(np.float32) * 0.2)))


HANDS = [("none", "none"), ("left", "none"), ("none", "right"),
         ("left", "right")]


def _estimators(hamer=False):
    """A JAX MotionEstimator at J = 52 and the port's on the same weights."""
    jm = JSM.random_test_model(jax.random.PRNGKey(0), n_joints=52)
    hcfg = JHM.tiny_hmr_config(num_joints=22)
    hp = JHM.hmr_init(jax.random.PRNGKey(2), hcfg)
    kw = {}
    if hamer:
        acfg = JHM.tiny_hmr_config(num_joints=16)
        ap = JHM.hmr_init(jax.random.PRNGKey(4), acfg)
        kw = dict(hamer_params=ap, hamer_cfg=acfg)
    je = JMO.MotionEstimator(
        vitpose_params=None, vitpose_cfg=JVP.tiny_vitpose_config(),
        hmr_params=hp, hmr_cfg=hcfg, smpl_model=jm, **kw)
    if hamer:
        kw = dict(hamer_params=bridge_params(ap),
                  hamer_cfg=_port_hmr_cfg(acfg))
    pe = MO.MotionEstimator(
        vitpose_params=None,
        vitpose_cfg=_port_vp_cfg(JVP.tiny_vitpose_config()),
        hmr_params=bridge_params(hp), hmr_cfg=_port_hmr_cfg(hcfg),
        smpl_model=_port_model(jm), **kw)
    return je, pe


def test_fuse_pose_matches_jax_every_hand_combination():
    je, pe = _estimators()
    rng = np.random.default_rng(7)
    T = len(HANDS)
    body = np.stack([_rotmats(rng, 22) for _ in range(T)])
    hands = [{"left": _rotmats(rng, 16) if l != "none" else None,
              "right": _rotmats(rng, 16) if r != "none" else None}
             for l, r in HANDS]
    want = np.stack([np.asarray(je.fuse_pose(jnp.asarray(body[t]),
                                             hands[t])) for t in range(T)])
    for t in range(T):
        got = pe.fuse_pose(tt(body[t]), {k: None if v is None else tt(v)
                                         for k, v in hands[t].items()})
        np.testing.assert_allclose(nn(got), want[t], atol=1e-5)
    packed = MO.pack_hands([{k: None if v is None else tt(v)
                             for k, v in h.items()} for h in hands], 16,
                           "cpu")
    batched = MO.fuse_pose_batch(52, tt(body), *packed)
    np.testing.assert_allclose(nn(batched), want, atol=1e-5)
    assert np.abs(want[3, 22:52]).sum() > 0
    np.testing.assert_allclose(want[0, 22:52], 0.0)


def _hand_keypoints(rng, t, h, w):
    """133 wholebody keypoints a frame whose two hands' 21 points are
    confident and spread over a hand-sized patch."""
    k = np.zeros((t, 133, 3))
    k[..., 0] = rng.uniform(0, w, (t, 133))
    k[..., 1] = rng.uniform(0, h, (t, 133))
    k[..., 2] = 0.1
    for lo, cx in ((-42, 0.35 * w), (-21, 0.65 * w)):
        sl = slice(lo, lo + 21 or None)
        k[:, sl, 0] = cx + rng.uniform(-6, 6, (t, 21))
        k[:, sl, 1] = 0.5 * h + rng.uniform(-6, 6, (t, 21))
        k[:, sl, 2] = 0.9
    return k


def test_hand_params_match_jax():
    """Both hands found on every frame: HaMeR's rotations (the left hand
    mirrored into the model and back) as the JAX package's, and every crop
    counted."""
    je, pe = _estimators(hamer=True)
    rng = np.random.default_rng(3)
    frames = [rng.integers(0, 256, (48, 64, 3)).astype(np.uint8)
              for _ in range(2)]
    kpts = _hand_keypoints(rng, 2, 48, 64)
    want = je.hand_params(frames, kpts)
    got = pe.hand_params(frames, kpts)
    assert pe.hand_crops == 4
    for g, w in zip(got, want):
        for side in ("left", "right"):
            assert g[side].shape == (16, 3, 3)
            np.testing.assert_allclose(nn(g[side]), np.asarray(w[side]),
                                       atol=1e-4)


def test_estimate_motion_matches_jax():
    """tests/test_motion.py's end-to-end setup, with random-topology faces
    on its 64-vertex model: the posed vertices within 1e-4 and the sdc
    within one level but near face edges."""
    key = jax.random.PRNGKey(0)
    hcfg = JHM.tiny_hmr_config(num_joints=5)
    vcfg = JVP.tiny_vitpose_config()
    vp = JVP.vitpose_init(jax.random.PRNGKey(1), vcfg)
    hp = JHM.hmr_init(jax.random.PRNGKey(2), hcfg)
    faces = np.random.default_rng(9).integers(0, 64, (48, 3))
    jm = dataclasses.replace(JSM.random_test_model(key), faces=faces)
    je = JMO.MotionEstimator(vitpose_params=vp, vitpose_cfg=vcfg,
                             hmr_params=hp, hmr_cfg=hcfg, smpl_model=jm,
                             focal=100.0)
    pe = MO.MotionEstimator(
        vitpose_params=bridge_params(vp, kind="vitpose"),
        vitpose_cfg=_port_vp_cfg(vcfg), hmr_params=bridge_params(hp),
        hmr_cfg=_port_hmr_cfg(hcfg), smpl_model=_port_model(jm),
        focal=100.0)
    rng = np.random.default_rng(0)
    frames = [rng.uniform(0, 255, (48, 64, 3)).astype(np.uint8)
              for _ in range(2)]
    masks = [np.ones((48, 64), bool)] * 2
    bboxes = np.array([[10, 5, 50, 45], [12, 5, 52, 45]])

    seen = {}
    render = JMO.REND.render_frames

    def spy(verts, *args, **kwargs):
        seen["verts"] = np.asarray(verts)
        return render(verts, *args, **kwargs)

    JMO.REND.render_frames = spy
    try:
        want = je.estimate_motion(frames, masks, bboxes)
    finally:
        JMO.REND.render_frames = render
    np.testing.assert_allclose(nn(pe.posed_vertices(frames, bboxes)),
                               seen["verts"], atol=1e-4, rtol=1e-4)
    got = pe.estimate_motion(frames, masks, bboxes)
    assert got.shape == want.shape == (2, 48, 64, 3)
    assert got.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int)).max(-1)
    near = np.stack([edges_and_areas(v, faces, 100.0,
                                     np.array([32.0, 24.0]), 48, 64)[0]
                     for v in seen["verts"]])
    assert (want > 0).any()
    assert (diff[~near] <= 1).all(), int((diff[~near] > 1).sum())


def test_mesh_of_one_rank_gives_the_single_process_sdc():
    """MotionEstimator(mesh=...) on a gloo world of one rank (spawned by
    entry/graft.py) gives the single-process sdc in every bit, on
    test_estimate_motion_matches_jax's setup (its sdc is not empty)."""
    from mimo_tpu_torch.entry import graft
    hcfg = JHM.tiny_hmr_config(num_joints=5)
    vcfg = JVP.tiny_vitpose_config()
    faces = np.random.default_rng(9).integers(0, 64, (48, 3))
    jm = dataclasses.replace(JSM.random_test_model(jax.random.PRNGKey(0)),
                             faces=faces)
    models = {"vitpose": (bridge_params(JVP.vitpose_init(
        jax.random.PRNGKey(1), vcfg), kind="vitpose"), _port_vp_cfg(vcfg)),
        "hmr": (bridge_params(JHM.hmr_init(jax.random.PRNGKey(2), hcfg)),
                _port_hmr_cfg(hcfg)),
        "smpl": _port_model(jm), "focal": 100.0}
    rng = np.random.default_rng(0)
    clip = ([rng.uniform(0, 255, (48, 64, 3)).astype(np.uint8)
             for _ in range(2)], [np.ones((48, 64), bool)] * 2,
            np.array([[10, 5, 50, 45], [12, 5, 52, 45]]))
    (got,), = graft.spawn(graft.motion_body, 1, backend="gloo",
                          device="cpu",
                          args=(models, [dict(op="motion", clip=clip)]))
    want = MO.MotionEstimator(
        vitpose_params=models["vitpose"][0], vitpose_cfg=models["vitpose"][1],
        hmr_params=models["hmr"][0], hmr_cfg=models["hmr"][1],
        smpl_model=models["smpl"], focal=100.0).estimate_motion(*clip)
    assert want.any()
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def vitpose_dir(tmp_path_factory):
    from mimo_tpu.weights.convert import save_npz
    d = tmp_path_factory.mktemp("w")
    save_npz(jax.tree.map(np.asarray, JVP.vitpose_init(
        jax.random.PRNGKey(0), JVP.tiny_vitpose_config())),
        str(d / "vitpose.npz"))
    return d


def test_estimate_pose_batch_matches_jax_and_per_frame(vitpose_dir):
    """tests/test_factory.py's case: 5 frames in batches of 2 (a short last
    one) against the JAX package's batched path and the port's per-frame
    path."""
    import mimo_tpu.decomp.factory as JF
    rng = np.random.default_rng(0)
    T, H, W = 5, 96, 72
    frames = [rng.integers(0, 255, (H, W, 3)).astype(np.uint8)
              for _ in range(T)]
    boxes = np.asarray([[8 + t, 10, 8 + t + 40, 10 + 70] for t in range(T)],
                       np.int64)
    want = JF.build_decomp_models(str(vitpose_dir), dtype=jnp.float32,
                                  tiny=True).estimate_pose_batch(
        frames, boxes, batch=2)
    models = FA.build_decomp_models(str(vitpose_dir), dtype=torch.float32,
                                    tiny=True, device="cpu")
    got = models.estimate_pose_batch(frames, boxes, batch=2)
    single = np.stack([models.estimate_pose(frames[t], boxes[t])
                       for t in range(T)])
    assert got.shape == want.shape == (T, 7, 3)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, single, atol=1e-5)


def test_factory_seeded_motion_stage_runs_get_motion():
    """build_decomp_models(None) wires the whole motion stage (seeded
    ViTPose, HMR2, HaMeR, the surface SMPL-H, the renderer); get_motion
    gives a uint8 sdc of the frames' size, and None without the stage."""
    models = FA.build_decomp_models(None, dtype=torch.float32, tiny=True,
                                    device="cpu",
                                    only={"vitpose", "hmr", "hamer"})
    est = models.estimate_motion.__self__
    assert est.smpl_model.num_verts == 6890 and est.hamer_params is not None
    assert models.estimate_pose_batch is not None
    # the tiny body head regresses 5 joints; SMPL-H's elbow chains need 20
    cfg = HM.tiny_hmr_config(num_joints=24)
    hp = HM.hmr_init(torch.Generator().manual_seed(3), cfg)
    for k in ("kernel", "bias"):       # the mean camera: the body in view
        hp["dec_cam"][k].zero_()
    est = dataclasses.replace(est, hmr_cfg=cfg, hmr_params=hp)
    models.estimate_motion = est.estimate_motion
    rng = np.random.default_rng(1)
    frames = [rng.integers(0, 256, (40, 32, 3)).astype(np.uint8)
              for _ in range(2)]
    boxes = np.array([[4, 4, 28, 36], [5, 4, 29, 36]])
    sdc = DP.VideoProcessor(models).get_motion(frames, None, boxes)
    assert sdc.shape == (2, 40, 32, 3) and sdc.dtype == np.uint8
    assert est.render_stats["covered"] > 0 and sdc.any()
    assert DP.VideoProcessor(DP.DecompModels()).get_motion(
        frames, None, boxes) is None
