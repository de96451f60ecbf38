"""The decomposition's frame-parallel motion stage in the port
(``MotionEstimator(mesh=...)``: ViTPose, HMR2 and the render split over the
ranks; ``build_decomp_models(mesh=...)``'s flip-test heatmaps) on gloo CPU
worlds of 2 and 4 ranks, on a ragged n + 1 frames.

- tests/test_decomp_sharding.py's estimator (tiny ViTPose and HMR2, the
  64-vertex test model) against the JAX package's frame-parallel
  estimator on the 8-device mesh, within one uint8 level, and against the
  port's single process, equal;
- the same with random-topology faces on the test model (the sdc is not
  empty there), against the port's single process, equal;
- the factory's batched pose stage (tests/test_torch_motion.py's 5 frames
  in batches of 2) built with the mesh, within 1e-5 of the port's single
  process and of the JAX package's.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from mimo_tpu.decomp import hmr as JHM
from mimo_tpu.decomp import smpl as JSM
from mimo_tpu.decomp import vitpose as JVP
from mimo_tpu.decomp.motion import MotionEstimator as JMotionEstimator
from mimo_tpu.parallel.mesh import get_mesh as jax_get_mesh
from mimo_tpu_torch.decomp import factory as FA
from mimo_tpu_torch.decomp.motion import MotionEstimator
from mimo_tpu_torch.entry import graft
from tests.test_torch_helpers import bridge_params, set_fp32_matmuls
from tests.test_torch_motion import _port_vp_cfg
from tests.test_torch_motion_core import _port_hmr_cfg, _port_model

set_fp32_matmuls()

WORLDS = (2, 4)
H, W = 32, 24


def _jax_kw(faces=None):
    """tests/test_decomp_sharding.py's estimator arguments."""
    hcfg, vcfg = JHM.tiny_hmr_config(), JVP.tiny_vitpose_config()
    smpl = JSM.random_test_model(jax.random.PRNGKey(2))
    if faces is not None:
        smpl = dataclasses.replace(smpl, faces=faces)
    return dict(vitpose_params=JVP.vitpose_init(jax.random.PRNGKey(1), vcfg),
                vitpose_cfg=vcfg,
                hmr_params=JHM.hmr_init(jax.random.PRNGKey(0), hcfg),
                hmr_cfg=hcfg, smpl_model=smpl, focal=50.0)


def _port_models(kw):
    return {"vitpose": (bridge_params(kw["vitpose_params"], kind="vitpose"),
                        _port_vp_cfg(kw["vitpose_cfg"])),
            "hmr": (bridge_params(kw["hmr_params"]),
                    _port_hmr_cfg(kw["hmr_cfg"])),
            "smpl": _port_model(kw["smpl_model"]), "focal": kw["focal"]}


def _clip(t):
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 255, (H, W, 3)).astype(np.uint8)
              for _ in range(t)]
    masks = np.zeros((t, H, W), bool)
    masks[:, 4:28, 4:20] = True
    boxes = np.asarray([[4, 4, 20, 28]] * t, np.int64)
    return frames, masks, boxes


def _pose_clip():
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 255, (96, 72, 3)).astype(np.uint8)
              for _ in range(5)]
    boxes = np.asarray([[8 + t, 10, 8 + t + 40, 10 + 70] for t in range(5)],
                       np.int64)
    return frames, boxes


FACES = np.random.default_rng(9).integers(0, 64, (48, 3))


@pytest.fixture(scope="module")
def worlds():
    """Each world's (plain model, faced model, pose batch) results by rank."""
    out = {}
    for n in WORLDS:
        clip = _clip(n + 1)
        jobs = [(graft.motion_body, (_port_models(_jax_kw(faces)),
                                     [dict(op="motion", clip=clip)]))
                for faces in (None, FACES)]
        jobs.append((graft.motion_body, (
            _port_models(_jax_kw()),
            [dict(op="pose_batch", clip=_pose_clip())])))
        out[n] = graft.spawn(graft.bodies, n, backend="gloo", device="cpu",
                             args=(jobs,))
    return out


def _single(kw, clip):
    m = _port_models(kw)
    return MotionEstimator(vitpose_params=m["vitpose"][0],
                           vitpose_cfg=m["vitpose"][1],
                           hmr_params=m["hmr"][0], hmr_cfg=m["hmr"][1],
                           smpl_model=m["smpl"],
                           focal=m["focal"]).estimate_motion(*clip)


@pytest.mark.parametrize("n", WORLDS)
def test_motion_stage_matches_jax_mesh_and_single(worlds, n):
    clip = _clip(n + 1)
    want = JMotionEstimator(mesh=jax_get_mesh(8), **_jax_kw()).estimate_motion(
        *clip)
    single = _single(_jax_kw(), clip)
    for rank in worlds[n]:
        got = rank[0][0]
        assert got.shape == want.shape == (n + 1, H, W, 3)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, single)
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("n", WORLDS)
def test_motion_stage_with_faces_matches_single(worlds, n):
    clip = _clip(n + 1)
    single = _single(_jax_kw(FACES), clip)
    assert single.any()
    for rank in worlds[n]:
        np.testing.assert_array_equal(rank[1][0], single)


@pytest.mark.parametrize("n", WORLDS)
def test_factory_pose_batch_with_mesh(worlds, n, tmp_path_factory):
    from mimo_tpu.decomp import factory as JF
    from mimo_tpu.weights.convert import save_npz
    d = tmp_path_factory.mktemp("w")
    kw = _jax_kw()
    save_npz(jax.tree.map(np.asarray, kw["vitpose_params"]),
             str(d / "vitpose.npz"))
    frames, boxes = _pose_clip()
    want = JF.build_decomp_models(str(d), dtype=jnp.float32,
                                  tiny=True).estimate_pose_batch(
        frames, boxes, batch=2)
    single = FA.build_decomp_models(
        params={"vitpose": _port_models(kw)["vitpose"][0]}, tiny=True,
        device="cpu").estimate_pose_batch(frames, boxes, batch=2)
    for rank in worlds[n]:
        got = rank[2][0]
        assert got.shape == want.shape == (5, 7, 3)
        np.testing.assert_allclose(got, single, atol=1e-5)
        np.testing.assert_allclose(got, want, atol=1e-5)


def test_mesh_needs_an_initialised_world():
    """A mesh is built from the joined process group, not from a count."""
    from mimo_tpu_torch.parallel.mesh import ProcessMesh
    with pytest.raises(RuntimeError, match="parallel.init"):
        ProcessMesh((2,), ("data",), "cpu")
