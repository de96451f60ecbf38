"""The motion stage's math in the port (mimo_tpu_torch/decomp/{transforms,
smpl,hmr}.py) against mimo_tpu/decomp/{transforms,smpl,hmr}.py on the same
numpy-seeded inputs, fp32 on the CPU: the rotation conversions (angles near
pi included, where the quaternion's pivot leaves w), SMPL-H skinning on a
random chain model and on the port's surface SMPL-H, the chumpy unpickler
shim, HMR2's forward in both token-input modes with two IEF iterations
(JAX-initialised tiny params through the weights bridge) and the crop
camera lift.

Tolerances: rotations, axis-angles and vertices 1e-5 (fp32, summation
order differs); the HMR outputs 1e-4 (a two-block ViT and a two-layer head
deep).
"""

import dataclasses
import pickle
import sys
import types

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from mimo_tpu.decomp import hmr as JHM
from mimo_tpu.decomp import smpl as JSM
from mimo_tpu.decomp import transforms as JT
from mimo_tpu_torch.decomp import hmr as HM
from mimo_tpu_torch.decomp import smpl as SM
from mimo_tpu_torch.decomp import transforms as T
from mimo_tpu_torch.decomp import vit as V
from tests.test_torch_helpers import bridge_params, nn, set_fp32_matmuls, tt

set_fp32_matmuls()


def _axis_angles(seed, n, lo=0.0, hi=np.pi):
    """n axis-angles with random axes and angles uniform in [lo, hi]."""
    rng = np.random.default_rng(seed)
    axis = rng.standard_normal((n, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    return (axis * rng.uniform(lo, hi, (n, 1))).astype(np.float32)


ANGLE_SETS = {
    "general": lambda: _axis_angles(0, 64),
    "near pi": lambda: np.concatenate([
        _axis_angles(1, 32, np.pi - 1e-2, np.pi - 1e-4),
        _axis_angles(2, 8, np.pi, np.pi)]),
    "small": lambda: np.concatenate([_axis_angles(3, 16, 0, 1e-3),
                                     np.zeros((2, 3), np.float32)]),
}


@pytest.mark.parametrize("angles", list(ANGLE_SETS))
def test_rotation_conversions_match_jax(angles):
    aa = ANGLE_SETS[angles]()
    R_j = JT.aa_to_rotmat(jnp.asarray(aa))
    R_t = T.aa_to_rotmat(tt(aa))
    np.testing.assert_allclose(nn(R_t), nn(R_j), atol=1e-5)
    R = np.asarray(R_j)                    # both sides on the same matrices
    np.testing.assert_allclose(nn(T.rotmat_to_quat(tt(R))),
                               nn(JT.rotmat_to_quat(jnp.asarray(R))),
                               atol=1e-5)
    back_j = JT.rotmat_to_aa(jnp.asarray(R))
    back_t = T.rotmat_to_aa(tt(R))
    np.testing.assert_allclose(nn(back_t), nn(back_j), atol=1e-5)
    # and the same rotation (at pi, axis * pi and -axis * pi both are)
    np.testing.assert_allclose(nn(T.aa_to_rotmat(back_t)), R, atol=1e-5)


def test_rot6d_matches_jax():
    x = np.random.default_rng(4).standard_normal((2, 7, 6)).astype(
        np.float32)
    np.testing.assert_allclose(nn(T.rot6d_to_rotmat(tt(x))),
                               nn(JT.rot6d_to_rotmat(jnp.asarray(x))),
                               atol=1e-5)


def _port_model(m):
    return SM.SMPLModel(
        *(tt(getattr(m, f)) for f in ("v_template", "shapedirs", "posedirs",
                                      "J_regressor", "lbs_weights")),
        parents=np.asarray(m.parents), faces=np.asarray(m.faces))


def _lbs_pair(jm, pm, seed, batch, scale):
    rng = np.random.default_rng(seed)
    betas = rng.standard_normal((batch, jm.shapedirs.shape[-1])).astype(
        np.float32)
    pose = (rng.standard_normal((batch, jm.num_joints, 3)) * scale).astype(
        np.float32)
    pose[0, 1] = _axis_angles(seed, 1, np.pi - 1e-3, np.pi - 1e-3)[0]
    transl = rng.standard_normal((batch, 3)).astype(np.float32)
    vj, jj = JSM.lbs(jm, jnp.asarray(betas), jnp.asarray(pose),
                     jnp.asarray(transl))
    vt, jt = SM.lbs(pm, tt(betas), tt(pose), tt(transl))
    np.testing.assert_allclose(nn(vt), nn(vj), atol=1e-5)
    np.testing.assert_allclose(nn(jt), nn(jj), atol=1e-5)


def test_lbs_matches_jax_random_model():
    jm = JSM.random_test_model(jax.random.PRNGKey(0), n_joints=7)
    _lbs_pair(jm, _port_model(jm), 5, 3, 0.5)


def test_random_test_model_rest_pose_is_the_template():
    """The port's random_test_model has the JAX one's shapes and tree, and
    zero pose and betas give its template (tests/test_decomp_core.py's
    rest-pose case)."""
    pm = SM.random_test_model(torch.Generator().manual_seed(0))
    jm = JSM.random_test_model(jax.random.PRNGKey(0))
    for f in ("v_template", "shapedirs", "posedirs", "J_regressor",
              "lbs_weights"):
        assert tuple(getattr(pm, f).shape) == getattr(jm, f).shape
    np.testing.assert_array_equal(pm.parents, jm.parents)
    verts, _ = SM.lbs(pm, torch.zeros((2, 4)),
                      torch.zeros((2, pm.num_joints, 3)))
    np.testing.assert_allclose(nn(verts), np.broadcast_to(
        nn(pm.v_template), (2,) + tuple(pm.v_template.shape)), atol=1e-5)


def test_lbs_matches_jax_surface_smplh():
    """The port's synthetic SMPL-H (52 joints, SMPL-H's tree, 6890
    vertices) through both packages' from_arrays and lbs."""
    data = SM.surface_arrays(0)
    jm, pm = JSM.from_arrays(data), SM.from_arrays(data)
    assert pm.num_verts == 6890 and pm.faces.shape == (13776, 3)
    np.testing.assert_array_equal(pm.parents, jm.parents)
    np.testing.assert_allclose(nn(pm.posedirs), nn(jm.posedirs), atol=0)
    _lbs_pair(jm, pm, 6, 2, 0.3)


def test_surface_smplh_is_a_closed_surface():
    """Every edge of the synthetic SMPL-H joins exactly two faces, and the
    faces are small: the longest edge is a few centimetres."""
    m = SM.surface_smplh(0)
    f = m.faces
    edges = np.sort(np.concatenate([f[:, [0, 1]], f[:, [1, 2]],
                                    f[:, [2, 0]]]), axis=1)
    _, counts = np.unique(edges, axis=0, return_counts=True)
    assert set(counts) == {2}
    assert m.num_verts - len(counts) + len(f) == 2      # Euler: a sphere
    v = m.v_template.numpy()
    lengths = np.linalg.norm(v[edges[:, 0]] - v[edges[:, 1]], axis=-1)
    assert lengths.max() < 0.1
    assert np.ptp(v[:, 1]) > 1.6


def test_chumpy_pickle_reads_as_jax(tmp_path, monkeypatch):
    """A pickle holding chumpy objects (a stand-in chumpy module at dump
    time, absent at load time) and a sparse regressor reads the same in
    both packages."""
    import scipy.sparse as sp

    mod = types.ModuleType("chumpy.ch")

    class Ch:
        def __init__(self, x):
            self.x = x

        def __reduce__(self):
            return (Ch, (), {"x": self.x})

    Ch.__module__, Ch.__qualname__ = "chumpy.ch", "Ch"
    mod.Ch = Ch
    monkeypatch.setitem(sys.modules, "chumpy", types.ModuleType("chumpy"))
    monkeypatch.setitem(sys.modules, "chumpy.ch", mod)
    rng = np.random.default_rng(0)
    data = {
        "v_template": Ch(rng.standard_normal((8, 3))),
        "shapedirs": Ch(rng.standard_normal((8, 3, 4))),
        "posedirs": rng.standard_normal((8, 3, 9)),
        "J_regressor": sp.csc_matrix(np.abs(rng.standard_normal((2, 8)))),
        "weights": Ch(np.abs(rng.standard_normal((8, 2)))),
        "kintree_table": np.array([[4294967295, 0], [0, 1]], np.uint32),
        "f": np.arange(9, dtype=np.uint32).reshape(3, 3) % 8,
    }
    path = tmp_path / "model.pkl"
    with open(path, "wb") as f:
        pickle.dump(data, f)
    monkeypatch.delitem(sys.modules, "chumpy.ch")
    monkeypatch.delitem(sys.modules, "chumpy")
    pm, jm = SM.load_smpl_pickle(str(path)), JSM.load_smpl_pickle(str(path))
    for f in ("v_template", "shapedirs", "posedirs", "J_regressor",
              "lbs_weights"):
        np.testing.assert_array_equal(nn(getattr(pm, f)),
                                      nn(getattr(jm, f)))
    np.testing.assert_array_equal(pm.parents, jm.parents)
    np.testing.assert_array_equal(pm.faces, jm.faces)
    assert pm.parents[0] == -1 and pm.num_joints == 2


def _port_hmr_cfg(cfg):
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(cfg) if f.name != "backbone"}
    return HM.HMRConfig(backbone=V.ViTConfig(**cfg.backbone.__dict__),
                        **fields)


@pytest.mark.parametrize("mode", ["zero", "mean_shape"])
def test_hmr_forward_matches_jax(mode):
    cfg = dataclasses.replace(JHM.tiny_hmr_config(num_joints=6),
                              transformer_input=mode, ief_iters=2)
    p = JHM.hmr_init(jax.random.PRNGKey(3), cfg)
    # IEF anchors away from the identity, as a converted bundle has them
    rng = np.random.default_rng(7)
    p["mean_pose"] = p["mean_pose"] + jnp.asarray(
        rng.standard_normal(p["mean_pose"].shape).astype(np.float32) * 0.3)
    p["mean_betas"] = jnp.asarray(rng.standard_normal(4).astype(np.float32))
    crops = rng.standard_normal((3, 32, 32, 3)).astype(np.float32)
    want = JHM.hmr_forward(p, cfg, jnp.asarray(crops))
    got = HM.hmr_forward(bridge_params(p), _port_hmr_cfg(cfg), tt(crops))
    assert got["pose_rotmats"].shape == (3, 6, 3, 3)
    for k in ("pose_rotmats", "betas", "cam"):
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(nn(got[k]), nn(want[k]), atol=1e-4,
                                   rtol=1e-4)


def test_hmr_init_shapes_match_jax():
    """The port's init draws the JAX tree's shapes (full HaMeR head, a
    two-block backbone)."""
    cfg = dataclasses.replace(
        JHM.hamer_config(), backbone=dataclasses.replace(
            JHM.hamer_config().backbone, depth=2))
    want = jax.eval_shape(lambda: JHM.hmr_init(jax.random.PRNGKey(0), cfg))
    got = HM.hmr_init(torch.Generator().manual_seed(0), _port_hmr_cfg(cfg))
    flat_j = {jax.tree_util.keystr(k): tuple(v.shape)
              for k, v in jax.tree_util.tree_leaves_with_path(want)}
    flat_t = {jax.tree_util.keystr(k): tuple(v.shape)
              for k, v in jax.tree_util.tree_leaves_with_path(got)}
    # conv kernels: HWIO in JAX, OIHW in the port
    pe = flat_j.pop("['backbone']['patch_embed']['kernel']")
    assert flat_t.pop("['backbone']['patch_embed']['kernel']") == (
        pe[3], pe[2], pe[0], pe[1])
    assert flat_t == flat_j


def test_cam_crop_to_full_matches_jax():
    rng = np.random.default_rng(8)
    cam = np.concatenate([rng.uniform(0.5, 1.5, (5, 1)),
                          rng.standard_normal((5, 2))], 1).astype(np.float32)
    cs = np.concatenate([rng.uniform(100, 600, (5, 2)),
                         rng.uniform(50, 400, (5, 1))], 1).astype(np.float32)
    want = JHM.cam_crop_to_full(cam, cs, 480.0, 720.0, 5000.0)
    got = HM.cam_crop_to_full(tt(cam), tt(cs), 480.0, 720.0, 5000.0)
    np.testing.assert_allclose(nn(got), want, rtol=1e-6)
