"""SMPL / SMPL-H body model: linear blend skinning in PyTorch.

Counterpart of ``mimo_tpu/decomp/smpl.py``: ``SMPLModel``, ``lbs``, the
unpickler shim that reads the published chumpy pickles without chumpy
(scipy only, for their sparse regressors), ``load_smpl_pickle``,
``load_smpl_npz``, ``from_arrays`` and ``random_test_model``.

  v_shaped = v_template + shapedirs @ betas
  joints   = J_regressor @ v_shaped
  v_posed  = v_shaped + posedirs @ vec(R[1:] - I)
  world transforms accumulate down the kinematic tree; skinning applies
  W . A to homogeneous vertices.

No SMPL-H artifact is in the repository. ``surface_smplh`` is a synthetic
model at SMPL-H's counts (6890 vertices, 13776 faces, 52 joints, 16
betas) whose faces join neighbouring vertices of one closed, body-sized
surface, so a frame's faces cover a few pixels each as a real mesh's do
(``tools/gen_decomp_weights.py::gen_smpl`` joins random vertex triples).
"""

from __future__ import annotations

import pickle
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch

from mimo_tpu_torch.decomp.transforms import aa_to_rotmat


@dataclass(frozen=True)
class SMPLModel:
    """Model constants (from the published SMPL / SMPL-H artifacts)."""

    v_template: torch.Tensor   # (V, 3)
    shapedirs: torch.Tensor    # (V, 3, n_betas)
    posedirs: torch.Tensor     # (P, V*3), P = 9*(J-1)
    J_regressor: torch.Tensor  # (J, V)
    lbs_weights: torch.Tensor  # (V, J)
    parents: np.ndarray        # (J,) int, parents[0] == -1
    faces: np.ndarray          # (F, 3) int

    @property
    def num_joints(self) -> int:
        return self.J_regressor.shape[0]

    @property
    def num_verts(self) -> int:
        return self.v_template.shape[0]

    @property
    def num_betas(self) -> int:
        return self.shapedirs.shape[-1]

    def to(self, device) -> "SMPLModel":
        return SMPLModel(*(getattr(self, f).to(device) for f in (
            "v_template", "shapedirs", "posedirs", "J_regressor",
            "lbs_weights")), parents=self.parents, faces=self.faces)


def lbs(model: SMPLModel, betas: torch.Tensor, pose_aa: torch.Tensor,
        transl: Optional[torch.Tensor] = None):
    """Forward the body model.

    betas: (B, n_betas); pose_aa: (B, J, 3) axis-angle, the global
    orientation at index 0; transl: (B, 3) or None. Returns (verts (B, V,
    3), joints (B, J, 3)) in the model's dtype."""
    B = betas.shape[0]
    J = model.num_joints

    v_shaped = model.v_template[None] + torch.einsum(
        "vcs,bs->bvc", model.shapedirs, betas)
    joints = torch.einsum("jv,bvc->bjc", model.J_regressor, v_shaped)

    R = aa_to_rotmat(pose_aa)                               # (B, J, 3, 3)
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    pose_feature = (R[:, 1:] - eye).reshape(B, -1)          # (B, 9(J-1))
    v_posed = v_shaped + torch.einsum(
        "pn,bp->bn", model.posedirs, pose_feature).reshape(B, -1, 3)

    parents = model.parents
    rel_j = joints.clone()
    rel_j[:, 1:] = joints[:, 1:] - joints[:, parents[1:]]

    local = torch.zeros((B, J, 4, 4), dtype=R.dtype, device=R.device)
    local[..., :3, :3] = R
    local[..., :3, 3] = rel_j
    local[..., 3, 3] = 1.0
    world = [local[:, 0]]
    for j in range(1, J):
        world.append(world[parents[j]] @ local[:, j])
    A = torch.stack(world, dim=1)                           # (B, J, 4, 4)
    posed_joints = A[..., :3, 3]

    # remove the rest-pose joint locations from the transforms
    joints_h = torch.cat([joints, joints.new_zeros((B, J, 1))], dim=-1)
    corr = torch.einsum("bjxy,bjy->bjx", A, joints_h)
    A = A.clone()
    A[..., :3, 3] -= corr[..., :3]

    T = torch.einsum("vj,bjxy->bvxy", model.lbs_weights, A)  # (B, V, 4, 4)
    v_h = torch.cat([v_posed, v_posed.new_ones((B, v_posed.shape[1], 1))],
                    dim=-1)
    verts = torch.einsum("bvxy,bvy->bvx", T, v_h)[..., :3]

    if transl is not None:
        verts = verts + transl[:, None]
        posed_joints = posed_joints + transl[:, None]
    return verts, posed_joints


# ---------------------------------------------------------------------------
# artifact loading (no chumpy)
# ---------------------------------------------------------------------------


class _ChumpyShim:
    """Stands in for chumpy.Ch during unpickling; keeps only the array."""

    def __init__(self, *args, **kwargs):
        self._data = None

    def __setstate__(self, state):
        if isinstance(state, dict):
            for key in ("x", "_data", "a"):
                if key in state:
                    self._data = np.asarray(state[key])
                    break

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self._data, dtype=dtype)


class _SMPLUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.startswith("chumpy"):
            return _ChumpyShim
        if module.startswith("scipy.sparse"):
            import scipy.sparse
            return getattr(scipy.sparse, name, scipy.sparse.csc_matrix)
        return super().find_class(module, name)


def _dense(x) -> np.ndarray:
    if hasattr(x, "todense"):
        return np.asarray(x.todense())
    return np.asarray(x)


def load_smpl_pickle(path: str, dtype=torch.float32,
                     device=None) -> SMPLModel:
    """A published SMPL / SMPL-H .pkl (legacy chumpy pickles included)."""
    with open(path, "rb") as f:
        data = _SMPLUnpickler(f, encoding="latin1").load()
    return from_arrays(data, dtype, device)


def load_smpl_npz(path: str, dtype=torch.float32, device=None) -> SMPLModel:
    with np.load(path, allow_pickle=True) as f:
        return from_arrays({k: f[k] for k in f.files}, dtype, device)


def from_arrays(data: Dict[str, Any], dtype=torch.float32,
                device=None) -> SMPLModel:
    """The published arrays (v_template, shapedirs, posedirs as (V, 3, P)
    or (P, V*3), J_regressor, weights, kintree_table, f) -> SMPLModel."""
    def t(x):
        return torch.as_tensor(np.asarray(_dense(x), np.float64),
                               dtype=dtype, device=device)

    posedirs = _dense(data["posedirs"])
    if posedirs.ndim == 3:  # (V, 3, P) -> (P, V*3)
        posedirs = posedirs.reshape(-1, posedirs.shape[-1]).T
    parents = np.asarray(_dense(data["kintree_table"]))[0].astype(np.int64)
    parents[0] = -1
    return SMPLModel(
        v_template=t(data["v_template"]), shapedirs=t(data["shapedirs"]),
        posedirs=t(posedirs), J_regressor=t(data["J_regressor"]),
        lbs_weights=t(data["weights"]), parents=parents,
        faces=np.asarray(_dense(data["f"]), np.int64))


def random_test_model(gen: torch.Generator, n_verts: int = 64,
                      n_joints: int = 5, n_betas: int = 4) -> SMPLModel:
    """Small synthetic model for tests (a chain of joints, one face)."""
    def normal(*shape):
        return torch.randn(shape, generator=gen, device=gen.device)

    parents = np.array([-1] + [max(0, j - 1) for j in range(1, n_joints)])
    return SMPLModel(
        v_template=normal(n_verts, 3) * 0.3,
        shapedirs=normal(n_verts, 3, n_betas) * 0.01,
        posedirs=normal(9 * (n_joints - 1), n_verts * 3) * 0.01,
        J_regressor=torch.softmax(normal(n_joints, n_verts), -1),
        lbs_weights=torch.softmax(normal(n_verts, n_joints), -1),
        parents=parents, faces=np.zeros((1, 3), np.int64))


def _smplh_parents() -> np.ndarray:
    """SMPL-H's kinematic tree: SMPL's first 22 joints, then each hand's
    five fingers of three joints from the left (20) and right (21)
    wrists."""
    body = [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16,
            17, 18, 19]
    hands = []
    for wrist in (20, 21):
        for _ in range(5):
            j = len(body) + len(hands)
            hands += [wrist, j, j + 1]
    return np.asarray(body + hands, np.int64)


SMPLH_PARENTS = _smplh_parents()


def surface_arrays(seed: int = 0, rings: int = 82, segments: int = 84,
                   n_joints: int = 52, n_betas: int = 16
                   ) -> Dict[str, np.ndarray]:
    """The published arrays of a synthetic SMPL-H with a surface topology:
    a closed latitude-longitude mesh of ``rings`` x ``segments`` vertices
    and two poles (82 x 84 + 2 = 6890 vertices, 2 x 82 x 84 = 13776
    triangles: SMPL-H's counts, which a closed genus-0 mesh with V = 6890
    has, F = 2V - 4), each triangle joining neighbours. The vertices lie on
    a seeded ellipsoid (girth perturbed) 1.7 m tall, 0.5 m wide, 0.3 m
    deep. Blend shapes, joint regressor and skinning weights are seeded
    random, as ``gen_smpl`` draws them; the joints follow SMPL-H's tree."""
    rng = np.random.default_rng(seed)
    n_verts = rings * segments + 2
    theta = np.pi * (np.arange(rings) + 1) / (rings + 1)        # polar
    phi = 2 * np.pi * np.arange(segments) / segments
    st, ct = np.sin(theta)[:, None], np.cos(theta)[:, None]
    ring = np.stack([0.25 * st * np.cos(phi),
                     np.broadcast_to(-0.85 * ct, (rings, segments)),
                     0.15 * st * np.sin(phi)], -1).reshape(-1, 3)
    # girth perturbed by 2% a vertex (height kept: the poles stay smooth)
    ring[:, [0, 2]] *= 1.0 + 0.02 * rng.standard_normal((rings * segments,
                                                          1))
    v = np.concatenate([[[0.0, -0.85, 0.0]], ring, [[0.0, 0.85, 0.0]]])

    def vid(r, s):
        return 1 + r * segments + s % segments

    faces = []
    for s in range(segments):
        faces.append((0, vid(0, s + 1), vid(0, s)))
        faces.append((n_verts - 1, vid(rings - 1, s),
                      vid(rings - 1, s + 1)))
        for r in range(rings - 1):
            a, b = vid(r, s), vid(r, s + 1)
            c, d = vid(r + 1, s), vid(r + 1, s + 1)
            faces += [(a, b, d), (a, d, c)]
    kin = np.zeros((2, n_joints), np.int64)
    kin[0] = np.maximum(SMPLH_PARENTS[:n_joints], 0)
    kin[1] = np.arange(n_joints)
    weights = np.abs(rng.standard_normal((n_verts, n_joints)))
    return {
        "v_template": v,
        "shapedirs": rng.standard_normal((n_verts, 3, n_betas)) * 0.01,
        "posedirs": rng.standard_normal((n_verts, 3, 9 * (n_joints - 1)))
        * 0.001,
        "J_regressor": np.abs(rng.standard_normal((n_joints, n_verts)))
        / n_verts,
        "weights": weights / weights.sum(-1, keepdims=True),
        "kintree_table": kin,
        "f": np.asarray(faces, np.int64),
    }


def surface_smplh(seed: int = 0, dtype=torch.float32,
                  device=None) -> SMPLModel:
    """``surface_arrays`` as an SMPLModel."""
    return from_arrays(surface_arrays(seed), dtype, device)
