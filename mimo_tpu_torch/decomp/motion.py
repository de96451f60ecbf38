"""Motion stage: 2D pose -> 3D body (HMR2) + hands (HaMeR) -> SMPL-H pose
fusion -> the rendered "sdc" video that drives the synthesis half.

Counterpart of ``mimo_tpu/decomp/motion.py``: ViTPose wholebody keypoints
give the hand boxes; HMR2 regresses the body from the person crops, HaMeR
the hands from hand crops (rescale 2, the left hand mirrored in and out);
each hand's global orientation is re-expressed in its elbow's frame along
the kinematic chain; SMPL-H (``smpl.lbs``) poses the body and the z-buffer
renderer (``renderer.render_frames``) draws its vertex colours. The crops
of all frames go through each model in one batch; the hands of the clip
ride identity-filled (T, 16, 3, 3) arrays with presence flags, so one
fuse and one ``lbs`` cover the clip. The rotations, the fuse, ``lbs`` and
the render run in fp32 on the models' device; the crops are cut on the
host (``vitpose.square_crop``).

The sdc colours are the reference's ``sdc_info.npy`` when given, else the
template's vertex coordinates normalised to [0, 1] (colour still names
the body-surface point).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from mimo_tpu_torch.decomp import hmr as HM
from mimo_tpu_torch.decomp import renderer as REND
from mimo_tpu_torch.decomp import smpl as SM
from mimo_tpu_torch.decomp import vitpose as VP
from mimo_tpu_torch.decomp.transforms import rotmat_to_aa


def wrist_local_rotation(body_rotmats: torch.Tensor,
                         hand_global: torch.Tensor,
                         chain: Sequence[int]) -> torch.Tensor:
    """The wrist's local rotation (..., 3, 3) that, composed after the
    chain's local rotations (``body_rotmats`` (..., J, 3, 3), root to the
    wrist's parent), reproduces the hand's global orientation (..., 3,
    3)."""
    G = torch.eye(3, dtype=body_rotmats.dtype, device=body_rotmats.device)
    for j in chain:
        G = G @ body_rotmats[..., j, :, :]
    return G.transpose(-1, -2) @ hand_global


def mirror_rotmat_x(R: torch.Tensor) -> torch.Tensor:
    """A rotation (..., 3, 3) mirrored across the x-plane: M R M with M =
    diag(1, -1, -1) (axis-angle (x, -y, -z))."""
    M = torch.diag(torch.tensor([1.0, -1.0, -1.0], dtype=R.dtype,
                                device=R.device))
    return M @ R @ M


# SMPL-H joints: 0 global, 1..21 body, 22..36 left hand, 37..51 right
SMPLH_LEFT_ELBOW_CHAIN = (0, 3, 6, 9, 13, 16, 18)   # spine, collar, shoulder,
SMPLH_RIGHT_ELBOW_CHAIN = (0, 3, 6, 9, 14, 17, 19)  # elbow
SMPLH_LEFT_WRIST = 20
SMPLH_RIGHT_WRIST = 21


def fuse_pose_batch(J: int, body_rotmats: torch.Tensor, lrot: torch.Tensor,
                    lval: torch.Tensor, rrot: torch.Tensor,
                    rval: torch.Tensor) -> torch.Tensor:
    """The clip's (T, J, 3) axis-angle pose from the body's (T, Jb, 3, 3)
    local rotations and the hands' (T, 16, 3, 3) (identity where absent,
    ``lval`` / ``rval`` (T,) > 0 where present): the body's first
    min(Jb, J) joints; for SMPL-H (J >= 52) each present hand's wrist in its
    elbow's frame and its 15 finger joints."""
    T = body_rotmats.shape[0]
    body_aa = rotmat_to_aa(body_rotmats)
    n_body = min(body_aa.shape[1], J)
    pose = body_aa.new_zeros((T, J, 3))
    pose[:, :n_body] = body_aa[:, :n_body]
    if J >= 52:
        for hr, val, wrist, chain, base in (
            (lrot, lval, SMPLH_LEFT_WRIST, SMPLH_LEFT_ELBOW_CHAIN, 22),
            (rrot, rval, SMPLH_RIGHT_WRIST, SMPLH_RIGHT_ELBOW_CHAIN, 37),
        ):
            n_fingers = min(15, hr.shape[1] - 1)
            with_hand = pose.clone()
            with_hand[:, wrist] = rotmat_to_aa(
                wrist_local_rotation(body_rotmats, hr[:, 0], chain))
            with_hand[:, base:base + n_fingers] = rotmat_to_aa(
                hr[:, 1:1 + n_fingers])
            pose = torch.where(val[:, None, None] > 0, with_hand, pose)
    return pose


def pack_hands(hands, n_joints: int, device):
    """Per-frame {left, right: (n, 3, 3) or None} -> (lrot, lval, rrot,
    rval): (T, n, 3, 3) identity-filled rotations and (T,) 0/1 flags."""
    eye = torch.eye(3, device=device).expand(n_joints, 3, 3)
    out = []
    for side in ("left", "right"):
        out.append(torch.stack([h[side] if h[side] is not None else eye
                                for h in hands]).float())
        out.append(torch.tensor([h[side] is not None for h in hands],
                                dtype=torch.float32, device=device))
    return tuple(out)


@dataclass
class MotionEstimator:
    """The pose, body and hand models, SMPL-H and the renderer behind the
    ``estimate_motion`` callable of the decomposition pipeline. The
    models run on their parameters' device and dtype."""

    vitpose_params: Any
    vitpose_cfg: VP.ViTPoseConfig
    hmr_params: Any
    hmr_cfg: HM.HMRConfig
    smpl_model: SM.SMPLModel
    sdc_colors: Optional[np.ndarray] = None          # (V, 3) in [0, 1]
    hamer_params: Any = None
    hamer_cfg: Optional[HM.HMRConfig] = None
    focal: float = 5000.0
    mesh: Any = None

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(
                "MotionEstimator: frame-parallel forwards over a device mesh "
                "are not ported yet (ROADMAP.md, Queue 1 item 3)")
        leaf = self.hmr_params["dec_cam"]["kernel"]
        self.device, self.dtype = leaf.device, leaf.dtype
        self.smpl_model = self.smpl_model.to(self.device)
        if self.sdc_colors is None:
            v = self.smpl_model.v_template.cpu().numpy()
            v = (v - v.min(0)) / (v.max(0) - v.min(0) + 1e-9)
            self.sdc_colors = v.astype(np.float32)
        self._colors = torch.as_tensor(self.sdc_colors, dtype=torch.float32,
                                       device=self.device)
        self._faces = torch.as_tensor(self.smpl_model.faces,
                                      device=self.device)
        self.hand_crops = 0             # HaMeR crops of the last clip
        self.render_stats: Dict[str, int] = {}

    def _upload(self, crops):
        return torch.from_numpy(np.stack(crops)).to(self.device, self.dtype)

    # ------------------------------------------------------------------

    def body_params(self, frames: Sequence[np.ndarray], bboxes: np.ndarray):
        """HMR2 over every frame's person crop, one batch. Returns its
        outputs and the crops' (cx, cy, size) (T, 3)."""
        size = self.hmr_cfg.backbone.img_size
        crops, css = [], []
        for f, bb in zip(frames, bboxes):
            c, cs = VP.square_crop(f, bb, out_size=size)
            crops.append(c)
            css.append(cs)
        out = HM.hmr_forward(self.hmr_params, self.hmr_cfg,
                             self._upload(crops))
        return out, np.stack(css)

    def hand_params(self, frames, kpts_per_frame):
        """HaMeR on the hand crops the wholebody keypoints give, one batch;
        per frame {left, right: (16, 3, 3) fp32 rotations or None}, the
        left hand mirrored into the model and back."""
        results = [dict(left=None, right=None) for _ in frames]
        self.hand_crops = 0
        if self.hamer_params is None:
            return results
        size = self.hamer_cfg.backbone.img_size
        entries, crops = [], []
        for t, (f, kpts) in enumerate(zip(frames, kpts_per_frame)):
            left, right = VP.hand_boxes_from_keypoints(kpts)
            for side, bb in (("left", left), ("right", right)):
                if bb is None:
                    continue
                c, _ = VP.square_crop(f, bb, out_size=size, rescale=2.0)
                if side == "left":
                    c = np.ascontiguousarray(c[:, ::-1])
                entries.append((t, side))
                crops.append(c)
        self.hand_crops = len(crops)
        if not crops:
            return results
        rotm = HM.hmr_forward(self.hamer_params, self.hamer_cfg,
                              self._upload(crops))["pose_rotmats"]
        for (t, side), R in zip(entries, rotm):
            results[t][side] = mirror_rotmat_x(R) if side == "left" else R
        return results

    def fuse_pose(self, body_rotmats: torch.Tensor,
                  hands: Dict[str, Optional[torch.Tensor]]) -> torch.Tensor:
        """One frame's (J, 3) axis-angle pose: ``fuse_pose_batch`` over a
        clip of one frame."""
        dev = body_rotmats.device
        hands = {side: None if hands.get(side) is None
                 else torch.as_tensor(hands[side], device=dev)
                 for side in ("left", "right")}
        n_hand = next((h.shape[0] for h in hands.values() if h is not None),
                      16)
        return fuse_pose_batch(self.smpl_model.num_joints, body_rotmats[None],
                               *pack_hands([hands], n_hand, dev))[0]

    # ------------------------------------------------------------------

    def keypoints(self, frames, bboxes) -> np.ndarray:
        """Wholebody keypoints (T, K, 3) of the person crops (no flip
        test), zeros (T, 133, 3) without a pose model."""
        if self.vitpose_params is None:
            return np.zeros((len(frames), 133, 3))
        size = self.vitpose_cfg.backbone.img_size
        crops, boxes_xywh = [], []
        for f, bb in zip(frames, bboxes):
            c, cs = VP.square_crop(f, bb, out_size=size)
            crops.append(c)
            half = cs[2] / 2
            boxes_xywh.append([cs[0] - half, cs[1] - half, cs[2], cs[2]])
        hm = VP.heatmaps(self.vitpose_params, self.vitpose_cfg,
                         self._upload(crops))
        return VP.decode_keypoints(hm.float().cpu().numpy(),
                                   np.asarray(boxes_xywh, np.float32))

    def posed_vertices(self, frames, bboxes) -> torch.Tensor:
        """The clip's SMPL-H vertices (T, V, 3) in camera space."""
        H, W = frames[0].shape[:2]
        out, css = self.body_params(frames, np.asarray(bboxes))
        hands = self.hand_params(frames, self.keypoints(frames, bboxes))
        n_hand = self.hamer_cfg.num_joints if self.hamer_cfg else 16
        poses = fuse_pose_batch(self.smpl_model.num_joints,
                                out["pose_rotmats"],
                                *pack_hands(hands, n_hand, self.device))
        nb = self.smpl_model.num_betas
        b = out["betas"][:, :nb]
        if b.shape[1] < nb:
            b = torch.nn.functional.pad(b, (0, nb - b.shape[1]))
        verts, _ = SM.lbs(self.smpl_model, b, poses)
        # the crop camera lifted to the full image
        transl = HM.cam_crop_to_full(
            out["cam"], torch.from_numpy(css).to(self.device), W, H,
            self.focal)
        return verts + transl[:, None, :]

    def estimate_motion(self, frames, masks, bboxes) -> np.ndarray:
        """frames: (H, W, 3) uint8; returns the sdc video (T, H, W, 3) uint8
        on black."""
        H, W = frames[0].shape[:2]
        verts = self.posed_vertices(frames, bboxes)
        rgb, alpha, _ = REND.render_frames(
            verts, self._faces, self._colors, self.focal,
            torch.tensor([W / 2.0, H / 2.0], device=self.device),
            height=H, width=W, stats=self.render_stats)
        sdc = rgb * alpha[..., None]
        return (sdc.clamp(0, 1) * 255).to(torch.uint8).cpu().numpy()
