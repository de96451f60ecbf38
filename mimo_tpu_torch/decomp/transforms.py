"""Rotation representations: axis-angle <-> rotation matrix <-> quaternion.

Counterpart of ``mimo_tpu/decomp/transforms.py``: Rodrigues, a branchless
Shepperd matrix -> quaternion (all four candidates built, the one with the
largest pivot taken), the quaternion -> axis-angle on the w >= 0
hemisphere, and Zhou et al.'s 6D rotation of the HMR2 / HaMeR heads.
Batched over leading axes, on any device; callers keep them in fp32.

Near an angle of pi the pivot moves from w to the largest of x, y, z, and
the sign of the picked quaternion flips with it; the hemisphere step
(``q * sign(w + 1e-12)``) then gives axis * pi with either sign of the
axis, both the same rotation.
"""

from __future__ import annotations

import torch


def aa_to_rotmat(aa: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrices (..., 3, 3) (Rodrigues)."""
    angle = torch.linalg.vector_norm(aa, dim=-1, keepdim=True)
    small = angle < 1e-8
    axis = aa / torch.where(small, torch.ones_like(angle), angle)
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    zero = torch.zeros_like(x)
    K = torch.stack([
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ], dim=-2)
    a = angle[..., None]
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device).expand(K.shape)
    R = eye + torch.sin(a) * K + (1 - torch.cos(a)) * (K @ K)
    return torch.where(small[..., None], eye, R)


def safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp(x, min=1e-12))


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> unit quaternion (..., 4) wxyz."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    qw = 0.5 * safe_sqrt(1.0 + tr)
    qx = 0.5 * safe_sqrt(1.0 + m00 - m11 - m22)
    qy = 0.5 * safe_sqrt(1.0 - m00 + m11 - m22)
    qz = 0.5 * safe_sqrt(1.0 - m00 - m11 + m22)

    c0 = torch.stack([qw, (m21 - m12) / (4 * qw), (m02 - m20) / (4 * qw),
                      (m10 - m01) / (4 * qw)], dim=-1)
    c1 = torch.stack([(m21 - m12) / (4 * qx), qx, (m01 + m10) / (4 * qx),
                      (m02 + m20) / (4 * qx)], dim=-1)
    c2 = torch.stack([(m02 - m20) / (4 * qy), (m01 + m10) / (4 * qy), qy,
                      (m12 + m21) / (4 * qy)], dim=-1)
    c3 = torch.stack([(m10 - m01) / (4 * qz), (m02 + m20) / (4 * qz),
                      (m12 + m21) / (4 * qz), qz], dim=-1)

    cand = torch.stack([c0, c1, c2, c3], dim=-2)            # (..., 4, 4)
    scores = torch.stack([tr, m00 - m11 - m22, m11 - m00 - m22,
                          m22 - m00 - m11], dim=-1)
    idx = torch.argmax(scores, dim=-1)        # first of equal maxima
    q = torch.take_along_dim(cand, idx[..., None, None].expand(
        *idx.shape, 1, 4), dim=-2)[..., 0, :]
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_to_aa(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4) wxyz -> axis-angle (..., 3)."""
    q = q * torch.sign(q[..., :1] + 1e-12)   # hemisphere: w >= 0
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    xyz = q[..., 1:]
    norm = torch.linalg.vector_norm(xyz, dim=-1, keepdim=True)
    angle = 2.0 * torch.atan2(norm[..., 0], w)
    axis = xyz / torch.clamp(norm, min=1e-12)
    return axis * angle[..., None]


def rotmat_to_aa(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> axis-angle (..., 3)."""
    return quat_to_aa(rotmat_to_quat(R))


def rot6d_to_rotmat(x: torch.Tensor) -> torch.Tensor:
    """6D continuous rotation (Zhou et al.) (..., 6) -> (..., 3, 3): the
    two Gram-Schmidt columns and their cross product."""
    a1, a2 = x[..., 0:3], x[..., 3:6]
    b1 = a1 / torch.clamp(torch.linalg.vector_norm(a1, dim=-1, keepdim=True),
                          min=1e-8)
    b2 = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = b2 / torch.clamp(torch.linalg.vector_norm(b2, dim=-1, keepdim=True),
                          min=1e-8)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2).transpose(-1, -2)
