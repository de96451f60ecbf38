"""Latent frame interpolation (optional frame-rate upsampling).

Counterpart of ``mimo_tpu/pipelines/interp.py`` (reference
src/pipelines/utils.py:10-29 slerp / linear and interpolate_latents):
inserts ``factor - 1`` interpolated latents between consecutive frames.
"""

from __future__ import annotations

import torch


def lerp(v0: torch.Tensor, v1: torch.Tensor, t: float) -> torch.Tensor:
    return (1 - t) * v0 + t * v1


def slerp(v0: torch.Tensor, v1: torch.Tensor, t: float,
          dot_threshold: float = 0.9995) -> torch.Tensor:
    """Spherical interpolation over flattened latents (fp32 norms); falls
    back to lerp when the vectors are nearly parallel."""
    f0 = v0.float().reshape(-1)
    f1 = v1.float().reshape(-1)
    n0 = f0 / torch.linalg.norm(f0)
    n1 = f1 / torch.linalg.norm(f1)
    dot = torch.clamp(torch.sum(n0 * n1), -1.0, 1.0)
    theta = torch.arccos(dot)
    sin_theta = torch.sin(theta)
    w0 = torch.sin((1 - t) * theta) / sin_theta
    w1 = torch.sin(t * theta) / sin_theta
    out = w0 * f0 + w1 * f1
    out = torch.where(torch.abs(dot) > dot_threshold,
                      (1 - t) * f0 + t * f1, out)
    return out.reshape(v0.shape).to(v0.dtype)


def interpolate_latents(latents: torch.Tensor, factor: int,
                        mode: str = "slerp") -> torch.Tensor:
    """latents: (F, h, w, c) -> ((F-1)*factor + 1, h, w, c). factor < 2 is a
    no-op; any mode but "slerp" interpolates linearly."""
    if factor < 2:
        return latents
    fn = slerp if mode == "slerp" else lerp
    out = []
    for i in range(latents.shape[0] - 1):
        out.append(latents[i])
        for k in range(1, factor):
            out.append(fn(latents[i], latents[i + 1], k / factor))
    out.append(latents[-1])
    return torch.stack(out)
