"""Pose guider: strided conv encoder mapping the sdc pose video (3ch, full
resolution) to latent-resolution features added after the denoising UNet's
conv_in. Counterpart of ``mimo_tpu/models/pose_guider.py``.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from mimo_tpu_torch.config import PoseGuiderConfig
from mimo_tpu_torch.models import layers as L

Params = Dict[str, Any]


def pose_guider_init(gen: torch.Generator, cfg: PoseGuiderConfig,
                     dtype: torch.dtype = torch.float32) -> Params:
    chans = cfg.block_out_channels
    blocks = [{
        "conv_a": L.conv2d_init(gen, 3, 3, chans[i], chans[i], dtype=dtype),
        "conv_b": L.conv2d_init(gen, 3, 3, chans[i], chans[i + 1],
                                dtype=dtype),
    } for i in range(len(chans) - 1)]
    return {
        "conv_in": L.conv2d_init(gen, 3, 3, cfg.conditioning_channels,
                                 chans[0], dtype=dtype),
        "blocks": blocks,
        "conv_out": L.conv2d_init(gen, 3, 3, chans[-1],
                                  cfg.embedding_channels, dtype=dtype,
                                  zero=True),
    }


def pose_guider_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x: (B, F, H, W, 3) in [0, 1] -> (B, F, H/8, W/8, embedding_channels)."""
    b, f, h, w, c = x.shape
    y = L.silu(L.conv2d(p["conv_in"], x.reshape(b * f, h, w, c), padding=1))
    for blk in p["blocks"]:
        y = L.silu(L.conv2d(blk["conv_a"], y, padding=1))
        y = L.silu(L.conv2d(blk["conv_b"], y, stride=2, padding=1))
    y = L.conv2d(p["conv_out"], y, padding=1)
    return y.reshape(b, f, *y.shape[1:])
