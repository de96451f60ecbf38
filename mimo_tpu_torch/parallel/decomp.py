"""Frame-parallel sharding of the decomposition half.

Counterpart of ``mimo_tpu/parallel/decomp.py``. Every heavy per-frame model
of the decomposition (the ViTPose / HMR2 / HaMeR crops, the sdc render) is
independent along its leading axis, so the multi-process layer is plain
data parallelism (``comm.gather_blocks``): every rank gets the full batch,
pads it to a multiple of the axis size by repeating the last sample, runs
its block, and gathers every output leaf in rank order before slicing back
to the true length. Weights are replicated (every rank builds or loads
them itself).

- ``frame_parallel(fn, mesh)`` wraps ``fn(params, batch) -> tensor or a
  dict / list / tuple of tensors``;
- ``render_frames_sharded(...)``: each rank draws its frames with the
  port's exact z-buffer (``decomp.renderer.render_frames``), whose output
  does not depend on how the frames are split. The JAX package's banded
  rasterizer and its ``lax.cond`` fallback exist for the TPU and are not
  ported.
"""

from __future__ import annotations

from typing import Callable

import torch

from mimo_tpu_torch.decomp import renderer as REND
from mimo_tpu_torch.parallel import comm


def frame_parallel(fn: Callable, mesh) -> Callable:
    """``fn(params, batch)`` with the leading batch axis split over the
    mesh's "data" axis: ``fn`` must be independent per sample along it,
    so each sample's output is the one the unsharded call gives it."""

    def wrapped(params, batch):
        return comm.gather_blocks(lambda b: fn(params, b), batch,
                                  mesh.group("data"))

    return wrapped


def render_frames_sharded(verts_per_frame: torch.Tensor, faces, colors,
                          focal, center, *, height: int, width: int, mesh,
                          stats=None):
    """``renderer.render_frames`` with the frames split over the mesh's
    "data" axis; returns (rgb, alpha, depth) of every frame on every rank.
    ``stats`` receives this rank's candidate tests."""
    return comm.gather_blocks(
        lambda v: REND.render_frames(v, faces, colors, focal, center,
                                     height=height, width=width,
                                     stats=stats),
        verts_per_frame, mesh.group("data"))
