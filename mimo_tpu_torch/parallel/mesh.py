"""The process mesh on ``torch.distributed``.

Counterpart of ``mimo_tpu/parallel/mesh.py``. There a mesh is an array of
devices with named axes and XLA places the collectives; here a rank is one
process, and a ``ProcessMesh`` lays the world's ranks out as a shape with
named axes (``("data",)``, or ``("data", "frame")`` for 2-D generation).
Each rank holds its coordinates and one process group per axis: the ranks
of its line along that axis, in rank order. The collectives the sharded
code needs (``parallel/comm.py``) take such a group.

The sharding modes that use a mesh are described in
``pipelines/pose2vid.py`` (window-batch DP, frame-axis parallelism, 2-D)
and ``parallel/decomp.py`` (frame-parallel decomposition forwards).

Backend and device are explicit: NCCL is the default on CUDA and refuses
more ranks than there are visible cards; gloo runs only where the caller
names it (on the CPU, or several ranks sharing one card). Nothing switches
backend or device on a failure.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


def init(backend: Optional[str] = None, device=None, *, init_method: str,
         world_size: int, rank: int) -> torch.device:
    """Join the process group; returns this rank's device.

    ``device``: "cuda" (the default) means ``cuda:<rank>``; a device with an
    index ("cuda:0") is taken as it is, so several gloo ranks may share one
    card; "cpu" runs on the host. ``backend``: "nccl" (the default on CUDA)
    or "gloo" (the default on the CPU, and on CUDA only when named)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("parallel.init: no CUDA device; pass "
                               "device='cpu' (and backend='gloo') to run on "
                               "the CPU")
        if dev.index is None:
            dev = torch.device("cuda", rank)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("parallel.init: NCCL needs CUDA devices")
        cards = torch.cuda.device_count()
        if world_size > cards:
            raise RuntimeError(
                f"parallel.init: NCCL with {world_size} ranks needs "
                f"{world_size} cards, {cards} visible (NCCL refuses two "
                f"ranks on one card; name backend='gloo' to share it)")
    elif backend != "gloo":
        raise ValueError(f"parallel.init: unknown backend {backend!r}")
    if dev.type == "cuda":
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"parallel.init: {dev} is not visible "
                               f"({torch.cuda.device_count()} cards)")
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            device_id=dev if backend == "nccl" else None)
    return dev


class ProcessMesh:
    """The world's ranks laid out as ``shape`` with ``axis_names``.

    ``shape`` / ``size(axis)``: ranks along each axis (``shape`` is a dict,
    as a JAX mesh's); ``index(axis)``: this rank's coordinate on it;
    ``group(axis)``: the process group of this rank's line along it. Every
    rank of the world must build the same mesh, in the same order, since
    ``dist.new_group`` is collective."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 device):
        if not dist.is_initialized():
            raise RuntimeError("ProcessMesh: call parallel.init first")
        shape, axis_names = tuple(shape), tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError(f"ProcessMesh: shape {shape} vs axes "
                             f"{axis_names}")
        world, rank = dist.get_world_size(), dist.get_rank()
        if int(np.prod(shape)) != world:
            raise ValueError(f"ProcessMesh: shape {shape} holds "
                             f"{int(np.prod(shape))} ranks, the world "
                             f"{world}")
        ranks = np.arange(world).reshape(shape)
        self.axis_names = axis_names
        self.shape: Dict[str, int] = dict(zip(axis_names, shape))
        self.device = torch.device(device)
        self.rank = rank
        self.coords: Dict[str, int] = dict(zip(
            axis_names, (int(c) for c in np.unravel_index(rank, shape))))
        self._groups: Dict[str, Any] = {}
        for i, name in enumerate(axis_names):
            for line in np.moveaxis(ranks, i, -1).reshape(-1, shape[i]):
                group = dist.new_group([int(r) for r in line])
                if rank in line:
                    self._groups[name] = group

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis: str):
        return self._groups[axis]

    def __repr__(self) -> str:
        return (f"ProcessMesh({self.shape}, rank {self.rank} at "
                f"{self.coords}, {self.device})")


def get_mesh(*, device) -> ProcessMesh:
    """The 1-D ``("data",)`` mesh over the whole world."""
    return ProcessMesh((dist.get_world_size(),), ("data",), device)


def get_mesh_2d(shape: Tuple[int, int], *, device) -> ProcessMesh:
    """The 2-D ``("data", "frame")`` (windows x frames) mesh of long clips:
    ranks r = d * nf + f (the layout ``__graft_entry__.py`` builds with a
    reshape)."""
    return ProcessMesh(shape, ("data", "frame"), device)
