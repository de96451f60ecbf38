"""The collectives the sharded code takes from ``jax.lax``, on
``torch.distributed`` process groups.

- ``all_to_all(x, group, split_axis, concat_axis)``: ``jax.lax.all_to_all``
  with ``tiled=True``. ``split_axis`` is cut into n blocks, block i goes to
  rank i, and the n blocks a rank receives are concatenated on
  ``concat_axis`` in rank order. ``dist.all_to_all_single`` splits only
  dim 0, so the split axis is moved to the front and made contiguous first.
- ``all_gather(x, group, axis)``: ``jax.lax.all_gather(..., tiled=True)``,
  every rank's ``x`` concatenated on ``axis`` in rank order.
- ``axis_index(group)``: this rank's place in the group.
- ``broadcast(x, group, src)``: the group's rank ``src``'s ``x``.

gloo takes no ``bool`` tensor: masks travel as ``uint8``. gloo runs every
collective here on CUDA tensors itself (torch 2.11 on an H100: ``python -m
mimo_tpu_torch.entry.graft --probe``; it copies them through host memory),
so no tensor is staged by hand, and no call falls back from one backend to
another.

``gather_blocks(fn, x, group)`` runs a per-sample ``fn`` on this rank's
block of a batch every rank holds (padded with its last sample,
``pad_to``) and gathers the outputs; ``measure()`` records each
``all_to_all``'s bytes sent and its time (CUDA events on the current stream
for CUDA tensors, the host clock otherwise).
"""

from __future__ import annotations

import contextlib
import time
from typing import List

import torch
import torch.distributed as dist


def axis_index(group) -> int:
    return dist.get_rank(group)


def axis_size(group) -> int:
    return dist.get_world_size(group)


def local_slice(length: int, n: int, index: int) -> slice:
    """Block ``index`` of ``length`` cut into ``n`` equal blocks."""
    if length % n:
        raise ValueError(f"{length} does not split into {n} equal blocks")
    per = length // n
    return slice(index * per, (index + 1) * per)


def pad_to(x: torch.Tensor, mult: int) -> torch.Tensor:
    """The leading axis padded up to a multiple of ``mult`` by repeating
    the last sample (a real sample stays in-distribution for a model that
    normalises by its input)."""
    pad = (-x.shape[0]) % mult
    if not pad:
        return x
    return torch.cat([x, x[-1:].expand(pad, *x.shape[1:])], dim=0)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def gather_blocks(fn, x: torch.Tensor, group):
    """fn over the leading axis of x split over ``group``: x padded to a
    multiple of the group (``pad_to``), this rank's block through ``fn``
    (independent per sample), every output tensor (a dict, list or tuple
    of them too) gathered in rank order and cut back to x's length. Every
    rank passes the whole x."""
    n = axis_size(group)
    padded = pad_to(x, n)
    y = fn(padded[local_slice(padded.shape[0], n, axis_index(group))])
    return _map(y, lambda o: all_gather(o, group, axis=0)[:x.shape[0]])


class CommTimes:
    """Per-exchange times of ``all_to_all`` inside ``measure()``."""

    def __init__(self):
        self._events: List = []
        self._host: List[float] = []
        self.calls = 0
        self.bytes = 0

    def seconds(self) -> float:
        total = sum(self._host)
        if self._events:
            self._events[-1][1].synchronize()
            total += sum(a.elapsed_time(b) for a, b in self._events) / 1e3
        return total


_MEASURES: List[CommTimes] = []


@contextlib.contextmanager
def measure():
    """Record every ``all_to_all`` inside: its bytes sent and its time."""
    m = CommTimes()
    _MEASURES.append(m)
    try:
        yield m
    finally:
        _MEASURES.remove(m)


def _wire(x: torch.Tensor) -> torch.Tensor:
    """x as the backends take it: contiguous, bool as uint8."""
    return (x.to(torch.uint8) if x.dtype == torch.bool else x).contiguous()


def all_to_all(x: torch.Tensor, group, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    n = axis_size(group)
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: axis {split_axis} of {tuple(x.shape)} "
                         f"does not split over {n} ranks")
    if n == 1:
        return x
    send = _wire(x.movedim(split_axis, 0))
    timed = _MEASURES[-1] if _MEASURES else None
    if timed is not None:
        timed.calls += 1
        timed.bytes += send.numel() * send.element_size() * (n - 1) // n
        if x.is_cuda:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        else:
            t0 = time.perf_counter()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    if timed is not None:
        if x.is_cuda:
            ev[1].record()
            timed._events.append(ev)
        else:
            timed._host.append(time.perf_counter() - t0)
    blocks = [b.movedim(0, split_axis) for b in recv.to(x.dtype).chunk(n, 0)]
    return torch.cat(blocks, dim=concat_axis)


def all_gather(x: torch.Tensor, group, axis: int = 0) -> torch.Tensor:
    n = axis_size(group)
    if n == 1:
        return x
    send = _wire(x)
    parts = [torch.empty_like(send) for _ in range(n)]
    dist.all_gather(parts, send, group=group)
    return torch.cat(parts, dim=axis).to(x.dtype)


def broadcast(x: torch.Tensor, group, src: int = 0) -> torch.Tensor:
    """The group's rank ``src``'s x (``src`` is a rank of the group)."""
    if axis_size(group) == 1:
        return x
    buf = _wire(x).clone()
    dist.broadcast(buf, group=group,
                   src=dist.get_global_rank(group, src)
                   if group is not dist.group.WORLD else src)
    return buf.to(x.dtype)
