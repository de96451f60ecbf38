"""Temporal context-window scheduler (numpy only).

A copy of ``mimo_tpu/pipelines/context.py``, which cannot be imported where
there is no JAX (importing any ``mimo_tpu`` module imports ``jax``).
``tests/test_torch_context.py`` holds this copy to the original.

Sliding windows of ``context_size`` frames with ``context_overlap``,
dilated by powers of two up to ``context_stride``, wrapping around the clip,
with a per-step bit-reversed offset (reference src/pipelines/context.py).
"""

from __future__ import annotations

from typing import List

import numpy as np


def ordered_halving(val: int) -> float:
    """Bit-reversed fraction in [0, 1): 1->0.5, 2->0.25, 3->0.75, ..."""
    out = 0.0
    scale = 0.5
    while val:
        if val & 1:
            out += scale
        val >>= 1
        scale *= 0.5
    return out


def window_list(num_frames: int, context_size: int, context_stride: int = 1,
                context_overlap: int = 4, step: int = 0,
                closed_loop: bool = True) -> List[List[int]]:
    if num_frames <= context_size:
        return [list(range(num_frames))]

    context_stride = min(
        context_stride,
        int(np.ceil(np.log2(num_frames / context_size))) + 1,
    )

    windows: List[List[int]] = []
    oh = ordered_halving(step)
    for power in range(context_stride):
        dilation = 1 << power
        pad = int(round(num_frames * oh))
        start = int(oh * dilation) + pad
        stop = num_frames + pad + (0 if closed_loop else -context_overlap)
        stride = context_size * dilation - context_overlap
        for j in range(start, stop, stride):
            windows.append([e % num_frames
                            for e in range(j, j + context_size * dilation,
                                           dilation)])
    return windows


def compute_windows(num_frames: int, context_size: int,
                    context_stride: int = 1, context_overlap: int = 4,
                    step: int = 0, pad_to_multiple: int = 1):
    """(W, min(context_size, num_frames)) int32 window indices plus a (W,)
    float32 weight vector (0 for padding windows appended to make W a
    multiple of ``pad_to_multiple``)."""
    wl = window_list(num_frames, context_size, context_stride,
                     context_overlap, step)
    idx = np.asarray(wl, dtype=np.int32)
    w = np.ones((idx.shape[0],), dtype=np.float32)
    if pad_to_multiple > 1:
        rem = (-idx.shape[0]) % pad_to_multiple
        if rem:
            idx = np.concatenate([idx, np.tile(idx[:1], (rem, 1))], axis=0)
            w = np.concatenate([w, np.zeros((rem,), np.float32)])
    return idx, w
