"""Weights bridge: a ``mimo_tpu`` parameter tree, flattened to numpy arrays,
becomes the port's parameter tree of torch tensors.

Input is the flat format of ``weights/convert.py`` (the port's copy of
``mimo_tpu/weights/convert.py``; ``flatten_tree``/``save_npz``): keys are ``/``-joined paths, list indices
are decimal path parts, and a ``None`` subtree is a ``<path>#none`` key.
The same tree structure comes out, with these layout changes:

- conv kernels (every 4-D ``kernel`` leaf) go from HWIO to OIHW in
  ``channels_last`` memory format (PyTorch's conv layout);
- linear kernels stay (in, out): the port computes ``x @ kernel``;
- the transposed convs of the decomposition trees (``kind`` "sam", "sam2"
  or "vitpose", matched by path in ``TRANSPOSED_CONVS``) go from the JAX
  package's spatially flipped HWIO (``lax.conv_transpose`` without
  ``transpose_kernel``) to ``F.conv_transpose2d``'s (in, out, kh, kw),
  unflipped.

Everything else (rel-pos tables, pos-embeds, BatchNorm statistics, token
embeddings) copies through as it is; a string leaf (the depth head's resize
kinds) stays a Python string.

bfloat16 leaves arrive as ``ml_dtypes`` arrays (or, read back from an
``.npz``, as raw 2-byte records), which torch cannot take directly; their
bits are widened to float32 on the host first. Nothing here
imports ``mimo_tpu`` or JAX.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch


def _bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    return (bits.view(np.uint16).astype(np.uint32) << 16).view(np.float32)


# path of every transposed-conv kernel of a decomposition tree
TRANSPOSED_CONVS = {
    "sam": re.compile(r"up[12]/kernel"),
    "sam2": re.compile(r"decoder/up[12]/kernel"),
    "vitpose": re.compile(r"deconvs/\d+/deconv/kernel"),
}


def _to_tensor(name: str, arr: np.ndarray, device, dtype,
               transposed: bool = False) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.kind in "US":          # structural metadata (a string)
        return arr.item() if arr.ndim == 0 else arr.tolist()
    if arr.dtype.name in ("bfloat16", "void16"):
        # an ml_dtypes bfloat16 array, or one read back from an .npz
        # (which stores it as raw 2-byte records)
        arr = _bf16_bits_to_f32(arr)
    elif arr.dtype.kind == "f":
        arr = arr.astype(np.float32)
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if transposed:                       # flipped HWIO -> (in, out, kh, kw)
        t = t.flip(0, 1).permute(2, 3, 0, 1)
    elif name == "kernel" and t.dim() == 4:        # HWIO -> OIHW
        t = t.permute(3, 2, 0, 1)
    if t.is_floating_point():
        t = t.to(device=device, dtype=dtype or torch.float32)
    else:
        t = t.to(device=device)
    if t.dim() == 4:
        t = t.contiguous(memory_format=torch.channels_last)
    return t


def from_flat(flat: Mapping[str, np.ndarray], device=None,
              dtype: Optional[torch.dtype] = None,
              kind: Optional[str] = None) -> Any:
    """Flat ``flatten_tree`` mapping -> nested dicts/lists of tensors.
    Floating leaves are cast to ``dtype`` (float32 if None). ``kind`` names
    a decomposition tree whose transposed convs take their own layout."""
    deconv = TRANSPOSED_CONVS[kind] if kind else None
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        if key.endswith("#none"):
            parts = key[:-len("#none")].split("/")
            leaf = None
        else:
            parts = key.split("/")
            leaf = _to_tensor(parts[-1], val, device, dtype,
                              bool(deconv and deconv.fullmatch(key)))
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf

    def listify(node):
        if isinstance(node, dict):
            keys = list(node)
            if keys and all(re.fullmatch(r"\d+", k) for k in keys):
                return [listify(node[str(i)]) for i in range(len(keys))]
            return {k: listify(v) for k, v in node.items()}
        return node

    return listify(root)


def load_npz(path: str, device=None, dtype: Optional[torch.dtype] = None,
             kind: Optional[str] = None):
    """Load a ``save_npz`` bundle straight into the port's tree."""
    with np.load(path) as f:
        return from_flat({k: f[k] for k in f.files}, device, dtype, kind)
