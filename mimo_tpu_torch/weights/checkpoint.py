"""Checkpoint save / load / pruning of a nested parameter tree.

Counterpart of ``mimo_tpu/weights/checkpoint.py``: ``torch.save`` /
``torch.load(weights_only=True)`` where the reference uses orbax, and
``keep_latest`` with the reference's semantics. A checkpoint is a directory
(as orbax writes one) holding the tree in ``params.pt``, so
``keep_latest`` prunes ``checkpoint-<step>`` directories in both packages.
The tree is what the port's models take: dicts, lists, None and tensors.
The flat .npz of ``weights/convert.py`` stays the interchange format with
the JAX package (``weights/bridge.py`` reads it).
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Any

import torch

TREE_FILE = "params.pt"


def save(tree: Any, path: str) -> None:
    """Write ``tree`` into the checkpoint directory ``path`` (made if
    missing; a tree already there is replaced)."""
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, TREE_FILE + ".tmp")
    torch.save(tree, tmp)
    os.replace(tmp, os.path.join(path, TREE_FILE))


def load(path: str, device="cuda") -> Any:
    """The tree of the checkpoint directory ``path`` with its tensors on
    ``device``: the card unless the caller asks for the CPU."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("checkpoint.load: no CUDA device; pass "
                           "device='cpu' to load onto the CPU")
    return torch.load(os.path.join(path, TREE_FILE), map_location=device,
                      weights_only=True)


def keep_latest(ckpt_dir: str, n_keep: int = 2,
                pattern: str = r"checkpoint-(\d+)") -> None:
    """Prune old checkpoint-<step> dirs, keep the n newest
    (src/utils/util.py:35-48 semantics)."""
    if not os.path.isdir(ckpt_dir):
        return
    entries = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(pattern, name)
        if m:
            entries.append((int(m.group(1)), name))
    entries.sort()
    for _, name in entries[:-n_keep] if n_keep else entries:
        shutil.rmtree(os.path.join(ckpt_dir, name), ignore_errors=True)
