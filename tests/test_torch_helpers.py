"""Shared helpers (no tests) of the tests that hold the PyTorch port (mimo_tpu_torch)
against the JAX package: parameter bridging and numpy/torch conversion.

Both packages run on the CPU in fp32. Inputs are made with numpy from a seed
and handed to both sides; JAX parameters reach the port through the weights
bridge (mimo_tpu_torch/weights/bridge.py) in the flatten_tree format.
"""

import numpy as np
import jax
import torch

from mimo_tpu.weights.convert import flatten_tree
from mimo_tpu_torch.weights import bridge


def set_fp32_matmuls() -> None:
    """Full fp32 products on both backends (TF32 would keep ~3 digits)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def bridge_params(jax_tree, kind=None):
    """JAX parameter tree -> the port's tree, through the flat format
    (``kind``: a decomposition tree, see ``bridge.TRANSPOSED_CONVS``)."""
    flat = flatten_tree(jax.tree.map(np.asarray, jax_tree))
    return bridge.from_flat(flat, kind=kind)


def tt(x) -> torch.Tensor:
    """numpy / JAX array -> fp32 torch tensor."""
    return torch.from_numpy(np.array(x, dtype=np.float32))


def nn(x) -> np.ndarray:
    """torch tensor or JAX array -> fp64 numpy (for comparison)."""
    if isinstance(x, torch.Tensor):
        return x.detach().double().numpy()
    return np.asarray(x, np.float64)
