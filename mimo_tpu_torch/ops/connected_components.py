"""Connected components on binary masks: the native C++ union-find with a
scipy fallback.

Counterpart of ``mimo_tpu/ops/connected_components.py``, loading the same
source, ``native/cc_labeling.cpp``, through ctypes. The library is built
from that source at first use with the host C++ compiler into
``mimo_tpu_torch/_build/`` (ignored by git), named by a hash of the source;
where no compiler or no source is found, scipy's ``ndimage.label`` computes
the same labels. ``backend()`` says which of the two runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "cc_labeling.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

_STATE = {"lib": None, "tried": False}
_S4 = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]])


def _build() -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes()
                          + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    so = BUILD_DIR / f"libcc_labeling_{digest}.so"
    if not so.exists():
        cxx = os.environ.get("CXX") or shutil.which("g++") \
            or shutil.which("c++")
        if cxx is None:
            raise RuntimeError("no C++ compiler")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
    return so


def _load_lib() -> Optional[ctypes.CDLL]:
    if _STATE["tried"]:
        return _STATE["lib"]
    _STATE["tried"] = True
    try:
        lib = ctypes.CDLL(str(_build()))
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return None
    u8, i32 = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32)
    lib.cc_label.restype = ctypes.c_int32
    lib.cc_label.argtypes = [u8, ctypes.c_int32, ctypes.c_int32, i32, i32,
                             ctypes.c_int32]
    lib.cc_clean.restype = None
    lib.cc_clean.argtypes = [u8] + [ctypes.c_int32] * 4
    _STATE["lib"] = lib
    return lib


def backend() -> str:
    """"native" (the C++ union-find) or "scipy"."""
    return "native" if _load_lib() is not None else "scipy"


def label(mask: np.ndarray) -> Tuple[np.ndarray, int]:
    """4-connected component labels of a binary mask: (labels int32 (H, W)
    with 0 for background, number of components)."""
    mask = np.ascontiguousarray(mask.astype(np.uint8))
    h, w = mask.shape
    lib = _load_lib()
    if lib is not None:
        labels = np.zeros((h, w), np.int32)
        n = lib.cc_label(
            mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w,
            labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), None, 0)
        return labels, int(n)
    from scipy import ndimage
    labels, n = ndimage.label(mask, structure=_S4)
    return labels.astype(np.int32), int(n)


def clean_mask(mask: np.ndarray, min_area: int = 64,
               fill_holes: bool = True) -> np.ndarray:
    """Drop foreground specks < min_area and fill interior background holes
    < min_area (the SAM2 connected-components post-step)."""
    m = np.ascontiguousarray(mask.astype(np.uint8))
    h, w = m.shape
    lib = _load_lib()
    if lib is not None:
        lib.cc_clean(m.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w,
                     min_area, 1 if fill_holes else 0)
        return m.astype(bool)
    from scipy import ndimage
    labels, n = ndimage.label(m, structure=_S4)
    if n:
        areas = np.bincount(labels.ravel())
        small = np.isin(labels, np.nonzero(areas < min_area)[0]) & (labels > 0)
        m[small] = 0
    if fill_holes:
        labels, n = ndimage.label((m == 0).astype(np.uint8), structure=_S4)
        if n:
            areas = np.bincount(labels.ravel())
            border = np.unique(np.concatenate([
                labels[0], labels[-1], labels[:, 0], labels[:, -1]]))
            for lab in range(1, n + 1):
                if lab not in border and areas[lab] < min_area:
                    m[labels == lab] = 1
    return m.astype(bool)
