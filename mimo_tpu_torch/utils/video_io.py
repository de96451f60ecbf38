"""Video and image I/O (OpenCV backend, RGB numpy frames).

A copy of ``mimo_tpu/utils/video_io.py``, which cannot be imported where
there is no JAX. Only the CLIs and the web app need it:
``entry.animate.animate`` and ``entry.edit.edit`` also take frames already
in memory, which needs no OpenCV.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover - depends on the machine
    cv2 = None


def _require_cv2():
    if cv2 is None:
        raise RuntimeError("OpenCV is required for video I/O")


def get_fps(path: str) -> float:
    _require_cv2()
    cap = cv2.VideoCapture(path)
    try:
        return float(cap.get(cv2.CAP_PROP_FPS))
    finally:
        cap.release()


def read_frames(path: str) -> List[np.ndarray]:
    _require_cv2()
    cap = cv2.VideoCapture(path)
    frames = []
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    finally:
        cap.release()
    return frames


def load_video_fixed_fps(path: str, target_fps: float = 30.0,
                         target_speed: float = 1.0) -> List[np.ndarray]:
    """Read a video resampled to target_fps by index striding."""
    _require_cv2()
    cap = cv2.VideoCapture(path)
    try:
        fps = round(cap.get(cv2.CAP_PROP_FPS)) or target_fps
        keep_ratio = target_speed * fps / target_fps
        n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        keep = set(np.arange(0, n, keep_ratio).astype(int).tolist())
        frames = []
        idx = 0
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            if idx in keep:
                frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
            idx += 1
        return frames
    finally:
        cap.release()


def save_video(frames, path: str, fps: float = 30.0) -> None:
    """frames: iterable of (H, W, 3) uint8 or [0,1] float RGB."""
    _require_cv2()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    frames = list(frames)
    if not frames:
        raise ValueError("no frames to save")
    h, w = np.asarray(frames[0]).shape[:2]
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                             (w, h))
    if not writer.isOpened():
        raise RuntimeError(f"could not open video writer for {path}")
    try:
        for f in frames:
            f = np.asarray(f)
            if f.dtype != np.uint8:
                f = (np.clip(f, 0, 1) * 255).astype(np.uint8)
            writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    finally:
        writer.release()


class VideoReader:
    """Random-access clip sampler: seek-based frame access and uniform clip
    sampling without decoding the whole file."""

    def __init__(self, path: str):
        _require_cv2()
        self.path = path
        self._cap = cv2.VideoCapture(path)
        if not self._cap.isOpened():
            raise FileNotFoundError(path)
        self.num_frames = int(self._cap.get(cv2.CAP_PROP_FRAME_COUNT))
        self.fps = float(self._cap.get(cv2.CAP_PROP_FPS))
        self.width = int(self._cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        self.height = int(self._cap.get(cv2.CAP_PROP_FRAME_HEIGHT))

    def __len__(self) -> int:
        return self.num_frames

    def get_frame(self, idx: int) -> np.ndarray:
        self._cap.set(cv2.CAP_PROP_POS_FRAMES, idx)
        ok, frame = self._cap.read()
        if not ok:
            raise IndexError(f"frame {idx} of {self.num_frames}")
        return cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)

    def sample_clip(self, n: int, start: int = 0,
                    end: Optional[int] = None) -> List[np.ndarray]:
        """n frames uniformly spread over [start, end)."""
        end = self.num_frames if end is None else min(end, self.num_frames)
        idx = np.linspace(start, max(start, end - 1), n).astype(int)
        return [self.get_frame(int(i)) for i in idx]

    def close(self) -> None:
        self._cap.release()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def load_image(path: str) -> np.ndarray:
    _require_cv2()
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def save_image(img: np.ndarray, path: str) -> None:
    _require_cv2()
    if img.dtype != np.uint8:
        img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    cv2.imwrite(path, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
