"""The one generator of the benchmark's traffic: the inputs of clip k of a
run seeded n, from a traffic file's parameters (``traffic/<name>.json``).

A clip is what a user submits: a reference image of a character (a figure
on a plain background, so that the entry's matting finds a person) and a
template of ``frames`` frames at ``height`` × ``width``. The template's pose
video (sdc) is a figure on black, walking ``speed`` pixels a frame (drawn
from the ``speed`` range), bouncing at the frame's edges, with its arms
swinging. With ``streams`` holding "bk", "vid" and "occ" it is an edit
template as well: a textured background, the source video (the background
with the figure painted in) and a fixed occlusion patch on the figure's
path.

Every seed gets the same sizes; only the values differ (colours, the
figure's proportions, start, direction and pace, the background's
texture). The inputs of clip k depend on (n, k) alone.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List

import numpy as np

HERE = Path(__file__).resolve().parent


def load(name: str) -> Dict[str, Any]:
    """The parameters of the traffic mix ``name``."""
    with open(HERE / f"{name}.json") as f:
        return json.load(f)


def rng_of(seed: int, *keys: int) -> np.random.Generator:
    """A generator of (seed, keys...): any whole seed, negatives too."""
    return np.random.default_rng(
        np.random.SeedSequence([seed % (1 << 64), *keys]))


def seed_of(seed: int, *keys: int) -> int:
    """A torch seed of (seed, keys...)."""
    return int(rng_of(seed, *keys).integers(0, 1 << 62))


# what each derived stream of a run's seed is for
INPUTS, NOISE, WEIGHTS, CHECKED = 0, 1, 2, 3
WARM = 1 << 20   # the clip index of the warm-up's inputs: no window's


def weights_seed(seed: int) -> int:
    return seed_of(seed, WEIGHTS)


def checked_clip(seed: int, clips: int) -> int:
    """Which of a window's ``clips`` clips the reference checks."""
    return int(rng_of(seed, CHECKED).integers(0, clips))


def _colour(rng, low=70, high=250) -> np.ndarray:
    return rng.integers(low, high, size=3).astype(np.uint8)


def _figure(rng, canvas_h: int) -> Dict[str, Any]:
    """A figure's proportions and colours."""
    s = canvas_h / 720.0
    return {"torso_h": int(rng.integers(260, 320) * s),
            "torso_w": int(rng.integers(80, 100) * s),
            "head": int(rng.integers(50, 62) * s),
            "arm_w": int(rng.integers(190, 230) * s),
            "colours": [_colour(rng) for _ in range(4)]}


def _draw(img: np.ndarray, fig: Dict[str, Any], cx: int, top: int,
          swing: float) -> np.ndarray:
    """The figure drawn onto img (in place) with its torso's centre at
    column cx; returns the mask of the pixels it covers."""
    h, w = img.shape[:2]
    mask = np.zeros((h, w), bool)
    head, tw, th, aw = fig["head"], fig["torso_w"], fig["torso_h"], fig["arm_w"]
    parts = [
        (top + head, top + head + th, cx - tw // 2, cx + tw // 2),      # torso
        (top, top + head, cx - head // 2, cx + head // 2),              # head
        (top + head + 30 + int(swing), top + head + 50 + int(swing),
         cx - aw // 2, cx + aw // 2),                                   # arms
        (top + head + th, top + head + th + th // 2, cx - tw // 2 + 4,
         cx - 6),                                                       # leg
    ]
    for (y0, y1, x0, x1), col in zip(parts, fig["colours"]):
        y0, y1, x0, x1 = max(0, y0), min(h, y1), max(0, x0), min(w, x1)
        img[y0:y1, x0:x1] = col
        mask[y0:y1, x0:x1] = True
    return mask


def reference_image(p: Dict[str, Any], rng) -> np.ndarray:
    """A figure on a plain light background, with a little pixel noise."""
    h, w = p["ref_size"]
    img = np.empty((h, w, 3), np.uint8)
    img[...] = rng.integers(200, 250, size=3).astype(np.uint8)
    fig = _figure(rng, h)
    fig["colours"] = [_colour(rng, 20, 150) for _ in range(4)]
    _draw(img, fig, w // 2 + int(rng.integers(-20, 21)), h // 8, 0.0)
    noise = rng.integers(-6, 7, size=img.shape)
    return np.clip(img.astype(np.int16) + noise, 0, 255).astype(np.uint8)


def _background(rng, h: int, w: int) -> np.ndarray:
    yy, xx = np.mgrid[0:h, 0:w]
    a, b, c = rng.integers(2, 9, size=3)
    return np.stack([(xx // a + yy // b) % 200 + 30,
                     (xx // (a + 4)) % 90 + 100 + (yy // (8 * c)) % 2 * 40,
                     (yy // c) % 160 + 60], axis=-1).astype(np.uint8)


def clip_inputs(p: Dict[str, Any], seed: int, k: int) -> Dict[str, Any]:
    """Clip k's inputs: ``ref`` (H, W, 3) uint8, ``sdc`` a list of frames
    and, for an edit template, ``vid``, ``bk``, ``occ``; ``seed`` the
    clip's noise seed."""
    rng = rng_of(seed, INPUTS, k)
    h, w = p["height"], p["width"]
    n = p["frames"]
    ref = reference_image(p, rng)
    fig = _figure(rng, h)
    margin = fig["arm_w"] // 2 + 10
    span = w - 2 * margin
    speed = float(rng.uniform(*p["speed"]))
    start = float(rng.uniform(0, 2 * span))
    direction = 1.0 if rng.random() < 0.5 else -1.0
    top = int(rng.integers(h // 10, h // 5))
    phase = float(rng.uniform(0, 2 * np.pi))
    edit = "bk" in p["streams"]
    bk = _background(rng, h, w) if edit else None
    sdc: List[np.ndarray] = []
    vid: List[np.ndarray] = []
    centres = []
    for t in range(n):
        q = (start + direction * speed * t) % (2 * span)
        cx = margin + int(q if q < span else 2 * span - q)
        centres.append(cx)
        f = np.zeros((h, w, 3), np.uint8)
        body = _draw(f, fig, cx, top, 12.0 * np.sin(phase + 0.5 * t))
        sdc.append(f)
        if edit:
            v = bk.copy()
            v[body] = f[body] // 2 + 90
            vid.append(v)
    out: Dict[str, Any] = {"ref": ref, "sdc": sdc,
                           "seed": seed_of(seed, NOISE, k)}
    if edit:
        # the occlusion patch: a block across the figure's path, mid-clip
        occ = np.zeros((h, w, 3), np.uint8)
        cy = top + fig["head"] + fig["torso_h"] // 2
        cx = centres[n // 2]
        ph, pw = p["occ_size"]
        occ[cy - ph // 2:cy + ph // 2, cx - pw // 2:cx + pw // 2] = 255
        out.update(vid=vid, bk=[bk] * n, occ=[occ] * n)
    return out
