"""The port's z-buffer renderer (mimo_tpu_torch/decomp/renderer.py) against
mimo_tpu/decomp/renderer.py's ``rasterize`` and ``render_frames`` on
numpy-seeded meshes: random topology (faces spanning the frame), the
surface topology of the synthetic SMPL-H, exact depth ties between
overlapping faces (the lowest face index wins), faces behind the camera,
degenerate faces and faces partly off the image.

Tolerance: alpha equal except at pixel centres within 1e-4 (barycentric)
of an edge of a face that could cover them; rgb and depth within 1e-5
where both cover (chip_smoke.py phase 8 holds the card to the CPU so),
widened to 1e-5 / area at pixels covered by a face smaller than one square
pixel: there the fp32 edge functions' rounding, divided by the area,
reaches 1e-5 in either package, and the JAX package's compiler may fuse
their products into FMAs. The candidate chunking must not change a bit.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from mimo_tpu.decomp import renderer as JR
from mimo_tpu_torch.decomp import renderer as R
from mimo_tpu_torch.decomp import smpl as SM
from tests.test_torch_helpers import nn

EDGE = 1e-4
TOL = 1e-5


def edges_and_areas(verts, faces, focal, center, h, w):
    """(near, area): (H, W) pixels whose centre lies within EDGE
    (barycentric, fp64) of an edge of a front-facing, non-degenerate face,
    and the least |area| (px^2) of such a face covering each pixel (inf
    where none does)."""
    v = np.asarray(verts, np.float64)
    xy = v[:, :2] / np.maximum(v[:, 2:3], 1e-6) * focal + center
    px, py = np.meshgrid(np.arange(w) + 0.5, np.arange(h) + 0.5)
    near = np.zeros((h, w), bool)
    least = np.full((h, w), np.inf)
    for f in np.asarray(faces):
        if (v[f, 2] <= 1e-6).any():
            continue
        (x0, y0), (x1, y1), (x2, y2) = xy[f]
        area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
        if abs(area) <= 1e-9:
            continue
        w0 = ((x2 - x1) * (py - y1) - (y2 - y1) * (px - x1)) / area
        w1 = ((x0 - x2) * (py - y2) - (y0 - y2) * (px - x2)) / area
        lo = np.minimum(np.minimum(w0, w1), 1 - w0 - w1)
        near |= np.abs(lo) <= EDGE
        least = np.where(lo >= -EDGE, np.minimum(least, abs(area)), least)
    return near, least


def assert_render_close(got, want, edge_area):
    near, area = edge_area
    rgb_t, a_t, d_t = (nn(x) for x in got)
    rgb_j, a_j, d_j = (np.asarray(x, np.float64) for x in want)
    bad = (a_t != a_j) & ~near
    assert not bad.any(), int(bad.sum())
    both = (a_t > 0) & (a_j > 0)
    assert both.any()
    tol = TOL * np.maximum(1.0, 1.0 / area)
    assert (np.abs(rgb_t - rgb_j).max(-1) <= tol)[both].all()
    assert (np.abs(d_t - d_j) <= tol)[both].all()
    assert (rgb_t[a_t == 0] == 0).all() and (d_t[a_t == 0] == 0).all()


def random_mesh(seed, nv=60, nf=80, zlo=1.5):
    rng = np.random.default_rng(seed)
    verts = np.concatenate([rng.uniform(-1.2, 1.2, (nv, 2)),
                            rng.uniform(zlo, 3.0, (nv, 1))], 1)
    return (verts.astype(np.float32),
            rng.integers(0, nv, (nf, 3)).astype(np.int32),
            rng.uniform(0, 1, (nv, 3)).astype(np.float32))


def surface_mesh(seed):
    data = SM.surface_arrays(seed, rings=14, segments=18)
    v = data["v_template"].astype(np.float32)
    rng = np.random.default_rng(seed)
    v = v @ np.linalg.qr(rng.standard_normal((3, 3)))[0].astype(np.float32)
    v[:, 2] += 2.0
    return (v, data["f"].astype(np.int32),
            rng.uniform(0, 1, v.shape).astype(np.float32))


def special_mesh(seed):
    """Exact ties (two faces twice, at the same positions), faces behind the
    camera, degenerate faces, faces off-image."""
    rng = np.random.default_rng(seed)
    quad = np.array([[-0.5, -0.5, 2], [0.6, -0.4, 2], [0.1, 0.7, 2],
                     [-0.6, 0.5, 2]], np.float32)
    verts = np.concatenate([
        quad,                                   # 0-3: two faces
        quad,                                   # 4-7: the same two again
        [[0, 0, -1], [0.3, 0, 2], [0, 0.3, 2]],  # 8-10: one vertex behind
        [[0.2, 0.2, 1e-7], [0.5, 0.2, 2], [0.2, 0.5, 2]],  # 11-13: z ~ 0
        [[0.1, 0.1, 1.5], [0.2, 0.2, 1.5], [0.3, 0.3, 1.5]],  # 14-16: line
        [[-3, -3, 1.8], [3, -2, 1.8], [0, 4, 2.5]],  # 17-19: off-image
    ]).astype(np.float32)
    faces = np.array([[4, 5, 6], [0, 1, 2], [0, 2, 3], [4, 6, 7],
                      [8, 9, 10], [11, 12, 13], [14, 15, 16], [14, 14, 15],
                      [17, 18, 19]], np.int32)
    return verts, faces, rng.uniform(0, 1, (len(verts), 3)).astype(
        np.float32)


MESHES = {"random": lambda: random_mesh(0),
          "random behind": lambda: random_mesh(1, zlo=-0.5),
          "surface": lambda: surface_mesh(2),
          "special": lambda: special_mesh(3)}
H, W = 40, 48
FOCAL, CENTER = 30.0, np.array([W / 2, H / 2], np.float32)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_rasterize_matches_jax(mesh, monkeypatch):
    verts, faces, colors = MESHES[mesh]()
    want = JR.rasterize(jnp.asarray(verts), jnp.asarray(faces),
                        jnp.asarray(colors), jnp.asarray(np.float32(FOCAL)),
                        jnp.asarray(CENTER), height=H, width=W,
                        face_chunk=16)
    stats = {}
    got = R.rasterize(torch.from_numpy(verts), torch.from_numpy(faces),
                      torch.from_numpy(colors), FOCAL,
                      torch.from_numpy(CENTER), height=H, width=W,
                      stats=stats)
    assert got[0].shape == (H, W, 3) and got[1].shape == got[2].shape \
        == (H, W)
    assert_render_close(got, want, edges_and_areas(verts, faces, FOCAL,
                                                   CENTER, H, W))
    assert 0 < stats["covered"] <= stats["tests"]
    # the candidate chunks change nothing
    monkeypatch.setattr(R, "BUDGET", 97)
    small = R.rasterize(torch.from_numpy(verts), torch.from_numpy(faces),
                        torch.from_numpy(colors), FOCAL,
                        torch.from_numpy(CENTER), height=H, width=W)
    for a, b in zip(got, small):
        assert torch.equal(a, b)


def test_ties_go_to_the_lowest_face_index():
    """Faces 0 and 1 join vertices at the same positions (equal depths,
    bit for bit), coloured red and blue: the first face's colour wins
    wherever they cover, whichever it is, as in the JAX package (there
    across chunks of one face)."""
    tri = np.array([[-0.5, -0.5, 2], [0.6, -0.4, 2], [0.1, 0.7, 2]],
                   np.float32)
    verts = np.concatenate([tri, tri])
    colors = np.array([[1, 0, 0]] * 3 + [[0, 0, 1]] * 3, np.float32)
    for faces in ([[0, 1, 2], [3, 4, 5]], [[3, 4, 5], [0, 1, 2]]):
        faces = np.asarray(faces, np.int32)
        rgb, alpha, _ = R.rasterize(
            torch.from_numpy(verts), torch.from_numpy(faces),
            torch.from_numpy(colors), FOCAL, torch.from_numpy(CENTER),
            height=H, width=W)
        want = JR.rasterize(jnp.asarray(verts), jnp.asarray(faces),
                            jnp.asarray(colors),
                            jnp.asarray(np.float32(FOCAL)),
                            jnp.asarray(CENTER), height=H, width=W,
                            face_chunk=1)
        cover = nn(alpha) > 0
        assert cover.sum() > 50
        np.testing.assert_allclose(nn(rgb)[cover],
                                   np.broadcast_to(colors[faces[0, 0]],
                                                   (cover.sum(), 3)),
                                   atol=1e-6)
        np.testing.assert_allclose(nn(rgb), np.asarray(want[0]), atol=1e-6)


def test_render_frames_matches_jax():
    """Three frames of the surface mesh moving, at a height past the JAX
    package's band (its banded kernel and its fallback)."""
    v, faces, colors = surface_mesh(4)
    verts = np.stack([v + [0.1 * t, -0.05 * t, 0.2 * t] for t in range(3)])
    h, w, center = 96, 64, np.array([32.0, 48.0], np.float32)
    want = JR.render_frames(jnp.asarray(verts), jnp.asarray(faces),
                            jnp.asarray(colors),
                            jnp.asarray(np.float32(60.0)),
                            jnp.asarray(center), height=h, width=w)
    got = R.render_frames(torch.from_numpy(verts), torch.from_numpy(faces),
                          torch.from_numpy(colors), 60.0,
                          torch.from_numpy(center), height=h, width=w)
    assert got[0].shape == (3, h, w, 3)
    edges = [edges_and_areas(vt, faces, 60.0, center, h, w) for vt in verts]
    assert_render_close(got, want, tuple(np.stack(x) for x in zip(*edges)))


def test_render_over_matches_jax():
    rng = np.random.default_rng(5)
    rgb = rng.uniform(0, 1, (2, 4, 5, 3)).astype(np.float32)
    alpha = (rng.uniform(0, 1, (2, 4, 5)) > 0.5).astype(np.float32)
    bg = rng.uniform(0, 1, (2, 4, 5, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        nn(R.render_over(*(torch.from_numpy(x) for x in (rgb, alpha, bg)))),
        np.asarray(JR.render_over(jnp.asarray(rgb), jnp.asarray(alpha),
                                  jnp.asarray(bg)), np.float64))
