"""Vertex-coloured mesh -> image, alpha and depth: an exact z-buffer.

Counterpart of ``mimo_tpu/decomp/renderer.py`` (``project``,
``rasterize``, ``render_over``, ``render_frames``), which draws the SMPL
"sdc" video of the motion stage. It keeps ``rasterize``'s semantics:

- pixel centres at +0.5; perspective projection ``xy / max(z, 1e-6) *
  focal + center``;
- the edge functions in the same fp32 order, ``w2 = 1 - w0 - w1``;
- a pixel is covered where all three weights are >= 0, ``|area| > 1e-9``
  and all three vertex depths are > 1e-6;
- z and the colours interpolate screen-linearly (not perspective-correct);
- the nearest face wins, ties going to the lowest face index.

Instead of testing every face against every pixel in fixed face chunks (a
``lax.scan``, and the row-band variant with its fallback, both shaped by
the TPU), each face is tested only at the pixel centres of its bounding
box, widened by one pixel for rounding and clipped to the image. The
(frame, face, pixel) candidates are processed in chunks of at most
``BUDGET`` tests, so a mesh of huge faces is slow but bounded in memory.
Each covered candidate packs its depth's float bits above its face index
into one int64 (depths are positive, so their bits order as the floats),
and ``scatter_reduce(amin)`` keeps the nearest face of every pixel: the
same answer, and the same bits, whatever the order. A second pass
recomputes the winning face's weights at each covered pixel for its
colour. All frames of a clip share one pass.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

BUDGET = 1 << 24                  # candidate pixel tests a chunk
_NO_HIT = torch.iinfo(torch.int64).max


def project(verts: torch.Tensor, focal, center) -> torch.Tensor:
    """(..., 3) camera-space vertices (+z forward) -> (..., 2) pixels."""
    xy = verts[..., :2] / torch.clamp(verts[..., 2:3], min=1e-6)
    return xy * focal + center


def _edge(ax, ay, bx, by, px, py):
    return (bx - ax) * (py - ay) - (by - ay) * (px - ax)


def _weights(tri, inv_area, px, py):
    """Barycentric weights of pixel centres (px, py) in triangles ``tri``
    (..., 3, 2), in the reference's fp32 order."""
    x0, y0 = tri[..., 0, 0], tri[..., 0, 1]
    x1, y1 = tri[..., 1, 0], tri[..., 1, 1]
    x2, y2 = tri[..., 2, 0], tri[..., 2, 1]
    w0 = _edge(x1, y1, x2, y2, px, py) * inv_area
    w1 = _edge(x2, y2, x0, y0, px, py) * inv_area
    return w0, w1, 1.0 - w0 - w1


def _chunks(counts: torch.Tensor, budget: int):
    """Consecutive [start, end) ranges of ``counts`` (host int64) whose sums
    stay within ``budget`` (a range of one item may exceed it)."""
    cum = torch.cumsum(counts, 0)
    start, n, done = 0, len(counts), 0
    while start < n:
        end = int(torch.searchsorted(cum, done + budget, right=True))
        end = max(end, start + 1)
        yield start, end
        done = int(cum[end - 1])
        start = end


def candidates(verts: torch.Tensor, faces: torch.Tensor, focal, center, *,
               height: int, width: int):
    """The (frame, face, pixel) tests of ``render_frames``, in chunks of at
    most ``BUDGET``: yields (item, pix, w0, w1, w2, z), item = frame * F +
    face, pix = frame * H * W + y * W + x, and the fp32 barycentric weights
    and interpolated depth at the pixel centre. Faces behind the camera (a
    vertex depth <= 1e-6) or degenerate (|area| <= 1e-9) have no tests."""
    dev = verts.device
    T, H, W = verts.shape[0], height, width
    verts = verts.float()
    focal = torch.as_tensor(focal, dtype=torch.float32, device=dev)
    center = torch.as_tensor(center, dtype=torch.float32, device=dev)
    tri = project(verts, focal, center)[:, faces]            # (T, F, 3, 2)
    tz = verts[..., 2][:, faces]                             # (T, F, 3)
    x0, y0 = tri[..., 0, 0], tri[..., 0, 1]
    x1, y1 = tri[..., 1, 0], tri[..., 1, 1]
    x2, y2 = tri[..., 2, 0], tri[..., 2, 1]
    area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)     # (T, F)
    ok = (area.abs() > 1e-9) & (tz > 1e-6).all(-1) & torch.isfinite(area)
    inv_area = torch.where(area.abs() < 1e-9, torch.zeros_like(area),
                           1.0 / area)

    def box(c, n):
        """First pixel and count of pixel centres i + 0.5 within [min - 1,
        max + 1] of the coordinates c (T, F, 3), clipped to [0, n)."""
        lo = torch.clamp(torch.ceil(c.amin(-1) - 0.5) - 1, 0, n)
        hi = torch.clamp(torch.floor(c.amax(-1) - 0.5) + 1, -1, n - 1)
        return lo.long(), torch.clamp(hi - lo + 1, min=0).long()

    bx, nx = box(tri[..., 0], W)
    by, ny = box(tri[..., 1], H)
    counts = torch.where(ok, nx * ny, torch.zeros_like(nx)).reshape(-1)
    F_ = faces.shape[0]
    tri, tz = tri.reshape(-1, 3, 2), tz.reshape(-1, 3)
    inv_area, bx, by, nx = (x.reshape(-1) for x in (inv_area, bx, by, nx))
    counts_host = counts.cpu()
    for a, b in _chunks(counts_host, BUDGET):
        total = int(counts_host[a:b].sum())
        if total == 0:
            continue
        c = counts[a:b]
        item = torch.repeat_interleave(
            torch.arange(a, b, device=dev), c, output_size=total)
        start = torch.repeat_interleave(torch.cumsum(c, 0) - c, c,
                                        output_size=total)
        local = torch.arange(total, device=dev) - start
        nxi = nx[item]
        px = bx[item] + local % nxi
        py = by[item] + local // nxi
        w0, w1, w2 = _weights(tri[item], inv_area[item],
                              px.float() + 0.5, py.float() + 0.5)
        tzi = tz[item]
        z = w0 * tzi[:, 0] + w1 * tzi[:, 1] + w2 * tzi[:, 2]
        yield item, (item // F_) * (H * W) + py * W + px, w0, w1, w2, z


def render_frames(verts: torch.Tensor, faces: torch.Tensor,
                  colors: torch.Tensor, focal, center, *, height: int,
                  width: int, stats: Optional[Dict[str, int]] = None):
    """Render one mesh in each of T frames.

    verts: (T, V, 3) camera space; faces: (F, 3) int; colors: (V, 3) in
    [0, 1]; focal: scalar or (2,); center: (2,). Returns (rgb (T, H, W, 3),
    alpha (T, H, W), depth (T, H, W)) in fp32 on the vertices' device;
    depth is 0 where nothing covers. ``stats``, if given, receives the
    candidate pixel tests, the covered ones and the chunks."""
    dev = verts.device
    T, H, W = verts.shape[0], height, width
    verts = verts.float()
    faces = torch.as_tensor(faces, device=dev).long()
    colors = torch.as_tensor(colors, device=dev).float()
    F_ = faces.shape[0]
    zbuf = torch.full((T * H * W,), _NO_HIT, dtype=torch.int64, device=dev)
    n_tests = n_chunks = n_cover = 0
    for item, pix, w0, w1, w2, z in candidates(
            verts, faces, focal, center, height=H, width=W):
        cover = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        key = (z.view(torch.int32).long() << 32) | (item % F_)
        zbuf.scatter_reduce_(0, pix[cover], key[cover], reduce="amin")
        n_chunks += 1
        n_tests += len(item)
        n_cover += int(cover.sum())

    # the winners' weights again, at their pixels, for the colours
    hp = torch.nonzero(zbuf != _NO_HIT)[:, 0]
    key = zbuf[hp]
    face = key & 0xFFFFFFFF
    t = hp // (H * W)
    focal = torch.as_tensor(focal, dtype=torch.float32, device=dev)
    center = torch.as_tensor(center, dtype=torch.float32, device=dev)
    tri = project(verts[t[:, None], faces[face]], focal, center)  # (N, 3, 2)
    x0, y0 = tri[:, 0, 0], tri[:, 0, 1]
    x1, y1 = tri[:, 1, 0], tri[:, 1, 1]
    x2, y2 = tri[:, 2, 0], tri[:, 2, 1]
    area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
    w0, w1, w2 = _weights(tri, 1.0 / area, (hp % W).float() + 0.5,
                          ((hp % (H * W)) // W).float() + 0.5)
    col = colors[faces[face]]                                # (N, 3, 3)
    rgb = torch.zeros((T * H * W, 3), dtype=torch.float32, device=dev)
    rgb[hp] = (w0[:, None] * col[:, 0] + w1[:, None] * col[:, 1]
               + w2[:, None] * col[:, 2])
    depth = torch.zeros((T * H * W,), dtype=torch.float32, device=dev)
    depth[hp] = (key >> 32).to(torch.int32).view(torch.float32)
    alpha = torch.zeros((T * H * W,), dtype=torch.float32, device=dev)
    alpha[hp] = 1.0
    if stats is not None:
        stats.update(tests=n_tests, covered=n_cover, chunks=n_chunks)
    return (rgb.reshape(T, H, W, 3), alpha.reshape(T, H, W),
            depth.reshape(T, H, W))


def rasterize(verts: torch.Tensor, faces: torch.Tensor, colors: torch.Tensor,
              focal, center, *, height: int, width: int,
              stats: Optional[Dict[str, int]] = None):
    """One mesh, verts (V, 3) -> (rgb (H, W, 3), alpha (H, W), depth (H,
    W))."""
    rgb, alpha, depth = render_frames(verts[None], faces, colors, focal,
                                      center, height=height, width=width,
                                      stats=stats)
    return rgb[0], alpha[0], depth[0]


def render_over(rgb: torch.Tensor, alpha: torch.Tensor,
                background: torch.Tensor) -> torch.Tensor:
    """Alpha-composite a render over a background frame."""
    return rgb * alpha[..., None] + background * (1 - alpha[..., None])
