"""Bilinear sampling, backward warping and the modulated deformable conv.

Counterpart of ``mimo_tpu/ops/sampling.py`` (channels-last, coordinates in
pixels, x right and y down). The sampling is ``F.grid_sample`` with
``align_corners=True``, so a pixel coordinate ``x`` maps to ``2 x / (W - 1)
- 1`` and back: ``padding_mode="border"`` is the JAX package's clamped
corners (a clamped coordinate and clamped corner indices give the same
value), ``"zeros"`` its ``zero_outside`` (a corner outside the image adds
nothing). Coordinates are fp32 whatever the image's dtype, and the result
takes the promoted dtype of the image and the coordinates, as the JAX
functions' does.

``deform_conv2d`` (torchvision's modulated deformable conv, stride 1, same
padding) samples every (group, tap) with one ``grid_sample`` over the
groups folded into the batch, then takes one matmul with the kernel.
``deform_conv2d_window``, the JAX package's gather-free form for bounded
offsets, computes the same function, so here it is the same code.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _normalized(x: torch.Tensor, y: torch.Tensor, h: int,
                w: int) -> torch.Tensor:
    """Pixel coordinates -> ``grid_sample``'s (x, y) in [-1, 1] at
    ``align_corners=True``."""
    return torch.stack([x * (2.0 / (w - 1)) - 1.0,
                        y * (2.0 / (h - 1)) - 1.0], dim=-1)


def sample_nchw(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                zero_outside: bool) -> torch.Tensor:
    """img (N, C, H, W) fp32 sampled at pixel coordinates x, y of shape
    (N, P, Q) -> (N, C, P, Q). An axis of one pixel is padded with a zero
    (zeros mode) or a copy (border mode) to two, which samples the same."""
    h, w = img.shape[2:]
    if h == 1 or w == 1:
        pad = (0, int(w == 1), 0, int(h == 1))
        img = F.pad(img, pad) if zero_outside \
            else F.pad(img, pad, mode="replicate")
        h, w = img.shape[2:]
    grid = _normalized(x.float(), y.float(), h, w)
    return F.grid_sample(img, grid, mode="bilinear",
                         padding_mode="zeros" if zero_outside else "border",
                         align_corners=True)


def bilinear_sample_batch(imgs: torch.Tensor, coords: torch.Tensor,
                          zero_outside: bool = False) -> torch.Tensor:
    """imgs: (B, H, W, C); coords: (B, ..., 2) as (x, y) pixel coordinates.
    Returns (B, ..., C)."""
    b, _, _, c = imgs.shape
    lead = coords.shape[1:-1]
    flat = coords.reshape(b, 1, -1, 2).float()
    out = sample_nchw(imgs.permute(0, 3, 1, 2).float(), flat[..., 0],
                      flat[..., 1], zero_outside)           # (B, C, 1, P)
    out = out[:, :, 0].transpose(1, 2).reshape(b, *lead, c)
    return out.to(torch.promote_types(imgs.dtype, coords.dtype))


def bilinear_sample(img: torch.Tensor, coords: torch.Tensor,
                    zero_outside: bool = False) -> torch.Tensor:
    """img: (H, W, C); coords: (..., 2) as (x, y). Returns (..., C)."""
    return bilinear_sample_batch(img[None], coords[None], zero_outside)[0]


def flow_warp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward-warp img by flow: out(p) = img(p + flow(p)), border
    clamped. img: (B, H, W, C); flow: (B, H, W, 2) in pixels (x, y)."""
    _, h, w, _ = flow.shape
    ys = torch.arange(h, device=flow.device, dtype=torch.float32)
    xs = torch.arange(w, device=flow.device, dtype=torch.float32)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    f = flow.float()
    out = sample_nchw(img.permute(0, 3, 1, 2).float(), gx + f[..., 0],
                      gy + f[..., 1], zero_outside=False)
    return out.permute(0, 2, 3, 1).to(
        torch.promote_types(img.dtype, flow.dtype))


def deform_conv2d(x: torch.Tensor, offsets: torch.Tensor,
                  kernel: torch.Tensor, bias: Optional[torch.Tensor] = None,
                  mask: Optional[torch.Tensor] = None, kh: int = 3,
                  kw: int = 3, deform_groups: int = 1) -> torch.Tensor:
    """Modulated deformable conv (torchvision semantics, stride 1, same
    padding, zero padding outside the image).

    x: (B, H, W, Cin); offsets: (B, H, W, G*kh*kw*2) as (dy, dx) pairs in
    (group, tap) order; kernel: (Cout, Cin, kh, kw) (the port's conv
    layout); mask: (B, H, W, G*kh*kw) modulation (post-sigmoid) or None.
    The g-th Cin/G channel slab samples with the g-th offset and mask
    block."""
    b, h, w, cin = x.shape
    cout = kernel.shape[0]
    g = deform_groups
    cg = cin // g
    taps = kh * kw
    dev = x.device
    out_dtype = torch.promote_types(x.dtype, offsets.dtype)
    off = offsets.float().reshape(b, h, w, g, taps, 2)
    ti = torch.arange(taps, device=dev)
    tap_dy = (ti // kw).float() - (kh - 1) / 2
    tap_dx = (ti % kw).float() - (kw - 1) / 2
    gy, gx = torch.meshgrid(torch.arange(h, device=dev, dtype=torch.float32),
                            torch.arange(w, device=dev, dtype=torch.float32),
                            indexing="ij")
    cy = gy[None, :, :, None, None] + tap_dy + off[..., 0]   # (B,H,W,G,T)
    cx = gx[None, :, :, None, None] + tap_dx + off[..., 1]
    # groups into the batch: (B*G, H, W*T) positions on (B*G, cg, H, W)
    cy = cy.permute(0, 3, 1, 2, 4).reshape(b * g, h, w * taps)
    cx = cx.permute(0, 3, 1, 2, 4).reshape(b * g, h, w * taps)
    xg = x.float().reshape(b, h, w, g, cg).permute(0, 3, 4, 1, 2) \
        .reshape(b * g, cg, h, w)
    s = sample_nchw(xg, cx, cy, zero_outside=True)     # (B*G, cg, H, W*T)
    s = s.reshape(b, g, cg, h, w, taps)
    if mask is not None:
        m = mask.float().reshape(b, h, w, g, taps).permute(0, 3, 1, 2, 4)
        s = s * m[:, :, None]
    # torchvision's column order: tap-major, then (group, channel)
    cols = s.permute(0, 3, 4, 5, 1, 2).reshape(b * h * w, taps * cin)
    kmat = kernel.permute(2, 3, 1, 0).reshape(taps * cin, cout)
    cols = cols.to(out_dtype)
    out = (cols @ kmat.to(out_dtype)).reshape(b, h, w, cout)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def deform_conv2d_window(x: torch.Tensor, offsets: torch.Tensor,
                         kernel: torch.Tensor,
                         bias: Optional[torch.Tensor] = None,
                         mask: Optional[torch.Tensor] = None, kh: int = 3,
                         kw: int = 3, deform_groups: int = 1,
                         max_abs_offset: float = 5.0) -> torch.Tensor:
    """``deform_conv2d`` under the JAX package's name for its bounded-offset
    form (``max_abs_offset`` is the bound that form needs; the result does
    not depend on it)."""
    del max_abs_offset
    return deform_conv2d(x, offsets, kernel, bias, mask, kh, kw,
                         deform_groups)
