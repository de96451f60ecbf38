"""RAFT optical flow.

Counterpart of ``mimo_tpu/decomp/raft.py`` (the reference's
``ProPainter/RAFT``): the feature and context encoders (instance norm, and
eval-mode BatchNorm folded into a fixed affine by the converter), the
all-pairs correlation pyramid in fp32, the motion encoder and separable
conv-GRU, ``iters`` refinement steps (a Python loop where the JAX package
scans) and convex 8x upsampling. ``raft_bi`` runs it forwards and
backwards over a clip (the reference's RAFT_bi).

The pyramid lookup is the reference's ``grid_sample`` over each pixel's
(1, hl, wl) correlation volume at the (2r + 1)^2 integer offsets around its
coordinate (zero padding, pixel coordinates, ``align_corners=True``): the
semantics of the JAX package's one-hot-matmul formulation, which it made
for the TPU's matrix unit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F

from mimo_tpu_torch.models import layers as L
from mimo_tpu_torch.ops.sampling import sample_nchw

Params = Dict[str, Any]


@dataclass(frozen=True)
class RAFTConfig:
    hidden_dim: int = 128
    context_dim: int = 128
    corr_levels: int = 4
    corr_radius: int = 4
    iters: int = 20
    # encoder channel plan (BasicEncoder): stem 64 -> (64, 96, 128) -> out
    enc_dims: Tuple[int, int, int] = (64, 96, 128)
    fmap_dim: int = 256


def tiny_raft_config() -> RAFTConfig:
    return RAFTConfig(hidden_dim=16, context_dim=16, corr_levels=2,
                      corr_radius=2, iters=3, enc_dims=(8, 12, 16),
                      fmap_dim=16)


# ---------------------------------------------------------------------------
# encoders
# ---------------------------------------------------------------------------


def _inorm_init(c: int, dtype, device) -> Params:
    return {"scale": torch.ones((c,), dtype=dtype, device=device),
            "bias": torch.zeros((c,), dtype=dtype, device=device)}


def _norm(p: Params, x: torch.Tensor, kind: str) -> torch.Tensor:
    """"instance": per-sample, per-channel statistics in fp32 (the feature
    encoder's InstanceNorm2d); "affine": the fixed per-channel scale and
    bias of the context encoder's folded eval-mode BatchNorm2d."""
    xf = x.float()
    if kind == "instance":
        mean = xf.mean(dim=(1, 2), keepdim=True)
        var = xf.var(dim=(1, 2), keepdim=True, unbiased=False)
        xf = (xf - mean) * torch.rsqrt(var + 1e-5)
    return (xf * p["scale"].float() + p["bias"].float()).to(x.dtype)


def _resunit_init(gen, c_in: int, c_out: int, stride: int, dtype) -> Params:
    dev = gen.device
    p = {"conv1": L.conv2d_init(gen, 3, 3, c_in, c_out, dtype=dtype),
         "n1": _inorm_init(c_out, dtype, dev),
         "conv2": L.conv2d_init(gen, 3, 3, c_out, c_out, dtype=dtype),
         "n2": _inorm_init(c_out, dtype, dev),
         "stride": stride}
    if stride != 1 or c_in != c_out:
        p["down"] = L.conv2d_init(gen, 1, 1, c_in, c_out, dtype=dtype)
        p["dn"] = _inorm_init(c_out, dtype, dev)
    return p


def _resunit(p: Params, x: torch.Tensor, kind: str, s: int) -> torch.Tensor:
    h = F.relu(_norm(p["n1"], L.conv2d(p["conv1"], x, stride=s, padding=1),
                     kind))
    h = F.relu(_norm(p["n2"], L.conv2d(p["conv2"], h, padding=1), kind))
    if "down" in p:
        x = _norm(p["dn"], L.conv2d(p["down"], x, stride=s, padding=0), kind)
    return F.relu(x + h)


def _encoder_init(gen, cfg: RAFTConfig, out_dim: int, dtype) -> Params:
    d1, d2, d3 = cfg.enc_dims
    return {
        "stem": L.conv2d_init(gen, 7, 7, 3, d1, dtype=dtype),
        "stem_n": _inorm_init(d1, dtype, gen.device),
        "layer1": [_resunit_init(gen, d1, d1, 1, dtype),
                   _resunit_init(gen, d1, d1, 1, dtype)],
        "layer2": [_resunit_init(gen, d1, d2, 2, dtype),
                   _resunit_init(gen, d2, d2, 1, dtype)],
        "layer3": [_resunit_init(gen, d2, d3, 2, dtype),
                   _resunit_init(gen, d3, d3, 1, dtype)],
        "head": L.conv2d_init(gen, 1, 1, d3, out_dim, dtype=dtype),
    }


def _encoder(p: Params, x: torch.Tensor, kind: str = "instance"):
    h = F.relu(_norm(p["stem_n"], L.conv2d(p["stem"], x, stride=2,
                                           padding=3), kind))
    for layer, s0 in (("layer1", 1), ("layer2", 2), ("layer3", 2)):
        for i, blk in enumerate(p[layer]):
            h = _resunit(blk, h, kind, s0 if i == 0 else 1)
    return L.conv2d(p["head"], h, padding=0)


# ---------------------------------------------------------------------------
# update block
# ---------------------------------------------------------------------------


def _gru_init(gen, hidden: int, in_dim: int, dtype) -> Params:
    def mk(kh, kw):
        return L.conv2d_init(gen, kh, kw, hidden + in_dim, hidden,
                             dtype=dtype)
    return {"z1": mk(1, 5), "r1": mk(1, 5), "q1": mk(1, 5),
            "z2": mk(5, 1), "r2": mk(5, 1), "q2": mk(5, 1)}


def _gru_pass(pz, pr, pq, h, x, pad):
    hx = torch.cat([h, x], dim=-1)
    z = torch.sigmoid(L.conv2d(pz, hx, padding=pad))
    r = torch.sigmoid(L.conv2d(pr, hx, padding=pad))
    q = torch.tanh(L.conv2d(pq, torch.cat([r * h, x], dim=-1), padding=pad))
    return (1 - z) * h + z * q


def _sep_gru(p: Params, h, x):
    """SepConvGRU: a horizontal (1x5) then a vertical (5x1) pass."""
    h = _gru_pass(p["z1"], p["r1"], p["q1"], h, x, (0, 2))
    return _gru_pass(p["z2"], p["r2"], p["q2"], h, x, (2, 0))


def _update_init(gen, cfg: RAFTConfig, dtype) -> Params:
    corr_dim = cfg.corr_levels * (2 * cfg.corr_radius + 1) ** 2
    hd = cfg.hidden_dim

    def conv(kh, kw, ci, co):
        return L.conv2d_init(gen, kh, kw, ci, co, dtype=dtype)
    return {
        "mc1": conv(1, 1, corr_dim, 256),
        "mc2": conv(3, 3, 256, 192),
        "mf1": conv(7, 7, 2, 128),
        "mf2": conv(3, 3, 128, 64),
        "mout": conv(3, 3, 192 + 64, 128 - 2),
        "gru": _gru_init(gen, hd, 128 + cfg.context_dim, dtype),
        "fh1": conv(3, 3, hd, 256),
        "fh2": conv(3, 3, 256, 2),
        "up1": conv(3, 3, hd, 256),
        "up2": conv(1, 1, 256, 64 * 9),
    }


def _motion_encoder(p: Params, flow, corr):
    c = F.relu(L.conv2d(p["mc1"], corr, padding=0))
    c = F.relu(L.conv2d(p["mc2"], c, padding=1))
    f = F.relu(L.conv2d(p["mf1"], flow, padding=3))
    f = F.relu(L.conv2d(p["mf2"], f, padding=1))
    out = F.relu(L.conv2d(p["mout"], torch.cat([c, f], dim=-1), padding=1))
    return torch.cat([out, flow], dim=-1)            # 128 channels


# ---------------------------------------------------------------------------
# correlation pyramid
# ---------------------------------------------------------------------------


def _corr_pyramid(f1: torch.Tensor, f2: torch.Tensor,
                  levels: int) -> List[torch.Tensor]:
    """f1, f2: (B, H, W, D) fp32. Returns the (B*H*W, 1, hl, wl) volumes of
    every level (each 2x2-average-pooled from the one before)."""
    b, h, w, d = f1.shape
    corr = torch.einsum("bxyd,buvd->bxyuv", f1, f2) / (float(d) ** 0.5)
    vol = corr.reshape(b * h * w, 1, h, w)
    pyr = [vol]
    for _ in range(levels - 1):
        vol = F.avg_pool2d(vol, 2, stride=2)
        pyr.append(vol)
    return pyr


def _corr_lookup(pyr: List[torch.Tensor], coords: torch.Tensor,
                 radius: int) -> torch.Tensor:
    """coords: (B, H, W, 2) fp32 (x, y) correspondences. Returns (B, H, W,
    levels * (2r+1)^2): at each level (coordinates over 2^level), the
    volume bilinearly sampled at the coordinate plus every integer offset,
    y offset major, zero outside the volume."""
    b, h, w, _ = coords.shape
    n = b * h * w
    s = 2 * radius + 1
    ks = torch.arange(-radius, radius + 1, device=coords.device,
                      dtype=torch.float32)
    flat = coords.reshape(n, 2).float()
    out = []
    for lvl, vol in enumerate(pyr):
        c = flat / (2.0 ** lvl)
        xs = (c[:, 0, None, None] + ks[None, None, :]).expand(n, s, s)
        ys = (c[:, 1, None, None] + ks[None, :, None]).expand(n, s, s)
        res = sample_nchw(vol, xs, ys, zero_outside=True)   # (N, 1, s, s)
        out.append(res.reshape(b, h, w, s * s))
    return torch.cat(out, dim=-1)


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------


def raft_init(gen: torch.Generator, cfg: RAFTConfig,
              dtype: torch.dtype = torch.float32) -> Params:
    return {"fnet": _encoder_init(gen, cfg, cfg.fmap_dim, dtype),
            "cnet": _encoder_init(gen, cfg, cfg.hidden_dim + cfg.context_dim,
                                  dtype),
            "update": _update_init(gen, cfg, dtype)}


def _upsample_flow(flow: torch.Tensor, up_mask: torch.Tensor) -> torch.Tensor:
    """Convex 8x upsampling: each of a pixel's 8x8 sub-pixels a softmax
    mix of its 3x3 coarse neighbours (x8). flow (B, H, W, 2) fp32."""
    b, h, w, _ = flow.shape
    mask = torch.softmax(up_mask.float().reshape(b, h, w, 64, 9), dim=-1)
    fpad = F.pad(flow, (0, 0, 1, 1, 1, 1))
    neigh = torch.stack([fpad[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
                         for dy in (-1, 0, 1) for dx in (-1, 0, 1)],
                        dim=-2)                       # (B, H, W, 9, 2)
    up = torch.einsum("bhwsn,bhwnc->bhwsc", mask, neigh.float() * 8.0)
    up = up.reshape(b, h, w, 8, 8, 2).permute(0, 1, 3, 2, 4, 5)
    return up.reshape(b, 8 * h, 8 * w, 2).to(flow.dtype)


def raft_flow(p: Params, cfg: RAFTConfig, img1: torch.Tensor,
              img2: torch.Tensor) -> torch.Tensor:
    """img1, img2: (B, H, W, 3) in [-1, 1], H and W multiples of 8. Returns
    the flow (B, H, W, 2) in pixels, fp32."""
    b, h, w, _ = img1.shape
    f1 = _encoder(p["fnet"], img1, kind="instance")
    f2 = _encoder(p["fnet"], img2, kind="instance")
    cnet = _encoder(p["cnet"], img1, kind="affine")
    net = torch.tanh(cnet[..., :cfg.hidden_dim])
    inp = F.relu(cnet[..., cfg.hidden_dim:])

    pyr = _corr_pyramid(f1.float(), f2.float(), cfg.corr_levels)
    h8, w8 = h // 8, w // 8
    gy, gx = torch.meshgrid(
        torch.arange(h8, device=img1.device, dtype=torch.float32),
        torch.arange(w8, device=img1.device, dtype=torch.float32),
        indexing="ij")
    coords0 = torch.stack([gx, gy], -1)[None].expand(b, h8, w8, 2)
    coords = coords0
    up = p["update"]
    for _ in range(cfg.iters):
        corr = _corr_lookup(pyr, coords, cfg.corr_radius)
        flow = coords - coords0
        motion = _motion_encoder(up, flow.to(net.dtype), corr.to(net.dtype))
        x = torch.cat([inp, motion], dim=-1)
        net = _sep_gru(up["gru"], net, x)
        dflow = L.conv2d(up["fh2"], F.relu(L.conv2d(up["fh1"], net,
                                                    padding=1)), padding=1)
        coords = coords + dflow.float()
    up_mask = L.conv2d(up["up2"], F.relu(L.conv2d(up["up1"], net,
                                                  padding=1)), padding=0)
    return _upsample_flow((coords - coords0).float(), up_mask)


def raft_bi(p: Params, cfg: RAFTConfig, frames: torch.Tensor):
    """frames: (T, H, W, 3) in [-1, 1]. Returns (flow_fwd, flow_bwd), each
    (T-1, H, W, 2): the flows from every frame to the next and back."""
    a, b = frames[:-1], frames[1:]
    return raft_flow(p, cfg, a, b), raft_flow(p, cfg, b, a)
