"""Pose2Video pipeline: prepare → host step loop → decode.

Counterpart of ``mimo_tpu/pipelines/pose2vid.py`` (single-device branches):
``prepare_conditioning`` (CLIP embed, VAE encodes, pose guider, one
reference-UNet pass writing the attention banks), ``_accumulate_step`` (all
windows of one DDIM step through the denoising UNet, overlap averaging with
a per-frame counter, CFG) and ``generate_host_loop`` (the step loop on the
host, then the optional latent interpolation of ``pipelines/interp.py``,
then the decode). ``vae_chunk`` bounds the full-resolution VAE passes with
a Python loop in place of ``lax.map``.

Mesh sharding and the scanned ``generate_fn`` are not ported.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from mimo_tpu_torch.config import MIMOConfig
from mimo_tpu_torch.models import clip_vision as CV
from mimo_tpu_torch.models import pose_guider as PG
from mimo_tpu_torch.models import unet as U
from mimo_tpu_torch.models import vae as V
from mimo_tpu_torch.pipelines.context import compute_windows
from mimo_tpu_torch.pipelines.interp import interpolate_latents
from mimo_tpu_torch.schedulers.ddim import DDIM

Params = Dict[str, Any]


@dataclass(frozen=True)
class Pose2VideoStatic:
    """Pipeline configuration of one generation."""

    cfg: MIMOConfig
    num_frames: int
    height: int
    width: int
    num_inference_steps: int
    guidance_scale: float
    window_chunk: Optional[int] = None   # None = all windows at once
    vae_chunk: int = 8                   # frames per VAE call
    interpolation_factor: int = 0        # latent frame-rate upsampling
                                         # before decode (< 2: none)
    interpolation_mode: str = "slerp"    # "slerp" or linear

    @property
    def do_cfg(self) -> bool:
        return self.guidance_scale > 1.0


class PhaseClock:
    """Phase boundaries of one generation: CUDA events on the device's
    timeline when it runs on CUDA, the host clock otherwise. Recording an
    event does not synchronise; ``durations_ms`` does, once."""

    def __init__(self, device: torch.device):
        self.cuda = torch.device(device).type == "cuda"
        self.marks = []

    def mark(self, name: str) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append((name, ev))
        else:
            self.marks.append((name, time.perf_counter()))

    def durations_ms(self) -> Dict[str, float]:
        """{phase: ms} from each mark to the next."""
        if self.cuda:
            self.marks[-1][1].synchronize()
        out = {}
        for (_, a), (name, b) in zip(self.marks, self.marks[1:]):
            out[name] = (a.elapsed_time(b) if self.cuda
                         else (b - a) * 1e3)
        return out


def chunked_apply(fn, x: torch.Tensor, chunk: int) -> torch.Tensor:
    """fn over x in chunks along axis 0 (bounds peak memory of the
    full-resolution VAE passes)."""
    if chunk <= 0 or chunk >= x.shape[0]:
        return fn(x)
    return torch.cat([fn(x[i:i + chunk]) for i in range(0, x.shape[0], chunk)],
                     dim=0)


def make_windows(st: Pose2VideoStatic) -> Tuple[np.ndarray, np.ndarray]:
    pcfg = st.cfg.pipeline
    return compute_windows(st.num_frames,
                           min(pcfg.context_frames, st.num_frames),
                           pcfg.context_stride, pcfg.context_overlap)


def prepare_conditioning(params: Params, st: Pose2VideoStatic,
                         ref_image: torch.Tensor, pose_video: torch.Tensor,
                         bk_video: torch.Tensor,
                         clip_pixels: torch.Tensor) -> Dict[str, Any]:
    """The once-per-generation encoders.

    ref_image (H, W, 3) in [-1, 1]; pose_video (F, H, W, 3) in [0, 1];
    bk_video (F, H, W, 3) in [-1, 1]; clip_pixels (224, 224, 3)
    CLIP-normalized."""
    cfg = st.cfg
    image_embeds = CV.clip_image_embed(params["clip"], cfg.clip_vision,
                                       clip_pixels[None])          # (1, 768)
    ctx_cond = image_embeds[:, None, :]
    ctx_uncond = torch.zeros_like(ctx_cond)

    enc_in = torch.cat([ref_image[None], bk_video], dim=0)
    latents = chunked_apply(
        lambda x: V.encode_mean(params["vae"], cfg.vae, x), enc_in,
        st.vae_chunk)
    ref_latents, bk_latents = latents[:1], latents[1:]
    pose_fea = PG.pose_guider_apply(params["pose_guider"],
                                    pose_video[None])[0]

    # reference UNet pass (t=0) writes banks; batch 2 = [uncond; cond]
    if st.do_cfg:
        ref_in = torch.cat([ref_latents, ref_latents], dim=0)
        ref_ctx = torch.cat([ctx_uncond, ctx_cond], dim=0)
    else:
        ref_in, ref_ctx = ref_latents, ctx_cond
    banks = U.unet2d_apply(params["reference_unet"], cfg.reference_unet,
                           ref_in, 0.0, ref_ctx)
    return {
        "ctx_cond": ctx_cond,
        "ctx_uncond": ctx_uncond,
        "ref_latents": ref_latents,
        "bk_latents": bk_latents,
        "pose_fea": pose_fea,
        "cond_banks": [b[-1] for b in banks],   # cond-written entries
    }


def _window_counter(num_frames: int, win: np.ndarray,
                    wts: np.ndarray) -> np.ndarray:
    """Per-frame overlap counter, (F, 1, 1, 1) fp32."""
    counter = np.zeros((num_frames,), np.float32)
    np.add.at(counter, win.reshape(-1), np.repeat(wts, win.shape[1]))
    return np.maximum(counter, 1e-6)[:, None, None, None]


def _run_unet_window_chunk(params_du: Params, st: Pose2VideoStatic,
                           cond: Dict[str, Any], latents: torch.Tensor, t,
                           w_idx: torch.Tensor) -> torch.Tensor:
    """UNet forward over one chunk of windows. w_idx: (chunk, cs) frame
    indices. Returns (chunk[×2 under CFG], cs, h, w, 4), [uncond; cond]."""
    chunk = w_idx.shape[0]
    lat_w = latents[w_idx]
    bk_w = cond["bk_latents"][w_idx]
    pose_w = cond["pose_fea"][w_idx]
    ctx_c = cond["ctx_cond"].expand(chunk, -1, -1)
    if st.do_cfg:
        x = torch.cat([lat_w, lat_w], dim=0)
        bkx = torch.cat([bk_w, bk_w], dim=0)
        posex = torch.cat([pose_w, pose_w], dim=0)
        ctx = torch.cat([cond["ctx_uncond"].expand(chunk, -1, -1), ctx_c],
                        dim=0)
    else:
        x, bkx, posex, ctx = lat_w, bk_w, pose_w, ctx_c
    # 8-channel input: noise ‖ background latents
    x = torch.cat([x, bkx], dim=-1)
    return U.unet3d_apply(params_du, st.cfg.denoising_unet, x, t, ctx, posex,
                          cond["cond_banks"], cfg_split=st.do_cfg)


def accumulate_windows(nsum: torch.Tensor, preds: torch.Tensor,
                       w_idx: torch.Tensor, wts: torch.Tensor) -> None:
    """nsum[w_idx[i]] += wts[i] * preds[i] for every window i, in window
    order, in place. nsum (F, ...) fp32; preds (W, cs, ...); w_idx (W, cs)
    frame indices; wts (W,).

    One ``index_add_`` per window: the frames of one window are distinct,
    so no call adds twice to one row, and the order of the adds to a frame
    that several windows share is the window order. A single call over
    overlapping windows would add with atomics in no fixed order on CUDA,
    and two runs of one clip could differ in their bits."""
    for i in range(w_idx.shape[0]):
        nsum.index_add_(0, w_idx[i], preds[i] * wts[i])


def _accumulate_step(params_du: Params, st: Pose2VideoStatic,
                     cond: Dict[str, Any], latents: torch.Tensor, t,
                     win: np.ndarray, wts: np.ndarray,
                     counter: torch.Tensor) -> torch.Tensor:
    """One denoise step's combined v-prediction: every window chunk,
    weighted scatter-add in window order, divide by the overlap counter,
    CFG."""
    wn = win.shape[0]
    chunk = st.window_chunk or wn
    dev = latents.device
    nsum_u = torch.zeros(latents.shape, dtype=torch.float32, device=dev)
    nsum_c = torch.zeros_like(nsum_u)
    for c0 in range(0, wn, chunk):
        w_idx = torch.as_tensor(win[c0:c0 + chunk], dtype=torch.long,
                                device=dev)
        size = w_idx.shape[0]
        wt = torch.as_tensor(wts[c0:c0 + chunk], device=dev)
        pred = _run_unet_window_chunk(params_du, st, cond, latents, t,
                                      w_idx).float()
        if st.do_cfg:
            accumulate_windows(nsum_u, pred[:size], w_idx, wt)
            accumulate_windows(nsum_c, pred[size:], w_idx, wt)
        else:
            accumulate_windows(nsum_c, pred, w_idx, wt)
    if st.do_cfg:
        v_u, v_c = nsum_u / counter, nsum_c / counter
        return v_u + st.guidance_scale * (v_c - v_u)
    return nsum_c / counter


def decode_frames(params: Params, st: Pose2VideoStatic,
                  latents: torch.Tensor) -> torch.Tensor:
    """VAE decode in ``vae_chunk`` frame chunks -> video in [0, 1]."""
    images = chunked_apply(lambda z: V.decode(params["vae"], st.cfg.vae, z),
                           latents, st.vae_chunk)
    return torch.clamp(images * 0.5 + 0.5, 0.0, 1.0)


@torch.inference_mode()
def generate_host_loop(params: Params, st: Pose2VideoStatic,
                       ref_image: torch.Tensor, pose_video: torch.Tensor,
                       bk_video: torch.Tensor, clip_pixels: torch.Tensor,
                       noise: torch.Tensor,
                       clock: Optional[PhaseClock] = None) -> torch.Tensor:
    """Full generation: conditioning → DDIM loop on the host → decode.

    noise: (F, h, w, 4) standard normal (the caller owns the generator).
    Returns the video (F', H, W, 3) in [0, 1], F' = (F-1)*factor + 1 with
    ``st.interpolation_factor`` >= 2, else F. ``clock``, if given, is
    marked at "start", "prepare", "step0".."stepN-1" and "decode"."""
    mark = clock.mark if clock is not None else (lambda name: None)
    mark("start")
    ddim = DDIM.create(st.cfg.pipeline.scheduler, st.num_inference_steps)
    win, wts = make_windows(st)
    counter = torch.as_tensor(_window_counter(st.num_frames, win, wts),
                              device=noise.device)
    cond = prepare_conditioning(params, st, ref_image, pose_video, bk_video,
                                clip_pixels)
    mark("prepare")
    latents = noise * ddim.init_noise_sigma
    for i in range(ddim.num_steps):
        t = float(ddim.timesteps[i])
        v = _accumulate_step(params["denoising_unet"], st, cond, latents, t,
                             win, wts, counter)
        latents = ddim.step_v(v, i, latents)
        mark(f"step{i}")
    latents = interpolate_latents(latents, st.interpolation_factor,
                                  st.interpolation_mode)
    video = decode_frames(params, st, latents)
    mark("decode")
    return video
