"""Pose2Video pipeline: prepare → host step loop → decode.

Counterpart of ``mimo_tpu/pipelines/pose2vid.py``: ``prepare_conditioning``
(CLIP embed, VAE encodes, pose guider, one reference-UNet pass writing the
attention banks), ``_accumulate_step`` (all windows of one DDIM step
through the denoising UNet, overlap averaging with a per-frame counter,
CFG) and ``generate_host_loop`` (the step loop on the host, then the
optional latent interpolation of ``pipelines/interp.py``, then the decode).
``vae_chunk`` bounds the full-resolution VAE passes with a Python loop in
place of ``lax.map``. The scanned ``generate_fn`` is not ported: its host
loop is the one the JAX package runs too.

Sharding over a ``parallel.ProcessMesh`` (one process a rank; the modes of
``mimo_tpu/parallel/mesh.py``), chosen by ``mesh_axis`` / ``frame_axis``:

- window DP (``mesh_axis``): every rank holds the whole clip's latents and
  runs its share of each chunk's windows; the fp32 predictions are
  all-gathered and added in window order with ``accumulate_windows``, so
  the sum is the one a single process takes (an all-reduce would add in
  an order set by the ranks). The ragged tail of a window count that does
  not divide the axis runs as one frame-sharded call over the axis, so no
  weight-0 padded window runs (``_effective_chunk``).
- frame parallelism (``frame_axis`` alone; the flagship clip has one
  window): each rank holds its F/n frames of the latents, background
  latents and pose features; the VAE encode, the pose guider, the UNet
  and the decode run on them, the motion modules' temporal attention
  swaps frame- for spatial-sharding with one all-to-all each way
  (``models/unet.py``), and the DDIM step is elementwise. CLIP, the
  reference frame and the reference UNet are replicated.
- 2-D (both; long clips): windows split over ``mesh_axis`` and each
  window's frames over ``frame_axis``; the encoders and the decode split
  the clip's frames over ``frame_axis`` (padded with its last frame to a
  multiple of it) and gather them.

``generate_host_loop`` returns the whole video on every rank.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from mimo_tpu_torch.config import MIMOConfig
from mimo_tpu_torch.models import clip_vision as CV
from mimo_tpu_torch.models import pose_guider as PG
from mimo_tpu_torch.models import unet as U
from mimo_tpu_torch.models import vae as V
from mimo_tpu_torch.parallel import comm
from mimo_tpu_torch.pipelines.context import compute_windows
from mimo_tpu_torch.pipelines.interp import interpolate_latents
from mimo_tpu_torch.schedulers.ddim import DDIM
from mimo_tpu_torch.utils import profiling

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
    pad_windows_to: int = 1              # window count made a multiple of
                                         # this with weight-0 windows
    mesh_axis: Optional[str] = None      # split the windows over this axis
    frame_axis: Optional[str] = None     # split the frames over this axis
    mesh: Any = None                     # parallel.ProcessMesh
    vae_chunk: int = 8                   # frames per VAE call
    interpolation_factor: int = 0        # latent frame-rate upsampling
                                         # before decode (< 2: none)
    interpolation_mode: str = "slerp"    # "slerp" or linear

    @property
    def do_cfg(self) -> bool:
        return self.guidance_scale > 1.0

    @property
    def mode(self) -> str:
        """"plain", "window" (DP), "frame" or "2d"."""
        if self.mesh is None:
            if self.mesh_axis or self.frame_axis:
                raise ValueError("mesh_axis / frame_axis need a mesh")
            return "plain"
        if self.mesh_axis and self.frame_axis:
            return "2d"
        if self.frame_axis:
            return "frame"
        if self.mesh_axis:
            return "window"
        raise ValueError("a mesh needs mesh_axis or frame_axis")


def clip_timings(clock: profiling.PhaseClock) -> Dict[str, Any]:
    """The clip's record, as ``Runner.last_timings`` holds it, from the
    marks of ``generate_host_loop``: ``prepare``, ``step_mean``, ``decode``
    and ``step_ms`` (each step) in ms on the device's timeline, ``steps``,
    then ``clock.record()``'s ``clip``, ``spans`` (host) and ``h2d_bytes``
    / ``d2h_bytes``."""
    ms = clock.durations_ms()
    step_ms = [v for k, v in ms.items() if k.startswith("step")]
    return {"prepare": ms["prepare"],
            "step_mean": sum(step_ms) / len(step_ms),
            "decode": ms["decode"], "steps": len(step_ms),
            "step_ms": step_ms, **clock.record()}


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
                           pcfg.context_stride, pcfg.context_overlap,
                           pad_to_multiple=st.pad_windows_to)


def _frame_block(st: Pose2VideoStatic, length: int) -> slice:
    """This rank's block of ``length`` frames on the frame axis."""
    return comm.local_slice(length, st.mesh.size(st.frame_axis),
                            st.mesh.index(st.frame_axis))


def prepare_conditioning(params: Params, st: Pose2VideoStatic,
                         ref_image: torch.Tensor, pose_video: torch.Tensor,
                         bk_video: torch.Tensor,
                         clip_pixels: torch.Tensor) -> Dict[str, Any]:
    """The once-per-generation encoders.

    ref_image (H, W, 3) in [-1, 1]; pose_video (F, H, W, 3) in [0, 1];
    bk_video (F, H, W, 3) in [-1, 1]; clip_pixels (224, 224, 3)
    CLIP-normalized. With a frame axis the VAE encode of the background
    frames and the pose guider run on this rank's block of frames: kept
    there in "frame" mode (the frames must split evenly), gathered over the
    frame axis in "2d" mode (``comm.gather_blocks``: the clip padded with
    its last frame). Each encoder runs in a profiler range of its own,
    ``pipeline.prepare.<encoder>``."""
    cfg = st.cfg
    with profiling.annotate("pipeline.prepare.clip"):
        image_embeds = CV.clip_image_embed(params["clip"], cfg.clip_vision,
                                           clip_pixels[None])      # (1, 768)
    ctx_cond = image_embeds[:, None, :]
    ctx_uncond = torch.zeros_like(ctx_cond)

    def encode(bk):
        # the reference frame rides the first VAE chunk (on every rank)
        latents = chunked_apply(
            lambda x: V.encode_mean(params["vae"], cfg.vae, x),
            torch.cat([ref_image[None], bk], dim=0), st.vae_chunk)
        return latents[:1], latents[1:]

    def pose_guider(pose):
        return PG.pose_guider_apply(params["pose_guider"], pose[None])[0]

    if st.mode == "2d":
        group = st.mesh.group(st.frame_axis)
        refs = []

        def encode_block(bk):
            ref, lat = encode(bk)
            refs.append(ref)
            return lat

        with profiling.annotate("pipeline.prepare.vae_encode"):
            bk_latents = comm.gather_blocks(encode_block, bk_video, group)
        ref_latents = refs[0]
        with profiling.annotate("pipeline.prepare.pose_guider"):
            pose_fea = comm.gather_blocks(pose_guider, pose_video, group)
    else:
        if st.mode == "frame":
            block = _frame_block(st, bk_video.shape[0])
            bk_video, pose_video = bk_video[block], pose_video[block]
        with profiling.annotate("pipeline.prepare.vae_encode"):
            ref_latents, bk_latents = encode(bk_video)
        with profiling.annotate("pipeline.prepare.pose_guider"):
            pose_fea = pose_guider(pose_video)

    # reference UNet pass (t=0) writes banks; batch 2 = [uncond; cond]
    if st.do_cfg:
        ref_in = torch.cat([ref_latents, ref_latents], dim=0)
        ref_ctx = torch.cat([ctx_uncond, ctx_cond], dim=0)
    else:
        ref_in, ref_ctx = ref_latents, ctx_cond
    with profiling.annotate("pipeline.prepare.reference_unet"):
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
                           w_idx: torch.Tensor, group=None,
                           frames_global: Optional[int] = None
                           ) -> torch.Tensor:
    """UNet forward over one chunk of windows. w_idx: (chunk, cs) frame
    indices into ``latents`` and the conditioning. Returns (chunk[×2 under
    CFG], cs, h, w, 4), [uncond; cond]. With ``group`` the frames are this
    rank's block of each window's ``frames_global``
    (``_frame_sharded_unet``)."""
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
    if group is None:
        return U.unet3d_apply(params_du, st.cfg.denoising_unet, x, t, ctx,
                              posex, cond["cond_banks"], cfg_split=st.do_cfg)
    return _frame_sharded_unet(params_du, st, group, x, t, ctx, posex,
                               cond["cond_banks"], frames_global)


def _frame_sharded_unet(params_du: Params, st: Pose2VideoStatic, group, x,
                        t, ctx, posex, banks, frames_global: int):
    """The UNet on this rank's frames of each window (x: (B, cs/n, ...)):
    every op is frame-local but the motion modules' temporal attention,
    which swaps frame- for spatial-sharding over ``group``. The window
    batch is not split, so the [uncond; cond] halves stay whole."""
    n = comm.axis_size(group)
    if frames_global % n:
        raise ValueError(f"frame-sharded UNet: {frames_global} window frames "
                         f"do not split over {n} ranks")
    if x.shape[1] * n != frames_global:
        raise ValueError(f"frame-sharded UNet: {x.shape[1]} local frames of "
                         f"{frames_global} on {n} ranks")
    return U.unet3d_apply(params_du, st.cfg.denoising_unet, x, t, ctx, posex,
                          banks, cfg_split=st.do_cfg, group=group,
                          frames_global=frames_global)


def _gather_windows(pred: torch.Tensor, group, do_cfg: bool) -> torch.Tensor:
    """Every rank's windows' predictions, in window order: (n·w[×2], ...)
    from each rank's (w[×2], ...), [uncond; cond] halves kept."""
    if do_cfg:
        return comm.all_gather(pred.unflatten(0, (2, -1)), group,
                               axis=1).flatten(0, 1)
    return comm.all_gather(pred, group, axis=0)


def _unet_call(params_du: Params, st: Pose2VideoStatic, cond: Dict[str, Any],
               latents: torch.Tensor, t, win: np.ndarray,
               tail: bool = False) -> Tuple[np.ndarray, torch.Tensor]:
    """One chunk's UNet predictions, by sharding mode. Returns (the frame
    indices of ``latents`` they belong to, (w[×2], cs', h, w, 4) fp32):

    - "plain": every window of the chunk;
    - "window": this rank's windows, then every rank's gathered in window
      order; ``tail``: every window of the chunk as one frame-sharded call
      over ``mesh_axis`` (the ragged remainder, ``_effective_chunk``);
    - "frame": this rank's frames of every window, on its own latents
      (each window's block of frames must be this rank's block of the
      clip: one window over the whole clip);
    - "2d": this rank's windows on ``mesh_axis`` and their frames on
      ``frame_axis``, gathered over both."""
    dev = latents.device
    mode = st.mode

    def run(w, group=None):
        idx = torch.as_tensor(w, dtype=torch.long, device=dev)
        if group is None:
            pred = _run_unet_window_chunk(params_du, st, cond, latents, t,
                                          idx)
        else:
            pred = _run_unet_window_chunk(params_du, st, cond, latents, t,
                                          idx, group=group,
                                          frames_global=win.shape[1])
        return pred.float()

    def frames_of(w, axis):
        return w[:, comm.local_slice(w.shape[1], st.mesh.size(axis),
                                     st.mesh.index(axis))]

    if mode == "plain":
        return win, run(win)
    if mode == "window" and tail:
        group = st.mesh.group(st.mesh_axis)
        pred = run(frames_of(win, st.mesh_axis), group)
        return win, comm.all_gather(pred, group, axis=1)
    if mode == "frame":
        w = frames_of(win, st.frame_axis)
        lo = _frame_block(st, st.num_frames).start
        local = w - lo
        if (local < 0).any() or (local >= latents.shape[0]).any():
            raise ValueError(
                "frame mode needs each window's frame block on its rank "
                "(one window over the whole clip); use the 2-D mode (both "
                "mesh_axis and frame_axis) for several windows")
        return local, run(local, st.mesh.group(st.frame_axis))
    dgroup = st.mesh.group(st.mesh_axis)
    w = win[comm.local_slice(win.shape[0], st.mesh.size(st.mesh_axis),
                             st.mesh.index(st.mesh_axis))]
    if mode == "window":
        pred = run(w)
    else:
        fgroup = st.mesh.group(st.frame_axis)
        pred = comm.all_gather(run(frames_of(w, st.frame_axis), fgroup),
                               fgroup, axis=1)
    return win, _gather_windows(pred, dgroup, st.do_cfg)


def _effective_chunk(st: Pose2VideoStatic, wn: int) -> int:
    """Windows a UNet call. An explicit ``window_chunk`` wins; otherwise
    all windows at once, but in window-DP mode the largest multiple of the
    axis size, so the ragged remainder runs as the frame-sharded tail of
    ``_accumulate_step`` instead of as weight-0 padding."""
    if st.window_chunk:
        return st.window_chunk
    if st.mode == "window":
        n = st.mesh.size(st.mesh_axis)
        return max(n, wn - wn % n)
    return wn


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
    CFG. In "frame" mode ``latents`` and ``counter`` are this rank's
    frames.

    In window-DP mode a ragged window count runs its W % chunk leftover
    windows as one frame-sharded call over the axis (every rank does 1/n
    of the real work), where each window's frames split over the axis;
    otherwise ``pad_windows_to`` must make the count even."""
    wn, cs = win.shape
    chunk = _effective_chunk(st, wn)
    n_tail = 0
    if st.mode in ("window", "2d"):
        n = st.mesh.size(st.mesh_axis)
        if st.mode == "window" and wn % chunk and cs % n == 0:
            n_tail = wn % chunk
        if chunk % n or (wn - n_tail) % chunk:
            raise ValueError(
                f"{wn} windows in chunks of {chunk} do not split over "
                f"{n} ranks: window_chunk and pad_windows_to must be "
                f"multiples of {n}")
    full = wn - n_tail
    dev = latents.device
    nsum_u = torch.zeros(latents.shape, dtype=torch.float32, device=dev)
    nsum_c = torch.zeros_like(nsum_u)

    def add(c0, c1, tail=False):
        w_idx, pred = _unet_call(params_du, st, cond, latents, t,
                                 win[c0:c1], tail)
        w_idx = torch.as_tensor(w_idx, dtype=torch.long, device=dev)
        wt = torch.as_tensor(wts[c0:c1], device=dev)
        size = w_idx.shape[0]
        if st.do_cfg:
            accumulate_windows(nsum_u, pred[:size], w_idx, wt)
            accumulate_windows(nsum_c, pred[size:], w_idx, wt)
        else:
            accumulate_windows(nsum_c, pred, w_idx, wt)

    for c0 in range(0, full, chunk):
        add(c0, min(c0 + chunk, full))
    if n_tail:
        add(full, wn, tail=True)
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


def _decode_frames(params: Params, st: Pose2VideoStatic,
                   latents: torch.Tensor) -> torch.Tensor:
    """The whole clip's video from the whole clip's latents on every rank:
    with a frame axis each rank decodes its block of frames and the blocks
    are gathered. In "frame" mode the frames must split evenly over the
    axis, as they do under the JAX package's shard_map; in "2d" mode the
    clip is padded with its last frame (``comm.gather_blocks``)."""
    if st.mode == "2d":
        return comm.gather_blocks(lambda z: decode_frames(params, st, z),
                                  latents, st.mesh.group(st.frame_axis))
    if st.mode != "frame":
        return decode_frames(params, st, latents)
    n = st.mesh.size(st.frame_axis)
    if latents.shape[0] % n:
        raise ValueError(f"frame-sharded decode: {latents.shape[0]} frames "
                         f"do not split over {n} ranks")
    video = decode_frames(params, st, latents[_frame_block(
        st, latents.shape[0])])
    return comm.all_gather(video, st.mesh.group(st.frame_axis), axis=0)


@torch.inference_mode()
def generate_host_loop(params: Params, st: Pose2VideoStatic,
                       ref_image: torch.Tensor, pose_video: torch.Tensor,
                       bk_video: torch.Tensor, clip_pixels: torch.Tensor,
                       noise: torch.Tensor,
                       clock: Optional[profiling.PhaseClock] = None
                       ) -> torch.Tensor:
    """Full generation: conditioning → DDIM loop on the host → decode.

    noise: (F, h, w, 4) standard normal (the caller owns the generator;
    every rank passes the whole clip's inputs and noise). Returns the
    video (F', H, W, 3) in [0, 1], F' = (F-1)*factor + 1 with
    ``st.interpolation_factor`` >= 2, else F, on every rank. ``clock``, if
    given, is marked at "start", "prepare", "step0".."stepN-1" and
    "decode". The host's enqueue of each phase runs in a profiler range,
    ``pipeline.prepare``, ``pipeline.step`` (each step) and
    ``pipeline.decode``."""
    mark = clock.mark if clock is not None else (lambda name: None)
    mark("start")
    with profiling.annotate("pipeline.prepare"):
        ddim = DDIM.create(st.cfg.pipeline.scheduler, st.num_inference_steps)
        win, wts = make_windows(st)
        counter = torch.as_tensor(_window_counter(st.num_frames, win, wts),
                                  device=noise.device)
        if st.mode == "frame":
            # this rank's frames of the latents and the counter
            block = _frame_block(st, st.num_frames)
            noise, counter = noise[block], counter[block]
        cond = prepare_conditioning(params, st, ref_image, pose_video,
                                    bk_video, clip_pixels)
    mark("prepare")
    latents = noise * ddim.init_noise_sigma
    for i in range(ddim.num_steps):
        with profiling.annotate("pipeline.step"):
            t = float(ddim.timesteps[i])
            v = _accumulate_step(params["denoising_unet"], st, cond, latents,
                                 t, win, wts, counter)
            latents = ddim.step_v(v, i, latents)
        mark(f"step{i}")
    with profiling.annotate("pipeline.decode"):
        if st.mode == "frame" and st.interpolation_factor < 2:
            # decode this rank's frames as they are, then gather the video
            video = comm.all_gather(decode_frames(params, st, latents),
                                    st.mesh.group(st.frame_axis), axis=0)
        else:
            if st.mode == "frame":
                # the interpolation mixes neighbouring frames: gather first
                latents = comm.all_gather(
                    latents, st.mesh.group(st.frame_axis), axis=0)
            latents = interpolate_latents(latents, st.interpolation_factor,
                                          st.interpolation_mode)
            video = _decode_frames(params, st, latents)
    mark("decode")
    return video
