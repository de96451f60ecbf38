"""MIMO's generation and its two entries, in plain float32: the
conditioning (CLIP, VAE encode, pose guider, reference UNet banks), the
DDIM loop with CFG over overlapping context windows, the VAE decode; then
``animate`` (human crop) and ``edit`` (ROI shots and paste-back) around it.

Everything the program derives from the inputs is worked out again here:
the crops, pads, shots and resizes, the CLIP pixels, the initial noise
(drawn from the clip's seed with a ``torch.Generator`` on the device, as
MIMO's pipeline draws it), the schedule and the windows.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from benchmark.reference import encoders as E
from benchmark.reference import frames as FR
from benchmark.reference import nn
from benchmark.reference import unet as U

Params = Dict[str, Any]

VAE_CHUNK = 8   # frames a VAE call, to bound memory


# ---------------------------------------------------------------------------
# schedule and windows
# ---------------------------------------------------------------------------


def ddim_tables(sched: Dict[str, Any], steps: int):
    """(timesteps, alpha_t, alpha_prev) of DDIM with trailing spacing, a
    scaled-linear beta schedule rescaled to zero terminal SNR."""
    T = sched["num_train_timesteps"]
    betas = np.linspace(sched["beta_start"] ** 0.5, sched["beta_end"] ** 0.5,
                        T, dtype=np.float64) ** 2
    acp = np.cumprod(1.0 - betas)
    if sched["rescale_betas_zero_snr"]:
        s = np.sqrt(acp)
        s = (s - s[-1]) * (s[0] / (s[0] - s[-1]))
        acp = s ** 2
    ts = np.round(np.arange(T, 0, -T / steps)).astype(np.int64) - 1
    prev = ts - T // steps
    a_prev = np.where(prev >= 0, acp[np.clip(prev, 0, T - 1)], 1.0)
    return ts, acp[ts], a_prev


def ddim_step_v(v: torch.Tensor, x: torch.Tensor, a_t: float,
                a_p: float) -> torch.Tensor:
    """One eta = 0 DDIM update under v-prediction."""
    x0 = a_t ** 0.5 * x - (1 - a_t) ** 0.5 * v
    eps = a_t ** 0.5 * v + (1 - a_t) ** 0.5 * x
    return a_p ** 0.5 * x0 + (1 - a_p) ** 0.5 * eps


def windows(num_frames: int, size: int, overlap: int) -> List[List[int]]:
    """Context windows of ``size`` frames, ``overlap`` shared, wrapping
    around the clip (MIMO's uniform context scheduler at step 0, stride
    1)."""
    if num_frames <= size:
        return [list(range(num_frames))]
    return [[e % num_frames for e in range(j, j + size)]
            for j in range(0, num_frames, size - overlap)]


# ---------------------------------------------------------------------------
# generation
# ---------------------------------------------------------------------------


def _chunked(fn, x: torch.Tensor) -> torch.Tensor:
    return torch.cat([fn(x[i:i + VAE_CHUNK])
                      for i in range(0, x.shape[0], VAE_CHUNK)], dim=0)


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


@torch.no_grad()
def generate(params: Params, cfg: Dict[str, Any], ref_image: np.ndarray,
             pose_frames: Sequence[np.ndarray],
             bk_frames: Sequence[np.ndarray], *, width: int, height: int,
             steps: int, guidance: float, seed: int, device) -> np.ndarray:
    """The video (F, height, width, 3) in [0, 1] of a prepared reference
    image and pose / background frames of any size (resized here)."""
    m, pl = cfg, cfg["pipeline"]
    f = len(pose_frames)

    def frames01(fs):
        return _tensor(np.stack([FR.resize_frame(x, width, height)
                                 for x in fs]), device).float() / 255.0

    ref = frames01([ref_image])[0] * 2 - 1
    pose = frames01(pose_frames)
    bk = frames01(bk_frames) * 2 - 1
    cs = m["clip_vision"]["image_size"]
    clip_px = E.clip_preprocess(
        _tensor(FR.resize_frame(ref_image, cs, cs), device).float() / 255.0)
    ds = 2 ** (len(m["vae"]["block_out_channels"]) - 1)
    gen = torch.Generator(device=device).manual_seed(seed)
    noise = torch.randn((f, height // ds, width // ds, 4), generator=gen,
                        device=device)

    # conditioning
    ctx_c = E.clip_image_embed(params["clip"], m["clip_vision"],
                               clip_px[None])[:, None, :]
    ctx_u = torch.zeros_like(ctx_c)
    lat = _chunked(lambda x: E.vae_encode_mean(params["vae"], m["vae"], x),
                   torch.cat([ref[None], bk], dim=0))
    ref_lat, bk_lat = lat[:1], lat[1:]
    pose_fea = E.pose_guider(params["pose_guider"], pose)
    banks = U.unet2d_banks(params["reference_unet"], m["reference_unet"],
                           torch.cat([ref_lat, ref_lat]),
                           torch.cat([ctx_u, ctx_c]))
    cond_banks = [b[-1] for b in banks]

    # denoising
    ts, a_t, a_p = ddim_tables(pl["scheduler"], steps)
    win = windows(f, min(pl["context_frames"], f), pl["context_overlap"])
    counter = torch.zeros((f,), device=device)
    for w in win:
        counter[w] += 1
    counter = counter[:, None, None, None]
    idx = torch.tensor(win, device=device)
    nw = len(win)
    x = noise
    for i in range(steps):
        lat_w = x[idx]
        xin = torch.cat([torch.cat([lat_w, lat_w]),
                         torch.cat([bk_lat[idx], bk_lat[idx]])], dim=-1)
        pred = U.unet3d(params["denoising_unet"], m["denoising_unet"], xin,
                        float(ts[i]),
                        torch.cat([ctx_u.expand(nw, -1, -1),
                                   ctx_c.expand(nw, -1, -1)]),
                        torch.cat([pose_fea[idx], pose_fea[idx]]),
                        cond_banks, cfg_split=True)
        v_u, v_c = torch.zeros_like(x), torch.zeros_like(x)
        for j in range(nw):
            v_u.index_add_(0, idx[j], pred[j])
            v_c.index_add_(0, idx[j], pred[nw + j])
        v_u, v_c = v_u / counter, v_c / counter
        x = ddim_step_v(v_u + guidance * (v_c - v_u), x, float(a_t[i]),
                        float(a_p[i]))
    video = _chunked(lambda z: E.vae_decode(params["vae"], m["vae"], z), x)
    return torch.clamp(video * 0.5 + 0.5, 0.0, 1.0).cpu().numpy()


# ---------------------------------------------------------------------------
# entries
# ---------------------------------------------------------------------------


def animate(params: Params, cfg: Dict[str, Any], ref_img: np.ndarray,
            pose_frames: Sequence[np.ndarray], *, seed: int, device
            ) -> np.ndarray:
    """run_animate.py: the sdc frames cropped to the person, on white."""
    pl = cfg["pipeline"]
    ref = FR.prep_reference_image(ref_img)
    h, w = pose_frames[0].shape[:2]
    white = [np.full((h, w, 3), 255, np.uint8)] * len(pose_frames)
    pose, bk = FR.crop_human(pose_frames, white)
    pose = [FR.pad_img(p, (0, 0, 0))[0] for p in pose]
    bk = [FR.pad_img(b, (255, 255, 255))[0] for b in bk]
    return generate(params, cfg, ref, pose, bk, width=pl["width"],
                    height=pl["height"], steps=pl["num_inference_steps"],
                    guidance=pl["guidance_scale"], seed=seed, device=device)


def edit(params: Params, cfg: Dict[str, Any], ref_img: np.ndarray,
         sdc: Sequence[np.ndarray], vid: Sequence[np.ndarray],
         bk: Sequence[np.ndarray], occ: Optional[Sequence[np.ndarray]], *,
         seed: int, device) -> List[np.ndarray]:
    """run_edit.py: ROI shots generated at the configured size and pasted
    back into the template's frames."""
    pl = cfg["pipeline"]
    ref = FR.prep_reference_image(ref_img)
    shots, boxes = FR.roi_shots(sdc)
    pose_in, bk_in, pad_info = [], [], []
    for p, b in zip(FR.shot_crops(sdc, shots, boxes),
                    FR.shot_crops(bk, shots, boxes)):
        pose_in.append(FR.pad_img(p, (0, 0, 0))[0])
        bb, pad = FR.pad_img(b, (255, 255, 255))
        bk_in.append(bb)
        pad_info.append((bb.shape[0], bb.shape[1], pad))
    video = generate(params, cfg, ref, pose_in, bk_in, width=pl["width"],
                     height=pl["height"], steps=pl["num_inference_steps"],
                     guidance=pl["guidance_scale"], seed=seed, device=device)
    return FR.composite_back(video, shots, boxes, pad_info, bk, vid, occ)
