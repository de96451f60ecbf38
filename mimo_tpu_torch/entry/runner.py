"""Host-side runner: weights, reference-image prep, one generation.

Counterpart of ``mimo_tpu/entry/runner.py``: ``init_random_params``,
``load_params``, ``prep_reference_image`` and ``Runner.generate``. The
frames go to the device once as uint8 and are resized and normalised there
(``Runner.inputs``); the device runs ``pipelines.pose2vid.generate_host_loop``
(``Runner.run``). ``Runner.clip`` opens a clip's span recorder
(``profiling.PhaseClock``) for an entry call.
"""

from __future__ import annotations

import contextlib
import itertools
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mimo_tpu_torch.config import MIMOConfig
from mimo_tpu_torch.models import clip_vision as CV
from mimo_tpu_torch.models import pose_guider as PG
from mimo_tpu_torch.models import unet as U
from mimo_tpu_torch.models import vae as V
from mimo_tpu_torch.pipelines import pose2vid
from mimo_tpu_torch.utils import frames as FU
from mimo_tpu_torch.utils import profiling
from mimo_tpu_torch.weights import bridge

# a generation's static description and its device inputs (Runner.inputs)
Job = Tuple[pose2vid.Pose2VideoStatic, Tuple[torch.Tensor, ...]]


def init_random_params(cfg: MIMOConfig, generator: torch.Generator,
                       dtype: torch.dtype = torch.bfloat16) -> Dict[str, Any]:
    """Random weights at the config's width, drawn on the generator's
    device with the JAX initialisers' bounds."""
    return {
        "reference_unet": U.unet_init(generator, cfg.reference_unet, dtype),
        "denoising_unet": U.unet_init(generator, cfg.denoising_unet, dtype),
        "pose_guider": PG.pose_guider_init(generator, cfg.pose_guider, dtype),
        "vae": V.vae_init(generator, cfg.vae, dtype),
        "clip": CV.clip_vision_init(generator, cfg.clip_vision, dtype),
    }


def load_params(path: str, device="cuda",
                dtype: torch.dtype = torch.bfloat16) -> Dict[str, Any]:
    """Load a converted .npz weight bundle (weights/convert.py)
    onto ``device``: the card unless the caller asks for the CPU."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("load_params: no CUDA device; pass device='cpu' "
                           "to load the weights onto the CPU")
    return bridge.load_npz(path, device=device, dtype=dtype)


def segment_reference(img: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Reference-image matting heuristic: background colour from the image
    border; pixels far from it are foreground. Returns (rgb_on_white,
    mask[0/255])."""
    border = np.concatenate([
        img[0].reshape(-1, 3), img[-1].reshape(-1, 3),
        img[:, 0].reshape(-1, 3), img[:, -1].reshape(-1, 3)], axis=0)
    bg = np.median(border.astype(np.float32), axis=0)
    dist = np.linalg.norm(img.astype(np.float32) - bg, axis=-1)
    mask = FU.clean_mask((dist > 40).astype(np.uint8) * 255)
    out = img.copy()
    out[mask == 0] = 255
    return out, mask


def prep_reference_image(img: np.ndarray) -> np.ndarray:
    """segment → crop to person → pad to white square."""
    seg, mask = segment_reference(img)
    if mask.any():
        seg = FU.crop_img(seg, mask)
    seg, _ = FU.pad_img(seg, (255, 255, 255))
    return seg


@dataclass
class Runner:
    cfg: MIMOConfig
    params: Dict[str, Any]
    device: torch.device
    dtype: torch.dtype = torch.bfloat16
    # the last clip's record (pose2vid.clip_timings): prepare, step_mean,
    # decode and step_ms (device, ms), steps, clip and spans (host),
    # h2d_bytes and d2h_bytes (the clip's copies between host and device)
    last_timings: Dict[str, Any] = field(default_factory=dict)
    # the id of the last clip begun; every span of a clip carries it
    clip_id: int = 0
    # sharding over a parallel.ProcessMesh (Pose2VideoStatic's fields of
    # the same names); every rank calls generate with the same inputs
    mesh: Any = None
    mesh_axis: Optional[str] = None
    frame_axis: Optional[str] = None
    pad_windows_to: int = 1

    def clock(self) -> profiling.PhaseClock:
        """A span recorder for the next clip."""
        self.clip_id += 1
        return profiling.PhaseClock(self.device, clip=self.clip_id)

    @contextlib.contextmanager
    def clip(self, name: str):
        """One entry call: yields a new clip's recorder with its root span
        ``name`` open; ``last_timings`` takes the clip's record when the
        block returns."""
        clock = self.clock()
        with clock.span(name):
            yield clock
        self.last_timings = pose2vid.clip_timings(clock)

    def upload(self, frames: Sequence[np.ndarray],
               clock: profiling.PhaseClock) -> torch.Tensor:
        """Host frames of one shape as one uint8 (F, ...) tensor on the
        device (``FU.upload_frames``), counted in ``clock``."""
        out = FU.upload_frames(frames, self.device)
        clock.copied("h2d", out.nbytes)
        return out

    def _batches(self, frames, clock) -> List[torch.Tensor]:
        """Frames as uint8 batches of one size each on the device: an
        (F, H, W, 3) tensor on it, a list of such tensors (e.g. one a
        shot), or host (H, W, 3) frames, each run of one size uploaded
        once."""
        if torch.is_tensor(frames):
            return [frames]
        if torch.is_tensor(frames[0]):
            return list(frames)
        return [self.upload(list(run), clock)
                for _, run in itertools.groupby(frames, key=np.shape)]

    def inputs(self, ref_image: np.ndarray, pose_frames, bk_frames, *,
               width: int, height: int, steps: int, cfg_scale: float,
               seed: int, window_chunk: Optional[int] = None,
               interpolation_factor: int = 0,
               clock: profiling.PhaseClock) -> Job:
        """A generation's device inputs, in the span ``entry.inputs``: the
        frames' uploads (host frames), the resizes to (height, width) and
        the normalisation on the device, the CLIP preprocess and the noise
        draw. ref_image: (h, w, 3) uint8 prepared reference; pose / bk
        frames: uint8 of any size, as ``_batches`` takes them. The caller
        may drop its frames before ``run``: nothing here keeps them."""
        dev, dt = self.device, self.dtype
        with clock.span("entry.inputs"):
            ref_u8 = self.upload([ref_image], clock)
            ref = (FU.to_unit(FU.resize_frames(ref_u8, width, height))[0]
                   * 2.0 - 1.0).to(dt)

            def video(frames):
                return FU.to_unit(torch.cat([
                    FU.resize_frames(b, width, height)
                    for b in self._batches(frames, clock)]))

            pose = video(pose_frames).to(dt)
            bk = (video(bk_frames) * 2.0 - 1.0).to(dt)
            cs = self.cfg.clip_vision.image_size
            clip_px = CV.clip_preprocess(
                FU.to_unit(FU.resize_frames(ref_u8, cs, cs))[0]).to(dt)

            ds = self.cfg.vae.downscale
            gen = torch.Generator(device=dev).manual_seed(seed)
            noise = torch.randn((pose.shape[0], height // ds, width // ds, 4),
                                generator=gen, device=dev)

            st = pose2vid.Pose2VideoStatic(
                cfg=self.cfg, num_frames=pose.shape[0], height=height,
                width=width, num_inference_steps=steps,
                guidance_scale=cfg_scale, window_chunk=window_chunk,
                pad_windows_to=self.pad_windows_to, mesh_axis=self.mesh_axis,
                frame_axis=self.frame_axis, mesh=self.mesh,
                interpolation_factor=interpolation_factor)
            return st, (ref, pose, bk, clip_px, noise.to(dt))

    def run(self, job: Job, clock: profiling.PhaseClock) -> torch.Tensor:
        """The pipeline (``generate_host_loop``) on ``inputs``' job: the
        (F', height, width, 3) video in [0, 1] on the device."""
        st, tensors = job
        return pose2vid.generate_host_loop(self.params, st, *tensors,
                                           clock=clock)

    def to_host(self, video: torch.Tensor,
                clock: profiling.PhaseClock) -> np.ndarray:
        """The video as host float32, in the span ``entry.output`` after
        the one wait for the decode."""
        clock.durations_ms()
        with clock.span("entry.output"):
            out = video.float().cpu().numpy()
        clock.copied("d2h", out.nbytes)
        return out

    def generate(self, ref_image: np.ndarray, pose_frames, bk_frames, *,
                 width: int, height: int, steps: int, cfg_scale: float,
                 seed: int, window_chunk: Optional[int] = None,
                 interpolation_factor: int = 0,
                 clock: Optional[profiling.PhaseClock] = None) -> np.ndarray:
        """``inputs``, ``run`` and ``to_host`` in one call. Returns
        (F', height, width, 3) float32 in [0, 1]: F' = F, or
        (F-1)*interpolation_factor + 1 when the factor is >= 2.

        ``clock``: the clip's recorder, whose caller sets ``last_timings``
        (``Runner.clip``); without one the generation is a clip of its own
        and sets it here."""
        own = clock is None
        clock = clock or self.clock()
        job = self.inputs(ref_image, pose_frames, bk_frames, width=width,
                          height=height, steps=steps, cfg_scale=cfg_scale,
                          seed=seed, window_chunk=window_chunk,
                          interpolation_factor=interpolation_factor,
                          clock=clock)
        video = self.to_host(self.run(job, clock), clock)
        if own:
            self.last_timings = pose2vid.clip_timings(clock)
        return video
