"""Video character editing (run_edit.py semantics): ROI-clip the template,
generate, paste back with feather masks, occlusion compositing and an
overlap cross-fade.

Counterpart of ``mimo_tpu/entry/edit.py``, with one API difference:
``edit`` takes a template directory or a ``Template`` already in memory
(as ``entry.animate.animate`` takes pose frames). The shot split's masks,
the crops and pads (``crop_shots``) and the paste-back (``paste_back``)
run on the Runner's device as batched tensor ops: the frames go there as
uint8 (sdc and bk for the crops, dropped before the generation; bk, vid and
occ after the decode), only the boxes come back before the generation, and
only the finished uint8 frames after it. The host keeps the shot split's
decisions and the reference image's matting. ``composite_back`` is the
numpy paste-back of the original, ``paste_back``'s oracle. The resizes on
the device are OpenCV's arithmetic (``utils.frames.cv_resize``), equal to
``cv2.resize`` in every bit, so the two paste-backs agree in every bit.

CLI: python -m mimo_tpu_torch.entry.edit --ref ref.png --template dir/ \\
        --output out.mp4 [--weights bundle.npz] [--W 784 --H 784 ...]
The CLI runs on a CUDA device and raises without one.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from mimo_tpu_torch.config import DTypePolicy, MIMOConfig
from mimo_tpu_torch.entry.runner import (Runner, init_random_params,
                                         load_params, prep_reference_image)
from mimo_tpu_torch.entry.template import Template, load_template
from mimo_tpu_torch.utils import frames as FU
from mimo_tpu_torch.utils import video_io as VIO

OVERLAY = 4  # shot cross-fade frames (run_edit.py:216)


def composite_back(video: np.ndarray, context_list, bbox_clip_list,
                   pad_info, bk_ori, vid_ori, occ_ori,
                   overlay: int = OVERLAY) -> List[np.ndarray]:
    """Paste generated crops back into the full frames: unpad → place at
    the shot's bbox → feathered blend onto the original background →
    occlusion alpha-over of the source video → linear cross-fade on
    shot-overlap frames. Frames no shot covers are dropped."""
    n_total = len(bk_ori)
    res: List[Optional[np.ndarray]] = [None] * n_total
    video_idx = 0
    for k, context in enumerate(context_list):
        start_i = context[0]
        bbox = bbox_clip_list[k]
        for i in context:
            bk_image = bk_ori[i].astype(np.float32)
            fh, fw = bk_image.shape[:2]
            pad_h, pad_w, padding_v = pad_info[video_idx]
            frame = video[video_idx]  # (H, W, 3) float [0,1]
            frame = FU.resize_frame((frame * 255).astype(np.uint8),
                                    pad_w, pad_h)
            top, bottom, left, right = padding_v
            frame = frame[top:pad_h - bottom, left:pad_w - right]

            w_min, w_max, h_min, h_max = bbox
            canvas = np.full((fh, fw, 3), 255, np.float32)
            ch, cw = frame.shape[:2]
            canvas[h_min:h_min + ch, w_min:w_min + cw] = frame

            mask_full = np.zeros((fh, fw), np.float32)
            feather = FU.get_feather_mask(bbox, (fw, fh), (ch, cw))
            mask_full[h_min:h_min + ch, w_min:w_min + cw] = feather

            out = canvas * mask_full[..., None] + \
                bk_image * (1 - mask_full[..., None])

            if occ_ori is not None:
                occ = occ_ori[i][..., 0].astype(np.float32) / 255.0
                out = out * (1 - occ[..., None]) + \
                    vid_ori[i].astype(np.float32) * occ[..., None]

            if res[i] is None:
                res[i] = out
            else:
                factor = (i - start_i + 1) / (overlay + 1)
                res[i] = res[i] * (1 - factor) + out * factor
            video_idx += 1
    return [np.clip(r, 0, 255).astype(np.uint8) for r in res
            if r is not None]


def crop_shots(runner: Runner, sdc: Sequence[np.ndarray],
               bk: Sequence[np.ndarray], clock):
    """``crop_human_clip_auto_context`` and the pads on the runner's
    device: sdc and bk uploaded once as uint8, the cleaned sdc masks' boxes
    (``FU.sdc_rects``) copied back once, the shot split worked out on the
    host from them (``FU.roi_shots``), then each shot's pose and bk frames
    cropped and padded (black and white) to a 16-multiple square there.
    Returns (pose batches, bk batches, one a shot; pad_info, one a
    generated frame; context_list; bbox_clip_list)."""
    sdc_t = runner.upload(sdc, clock)
    bk_t = runner.upload(bk, clock)
    rects = FU.sdc_rects(sdc_t, clean=True, clock=clock)
    shape = tuple(sdc_t.shape[1:3])
    _, context_list, bbox_clip_list = FU.roi_shots(
        [FU.roi_box(r, shape) for r in rects], OVERLAY)
    pose_in, bk_in, pad_info = [], [], []
    for context, bbox in zip(context_list, bbox_clip_list):
        bx, bxm, by, bym = FU.shot_box(bbox, shape)
        shot = slice(context[0], context[-1] + 1)   # a shot is a range
        pose, _ = FU.pad_frames(sdc_t[shot, by:bym, bx:bxm], (0, 0, 0))
        back, padding_v = FU.pad_frames(bk_t[shot, by:bym, bx:bxm],
                                        (255, 255, 255))
        pose_in.append(pose)
        bk_in.append(back)
        pad_info += [(back.shape[1], back.shape[2], padding_v)] * len(context)
    return pose_in, bk_in, pad_info, context_list, bbox_clip_list


def paste_back(video: torch.Tensor, context_list, bbox_clip_list, pad_info,
               bk: torch.Tensor, vid: torch.Tensor,
               occ: Optional[torch.Tensor], overlay: int = OVERLAY,
               clock=None) -> torch.Tensor:
    """``composite_back`` on the device, batched a shot: video (N, h, w, 3)
    in [0, 1], bk and vid (F, H, W, 3) uint8, occ (F, H, W) uint8 (the
    occlusion video's channel 0) or None, all tensors on one device;
    pad_info one entry a generated frame, one size within a shot. The same
    arithmetic in the same order, so the frames equal ``composite_back``'s
    in every bit. Returns the (M, H, W, 3) uint8 frames some shot covers.
    ``clock`` counts the feather masks' copies."""
    dev = bk.device
    n_total, fh, fw = bk.shape[:3]
    res = torch.empty((n_total, fh, fw, 3), dtype=torch.float32, device=dev)
    covered = [False] * n_total
    video_idx = 0
    for context, bbox in zip(context_list, bbox_clip_list):
        n, start_i = len(context), context[0]
        shot = slice(start_i, context[-1] + 1)
        pad_h, pad_w, (top, bottom, left, right) = pad_info[video_idx]
        frames = (video[video_idx:video_idx + n].float() * 255).to(
            torch.uint8)
        frames = FU.resize_frames(frames, pad_w, pad_h)[
            :, top:pad_h - bottom, left:pad_w - right]

        w_min, _, h_min, _ = bbox
        ch, cw = frames.shape[1:3]
        canvas = torch.full((n, fh, fw, 3), 255.0, device=dev)
        canvas[:, h_min:h_min + ch, w_min:w_min + cw] = frames

        feather = torch.from_numpy(
            FU.get_feather_mask(bbox, (fw, fh), (ch, cw))).to(dev)
        if clock is not None:
            clock.copied("h2d", feather.nbytes)
        mask_full = torch.zeros((fh, fw, 1), device=dev)
        mask_full[h_min:h_min + ch, w_min:w_min + cw, 0] = feather

        out = canvas * mask_full + bk[shot].float() * (1 - mask_full)
        if occ is not None:
            o = FU.to_unit(occ[shot])[..., None]
            out = out * (1 - o) + vid[shot].float() * o

        for k, i in enumerate(context):
            if covered[i]:
                factor = (i - start_i + 1) / (overlay + 1)
                out[k] = res[i] * (1 - factor) + out[k] * factor
            covered[i] = True
        res[shot] = out
        video_idx += n
    if not all(covered):
        res = res[[i for i in range(n_total) if covered[i]]]
    return res.clamp_(0, 255).to(torch.uint8)


def edit(runner: Runner, ref_img: np.ndarray,
         template: Union[str, os.PathLike, Template], *,
         width: int = 784, height: int = 784, steps: int = 25,
         cfg_scale: float = 3.5, seed: int = 42,
         max_frames: int = 150) -> List[np.ndarray]:
    """The edited video as (H, W, 3) uint8 frames at the template's size.
    ``template``: a template directory, or a ``Template`` in memory (its
    streams are cut to ``max_frames``); either needs a background (bk).
    The call is one clip of ``runner`` (``Runner.clip``): its spans and
    phases, the paste-back's included, are in ``runner.last_timings`` when
    it returns."""
    with runner.clip("entry.edit") as clock:
        with clock.span("entry.template"):
            if isinstance(template, (str, os.PathLike)):
                tpl = load_template(os.fspath(template),
                                    max_frames=max_frames, require_bk=True)
            else:
                tpl = template
                if tpl.bk is None:
                    raise FileNotFoundError(f"{tpl.path}/bk.mp4 required for "
                                            f"the edit flow")
            sdc = list(tpl.sdc)[:max_frames]
            bk_ori = list(tpl.bk)[:max_frames]
            vid_ori = list(tpl.vid)[:max_frames] if tpl.vid else bk_ori
            occ_ori = (list(tpl.occ)[:max_frames] if tpl.occ is not None
                       else None)
            pose_in, bk_in, pad_info, context_list, bbox_clip_list = \
                crop_shots(runner, sdc, bk_ori, clock)
        with clock.span("entry.reference"):
            ref = prep_reference_image(ref_img)

        job = runner.inputs(ref, pose_in, bk_in, width=width, height=height,
                            steps=steps, cfg_scale=cfg_scale, seed=seed,
                            clock=clock)
        # the template's frames leave the device before the pipeline, and
        # the paste-back's streams reach it after the decode
        del pose_in, bk_in
        video = runner.run(job, clock)
        del job
        # the one wait for the decode: the span holds the host's work alone
        clock.durations_ms()

        with clock.span("entry.paste_back"):
            bk = runner.upload(bk_ori, clock)
            vid = bk if vid_ori is bk_ori else runner.upload(vid_ori, clock)
            occ = (runner.upload(occ_ori, clock)[..., 0]
                   if occ_ori is not None else None)
            frames = paste_back(video, context_list, bbox_clip_list,
                                pad_info, bk, vid, occ, clock=clock)
            out = frames.cpu().numpy()
            clock.copied("d2h", out.nbytes)
            return list(out)


def main(argv=None):
    ap = argparse.ArgumentParser(description="MIMO video character edit "
                                             "(PyTorch port)")
    ap.add_argument("--ref", required=True)
    ap.add_argument("--template", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--weights", default=None,
                    help=".npz bundle from `python -m "
                         "mimo_tpu_torch.weights.convert` "
                         "(random init if omitted — smoke-test mode)")
    ap.add_argument("--W", type=int, default=784)
    ap.add_argument("--H", type=int, default=784)
    ap.add_argument("--steps", type=int, default=25)
    ap.add_argument("--cfg", type=float, default=3.5)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--max-frames", type=int, default=150)
    args = ap.parse_args(argv)

    # validate inputs before the (slow) model init
    tpl_probe = load_template(args.template, max_frames=1, require_bk=True)
    ref = VIO.load_image(args.ref)

    if not torch.cuda.is_available():
        raise RuntimeError("mimo_tpu_torch.entry.edit needs a CUDA device "
                           "(torch.cuda.is_available() is False); the "
                           "library API (Runner, edit) takes an explicit "
                           "device")
    device = torch.device("cuda")
    dtype = DTypePolicy.for_device(device).compute_dtype
    cfg = MIMOConfig()
    if args.weights:
        params = load_params(args.weights, device=device, dtype=dtype)
    else:
        gen = torch.Generator(device=device).manual_seed(0)
        params = init_random_params(cfg, gen, dtype=dtype)
    runner = Runner(cfg=cfg, params=params, device=device, dtype=dtype)
    frames = edit(runner, ref, args.template, width=args.W, height=args.H,
                  steps=args.steps, cfg_scale=args.cfg, seed=args.seed,
                  max_frames=args.max_frames)
    VIO.save_video(frames, args.output, fps=tpl_probe.fps)
    print(f"saved {len(frames)} frames to {args.output}")


if __name__ == "__main__":
    main()
