"""The work of one clip, counted from its shapes on ``meta`` tensors: the
reference's pieces run under ``torch.utils.flop_counter.FlopCounterMode``
(products and convolutions at 2 FLOP a multiply-add), and its work log
gives each attention call and each of the program's tile-core products, so
that the same count holds whatever implements the step.

``clip_work(cfg, frames)`` returns the FLOPs of each piece (clip, vae_encode,
pose_guider, reference_unet, step, vae_decode), the clip's total, and the
bound in seconds (``peaks.py``) of the clip's level-0 flash attention
(d = 40 from 1024 queries) and of its tile-core products.
"""

from __future__ import annotations

import functools
import json
from typing import Any, Dict, List

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference import encoders as E
from benchmark.reference import nn
from benchmark.reference import params as P
from benchmark.reference import pipeline as RP
from benchmark.reference import unet as U
from benchmark.work import peaks

META = torch.device("meta")
FLASH_MIN_Q = 1024   # the program's flash kernels take Sq from here


def _meta_tree(tree: Any) -> Any:
    if isinstance(tree, P.Leaf):
        return torch.empty(tree.shape, device=META)
    if isinstance(tree, dict):
        return {k: _meta_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_meta_tree(v) for v in tree]
    return tree


def _count(fn) -> tuple:
    log: List[Dict[str, Any]] = []
    with FlopCounterMode(display=False) as fc, nn.recording(log):
        fn()
    return fc.get_total_flops(), log


def _bounds(log: List[Dict[str, Any]]) -> Dict[str, float]:
    flash = gemm = 0.0
    for it in log:
        if it["op"] == "attn" and it["d"] == 40 and it["sq"] >= FLASH_MIN_Q:
            flash += peaks.bound_s(*peaks.flash_work(
                it["b"], it["heads"], it["d"], it["sq"], it["sk"],
                it["bank"]))
        elif it["op"] == "gemm":
            gemm += peaks.bound_s(*peaks.gemm_work(
                it["m"], it["k"], it["n"], it["res"], it["geglu"]))
    return {"flash40_bound_s": flash, "gemm_bound_s": gemm}


def clip_work(cfg: Dict[str, Any], frames: int) -> Dict[str, Any]:
    """The work of one generation of ``frames`` frames at the
    configuration's size (the windows as the pipeline forms them)."""
    return _clip_work(json.dumps(cfg, sort_keys=True), frames)


@functools.lru_cache(maxsize=None)
def _clip_work(cfg_json: str, frames: int) -> Dict[str, Any]:
    cfg = json.loads(cfg_json)
    pl = cfg["pipeline"]
    h, w = pl["height"], pl["width"]
    ds = 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
    lh, lw = h // ds, w // ds
    p = _meta_tree(P.layout(cfg))
    win = RP.windows(frames, min(pl["context_frames"], frames),
                     pl["context_overlap"])
    nw, cs = len(win), len(win[0])
    cs_img = cfg["clip_vision"]["image_size"]
    ctx = torch.empty((2, 1, cfg["clip_vision"]["projection_dim"]),
                      device=META)
    banks = {}

    def ref_unet():
        banks["b"] = U.unet2d_banks(p["reference_unet"],
                                    cfg["reference_unet"],
                                    torch.empty((2, lh, lw, 4), device=META),
                                    ctx)

    pieces = {
        "clip": lambda: E.clip_image_embed(
            p["clip"], cfg["clip_vision"],
            torch.empty((1, cs_img, cs_img, 3), device=META)),
        "vae_encode": lambda: E.vae_encode_mean(
            p["vae"], cfg["vae"], torch.empty((frames + 1, h, w, 3),
                                              device=META)),
        "pose_guider": lambda: E.pose_guider(
            p["pose_guider"], torch.empty((frames, h, w, 3), device=META)),
        "reference_unet": ref_unet,
        "step": lambda: U.unet3d(
            p["denoising_unet"], cfg["denoising_unet"],
            torch.empty((2 * nw, cs, lh, lw, 8), device=META), 1.0,
            torch.empty((2 * nw, 1, ctx.shape[-1]), device=META),
            torch.empty((2 * nw, cs, lh, lw,
                         cfg["pose_guider"]["embedding_channels"]),
                        device=META),
            [b[-1] for b in banks["b"]], cfg_split=True),
        "vae_decode": lambda: E.vae_decode(
            p["vae"], cfg["vae"], torch.empty((frames, lh, lw, 4),
                                              device=META)),
    }
    flops, logs = {}, {}
    for name, fn in pieces.items():
        flops[name], logs[name] = _count(fn)
    steps = pl["num_inference_steps"]
    total = sum(flops.values()) + (steps - 1) * flops["step"]
    clip_log = logs["reference_unet"] + logs["step"] * steps
    return {"flops": flops, "clip_flops": total, "steps": steps,
            **_bounds(clip_log)}
