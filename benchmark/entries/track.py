"""The ``track`` entry (MIMO's ``video_decomp`` human tracking): a video
and the person's first mask in, SAM 2 tracks the mask through the clip.
The interface is ``animate.py``'s.

The system under test is the port's ``build_decomp_models(...)
.track_video``, the call ``VideoProcessor.get_human`` makes: the encode of
every frame, the prompt with points of the first mask on frame 0, and the
forward and reverse propagation. A clip's input is the traffic's source
video (``vid``); its first mask is the figure's silhouette, ``sdc[0]``
nonzero, in place of ``get_first_mask``'s detector and SAM ViT-H.

What ``clip`` returns and ``correct`` compares: the sigmoid of the picked
candidate's low-res logits before the object gate, every frame
((T, 4g, 4g) float32, one copy back from the device inside the clip), from
``track_video.last_record``. The record's decisions (each frame's pick,
object gate, and the prompt frame's stability choice and binarised mask)
are kept by the clip's ``seed`` for ``reference``, which follows them at
near-ties (``reference/sam2.py``)."""

from __future__ import annotations

import sys
from typing import Any, Dict, Optional

import torch

from benchmark.reference import sam2 as RS
from benchmark.reference import sam2_params
from benchmark.work import track_count

__all__ = ["layout", "work", "Program", "reference", "frames"]

layout = sam2_params.layout
work = track_count.clip_work
# the warm-up's frames: encode chunks of 8, 8 and 6 (a clip's last is 6),
# and every shape of the memory bank (1-7 memories, 1-16 pointers), whose
# frame graphs the card captures then
WARM_FRAMES = 22
# each clip's recorded decisions by its seed: the harness hands
# ``reference`` the clip's inputs alone, after the program is gone
_DECISIONS: Dict[int, Dict[str, Any]] = {}


def first_mask(inp: Dict[str, Any]):
    return inp["sdc"][0].any(axis=-1)


def _port_config(cfg: Dict[str, Any]):
    """The port's ``SAM2Config`` of a configuration file, and whether it is
    the factory's tiny one; the factory builds no other, and its tracker
    prompts as ``track`` says."""
    from mimo_tpu_torch.decomp import factory as FA
    from mimo_tpu_torch.decomp.hiera import HieraConfig
    from mimo_tpu_torch.decomp.sam2 import SAM2Config
    h = {k: tuple(v) if isinstance(v, list) else v
         for k, v in cfg["hiera"].items()}
    c = SAM2Config(hiera=HieraConfig(**h), **cfg["sam2"])
    tr = cfg["track"]
    if (tr["prompt_frame"], tr["points"], tr["points_seed"], tr["enc_chunk"]
            ) != (0, FA.TrackVideo.PROMPT_POINTS, 0, 8):
        raise ValueError(f"the port's tracker does not prompt as {tr}")
    for tiny in (False, True):
        if c == FA.configs(tiny)[1]:
            return tiny
    raise ValueError("build_decomp_models builds SAM2Config() or "
                     "tiny_sam2_config() only")


class Program:
    def __init__(self, cfg: Dict[str, Any], cfg_path, params,
                 device: torch.device, dtype: torch.dtype):
        from mimo_tpu_torch.decomp.factory import build_decomp_models
        self.models = build_decomp_models(
            params={"sam2": params}, only={"sam2"}, device=device,
            tiny=_port_config(cfg))
        if not hasattr(self.models.track_video, "last_record"):
            raise RuntimeError("this port's track_video keeps no record of "
                               "its decisions, which the check needs")

    def clip(self, inp: Dict[str, Any], steps: Optional[int] = None):
        """The clip's video through ``track_video``; ``steps`` set (the
        warm-up) tracks its first ``WARM_FRAMES`` frames."""
        vid = inp["vid"] if steps is None else inp["vid"][:WARM_FRAMES]
        self.models.track_video(list(vid), first_mask(inp), 0)
        rec = self.models.track_video.last_record
        out = torch.sigmoid(rec.picked()).cpu().numpy()
        _DECISIONS[inp["seed"]] = rec.decisions()
        return out

    def timings(self) -> Dict[str, Any]:
        """The last clip's record (``TrackRecord.timings``): ``encode``,
        ``prompt``, ``frame_ms`` and their mean on the device's timeline,
        the counters, the host spans."""
        return self.models.track_video.last_record.timings()


def reference(cfg: Dict[str, Any], params, inp: Dict[str, Any], device):
    stats: Dict[str, Any] = {}
    with torch.no_grad():
        out = RS.track(params, cfg, inp["vid"], first_mask(inp), device,
                       record=_DECISIONS.get(inp["seed"]), stats=stats)
    print(f"# reference decisions (followed at a near-tie; differ: the "
          f"program's taken against a clear margin): {stats}",
          file=sys.stderr, flush=True)
    return out.cpu().numpy()


def frames(inp: Dict[str, Any]) -> int:
    """The clip's frames."""
    return len(inp["vid"])
