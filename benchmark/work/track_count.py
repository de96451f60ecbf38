"""The work of one tracked clip, counted from its shapes on ``meta``
tensors, as ``count.py`` counts a generation: the plain reference's pieces
(``reference/sam2.py``) under ``FlopCounterMode`` (2 FLOP a multiply-add),
with ``nn.recording``'s log of their attention calls.

``clip_work(cfg, frames)`` returns the FLOPs of a frame's encode, of the
prompt frame (decoder and conditioning memory), of each propagated frame at
the memories and pointers it really has (frame k of the propagation attends
the conditioning memory and the min(k - 1, 6) before it, and min(k, 16)
pointers), the clip's total, and two bounds in seconds (``peaks.py``): the
Hiera global blocks' attention (d = 72, from ``FLASH_MIN_Q`` queries: the
program's flash kernel) and every memory self- and cross-attention call
(d = 256).
"""

from __future__ import annotations

import functools
import json
from typing import Any, Dict, List, Tuple

import torch

from benchmark.reference import sam2 as R
from benchmark.reference import sam2_params as SP
from benchmark.work import peaks
from benchmark.work.count import FLASH_MIN_Q, META, _count, _meta_tree

GLOBAL_D = 72
MEMORY_D = 256


def _empty(*shape) -> torch.Tensor:
    return torch.empty(shape, device=META)


def _bound(log: List[Dict[str, Any]], keep) -> float:
    return sum(peaks.bound_s(*peaks.flash_work(it["b"], it["heads"], it["d"],
                                               it["sq"], it["sk"]))
               for it in log if it["op"] == "attn" and keep(it))


def _global(it) -> bool:
    return it["d"] == GLOBAL_D and it["sq"] >= FLASH_MIN_Q


def _memory(it) -> bool:
    return it["d"] == MEMORY_D


def frame_memory(k: int, cfg: Dict[str, Any]) -> Tuple[int, int]:
    """(memories, pointers) that propagated frame k (from 1) attends."""
    c = cfg["sam2"]
    return (1 + min(k - 1, c["num_maskmem"] - 1),
            1 + min(k - 1, c["max_obj_ptrs"] - 1))


def clip_work(cfg: Dict[str, Any], frames: int) -> Dict[str, Any]:
    return _clip_work(json.dumps(cfg, sort_keys=True), frames)


@functools.lru_cache(maxsize=None)
def _clip_work(cfg_json: str, frames: int) -> Dict[str, Any]:
    cfg = json.loads(cfg_json)
    c = cfg["sam2"]
    p = _meta_tree(SP.layout(cfg))
    s = cfg["hiera"]["input_size"][0]
    g, d, md = s // 16, c["dim"], c["mem_dim"]
    feat = _empty(g, g, d)
    s0, s1 = _empty(4 * g, 4 * g, d // 8), _empty(2 * g, 2 * g, d // 4)
    mask = _empty(16 * g, 16 * g)

    def prompt():
        R.decode(p, cfg, feat, _empty(cfg["track"]["points"], d), s0, s1)
        R.encode_memory(p, feat, mask)

    def frame(m, n_ptr):
        x = R.memory_attention(p, cfg, feat, feat, _empty(m, g, g, md),
                               _empty(m, g, g, md),
                               _empty(n_ptr * d // md, md))
        R.decode(p, cfg, x, _empty(1, d), s0, s1)
        R.encode_memory(p, feat, mask)

    enc, enc_log = _count(lambda: R.encode(p, cfg, _empty(1, s, s, 3)))
    pr, _ = _count(prompt)
    per_mem = {}
    frame_flops, mem_bound = 0.0, 0.0
    for k in range(1, frames):
        key = frame_memory(k, cfg)
        if key not in per_mem:
            per_mem[key] = _count(lambda: frame(*key))
        flops, log = per_mem[key]
        frame_flops += flops
        mem_bound += _bound(log, _memory)
    full = per_mem.get(frame_memory(frames - 1, cfg), (0.0, None))[0]
    return {"flops": {"encode": enc, "prompt": pr, "frame_full": full},
            "clip_flops": frames * enc + pr + frame_flops,
            "frames": frames,
            "flash72_bound_s": frames * _bound(enc_log, _global),
            "memattn_bound_s": mem_bound}

