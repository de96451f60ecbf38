"""Device time of the temporal attention core (``ops/temporal_attention.py::
temporal_attn_core``) at the motion modules' shapes, beside its byte bound,
SDPA on the same inputs and, optionally, an earlier build of the core.

    python -m mimo_tpu_torch.tools.time_tattn_core [--against OLD.cu]

``--against`` builds OLD.cu alone with nvcc (into a temporary directory)
and binds its ``mimo_temporal_attention_fwd`` with the signature of the
CUDA-core design that the tensor-core kernel replaced: (qkv, out, B, F, S,
H, d, scale_log2, stream). Each of two rounds times old, new, new, old on
the same inputs. Times are device time per call from torch.profiler (the sum of the
kernels a call launches), so host overhead does not count. Prints the
card's name and power limit, one line per case, then one JSON line.
Needs CUDA.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math

import torch

from mimo_tpu_torch.ops import _build
from mimo_tpu_torch.ops import temporal_attention as TA
from mimo_tpu_torch.tools.timing import PEAK_BYTES, card_line, device_ms

ROUNDS = 2             # of old, new, new, old (new alone without --against)
# (B, F, S, C, heads): the motion modules at UNet levels 0-3 (the CFG
# batch of 2, 24 frames), then a short window (F = 5) and the longest
# (F = 32)
CASES = [(2, 24, 6272, 320, 8), (2, 24, 1568, 640, 8), (2, 24, 400, 1280, 8),
         (2, 24, 104, 1280, 8), (2, 5, 6272, 320, 8), (2, 32, 1568, 640, 8),
         (2, 32, 400, 1280, 8)]


def core_work(b, f, s, c, heads):
    """(FLOPs, bytes, logits) of the core: Q.K^T and P.V at 2 FLOP a
    multiply-add, q|k|v read once and o written once in bf16, one exp2 a
    logit."""
    logits = b * s * heads * f * f
    return 2 * 2 * logits * (c // heads), 4 * b * f * s * c * 2, logits


def sdpa_inputs(qkv, b, f, s, heads):
    """q, k, v of the core as contiguous (B·S, H, F, d) copies: the layout
    F.scaled_dot_product_attention attends over."""
    c = qkv.shape[1] // 3
    x = qkv.view(b, f, s, 3, heads, c // heads).permute(3, 0, 2, 4, 1, 5)
    return [t.reshape(b * s, heads, f, c // heads).contiguous() for t in x]


def build_old(src: str):
    """OLD.cu built alone, its entry point bound with the old signature."""
    fn, _ = _build.build_alone(
        src, "mimo_temporal_attention_fwd",
        ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
         + [ctypes.c_float, ctypes.c_void_p], ctypes.c_int))

    def run(qkv, b, f, s, heads):
        c = qkv.shape[1] // 3
        d = c // heads
        out = torch.empty((qkv.shape[0], c), dtype=qkv.dtype,
                          device=qkv.device)
        _build.check(fn(qkv.data_ptr(), out.data_ptr(), b, f, s, heads, d,
                        TA.LOG2E / math.sqrt(d),
                        torch.cuda.current_stream().cuda_stream),
                     "the earlier core (--against)")
        return out
    return run


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_tattn_core needs a CUDA device")
    print(card_line(), flush=True)
    old = build_old(args.against) if args.against else None
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for b, f, s, c, heads in CASES:
        qkv = (torch.randn((b * f * s, 3 * c), generator=gen, device="cuda")
               * 2).to(torch.bfloat16)
        want = TA.temporal_attn_core_plain(qkv, b, f, s, heads).float()
        limit = 2 ** -7 * float(qkv[:, 2 * c:].float().abs().max())
        fns = {"new": lambda: TA.temporal_attn_core(qkv, b, f, s, heads)}
        if old is not None:
            fns["old"] = lambda: old(qkv, b, f, s, heads)
        for name, fn in fns.items():
            err = float((fn().float() - want).abs().max())
            if not err <= limit:
                raise AssertionError(f"{name} core {(b, f, s, c, heads)}: "
                                     f"max_abs_err {err} > {limit}")
        order = ["old", "new", "new", "old"] if old is not None else ["new"]
        times = {name: [] for name in fns}
        for _ in range(ROUNDS):
            for name in order:
                times[name].append(device_ms(fns[name]))
        q, k, v = sdpa_inputs(qkv, b, f, s, heads)
        sdpa = device_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v))
        bound = core_work(b, f, s, c, heads)[1] / PEAK_BYTES * 1e3
        row = dict(case=[b, f, s, c, heads], bound_ms=bound, sdpa_ms=sdpa,
                   **{f"{name}_ms": ts for name, ts in times.items()})
        rows.append(row)
        print(f"B={b} F={f} S={s} C={c} heads={heads}: new "
              + " / ".join(f"{t:.4f}" for t in times["new"]) + " ms"
              + ("; old " + " / ".join(f"{t:.4f}" for t in times["old"])
                 + " ms" if old is not None else "")
              + f"; SDPA {sdpa:.4f} ms; byte bound {bound:.4f} ms "
              f"({bound / min(times['new']):.0%} of the best new)",
              flush=True)
    print(json.dumps({"tattn_core": rows}))


if __name__ == "__main__":
    main()
