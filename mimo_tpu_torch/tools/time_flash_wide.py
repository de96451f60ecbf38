"""Device time of the wide-head flash kernel (``ops/flash_attention.py::
flash_attention_wide``, ``csrc/flash_wide.cu``) at the VAE mid block's
shapes, beside its bound, SDPA on the same inputs and, optionally, other
builds of the kernel's source.

    python -m mimo_tpu_torch.tools.time_flash_wide [--against A.cu ...]

``--against FILE`` builds each file, an earlier design with the first
design's tile plan FIRST_PLAN (such as ``git show 07ba87d:mimo_tpu_torch/
csrc/flash_wide.cu``), alone with nvcc (``_build.build_alone``; it may
include ``csrc/``'s headers) and binds its ``mimo_flash_wide_fwd``, whose
signature every design keeps. Each build is first held against the plain version at
CHECK_CASES and CASES, run twice for equal bits and compared bit for bit
with the package's kernel; then each of ROUNDS rounds times the builds in
turns (A, B, ..., new, new, ..., B, A) on the same inputs. Times are device
time per call from torch.profiler, so host overhead does not count. Beside
each: the estimated bytes its blocks receive into shared memory from L2
(``fill_bytes``, from the tile plan, not measured) and the rate that
implies. Prints the card's name and power limit, ptxas's registers, spills
and notes of every build's ``flash_wide_kernel<d>``, one line a case, then
one JSON line. Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import math
import re
from pathlib import Path

import torch

from mimo_tpu_torch.ops import _build
from mimo_tpu_torch.ops import flash_attention as FA
from mimo_tpu_torch.tools.timing import bound, card_line, device_ms, \
    flash_work

ROUNDS = 2
# (heads, d, batch, sq, sk): a bench VAE chunk of 8 frames at 512x784, the
# encode's last chunk (1 frame), edit's 784x784
CASES = [(1, 512, 8, 6272, 6272), (1, 512, 1, 6272, 6272),
         (1, 512, 8, 9604, 9604)]
# checked, not timed: a last query tile of 12 rows (its second warpgroup's
# rows all past Sq) and a last key tile of 20 keys; ragged edges; two heads
# of 192 (3 boxes of columns split 2 / 1 between a pair of blocks); one
# query tile of 64 rows over 33 keys
CHECK_CASES = [(1, 512, 2, 1036, 980), (1, 512, 2, 1100, 1000),
               (2, 192, 2, 1100, 1000), (1, 512, 1, 64, 33)]
TILE = 64            # keys a K / V tile
# tile plans that ``fill_bytes`` sizes: (query rows a block, blocks that
# split a query tile's columns of O and V); neither multicasts
PLAN = (128, 2)      # csrc/flash_wide.cu: kWideBQ, a pair a query tile
FIRST_PLAN = (64, 1)  # the first design: 64 rows, all of O's columns


def fill_bytes(b, heads, d, sq, sk, plan=PLAN):
    """Estimated bytes the blocks of one call of the wide kernel receive
    into shared memory, each read once from L2: each block its Q tile,
    every K tile and its share of every V tile."""
    rows, split = plan
    blocks = b * heads * -(-sq // rows) * split
    k_tile = TILE * d * 2
    return blocks * (rows * d * 2
                     + -(-sk // TILE) * (k_tile + k_tile // split))


def registers(log: str):
    """ptxas's registers and spills of each flash_wide_kernel<d> in log,
    and its notes that name the kernel (a warning, or wgmma products
    serialized)."""
    kernels, notes = _build.ptxas_report(log)
    return [n for n in notes if "flash_wide_kernel" in n] + [
        f"d={m.group(1)}: {regs}; {spills}" for name, regs, spills in kernels
        if (m := re.search(r"flash_wide_kernelILi(\d+)E", name))]


def build(src: str):
    """src built alone, its mimo_flash_wide_fwd bound; (run, ptxas log)."""
    fn, log = _build.build_alone(src, "mimo_flash_wide_fwd")

    def run(q, k, v, heads):
        d = q.shape[2] // heads
        out = torch.empty_like(q)
        _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), q.shape[0], heads, d, q.shape[1],
                        k.shape[1], q.stride(0), q.stride(1), k.stride(0),
                        k.stride(1), v.stride(0), v.stride(1), out.stride(0),
                        out.stride(1), FA.LOG2E / math.sqrt(d),
                        torch.cuda.current_stream().cuda_stream), src)
        return out
    return run, log


def inputs(gen, heads, d, b, sq, sk):
    """q, k, v scaled as chip_smoke.py's flash cases (logits of a few
    units)."""
    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(torch.bfloat16)
    return (randn(b, sq, heads * d, scale=2.0),
            randn(b, sk, heads * d, scale=2.0), randn(b, sk, heads * d))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", nargs="*", default=[])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_flash_wide needs a CUDA device")
    print(card_line(), flush=True)
    _build.load_library()
    fns = {"new": lambda q, k, v, h: FA.flash_attention_wide(q, k, v, h)}
    logs = {"new": _build.build_log()}
    for src in args.against:
        fns[Path(src).stem], logs[Path(src).stem] = build(src)
    for name, log in logs.items():
        print(f"ptxas {name}: " + " | ".join(registers(log)), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    failed = []
    for heads, d, b, sq, sk in CHECK_CASES + CASES:
        q, k, v = inputs(gen, heads, d, b, sq, sk)
        want = FA.attention_plain(q, k, v, heads).float()
        outs = {}
        for name, fn in fns.items():
            first = outs[name] = fn(q, k, v, heads)
            err = float((first.float() - want).abs().max())
            same = torch.equal(first, fn(q, k, v, heads))
            print(f"check {name} H={heads} d={d} B={b} Sq={sq} Sk={sk}: "
                  f"max_abs_err {err:.4g}, twice "
                  f"{'equal' if same else 'DIFFER'}"
                  + ("" if name == "new" else ", equal to new in every bit: "
                     + str(torch.equal(first, outs["new"]))), flush=True)
            if not (err <= 2e-2 and same):
                failed.append(f"{name} at {(heads, d, b, sq, sk)}: "
                              f"max_abs_err {err}, equal {same}")
        del want, outs
    if failed:
        raise AssertionError("; ".join(failed))
    olds = [n for n in fns if n != "new"]
    order = olds + ["new", "new"] + olds[::-1]
    rows = []
    for heads, d, b, sq, sk in CASES:
        q, k, v = inputs(gen, heads, d, b, sq, sk)
        times = {name: [] for name in fns}
        for _ in range(ROUNDS):
            for name in order:
                times[name].append(device_ms(
                    lambda: fns[name](q, k, v, heads), n=10))
        qh, kh, vh = (x.unflatten(-1, (heads, -1)).transpose(1, 2)
                      for x in (q, k, v))
        sdpa = device_ms(lambda: torch.nn.functional
                         .scaled_dot_product_attention(qh, kh, vh), n=10)
        bound_ms = bound(*flash_work(b, heads, d, sq, sk,
                                     q.numel() + k.numel() + v.numel()))[0]
        row = dict(case=[heads, d, b, sq, sk], bound_ms=bound_ms,
                   sdpa_ms=sdpa)
        parts = []
        for name, ts in times.items():
            fill = fill_bytes(b, heads, d, sq, sk,
                              PLAN if name == "new" else FIRST_PLAN)
            best = min(ts)
            row[name] = dict(ms=ts, fill_gb_estimated=fill / 1e9)
            parts.append(f"{name} " + " / ".join(f"{t:.4f}" for t in ts)
                         + f" ms ({bound_ms / best:.0%} of the bound; "
                         f"fill, estimated, {fill / 1e9:.2f} GB: "
                         f"{fill / (best * 1e-3) / 1e12:.2f} TB/s)")
        rows.append(row)
        print(f"H={heads} d={d} B={b} Sq={sq} Sk={sk}: " + "; ".join(parts)
              + f"; SDPA {sdpa:.4f} ms; bound {bound_ms:.4f} ms", flush=True)
    print(json.dumps({"flash_wide": rows}))


if __name__ == "__main__":
    main()
