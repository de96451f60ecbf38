"""Device time of the two normalisation kernels of the main path, the
GroupNorm kernel (``ops/groupnorm.py::group_norm_fused``) and the GEMM tile
core's LayerNorm row pass, at the shapes a step gives them, beside their
byte bound and one PyTorch call of the same function.

    python -m mimo_tpu_torch.tools.time_norms [--rounds 2] [--tiers]

Times are device time per call from torch.profiler, so host overhead does
not count: for GroupNorm every kernel a call launches; for the LN pass the
kernels named ``ln_rows`` of a ``gemm(x, w, ln=...)`` call with a narrow
(K, 8) weight (so the same command times a tree whose LN pass runs inside
the tile core's entry point). Each case is timed ``--rounds`` times in
turn with the library call. ``--tiers`` also times each GroupNorm case
under every plan of ``TIERS`` that fits it (the tier ``gn_plan`` picks is
marked), each checked against the plain version and run twice for equal
bits, and each LN case under every plan of ``LN_PLANS``. Prints the card's name and power limit, one line per case, then one
JSON line. Needs CUDA. ``chip_smoke.py`` takes its GroupNorm and LN cases
from here.
"""

from __future__ import annotations

import argparse
import json

import torch
import torch.nn.functional as F

from mimo_tpu_torch.ops import ffn as FF
from mimo_tpu_torch.ops import groupnorm as GN
from mimo_tpu_torch.tools.timing import PEAK_BYTES, card_line, device_ms

# (N, S, C, row_add, silu): the UNet3D's GroupNorms at levels 0-3 (48
# frames; resnet norms with SiLU, the time-embedding add in norm2, the up
# blocks' concat widths; transformer and motion norms plain), then the VAE
# decoder's (8 frames)
GN_CASES = [(48, 6272, 320, True, True), (48, 6272, 320, False, False),
            (48, 6272, 640, False, True), (48, 6272, 960, False, True),
            (48, 1568, 640, True, True), (48, 1568, 640, False, False),
            (48, 1568, 1280, False, True), (48, 1568, 1920, False, True),
            (48, 400, 1280, True, True), (48, 400, 1280, False, False),
            (48, 400, 2560, False, True), (48, 104, 1280, False, False),
            (48, 104, 2560, False, True), (8, 6272, 512, False, False),
            (8, 25088, 512, False, True), (8, 100352, 256, False, True),
            (8, 401408, 128, False, True)]
# (rows, K, PE frames): the LN passes of the transformers' q|k|v and FFN
# at levels 0-3 (48 frames), and the motion modules' LN + PE at level 0
LN_CASES = [(48 * 6272, 320, 0), (48 * 1568, 640, 0), (48 * 400, 1280, 0),
            (48 * 104, 1280, 0), (48 * 6272, 320, 24)]
# the GroupNorm plans --tiers times: gn_plan's keyword arguments (the slice
# budget doubled: 96 KB)
TIERS = {
    "stream": dict(tier="stream"),
    "resident": dict(tier="resident"),
    "resident, narrowest chunk": dict(tier="resident", widen=False),
    "resident, 256 threads a block": dict(tier="resident", threads=256),
    "resident, 2x slice budget": dict(tier="resident", budget=96 * 1024),
}
# the LN pass's plans --tiers times: (m, K, SMs) -> plan
LN_PLANS = {
    "register kernel": lambda m, k, sms: FF.ln_rows_plan(m, k, sms,
                                                         short_runs=0),
    "wide-row kernel, a warp a row": lambda m, k, sms: FF.LnPlan(
        32, 0, 1, -(-m // FF.LN_WARPS)),
}


def gn_eps(silu: bool) -> float:
    """The eps of a GN_CASES norm: 1e-5 for the resnets' (the ones with
    SiLU), 1e-6 for the others."""
    return 1e-5 if silu else 1e-6


def tier_times(x, args_, rounds: int):
    """{tier: [ms a round]} of every TIERS plan that fits x, timed in turn;
    each checked against the plain version and for equal bits on a
    rerun. A plan the card refuses (a cluster it cannot place) reads its
    error instead."""
    n, s, c = x.shape
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    picked = GN.gn_plan(n, s, c, 32, x.element_size(), sms)
    want = GN.group_norm_plain(*args_).float()
    fns = {}
    for name, kw in TIERS.items():
        try:
            plan = GN.gn_plan(n, s, c, 32, x.element_size(), sms, **kw)
        except ValueError:
            continue
        label = name + (" (picked)" if plan == picked else "")
        if any(plan == p for p, _ in fns.values()):
            continue
        fn = (lambda p: lambda: GN.group_norm_cuda(*args_, plan=p))(plan)
        try:
            got = fn()
            again = fn()
            torch.cuda.synchronize()
        except RuntimeError as e:
            print(f"    {label}: {e}", flush=True)
            continue
        err = float((got.float() - want).abs().max())
        if not err <= 0.0625 or not torch.equal(got, again):
            raise AssertionError(f"group norm {(n, s, c)} {label}: "
                                 f"max_abs_err {err}, equal bits "
                                 f"{torch.equal(got, again)}")
        fns[label] = (plan, fn)
    times = {label: [] for label in fns}
    for _ in range(rounds):
        for label, (_, fn) in fns.items():
            times[label].append(device_ms(fn))
    for label, (plan, _) in fns.items():
        print(f"    {label}: " + " / ".join(f"{t:.4f}" for t in times[label])
              + f" ms  {plan}", flush=True)
    return times


def ln_plan_times(x, args_, rounds: int):
    """{plan: [ms a round]} of every LN_PLANS plan of the (m, K) x (those
    that differ), timed in turn, each checked against the plain version."""
    m, k = x.shape
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    picked = FF.ln_rows_plan(m, k, sms)
    want = FF.ln_rows_plain(*args_).float()
    fns = {}
    for name, make in LN_PLANS.items():
        plan = make(m, k, sms)
        if any(plan == p for p, _ in fns.values()):
            continue
        label = name + (" (picked)" if plan == picked else "")
        fn = (lambda p: lambda: FF.ln_rows_cuda(*args_, plan=p))(plan)
        err = float((fn().float() - want).abs().max())
        if not err <= float(want.abs().max()) / 64:
            raise AssertionError(f"LN pass {(m, k)} {label}: max_abs_err "
                                 f"{err}")
        fns[label] = (plan, fn)
    times = {label: [] for label in fns}
    for _ in range(rounds):
        for label, (_, fn) in fns.items():
            times[label].append(device_ms(fn, ["ln_rows"]))
    for label, (plan, _) in fns.items():
        print(f"    {label}: " + " / ".join(f"{t:.4f}" for t in times[label])
              + f" ms  {plan}", flush=True)
    return times


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--tiers", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_norms needs a CUDA device")
    print(card_line(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    rows = []
    for n, s, c, radd, silu in GN_CASES:
        x = (randn(n, s, c, scale=3.0) + 0.5).to(bf)
        scale, bias = randn(c) * 0.5 + 1.0, randn(c) * 0.5
        ra = randn(n, c).to(bf) if radd else None
        args_ = (x, scale, bias, 32, gn_eps(silu), silu, ra)
        err = float((GN.group_norm_fused(*args_).float()
                     - GN.group_norm_plain(*args_).float()).abs().max())
        if not err <= 0.0625:
            raise AssertionError(f"group norm {(n, s, c)}: max_abs_err {err}")
        lib = None
        if not (radd or silu):
            xt = x.transpose(1, 2).contiguous()
            sb, bb = scale.to(bf), bias.to(bf)
            lib = lambda: F.group_norm(xt, 32, sb, bb, gn_eps(silu))
        times, lib_times = [], []
        for _ in range(args.rounds):
            times.append(device_ms(lambda: GN.group_norm_fused(*args_)))
            if lib is not None:
                lib_times.append(device_ms(lib))
        bound = 2 * x.numel() * 2 / PEAK_BYTES * 1e3
        label = (f"group_norm_fused ({n}, {s}, {c})"
                 f"{' +row_add' if radd else ''}{' +silu' if silu else ''}")
        print(f"{label}: " + " / ".join(f"{t:.4f}" for t in times) + " ms"
              + (f"; F.group_norm " + " / ".join(f"{t:.4f}" for t in lib_times)
                 + " ms" if lib_times else "")
              + f"; byte bound {bound:.4f} ms ({bound / min(times):.0%} of "
              f"the best)", flush=True)
        tiers = tier_times(x, args_, args.rounds) if args.tiers else None
        rows.append(dict(kernel="group_norm_fused", case=[n, s, c, radd, silu],
                         ms=times, library_ms=lib_times or None,
                         bound_ms=bound, tiers=tiers))
        del x
    for r, k, frames in LN_CASES:
        x = (randn(r, k, scale=2.0) + 0.3).to(bf)
        scale, bias = (randn(k, scale=0.3) + 1.0).to(bf), randn(k, scale=0.3).to(bf)
        w = randn(k, 8, scale=k ** -0.5).to(bf)
        pe = randn(frames, k, scale=0.5).to(bf) if frames else None
        kw = dict(ln=(scale, bias, 1e-5), pe=pe, pe_div=6272)
        times, lib_times = [], []
        for _ in range(args.rounds):
            times.append(device_ms(lambda: FF.gemm(x, w, **kw), ["ln_rows"]))
            if pe is None:
                lib_times.append(device_ms(
                    lambda: F.layer_norm(x, (k,), scale, bias, 1e-5)))
        bound = 2 * x.numel() * 2 / PEAK_BYTES * 1e3
        label = f"LN pass R={r} K={k}{' +pe' if frames else ''}"
        tiers = ln_plan_times(x, (x, scale, bias, 1e-5, pe, 6272),
                              args.rounds) if args.tiers else None
        rows.append(dict(kernel="ln_rows", case=[r, k, frames], ms=times,
                         library_ms=lib_times or None, bound_ms=bound,
                         tiers=tiers))
        print(f"{label}: " + " / ".join(f"{t:.4f}" for t in times) + " ms"
              + (f"; F.layer_norm " + " / ".join(f"{t:.4f}" for t in lib_times)
                 + " ms" if lib_times else "")
              + f"; byte bound {bound:.4f} ms ({bound / min(times):.0%} of "
              f"the best)", flush=True)
        del x
    print(json.dumps({"norms": rows}))


if __name__ == "__main__":
    main()
