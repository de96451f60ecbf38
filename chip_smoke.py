"""On-card smoke test of the PyTorch port (mimo_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. device: fails without CUDA; prints the card's name and power limit and
   the torch / CUDA / triton / nvcc versions;
2. build: compiles the CUDA kernels from mimo_tpu_torch/csrc with nvcc,
   prints the build's wall time and ptxas's registers and spills (the 36
   flash ablation builds summed up at the end); fails if the GEMM tile
   core, any production flash (wide heads too), temporal-core, GroupNorm
   or LN-row instantiation spills, or ptxas ignored a setmaxnreg;
3. kernels: each kernel wrapper (the function the main path calls; one
   call must count one launch) against its plain PyTorch version on the
   card at the main path's shapes (ragged edges included) and at the edit
   path's 784x784 ones (98x98 latents: a ragged last row tile of the tile
   core at every level, a 4-row last query tile of flash at 9604 queries,
   GroupNorm's stream tier at level 0), max error beside
   the stated tolerance; the kernel's, the plain version's and, where one
   PyTorch call computes the same function or the tile core's product(s),
   that call's time (a yardstick the port never calls), beside the bound:
   the least time the card could take (the larger of bytes over 3.35 TB/s
   and operations over their peak rate; for attention the operations also
   take the exp2 of every logit, spread over the special-function units
   and the FMA pipes, see ``exp2_ms``); GroupNorm at UNet levels 0-3 and
   the VAE's shapes (twice in each of its two tiers, which must give equal
   bits), and the LN row pass (``ln_rows``) at levels 0-3, and both of
   its kernels at K = 64 / 136 / 232 / 1280 / 2048 (twice at level 0,
   equal bits); the flash kernel also at the full main-path batch, beside
   SDPA in interleaved rounds; the temporal attention chain at UNet
   levels 0-3, and its core alone at those levels
   and at F = 5 and 32 (beside SDPA on (B·S, H, F, d) copies); flash also
   at the decomposition's widths (d = 72 Hiera-L, d = 16 the decoders,
   d = 64 DINOv2-L over 2073 tokens with q/k/v column views); the wide-head
   flash kernel (``flash_attention_wide``) at the VAE mid block's one head
   of d = 512 over a VAE chunk of 8 frames (B = 8, S = 6272), the encode's last
   chunk (B = 1), edit's 9604 tokens, 256x256's 1024 and a ragged 1100 /
   1000 and 1036 / 980 (a last query tile of 12 rows, a last key tile of
   20), and at 2 heads of 192, beside SDPA on the first pinned backend
   (``decomp/vit.py::SDPA_BACKENDS``) that takes the shape, named, twice at
   B = 8 S = 6272 and at S = 9604 (equal bits), each logging its estimated
   shared-memory fill from L2 and the rate it implies;
4. flash ablation builds (``mimo_tpu_torch.tools.ablate_flash``, the
   production kernel's body at each mode): ``full`` equal in every bit to
   the production kernel (``flash_attention_nt``) at UNet levels 0 and 1
   and a ragged shape; there every mode, in both layouts, against its
   plain version; each stand-in mode's output moves with an input it
   keeps; then the tool's own run (every mode in both layouts timed at
   B=24, Sq=6272, Sk=12544, d=40, beside its bound and SDPA) with its
   launch count read just after;
5. main path: a small-input agreement check (card, bf16 + kernels, against
   the CPU fp32 plain path), then a full-width MIMOConfig() generation of a
   24-frame 512x784 clip with CFG through ``entry.animate.animate``, twice
   through one Runner with the same seed; the second run's video must equal
   the first's in every bit, its phase times and kernel launch counts are
   printed and every synthesis kernel's count must be > 0 (Hiera's row
   passes, ``TRACK_ONLY``, run on the tracker's path alone), and it runs
   under ``torch.cuda.set_sync_debug_mode("warn")``: its host synchronisations
   are printed by the source line that made them, with their counts (a
   count of a multiple of the steps is one a step); then the window sum of
   a 41-frame clip (three overlapping context windows, some frames in all
   three) 20 times in fp32, which must give one result, and the clip at
   256x256 for 2 steps twice through the same Runner, whose two videos must
   be equal in every bit;
6. edit path: ``entry.edit.edit`` through phase 5's Runner on a 48-frame
   720x1280 template drawn in memory (a figure walking far enough for
   several ROI shots, a textured background, an occlusion patch it passes
   through) at 784x784, CFG 3.5, 3 DDIM steps; prints the shots, the
   generated frames and windows, the phase times, the paste-back's time
   (``entry.edit.paste_back``, on the card), the clip's copies, the peak
   device memory and every kernel's launch count (each synthesis kernel's
   must be > 0); the
   card's paste-back against the host's numpy one (``composite_back``) on
   the same inputs: the largest gap in uint8 levels and the pixels that
   differ; checks 48 uint8 720x1280 frames, the occ patch equal to vid
   and everything outside the shots' bboxes equal to bk within 1, a pasted
   region that is not constant, and a second run equal in every bit; then
   one 150-frame (the CLI's --max-frames) 1-step run, which must fit the
   card;
7. decomp track: Hiera's row passes against the eager chain
   (``hiera_rows_check``: bias + GELU over every bf16 pattern and each pass
   at stage-1 / stage-3 shapes equal in every bit, LN within 1 bf16 ulp,
   a whole Hiera-L encode, each pass's time beside its byte bound), then
   a small-input agreement check (SAM2 at real head widths
   and reduced depth at 512x512, 10 frames so the memory ring fills and
   wraps, card bf16 + flash against the CPU fp32 plain path: the frames'
   encoding, the memory attention and the mask decoder, each call taken
   again on the CPU from the card call's own inputs, and one Hiera-L
   global block's d = 72 flash attention against the fp32 plain attention
   on its own q, k, v, which sees a x1.25 softmax scale; that check runs
   the eager frame loop), the full-width tracker's frame loop as CUDA
   graphs against its eager loop (two clips, each from a keyframe in its
   middle and again on its cached encode: equal bits), then the
   decomposition half's track stage at full width through
   ``mimo_tpu_torch.tools.profile_decomp`` (SAM ViT-H, SAM2 Hiera-L and
   ViTPose-H, seeded random bf16 weights) on a 48-frame 720x480 clip drawn
   in memory: the known box on frame 0 -> SAM + clean_mask -> SAM2 forwards
   and backwards -> get_bbox, one automatic_masks and one detector call on
   frame 0; prints each call's time, the peak memory and the flash launches
   by head width (d = 72 and d = 16 must both be > 0, and Hiera's row
   passes' launches too); checks (48, 720,
   480) bool masks, frame 0 equal to the prompt frame's mask, (48, 4)
   boxes inside the frame, and the timed run equal in every bit to the
   warm-up run before it (each encodes the clip);
8. decomp pose + motion: a small-input agreement check (the card against
   the CPU fp32 plain path on the card call's own inputs: HMR2 at real head
   widths and 2 backbone blocks, ``lbs`` of the surface SMPL-H, the z-buffer
   render at 720x480: alpha equal off the faces' edges, rgb and depth
   within 1e-5), then through ``mimo_tpu_torch.tools.profile_decomp`` the
   pose stage (ViTPose-H, flip test) and the motion stage (ViTPose-H, HMR2,
   HaMeR, the fuse, ``lbs`` of the surface SMPL-H, the render, and HaMeR on
   keypoints that find both hands) at full width on phase 7's clip and
   boxes, seeded random bf16 weights (the pose heads' updates scaled by
   0.1 and HMR2's camera at its mean, so the posed body is framed in its
   box), each an untimed pass then the timed one; prints each call's time,
   the host crop time, the raster's candidate tests and time a frame, the
   peak memory and the kernel launches (none of the 15 kernels is on this
   path); checks (48, 133, 3) keypoints, a (48, 720, 480, 3) uint8 sdc
   whose body covers 5-50% of every frame with its centroid inside the
   frame's person box, HaMeR crops > 0 and the timed run equal in every
   bit to the untimed one; then the bf16 posed vertices of the clip ten
   times, a batch of its first half before every other call, which must
   all be equal in every bit (``repeat_check``: the ViTs' attention stays
   off cuDNN, whose bits did not repeat after other shapes; ``--calibrate
   repeat`` shows the check fails with cuDNN put back); then renders the template framed as
   ``tools/profile_raster.py`` frames it (it must cover 5-50% of the frame)
   and a mesh of random vertex triples (``gen_smpl``'s faces), printing
   their time, candidate tests and memory;
9. decomp bk + occ: a small-input agreement check (tiny RAFT + ProPainter
   ``inpaint_video`` of a 14-frame 16x24 clip, every chunk rule taken, and
   the tiny DepthAnythingV2, card fp32 against CPU fp32; limits between
   the sound seeds and two planted faults, flow_warp's x and y swapped and
   the deformable offsets' tanh bound dropped), then at full width (seeded
   random bf16 weights) on phase 7's clip and known masks: the background
   stage (``VideoProcessor.get_bk_recover``: RAFT, flow completion, image
   propagation, the sliding windows) untimed then timed through
   ``tools/profile_decomp.py``, printing each phase's time, the peak
   memory and the back-off ratio, and checking a (48, 720, 480, 3) uint8
   background, equal bits, a finite composite, the ratio 1.0 and the frame
   within one level outside the dilated masks; then DINOv2-L's d = 64
   flash (2073 tokens, q/k/v views) against fp32 plain attention on one
   block's own inputs, and ``VideoProcessor.get_occ`` with phase 8's sdc
   twice (equal bits), printing the keyframes, the candidates, the
   occluders kept, the tracks run and the seconds; d = 64 and d = 16 flash
   launches must be > 0;
10. decomp run -> animate -> edit through the port's commands, OpenCV held
   off as on the card: phase 7's clip drawn at 1.5x (48 frames 1080x720)
   and written as the port writes video without OpenCV (an uncompressed
   AVI); ``VideoProcessor.run`` into a template directory at full width
   (every bundle, seeded random bf16 weights with phases 7-9's
   adjustments; the detector replaced by the figure's box and, where the
   random ViTPose fails it, the full-body gate by the figure's keypoints),
   which caps the clip to 720x480; each stage's seconds, the stage files'
   write and read times, the template's bytes, the peak memory and flash
   launches by head width (d = 16, 64 and 72 must be > 0); every stage file
   read back equal in every bit to its stage's output, (48, 4) boxes inside
   the frame, and a resumed run that recomputes only the occlusion stage
   and writes every file again equal in every bit; then ``python3 -m
   mimo_tpu_torch decomp --max-frames 8`` unpatched (seeded weights) in a
   subprocess, which must exit with a pipeline code, print its line and
   write vid.mp4; then ``animate`` (24 frames 512x784, 2 steps) and
   ``edit`` (784x784 ROI shots, 2 steps) through
   ``mimo_tpu_torch.__main__.main`` from that template and a reference PNG
   the port wrote (beside it, a 2048x2048 RGBA PNG of Paeth rows, as image
   tools write them, must read back to its pixels; both loads are timed):
   each must launch every main-path kernel; 24 uint8
   784x512 frames that are not constant; 48 uint8 720x480 edited frames
   equal to bk within 1 outside the shots' bboxes (and the occlusion mask);
11. the multi-process layer through ``mimo_tpu_torch.entry.graft``'s
   spawner (``torch.multiprocessing`` in spawn mode, every rank on this
   card: NCCL refuses two ranks on one card, so worlds of 2 and 4 run over
   gloo): (a) the frame-parallel flagship (``MIMOConfig()``, phase 5's
   24-frame 512x784 clip, CFG 3.5, 2 DDIM steps, one window; the motion
   modules' all-to-all) on 2 ranks, rank 0's video against the single
   process within the limit of ``--calibrate multi``, a second run equal
   in every bit, and rank 0's launches of every main-path kernel > 0; (b)
   window DP on phase 5's 41-frame 256x256 clip (two window-parallel
   windows and the frame-sharded tail), within that limit, each rank's
   UNet window-frames showing no padded window; (c) (a) on an NCCL world
   of 1, equal in every bit to the single process and to its own second
   run; (d) the 2-D (2, 2) mesh on (b)'s clip, within the limit; (e) the
   motion stage (phase 8's models) frame-parallel on 2 ranks on phase 7's
   48 frames and a ragged 47, in fp32: the posed vertices within 1e-5 of
   the single process's, the frame-parallel render of one vertex set and
   the sharded sdc equal to single-process renders in every bit, and the
   sdc within one uint8 level of the single process's but at pixels on a
   face edge or a depth tie (the nearest two faces' depths, from the
   renderer's own tests, within 1e-6 of the depth), where the vertices'
   rounding can flip them, and at most 300 such pixels; and in bf16 the
   same, and on each rank the single-process posed vertices ten times,
   the sharded posed vertices before every other call, all equal in every
   bit (``--calibrate repeat`` shows this fails with cuDNN put back).
   Prints each run's prepare / step / decode times, all-to-all bytes and
   seconds a step, peak memory per rank and the phase's wall time; any
   rank's failure fails the script;
12. the kernels' JSON line (``launches`` from the run of the entry's
   ``path``: phase 5, 6 or the tool's run of phase 4; the "decomp" path's
   flash entries count their head width's launches in phases 7 and 9; under
   "decomp-run" one row a kernel launched in phase 10, a flash wrapper's
   one a head width, with its phase-10 launches; under "frame-parallel"
   phase 3's temporal chain at the positions a rank holds and one row a
   kernel with rank 0's launches in phase 11 (a)), then the last line:
   {"ok": true, "device": {...}}.

``python3 chip_smoke.py --calibrate [main] [decomp] [motion] [bk] [multi]
[repeat]`` runs phases 1-2, then the readings that place the limits of the
small-input agreement checks of phases 5, 7, 8 and 9 and of phase 11
(sound seeds and planted faults; all five without a section named), and
prints no result line; ``repeat`` runs phase 8's and phase 11 (e)'s bf16
repeat checks at weight seeds 0-3 as they are and with cuDNN's attention
put back into ``decomp/vit.py``'s ``SDPA_BACKENDS`` (the fault they
guard), and says whether each check passed.
``python3 chip_smoke.py --kernels`` runs phases 1-3 and the GEMM tile
core's breakdown (each launch of the FFN and of q|k|v timed alone, beside
variants that drop one piece of the work and beside torch.matmul of the
same products), then prints phase 3's numbers as one JSON line, and no
result line: run from another tree's checkout, it times that tree's kernels
on the same cases.

Needs no JAX, no OpenCV and no files from outside the repository; weights
are random, drawn from a seeded torch.Generator. Phase 10 writes its clip
and template into a temporary directory (``TMPDIR``) and removes it.
"""

import contextlib
import dataclasses
import json
import os
import re
import struct
import subprocess
import sys
import tempfile
import time
import warnings
import zlib
from collections import Counter

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
from mimo_tpu_torch.tools.timing import (PEAK_BF16, PEAK_BYTES,  # noqa: E402
                                         PEAK_FP32, SFU_PER_CLOCK, bound,
                                         exp2_ms, flash_work, sm_clock)
from mimo_tpu_torch.tools.profile_decomp import framed_bodies  # noqa: E402

STEPS = 4            # DDIM steps of the full-width run
FRAMES, HEIGHT, WIDTH = 24, 512, 784
FLASH_ROUNDS = 5     # interleaved kernel / SDPA rounds of phase 3
# the edit run of phase 6: a 48-frame 720x1280 template edited at the CLI's
# 784x784 (98x98 latents: UNet levels of 9604 / 2401 / 625 / 169 tokens)
EDIT_FRAMES, EDIT_SRC, EDIT_SIZE, EDIT_STEPS = 48, (720, 1280), 784, 3
EDIT_MAX_FRAMES = 150   # the edit CLI's default --max-frames
EDIT_S = (9604, 2401, 625, 169)
# the temporal chain's (S, C) a rank on phase 11's frame-parallel path
FRAME_PARALLEL_S = ((3136, 320), (784, 640), (200, 1280), (52, 1280))


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() in ms (CUDA events, after one warm-up)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def check_close(name: str, got: torch.Tensor, want: torch.Tensor,
                atol: float, rtol: float, why: str) -> float:
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got - want).abs()
    max_err = float(err.max())
    ref_at = float(want.flatten()[err.argmax()].abs())
    excess = float((err - (atol + rtol * want.abs())).max())
    ok = excess <= 0
    log(f"  {name}: max_abs_err={max_err:.6g} at |ref|={ref_at:.4g} "
        f"(tolerance |d| <= {atol} + {rtol}*|ref|: {why}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version (max_abs_err {max_err})")
    return max_err


def phase_device() -> str:
    log("== phase 1: device")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(smi.stdout.strip().splitlines()[0])
    try:
        import triton
        triton_v = triton.__version__
    except ImportError:
        triton_v = "not installed"
    from mimo_tpu_torch.ops import _build
    nvcc = subprocess.run([_build.find_nvcc(), "--version"],
                          capture_output=True, text=True, check=True)
    log(f"python {sys.version.split()[0]} | torch {torch.__version__} | "
        f"cuda {torch.version.cuda} | triton {triton_v} | nvcc "
        f"{nvcc.stdout.strip().splitlines()[-1]}")
    sms, mhz = sm_clock()
    log(f"{sms} SMs x {mhz:.0f} MHz (max SM clock): exp2 bound "
        f"{exp2_ms(1e9) * 1e-3:.4g} s per 1e9 logits (MUFU alone "
        f"{1e9 / (SFU_PER_CLOCK * sms * mhz * 1e6):.4g} s)")
    return torch.cuda.get_device_name(0)


def phase_build() -> None:
    log("== phase 2: build")
    from mimo_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.load_library()
    secs = _build.build_seconds()
    log(f"  library {_build.library_path().name}: "
        f"{'built in %.1f s' % secs if secs is not None else 'cached'} "
        f"(load {time.perf_counter() - t0:.1f} s)")
    # ptxas -v: registers and spills of each kernel (mangled names), and
    # any warning (C7508: setmaxnreg ignored) or note of a performance loss
    # (C7515 / C7520: wgmma products serialized); the ablation builds'
    # (flash_ablate_kernel<d, mode, pretransposed>) are summed up after
    from mimo_tpu_torch.tools.ablate_flash import MODES
    kernels, notes = _build.ptxas_report(_build.build_log())
    bad = [n for n in notes if "setmaxnreg" in n]
    ablation = []
    for line in notes:
        log(f"  {line}")
    for name, regs, spills in kernels:
        inst = re.search(r"flash_ablate_kernelILi(\d+)ELi(\d+)ELb([01])E",
                         name)
        if inst:
            d, mode, pre = inst.groups()
            ablation.append(f"d={d} {MODES[int(mode)]}"
                            f"{' pretransposed' if pre == '1' else ''}: "
                            f"{regs}; {spills}")
        else:
            log(f"  ptxas {name}: {regs}; {spills}")
        if any(k in name for k in ("gemm_kernel", "flash_fwd_kernel",
                                    "flash_wide_kernel", "tattn_kernel",
                                    "gn_kernel", "gn_resident_kernel",
                                    "ln_rows_kernel", "ln_rows_wide_kernel",
                                    "hiera_bias_gelu_kernel",
                                    "hiera_bias_res_kernel")) \
                and not spills.startswith("0 bytes"):
            bad.append(f"{name}: {spills}")
    log(f"  flash ablation builds ({len(ablation)}; a spill there counts in "
        f"full - mode):")
    for line in sorted(ablation, key=lambda x: (int(x[2:4]), x)):
        log(f"    {line}")
    if bad:
        raise AssertionError(f"kernel build: {bad}")


def call_wrapper(wrapper, *args, **kwargs):
    """Call a kernel wrapper on card tensors; it must launch its kernel
    exactly once (its count goes up by one) and return the result."""
    before = wrapper.launches
    out = wrapper(*args, **kwargs)
    if wrapper.launches != before + 1:
        raise AssertionError(f"{wrapper.__name__}: launch count went from "
                             f"{before} to {wrapper.launches} in one call")
    return out


def kernel_entry(name, source, replaces, label, err, run, plain, work,
                 library=None, path="animate"):
    """Time the wrapper, its plain version and the library yardstick
    (``library`` = (description, fn), or (reason there is none, None));
    ``work`` = (flops, bytes[, peak[, logits]]) of the function for its
    bound; ``path``: the run whose launch counts the entry reports
    ("animate", phase 5; "edit", phase 6; "decomp", phase 7; "tool", the
    ablation tool's run of phase 4). One entry of the JSON line."""
    ms = cuda_ms(run, 10)
    plain_ms = cuda_ms(plain, 3)
    lib_what, lib_fn = library or ("no single call", None)
    library_ms = cuda_ms(lib_fn, 10) if lib_fn is not None else None
    bound_ms, bound_by, what = bound(*work)
    log(f"    time: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, library "
        f"{'%.3f ms' % library_ms if library_ms is not None else '-'} "
        f"({lib_what}); bound {bound_ms:.3f} ms by {what} "
        f"({bound_ms / ms:.0%} of it)")
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                shape=label, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                library=lib_what, path=path)


def median_range(xs, fmt="%.3f", scale=1.0):
    """'median (min-max)' of sorted xs, each scaled and formatted."""
    m, lo, hi = (fmt % (x * scale) for x in (xs[len(xs) // 2], xs[0], xs[-1]))
    return f"{m} ({lo} to {hi})"


def sdpa_call(q, k, v, heads, bank=()):
    """F.scaled_dot_product_attention on the same q/k/v viewed as (B, H, S,
    d), the bank concatenated to the keys beforehand."""
    import torch.nn.functional as F
    k, v = concat_bank(k, v, bank)
    qh, kh, vh = (x.unflatten(-1, (heads, -1)).transpose(1, 2)
                  for x in (q, k, v))
    return ("F.scaled_dot_product_attention",
            lambda: F.scaled_dot_product_attention(qh, kh, vh))


def concat_bank(k, v, bank):
    """k and v with the bank appended to every row's keys (contiguous)."""
    if not bank:
        return k, v
    b = k.shape[0]
    return (torch.cat([k, bank[0].expand(b, -1, -1)], dim=1),
            torch.cat([v, bank[1].expand(b, -1, -1)], dim=1))


def phase_kernels():
    """Each kernel wrapper against its plain version on the card, at the
    main path's and the edit path's shapes. Returns one entry of measured
    numbers per case."""
    log("== phase 3: kernel wrappers vs plain versions (card, main-path "
        "shapes)")
    from mimo_tpu_torch.ops import ffn as FF
    from mimo_tpu_torch.ops import flash_attention as FA
    from mimo_tpu_torch.ops import groupnorm as GN
    from mimo_tpu_torch.ops import temporal_attention as TA
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    bf = torch.bfloat16

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf)

    entries = []
    flash_why = ("bf16 output (8-bit mantissa) and P rounded to bf16 for "
                 "P.V; reference fp32 on the same bf16 inputs")
    # (wrapper, heads, d, batch, sq, sk1, sk2, views): UNet levels 0 and 1
    # on a 2-row batch subset; ragged query and key edges; d = 64 and 160
    # (the 64-key tiles and the 3-box tiles) with a bank of 333; banks of
    # 777 and 333 keys (not a multiple of the 128- or 64-key tile); level 0
    # with q/k/v as column views of one (2, 6272, 3 * 320) q|k|v result, as
    # the main path calls it
    cases = [
        (FA.flash_attention_nt, 8, 40, 2, 6272, 6272, 0, False),
        (FA.flash_attention_nt, 8, 80, 2, 1568, 1568, 0, False),
        (FA.flash_attention_nt, 8, 40, 2, 1100, 1000, 0, False),
        (FA.flash_attention_nt_bank, 8, 40, 2, 6272, 6272, 6272, False),
        (FA.flash_attention_nt_bank, 8, 80, 2, 1568, 1568, 1568, False),
        (FA.flash_attention_nt_bank, 8, 80, 2, 1568, 1568, 777, False),
        (FA.flash_attention_nt_bank, 8, 64, 2, 1100, 1000, 333, False),
        (FA.flash_attention_nt_bank, 8, 160, 2, 1100, 1000, 333, False),
        (FA.flash_attention_nt, 8, 40, 2, 6272, 6272, 0, True),
        (FA.flash_attention_nt_bank, 8, 40, 2, 6272, 6272, 6272, True),
    ]
    # the edit path's levels 0 and 1 (last query tile of 4 rows at level 0;
    # B = 1 there: the plain version's fp32 logits take ~6 GB a batch row)
    edit_cases = [
        (FA.flash_attention_nt, 8, 40, 1, 9604, 9604, 0, False),
        (FA.flash_attention_nt_bank, 8, 40, 1, 9604, 9604, 9604, False),
        (FA.flash_attention_nt, 8, 80, 2, 2401, 2401, 0, False),
        (FA.flash_attention_nt_bank, 8, 80, 2, 2401, 2401, 2401, False),
    ]
    # the decomposition half's track stage (phase 7): Hiera-L's stage-3
    # global blocks (d = 72, 8 heads, 64x64 tokens of one 8-frame encode
    # chunk, q/k/v strided views of one (B, S, 3 * 576) q|k|v product) and
    # the SAM / SAM2 decoders' image -> token attention (d = 16, 4096 image
    # tokens against 7 prompt tokens; B = 1, and one automatic_masks prompt
    # chunk of 256)
    decomp_cases = [
        (FA.flash_attention_nt, 8, 72, 8, 4096, 4096, 0, True),
        (FA.flash_attention_nt, 8, 16, 1, 4096, 7, 0, False),
        (FA.flash_attention_nt, 8, 16, 256, 4096, 7, 0, False),
        # the occlusion stage's DINOv2-L (phase 9): 16 heads of 64 over the
        # 56x37 grid of a 720x480 frame plus the cls token, 2073 tokens (16
        # full 128-row query tiles and one of 25), q/k/v column views of
        # one (1, 2073, 3 * 1024) q|k|v product
        (FA.flash_attention_nt, 16, 64, 1, 2073, 2073, 0, True),
    ]
    for (wrapper, heads, d, b, sq, sk1, sk2, views), path in (
            [(c, "edit" if c[4] in EDIT_S else "animate")
             for c in cases + edit_cases]
            + [(c, "decomp") for c in decomp_cases]):
        inner = heads * d
        # LN-scaled activations through random projections: logits of a
        # few units, so the softmax is neither flat nor one-hot
        if views:
            qkv = randn(b, sq, 3 * inner, scale=2.0)
            qkv[..., 2 * inner:] /= 2
            q, k, v = qkv.split(inner, dim=-1)
        else:
            q = randn(b, sq, inner, scale=2.0)
            k = randn(b, sk1, inner, scale=2.0)
            v = randn(b, sk1, inner)
        bank = (randn(1, sk2, inner, scale=2.0), randn(1, sk2, inner)) \
            if sk2 else ()
        args = (q, k, v, *bank, heads)
        got = call_wrapper(wrapper, *args)
        torch.cuda.synchronize()
        want = FA.attention_plain(q, k, v, heads, *bank)
        label = (f"{wrapper.__name__} d={d} B={b} Sq={sq} Sk={sk1}"
                 + (f"+bank {sk2}" if sk2 else "")
                 + (" (q|k|v views)" if views else ""))
        err = check_close(label, got, want, 2e-2, 2e-2, flash_why)
        n_in = sum(t.numel() for t in (q, k, v, *bank))
        entries.append(kernel_entry(
            wrapper.__name__, "mimo_tpu_torch/csrc/flash_attention.cu",
            "mimo_tpu/ops/flash_transposed.py:"
            + ("403" if sk2 else "222"), label, err,
            lambda: wrapper(*args),
            lambda: FA.attention_plain(q, k, v, heads, *bank),
            flash_work(b, heads, d, sq, sk1 + sk2, n_in),
            sdpa_call(q, k, v, heads, bank), path))
        entries[-1]["width"] = d

    # the kernel against SDPA on the same inputs, at UNet levels 0 and 1 on
    # the 2-row subset and at the full main-path batch (the uncond/cond
    # half), timed in turns over FLASH_ROUNDS rounds: median and range of
    # each and of the kernel's excess over SDPA a round
    for wrapper, d, s in ((FA.flash_attention_nt, 40, 6272),
                          (FA.flash_attention_nt_bank, 40, 6272),
                          (FA.flash_attention_nt, 80, 1568),
                          (FA.flash_attention_nt_bank, 80, 1568)):
        for b in (2, 24):
            q, k, v = (randn(b, s, 8 * d) for _ in range(3))
            bank = ((randn(1, s, 8 * d), randn(1, s, 8 * d))
                    if wrapper is FA.flash_attention_nt_bank else ())
            sdpa = sdpa_call(q, k, v, 8, bank)[1]
            rounds = [(cuda_ms(lambda: wrapper(q, k, v, *bank, 8), 10),
                       cuda_ms(sdpa, 10)) for _ in range(FLASH_ROUNDS)]
            ms, sdpa_ms = (sorted(t) for t in zip(*rounds))
            excess = sorted(a / c - 1 for a, c in rounds)
            sk = s + (s if bank else 0)
            n_in = sum(t.numel() for t in (q, k, v, *bank))
            bound_ms, _, what = bound(*flash_work(b, 8, d, s, sk, n_in))
            log(f"  {wrapper.__name__} d={d} B={b} S={s}, {FLASH_ROUNDS} "
                f"rounds, median (min-max): kernel {median_range(ms)} ms, "
                f"SDPA {median_range(sdpa_ms)} ms, kernel/SDPA - 1 "
                f"{median_range(excess, '%+.1f%%', 100)}; bound "
                f"{bound_ms:.3f} ms by {what} ({bound_ms / ms[len(ms) // 2]:.0%}"
                f" of the median)")

    entries += wide_flash_cases(FA, randn, flash_why)
    entries += group_norm_cases(GN, randn)
    entries += ln_rows_cases(FF, randn)
    entries += gemm_chain_cases(FF, TA, randn)
    entries += temporal_core_cases(TA, randn)
    return entries


# the wide flash kernel (flash_attention_wide) at the VAE mid block's one
# head of d = 512: (heads, d, batch, sq, sk, path) of a vae_chunk of 8
# frames at 512x784, the encode's last chunk (1 frame: 49 query tiles of
# 128, 98 blocks, under one wave), edit's 784x784 (the plain version's
# logits 315 MB a 1024-query chunk), the animate CLI's 256x256, ragged
# query and key edges; 1036 / 980: the last query tile's 12 rows leave its
# second warpgroup none, and the last key tile holds 20 keys; and 2 heads
# of 192 (3 boxes of 64 columns split 2 / 1 between the two blocks of a
# query tile, the second head at a column offset). The first case and
# S = 9604 run twice (equal bits).
WIDE_CASES = [(1, 512, 8, 6272, 6272, "animate"),
              (1, 512, 1, 6272, 6272, "animate"),
              (1, 512, 8, 9604, 9604, "edit"),
              (1, 512, 8, 1024, 1024, "animate"),
              (1, 512, 2, 1100, 1000, "animate"),
              (1, 512, 2, 1036, 980, "animate"),
              (2, 192, 2, 1100, 1000, "animate")]
WIDE_TWICE = {(1, 512, 8, 6272, 6272), (1, 512, 8, 9604, 9604)}


def sdpa_backend_call(q, k, v, heads):
    """F.scaled_dot_product_attention on (B, H, S, d) views of q/k/v, on the
    first of ``decomp/vit.py``'s pinned SDPA_BACKENDS (torch's own order
    among them) that takes the shape: (description naming it, fn), or
    (reason, None)."""
    import torch.nn.functional as F
    from torch.nn.attention import sdpa_kernel
    from mimo_tpu_torch.decomp.vit import SDPA_BACKENDS
    qh, kh, vh = (x.unflatten(-1, (heads, -1)).transpose(1, 2)
                  for x in (q, k, v))
    for backend in SDPA_BACKENDS:
        def fn(backend=backend):
            with sdpa_kernel([backend]):
                return F.scaled_dot_product_attention(qh, kh, vh)
        try:
            with warnings.catch_warnings():  # torch's reasons a backend
                warnings.simplefilter("ignore")  # refuses the shape
                fn()
        except RuntimeError:
            continue
        return f"F.scaled_dot_product_attention ({backend.name})", fn
    return "no SDPA backend of SDPA_BACKENDS takes it", None


def wide_flash_cases(FA, randn, why):
    """``flash_attention_wide`` against its plain version at WIDE_CASES,
    inputs scaled as the flash cases' (logits of a few units), beside SDPA
    on the first pinned backend that takes d = 512 (SDPA's flash backend
    stops at d = 256); the WIDE_TWICE cases twice, which must give equal
    bits. Each case also logs the estimated bytes the kernel's blocks
    receive into shared memory from L2 (``tools/time_flash_wide.py::
    fill_bytes``) and the rate its time implies; neither is measured, and
    neither enters the kernels' JSON line."""
    from mimo_tpu_torch.tools.time_flash_wide import fill_bytes
    entries = []
    for heads, d, b, sq, sk, path in WIDE_CASES:
        inner = heads * d
        q = randn(b, sq, inner, scale=2.0)
        k = randn(b, sk, inner, scale=2.0)
        v = randn(b, sk, inner)
        got = call_wrapper(FA.flash_attention_wide, q, k, v, heads)
        torch.cuda.synchronize()
        want = FA.attention_plain(q, k, v, heads)
        label = f"flash_attention_wide d={d} H={heads} B={b} Sq={sq} Sk={sk}"
        err = check_close(label, got, want, 2e-2, 2e-2, why)
        del got, want
        if (heads, d, b, sq, sk) in WIDE_TWICE:
            bit_equal(label,
                      lambda: FA.flash_attention_wide(q, k, v, heads))
        entries.append(kernel_entry(
            "flash_attention_wide", "mimo_tpu_torch/csrc/flash_wide.cu",
            "mimo_tpu/ops/attention.py:103", label, err,
            lambda: FA.flash_attention_wide(q, k, v, heads),
            lambda: FA.attention_plain(q, k, v, heads),
            flash_work(b, heads, d, sq, sk,
                       q.numel() + k.numel() + v.numel()),
            sdpa_backend_call(q, k, v, heads), path))
        fill = fill_bytes(b, heads, d, sq, sk)
        log(f"    shared-memory fill from L2 (estimated): {fill / 1e9:.3f} "
            f"GB, {fill / (entries[-1]['ms'] * 1e-3) / 1e12:.2f} TB/s at "
            f"the kernel's time")
        entries[-1]["width"] = d
    return entries


def bit_equal(label: str, fn) -> None:
    """fn() twice on the same inputs must give equal bits."""
    first, second = fn(), fn()
    torch.cuda.synchronize()
    same = torch.equal(first, second)
    log(f"  {label}, run twice: {'equal in every bit' if same else 'DIFFER'}")
    if not same:
        raise AssertionError(f"{label}: two runs differ")


def group_norm_cases(GN, randn):
    """``group_norm_fused`` against ``group_norm_plain`` at every GroupNorm
    shape of a UNet3D step (levels 0-3) and of the VAE decoder
    (``tools/time_norms.py::GN_CASES``, then EDIT_GN_CASES at 784x784),
    beside F.group_norm where no row
    add or SiLU is fused; then a level-0 call (the resident tier's clusters
    of 16), a level-1 call (clusters of 6) and a level-0 call at C = 960
    (the stream tier), and at 784x784 a level-0 call (stream) and a level-1
    call at C = 960 (clusters of 9) each twice, which must give equal
    bits; then small
    and odd shapes through both tiers."""
    from mimo_tpu_torch.tools import time_norms as TN
    why = ("bf16 output rounding (<= 1 ulp = 2^-7 relative) on fp32 "
           "statistics summed in another order")
    bf = torch.bfloat16
    entries = []
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for n, s, c, radd, silu in TN.GN_CASES + EDIT_GN_CASES:
        groups, eps = 32, TN.gn_eps(silu)
        # the Pallas variant the JAX package takes there: the UNet's (S, N,
        # C); the VAE's frames resident in VMEM where 4 slabs and 2 row
        # tiles fit its 40 MiB (64x98), else two-phase
        vmem = 4 * s * c * 2 + 2 * min(s, 1024) * c * 4
        replaces = ("mimo_tpu/ops/groupnorm.py:"
                    + ("221" if n == 48 else "275" if vmem <= 40 * 2 ** 20
                       else "298"))
        x = randn(n, s, c, scale=3.0) + 0.5
        scale = randn(c).float() * 0.5 + 1.0
        bias = randn(c).float() * 0.5
        ra = randn(n, c) if radd else None
        args = (x, scale, bias, groups, eps, silu, ra)
        got = call_wrapper(GN.group_norm_fused, *args)
        torch.cuda.synchronize()
        plan = GN.gn_plan(n, s, c, groups, 2, sms)
        label = (f"group_norm_fused ({n}, {s}, {c}) G={groups} eps={eps}"
                 f"{' +row_add' if radd else ''}{' +silu' if silu else ''} "
                 + (f"[resident: clusters of {plan.cluster} x {plan.rows} "
                    f"rows x {plan.cw} channels]"
                    if isinstance(plan, GN.ResidentPlan) else
                    f"[stream: {plan.teams} teams x {plan.team} blocks x "
                    f"{plan.rows} rows]"))
        err = check_close(label, got, GN.group_norm_plain(*args), 1e-2, 1e-2,
                          why)
        # one read and one write of x; ~10 fp32 operations an element
        # (stats 3, normalise + affine 3, SiLU 4)
        work = (x.numel() * (10 if silu else 6), 2 * 2 * x.numel()
                + (2 * ra.numel() if radd else 0), PEAK_FP32)
        library = None
        if not (radd or silu):
            xt = x.transpose(1, 2).contiguous()   # (N, C, S), same values
            sb, bb = scale.to(bf), bias.to(bf)
            library = ("F.group_norm on an (N, C, S) copy",
                       lambda: torch.nn.functional.group_norm(xt, groups, sb,
                                                              bb, eps))
        entry = kernel_entry("group_norm_fused",
                             "mimo_tpu_torch/csrc/groupnorm.cu", replaces,
                             label, err, lambda: GN.group_norm_fused(*args),
                             lambda: GN.group_norm_plain(*args), work, library,
                             "edit" if (n, s, c, radd, silu) in EDIT_GN_CASES
                             else "animate")
        log(f"    {2 * x.numel() * 2 / (entry['ms'] * 1e-3) / 1e9:.0f} GB/s "
            f"for 1 read + 1 write")
        entries.append(entry)
    for n, s, c in ((48, 6272, 320), (48, 1568, 640), (48, 6272, 960),
                    (48, 9604, 320), (48, 2401, 960)):
        x = randn(n, s, c, scale=3.0) + 0.5
        args = (x, randn(c).float() + 1.0, randn(c).float(), 32, 1e-5, True,
                randn(n, c))
        bit_equal(f"group_norm_fused ({n}, {s}, {c}) +row_add +silu",
                  lambda: GN.group_norm_fused(*args))
    # small and odd shapes through both tiers (forced), fp32 and bf16: a
    # cluster of 8 blocks with a ragged last one (the slice budget made
    # small), C/G = 4, 8, 30 and 80, a chunk that is all of C, one row
    for (n, s, c), groups, dtype, budget in (
            ((2, 333, 320), 32, torch.float32, 7000),
            ((3, 910, 128), 32, bf, GN.SLICE_BUDGET),
            ((2, 50, 960), 32, torch.float32, GN.SLICE_BUDGET),
            ((1, 1, 2560), 32, bf, GN.SLICE_BUDGET),
            ((5, 1000, 24), 3, bf, GN.SLICE_BUDGET)):
        x = (randn(n, s, c, scale=3.0) + 0.5).to(dtype)
        args = (x, randn(c).float() + 1.0, randn(c).float(), groups, 1e-5,
                True, randn(n, c))
        want = GN.group_norm_plain(*args)
        tol = 1e-2 if dtype == bf else 1e-4
        for tier in ("stream", "resident"):
            plan = GN.gn_plan(n, s, c, groups, x.element_size(), sms,
                              tier=tier, budget=budget)
            label = f"group_norm {tier} ({n}, {s}, {c}) G={groups} {dtype}"
            check_close(f"{label} {plan}",
                        GN.group_norm_cuda(*args, plan=plan), want, tol, tol,
                        why if dtype == bf else "fp32 output, sums in "
                        "another order")
            bit_equal(label, lambda: GN.group_norm_cuda(*args, plan=plan))
    return entries


# GroupNorm at the edit path's 784x784, as tools/time_norms.py::GN_CASES
# at 512x784: (n, s, c, row add, SiLU) of UNet levels 0-3 (98x98 latents)
# and the VAE decoder's 98x98 ... 784x784 frames
EDIT_GN_CASES = [(48, 9604, 320, True, True), (48, 9604, 320, False, False),
                 (48, 9604, 640, False, True), (48, 9604, 960, False, True),
                 (48, 2401, 640, True, True), (48, 2401, 640, False, False),
                 (48, 2401, 960, False, True), (48, 2401, 1920, False, True),
                 (48, 625, 1280, True, True), (48, 625, 1280, False, False),
                 (48, 625, 2560, False, True), (48, 169, 1280, False, False),
                 (48, 169, 2560, False, True), (8, 9604, 512, False, False),
                 (8, 38416, 512, False, True), (8, 153664, 256, False, True),
                 (8, 614656, 128, False, True)]
# the LN pass at 784x784: (rows, K, PE frames), as time_norms.LN_CASES
EDIT_LN_CASES = [(48 * 9604, 320, 0), (48 * 2401, 640, 0),
                 (48 * 625, 1280, 0), (48 * 169, 1280, 0),
                 (48 * 9604, 320, 24)]


def ln_rows_cases(FF, randn):
    """The LN row pass (``ln_rows``, the tile core's LN prologue) against
    ``ln_rows_plain`` at UNet levels 0-3 (48 frames) and with the motion
    modules' PE at level 0 (``tools/time_norms.py::LN_CASES``), beside
    F.layer_norm; the PE at level 3 (the wide-row kernel, as at levels
    2-3), K = 232 (ragged) and EDIT_LN_CASES (784x784); then K = 232, 136
    (17 vectors: 8 lanes x 3, some idle), 64 (one vector a lane), 1280 and
    2048 (past the register plan) through both kernels (forced); then one
    level-0 call twice, which must give equal bits."""
    import torch.nn.functional as F
    from mimo_tpu_torch.tools import time_norms as TN
    why = ("LN rounded to bf16 (then + PE, rounded again) on fp32 statistics "
           "(E[x^2] - E[x]^2 against a centred variance, summed in another "
           "order): |d| <= 2^-6 max|ref| (two bf16 ulps of the largest "
           "value)")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    entries = []
    # (rows, K, PE frames): rows (b·F + f)·S + s of a CFG pair of F frames
    # for the PE
    for rows, c, frames in TN.LN_CASES + [(2 * 24 * 104, 1280, 24),
                                          (1000, 232, 0)] + EDIT_LN_CASES:
        x = randn(rows, c, scale=2.0) + 0.3
        scale, bias = randn(c, scale=0.3) + 1.0, randn(c, scale=0.3)
        pe = randn(frames, c, scale=0.5) if frames else None
        args = (x, scale, bias, 1e-5, pe, rows // (2 * frames) if frames else 1)
        got = call_wrapper(FF.ln_rows, *args)
        torch.cuda.synchronize()
        plan = FF.ln_rows_plan(rows, c, sms)
        label = (f"ln_rows R={rows} K={c}{' +pe F=%d' % frames if frames else ''}"
                 + (f" [{plan.lanes} lanes x {plan.vectors} vectors a row, "
                    f"{plan.steps_per_warp} row steps a warp]" if plan.vectors
                    else " [wide-row kernel: a warp a row]"))
        want = FF.ln_rows_plain(*args)
        err = check_close(label, got, want,
                          float(want.float().abs().max()) / 64, 0.0, why)
        # x read once, y written once, the vectors; ~8 fp32 operations an
        # element (stats 3, normalise + affine 4, PE 1)
        work = (8 * rows * c, 2 * (2 * rows * c + 2 * c + frames * c),
                PEAK_FP32)
        library = (("no single call: LN, then + PE", None) if frames else
                   ("F.layer_norm", lambda: F.layer_norm(x, (c,), scale, bias,
                                                         1e-5)))
        entries.append(kernel_entry(
            "ln_rows", "mimo_tpu_torch/csrc/ln_rows.cu",
            "mimo_tpu/ops/ffn.py:245", label, err,
            lambda: FF.ln_rows(*args), lambda: FF.ln_rows_plain(*args), work,
            library, "edit" if (rows, c, frames) in EDIT_LN_CASES
            else "animate"))
    for c in (232, 136, 64, 1280, 2048):
        x = randn(999, c, scale=2.0) + 0.3
        pe = randn(5, c, scale=0.5)
        args = (x, randn(c, scale=0.3) + 1.0, randn(c, scale=0.3), 1e-5, pe,
                37)
        want = FF.ln_rows_plain(*args)
        plans = {FF.ln_rows_plan(999, c, sms, short_runs=0),
                 FF.ln_rows_plan(999, c, sms)}
        for plan in sorted(plans):
            check_close(f"ln_rows_cuda R=999 K={c} +pe {plan}",
                        FF.ln_rows_cuda(*args, plan=plan), want,
                        float(want.float().abs().max()) / 64, 0.0, why)
    x = randn(48 * 6272, 320, scale=2.0) + 0.3
    args = (x, randn(320, scale=0.3) + 1.0, randn(320, scale=0.3), 1e-5)
    bit_equal("ln_rows R=301056 K=320", lambda: FF.ln_rows(*args))
    return entries


def gemm_chain_cases(FF, TA, randn):
    """The GEMM-chain wrappers (ops/ffn.py) and the temporal attention
    (ops/temporal_attention.py) against their plain versions: the
    unfused composition on the same bf16 weights and inputs."""
    why = ("both sides bf16 with the same rounding points; a product summed "
           "in another order can flip the rounding of an intermediate, so "
           "|d| <= 2^-6 max|ref| (two bf16 ulps of the largest value)")

    def lin(k, n, bias=True):
        p = {"kernel": randn(k, n, scale=k ** -0.5)}
        if bias:
            p["bias"] = randn(n, scale=0.1)
        return p

    def ln(c):
        return {"scale": randn(c, scale=0.3) + 1.0, "bias": randn(c, scale=0.3)}

    def check(label, got, want):
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        err = 0.0
        for i, (g, w) in enumerate(zip(got, want)):
            atol = float(w.float().abs().max()) / 64
            err = max(err, check_close(f"{label}[{i}]" if len(got) > 1
                                       else label, g, w, atol, 0.0, why))
        return err

    ffn_src = "mimo_tpu_torch/csrc/gemm.cu"
    entries = []
    # (rows, C): 48 frames (the CFG batch) at UNet level 0 (64x98 latents,
    # 6272 tokens), level 2 (the stride-2 pad-1 convs halve with ceil:
    # 64x98 -> 32x49 -> 16x25, 400 tokens) and level 3 (8x13, 104 tokens);
    # then ragged edges of the tile core: fewer rows than one 128-row tile,
    # level 3's rows at C=320, and C=232 (K past whole 64-deep stages, N
    # past whole tiles, GEGLU value/gate tiles cut at the edge)
    # then the edit path's levels 0-3 at 784x784 (98x98 latents: R mod 128
    # = 64 / 48 / 48 / 48, a ragged last row tile at every level)
    edit_rows = [(48 * s, c) for s, c in zip(EDIT_S, (320, 640, 1280, 1280))]
    for rows, c in ((48 * 6272, 320), (48 * 400, 1280), (48 * 104, 1280),
                    (48 * 104, 320), (40, 1280), (40, 320), (1000, 232),
                    *edit_rows):
        x = randn(rows, c, scale=2.0) + 0.3
        ln_p, res = ln(c), randn(rows, c)
        ff_p = {"proj_in": lin(c, 8 * c), "proj_out": lin(4 * c, c)}
        attn = {k: lin(c, c, bias=False) for k in ("to_q", "to_k", "to_v")}
        out = lin(c, c)
        x2, h = x.reshape(rows, c), randn(rows, 4 * c)
        w3 = torch.cat([attn[k]["kernel"] for k in ("to_q", "to_k", "to_v")],
                       dim=1)
        w_in, w_out = ff_p["proj_in"]["kernel"], ff_p["proj_out"]["kernel"]
        # bytes: x (also the residual) read once, the weights, vectors
        # and the output written once; the FFN's (R, 4C) not counted
        rc, cc = rows * c, c * c
        for wrapper, plain, replaces, args, work, library in (
                (FF.ffn_ln_geglu_fused, FF.ffn_ln_geglu_plain,
                 "mimo_tpu/ops/ffn.py:161", (x, ln_p, ff_p),
                 (24 * rc * c, 2 * (2 * rc + 12 * cc + 11 * c)),
                 ("torch.matmul of the up and down products",
                  lambda: (torch.matmul(x2, w_in), torch.matmul(h, w_out)))),
                (FF.qkv_ln_fused, FF.qkv_ln_plain,
                 "mimo_tpu/ops/ffn.py:245", (x, ln_p, attn),
                 (6 * rc * c, 2 * (4 * rc + 3 * cc + 2 * c)),
                 ("torch.matmul of the (C, 3C) product",
                  lambda: torch.matmul(x2, w3))),
                (FF.matmul_bias_residual, FF.matmul_bias_residual_plain,
                 "mimo_tpu/ops/ffn.py:415", (x, out, res),
                 (2 * rc * c, 2 * (3 * rc + cc + c)),
                 ("torch.matmul of the product",
                  lambda: torch.matmul(x2, out["kernel"]))),
                (FF.matmul_bias, FF.matmul_bias_plain,
                 "mimo_tpu/ops/ffn.py:371", (x, out),
                 (2 * rc * c, 2 * (2 * rc + cc + c)),
                 ("torch.addmm", lambda: torch.addmm(out["bias"], x2,
                                                     out["kernel"])))):
            got = call_wrapper(wrapper, *args)
            torch.cuda.synchronize()
            label = f"{wrapper.__name__} R={rows} C={c}"
            err = check(label, got, plain(*args))
            entries.append(kernel_entry(
                wrapper.__name__, ffn_src, replaces, label, err,
                lambda: wrapper(*args), lambda: plain(*args), work, library,
                "edit" if (rows, c) in edit_rows else "animate"))

    # motion modules: (B=2, F=24, S, C), 8 heads; levels 0-3 at 512x784,
    # then at 784x784
    levels = list(zip((6272, 1568, 400, 104) + EDIT_S,
                      (320, 640, 1280, 1280) * 2))
    # and the frame-parallel path's positions a rank (phase 11 (a): S / 2
    # at levels 0-3)
    levels += FRAME_PARALLEL_S
    for s, c in levels:
        x = randn(2, 24, s, c, scale=2.0)
        attn = {k: lin(c, c, bias=False) for k in ("to_q", "to_k", "to_v")}
        attn["to_out"] = lin(c, c)
        ln_p, pe = ln(c), randn(24, c, scale=0.5)
        args = (attn, ln_p, pe, x, 8)
        got = call_wrapper(TA.temporal_attention_ln, *args)
        torch.cuda.synchronize()
        label = f"temporal_attention_ln (2, 24, {s}, {c}) heads=8"
        err = check(label, got, TA.temporal_attention_plain(*args))
        # q|k|v and out products, the F x F attention (4 F FLOP a channel
        # of a row); x read once, 4 weights, vectors, pe, the output
        rc = x.numel()
        work = (8 * rc * c + 4 * 24 * rc, 2 * (2 * rc + 4 * c * c + 3 * c
                                              + 24 * c))
        entries.append(kernel_entry(
            "temporal_attention_ln", "mimo_tpu_torch/csrc/temporal_attention.cu",
            "mimo_tpu/ops/temporal_attention.py:212", label, err,
            lambda: TA.temporal_attention_ln(*args),
            lambda: TA.temporal_attention_plain(*args), work,
            ("no single call: LN + PE, two products and an F x F softmax "
             "attention", None),
            "edit" if s in EDIT_S else "frame-parallel"
            if (s, c) in FRAME_PARALLEL_S else "animate"))
    return entries


def temporal_core_cases(TA, randn):
    """The temporal attention core alone (``temporal_attn_core``, the
    kernel between the chain's two tile-core calls) against
    ``temporal_attn_core_plain`` at the motion modules' levels and at F = 5
    and 32, beside SDPA over contiguous (B·S, H, F, d) copies of q, k, v
    made before the timing (a yardstick the port never calls)."""
    import torch.nn.functional as F
    from mimo_tpu_torch.tools import time_tattn_core as TC
    why = ("a softmax weight can round to the neighbouring bf16 value (fp32 "
           "logits summed in another order, exp2 for exp: <= 2^-8 max|v| on "
           "o) and o can round the other way (2^-8 max|v|): |d| <= 2^-7 "
           "max|v|")
    entries = []
    edit = [(2, 24, s, c, 8) for s, c in zip(EDIT_S, (320, 640, 1280, 1280))]
    for b, f, s, c, heads in TC.CASES + edit:
        qkv = randn(b * f * s, 3 * c, scale=2.0)
        args = (qkv, b, f, s, heads)
        got = call_wrapper(TA.temporal_attn_core, *args)
        torch.cuda.synchronize()
        label = f"temporal_attn_core B={b} F={f} S={s} C={c} heads={heads}"
        err = check_close(label, got, TA.temporal_attn_core_plain(*args),
                          2 ** -7 * float(qkv[:, 2 * c:].float().abs().max()),
                          0.0, why)
        q, k, v = TC.sdpa_inputs(*args)
        flops, nbytes, logits = TC.core_work(b, f, s, c, heads)
        entries.append(kernel_entry(
            "temporal_attn_core", "mimo_tpu_torch/csrc/temporal_attention.cu",
            "mimo_tpu/ops/temporal_attention.py:212", label, err,
            lambda: TA.temporal_attn_core(*args),
            lambda: TA.temporal_attn_core_plain(*args),
            (flops, nbytes, PEAK_BF16, logits),
            ("F.scaled_dot_product_attention on contiguous (B·S, H, F, d) "
             "copies", lambda: F.scaled_dot_product_attention(q, k, v)),
            "edit" if s in EDIT_S else "animate"))
    return entries


def gemm_breakdown() -> None:
    """Where the tile core's time goes, at UNet levels 0, 1 and 2 (48
    frames): each launch of the LN + GEGLU FFN and of LN + q|k|v timed
    alone, beside variants that drop one piece of the work, torch.matmul
    of the same products and F.gelu. Differences read as costs: ``up
    geglu`` − ``up 8C`` is the GEGLU epilogue beyond the store of twice its
    output; ``qkv ln`` − ``qkv`` is the LN pass."""
    log("== GEMM tile core breakdown (ms)")
    import torch.nn.functional as F
    from mimo_tpu_torch.ops import ffn as FF
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(torch.bfloat16)

    for rows, c in ((48 * 6272, 320), (48 * 1568, 640), (48 * 400, 1280)):
        x, h = randn(rows, c), randn(rows, 4 * c)
        w_in, b_in = randn(c, 8 * c, scale=c ** -0.5), randn(8 * c, scale=0.1)
        w_out = randn(4 * c, c, scale=(4 * c) ** -0.5)
        b_out = randn(c, scale=0.1)
        w3 = randn(c, 3 * c, scale=c ** -0.5)
        ln = (randn(c, scale=0.3) + 1.0, randn(c, scale=0.3), 1e-5)
        w_v, b_v = w_in[:, :4 * c].contiguous(), b_in[:4 * c].contiguous()
        cases = {
            # the FFN's first launch: (R, C) x (C, 8C), GEGLU epilogue
            "up geglu": lambda: FF.gemm(x, w_in, bias=b_in, geglu=True),
            # the same value columns alone, + bias (no gate, no gelu)
            "up 4C bias": lambda: FF.gemm(x, w_v, bias=b_v),
            # all 8C columns, no epilogue work beyond the store
            "up 8C": lambda: FF.gemm(x, w_in),
            # the FFN's second launch: (R, 4C) x (4C, C) + bias + x
            "down +res": lambda: FF.gemm(h, w_out, bias=b_out, res=x),
            "qkv": lambda: FF.gemm(x, w3),
            "qkv ln": lambda: FF.gemm(x, w3, ln=ln),
            "torch up 8C": lambda: torch.matmul(x, w_in),
            "torch down": lambda: torch.matmul(h, w_out),
            "torch qkv": lambda: torch.matmul(x, w3),
            "torch gelu": lambda: F.gelu(h),
        }
        for name, fn in cases.items():
            log(f"  R={rows} C={c} {name}: {cuda_ms(fn, 20):.4f} ms")


def phase_ablation():
    """The ablation builds of the flash kernel against their plain
    versions, then the tool's main path. Returns (entries, {name: launches
    of the tool's run})."""
    log("== phase 4: flash ablation builds (tools/ablate_flash.py port)")
    from mimo_tpu_torch.ops import flash_attention as FA
    from mimo_tpu_torch.tools import ablate_flash as AB
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4321)
    bf = torch.bfloat16

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf)

    attn = (2e-2, 2e-2, "bf16 output and P rounded to bf16 for P.V; "
            "reference fp32 on the same bf16 inputs")
    # the stand-ins' outputs are weighted means of v (or shares in [0, 1])
    # that can be far smaller than 1: hold them to two bf16 ulps of their
    # largest value, as the GEMM chain is
    stand_in = ("P rounded to bf16 where the kernel feeds it to an mma, on "
                "both sides; fp32 sums in another order can flip a bf16 "
                "output rounding, so |d| <= 2^-6 max|ref|")
    name, src = "ablate_flash.run", "mimo_tpu_torch/csrc/flash_ablate.cu"
    entries = []
    heads = 8
    # (d, B, Sq, Sk): UNet level 0 self + bank keys, level 1, ragged
    for d, b, sq, sk in ((40, 2, 6272, 12544), (80, 2, 1568, 3136),
                         (40, 2, 1100, 1000)):
        q = randn(b, sq, heads * d, scale=2.0)
        k = randn(b, sk, heads * d, scale=2.0)
        v = randn(b, sk, heads * d)
        # `full` is the production instantiation of the shared body: the
        # same bits as the production kernel on the same inputs
        full = call_wrapper(AB.run, q, k, v, heads, "full")
        prod = FA.flash_attention_nt(q, k, v, heads)
        torch.cuda.synchronize()
        same = torch.equal(full, prod)
        log(f"  run(mode='full') d={d} B={b} Sq={sq} Sk={sk} vs "
            f"flash_attention_nt: {'equal in every bit' if same else 'DIFFER'}")
        if not same:
            raise AssertionError("ablate_flash full differs from the "
                                 "production flash kernel")
        for pre in (False, True):
            lay = AB.pretranspose if pre else (lambda x: x)
            args = tuple(lay(x) for x in (q, k, v))
            for mode in AB.MODES:
                got = call_wrapper(AB.run, *args, heads, mode, pre)
                torch.cuda.synchronize()
                label = (f"{name} {mode}{' pretransposed' if pre else ''} "
                         f"d={d} B={b} Sq={sq} Sk={sk}")
                want = AB.run_plain(*args, heads, mode, pre)
                if mode in AB.ATTENTION_MODES:
                    err = check_close(label, got, want, *attn)
                else:
                    err = check_close(label, got, want,
                                      float(want.float().abs().max()) / 64,
                                      0.0, stand_in)
                    # move an input the mode still computes with: the q/k
                    # elements of the rank-1 stand-in, else one key row
                    q2, k2 = q.clone(), k.clone()
                    if mode in ("noqk", "nomxu"):
                        q2[:, :, ::d] += 0.5
                    else:
                        k2[:, 0, :] += 1.0
                    moved = call_wrapper(AB.run, lay(q2), lay(k2), args[2],
                                         heads, mode, pre)
                    change = float((moved.float() - got.float()).abs().max())
                    log(f"    dependency: output moves by {change:.4g}")
                    if change == 0.0:
                        raise AssertionError(f"{label}: output does not "
                                             f"depend on a kept input")
                if (d, sq) == (40, 6272):
                    # SDPA computes `full`
                    library = (sdpa_call(q, k, v, heads)
                               if mode == "full" and not pre else
                               ("no single call: an ablation stand-in",
                                None))
                    entries.append(kernel_entry(
                        name, src, "tools/ablate_flash.py:210", label, err,
                        lambda: AB.run(*args, heads, mode, pre),
                        lambda: AB.run_plain(*args, heads, mode, pre),
                        AB.mode_work(mode, b, heads, d, sq, sk), library,
                        "tool"))

    log("  the tool's run: python -m mimo_tpu_torch.tools.ablate_flash")
    AB.run.launches = 0
    times = AB.main()
    launches = AB.run.launches
    log(f"  kernel launches in the tool's run: {{'{name}': {launches}}}")
    if launches <= 0 or not all(t > 0 for t in times.values()):
        raise AssertionError("the ablation tool did not launch its kernel")
    return entries, {name: launches}


def agreement_error(seed: int, fault=None):
    """Tiny-config generation at 256x256 (level-0 attention over 1024
    tokens, so the flash kernels run) on the card in bf16 against the CPU
    fp32 plain path on the same weights and inputs. ``fault`` (a context
    manager factory) plants a known error in the card run only. Returns
    (max, mean) absolute error over [0, 1] pixels."""
    from mimo_tpu_torch import config as C
    from mimo_tpu_torch.entry.runner import init_random_params
    from mimo_tpu_torch.pipelines import pose2vid
    cfg = C.tiny_mimo_config()
    f, h, w = 4, 256, 256
    gen = torch.Generator().manual_seed(seed)
    params = init_random_params(cfg, gen, dtype=torch.float32)
    # the motion modules' zero-init proj_out would hide them: give weights
    den = params["denoising_unet"]
    for blk in den["down"] + den["up"] + [den["mid"]]:
        for mm in blk["motions"] or []:
            c = mm["proj_out"]["kernel"].shape[0]
            mm["proj_out"] = {"kernel": torch.randn(c, c, generator=gen) * 0.1,
                              "bias": torch.randn(c, generator=gen) * 0.1}
    rng = np.random.default_rng(seed)
    ref = rng.uniform(-1, 1, (h, w, 3)).astype(np.float32)
    pose = rng.uniform(0, 1, (f, h, w, 3)).astype(np.float32)
    bk = rng.uniform(-1, 1, (f, h, w, 3)).astype(np.float32)
    clip_px = rng.standard_normal((32, 32, 3)).astype(np.float32)
    noise = rng.standard_normal((f, h // 8, w // 8, 4)).astype(np.float32)
    st = pose2vid.Pose2VideoStatic(cfg=cfg, num_frames=f, height=h, width=w,
                                   num_inference_steps=2, guidance_scale=3.5)

    def run(device, dtype, tree):
        args = [torch.from_numpy(a).to(device, dtype)
                for a in (ref, pose, bk, clip_px, noise)]
        return pose2vid.generate_host_loop(tree, st, *args).float().cpu()

    want = run("cpu", torch.float32, params)
    cuda_params = _map_tree(params, lambda t: t.to("cuda", torch.bfloat16))
    if fault is None:
        got = run("cuda", torch.bfloat16, cuda_params)
    else:
        with fault():
            got = run("cuda", torch.bfloat16, cuda_params)
    err = (got - want).abs()
    return float(err.max()), float(err.mean())


# The card-vs-CPU limits sit between the sound runs and the planted faults
# of ``python3 chip_smoke.py --calibrate`` (readings in PERF.md).
AGREE_MEAN_TOL = 1e-2
AGREE_MAX_TOL = 0.25


def small_input_agreement() -> None:
    from mimo_tpu_torch.ops import flash_attention as FA
    before = FA.flash_attention_nt_bank.launches
    mx, mean = agreement_error(7)
    if FA.flash_attention_nt_bank.launches == before:
        raise AssertionError("small-input run did not reach the flash kernel")
    log(f"  tiny 4x256x256 2-step generation, card bf16 vs CPU fp32: "
        f"max_abs_err={mx:.4g}, mean_abs_err={mean:.4g} (tolerance mean <= "
        f"{AGREE_MEAN_TOL}, max <= {AGREE_MAX_TOL} on [0, 1] pixels: between "
        f"the sound seeds and the planted faults of --calibrate)")
    if not (mean <= AGREE_MEAN_TOL and mx <= AGREE_MAX_TOL):
        raise AssertionError("card output disagrees with the CPU reference")


def _map_tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_tree(v, fn) for v in tree]
    return None if tree is None else fn(tree)


def template_frames(count=FRAMES):
    """A ``count``-frame 512x784 sdc-like pose clip and a reference image,
    drawn in memory (a figure walking across a black frame)."""
    frames = []
    for t in range(count):
        f = np.zeros((HEIGHT, WIDTH, 3), np.uint8)
        cx = 250 + 10 * t
        f[120:420, cx - 45:cx + 45] = (120, 180, 90)      # torso + legs
        f[60:120, cx - 28:cx + 28] = (200, 120, 80)       # head
        f[150:170, cx - 110 + 3 * t:cx + 110 - 3 * t] = (80, 90, 200)  # arms
        frames.append(f)
    ref = np.full((700, 480, 3), 255, np.uint8)
    ref[150:620, 170:310] = (30, 60, 160)
    ref[80:150, 205:275] = (220, 170, 140)
    return ref, frames


def phase_main_path():
    log("== phase 5: main path")
    small_input_agreement()
    from mimo_tpu_torch import config as C
    from mimo_tpu_torch.entry.animate import animate
    from mimo_tpu_torch.entry.runner import Runner, init_random_params
    dev = torch.device("cuda")
    cfg = C.MIMOConfig()
    t0 = time.perf_counter()
    params = init_random_params(cfg, torch.Generator(device=dev).manual_seed(0),
                                dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"  full-width MIMOConfig() weights: {n_params / 1e9:.3f} B params "
        f"(bf16), random init {time.perf_counter() - t0:.1f} s")
    runner = Runner(cfg=cfg, params=params, device=dev, dtype=torch.bfloat16)
    ref, frames = template_frames()
    kw = dict(width=WIDTH, height=HEIGHT, steps=STEPS, cfg_scale=3.5, seed=42)
    log(f"  animate: {FRAMES} frames {HEIGHT}x{WIDTH}, CFG 3.5, {STEPS} DDIM "
        f"steps (UNet3D batch {2 * FRAMES} frames of "
        f"{HEIGHT // 8}x{WIDTH // 8} latents)")
    t0 = time.perf_counter()
    first = animate(runner, ref, frames, **kw)
    log(f"  run 1 (warm-up): {time.perf_counter() - t0:.2f} s wall")

    counters = reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    video, syncs = host_syncs(lambda: animate(runner, ref, frames, **kw))
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    tm = runner.last_timings
    log(f"  run 2 (sync debug mode 'warn'): {wall:.2f} s wall | prepare "
        f"{tm['prepare']:.1f} ms | mean step {tm['step_mean']:.1f} ms | "
        f"decode {tm['decode']:.1f} ms (CUDA events) | peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    same = np.array_equal(first, video)
    log(f"  run 2 against run 1 (same Runner, seed 42): "
        f"{'equal in every bit' if same else 'DIFFER'}")
    if not same:
        raise AssertionError("a second run of the clip differs from the "
                             "first")
    log(f"  host synchronisations in run 2, {STEPS} steps "
        f"(torch.cuda.set_sync_debug_mode('warn')): {sum(syncs.values())}")
    for (where, msg), n in syncs.most_common():
        log(f"    {n} at {where}: {msg}")
    log(f"  kernel launches in run 2: {launches}")
    for name in unlaunched(launches):
        raise AssertionError(f"the main path never launched {name}")
    if video.shape != (FRAMES, HEIGHT, WIDTH, 3):
        raise AssertionError(f"output shape {video.shape}")
    if not np.isfinite(video).all():
        raise AssertionError("output has non-finite values")
    std = float(video.std())
    log(f"  output {video.shape} finite, min {video.min():.4f} max "
        f"{video.max():.4f} std {std:.4f}")
    if std <= 1e-4:
        raise AssertionError("output is constant")
    window_determinism(runner)
    return launches, runner


def host_syncs(fn):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("warn")``, the mode
    restored after: its result and the host synchronisations it made (each
    keeps the host from running ahead of the card), by (file:line,
    message)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return out, Counter(
        (f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}",
         str(w.message).split(" (Triggered")[0])
        for w in caught if "called a synchronizing" in str(w.message))


def accumulation_determinism(pose2vid, win, wts, runs: int = 20) -> None:
    """The step's window sum alone, in fp32 at the main path's latent size
    (64x98x4), ``runs`` times on the card: ``accumulate_windows`` must give
    one result. Beside it, for scale, the same adds as one ``index_add_``
    over the whole chunk (the scatter it replaced): atomics pick the order
    of a frame's adds, which decides the fp32 bits once three windows meet.
    The clip below rounds these sums into bf16 latents, which hides most
    one-ulp differences, so this check is the sharper of the two."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    lat = (64, 98, 4)
    preds = torch.randn((*win.shape, *lat), generator=gen, device=dev)
    idx = torch.as_tensor(win, dtype=torch.long, device=dev)
    wt = torch.as_tensor(wts, device=dev)

    def windowed():
        nsum = torch.zeros((int(win.max()) + 1, *lat), device=dev)
        pose2vid.accumulate_windows(nsum, preds, idx, wt)
        return nsum

    def one_scatter():
        nsum = torch.zeros((int(win.max()) + 1, *lat), device=dev)
        nsum.index_add_(0, idx.reshape(-1),
                        (preds * wt[:, None, None, None, None]).flatten(0, 1))
        return nsum

    distinct = {name: len({fn().cpu().numpy().tobytes() for _ in range(runs)})
                for name, fn in (("accumulate_windows", windowed),
                                 ("one index_add_ a chunk", one_scatter))}
    log(f"  window sum, fp32 {win.shape[0]} windows x {win.shape[1]} frames "
        f"x {lat}, {runs} runs: distinct results {distinct}")
    if distinct["accumulate_windows"] != 1:
        raise AssertionError("accumulate_windows is not deterministic")


def window_determinism(runner) -> None:
    """A clip longer than one context window, generated twice: the windows
    overlap, some frames lie in three of them, so the order of a frame's
    fp32 adds decides its bits (two adds onto zero commute); the two runs
    must agree in every bit."""
    from mimo_tpu_torch.entry.animate import animate
    from mimo_tpu_torch.pipelines import pose2vid
    frames, size = 41, 256
    st = pose2vid.Pose2VideoStatic(cfg=runner.cfg, num_frames=frames,
                                   height=size, width=size,
                                   num_inference_steps=2, guidance_scale=3.5)
    win, wts = pose2vid.make_windows(st)
    cover = np.bincount(win.reshape(-1))
    shared = int((cover > 1).sum())
    if cover.max() < 3:
        raise AssertionError(f"{frames} frames put no frame in three windows")
    accumulation_determinism(pose2vid, win, wts)
    ref, clip = template_frames(frames)
    kw = dict(width=size, height=size, steps=2, cfg_scale=3.5, seed=7)
    t0 = time.perf_counter()
    runs = [animate(runner, ref, clip, **kw) for _ in range(2)]
    same = np.array_equal(runs[0], runs[1])
    log(f"  window determinism: {frames} frames {size}x{size}, 2 steps, "
        f"{win.shape[0]} windows sharing {shared} frames (up to "
        f"{cover.max()} windows a frame): two runs "
        f"{'equal in every bit' if same else 'DIFFER'} (max |d| "
        f"{float(np.abs(runs[0] - runs[1]).max()):.3g}, "
        f"{time.perf_counter() - t0:.1f} s)")
    if not same:
        raise AssertionError("two runs of one clip differ")


def edit_template(count, speed):
    """A ``count``-frame template of EDIT_SRC (H x W) frames drawn in
    memory, as ``entry.template.Template``: a figure (an sdc-like pose
    render on black) walks ``speed`` pixels a frame, turning at the frame's
    edges; bk is a textured background, vid the background with the figure
    painted in, occ a fixed patch the figure passes through. Returns the
    template and the occlusion patch (rows, cols)."""
    from mimo_tpu_torch.entry.template import Template
    h, w = EDIT_SRC
    yy, xx = np.mgrid[0:h, 0:w]
    bk = np.stack([(xx // 3 + yy // 5) % 200 + 30,
                   (xx // 7) % 90 + 100 + (yy // 40) % 2 * 40,
                   (yy // 2) % 160 + 60], axis=-1).astype(np.uint8)
    occ_patch = (slice(380, 470), slice(560, 700))
    occ = np.zeros((h, w, 3), np.uint8)
    occ[occ_patch] = 255
    sdc, vid = [], []
    span = w - 2 * 140
    for t in range(count):
        p = (speed * t) % (2 * span)
        cx = 140 + (p if p < span else 2 * span - p)
        f = np.zeros((h, w, 3), np.uint8)
        f[250:550, cx - 45:cx + 45] = (120, 180, 90)            # torso, legs
        f[190:250, cx - 28:cx + 28] = (200, 120, 80)            # head
        f[280:300, cx - 110:cx + 110] = (80, 90, 200)           # arms
        sdc.append(f)
        body = f.any(-1)
        v = bk.copy()
        v[body] = f[body] // 2 + 90
        vid.append(v)
    tpl = Template(path="in-memory", fps=30, sdc=sdc, vid=vid,
                   bk=[bk] * count, occ=[occ] * count)
    return tpl, occ_patch


def phase_edit(runner):
    """The edit path (``entry.edit.edit``) at full width: ROI shots of an
    EDIT_FRAMES-frame template, one generation at EDIT_SIZE^2, the
    feathered, occlusion-aware paste-back; its checks; a second run for
    equal bits; then a run at the CLI's EDIT_MAX_FRAMES frames, 1 step,
    which must fit the card. Returns the first run's launch counts."""
    log("== phase 6: edit path")
    from mimo_tpu_torch.entry import edit as ED
    from mimo_tpu_torch.pipelines import pose2vid
    from mimo_tpu_torch.utils import frames as FU
    ref, _ = template_frames()
    kw = dict(width=EDIT_SIZE, height=EDIT_SIZE, cfg_scale=3.5, seed=42)

    def shots_of(tpl):
        """(context list, bbox list, generated frames, windows)."""
        _, _, _, _, ctx, bboxes = FU.crop_human_clip_auto_context(
            tpl.sdc, tpl.vid, tpl.bk, ED.OVERLAY)
        gen = sum(len(c) for c in ctx)
        st = pose2vid.Pose2VideoStatic(
            cfg=runner.cfg, num_frames=gen, height=EDIT_SIZE,
            width=EDIT_SIZE, num_inference_steps=1, guidance_scale=3.5)
        return ctx, bboxes, gen, pose2vid.make_windows(st)[0].shape[0]

    paste_s, pasted_args = [], []
    paste_back = ED.paste_back

    def timed_paste(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = paste_back(*args, **kwargs)
        torch.cuda.synchronize()
        paste_s.append(time.perf_counter() - t0)
        if not pasted_args:
            pasted_args.append((args, kwargs, out))
        return out

    tpl, occ_patch = edit_template(EDIT_FRAMES, 20)
    ctx, bboxes, gen, windows = shots_of(tpl)
    log(f"  template: {EDIT_FRAMES} frames {EDIT_SRC[0]}x{EDIT_SRC[1]}; "
        f"{len(ctx)} ROI shots {[(c[0], c[-1]) for c in ctx]} with bboxes "
        f"{bboxes}; {gen} generated frames at {EDIT_SIZE}x{EDIT_SIZE} in "
        f"{windows} context windows, CFG 3.5, {EDIT_STEPS} DDIM steps "
        f"(UNet3D batch {2 * windows * runner.cfg.pipeline.context_frames} "
        f"frames of {EDIT_SIZE // 8}x{EDIT_SIZE // 8} latents)")
    if len(ctx) < 2:
        raise AssertionError("the edit template made one ROI shot")
    counters = reset_counts()
    torch.cuda.reset_peak_memory_stats()
    ED.paste_back = timed_paste
    try:
        t0 = time.perf_counter()
        out = ED.edit(runner, ref, tpl, steps=EDIT_STEPS, **kw)
        wall = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in counters}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        again = ED.edit(runner, ref, tpl, steps=EDIT_STEPS, **kw)
    finally:
        ED.paste_back = paste_back
    tm = runner.last_timings
    log(f"  edit run 1: {wall:.2f} s wall | prepare {tm['prepare']:.1f} ms | "
        f"mean step {tm['step_mean']:.1f} ms | decode {tm['decode']:.1f} ms "
        f"(CUDA events) | paste_back {paste_s[0] * 1e3:.1f} ms (card, "
        f"host wall) | copies {tm['h2d_bytes'] / 1e6:.1f} MB up, "
        f"{tm['d2h_bytes'] / 1e6:.1f} MB back | peak device memory "
        f"{peak:.1f} GiB")
    # the card's paste-back against the host's numpy one on the same inputs
    args, _, card = pasted_args[0]
    video, p_ctx, p_bboxes, pad_info, bk, vid, occ = args
    t0 = time.perf_counter()
    host = ED.composite_back(
        video.float().cpu().numpy(), p_ctx, p_bboxes, pad_info,
        list(bk.cpu().numpy()), list(vid.cpu().numpy()),
        None if occ is None else list(occ.cpu().numpy()[..., None]))
    host_s = time.perf_counter() - t0
    gap = np.abs(card.cpu().numpy().astype(int) - np.stack(host).astype(int))
    log(f"  paste-back, card against host numpy (composite_back, "
        f"{host_s * 1e3:.0f} ms): largest gap {int(gap.max())} uint8 "
        f"levels, {int(gap.any(-1).sum())} of {gap[..., 0].size} pixels "
        f"differ")
    del pasted_args, video, bk, vid, occ, card
    log(f"  kernel launches in edit run 1: {launches}")
    for name in unlaunched(launches):
        raise AssertionError(f"the edit path never launched {name}")

    if len(out) != EDIT_FRAMES or any(
            f.shape != (*EDIT_SRC, 3) or f.dtype != np.uint8 for f in out):
        raise AssertionError(f"edit output: {len(out)} frames "
                             f"{out[0].shape} {out[0].dtype}")
    occ_err = bk_err = 0
    pasted = []
    for i, frame in enumerate(out):
        f = frame.astype(int)
        occ_err = max(occ_err, int(np.abs(f[occ_patch]
                                          - tpl.vid[i][occ_patch]).max()))
        inside = np.zeros(EDIT_SRC, bool)
        for c, (x0, x1, y0, y1) in zip(ctx, bboxes):
            if i in c:
                inside[y0:y1, x0:x1] = True
        outside = ~inside
        outside[occ_patch] = False
        bk_err = max(bk_err, int(np.abs(f[outside]
                                        - tpl.bk[i][outside]).max()))
        inside[occ_patch] = False
        pasted.append(frame[inside].astype(np.float32).std())
    same = all(np.array_equal(a, b) for a, b in zip(out, again))
    log(f"  output: {len(out)} frames {out[0].shape} uint8; |out - vid| in "
        f"the occ patch <= {occ_err}, |out - bk| outside the shots' bboxes "
        f"<= {bk_err} (limit 1 each: the cross-fade's float blend truncated "
        f"to uint8); pasted region std {min(pasted):.2f} to "
        f"{max(pasted):.2f}; run 2 {'equal in every bit' if same else 'DIFFERS'}")
    if occ_err > 1 or bk_err > 1:
        raise AssertionError("the paste-back changed pixels it must keep")
    if min(pasted) <= 1.0:
        raise AssertionError("a pasted region is constant")
    if not same:
        raise AssertionError("two edit runs differ")

    tpl, _ = edit_template(EDIT_MAX_FRAMES, 2)
    ctx, _, gen, windows = shots_of(tpl)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = ED.edit(runner, ref, tpl, steps=1, max_frames=EDIT_MAX_FRAMES, **kw)
    wall = time.perf_counter() - t0
    tm = runner.last_timings
    log(f"  edit at the CLI's --max-frames: {EDIT_MAX_FRAMES} frames, "
        f"{len(ctx)} shot(s), {gen} generated frames in {windows} windows "
        f"(window_chunk None: one UNet3D call of "
        f"{2 * windows * runner.cfg.pipeline.context_frames} frames), 1 step:"
        f" {wall:.2f} s wall | prepare {tm['prepare']:.1f} ms | step "
        f"{tm['step_mean']:.1f} ms | decode {tm['decode']:.1f} ms | peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB"
        f" of {torch.cuda.get_device_properties(0).total_memory / 2 ** 30:.1f}")
    if len(out) != EDIT_MAX_FRAMES:
        raise AssertionError(f"{len(out)} frames out of {EDIT_MAX_FRAMES}")
    return launches


def decomp_agreement_config():
    """SAM2 at real head widths and reduced depth at 512^2: Hiera-L's
    widths and heads with one block a stage but two in stage 3 (its second
    global: 32x32 = 1024 tokens of 8 heads of 72, so flash runs), one
    memory-attention layer, the full decoder (1024 image tokens, 8 heads of
    16)."""
    from mimo_tpu_torch.decomp import hiera as H
    from mimo_tpu_torch.decomp import sam2 as S2
    return S2.SAM2Config(hiera=H.HieraConfig(
        stages=(1, 1, 2, 1), global_blocks=(3,), input_size=(512, 512)),
        mem_layers=1)


# the agreement check's clip: frame 0 prompted, 9 tracked, so the ring of 6
# recent memories fills at the 7th tracked frame and drops its oldest after
DECOMP_AGREE_FRAMES = 10
# the modules the check holds, each at every call of the card run, and the
# output of each it compares: the frames' stride-16 features (Hiera, d = 72
# flash), the memory-conditioned features, and every candidate mask's
# low-res logits (the decoder, d = 16 flash), not the one the decoder picks:
# that pick is an argmax, and at a near-tie bf16 may tip it the other way
# (a sound seed of five did, at its first tracked frame: PERF.md)
DECOMP_MODULES = ("encode_frames", "memory_attention", "decode_masks")
# and, for a reading with less bf16 noise than the encoder's output, one
# Hiera-L global block's attention (the first d = 72 flash call of the
# card run: 8 frames x 32x32 tokens, 8 heads) against the fp32 plain
# attention on the CPU on that call's own q, k, v
GLOBAL_ATTENTION = "global_attention"


def decomp_agreement_error(seed: int, fault=None):
    """A SAM2 propagation (10 frames at 512x512: prompt frame 0 with five
    points, track 9) on the card in bf16 with the flash kernel, held module
    by module against the CPU fp32 plain path on the same weights (the
    card's bf16 values): each call of a module in ``DECOMP_MODULES`` is
    computed again on the CPU from the card call's own inputs, so each
    reading holds that module's error alone and no difference carries from
    one step to the next. ``fault`` (a context manager factory) plants a
    known error in the card run only. Returns {module: (max, mean)
    absolute error over its calls}, with one Hiera-L global block's flash
    attention (``GLOBAL_ATTENTION``) held to the fp32 plain attention on
    its own inputs, and the card run's flash launches by head width."""
    from mimo_tpu_torch.decomp import sam2 as S2
    from mimo_tpu_torch.ops import flash_attention as FAK
    cfg = decomp_agreement_config()
    gen = torch.Generator().manual_seed(seed)
    params = sharpen_attention(object_everywhere(
        S2.sam2_init(gen, cfg, torch.float32)))
    cuda_params = _map_tree(params, lambda t: t.to("cuda", torch.bfloat16))
    cpu_params = _map_tree(cuda_params, lambda t: t.to("cpu", torch.float32))
    rng = np.random.default_rng(seed)
    frames = [rng.integers(0, 256, (512, 512, 3)).astype(np.uint8)
              for _ in range(DECOMP_AGREE_FRAMES)]
    ys, xs = rng.integers(128, 384, (2, 5))
    points = np.stack([xs, ys], -1).astype(np.float32)

    calls = {name: [] for name in DECOMP_MODULES}
    from mimo_tpu_torch.ops import attention as AT
    global_calls = []

    def recording(flash):
        """``flash`` (the dispatch's kernel, a planted fault included),
        keeping its first d = 72 call."""
        def recorded(q, k, v, heads):
            out = flash(q, k, v, heads)
            if not global_calls and q.shape[2] // heads == 72:
                global_calls.append(((q, k, v, heads), out))
            return out
        return recorded

    def recorder(name):
        inner = getattr(S2, name)

        def recorded(p, c, *args):
            out = inner(p, c, *args)
            calls[name].append((args, out))
            return out
        return recorded

    widths = Counter(FAK.flash_attention_nt.widths)
    with (fault() if fault is not None else contextlib.nullcontext()), \
            contextlib.ExitStack() as stack:
        for name in DECOMP_MODULES:
            stack.enter_context(patched(S2, name, recorder(name)))
        # the eager frame loop: a captured frame's recorded output would be
        # the CUDA graph's buffer, not what that call computed
        stack.enter_context(patched(S2, "_use_graph", lambda device: False))
        stack.enter_context(patched(AT, "flash_attention_nt",
                                    recording(AT.flash_attention_nt)))
        pred = S2.SAM2VideoPredictor(cuda_params, cfg)
        pred.init_state(frames)
        pred.add_new_points(0, points, np.ones(5, np.int32))
        pred.propagate_logits(list(range(1, DECOMP_AGREE_FRAMES)))
    widths = FAK.flash_attention_nt.widths - widths

    def first(out):
        return out[0] if isinstance(out, tuple) else out

    errors = {}
    for name in DECOMP_MODULES:
        errs = [(first(out).float().cpu() - first(getattr(S2, name)(
            cpu_params, cfg, *(a.float().cpu() for a in args)))).abs()
            for args, out in calls[name]]
        errors[name] = (max(float(e.max()) for e in errs),
                        float(sum(e.sum() for e in errs)
                              / sum(e.numel() for e in errs)))
    (q, k, v, heads), out = global_calls[0]
    err = (out.float().cpu() - FAK.attention_plain(
        q.float().cpu(), k.float().cpu(), v.float().cpu(), heads)).abs()
    errors[GLOBAL_ATTENTION] = (float(err.max()), float(err.mean()))
    return errors, dict(widths)


def object_everywhere(sam2_params):
    """Random weights give SAM2's object score either sign, and "no object"
    sets every mask logit to -1024: bias the score head to "object" so the
    masks and the memory path carry the decoder's logits."""
    sam2_params["decoder"]["obj_mlp"]["fc3"]["bias"].fill_(10.0)
    return sam2_params


def sharpen_attention(tree, factor: float = 5.0):
    """Every attention's query and key projections scaled by ``factor``
    (logits by its square): at the default init the logits stay well
    under one, the softmax nearly uniform, and a fault in an attention
    (its scale, its keys, its rotation) hardly moves the output."""
    if isinstance(tree, list):
        for x in tree:
            sharpen_attention(x, factor)
    elif isinstance(tree, dict):
        if "qkv" in tree and "proj_attn" in tree:      # Hiera: q | k | v
            dout = tree["proj_attn"]["kernel"].shape[0]
            for leaf in tree["qkv"].values():
                leaf[..., :2 * dout] *= factor
        for name in ("to_q", "to_k", "q", "k"):
            if isinstance(tree.get(name), dict):
                for leaf in tree[name].values():
                    leaf *= factor
        for k, x in tree.items():
            if k not in ("qkv", "to_q", "to_k", "q", "k"):
                sharpen_attention(x, factor)
    return tree


# The card-vs-CPU limits of the decomposition check, (max, mean) a module,
# sit between the sound seeds and the planted faults of ``python3
# chip_smoke.py --calibrate`` (readings in PERF.md).
DECOMP_TOLS = {"encode_frames": (0.6, 0.08),
               "memory_attention": (0.15, 0.01),
               "decode_masks": (0.04, 0.004),
               GLOBAL_ATTENTION: (0.05, 0.004)}


def small_decomp_agreement() -> None:
    errors, widths = decomp_agreement_error(7)
    log(f"  SAM2 {DECOMP_AGREE_FRAMES}x512x512 propagate (real head widths, "
        f"reduced depth), card bf16 vs CPU fp32 on each call's own inputs "
        f"(limits between the sound seeds and the planted faults of "
        f"--calibrate); flash launches by width {widths}:")
    bad = []
    for name, (mx, mean) in errors.items():
        tmx, tmean = DECOMP_TOLS[name]
        ok = mx <= tmx and mean <= tmean
        log(f"    {name}: max_abs_err={mx:.4g} mean_abs_err={mean:.4g} "
            f"(tolerance max <= {tmx}, mean <= {tmean}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            bad.append(name)
    if not (widths.get(72) and widths.get(16)):
        raise AssertionError("the small decomposition run did not reach the "
                             "flash kernel at d = 72 and d = 16")
    if bad:
        raise AssertionError(f"the card's SAM2 disagrees with the CPU "
                             f"reference in {bad}")


def track_graph_agreement() -> None:
    """The frame loop as the card runs it, one CUDA graph a shape of the
    memory bank (``decomp/sam2.py::_FrameGraph``), against the same
    tracker's eager loop at full width (SAM2 Hiera-L, seeded random bf16
    weights) on two 48-frame 720x480 clips, the second the first mirrored:
    each tracked from a keyframe in its middle (both directions, the
    reverse one replaying graphs captured forwards), then from another
    keyframe on its cached encode, as the occlusion stage calls
    ``track_video``. Every mask and every frame's picked logits must be
    equal in every bit."""
    from mimo_tpu_torch.decomp import factory as FA
    from mimo_tpu_torch.decomp import sam2 as S2
    from mimo_tpu_torch.tools import profile_decomp as PD
    dev = torch.device("cuda")
    cfg = FA.configs(tiny=False)[FA.BUNDLES.index("sam2")]
    params = object_everywhere(FA.load_params(None, "sam2", cfg, dev,
                                              torch.bfloat16, 0))
    frames, masks, _ = PD.synth_frames(*PD.CLIP)
    clips = [(frames, masks),
             ([np.ascontiguousarray(f[:, ::-1]) for f in frames],
              np.ascontiguousarray(masks[:, :, ::-1]))]
    t = PD.CLIP[0]
    calls = [(c, kf) for c in range(len(clips)) for kf in (t // 2, t // 5)]
    runs = {}
    for mode, use in (("graphed", S2._use_graph),
                      ("eager", lambda device: False)):
        with patched(S2, "_use_graph", use):
            models = FA.build_decomp_models(params={"sam2": params},
                                            only={"sam2"}, device=dev)
            track = models.track_video
            t0 = time.perf_counter()
            runs[mode] = []
            for c, kf in calls:
                fr, m = clips[c]
                out = track(fr, m[kf], kf)
                runs[mode].append((out, track.last_record.picked().cpu()))
            log(f"  track {mode}: {len(calls)} calls (clip, keyframe) "
                f"{calls} in {time.perf_counter() - t0:.2f} s, "
                f"{len(track.tracker._graphs)} frame graphs")
            del models, track
            torch.cuda.empty_cache()
    bad = [calls[i] for i, ((a, pa), (b, pb)) in enumerate(
        zip(runs["graphed"], runs["eager"]))
        if not (np.array_equal(a, b) and torch.equal(pa, pb))]
    log(f"  track graphed vs eager: {len(calls) - len(bad)} of {len(calls)} "
        f"calls equal in every bit (masks and picked logits)")
    if bad:
        raise AssertionError(f"the graphed frame loop differs from the "
                             f"eager one in calls {bad}")


# Hiera-L's row passes a chunk of 8 frames at 1024^2 (rows, width): stage
# 1 (256^2 tokens, C = 144: GELU over 4C = 576) and stage 3 (64^2, 576)
HIERA_ROW_STAGES = {"stage 1": (8 * 256 * 256, 144),
                    "stage 3": (8 * 64 * 64, 576)}
# the LayerNorm pass's (rows, width) at the four stages
HIERA_LN_SHAPES = ((8 * 256 * 256, 144), (8 * 128 * 128, 288),
                   (8 * 64 * 64, 576), (8 * 32 * 32, 1152))
# and their windowed blocks' un-partitions: (grid, window, q-pooled), the
# last two a q-pooling block (stage 1 -> 2) and a grid the window pads
HIERA_UNPARTITIONS = (((256, 256), 8, False), ((64, 64), 16, False),
                      ((256, 256), 8, True), ((18, 22), 4, False))
# how much further from the fp32 encode the fused bf16 encode may lie
# than the eager bf16 one (mean gap a stage): the LN pass's variance
# formula moves a value by a bf16 step at most, which the random-weight
# blocks carry on, against a fault that moves whole rows
HIERA_ENCODE_GAP = 2.0


def _bits_differ(got: torch.Tensor, want: torch.Tensor) -> int:
    """Elements of two bf16 tensors whose bits differ."""
    return int((got.view(torch.int16) != want.view(torch.int16)).sum())


def _ln_ulps(got: torch.Tensor, ref: torch.Tensor, bias: torch.Tensor):
    """(largest |got - ref| in bf16 ulps at the scale of the affine's
    terms, max(|ref|, |ref - bias|, |bias|); largest |got - ref|) of a bf16
    LayerNorm against the fp32 one. Near zero, where the normalised term
    and the bias cancel, a bf16 step is far smaller than the terms' fp32
    rounding, so steps of the result itself mean nothing there."""
    terms = torch.maximum(torch.maximum(ref.abs(), (ref - bias).abs()),
                          bias.abs().expand_as(ref))
    ulp = torch.exp2(torch.floor(torch.log2(terms.clamp_min(2.0 ** -126)))
                     - 7)
    gap = (got.float() - ref).abs()
    return float((gap / ulp).max()), float(gap.max())


def hiera_rows_check() -> None:
    """The Hiera block's row passes (``ops/rows.py``, csrc/hiera_rows.cu)
    and LayerNorm pass (``ops/ffn.py::ln_rows``) against the eager chain on
    the card: bias + GELU over all 65,536 bf16 patterns, and bias + GELU
    and bias + residual (with and without the window map) at stage-1 and
    stage-3 shapes, each equal in every bit; LN within 1 bf16 ulp of
    ``F.layer_norm`` in fp32 at Hiera-L's four widths (``_ln_ulps``); a
    whole Hiera-L encode (2 frames at 1024^2): fused twice equal in every
    bit, the row passes with the eager LN equal in every bit to eager, and
    the fused four stage features no further from an fp32 encode than
    ``HIERA_ENCODE_GAP`` times the eager ones; each pass's time beside its
    HBM byte bound and the eager chain's."""
    import torch.nn.functional as F
    from mimo_tpu_torch.decomp import hiera as H
    from mimo_tpu_torch.decomp.vit import _window_unpartition
    from mimo_tpu_torch.ops import attention as AT
    from mimo_tpu_torch.ops import ffn as FF
    from mimo_tpu_torch.ops import rows as R
    log("  Hiera row passes against the eager chain:")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(23)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(torch.bfloat16)

    bad = []
    # every bf16 pattern through GELU: bias 0 leaves p + b = p
    pats = torch.from_numpy(np.arange(65536, dtype=np.uint16).view(
        np.int16)).view(torch.bfloat16).reshape(4096, 16).to(dev)
    zero = torch.zeros(16, dtype=torch.bfloat16, device=dev)
    n = _bits_differ(call_wrapper(R.bias_gelu, pats, zero),
                     R.bias_gelu_plain(pats, zero))
    log(f"    bias + GELU, all 65536 bf16 patterns: {n} differ in bits")
    bad += [("gelu patterns", n)] if n else []
    timings = []
    for stage, (rows, c) in HIERA_ROW_STAGES.items():
        hid = 4 * c
        p, b = randn(rows, hid, scale=2.0), randn(hid, scale=0.5)
        n = _bits_differ(call_wrapper(R.bias_gelu, p, b),
                         R.bias_gelu_plain(p, b))
        log(f"    bias + GELU {stage} ({rows} x {hid}): {n} differ in bits")
        bad += [(f"gelu {stage}", n)] if n else []
        timings.append((f"bias + GELU {stage} ({rows} x {hid})",
                        4 * rows * hid, lambda p=p, b=b: R.bias_gelu(p, b),
                        lambda p=p, b=b: R.bias_gelu_plain(p, b)))
        p, res, b = randn(rows, c), randn(rows, c, scale=4.0), randn(c)
        n = _bits_differ(call_wrapper(R.bias_residual, p, b, res),
                         res + (p + b))
        log(f"    bias + residual {stage} ({rows} x {c}): {n} differ in "
            f"bits")
        bad += [(f"residual {stage}", n)] if n else []
        timings.append((f"bias + residual {stage} ({rows} x {c})",
                        6 * rows * c,
                        lambda p=p, b=b, r=res: R.bias_residual(p, b, r),
                        lambda p=p, b=b, r=res: r + (p + b)))
        del p, res
    for (gh, gw), window, pooled in HIERA_UNPARTITIONS:
        c = 144 if window == 8 else 576
        hp, wp = -(-gh // window) * window, -(-gw // window) * window
        f = 2 if pooled else 1
        un = R.Unpartition(gh // f, gw // f, window // f, (hp // f, wp // f))
        frames = 8
        hp, wp = un.padded
        p = randn(frames * hp * wp // un.ws ** 2, un.ws ** 2, c)
        res, b = randn(frames, un.hgt * un.wid, c, scale=4.0), randn(c)

        def eager(p=p, b=b, res=res, un=un):
            return res + _window_unpartition(p + b, frames, un.hgt, un.wid,
                                             un.ws, un.padded)
        what = (f"bias + un-partition + residual, {frames} x {gh}x{gw} "
                f"window {window}{' q-pooled' if pooled else ''} (C {c})")
        n = _bits_differ(call_wrapper(R.bias_residual, p, b, res, un),
                         eager())
        log(f"    {what}: {n} differ in bits")
        bad += [(what, n)] if n else []
        if (gh, window, pooled) == (256, 8, False):
            timings.append((what, 6 * res.numel(),
                            lambda p=p, b=b, r=res, u=un:
                            R.bias_residual(p, b, r, u), eager))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for tokens, c in HIERA_LN_SHAPES:
        x, sc, bi = randn(tokens, c, scale=2.0), randn(c), randn(c)
        ref = F.layer_norm(x.float(), (c,), sc.float(), bi.float(), 1e-6)
        ulps, gap = _ln_ulps(call_wrapper(FF.ln_rows, x, sc, bi, 1e-6), ref,
                             bi.float())
        log(f"    LayerNorm ({tokens} x {c}, eps 1e-6, "
            f"{FF.ln_rows_plan(tokens, c, sms)}): against F.layer_norm in "
            f"fp32 {ulps:.3f} bf16 ulp at the terms' scale (largest |d| "
            f"{gap:.3g})")
        bad += [(f"LayerNorm {c}", ulps)] if ulps > 1 else []
        timings.append((f"LayerNorm ({tokens} x {c})", 4 * tokens * c,
                        lambda x=x, s=sc, b=bi: FF.ln_rows(x, s, b, 1e-6),
                        lambda x=x, s=sc, b=bi: FF.ln_rows_plain(x, s, b,
                                                                 1e-6)))
        del x
    # a whole Hiera-L encode: fused (twice), the row passes fused with the
    # eager LayerNorm, eager, and eager in fp32
    cfg = H.HieraConfig()
    params = H.hiera_init(torch.Generator(device=dev).manual_seed(5), cfg,
                          torch.bfloat16)
    px = randn(2, 1024, 1024, 3)
    fused = H.hiera_apply(params, cfg, px)
    again = H.hiera_apply(params, cfg, px)
    with patched(FF, "ln_rows", FF.ln_rows_plain):
        rows_only = H.hiera_apply(params, cfg, px)
    with patched(FF, "ln_rows", FF.ln_rows_plain), \
            patched(R, "bias_gelu", R.bias_gelu_plain), \
            patched(R, "bias_residual", R.bias_residual_plain):
        eager = H.hiera_apply(params, cfg, px)
        with patched(H, "dispatch_sdpa", AT.attention_plain):
            fp32 = H.hiera_apply(_map_tree(params, lambda t: t.float()),
                                 cfg, px.float())
    same = all(torch.equal(a, b) for a, b in zip(fused, again))
    rows_same = all(torch.equal(a, b) for a, b in zip(rows_only, eager))
    ratios = []
    for i, (f, e, r) in enumerate(zip(fused, eager, fp32)):
        gf, ge = ((t.float() - r).abs() for t in (f, e))
        ratios.append(float(gf.mean()) / float(ge.mean()))
        log(f"    encode stage {i + 1} {tuple(f.shape)}, mean |value| "
            f"{float(r.abs().mean()):.4g}: to fp32 fused max / mean gap "
            f"{float(gf.max()):.4g} / {float(gf.mean()):.4g}, eager "
            f"{float(ge.max()):.4g} / {float(ge.mean()):.4g}; fused to eager "
            f"{float((f.float() - e.float()).abs().mean()):.4g} (finite "
            f"{bool(torch.isfinite(f.float()).all())})")
    log(f"    encode fused twice: {'equal in every bit' if same else 'DIFFER'}"
        f"; the row passes with the eager LayerNorm against eager: "
        f"{'equal in every bit' if rows_same else 'DIFFER'}; fused / eager "
        f"mean gap to fp32 {[round(x, 3) for x in ratios]} (limit "
        f"{HIERA_ENCODE_GAP})")
    if not (same and rows_same) or max(ratios) > HIERA_ENCODE_GAP or not all(
            torch.isfinite(f.float()).all() for f in fused):
        bad.append(("encode", same, rows_same, ratios))
    del params, fused, again, rows_only, eager, fp32, px
    for what, nbytes, run, plain in timings:
        ms, plain_ms = cuda_ms(run, 20), cuda_ms(plain, 5)
        bound_ms = nbytes / PEAK_BYTES * 1e3
        log(f"    time {what}: {ms:.4f} ms, eager {plain_ms:.4f} ms; byte "
            f"bound {bound_ms:.4f} ms ({bound_ms / ms:.1%} of it)")
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"the Hiera row passes differ from the eager "
                             f"chain: {bad}")


def phase_decomp():
    """The decomposition half's track stage at full width through
    tools/profile_decomp.py: SAM ViT-H, SAM2 Hiera-L and ViTPose-H in bf16
    (seeded random weights) on a 48-frame 720x480 clip, a warm-up run then
    the timed one (each encodes the clip), and the checks: the two runs
    must give equal bits. Returns the timed run's launch counts."""
    log("== phase 7: decomp track")
    hiera_rows_check()
    small_decomp_agreement()
    track_graph_agreement()
    from mimo_tpu_torch.decomp import factory as FA
    from mimo_tpu_torch.decomp import sam2 as S2
    from mimo_tpu_torch.ops import flash_attention as FAK
    from mimo_tpu_torch.tools import profile_decomp as PD
    t, h, w = PD.CLIP
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    params = {name: FA.load_params(None, name, cfg, dev, torch.bfloat16, 0)
              for name, cfg in zip(FA.BUNDLES, FA.configs(tiny=False))
              if name in PD.STAGE_BUNDLES["track"]}
    object_everywhere(params["sam2"])
    models = FA.build_decomp_models(params=params)
    torch.cuda.synchronize()
    log(f"  SAM ViT-H, SAM2 Hiera-L, ViTPose-H: " + ", ".join(
        f"{sum(x.numel() for x in _leaves(params[n])) / 1e6:.1f} M"
        for n in params) + f" params (bf16), random init "
        f"{time.perf_counter() - t0:.1f} s")
    frames, seeds, boxes = PD.synth_frames(*PD.CLIP)
    first_run, bboxes1, _ = PD.warm_up(models, frames, seeds, boxes)
    prompted = []
    add_new_points = S2.SAM2VideoPredictor.add_new_points

    def recorded(self, *args):
        prompted.append(add_new_points(self, *args))
        return prompted[-1]

    S2.SAM2VideoPredictor.add_new_points = recorded
    try:
        counters = reset_counts()
        res = PD.run(models, frames, seeds, boxes)
        launches = {fn.__name__: fn.launches for fn in counters}
        widths = dict(FAK.flash_attention_nt.widths)
    finally:
        S2.SAM2VideoPredictor.add_new_points = add_new_points
    log(f"  kernel launches in the run: {launches}; flash_attention_nt by "
        f"head width {widths}")
    if launches["flash_attention_nt"] <= 0 or not (
            widths.get(72) and widths.get(16)):
        raise AssertionError("the decomposition path did not launch the "
                             "flash kernel at d = 72 and d = 16")
    for name in TRACK_ONLY:
        if launches[name] <= 0:
            raise AssertionError(f"the track run never launched {name}")
    masks, bboxes = res["masks"], res["bboxes"]
    from mimo_tpu_torch.decomp.pipeline import DecompConfig
    from mimo_tpu_torch.ops.connected_components import clean_mask
    prompt_mask = clean_mask(prompted[0], DecompConfig().mask_min_area)
    cover = masks.reshape(t, -1).mean(1)
    same = np.array_equal(masks, first_run) \
        and np.array_equal(bboxes, bboxes1)
    log(f"  masks {masks.shape} {masks.dtype}, coverage per frame "
        f"{cover.min():.4f} to {cover.max():.4f}; frame 0 = the prompt "
        f"frame's mask: {np.array_equal(masks[0], prompt_mask)}; bboxes "
        f"{bboxes.shape} in [{bboxes.min()}, {bboxes.max()}]; the warm-up "
        f"run {'equal in every bit' if same else 'DIFFERS'}")
    if masks.shape != (t, h, w) or masks.dtype != bool:
        raise AssertionError(f"track masks {masks.shape} {masks.dtype}")
    if not np.array_equal(masks[0], prompt_mask):
        raise AssertionError("frame 0's mask is not the prompt frame's")
    if bboxes.shape != (t, 4) or bboxes.min() < 0 \
            or (bboxes[:, [0, 2]] > w).any() or (bboxes[:, [1, 3]] > h).any():
        raise AssertionError(f"bboxes outside the frame: {bboxes}")
    if not same:
        raise AssertionError("two track runs differ")
    return Counter(launches), Counter(widths)


# ---------------------------------------------------------------------------
# phase 8: the decomposition's pose and motion stages
# ---------------------------------------------------------------------------


def motion_agreement_config():
    """HMR2 at its real head widths (6 layers of 1024, 8 heads of 64) on a
    ViT-H backbone (1280 wide, 16 heads, 256x192) cut to 2 blocks, with two
    IEF iterations, so a dropped update shows."""
    from mimo_tpu_torch.decomp import hmr as HM
    cfg = HM.HMRConfig()
    return dataclasses.replace(
        cfg, backbone=dataclasses.replace(cfg.backbone, depth=2),
        ief_iters=2)


MOTION_AGREE_CROPS = 4
# the render check's limits (fixed; fp32 on both sides): alpha equal but at
# pixel centres within EDGE_TOL (barycentric, fp64) of a face's edge, rgb and
# depth within RENDER_TOL where both cover
EDGE_TOL, RENDER_TOL = 1e-4, 1e-5


def framed_template(smpl, height: int, width: int):
    """SMPL-H's template framed as tools/profile_raster.py frames it:
    centred, 0.7 of the frame tall, 2 m in front of a focal of twice its
    pixels a metre; seeded vertex colours in [0.2, 1]. Returns (verts (V,
    3), focal, center, colors)."""
    v = smpl.v_template - smpl.v_template.mean(0)
    scale = 0.7 * height / float(v[:, 1].max() - v[:, 1].min())
    v = v.clone()
    v[:, 2] += 2.0
    colors = np.random.default_rng(0).uniform(
        0.2, 1.0, (v.shape[0], 3)).astype(np.float32)
    return v, scale * 2.0, [width / 2.0, height / 2.0], colors


def near_edges(verts, faces, focal, center, height: int, width: int):
    """(T, H, W) bool: pixel centres within EDGE_TOL (barycentric, in fp64)
    of an edge of a face that could cover them (the renderer's candidate
    tests, their weights recomputed in fp64)."""
    from mimo_tpu_torch.decomp import renderer as R
    t, f = verts.shape[0], faces.shape[0]
    hw = height * width
    dev = verts.device
    tri = R.project(verts.double(), torch.as_tensor(
        focal, dtype=torch.float64, device=dev), torch.as_tensor(
        center, dtype=torch.float64, device=dev))[:, faces].reshape(-1, 3, 2)
    near = torch.zeros(t * hw, dtype=torch.bool, device=dev)
    for item, pix, _, _, _, _ in R.candidates(
            verts, faces, focal, center, height=height, width=width):
        (x0, y0), (x1, y1), (x2, y2) = tri[item].permute(1, 2, 0)
        px = (pix % width).double() + 0.5
        py = ((pix % hw) // width).double() + 0.5
        area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
        w0 = ((x2 - x1) * (py - y1) - (y2 - y1) * (px - x1)) / area
        w1 = ((x0 - x2) * (py - y2) - (y0 - y2) * (px - x2)) / area
        lo = torch.minimum(torch.minimum(w0, w1), 1 - w0 - w1)
        near[pix[lo.abs() <= EDGE_TOL]] = True
    return near.reshape(t, height, width)


def motion_agreement_error(seed: int, fault=None):
    """The card against the CPU fp32 plain path, each on the card call's own
    inputs: HMR2 (``motion_agreement_config``, the card's bf16 weights and
    crops) -> (max, mean) of the rotations, betas and camera; ``lbs`` of the
    surface SMPL-H at 4 random poses (fp32 on both sides) -> the vertices'
    (max, mean); the render (fp32 on both sides) of the framed template and
    two of those posed bodies at 720x480 -> alpha pixels that differ off the
    edges, and the largest rgb and depth difference where both cover.
    ``fault`` plants a known error in the card's HMR2 run only."""
    from mimo_tpu_torch.decomp import hmr as HM
    from mimo_tpu_torch.decomp import renderer as R
    from mimo_tpu_torch.decomp import smpl as SM
    cfg = motion_agreement_config()
    params = HM.hmr_init(torch.Generator().manual_seed(seed), cfg)
    cuda_params = _map_tree(params, lambda t: t.to("cuda", torch.bfloat16))
    cpu_params = _map_tree(cuda_params, lambda t: t.to("cpu", torch.float32))
    rng = np.random.default_rng(seed)
    crops = torch.from_numpy(rng.standard_normal(
        (MOTION_AGREE_CROPS, 256, 192, 3)).astype(np.float32)).to(
        "cuda", torch.bfloat16)
    with fault() if fault is not None else contextlib.nullcontext():
        got = HM.hmr_forward(cuda_params, cfg, crops)
    want = HM.hmr_forward(cpu_params, cfg, crops.float().cpu())
    errors = {}
    for k in ("pose_rotmats", "betas", "cam"):
        e = (got[k].float().cpu() - want[k]).abs()
        errors["hmr " + k] = (float(e.max()), float(e.mean()))

    smpl = SM.surface_smplh(0)
    betas = torch.from_numpy(rng.standard_normal((4, 16)).astype(np.float32))
    pose = torch.from_numpy((rng.standard_normal((4, 52, 3)) * 0.3).astype(
        np.float32))
    vc, _ = SM.lbs(smpl.to("cuda"), betas.cuda(), pose.cuda())
    e = (vc.cpu() - SM.lbs(smpl, betas, pose)[0]).abs()
    errors["lbs verts"] = (float(e.max()), float(e.mean()))

    h, w = 720, 480
    tpl, focal, center, colors = framed_template(smpl, h, w)
    posed = vc[:2] - vc[:2].mean(1, keepdim=True) + torch.tensor(
        [0.0, 0.0, 2.0], device="cuda")
    verts = torch.cat([tpl.cuda()[None], posed])
    faces = torch.from_numpy(smpl.faces)
    rc = R.render_frames(verts, faces, colors, focal, center, height=h,
                         width=w)
    rw = R.render_frames(verts.cpu(), faces, colors, focal, center,
                         height=h, width=w)
    near = near_edges(verts, faces.cuda(), focal, center, h, w).cpu()
    (rgb_c, a_c, d_c), (rgb_w, a_w, d_w) = [[x.cpu() for x in r]
                                            for r in (rc, rw)]
    both = (a_c > 0) & (a_w > 0)
    errors["render alpha off-edge"] = (
        int(((a_c != a_w) & ~near).sum()), int((a_c != a_w).sum()))
    errors["render rgb, depth"] = (
        float((rgb_c - rgb_w).abs().amax(-1)[both].max()),
        float((d_c - d_w).abs()[both].max()))
    return errors


# The limits of the HMR2 and lbs readings, (max, mean), sit between the
# sound seeds and the planted faults of ``python3 chip_smoke.py --calibrate
# motion`` (readings in PERF.md); the render's are fixed.
MOTION_TOLS = {"hmr pose_rotmats": (0.45, 0.03), "hmr betas": (0.3, 0.1),
               "hmr cam": (0.2, 0.08), "lbs verts": (1e-5, 1e-6)}


def small_motion_agreement() -> None:
    errors = motion_agreement_error(7)
    log(f"  HMR2 ({MOTION_AGREE_CROPS} crops, real head widths, 2 backbone "
        f"blocks, 2 IEF iterations), lbs (surface SMPL-H, 4 poses) and the "
        f"render (3 frames of 720x480), card vs CPU fp32 on the card call's "
        f"own inputs:")
    bad = []
    for name, (mx, mean) in errors.items():
        if name == "render alpha off-edge":
            ok = mx == 0
            log(f"    {name}: {mx} pixels ({mean} within {EDGE_TOL} of an "
                f"edge) (tolerance 0) {'ok' if ok else 'FAIL'}")
        elif name == "render rgb, depth":
            ok = mx <= RENDER_TOL and mean <= RENDER_TOL
            log(f"    {name} where both cover: max_abs_err={mx:.4g}, "
                f"{mean:.4g} (tolerance {RENDER_TOL}) "
                f"{'ok' if ok else 'FAIL'}")
        else:
            tmx, tmean = MOTION_TOLS[name]
            ok = mx <= tmx and mean <= tmean
            log(f"    {name}: max_abs_err={mx:.4g} mean_abs_err={mean:.4g} "
                f"(tolerance max <= {tmx}, mean <= {tmean}) "
                f"{'ok' if ok else 'FAIL'}")
        if not ok:
            bad.append(name)
    if bad:
        raise AssertionError(f"the card's motion stage disagrees with the "
                             f"CPU reference in {bad}")


REPEAT_CALLS = 10     # calls of the bf16 repeat checks (phases 8, 11 (e))


def motion_params(dev, dtype, seed: int):
    """Phase 8's motion bundles (ViTPose-H, HMR2, HaMeR) at full width:
    seeded random weights in ``dtype``, ``framed_bodies``."""
    from mimo_tpu_torch.decomp import factory as FA
    from mimo_tpu_torch.tools import profile_decomp as PD
    return framed_bodies({
        name: FA.load_params(None, name, cfg, dev, dtype, seed)
        for name, cfg in zip(FA.BUNDLES, FA.configs(tiny=False))
        if name in PD.STAGE_BUNDLES["motion"]})


def repeat_readings(est, frames, boxes, between):
    """REPEAT_CALLS posed vertices of the clip, ``between()`` (another
    batch of the same models) before every other call: each later call's
    max |d| from the first (m)."""
    first, out = None, []
    for call in range(REPEAT_CALLS):
        if call % 2 == 0:
            between()
        verts = est.posed_vertices(frames, boxes)
        if first is None:
            first = verts
        else:
            out.append(float((verts - first).abs().max()))
    return out


def repeat_check(est, frames, boxes):
    """The bf16 posed vertices REPEAT_CALLS times, a batch of the clip's
    first half (as a rank of phase 11 (e) runs them) before every other
    call: all equal in every bit, or the script fails (cuDNN's attention
    did not repeat after other shapes; ``decomp/vit.py::SDPA_BACKENDS``)."""
    half = len(frames) // 2
    diffs = repeat_readings(est, frames, boxes, lambda: est.posed_vertices(
        frames[:half], boxes[:half]))
    log(f"  posed vertices of the {est.dtype} models {REPEAT_CALLS} times, "
        f"a {half}-frame batch before every other call: max |d| from the "
        f"first {[round(d, 6) for d in diffs]} m (must be 0)")
    if any(diffs):
        raise AssertionError("the bf16 posed vertices do not repeat")


def phase_motion():
    """The decomposition half's pose and motion stages at full width through
    tools/profile_decomp.py: ViTPose-H (flip test) over the 48-frame 720x480
    clip's known boxes, then ViTPose-H, HMR2 and HaMeR (seeded random bf16
    weights, ``framed_bodies``), the fuse and skinning of the surface
    SMPL-H and the z-buffer render, and HaMeR on keypoints that find both
    hands; each stage an untimed pass then the timed one, which must give
    equal bits. The sdc must cover 5-50% of every frame, centred inside
    its person box. Then the framed template's render and a
    random-topology mesh's. Returns the launch counts of the stages' four
    passes (no kernel of the 15 is on this path)."""
    log("== phase 8: decomp pose + motion")
    small_motion_agreement()
    from mimo_tpu_torch.decomp import factory as FA
    from mimo_tpu_torch.decomp import renderer as R
    from mimo_tpu_torch.tools import profile_decomp as PD
    t, h, w = PD.CLIP
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    params = motion_params(dev, torch.bfloat16, 0)
    models = FA.build_decomp_models(params=params)
    est = models.estimate_motion.__self__
    torch.cuda.synchronize()
    log(f"  ViTPose-H, HMR2, HaMeR: " + ", ".join(
        f"{sum(x.numel() for x in _leaves(params[n])) / 1e6:.1f} M"
        for n in params) + f" params (bf16); surface SMPL-H "
        f"{est.smpl_model.num_verts} vertices, {len(est.smpl_model.faces)} "
        f"faces, {est.smpl_model.num_joints} joints; built in "
        f"{time.perf_counter() - t0:.1f} s")
    frames, masks, boxes = PD.synth_frames(*PD.CLIP)
    counters = reset_counts()
    pose = PD.run_stage("pose", models, frames, masks, boxes)
    motion = PD.run_stage("motion", models, frames, masks, boxes)
    launches = {fn.__name__: fn.launches for fn in counters}
    log(f"  kernel launches in the two stages' four passes (untimed and "
        f"timed each): {launches} (ViT-H attends over 192 tokens, under "
        f"FLASH_MIN_Q)")

    kpts = pose["out"]
    sdc, hands, crops = motion["out"]
    same = (np.array_equal(kpts, pose["warm_up"])
            and np.array_equal(sdc, motion["warm_up"][0]))
    covered = sdc.max(-1) > 0
    share = covered.reshape(t, -1).mean(1)
    ys, xs = np.mgrid[:h, :w]
    n = np.maximum(covered.sum((1, 2)), 1)
    cx, cy = (xs * covered).sum((1, 2)) / n, (ys * covered).sum((1, 2)) / n
    inside = ((boxes[:, 0] <= cx) & (cx <= boxes[:, 2])
              & (boxes[:, 1] <= cy) & (cy <= boxes[:, 3]))
    log(f"  keypoints {kpts.shape}; sdc {sdc.shape} {sdc.dtype}, covered "
        f"share per frame {share.min():.4f} to {share.max():.4f}, its "
        f"centroid inside the person box on {int(inside.sum())} of {t} "
        f"frames; HaMeR crops {crops}; the warm-up run "
        f"{'equal in every bit' if same else 'DIFFERS'}")
    if kpts.shape != (t, 133, 3) or not np.isfinite(kpts).all():
        raise AssertionError(f"keypoints {kpts.shape}")
    if sdc.shape != (t, h, w, 3) or sdc.dtype != np.uint8:
        raise AssertionError(f"sdc {sdc.shape} {sdc.dtype}")
    if not ((0.05 <= share) & (share <= 0.5)).all() or not inside.all():
        raise AssertionError(f"the sdc's body is not framed: covered share "
                             f"{share.tolist()}, centroid inside the box "
                             f"{inside.tolist()}")
    if crops <= 0 or not all(torch.isfinite(x[s]).all() for x in hands
                             for s in ("left", "right")):
        raise AssertionError("HaMeR found no hands on the drawn keypoints")
    if not same:
        raise AssertionError("two pose + motion runs differ")
    repeat_check(est, frames, boxes)

    # the synthetic body framed as tools/profile_raster.py frames it, and a
    # mesh of random vertex triples (gen_smpl's faces) on the same vertices
    tpl, focal, center, colors = framed_template(est.smpl_model, h, w)
    for name, faces in (
            ("framed template", est.smpl_model.faces),
            ("random-topology faces", np.random.default_rng(0).integers(
                0, est.smpl_model.num_verts, (len(est.smpl_model.faces), 3)))):
        st = {}
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        _, alpha, _ = R.rasterize(tpl.to(dev), torch.from_numpy(faces),
                                  colors, focal, center, height=h, width=w,
                                  stats=st)
        end.record()
        end.synchronize()
        share = float(alpha.mean())
        log(f"  render of the {name}: {start.elapsed_time(end):.2f} ms, "
            f"{st['tests']} candidate pixel tests ({st['covered']} covered) "
            f"in {st['chunks']} chunk(s), peak "
            f"{(torch.cuda.max_memory_allocated() - base) / 2 ** 30:.2f} GiB "
            f"above the models; covers {share:.4f} of the frame")
        if name == "framed template" and not 0.05 <= share <= 0.5:
            raise AssertionError(f"the framed template covers {share} of "
                                 f"the frame")
    return launches, sdc


# ---------------------------------------------------------------------------
# phase 9: the decomposition's background and occlusion stages
# ---------------------------------------------------------------------------

# the agreement check's clip: long enough for every chunk rule of the tiny
# config (two RAFT clips, chunked flow completion and image propagation,
# capped reference frames), as tests/test_torch_propainter.py runs it
BK_AGREE_CLIP = (14, 16, 24)


def _deform_align_unbounded(p, x, cond, groups, max_residue, flow=None):
    """``propainter._deform_align`` without its ``max_residue * tanh`` bound
    on the learned offsets (a planted fault)."""
    from mimo_tpu_torch.decomp import propainter as P
    from mimo_tpu_torch.ops.sampling import deform_conv2d
    out = P._offset_stack(p["offset"], cond)
    n = out.shape[-1] // 3
    offset = torch.cat([out[..., :n], out[..., n:2 * n]], dim=-1)
    if flow is not None:
        offset = offset + flow.flip(-1).repeat(1, 1, 1, offset.shape[-1] // 2)
    return deform_conv2d(x, offset, p["kernel"], p["bias"],
                         mask=torch.sigmoid(out[..., 2 * n:]),
                         deform_groups=groups)


def bk_faults():
    """The planted faults of phase 9's agreement check."""
    from mimo_tpu_torch.decomp import propainter as P
    warp = P.flow_warp
    return {
        "flow_warp x and y swapped": lambda: patched(
            P, "flow_warp", lambda img, flow: warp(img, flow.flip(-1))),
        "_deform_align without the tanh bound": lambda: patched(
            P, "_deform_align", _deform_align_unbounded),
    }


# the check's offset stacks: their zero-initialised last convs drawn with
# this spread, which takes the offsets past tanh's linear range
OFFSET_STD = 0.5


def bk_agreement_error(seed: int, fault=None):
    """The tiny RAFT + ProPainter ``inpaint_video`` of a 14-frame 16x24
    clip and the tiny DepthAnythingV2's ``depth_forward`` of a 70x42 input,
    on the card in fp32 against the CPU in fp32 on the same weights and
    inputs (no kernel of the 15 is on either). The composite takes the
    generator's output inside the masks, which random weights make nearly
    blind to its inputs, and random RAFT flows fail the forward-backward
    check, so the image propagation fills nothing; so two stages are also
    held alone: every deformable alignment call of the card run (the flow
    net's and the generator's; the offset stacks' last convs drawn with
    ``OFFSET_STD``) against the same call on the CPU on its own inputs,
    and ``img_propagation`` of the clip along a consistent translation
    (forward flow f, backward -f) on the card against the CPU. ``fault``
    plants a known error in the card run only. Returns {name: (max, mean)
    absolute error} for "raft" (the flows), "deform_align",
    "img_propagation", "inpaint" (over [0, 1] pixels) and "depth"."""
    from mimo_tpu_torch.decomp import depth_anything as DA
    from mimo_tpu_torch.decomp import propainter as P
    from mimo_tpu_torch.decomp import raft as R
    deform_align = P._deform_align
    gen = torch.Generator().manual_seed(seed)
    pcfg, rcfg, dcfg = (P.tiny_propainter_config(), R.tiny_raft_config(),
                        DA.tiny_depth_config())
    pp = P.propainter_init(gen, pcfg)
    for align in (pp["flow"]["prop"]["align_fwd"],
                  pp["flow"]["prop"]["align_bwd"], pp["gen"]["align_fwd"],
                  pp["gen"]["align_bwd"]):
        for leaf in align["offset"]["c4"].values():
            leaf.normal_(0, OFFSET_STD, generator=gen)
    rp = R.raft_init(gen, rcfg)
    dp = DA.depth_anything_init(gen, dcfg)
    rng = np.random.default_rng(seed)
    t, h, w = BK_AGREE_CLIP
    frames = rng.uniform(0, 1, (t, h, w, 3)).astype(np.float32)
    masks = np.zeros((t, h, w, 1), np.float32)
    for i in range(t):
        masks[i, 4:10, 3 + i % 5:12 + i % 5] = 1
    px = rng.standard_normal((1, 70, 42, 3)).astype(np.float32)
    shift = np.tile(np.asarray([1.5, -2.0], np.float32), (t - 1, h, w, 1))

    def to(x, device):
        return _map_tree(x, lambda v: v.to(device)
                         if isinstance(v, torch.Tensor) else v)

    def run(device, trees, calls=None):
        pp_, rp_, dp_ = trees
        flows = []
        raft_bi = R.raft_bi

        def raft_recorded(*args):
            out = raft_bi(*args)
            flows.append(torch.cat([o.reshape(-1) for o in out]).cpu())
            return out

        align = P._deform_align      # a planted fault's, in a faulty run

        def align_recorded(*args, **kwargs):
            out = align(*args, **kwargs)
            calls.append((to(list(args), "cpu"), to(kwargs, "cpu"), out.cpu()))
            return out

        fr, ms = (torch.from_numpy(a).to(device) for a in (frames, masks))
        with contextlib.ExitStack() as stack:
            stack.enter_context(patched(R, "raft_bi", raft_recorded))
            if calls is not None:
                stack.enter_context(patched(P, "_deform_align",
                                            align_recorded))
            inp = P.inpaint_video(pp_, pcfg, rp_, rcfg, fr, ms)
        prop, _ = P.img_propagation(fr * 2 - 1, torch.from_numpy(
            shift).to(device), torch.from_numpy(-shift).to(device), ms)
        dep = DA.depth_forward(dp_, dcfg, torch.from_numpy(px).to(device))
        return {"raft": torch.cat(flows), "img_propagation": prop.cpu(),
                "inpaint": inp.cpu(), "depth": dep.float().cpu()}

    want = run("cpu", (pp, rp, dp))
    calls = []
    with (fault() if fault is not None else contextlib.nullcontext()):
        got = run("cuda", [to(x, "cuda") for x in (pp, rp, dp)], calls)
    errors = {}
    for name in want:
        err = (got[name] - want[name]).abs()
        errors[name] = (float(err.max()), float(err.mean()))
    errs = [(out - deform_align(*args, **kwargs)).abs()
            for args, kwargs, out in calls]
    errors["deform_align"] = (max(float(e.max()) for e in errs),
                              float(sum(e.sum() for e in errs)
                                    / sum(e.numel() for e in errs)))
    return errors


# The card-vs-CPU limits of phase 9's check, (max, mean) a model: between
# the sound seeds and the planted faults of ``python3 chip_smoke.py
# --calibrate bk`` (readings in PERF.md).
BK_TOLS = {"raft": (1e-5, 1e-6), "img_propagation": (1e-3, 1e-4),
           "inpaint": (2e-6, 1.5e-8), "depth": (1e-6, 1e-7),
           "deform_align": (1e-4, 1e-5)}


def small_bk_agreement() -> None:
    errors = bk_agreement_error(7)
    t, h, w = BK_AGREE_CLIP
    log(f"  tiny RAFT + ProPainter inpaint_video {t}x{h}x{w} (its deformable "
        f"alignments each on its own inputs; img_propagation along a "
        f"consistent shift) and tiny DepthAnythingV2 depth_forward 70x42, "
        f"card fp32 vs CPU fp32 (limits between the sound seeds and the "
        f"planted faults of --calibrate bk):")
    bad = []
    for name, (mx, mean) in errors.items():
        tmx, tmean = BK_TOLS[name]
        ok = mx <= tmx and mean <= tmean
        log(f"    {name}: max_abs_err={mx:.4g} mean_abs_err={mean:.4g} "
            f"(tolerance max <= {tmx}, mean <= {tmean}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            bad.append(name)
    if bad:
        raise AssertionError(f"the card's background / depth models disagree "
                             f"with the CPU reference in {bad}")


def bk_calibrate() -> None:
    """Phase 9's readings: sound seeds, then the planted faults; and the
    full-width DINOv2-L's d = 64 flash check, sound and under a x1.25
    softmax scale."""
    log("== calibrate: tiny RAFT + ProPainter and DepthAnythingV2, card fp32 "
        "vs CPU fp32")
    for name, seed, fault in ([(f"sound seed {s}", s, None)
                               for s in (7, 8, 9, 10, 11)]
                              + [(f"fault '{n}' seed 7", 7, f)
                                 for n, f in bk_faults().items()]):
        errors = bk_agreement_error(seed, fault)
        log(f"  {name}: " + "; ".join(
            f"{m} max_abs_err={mx:.4g} mean_abs_err={mean:.4g}"
            for m, (mx, mean) in errors.items()))
    from mimo_tpu_torch.decomp import factory as FA
    from mimo_tpu_torch.ops import flash_attention as FAK
    from mimo_tpu_torch.tools import profile_decomp as PD
    cfg = dict(zip(FA.BUNDLES, FA.configs(tiny=False)))["depth"]
    params = {"depth": FA.load_params(None, "depth", cfg, torch.device("cuda"),
                                      torch.bfloat16, 0)}
    models = FA.build_decomp_models(params=params)
    frame = PD.synth_frames(*PD.CLIP)[0][0]
    for name, fault in (("sound", None), ("flash scale x1.25", lambda: patched(
            FAK, "LOG2E", FAK.LOG2E * 1.25))):
        with (fault() if fault else contextlib.nullcontext()):
            label, mx, mean = depth_attention_check(models, frame)
        log(f"  DINOv2-L flash {label}, {name}: max_abs_err={mx:.4g} "
            f"mean_abs_err={mean:.4g}")


# DINOv2-L's d = 64 flash on one block's own q, k, v against the fp32 plain
# attention: bf16 inputs, bf16 output (as phase 7's Hiera-L check, whose
# limit this is)
DEPTH_ATTENTION_TOL = (0.05, 0.004)


def depth_attention_check(models, frame):
    """``models.depth`` on one frame, its first d = 64 flash call recorded:
    that call's output against ``attention_plain`` in fp32 on the CPU on
    its own q, k, v. Returns (the call's shape, max, mean)."""
    from mimo_tpu_torch.ops import attention as AT
    from mimo_tpu_torch.ops import flash_attention as FAK
    calls = []
    flash = AT.flash_attention_nt

    def recorded(q, k, v, heads):
        out = flash(q, k, v, heads)
        if not calls and q.shape[2] // heads == 64:
            calls.append(((q, k, v, heads), out))
        return out

    with patched(AT, "flash_attention_nt", recorded):
        models.depth(frame)
    if not calls:
        raise AssertionError("the depth model did not reach the flash kernel "
                             "at d = 64")
    (q, k, v, heads), out = calls[0]
    err = (out.float().cpu() - FAK.attention_plain(
        q.float().cpu(), k.float().cpu(), v.float().cpu(), heads)).abs()
    views = q.stride(1) == 3 * q.shape[2]
    return (f"B={q.shape[0]} S={q.shape[1]} H={heads} d=64"
            f"{' (q|k|v views)' if views else ''}",
            float(err.max()), float(err.mean()))


def phase_bk_occ(sdc):
    """The decomposition half's background and occlusion stages at full
    width (seeded random bf16 weights) on phase 7's 48-frame 720x480 clip
    and its known masks: ``get_bk_recover`` (RAFT + ProPainter) untimed
    then timed through tools/profile_decomp.py, equal bits, a (48, 720,
    480, 3) uint8 background within one level of the frame outside the
    dilated masks, a finite composite, the back-off ratio 1.0; then
    DINOv2-L's d = 64 flash on its own inputs and ``get_occ`` with phase
    8's sdc twice (equal bits). Returns the launch counts and flash launches
    by head width of the bk and occ runs."""
    log("== phase 9: decomp bk + occ")
    small_bk_agreement()
    from mimo_tpu_torch.decomp import factory as FA
    from mimo_tpu_torch.decomp import pipeline as DP
    from mimo_tpu_torch.ops import flash_attention as FAK
    from mimo_tpu_torch.ops import morphology as MO
    from mimo_tpu_torch.tools import profile_decomp as PD
    t, h, w = PD.CLIP
    dev = torch.device("cuda")
    frames, masks, _ = PD.synth_frames(*PD.CLIP)

    def build(stage):
        t0 = time.perf_counter()
        params = {name: FA.load_params(None, name, cfg, dev, torch.bfloat16,
                                       0)
                  for name, cfg in zip(FA.BUNDLES, FA.configs(tiny=False))
                  if name in PD.STAGE_BUNDLES[stage]}
        if "sam2" in params:
            object_everywhere(params["sam2"])
        models = FA.build_decomp_models(params=params)
        torch.cuda.synchronize()
        log(f"  {stage}: " + ", ".join(
            f"{n} {sum(x.numel() for x in _leaves(params[n])) / 1e6:.1f} M"
            for n in params) + f" params (bf16), random init "
            f"{time.perf_counter() - t0:.1f} s")
        return models

    # -- bk ----------------------------------------------------------------
    models = build("bk")
    finite = []
    inner = models.inpaint

    def checked(frames01, m, phases=None):
        out = inner(frames01, m, phases=phases)
        finite.append(bool(torch.isfinite(out).all()))
        return out

    models.inpaint = checked
    counters = reset_counts()
    res = PD.run_bk(models, frames, masks)
    launches = Counter({fn.__name__: fn.launches for fn in counters})
    widths = Counter(FAK.flash_attention_nt.widths)
    bk, first = res["out"], res["warm_up"]
    dil = MO.dilate(masks.astype(np.uint8), MO.rect(9, 9)).astype(bool)
    diff = np.abs(bk.astype(np.int16) - np.stack(frames).astype(np.int16))
    outside = diff[~dil]
    same = np.array_equal(bk, first)
    log(f"  bk {bk.shape} {bk.dtype}, back-off ratio {res['ratio']}, "
        f"|bk - frame| outside the dilated masks max {int(outside.max())} "
        f"(mean {outside.mean():.4f}), inside mean "
        f"{diff[dil].mean():.2f}; composite finite: {all(finite)}; the "
        f"warm-up run {'equal in every bit' if same else 'DIFFERS'}; "
        f"kernel launches {dict(launches)} (RAFT and ProPainter run none "
        f"of the 15)")
    if bk.shape != (t, h, w, 3) or bk.dtype != np.uint8:
        raise AssertionError(f"bk {bk.shape} {bk.dtype}")
    if not all(finite):
        raise AssertionError("the bk composite is not finite")
    if res["ratio"] != 1.0:
        raise AssertionError(f"bk backed off to ratio {res['ratio']}")
    if outside.max() > 1:
        raise AssertionError("bk differs from the frame outside the masks")
    if not same:
        raise AssertionError("two bk runs differ")
    del models, res, inner
    torch.cuda.empty_cache()

    # -- occ ---------------------------------------------------------------
    models = build("occ")
    label, mx, mean = depth_attention_check(models, frames[0])
    tmx, tmean = DEPTH_ATTENTION_TOL
    ok = mx <= tmx and mean <= tmean
    log(f"  DINOv2-L flash {label} on its own inputs vs fp32 plain: "
        f"max_abs_err={mx:.4g} mean_abs_err={mean:.4g} (tolerance max <= "
        f"{tmx}, mean <= {tmean}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the depth model's d = 64 flash disagrees with "
                             "plain attention")
    vp = DP.VideoProcessor(models)
    runs = []
    calls = {"automask": models.automask, "depth": models.depth,
             "track_video": models.track_video}
    for i in range(2):
        times = {}
        for name, fn in calls.items():
            setattr(models, name, PD.timed(times, name, fn))
        counters = reset_counts()
        stats = {}
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        occ = vp.get_occ(frames, masks, sdc, stats=stats)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        runs.append(occ)
        cover = "None" if occ is None else \
            f"{occ.shape} covering {occ.mean():.4f}"
        log(f"  get_occ run {i + 1}: {secs:.2f} s ("
            + ", ".join(f"{n} {len(ts)} x {np.mean(ts):.1f} ms"
                        for n, ts in times.items())
            + f"; the rest host); keyframes {stats['keyframes']}, candidates "
            f"a keyframe {stats['candidates']}, occluders kept "
            f"{stats['occluders']}, tracks run {stats['tracks']}; occ "
            f"{cover}; peak "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    for name, fn in calls.items():
        setattr(models, name, fn)
    occ_launches = Counter({fn.__name__: fn.launches for fn in counters})
    occ_widths = Counter(FAK.flash_attention_nt.widths)
    log(f"  kernel launches in the second get_occ run: {dict(occ_launches)}; "
        f"flash_attention_nt by head width {dict(occ_widths)}")
    same = (runs[0] is None and runs[1] is None) or (
        runs[0] is not None and runs[1] is not None
        and np.array_equal(runs[0], runs[1]))
    if not same:
        raise AssertionError("two get_occ runs differ")
    if runs[1] is not None and (runs[1].shape != (t, h, w)
                                or runs[1].dtype != bool):
        raise AssertionError(f"occ {runs[1].shape} {runs[1].dtype}")
    if not (occ_widths.get(64) and occ_widths.get(16)):
        raise AssertionError("the occ stage did not launch the flash kernel "
                             "at d = 64 and d = 16")
    return launches + occ_launches, widths + occ_widths


# ---------------------------------------------------------------------------
# phase 10: decomp run -> animate -> edit through the port's commands
# ---------------------------------------------------------------------------

# phase 7's clip drawn at 1.5x its size: the 720-pixel cap of ``run`` brings
# it back to 720x480
RUN_CLIP = (48, 1080, 720)
PAETH_PNG = 2048           # side of the Paeth-filtered PNG phase 10 reads
RUN_STAGES = ("get_human", "get_motion", "get_bk_recover", "get_occ")
# COCO's 17 body keypoints of the drawn figure, as fractions of its box
FIGURE_KEYPOINTS = ((0.5, 0.08), (0.45, 0.06), (0.55, 0.06), (0.4, 0.08),
                    (0.6, 0.08), (0.3, 0.25), (0.7, 0.25), (0.25, 0.42),
                    (0.75, 0.42), (0.22, 0.58), (0.78, 0.58), (0.38, 0.6),
                    (0.62, 0.6), (0.38, 0.8), (0.62, 0.8), (0.38, 0.97),
                    (0.62, 0.97))


def figure_keypoints(bbox):
    """(133, 3) wholebody keypoints: the figure's 17 body points inside
    ``bbox`` (xyxy) at score 1, the rest at score 0."""
    x0, y0, x1, y1 = np.asarray(bbox, np.float64)
    k = np.zeros((133, 3))
    for i, (fx, fy) in enumerate(FIGURE_KEYPOINTS):
        k[i] = (x0 + fx * (x1 - x0), y0 + fy * (y1 - y0), 1.0)
    return k


def run_models(box0):
    """Every decomposition bundle at full width (seeded random bf16 weights
    with phases 7-9's adjustments, ``object_everywhere`` and
    ``framed_bodies``), the detector replaced by the drawn figure's box on
    frame 0 (random weights find no person), and where the random model
    fails it, the full-body gate by the figure's keypoints and SAM's mask
    of the box by the figure's (a cleaned random SAM mask may be empty:
    phase 7 tracks the known mask for that reason). Returns the models and
    a dict that gets the random models' own readings: "pose", the gate's
    count of confident body keypoints, and "sam", the cleaned mask's
    pixels."""
    from mimo_tpu_torch.decomp import factory as FA
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    params = {name: FA.load_params(None, name, cfg, dev, torch.bfloat16, 0)
              for name, cfg in zip(FA.BUNDLES, FA.configs(tiny=False))}
    object_everywhere(params["sam2"])
    models = FA.build_decomp_models(params=framed_bodies(params))
    torch.cuda.synchronize()
    log(f"  every bundle at full width: " + ", ".join(
        f"{n} {sum(x.numel() for x in _leaves(params[n])) / 1e6:.1f} M"
        for n in params) + f" params (bf16), random init "
        f"{time.perf_counter() - t0:.1f} s")
    own = {}
    random_pose = models.estimate_pose

    def estimate_pose(frame, bbox):
        k = random_pose(frame, bbox)
        own["pose"] = int((k[:17, 2] > 0.3).sum())
        return k if own["pose"] >= 10 else figure_keypoints(bbox)

    random_segment = models.segment_box

    def segment_box(frame, bbox):
        from mimo_tpu_torch.ops.connected_components import clean_mask
        m = random_segment(frame, bbox)
        own["sam"] = int(clean_mask(m, 256).sum())
        if own["sam"]:
            return m
        x0, y0, x1, y1 = box0
        m = np.zeros(frame.shape[:2], bool)
        m[y0:y1, x0:x1] = True
        return m

    models.detect_person = lambda frame: (np.asarray(box0), 1.0)
    models.estimate_pose = estimate_pose
    models.segment_box = segment_box
    return models, own


def instrumented_run(vp, times, outputs):
    """``vp``'s stages timed (CUDA-synchronised wall seconds into
    ``times``) and their outputs kept in ``outputs``."""
    for name in RUN_STAGES:
        def call(*args, _fn=getattr(vp, name), _name=name, **kwargs):
            t0 = time.perf_counter()
            out = _fn(*args, **kwargs)
            torch.cuda.synchronize()
            times[_name] = time.perf_counter() - t0
            outputs[_name] = out
            return out
        setattr(vp, name, call)


@contextlib.contextmanager
def io_timed(records):
    """Within: video_io's stage-file writes and reads append (what, file
    name, seconds, frames) to ``records``."""
    from mimo_tpu_torch.utils import video_io as VIO
    names = ("save_video", "read_frames", "load_video_fixed_fps")
    saved = {n: getattr(VIO, n) for n in names}

    def timed_io(name):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = saved[name](*args, **kwargs)
            n = len(out) if out is not None else len(args[0])
            records.append((name, os.path.basename(args[1] if name ==
                                                   "save_video" else args[0]),
                            time.perf_counter() - t0, n))
            return out
        return call

    for n in names:
        setattr(VIO, n, timed_io(n))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(VIO, n, fn)


def file_bytes(d):
    """Every file of directory ``d``: name -> bytes."""
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = f.read()
    return out


@contextlib.contextmanager
def without_opencv():
    """Within: the port's video I/O and frame helpers take their paths
    without OpenCV, as on the card's machine, which has none."""
    from mimo_tpu_torch.utils import frames as FU
    from mimo_tpu_torch.utils import video_io as VIO
    with patched(VIO, "cv2", None), patched(FU, "cv2", None):
        yield


def paeth_png(img, path):
    """``img`` (H, W, 4) uint8 written as an RGBA PNG with every row's Paeth
    filter, as image tools pick it (the port writes filter 0 only)."""
    h, w, _ = img.shape
    x = img.astype(np.int16)
    a, b, c = (np.zeros_like(x) for _ in range(3))
    a[:, 1:], b[1:], c[1:, 1:] = x[:, :-1], x[:-1], x[:-1, :-1]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    raw = np.empty((h, 1 + 4 * w), np.uint8)
    raw[:, 0] = 4
    raw[:, 1:] = ((x - pred) & 255).reshape(h, 4 * w)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    with open(path, "wb") as out:
        out.write(b"\x89PNG\r\n\x1a\n"
                  + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0))
                  + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                  + chunk(b"IEND", b""))


def phase_decomp_run(work):
    """The decomposition's ``VideoProcessor.run`` at full width on a clip
    written as the card writes video (the uncompressed AVI of
    ``utils/video_io.py``), its stage files read back and a resumed run;
    the ``decomp`` command as a subprocess; then ``animate`` and ``edit``
    through ``mimo_tpu_torch.__main__.main`` on the template the run wrote.
    Run ``without_opencv`` (the card's machine has none). Returns the
    launch counts and flash launches by head width of the run, animate and
    edit."""
    log("== phase 10: decomp run -> animate -> edit through the port's "
        "commands")
    from mimo_tpu_torch import __main__ as CLI
    from mimo_tpu_torch.decomp import pipeline as DP
    from mimo_tpu_torch.entry import animate as AN
    from mimo_tpu_torch.entry import edit as ED
    from mimo_tpu_torch.entry.template import load_template
    from mimo_tpu_torch.tools import profile_decomp as PD
    from mimo_tpu_torch.utils import frames as FU
    from mimo_tpu_torch.utils import video_io as VIO
    t, h, w = RUN_CLIP
    frames, _, boxes = PD.synth_frames(t, h, w)
    inp = os.path.join(work, "input.mp4")
    t0 = time.perf_counter()
    VIO.save_video(frames, inp, 30)
    log(f"  input clip: {t} frames {h}x{w} written as an uncompressed AVI in "
        f"{time.perf_counter() - t0:.3f} s, {os.path.getsize(inp)} bytes")
    del frames
    box0 = boxes[0] * 2 // 3                  # at the capped 720x480
    models, own = run_models(box0)

    # -- run, then resume --------------------------------------------------
    tpl = os.path.join(work, "template")
    vp = DP.VideoProcessor(models)
    times, outputs, io = {}, {}, []
    instrumented_run(vp, times, outputs)
    counters = reset_counts()
    torch.cuda.reset_peak_memory_stats()
    with io_timed(io):
        res = vp.run(inp, tpl)
    launches = Counter({fn.__name__: fn.launches for fn in counters})
    widths = flash_widths()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"  run: code {res['code']}, {res.get('num_frames')} frames, "
        f"elapsed_s {res.get('elapsed_s', 0):.2f}; stages " + ", ".join(
            f"{n} {s:.2f} s" for n, s in times.items())
        + f"; the random ViTPose's full-body gate: {own.get('pose')} of "
        f"17 keypoints > 0.3 ("
        + ("its own" if own.get("pose", 0) >= 10
           else "replaced by the figure's")
        + f"); the random SAM's cleaned mask of the box: {own.get('sam')} "
        f"pixels (" + ("its own" if own.get("sam") else
                       "replaced by the figure's")
        + f"); peak {peak:.2f} GiB")
    log("  stage-file I/O: " + "; ".join(
        f"{what} {name} {n} frames {s:.3f} s" for what, name, s, n in io))
    log(f"  kernel launches in the run: {dict(launches)}; flash by wrapper "
        f"and head width {dict(widths)}")
    if res["code"] != DP.CODE_OK:
        raise AssertionError(f"run returned code {res['code']}")
    written = file_bytes(tpl)
    want = ["bbox.npy", "bk.mp4", "config.json", "mask.mp4", "sdc.mp4",
            "vid.mp4"] + (["occ.mp4"] if outputs["get_occ"] is not None
                          else [])
    log(f"  template: {sorted(written)}, {sum(map(len, written.values()))} "
        f"bytes; occ {'found' if outputs['get_occ'] is not None else 'none'}")
    if sorted(written) != sorted(want):
        raise AssertionError(f"template files {sorted(written)}, want "
                             f"{sorted(want)}")
    masks = outputs["get_human"][0]
    th, tw = masks.shape[1:]
    t0 = time.perf_counter()
    back = {n: np.stack(VIO.read_frames(os.path.join(tpl, n)))
            for n in want if n.endswith(".mp4")}
    read_s = time.perf_counter() - t0
    vid = np.stack(VIO.load_video_fixed_fps(inp)[:t])
    capped = np.stack([FU.resize_linear(f, tw, th, "cuda").cpu().numpy()
                       for f in vid])
    checks = {"vid.mp4": np.array_equal(back["vid.mp4"], capped),
              "mask.mp4": np.array_equal(back["mask.mp4"][..., 0] > 127,
                                         masks)
              and set(np.unique(back["mask.mp4"])) <= {0, 255},
              "sdc.mp4": np.array_equal(back["sdc.mp4"],
                                        outputs["get_motion"]),
              "bk.mp4": np.array_equal(back["bk.mp4"],
                                       outputs["get_bk_recover"])}
    if "occ.mp4" in back:
        checks["occ.mp4"] = np.array_equal(back["occ.mp4"][..., 0] > 127,
                                           outputs["get_occ"])
    bboxes = np.load(os.path.join(tpl, "bbox.npy"))
    log(f"  read back: {sum(len(b) for b in back.values())} frames in "
        f"{read_s:.3f} s; equal in every bit to the stage outputs: "
        f"{checks}; bbox.npy {bboxes.shape} {bboxes.dtype} in "
        f"[{bboxes.min()}, {bboxes.max()}]; frames {th}x{tw}")
    if (th, tw) != (h * 2 // 3, w * 2 // 3) or not all(checks.values()):
        raise AssertionError("a stage file does not read back to its stage")
    if bboxes.shape != (t, 4) or bboxes.min() < 0 or \
            (bboxes[:, [0, 2]] > tw).any() or (bboxes[:, [1, 3]] > th).any():
        raise AssertionError(f"bboxes outside the frame: {bboxes}")
    if not all(widths[("flash_attention_nt", d)] for d in (16, 64, 72)):
        raise AssertionError("the run did not launch the flash kernel at "
                             "d = 16, 64 and 72")

    again = DP.VideoProcessor(models)
    times2, outputs2 = {}, {}
    instrumented_run(again, times2, outputs2)
    res2 = again.run(inp, tpl, resume=True)
    same = file_bytes(tpl) == written
    log(f"  resumed run: code {res2['code']}, elapsed_s "
        f"{res2.get('elapsed_s', 0):.2f}, stages run {sorted(times2)}; "
        f"every file {'equal in every bit' if same else 'DIFFERS'}")
    if res2["code"] != DP.CODE_OK or set(times2) != {"get_occ"} or not same:
        raise AssertionError("the resumed run recomputed a stage or wrote "
                             "other bits")
    del models, vp, again, outputs, outputs2, back, vid, capped
    torch.cuda.empty_cache()

    # -- the command, unpatched, in its own process --------------------------
    out2 = os.path.join(work, "command")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "mimo_tpu_torch", "decomp", "--video", inp,
         "--output", out2, "--max-frames", "8"], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    lines = [x for x in proc.stdout.splitlines()
             if x.startswith("decomposition: ")]
    log(f"  `python3 -m mimo_tpu_torch decomp --max-frames 8` (seeded "
        f"weights): exit {proc.returncode} in {time.perf_counter() - t0:.1f}"
        f" s: {lines}")
    if proc.returncode not in (0, 1, 2, 3) or len(lines) != 1 or \
            not os.path.exists(os.path.join(out2, "vid.mp4")):
        raise AssertionError(f"the decomp command failed:\n{proc.stdout}\n"
                             f"{proc.stderr[-4000:]}")

    # -- animate and edit from the template ----------------------------------
    ref_png = os.path.join(work, "ref.png")
    VIO.save_image(template_frames()[0], ref_png)
    t0 = time.perf_counter()
    VIO.load_image(ref_png)
    ref_s = time.perf_counter() - t0
    # a user's reference as image tools write it: RGBA, Paeth rows, 4 MP
    rgba = np.random.default_rng(5).integers(0, 256, (PAETH_PNG, PAETH_PNG, 4),
                                             dtype=np.uint8)
    rgba[:, : PAETH_PNG // 2] = np.arange(PAETH_PNG // 2)[None, :, None] // 8
    paeth = os.path.join(work, "paeth.png")
    paeth_png(rgba, paeth)
    t0 = time.perf_counter()
    got = VIO.load_image(paeth)
    paeth_s = time.perf_counter() - t0
    log(f"  load_image: the reference PNG (filter 0, "
        f"{os.path.getsize(ref_png)} bytes) {ref_s:.3f} s; a {PAETH_PNG}^2 "
        f"RGBA PNG of Paeth rows ({os.path.getsize(paeth)} bytes) "
        f"{paeth_s:.3f} s")
    if not np.array_equal(got, rgba[..., :3]):
        raise AssertionError("the Paeth PNG did not read back to its pixels")
    del rgba, got
    runners = []

    class Kept(AN.Runner):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            runners.append(self)

    def cli(argv):
        counters = reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with patched(AN, "Runner", Kept), patched(ED, "Runner", Kept):
            CLI.main(argv)
        wall = time.perf_counter() - t0
        counts = {fn.__name__: fn.launches for fn in counters}
        tm = runners[-1].last_timings
        log(f"  {argv[0]}: {wall:.2f} s wall (model init included) | "
            f"prepare {tm['prepare']:.1f} ms | mean step "
            f"{tm['step_mean']:.1f} ms | decode {tm['decode']:.1f} ms (CUDA "
            f"events) | peak {torch.cuda.max_memory_allocated() / 2 ** 30:.1f}"
            f" GiB; kernel launches {counts}")
        for name in unlaunched(counts):
            raise AssertionError(f"{argv[0]} never launched {name}")
        runners.clear()
        return Counter(counts), flash_widths()

    anim = os.path.join(work, "animate.mp4")
    a_launches, a_widths = cli(
        ["animate", "--ref", ref_png, "--template", tpl, "--output", anim,
         "--W", "512", "--H", "784", "--max-frames", "24", "--steps", "2"])
    video = VIO.read_frames(anim)
    std = float(np.stack(video).std())
    log(f"  animate output: {len(video)} frames {video[0].shape} "
        f"{video[0].dtype}, std {std:.2f}")
    if len(video) != 24 or any(f.shape != (784, 512, 3) or f.dtype != np.uint8
                               for f in video) or std <= 1.0:
        raise AssertionError("animate wrote no 24-frame 784x512 video")

    edited = os.path.join(work, "edit.mp4")
    e_launches, e_widths = cli(
        ["edit", "--ref", ref_png, "--template", tpl, "--output", edited,
         "--steps", "2"])
    out = VIO.read_frames(edited)
    loaded = load_template(tpl, require_bk=True)
    _, _, _, _, ctx, bboxes = FU.crop_human_clip_auto_context(
        loaded.sdc, loaded.vid, loaded.bk, ED.OVERLAY)
    log(f"  edit: {len(ctx)} ROI shots {[(c[0], c[-1]) for c in ctx]} with "
        f"bboxes {bboxes}; output {len(out)} frames {out[0].shape}")
    if len(out) != t or any(f.shape != (th, tw, 3) or f.dtype != np.uint8
                            for f in out):
        raise AssertionError("edit wrote no 48-frame 720x480 video")
    bk_err = 0
    for i, frame in enumerate(out):
        outside = np.ones((th, tw), bool)
        for c, (x0, x1, y0, y1) in zip(ctx, bboxes):
            if i in c:
                outside[y0:y1, x0:x1] = False
        if loaded.occ is not None:
            outside &= loaded.occ[i][..., 0] == 0
        bk_err = max(bk_err, int(np.abs(frame[outside].astype(int)
                                        - loaded.bk[i][outside]).max(
                                            initial=0)))
    log(f"  |edit - bk| outside the shots' bboxes <= {bk_err} (limit 1)")
    if bk_err > 1:
        raise AssertionError("the paste-back changed pixels it must keep")
    return (launches + a_launches + e_launches,
            widths + a_widths + e_widths)


# ---------------------------------------------------------------------------
# phase 11: the multi-process layer (entry/graft.py's spawner)
# ---------------------------------------------------------------------------

MULTI_STEPS = 2             # DDIM steps of phase 11's generations
DP_CLIP = (41, 256)         # phase 5's window clip: three 24-frame windows


def multi_tol():
    from mimo_tpu_torch.entry import graft
    return graft.MULTI_TOL


CUDNN_FAULT = "cuDNN attention"


def plant(fault):
    """A planted fault of ``--calibrate multi`` or ``repeat`` in this rank:
    "local PE" (the motion modules' temporal PE over the rank's own frames,
    repeated), "reversed a2a" (the received blocks concatenated in reverse
    rank order), "reversed gather" (``comm.all_gather``'s blocks in reverse
    rank order: the frame-parallel forwards' and render's outputs) or
    CUDNN_FAULT (cuDNN's attention put back into the ViTs' SDPA backends,
    first as torch orders them on an H100: the code before P1's repair)."""
    if fault is None:
        return contextlib.nullcontext()
    if fault == CUDNN_FAULT:
        from torch.nn.attention import SDPBackend as B

        from mimo_tpu_torch.decomp import vit
        return patched(vit, "SDPA_BACKENDS", [
            B.CUDNN_ATTENTION, B.FLASH_ATTENTION, B.EFFICIENT_ATTENTION,
            B.MATH])
    import torch.distributed as dist
    from mimo_tpu_torch.models import unet as U
    from mimo_tpu_torch.parallel import comm
    n = dist.get_world_size()
    if fault == "local PE":
        pe = U._temporal_pe
        return patched(U, "_temporal_pe", lambda f, dim, dtype, device: pe(
            f // n, dim, dtype, device).repeat(n, 1))
    if fault == "reversed gather":
        gather = comm.all_gather

        def reversed_gather(x, group, axis=0):
            y = gather(x, group, axis)
            return torch.cat(y.chunk(n, dim=axis)[::-1], dim=axis)

        return patched(comm, "all_gather", reversed_gather)
    a2a = comm.all_to_all

    def reversed_blocks(x, group, split_axis, concat_axis):
        y = a2a(x, group, split_axis, concat_axis)
        return torch.cat(y.chunk(n, dim=concat_axis)[::-1], dim=concat_axis)

    return patched(comm, "all_to_all", reversed_blocks)


def motion_weights(params, dev, seed: int = 1000):
    """The denoising UNet's motion modules with seeded output projections
    (N(0, 1/C) kernels, zero bias) in place of their zero init, so that the
    temporal attention, and the all-to-all around it, reach the video.
    Drawn the same in every process from the seed."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    den = params["denoising_unet"]
    for blk in den["down"] + den["up"] + [den["mid"]]:
        for mm in blk["motions"] or []:
            k = mm["proj_out"]["kernel"]
            c = k.shape[0]
            k.copy_(torch.randn((c, c), generator=gen, device=dev) * c ** -0.5)
    return params


def multi_animate(dev, runners, task):
    """One phase-11 generation task on this rank: ``task["runs"]`` calls of
    ``animate`` through a Runner sharded as ``task["mesh"]`` /
    ``task["axes"]``; the kernel counts, the peak memory, the all-to-all
    bytes and seconds and the UNet's window-frames are those of the last
    run. Rank 0 returns the last video (bf16, as the pipeline made it)."""
    import torch.distributed as dist
    from mimo_tpu_torch import config as C
    from mimo_tpu_torch.entry import graft
    from mimo_tpu_torch.entry.animate import animate
    from mimo_tpu_torch.entry.runner import Runner, init_random_params
    from mimo_tpu_torch.parallel import comm
    from mimo_tpu_torch.parallel.mesh import ProcessMesh
    seed = task.get("weights_seed", 0)
    if seed not in runners:
        runners.clear()
        torch.cuda.empty_cache()
        cfg = C.MIMOConfig()
        runners[seed] = (cfg, motion_weights(init_random_params(
            cfg, torch.Generator(device=dev).manual_seed(seed),
            dtype=torch.bfloat16), dev))
    cfg, params = runners[seed]
    runner = Runner(cfg=cfg, params=params, device=dev, dtype=torch.bfloat16,
                    mesh=ProcessMesh(*task["mesh"], dev), **task["axes"])
    frames, size = task["clip"]
    ref, clip = template_frames(frames)
    kw = dict(width=size[1], height=size[0], steps=MULTI_STEPS,
              cfg_scale=3.5, seed=task["seed"])
    videos = []
    with plant(task.get("fault")):
        for i in range(task["runs"]):
            if i == task["runs"] - 1:
                counters = reset_counts()
                torch.cuda.reset_peak_memory_stats(dev)
            with comm.measure() as a2a, \
                    graft.count_window_frames() as unet_frames:
                t0 = time.perf_counter()
                videos.append(animate(runner, ref, clip, **kw))
                wall = time.perf_counter() - t0
    out = dict(timings=dict(runner.last_timings), wall=wall,
               a2a_bytes=a2a.bytes, a2a_calls=a2a.calls,
               a2a_s=a2a.seconds(),
               peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
               unet_frames=unet_frames[0],
               launches={fn.__name__: fn.launches for fn in counters},
               widths=flash_widths(),
               repeat_equal=all(np.array_equal(videos[0], v)
                                for v in videos[1:]))
    if dist.get_rank() == 0:
        out["video"] = torch.from_numpy(videos[-1]).bfloat16()
    return out


def multi_motion(dev, task):
    """Phase 8's motion stage (``motion_params``) in ``task["dtype"]``,
    built with a "data" mesh over the world, on phase 7's clip and boxes
    cut to each of ``task["frames"]``; rank 0 also runs the single-process
    estimator on the same models and returns ``sdc_stats``' readings of the
    two. In bf16 every rank also runs the single-process posed vertices
    REPEAT_CALLS times, the sharded ones before every other call, and
    returns their largest difference from the first (``repeat``). A
    ``task["fault"]`` is planted around the sharded calls (CUDNN_FAULT:
    around the whole task)."""
    import torch.distributed as dist
    from mimo_tpu_torch.decomp import factory as FA
    from mimo_tpu_torch.parallel import comm
    from mimo_tpu_torch.parallel.decomp import render_frames_sharded
    from mimo_tpu_torch.parallel.mesh import get_mesh
    from mimo_tpu_torch.tools import profile_decomp as PD
    dtype = getattr(torch, task["dtype"])
    params = motion_params(dev, dtype, task.get("weights_seed", 0))
    mesh = get_mesh(device=dev)
    sharded = FA.build_decomp_models(params=params, device=dev, mesh=mesh)
    est_sh = sharded.estimate_motion.__self__
    est_1 = FA.build_decomp_models(params=params,
                                   device=dev).estimate_motion.__self__
    frames, masks, boxes = PD.synth_frames(*PD.CLIP)
    h, w = frames[0].shape[:2]
    center = torch.tensor([w / 2.0, h / 2.0], device=dev)
    fault = task.get("fault")
    whole, part = (fault, None) if fault == CUDNN_FAULT else (None, fault)
    out = {}
    with plant(whole):
        for t in task["frames"]:
            clip = (frames[:t], masks[:t], boxes[:t])
            with plant(part):
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                sdc = sharded.estimate_motion(*clip)
                out[t] = dict(seconds=time.perf_counter() - t0)
                verts = est_sh.posed_vertices(clip[0], clip[2])
            own = est_1.posed_vertices(clip[0], clip[2])
            if dtype != torch.float32:
                diffs = repeat_readings(
                    est_1, clip[0], clip[2],
                    lambda: est_sh.posed_vertices(clip[0], clip[2]))
                out[t]["repeat"] = comm.all_gather(
                    torch.tensor([max(diffs)], device=dev),
                    mesh.group("data"))
            verts1 = comm.broadcast(own, mesh.group("data"), src=0)
            # every rank renders its frames of rank 0's single-process
            # vertices
            shared = render_frames_sharded(
                verts1, est_1._faces, est_1._colors, est_1.focal, center,
                height=h, width=w, mesh=mesh)
            if dist.get_rank() == 0:
                out[t].update(sdc_stats(est_1, verts, verts1, sdc, shared,
                                        center, h, w))
    return dict(runs=out)


def depth_gaps(verts, faces, focal, center, h, w):
    """(T, H, W): at each pixel the gap between the nearest face's depth
    and the next-nearest other face's, from the renderer's own candidate
    tests and fp32 depths (inf where fewer than two faces cover it): a
    pixel whose two nearest faces are that close can change face when
    the vertices round differently."""
    from mimo_tpu_torch.decomp import renderer as R
    faces = torch.as_tensor(faces, device=verts.device).long()
    n_faces = faces.shape[0]
    keys = []
    for rank in range(2):
        zbuf = torch.full((verts.shape[0] * h * w,), R._NO_HIT,
                          dtype=torch.int64, device=verts.device)
        for item, pix, w0, w1, w2, z in R.candidates(
                verts, faces, focal, center, height=h, width=w):
            key = (z.view(torch.int32).long() << 32) | (item % n_faces)
            keep = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
            if rank:      # every face but the pixel's nearest
                keep &= (key & 0xFFFFFFFF) != (keys[0][pix] & 0xFFFFFFFF)
            zbuf.scatter_reduce_(0, pix[keep], key[keep], reduce="amin")
        keys.append(zbuf)
    depth = [(k >> 32).to(torch.int32).view(torch.float32) for k in keys]
    gap = torch.where(keys[1] != R._NO_HIT, depth[1] - depth[0],
                      torch.full_like(depth[0], float("inf")))
    return gap.reshape(verts.shape[0], h, w)


def sdc_stats(est, verts, verts1, sdc, shared, center, h, w):
    """Phase 11 (e)'s readings on rank 0: the sharded and single-process
    posed vertices' max difference; whether the frame-parallel render of
    the single process's vertices (``shared``) equals their single-process
    render, and whether the sharded ``estimate_motion``'s sdc equals the
    single-process render of the sharded vertices, in every bit; the
    pixels where the two processes' sdcs differ by more than one level, as
    a share of the pixels either covers, and of them those on a face edge
    (``near_edges`` of either vertex set), those on a depth tie (in either
    render the nearest two faces' depths within TIE_REL of the depth,
    ``depth_gaps``) and the rest; and the largest depth gap, relative to
    the depth, of a pixel past one level off the edges."""
    from mimo_tpu_torch.decomp import renderer as R

    def render(v):
        return R.render_frames(v, est._faces, est._colors, est.focal, center,
                               height=h, width=w)

    def quantize(rgb, alpha):       # as MotionEstimator.estimate_motion
        return ((rgb * alpha[..., None]).clamp(0, 1) * 255).to(torch.uint8)

    rgb_s, a_s, d_s = render(verts)
    rgb_1, a_1, d_1 = render(verts1)
    sdc_s, sdc_1 = quantize(rgb_s, a_s), quantize(rgb_1, a_1)
    past = (sdc_s.int() - sdc_1.int()).abs().amax(-1) > 1
    edge = (near_edges(verts, est._faces, est.focal, center, h, w)
            | near_edges(verts1, est._faces, est.focal, center, h, w))
    depth = torch.where(a_1 > 0, d_1, d_s)
    gap = torch.minimum(
        depth_gaps(verts.float(), est._faces, est.focal, center, h, w),
        depth_gaps(verts1.float(), est._faces, est.focal, center, h, w))
    rel = gap / depth.clamp(min=1e-6)
    tie = rel <= TIE_REL
    off_edges = past & ~edge
    return dict(
        verts_d=float((verts - verts1).abs().max()),
        render_equal=all(torch.equal(a, b)
                         for a, b in zip(shared, render(verts1))),
        sdc_equal=bool(np.array_equal(sdc, sdc_s.cpu().numpy())),
        past=int(past.sum()), on_edges=int((past & edge).sum()),
        on_ties=int((off_edges & tie).sum()),
        unexplained=int((off_edges & ~tie).sum()),
        tie_rel_max=float(rel[off_edges].max()) if off_edges.any() else 0.0,
        share=float(past.sum() / ((a_s > 0) | (a_1 > 0)).sum()),
        max_delta=int((sdc_s.int() - sdc_1.int()).abs().max()),
        shape=tuple(sdc.shape), covered=float(a_1.mean()))


# phase 11 (e), in fp32 and in bf16: the posed vertices (m); a depth tie
# (``depth_gaps``, relative to the depth: the widest of the 54 ties read in
# fp32 was 8.73e-8); the pixels past one level a run may excuse on edges and
# ties (56 read in fp32 at 48 and at 47 frames). bf16 reads 0 m and 0 pixels
# at the sound weight seeds 0-3 of ``--calibrate multi``, the gathered
# blocks reversed 0.1504 m and 79% of the covered pixels.
VERTS_TOL, TIE_REL, EXCUSED_MAX = 1e-5, 1e-6, 300


def check_sdc(t, res, dtype):
    """Phase 11 (e): the frame-parallel motion stage against the single
    process (``sdc_stats``): the posed vertices within VERTS_TOL (the
    forwards on 24 crops a rank and on the whole clip may round
    differently), both renders equal in every bit, no pixel of the two
    sdcs more than one level apart off the faces' edges and depth ties,
    and at most EXCUSED_MAX there; in bf16 also each rank's
    REPEAT_CALLS single-process posed vertices equal in every bit."""
    from mimo_tpu_torch.tools import profile_decomp as PD
    _, h, w = PD.CLIP
    repeat = [float(x) for x in res.get("repeat", ())]
    excused = res["on_edges"] + res["on_ties"]
    log(f"  (e) motion stage frame-parallel ({dtype}), {t} frames over 2 "
        f"ranks: {res['seconds']:.2f} s (rank 0); posed vertices max |d| "
        f"{res['verts_d']:.3g} m (limit {VERTS_TOL}); the frame-parallel "
        f"render of the single process's vertices "
        f"{'equal' if res['render_equal'] else 'NOT equal'} to its "
        f"single-process render, the sharded sdc "
        f"{'equal' if res['sdc_equal'] else 'NOT equal'} to the render of "
        f"its vertices (every bit); vs the single process's sdc: max uint8 "
        f"delta {res['max_delta']}, {res['past']} pixels past 1 (share "
        f"{res['share']:.4g} of the covered): {res['on_edges']} on a face "
        f"edge, {res['on_ties']} on a depth tie (largest gap "
        f"{res['tie_rel_max']:.3g} of the depth, limit {TIE_REL}), "
        f"{res['unexplained']} elsewhere (limits: {EXCUSED_MAX} excused, 0 "
        f"elsewhere); covered share {res['covered']:.4f}"
        + (f"; single-process vertices {REPEAT_CALLS} times, max |d| from "
           f"the first a rank: "
           f"{[round(x, 6) for x in repeat]} (must be 0)" if repeat else ""))
    ok = (res["shape"] == (t, h, w, 3) and res["render_equal"]
          and res["sdc_equal"] and res["verts_d"] <= VERTS_TOL
          and not res["unexplained"] and excused <= EXCUSED_MAX
          and not any(repeat))
    if not ok:
        raise AssertionError(f"(e) {dtype}: the frame-parallel motion stage "
                             f"disagrees")


def multi_body(dev, tasks):
    """Phase 11's rank body: the tasks in order (one weight set kept)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    runners = {}
    out = []
    for task in tasks:
        t0 = time.perf_counter()
        if task["kind"] == "animate":
            res = multi_animate(dev, runners, task)
        else:
            runners.clear()
            torch.cuda.empty_cache()
            res = multi_motion(dev, task)
        out.append(dict(res, task_s=time.perf_counter() - t0))
    return out


def window_shape(frames):
    """(windows, frames a window) of a clip at MIMOConfig()'s context."""
    from mimo_tpu_torch import config as C
    from mimo_tpu_torch.pipelines import pose2vid
    st = pose2vid.Pose2VideoStatic(cfg=C.MIMOConfig(), num_frames=frames,
                                   height=8, width=8, num_inference_steps=1,
                                   guidance_scale=3.5)
    return pose2vid.make_windows(st)[0].shape


def agreement(got, want):
    err = np.abs(np.asarray(got, np.float64) - want)
    return float(err.max()), float(err.mean())


def single_videos(tasks):
    """The single-process videos of the animate tasks, in this process
    (full-width weights of each task's seed, as the ranks draw them)."""
    from mimo_tpu_torch import config as C
    from mimo_tpu_torch.entry.animate import animate
    from mimo_tpu_torch.entry.runner import Runner, init_random_params
    dev = torch.device("cuda")
    cfg = C.MIMOConfig()
    out, runner = {}, None
    for task in tasks:
        seed = task.get("weights_seed", 0)
        if runner is None or runner[0] != seed:
            runner = None
            torch.cuda.empty_cache()
            runner = (seed, Runner(cfg=cfg, params=motion_weights(
                init_random_params(cfg, torch.Generator(
                    device=dev).manual_seed(seed), dtype=torch.bfloat16),
                dev), device=dev, dtype=torch.bfloat16))
        frames, size = task["clip"]
        ref, clip = template_frames(frames)
        key = (seed, task["seed"], frames, size)
        if key not in out:
            out[key] = animate(runner[1], ref, clip, width=size[1],
                               height=size[0], steps=MULTI_STEPS,
                               cfg_scale=3.5, seed=task["seed"])
    del runner
    torch.cuda.empty_cache()
    return out


def flagship_task(seed=42, **kw):
    """Phase 11 (a)'s generation: phase 5's 24-frame 512x784 clip, CFG 3.5,
    one window, frame-parallel over a world-wide "data" axis."""
    return dict(kind="animate", clip=(FRAMES, (HEIGHT, WIDTH)), seed=seed,
                axes=dict(frame_axis="data"), **kw)


def log_run(label, res, world):
    tm = res["timings"]
    steps = max(1, MULTI_STEPS)
    log(f"  {label}: prepare {tm['prepare']:.1f} ms | mean step "
        f"{tm['step_mean']:.1f} ms | decode {tm['decode']:.1f} ms (CUDA "
        f"events, rank 0) | {res['wall']:.2f} s wall | all-to-all "
        f"{res['a2a_bytes'] / steps / 1e9:.4f} GB sent and "
        f"{res['a2a_s'] / steps:.4f} s a step, {res['a2a_calls']} calls | "
        f"UNet window-frames {res['unet_frames']} | peak "
        f"{res['peak_gib']:.2f} GiB | world {world}")


def phase_multi():
    """Phase 11: the multi-process layer through ``entry/graft.py``'s
    spawner, every rank on this card (NCCL refuses two ranks on one card,
    so worlds of 2 and 4 run over gloo, and NCCL at a world of 1):
    (a) the frame-parallel flagship and (b) window DP with the hybrid tail,
    world 2; (c) (a) on NCCL, world 1; (d) 2-D, world 4; (e) the
    decomposition's motion stage, world 2. Returns rank 0's kernel launches
    and flash launches by head width of (a)'s second run."""
    log("== phase 11: multi-process layer (torch.distributed, every rank on "
        "this card)")
    from mimo_tpu_torch.entry import graft
    from mimo_tpu_torch.tools import profile_decomp as PD
    t_phase = time.perf_counter()
    mx_tol, mean_tol = multi_tol()
    flag = flagship_task(mesh=((2,), ("data",)), runs=2)
    dp = dict(kind="animate", clip=(DP_CLIP[0], (DP_CLIP[1], DP_CLIP[1])),
              seed=7, mesh=((2,), ("data",)), axes=dict(mesh_axis="data"),
              runs=1)
    two_d = dict(dp, mesh=((2, 2), ("data", "frame")),
                 axes=dict(mesh_axis="data", frame_axis="frame",
                           pad_windows_to=2))
    t0 = time.perf_counter()
    single = single_videos([flag, dp])
    log(f"  single-process references ((a) and (b), this process): "
        f"{time.perf_counter() - t0:.1f} s")

    def check_video(label, res, task, limit=True):
        frames, size = task["clip"]
        want = single[(task.get("weights_seed", 0), task["seed"], frames,
                       size)]
        got = res["video"].float().numpy()
        if got.shape != want.shape or not np.isfinite(got).all():
            raise AssertionError(f"{label}: video {got.shape}")
        mx, mean = agreement(got, want)
        ok = mx <= mx_tol and mean <= mean_tol if limit else mx == 0
        log(f"  {label} vs the single process: max_abs_err={mx:.4g} "
            f"mean_abs_err={mean:.4g} ("
            + (f"limit max <= {mx_tol}, mean <= {mean_tol}: between the "
               f"sound seeds and the planted faults of --calibrate multi"
               if limit else "must be equal in every bit")
            + f") {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{label} disagrees with the single process")

    # (a), (b), (e): one world of 2 over gloo
    t0 = time.perf_counter()
    # phase 7's 48 frames, then a ragged 47, in fp32 and in bf16
    motion = [dict(kind="motion", frames=(PD.CLIP[0], PD.CLIP[0] - 1),
                   dtype=dtype) for dtype in ("float32", "bfloat16")]
    ranks = graft.spawn(multi_body, 2, backend="gloo", device="cuda:0",
                        args=([flag, dp] + motion,))
    log(f"  world 2 (gloo, both ranks on cuda:0): "
        f"{time.perf_counter() - t0:.1f} s wall, tasks "
        f"{[round(r['task_s'], 1) for r in ranks[0]]} s")
    a = ranks[0][0]
    log_run(f"(a) frame-parallel {FRAMES}x{HEIGHT}x{WIDTH}, run 2, rank 0",
            a, 2)
    log_run("(a) rank 1", ranks[1][0], 2)
    check_video("(a) rank 0's video", a, flag)
    if not all(r[0]["repeat_equal"] for r in ranks):
        raise AssertionError("(a): two runs differ")
    log(f"  (a) second run equal in every bit to the first on both ranks")
    log(f"  (a) rank 0's kernel launches in run 2: {a['launches']}")
    for name in unlaunched(a["launches"]):
        raise AssertionError(f"(a): the frame-parallel path never "
                             f"launched {name}")
    b = [r[1] for r in ranks]
    log_run(f"(b) window DP + hybrid tail {DP_CLIP[0]}x{DP_CLIP[1]}x"
            f"{DP_CLIP[1]}, rank 0", b[0], 2)
    check_video("(b) rank 0's video", b[0], dp)
    # each rank runs its share of the even chunk and its half of the tail
    # window's frames a step (three windows of 24: 24 + 12), where padding
    # the windows to an even count would run whole windows
    wn, cs = window_shape(DP_CLIP[0])
    even = max(2, wn - wn % 2)
    want_frames = MULTI_STEPS * (even // 2 * cs + (wn - even) * cs // 2)
    log(f"  (b) UNet window-frames a rank: {[r['unet_frames'] for r in b]} "
        f"({wn} windows of {cs}: its windows and half the tail's frames a "
        f"step, {want_frames} in all; padding to {-(-wn // 2) * 2} windows "
        f"would run {MULTI_STEPS * -(-wn // 2) * cs})")
    if any(r["unet_frames"] != want_frames for r in b):
        raise AssertionError("(b): a rank ran a padded window")
    for task, res in zip(motion, ranks[0][2:]):
        for t, run in res["runs"].items():
            check_sdc(t, run, task["dtype"])

    # (c): (a) on NCCL, a world of 1
    t0 = time.perf_counter()
    c, probe = graft.spawn(graft.bodies, 1, backend="nccl", device="cuda",
                           args=([(multi_body, ([flagship_task(
                               mesh=((1,), ("data",)), runs=2)],)),
                                  (graft.probe_body, ())],))[0]
    c = c[0]
    log(f"  world 1 (NCCL): {time.perf_counter() - t0:.1f} s wall; each "
        f"collective called on CUDA tensors (the generation, at world 1, "
        f"calls none): {probe}")
    if any(v != "ok" for v in probe.values()):
        raise AssertionError("(c): an NCCL collective failed")
    log_run("(c) NCCL world 1, run 2", c, 1)
    check_video("(c) the NCCL run's video", c, flag, limit=False)
    if not c["repeat_equal"]:
        raise AssertionError("(c): two runs differ")

    # (d): 2-D, a world of 4
    t0 = time.perf_counter()
    d4 = graft.spawn(multi_body, 4, backend="gloo", device="cuda:0",
                     args=([two_d],))
    log(f"  world 4 (gloo, every rank on cuda:0): "
        f"{time.perf_counter() - t0:.1f} s wall")
    log_run(f"(d) 2-D (2, 2) {DP_CLIP[0]}x{DP_CLIP[1]}x{DP_CLIP[1]}, rank 0",
            d4[0][0], 4)
    check_video("(d) rank 0's video", d4[0][0], two_d)
    log(f"  phase 11: {time.perf_counter() - t_phase:.1f} s wall")
    return a["launches"], a["widths"]


def multi_calibrate() -> None:
    """Phase 11's readings, on a world of 2: (a)'s frame-parallel flagship
    against the single process over sound seeds (weights and noise) and
    with a planted fault in the ranks (the temporal PE over the rank's own
    frames; the all-to-all's blocks in reverse rank order); then (e)'s bf16
    motion stage at 48 frames over sound weight seeds and with the
    gathered blocks in reverse rank order."""
    from mimo_tpu_torch.entry import graft
    from mimo_tpu_torch.tools import profile_decomp as PD
    log("== calibrate: frame-parallel flagship (world 2, gloo) vs the single "
        "process")
    tasks = [flagship_task(mesh=((2,), ("data",)), runs=1, weights_seed=s,
                           seed=s) for s in (7, 8, 9, 10, 11)]
    tasks += [flagship_task(mesh=((2,), ("data",)), runs=1, weights_seed=7,
                            seed=7, fault=f)
              for f in ("local PE", "reversed a2a")]
    motion = [dict(kind="motion", frames=(PD.CLIP[0],), dtype="bfloat16",
                   weights_seed=s) for s in (0, 1, 2, 3)]
    motion += [dict(motion[0], fault="reversed gather")]
    single = single_videos(tasks)
    ranks = graft.spawn(multi_body, 2, backend="gloo", device="cuda:0",
                        args=(tasks + motion,))
    for task, res in zip(tasks, ranks[0]):
        mx, mean = agreement(res["video"].float().numpy(), single[(
            task["weights_seed"], task["seed"], *task["clip"])])
        name = (f"fault '{task['fault']}' seed {task['seed']}"
                if task.get("fault") else f"sound seed {task['seed']}")
        log(f"  {name}: max_abs_err={mx:.4g} mean_abs_err={mean:.4g}")
    log("== calibrate: (e) bf16 motion stage (world 2, gloo) vs the single "
        "process")
    for task, res in zip(motion, ranks[0][len(tasks):]):
        run = res["runs"][PD.CLIP[0]]
        name = (f"fault '{task['fault']}' weights seed "
                f"{task['weights_seed']}" if task.get("fault")
                else f"sound weights seed {task['weights_seed']}")
        log(f"  {name}: vertices max |d| {run['verts_d']:.4g} m, share past "
            f"one level {run['share']:.4g} ({run['past']} pixels: "
            f"{run['on_edges']} on edges, {run['on_ties']} on ties, "
            f"{run['unexplained']} elsewhere), max delta {run['max_delta']}, "
            f"single-process repeat {[float(x) for x in run['repeat']]}")


def repeat_calibrate() -> None:
    """Phase 8's bf16 repeat check (this process) and phase 11 (e)'s (a
    world of 2 over gloo, 48 frames) at weight seeds 0-3, each as it is
    and with CUDNN_FAULT planted: the readings and whether the check
    passed."""
    from mimo_tpu_torch.decomp import factory as FA
    from mimo_tpu_torch.entry import graft
    from mimo_tpu_torch.tools import profile_decomp as PD
    seeds, faults = (0, 1, 2, 3), (None, CUDNN_FAULT)
    log("== calibrate: phase 8's bf16 repeat check, sound and with cuDNN's "
        "attention put back")
    dev = torch.device("cuda")
    frames, _, boxes = PD.synth_frames(*PD.CLIP)
    for seed in seeds:
        est = FA.build_decomp_models(params=motion_params(
            dev, torch.bfloat16, seed)).estimate_motion.__self__
        for fault in faults:
            with plant(fault):
                try:
                    repeat_check(est, frames, boxes)
                    verdict = "passed"
                except AssertionError:
                    verdict = "FAILED"
            log(f"  weights seed {seed}, {fault or 'sound'}: the check "
                f"{verdict}")
        del est
        torch.cuda.empty_cache()
    log("== calibrate: phase 11 (e)'s bf16 repeat (world 2, gloo), sound "
        "and with cuDNN's attention put back")
    tasks = [dict(kind="motion", frames=(PD.CLIP[0],), dtype="bfloat16",
                  weights_seed=seed, fault=fault)
             for seed in seeds for fault in faults]
    ranks = graft.spawn(multi_body, 2, backend="gloo", device="cuda:0",
                        args=(tasks,))
    for task, res in zip(tasks, ranks[0]):
        run = res["runs"][PD.CLIP[0]]
        repeat = [float(x) for x in run["repeat"]]
        log(f"  weights seed {task['weights_seed']}, "
            f"{task['fault'] or 'sound'}: max |d| from the first call a "
            f"rank {[round(x, 6) for x in repeat]} m, sharded vs single "
            f"vertices {run['verts_d']:.4g} m; the repeat check "
            f"{'FAILED' if any(repeat) else 'passed'}")


def reset_counts():
    """Every kernel wrapper's launch count (and the flash wrappers' counts by
    head width) set to 0; returns the wrappers."""
    from mimo_tpu_torch.ops import flash_attention as FA
    from mimo_tpu_torch.ops import kernel_wrappers
    counters = kernel_wrappers()
    for fn in counters:
        fn.launches = 0
    for fn in FA.FLASH_WRAPPERS:
        fn.widths.clear()
    return counters


# Hiera's row passes (ops/rows.py): wrappers of the tracker's path alone,
# which no synthesis path launches
TRACK_ONLY = ("bias_gelu", "bias_residual")


def unlaunched(counts):
    """The synthesis wrappers that ``counts`` ({name: launches}) shows
    never launched."""
    return [name for name, n in counts.items()
            if n <= 0 and name not in TRACK_ONLY]


def flash_widths():
    """The flash wrappers' launches since ``reset_counts``, by (wrapper
    name, head width)."""
    from mimo_tpu_torch.ops import flash_attention as FA
    return Counter({(fn.__name__, d): n for fn in FA.FLASH_WRAPPERS
                    for d, n in fn.widths.items()})


@contextlib.contextmanager
def patched(module, name, value):
    """``module.name`` set to ``value`` within."""
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def calibrate(sections=()) -> None:
    """Readings that place the limits of the small-input agreement checks
    (``sections``: any of "main", "decomp", "motion", "bk", "multi"; all if
    empty), and ``repeat_calibrate`` ("repeat", only when named)."""
    if "repeat" in sections:
        repeat_calibrate()
        sections = set(sections) - {"repeat"}
        if not sections:
            return
    sections = set(sections) or {"main", "decomp", "motion", "bk", "multi"}
    if "bk" in sections:
        bk_calibrate()
    if "main" in sections:
        main_calibrate()
    if "decomp" in sections:
        decomp_calibrate()
    if "motion" in sections:
        motion_calibrate()
    if "multi" in sections:
        multi_calibrate()


def main_calibrate() -> None:
    """The main path's agreement check: sound runs over several seeds, then
    runs with a planted fault in the card path (the bank keys dropped from
    the banked flash attention, the flash softmax scale off by 25%, the
    motion modules' PE dropped)."""
    from mimo_tpu_torch.models import unet as U
    from mimo_tpu_torch.ops import attention as AT
    from mimo_tpu_torch.ops import flash_attention as FA

    tattn = U.temporal_attention_ln
    faults = {
        "bank dropped": lambda: patched(
            AT, "flash_attention_nt_bank",
            lambda q, k, v, kb, vb, heads: FA.flash_attention_nt(q, k, v,
                                                                 heads)),
        "flash scale x1.25": lambda: patched(FA, "LOG2E", FA.LOG2E * 1.25),
        "motion PE dropped": lambda: patched(
            U, "temporal_attention_ln",
            lambda p, ln_p, pe, x, heads: tattn(p, ln_p, pe * 0, x, heads)),
    }
    log("== calibrate: small-input agreement, card bf16 vs CPU fp32")
    for seed in (7, 8, 9, 10, 11):
        mx, mean = agreement_error(seed)
        log(f"  sound seed {seed}: max_abs_err={mx:.4g} mean_abs_err="
            f"{mean:.4g}")
    for name, fault in faults.items():
        mx, mean = agreement_error(7, fault)
        log(f"  fault '{name}' seed 7: max_abs_err={mx:.4g} mean_abs_err="
            f"{mean:.4g}")


def decomp_calibrate() -> None:
    """The decomposition check's readings: sound seeds, then planted faults
    in the card run (the flash softmax scale off by 25%, the decoders'
    ragged key tile's zero rows counted as keys, d = 72's second column box
    dropped, the propagation's memories of earlier frames dropped, the
    memory attention's RoPE dropped); then
    the scale fault against phase 3's flash checks at the new widths."""
    from mimo_tpu_torch.decomp import sam2 as S2
    from mimo_tpu_torch.ops import flash_attention as FA
    from mimo_tpu_torch.ops import attention as AT
    memory_attention = S2.memory_attention
    flash = AT.flash_attention_nt

    def zero_keys_counted(q, k, v, heads):
        # a ragged key tile's zero-filled rows taken as keys: the decoders'
        # 7 prompt tokens padded with zero keys and values to one 128-key
        # tile
        if k.shape[1] < 128:
            pad = (0, 0, 0, 128 - k.shape[1])
            k = torch.nn.functional.pad(k, pad)
            v = torch.nn.functional.pad(v, pad)
        return flash(q, k, v, heads)

    def second_box_dropped(q, k, v, heads):
        # d = 72's second 64-column box lost: each head's q and k columns
        # 64-71 read as zeros (Hiera's global blocks)
        d = q.shape[2] // heads
        if d == 72:
            keep = (torch.arange(q.shape[2], device=q.device) % d < 64)
            q, k = q * keep.to(q.dtype), k * keep.to(k.dtype)
        return flash(q, k, v, heads)

    def scale_fault():
        return patched(FA, "LOG2E", FA.LOG2E * 1.25)

    faults = {
        "flash scale x1.25": scale_fault,
        "zero keys of the ragged tile counted": lambda: patched(
            AT, "flash_attention_nt", zero_keys_counted),
        "d = 72's second box dropped": lambda: patched(
            AT, "flash_attention_nt", second_box_dropped),
        "recent memories dropped": lambda: patched(
            S2, "memory_attention",
            lambda p, cfg, f, fp, mem, mp, ptr: memory_attention(
                p, cfg, f, fp, mem[:1], mp[:1], ptr)),
        "RoPE dropped": lambda: patched(
            S2, "_apply_rope", lambda x, cos, sin: x),
    }
    log("== calibrate: SAM2 propagate, card bf16 vs CPU fp32 on each "
        "call's own inputs")
    for name, seed, fault in ([(f"sound seed {s}", s, None)
                               for s in (7, 8, 9, 10, 11)]
                              + [(f"fault '{n}' seed 7", 7, f)
                                 for n, f in faults.items()]):
        errors, _ = decomp_agreement_error(seed, fault)
        log(f"  {name}: " + "; ".join(
            f"{m} max_abs_err={mx:.4g} mean_abs_err={mean:.4g}"
            for m, (mx, mean) in errors.items()))
    # phase 3's d = 72 (q|k|v views) and d = 16 (7 keys) checks, at B = 1,
    # under the scale fault
    gen = torch.Generator(device="cuda").manual_seed(1234)
    for d, sk, views in ((72, 4096, True), (16, 7, False)):
        inner = 8 * d
        x = torch.randn((1, 4096, 3 * inner), generator=gen, device="cuda")
        q = (x[..., :inner] * 2).bfloat16()
        k, v = ((x[..., inner:2 * inner] * 2).bfloat16(),
                x[..., 2 * inner:].bfloat16())
        if views:
            qkv = torch.cat([q, k, v], -1)
            q, k, v = qkv.split(inner, dim=-1)
        else:
            k, v = k[:, :sk].contiguous(), v[:, :sk].contiguous()
        want = FA.attention_plain(q, k, v, 8).float()
        with scale_fault():
            got = FA.flash_attention_nt(q, k, v, 8).float()
        err = (got - want).abs()
        excess = float((err - (2e-2 + 2e-2 * want.abs())).max())
        log(f"  fault 'flash scale x1.25' in phase 3's d={d} Sk={sk} check: "
            f"max_abs_err={float(err.max()):.4g} (tolerance 0.02 + "
            f"0.02*|ref|): {'caught' if excess > 0 else 'NOT caught'}")


def motion_calibrate() -> None:
    """Phase 8's readings: sound seeds, then planted faults in the card's
    HMR2 (the two 6D columns swapped before Gram-Schmidt, the last IEF
    update dropped)."""
    from mimo_tpu_torch.decomp import hmr as HM
    rot6d, forward = HM.rot6d_to_rotmat, HM.hmr_forward
    faults = {
        "rot6d columns swapped": lambda: patched(
            HM, "rot6d_to_rotmat",
            lambda x: rot6d(torch.cat([x[..., 3:6], x[..., 0:3]], -1))),
        "IEF update dropped": lambda: patched(
            HM, "hmr_forward", lambda p, cfg, crops: forward(
                p, dataclasses.replace(cfg, ief_iters=cfg.ief_iters - 1),
                crops)),
    }
    log("== calibrate: HMR2, lbs and the render, card vs CPU fp32 on the "
        "card call's own inputs")
    for name, seed, fault in ([(f"sound seed {s}", s, None)
                               for s in (7, 8, 9, 10, 11)]
                              + [(f"fault '{n}' seed 7", 7, f)
                                 for n, f in faults.items()]):
        errors = motion_agreement_error(seed, fault)
        log(f"  {name}: " + "; ".join(
            f"{m} {a:.4g} / {b:.4g}" for m, (a, b) in errors.items()))


def _leaves(tree):
    """The tensors of a parameter tree (not its ints and strings)."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def main() -> None:
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = phase_device()
    phase_build()
    if sys.argv[1:2] == ["--calibrate"]:
        calibrate(sys.argv[2:])
        return
    entries = phase_kernels()
    if sys.argv[1:] == ["--kernels"]:
        gemm_breakdown()
        print(json.dumps({"kernels": entries}))
        return
    ablation, ablation_launches = phase_ablation()
    animate_launches, runner = phase_main_path()
    launches = {"animate": animate_launches, "tool": ablation_launches,
                "edit": phase_edit(runner)}
    del runner
    torch.cuda.empty_cache()
    track, track_widths = phase_decomp()
    torch.cuda.empty_cache()
    launches["motion"], sdc = phase_motion()
    torch.cuda.empty_cache()
    bk_occ, bk_occ_widths = phase_bk_occ(sdc)
    # the decomposition path: the track run of phase 7 and the bk and occ
    # runs of phase 9, its flash entries counted at their head width
    launches["decomp"] = track + bk_occ
    widths = track_widths + bk_occ_widths
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work, \
            without_opencv():
        run_launches, run_widths = phase_decomp_run(work)
    torch.cuda.empty_cache()
    launches["frame-parallel"], fp_widths = phase_multi()

    def row(e, path, count):
        return {"name": e["name"], "route": e["route"],
                "source": e["source"], "replaces": e["replaces"],
                "shape": e["shape"], "path": path, "launches": count,
                "max_abs_err": e["max_abs_err"], "ms": e["ms"],
                "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
                "bound_by": e["bound_by"], "library_ms": e["library_ms"],
                "library": e["library"]}

    log("== phase 12: the kernels' JSON line")
    kernels = []
    for e in entries + ablation:
        kernels.append(row(e, e["path"], widths[e["width"]]
                           if e["path"] == "decomp" and "width" in e
                           else launches[e["path"]][e["name"]]))

    def path_rows(path, counts, path_widths):
        # one row a kernel the run launched (a flash wrapper's at each head
        # width it launched), with the numbers of its first phase-3 case
        # and its launches in the run; a kernel with phase-3 cases of the
        # path's own shapes has its rows above
        own = {e["name"] for e in entries if e["path"] == path}
        rows = {}
        for e in entries:
            key = (e["name"], e["width"]) if "width" in e else e["name"]
            count = path_widths[key] if "width" in e else counts[key]
            if count and key not in rows and e["name"] not in own:
                rows[key] = row(e, path, count)
        unchecked = set(path_widths) - set(rows)
        if unchecked:
            raise AssertionError(f"the {path} path launched flash at "
                                 f"{unchecked}, which no phase-3 case checks")
        return list(rows.values())

    # phase 10's decomposition run, animate and edit; phase 11 (a)'s rank 0
    kernels += path_rows("decomp-run", run_launches, run_widths)
    kernels += path_rows("frame-parallel", launches["frame-parallel"],
                         fp_widths)
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all (build "
        f"included)")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
