"""Ablation cost model of the flash attention kernel at UNet level 0's
banked shape (B=24, Sq=6272, Sk=12544 = self + bank, 8 heads, d=40).

Counterpart of ``tools/ablate_flash.py``. Each mode is a build of the
production flash kernel's own body (``csrc/flash_body.cuh``: wgmma + TMA,
a producer and two consumer warpgroups on an mbarrier ring) with one piece
of its work removed at compile time (``csrc/flash_ablate.cu`` and
``flash_body.cuh`` state each mode exactly); ``full - mode`` attributes the
production kernel's time to the piece. The numbers are not an exact
decomposition (a removed piece frees issue slots for its neighbours) but
rank the targets.

  full      the production kernel (bit-equal to ops.flash_attention's
            flash_attention_nt on the same inputs)
  noexp     no MUFU exp2 per logit        -> full - noexp   = exp2 cost
  nosm      no scale/mask/max/exp2        -> full - nosm    = softmax cost
  nopv      no P.V wgmma                  -> full - nopv    = PV cost
  noqk      rank-1 stand-in for Q.K^T     -> full - noqk    = QK cost
  nomxu     noqk + nopv                   -> full - nomxu   = tensor-core cost
  noshift   fixed shift, no running max   -> full - noshift = shift-chain cost
  chunk2/4  Q.K^T in 2 / 4 wgmma groups, the softmax of a sub-chunk while
            the later ones run            -> full - chunk*  = overlap gain
  every mode pretransposed (q, k, v as (B, H*d, S); Q, K read MN-major, V
  K-major, by the wgmma descriptors' transpose bits)
                                          -> mode - mode pretransposed
                                             = transpose cost

``run`` takes the kernel for CUDA tensors (or raises) and ``run_plain``,
the plain PyTorch version of every mode, for CPU tensors. The TPU tool's
block arguments do not carry over: the Hopper tiles are the production
kernel's compile-time constants (128 queries x ``BLOCK_K`` = 128 keys at
d = 40 and 80).

Usage (on a CUDA card): python -m mimo_tpu_torch.tools.ablate_flash
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from mimo_tpu_torch.ops import _build
from mimo_tpu_torch.ops.flash_attention import (LOG2E, _check_operand,
                                                attention_plain)
from mimo_tpu_torch.tools.timing import bound, card_line, flash_work

# the C interface's mode numbers (csrc/flash_body.cuh FlashMode)
MODES = ("full", "noexp", "nosm", "nopv", "noqk", "nomxu", "noshift",
         "chunk2", "chunk4")
# modes whose output is attention (the others are bounded stand-ins)
ATTENTION_MODES = ("full", "noshift", "chunk2", "chunk4")
KERNEL_DIMS = (40, 80)
# keys a tile of the kernel at both widths (FlashTile<D>::kBK): the
# stand-ins' per-tile state
BLOCK_K = 128


def nopv_key(cols: torch.Tensor) -> torch.Tensor:
    """For each output column c, the key of a tile whose p that column
    adds in nopv / nomxu: o register 4i + 2h + e of a thread (column
    8i + 2t + e) adds s register 4i + 2h + e of the same thread (key
    8i + 2t + e of the same row), so key c."""
    return cols % BLOCK_K


def mode_work(mode: str, b: int, heads: int, d: int, sq: int, sk: int):
    """``flash_work`` of a mode: the products it keeps (nopv and noqk drop
    one, nomxu both) and one exp2 a logit unless it drops them (noexp,
    nosm); q, k, v read once, o written once."""
    products = 2 - (mode in ("nopv", "noqk")) - 2 * (mode == "nomxu")
    return flash_work(b, heads, d, sq, sk, b * (sq + 2 * sk) * heads * d,
                      products, exp2=mode not in ("noexp", "nosm"))


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"ablate_flash: unknown mode {mode!r}; one of {MODES}")


def _heads_first(x: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, S, H*d) -> fp32 (B, H, S, d)."""
    b, s, inner = x.shape
    return x.reshape(b, s, heads, inner // heads).transpose(1, 2).float()


def run_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
              mode: str = "full", pretransposed: bool = False) -> torch.Tensor:
    """The plain PyTorch version of every mode, in fp32, result (B, Sq, H*d)
    in q's dtype. The attention modes are ``attention_plain``; the others
    keep the kernel's per-tile state, so they loop over its ``BLOCK_K``-key
    tiles and round P to bf16 where the kernel feeds it to a wgmma."""
    _check_mode(mode)
    if pretransposed:
        q, k, v = (x.transpose(1, 2) for x in (q, k, v))
    if mode in ATTENTION_MODES:
        return attention_plain(q, k, v, heads)
    b, sq, inner = q.shape
    d = inner // heads
    qh, kh, vh = (_heads_first(x, heads) for x in (q, k, v))
    rank1 = mode in ("noqk", "nomxu")
    pick = mode in ("nopv", "nomxu")
    pick_key = nopv_key(torch.arange(d, device=q.device))
    scale = LOG2E / math.sqrt(d)
    m = torch.full((b, heads, sq, 1), -math.inf, device=q.device)
    l = torch.zeros((b, heads, sq, 1), device=q.device)
    acc = torch.zeros((b, heads, sq, d), device=q.device)
    for k0 in range(0, kh.shape[2], BLOCK_K):
        kt, vt = kh[:, :, k0:k0 + BLOCK_K], vh[:, :, k0:k0 + BLOCK_K]
        if rank1:
            s = qh[..., :1] * kt[..., 0][:, :, None, :] - 8.0
        else:
            s = torch.matmul(qh, kt.transpose(-1, -2))
        if mode == "nosm":
            p = s.abs() + 1.0
            # the zero-filled keys past a ragged edge weigh |0| + 1
            l = l + p.sum(-1, keepdim=True) + (BLOCK_K - kt.shape[2])
            acc = acc + torch.matmul(p.bfloat16().float(), vt)
            continue
        x = s * scale
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        if mode == "noexp":
            p = torch.clamp(x - m_new, min=-16.0) + 16.0
        else:
            p = torch.exp2(x - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        if pick:
            p = torch.nn.functional.pad(p, (0, BLOCK_K - kt.shape[2]))
            acc = acc * alpha + p[..., pick_key]
        else:
            acc = acc * alpha + torch.matmul(p.bfloat16().float(), vt)
        m = m_new
    out = acc / l
    return out.transpose(1, 2).reshape(b, sq, inner).to(q.dtype)


def _run_cuda(q, k, v, heads: int, mode: str,
              pretransposed: bool) -> torch.Tensor:
    b = q.shape[0]
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, x, b)
    # natural (B, S, H*d) or pretransposed (B, H*d, S)
    sq, inner = (q.shape[2], q.shape[1]) if pretransposed else q.shape[1:]
    sk = k.shape[2] if pretransposed else k.shape[1]
    want = (b, inner, sk) if pretransposed else (b, sk, inner)
    if inner % heads or inner // heads not in KERNEL_DIMS:
        raise ValueError(f"ablate_flash kernel: head dim {inner}/{heads} is "
                         f"not one of {KERNEL_DIMS}")
    if tuple(k.shape) != want or tuple(v.shape) != want or sk < 1:
        raise ValueError(f"ablate_flash kernel: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    d = inner // heads
    out = torch.empty((b, sq, inner), dtype=q.dtype, device=q.device)
    err = _build.load_library().mimo_flash_ablate_fwd(
        MODES.index(mode), int(pretransposed), q.data_ptr(), k.data_ptr(),
        v.data_ptr(), out.data_ptr(), b, heads, d, sq, sk,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), out.stride(0), out.stride(1),
        LOG2E / math.sqrt(d), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, f"ablate_flash run({mode})")
    return out


def run(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
        mode: str = "full", pretransposed: bool = False) -> torch.Tensor:
    """Flash attention with ablation ``mode`` (one of MODES), bf16,
    d in (40, 80). q: (B, Sq, H*d), k/v: (B, Sk, H*d); with
    ``pretransposed`` (B, H*d, S) views whose S is contiguous, channel
    stride a multiple of 8 (see ``pretranspose``). Returns (B, Sq, H*d)."""
    _check_mode(mode)
    if not q.is_cuda:
        return run_plain(q, k, v, heads, mode, pretransposed)
    out = _run_cuda(q, k, v, heads, mode, pretransposed)
    run.launches += 1
    return out


run.launches = 0


def pretranspose(x: torch.Tensor) -> torch.Tensor:
    """(B, S, C) -> a (B, C, S) view with S contiguous and the channel
    stride rounded up to a multiple of 8, as the kernel's 16-byte loads
    along S need."""
    b, s, c = x.shape
    buf = x.new_zeros((b, c, -(-s // 8) * 8))
    buf[:, :, :s] = x.transpose(1, 2)
    return buf[:, :, :s]


def cuda_ms(fn, reps: int = 10) -> float:
    """Mean device time of fn() in ms: one warm-up call, then ``reps``
    calls between two CUDA events."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> Dict[str, float]:
    """Times every mode in both layouts at the level-0 banked shape, and
    SDPA on the same inputs; prints each mode's ms beside its bound
    (``mode_work``) and the attribution ``full - mode`` and ``mode - mode
    pretransposed``. Returns {label: ms}."""
    if not torch.cuda.is_available():
        raise RuntimeError("ablate_flash needs a CUDA device "
                           "(torch.cuda.is_available() is False)")
    import torch.nn.functional as F
    print(card_line(), flush=True)
    # level-0 cond equivalent: the self + bank keys of the banked call,
    # C=320, 8 heads (d=40)
    b, sq, sk, c, heads = 24, 6272, 12544, 320, 8
    d = c // heads
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn((b, s, c), generator=gen, device=dev,
                           dtype=torch.bfloat16) for s in (sq, sk, sk))
    qt, kt, vt = (pretranspose(x) for x in (q, k, v))
    times = {}
    for pre in (False, True):
        args = (qt, kt, vt) if pre else (q, k, v)
        for mode in MODES:
            label = mode + (" pretransposed" if pre else "")
            times[label] = ms = cuda_ms(lambda: run(*args, heads, mode, pre))
            bound_ms, _, what = bound(*mode_work(mode, b, heads, d, sq, sk))
            print(f"lvl0cond {label:21s}: {ms:8.3f} ms/call (bound "
                  f"{bound_ms:.3f} ms by {what}, {bound_ms / ms:.0%} of it)",
                  flush=True)
    qh, kh, vh = (x.unflatten(-1, (heads, d)).transpose(1, 2)
                  for x in (q, k, v))
    times["sdpa"] = cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh))
    f = times["full"]
    print(f"SDPA on the same inputs: {times['sdpa']:.3f} ms/call "
          f"(full / SDPA = {f / times['sdpa']:.3f})")
    print(f"full: {4 * b * heads * sq * sk * d / (f * 1e-3) / 1e12:.1f} "
          f"TFLOP/s at the unpadded d")
    print("attribution (full - ablated):")
    for mode in MODES[1:]:
        print(f"  {mode:9s}: {f - times[mode]:+8.3f} ms")
    print("transposes (mode - mode pretransposed):")
    for mode in MODES:
        print(f"  {mode:9s}: {times[mode] - times[mode + ' pretransposed']:+8.3f} ms",
              flush=True)
    return times


if __name__ == "__main__":
    main()
