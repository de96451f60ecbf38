// Ablation builds of the flash attention forward kernel (Hopper, sm_90a).
//
// Replaces the TPU kernel tools/ablate_flash.py::run (_kernel): a variant of
// the transposed flash kernel that times the production math with one piece
// removed, to split the kernel's time among its pieces. Here every build is
// the first design of the flash kernel (flash_ablate.cuh: mma.sync, cp.async
// double buffering; no longer the production kernel, which is the wgmma +
// TMA design of flash_attention.cu) with one piece taken out at compile
// time; everything else, data dependencies included, stays, so
// `full - mode` is the cost of that piece of the first design on this card
// (not an exact decomposition: a removed piece frees issue slots for its
// neighbours).
//
// Modes (the TPU tool's names, with their meaning on Hopper):
//   full     the first design, unchanged (attention, within the attention
//            tolerance of the production kernel; no longer bit-equal to it)
//   noexp    no exp2 per logit: p = max(x - m, -16) + 16 with the running
//            max m and the per-tile rescale kept          -> exp2 (MUFU) cost
//   nosm     no scale, mask, row max, shuffles, rescale or exp2:
//            p = |s| + 1 of the raw product               -> softmax cost
//   nopv     no P.V mma: column c of acc sums P of one key per tile (V
//            tiles still loaded)                          -> PV cost
//   noqk     no Q.K^T mma: s = q[row][0] * k[key][0] - 8  -> QK cost
//   nomxu    noqk and nopv: no tensor-core work at all
//   noshift  no running max: exp2(x - 8), no rescale of acc and l
//                                                         -> shift-chain cost
//   chunk2/4 each 64-key tile in 2 or 4 sub-chunks, the Q.K^T of sub-chunk
//            c + 1 issued before the softmax of c         -> interleave gain
// and, for every mode, the pretransposed layout: q, k, v given as
// (B, H*d, S) with S contiguous; K/V tiles land as [d][key] and the
// fragment loads swap ldmatrix .trans and plain; Q is transposed once per
// block                                                   -> transpose cost
//
// Outputs of full, noshift, chunk2/4 (and their pretransposed builds) are
// attention; the others are bounded stand-ins that
// mimo_tpu_torch/tools/ablate_flash.py::run_plain reproduces.
// Instantiated for the UNet's two flash widths, d = 40 and 80.

#include "flash_ablate.cuh"

namespace {

template <int D, int MODE, bool PRE>
__global__ void __launch_bounds__(kThreads) flash_ablate_kernel(const FlashArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  flash_fwd_body<D, MODE, PRE>(a, smem_raw);
}

template <int D, int MODE, bool PRE>
cudaError_t launch_ablate(const FlashArgs& a, int batch, int heads,
                          cudaStream_t stream) {
  using S = FlashShape<D>;
  constexpr int smem = PRE ? S::kSmemBytesT : S::kSmemBytes;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_ablate_kernel<D, MODE, PRE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((a.sq + kBlockQ - 1) / kBlockQ, heads, batch);
  flash_ablate_kernel<D, MODE, PRE><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D, bool PRE>
cudaError_t launch_mode(int mode, const FlashArgs& a, int batch, int heads,
                        cudaStream_t st) {
  switch (mode) {
#define MIMO_ABLATE_CASE(M) \
  case M:                   \
    return launch_ablate<D, M, PRE>(a, batch, heads, st);
    MIMO_ABLATE_CASE(kFull) MIMO_ABLATE_CASE(kNoExp) MIMO_ABLATE_CASE(kNoSm)
    MIMO_ABLATE_CASE(kNoPV) MIMO_ABLATE_CASE(kNoQK) MIMO_ABLATE_CASE(kNoMXU)
    MIMO_ABLATE_CASE(kNoShift) MIMO_ABLATE_CASE(kChunk2)
    MIMO_ABLATE_CASE(kChunk4)
#undef MIMO_ABLATE_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t code (0 on success); cudaErrorInvalidValue for a d
// other than 40 or 80, an unknown mode or an empty key sequence. Strides as
// in FlashArgs: `_ss` is the sequence stride, or the channel stride when
// pretransposed != 0; o is (B, Sq, H*d) in either layout.
int mimo_flash_ablate_fwd(
    int mode, int pretransposed, const void* q, const void* k, const void* v,
    void* o, int batch, int heads, int d, int sq, int sk, long long q_bs,
    long long q_ss, long long k_bs, long long k_ss, long long v_bs,
    long long v_ss, long long o_bs, long long o_ss, float scale_log2,
    void* stream) {
  if (sk < 1 || mode < 0 || mode >= kNumModes)
    return static_cast<int>(cudaErrorInvalidValue);
  FlashArgs a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = a.kb = static_cast<const __nv_bfloat16*>(k);
  a.v = a.vb = static_cast<const __nv_bfloat16*>(v);
  a.o = static_cast<__nv_bfloat16*>(o);
  a.sq = sq;
  a.sk1 = sk;
  a.sk2 = 0;
  a.q_bs = q_bs; a.q_ss = q_ss;
  a.k_bs = a.kb_bs = k_bs; a.k_ss = a.kb_ss = k_ss;
  a.v_bs = a.vb_bs = v_bs; a.v_ss = a.vb_ss = v_ss;
  a.o_bs = o_bs; a.o_ss = o_ss;
  a.scale_log2 = scale_log2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool pre = pretransposed != 0;
  if (d == 40)
    return pre ? launch_mode<40, true>(mode, a, batch, heads, st)
               : launch_mode<40, false>(mode, a, batch, heads, st);
  if (d == 80)
    return pre ? launch_mode<80, true>(mode, a, batch, heads, st)
               : launch_mode<80, false>(mode, a, batch, heads, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
