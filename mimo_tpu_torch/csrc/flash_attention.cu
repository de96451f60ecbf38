// Flash attention forward for Hopper (sm_90a): bf16 in, bf16 out, fp32
// logits and softmax state.
//
// Replaces the TPU kernels mimo_tpu/ops/flash_transposed.py
// ::flash_attention_nt (_flash_nt_kernel) and ::flash_attention_nt_bank
// (_flash_nt2_kernel). One kernel covers both: the key/value sequence is up
// to two segments, [self (B, Sk1) | bank (1, Sk2)], and the bank is read
// with batch stride 0, so the concatenation is never built. One online
// softmax runs across both segments.
//
// Layout: q, k, v, o are the model's natural (B, S, H*d) activations with
// any batch and sequence stride (last dim contiguous). Head h is the column
// slice [h*d, (h+1)*d), so no head transposes exist on either side.
//
// Numerics: exact softmax with a true running max (not the TPU kernel's
// Cauchy-Schwarz bound shift), scale 1/sqrt(d) folded into the exp2 domain
// in fp32 after the Q.K^T product. P is rounded to bf16 for the P.V product
// (fp32 accumulation); the row sum uses the fp32 P.
//
// What bounds it on an H100: at the UNet's top level (d=40, Sq=6272, up to
// 12544 keys) the work is 4*Sq*Sk*d FLOPs per (row, head), with the K/V
// tiles re-read by every query tile (from L2, mostly) and one exp2 per
// logit. The design: one block of 8 warps per (row, head, 128-query tile),
// so each K/V tile serves 128 queries; each warp owns 16 query rows and
// keeps its Q fragments in registers for the whole key loop; 64-key K/V
// tiles are double-buffered in shared memory with cp.async, so the next
// tile's loads are in flight during this tile's math; mma.sync m16n8k16
// with d zero-padded to the next multiple of 16 for Q.K^T (40 -> 48,
// 80 -> 96); V stays row-major and its B fragments come from ldmatrix.trans.
// Ragged query and key edges are masked here (cp.async zero-fills the rows
// past the key edge). wgmma and TMA are later work. The body is
// flash_attention.cuh, which the ablation builds (flash_ablate.cu) share.

#include "flash_attention.cuh"

namespace {

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const FlashArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  flash_fwd_body<D, kFull, false>(a, smem_raw);
}

template <int D>
cudaError_t launch_flash(const FlashArgs& a, int batch, int heads,
                         cudaStream_t stream) {
  using S = FlashShape<D>;
  if (S::kSmemBytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        S::kSmemBytes);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((a.sq + kBlockQ - 1) / kBlockQ, heads, batch);
  flash_fwd_kernel<D><<<grid, kThreads, S::kSmemBytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* mimo_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Returns a cudaError_t code (0 on success). kb/vb may alias k/v when
// sk2 == 0 (the bank segment is then empty and never read).
int mimo_flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* kb, const void* vb,
    void* o, int batch, int heads, int d, int sq, int sk1, int sk2,
    long long q_bs, long long q_ss, long long k_bs, long long k_ss,
    long long v_bs, long long v_ss, long long kb_bs, long long kb_ss,
    long long vb_bs, long long vb_ss, long long o_bs, long long o_ss,
    float scale_log2, void* stream) {
  if (sk1 < 1 || sk2 < 0) return static_cast<int>(cudaErrorInvalidValue);
  FlashArgs a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.kb = static_cast<const __nv_bfloat16*>(kb);
  a.vb = static_cast<const __nv_bfloat16*>(vb);
  a.o = static_cast<__nv_bfloat16*>(o);
  a.sq = sq;
  a.sk1 = sk1;
  a.sk2 = sk2;
  a.q_bs = q_bs; a.q_ss = q_ss;
  a.k_bs = k_bs; a.k_ss = k_ss;
  a.v_bs = v_bs; a.v_ss = v_ss;
  a.kb_bs = kb_bs; a.kb_ss = kb_ss;
  a.vb_bs = vb_bs; a.vb_ss = vb_ss;
  a.o_bs = o_bs; a.o_ss = o_ss;
  a.scale_log2 = scale_log2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
#define MIMO_FLASH_CASE(DD) \
  case DD:                  \
    return launch_flash<DD>(a, batch, heads, st);
    MIMO_FLASH_CASE(8) MIMO_FLASH_CASE(16) MIMO_FLASH_CASE(24)
    MIMO_FLASH_CASE(32) MIMO_FLASH_CASE(40) MIMO_FLASH_CASE(48)
    MIMO_FLASH_CASE(56) MIMO_FLASH_CASE(64) MIMO_FLASH_CASE(72)
    MIMO_FLASH_CASE(80) MIMO_FLASH_CASE(88) MIMO_FLASH_CASE(96)
    MIMO_FLASH_CASE(104) MIMO_FLASH_CASE(112) MIMO_FLASH_CASE(120)
    MIMO_FLASH_CASE(128) MIMO_FLASH_CASE(136) MIMO_FLASH_CASE(144)
    MIMO_FLASH_CASE(152) MIMO_FLASH_CASE(160)
#undef MIMO_FLASH_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
