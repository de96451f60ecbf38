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
// Numerics: exact softmax with a true running max of the raw logits (not
// the TPU kernel's Cauchy-Schwarz bound shift); p = exp2(s*c - m*c) with
// c = log2(e)/sqrt(d), in fp32. P is rounded to bf16 only as the operand of
// P.V (fp32 accumulation); the row sum uses the fp32 P.
//
// What bounds it on an H100: at the UNet's top level (d=40, Sq=6272, up to
// 12544 keys) each logit costs 4d FLOPs of tensor-core work and one exp2 on
// the special-function unit (16 a clock per SM); at d=40 the exp2 count, not
// the FLOPs, sets the bound. The first design (warp-level m16n8k16 products
// fed by per-thread fragment loads, 16-byte async copies from every thread,
// a select and a multiply per logit; retired) was bound by instruction
// issue. This one cuts the instructions around the products and the
// softmax (the body is flash_body.cuh, shared with the ablation builds of
// flash_ablate*.cu):
// - one block per (batch row, head, 128-query tile), 384 threads: a
//   producer warpgroup whose one thread issues every TMA load
//   (cp.async.bulk.tensor, 4-D maps over (d, H, S, B), 64-column boxes with
//   the 128-byte swizzle; columns d..63 of a box and rows past a segment
//   are zero-filled), and two consumer warpgroups of 64 query rows each
//   (setmaxnreg moves the producer's registers to them);
// - the block's Q tile is loaded once; K/V tiles of kBK keys (the self
//   tiles, then the bank tiles) stream through a ring of full / empty
//   mbarrier pairs as deep as 227 KB holds;
// - Q.K^T is wgmma.mma_async m64n{kBK}k16 with both operands K-major from
//   shared memory, ceil(d/16) steps (the zero columns pad the last);
// - the softmax runs on the accumulator in registers: row max of the raw
//   logits (two quad shuffles), one FFMA and one exp2 per logit, the key
//   mask only on a segment's last tile and only if it is ragged;
// - P.V is wgmma.mma_async m64n{d}k16 with P from registers (the
//   accumulator layout of two 8-key column groups is the A fragment of one
//   16-key step) and V MN-major from shared memory (the transpose bit), so
//   V needs no transpose and P never touches shared memory;
// - O / l is written from registers, rows past Sq masked.
// Not here (later work, ordered by the ablation builds' attribution,
// PERF.md §6): at d = 40 the K/V tile loads (80-byte head rows) alone and
// the compute chain alone each take ~97% of the kernel's time, so both
// have to shrink: fewer L2 -> shared-memory bytes a query (TMA multicast
// of K/V to a cluster's blocks, or a taller Q tile) and a shorter softmax
// (exp2 partly on the FMA units, ping-pong between the consumer
// warpgroups). Issuing a tile's Q.K^T in 2 or 4 groups ahead of its
// softmax lost (chunk2 / chunk4).

#include "flash_body.cuh"

namespace {

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     const __grid_constant__ CUtensorMap map_kb,
                     const __grid_constant__ CUtensorMap map_vb,
                     const FlashArgs a) {
  flash_body<D, kFull, false>(map_q, map_k, map_v, map_kb, map_vb, a);
}

struct FlashOperands {
  const void *q, *k, *v, *kb, *vb;
  int batch, heads;
  long long q_bs, q_ss, k_bs, k_ss, v_bs, v_ss, kb_bs, kb_ss, vb_bs, vb_ss;
};

template <int D>
cudaError_t launch_flash(const FlashOperands& x, FlashArgs a,
                         cudaStream_t stream) {
  using T = FlashTile<D>;
  const int b = x.batch, h = x.heads;
  const long long bs[5] = {x.q_bs, x.k_bs, x.v_bs, x.kb_bs, x.vb_bs};
  a.batched = 0;
  for (int i = 0; i < 5; ++i)
    if (b > 1 && bs[i] != 0) a.batched |= 1 << i;
  auto batched = [&](int i) { return (a.batched >> i & 1) != 0; };
  CUtensorMap mq, mk, mv, mkb, mvb;
  bool ok = make_map(&mq, x.q, D, h, a.sq, x.q_ss, b, x.q_bs, batched(0),
                     kBlockQ) &&
            make_map(&mk, x.k, D, h, a.sk1, x.k_ss, b, x.k_bs, batched(1),
                     T::kBK) &&
            make_map(&mv, x.v, D, h, a.sk1, x.v_ss, b, x.v_bs, batched(2),
                     T::kBK);
  if (a.sk2 > 0)
    ok = ok &&
         make_map(&mkb, x.kb, D, h, a.sk2, x.kb_ss, b, x.kb_bs, batched(3),
                  T::kBK) &&
         make_map(&mvb, x.vb, D, h, a.sk2, x.vb_ss, b, x.vb_bs, batched(4),
                  T::kBK);
  else
    mkb = mvb = mk;  // never read: the bank segment is empty
  if (!ok) return cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::kSmemBytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.sq + kBlockQ - 1) / kBlockQ, h, b);
  flash_fwd_kernel<D><<<grid, kThreads, T::kSmemBytes, stream>>>(
      mq, mk, mv, mkb, mvb, a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* mimo_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Returns a cudaError_t code (0 on success). kb/vb may alias k/v when
// sk2 == 0 (the bank segment is then empty and never read). Every operand
// needs a 16-byte aligned start and batch / sequence strides that are
// multiples of 8 elements (the TMA maps' rules).
int mimo_flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* kb, const void* vb,
    void* o, int batch, int heads, int d, int sq, int sk1, int sk2,
    long long q_bs, long long q_ss, long long k_bs, long long k_ss,
    long long v_bs, long long v_ss, long long kb_bs, long long kb_ss,
    long long vb_bs, long long vb_ss, long long o_bs, long long o_ss,
    float scale_log2, void* stream) {
  if (sq < 1 || sk1 < 1 || sk2 < 0 || batch < 1 || heads < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const FlashOperands x = {q,    k,    v,    kb,   vb,    batch, heads,
                           q_bs, q_ss, k_bs, k_ss, v_bs,  v_ss,  kb_bs,
                           kb_ss, vb_bs, vb_ss};
  FlashArgs a;
  a.o = static_cast<__nv_bfloat16*>(o);
  a.o_bs = o_bs;
  a.o_ss = o_ss;
  a.sq = sq;
  a.sk1 = sk1;
  a.sk2 = sk2;
  a.scale_log2 = scale_log2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
#define MIMO_FLASH_CASE(DD) \
  case DD:                  \
    return static_cast<int>(launch_flash<DD>(x, a, st));
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
