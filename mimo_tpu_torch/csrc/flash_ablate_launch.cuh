// Launch of the flash ablation builds (the flash body of flash_body.cuh at
// an ablation mode and a layout), shared by the per-width, per-layout
// sources flash_ablate_{40,40t,80,80t}.cu, so that each nvcc of the build
// compiles 9 of the 36 instantiations; flash_ablate.cu holds the C entry.

#pragma once

#include "flash_body.cuh"

// One call of mimo_flash_ablate_fwd: q, k, v are (B, S, H*d) with `_ss` the
// sequence stride, or (B, H*d, S) with `_ss` the channel stride when
// pretransposed; o is (B, Sq, H*d) in either layout.
struct AblateCall {
  int mode;
  const void *q, *k, *v;
  void* o;
  int batch, heads, sq, sk;
  long long q_bs, q_ss, k_bs, k_ss, v_bs, v_ss, o_bs, o_ss;
  float scale_log2;
  cudaStream_t stream;
};

// the four builds: d = 40 / 80, natural / pretransposed (`t`)
cudaError_t flash_ablate_40(const AblateCall& c);
cudaError_t flash_ablate_40t(const AblateCall& c);
cudaError_t flash_ablate_80(const AblateCall& c);
cudaError_t flash_ablate_80t(const AblateCall& c);

namespace {

template <int D, int MODE, bool PRE>
__global__ void __launch_bounds__(kThreads, 1)
    flash_ablate_kernel(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v,
                        const FlashArgs a) {
  // one key segment: the bank maps are never read (sk2 == 0)
  flash_body<D, MODE, PRE>(map_q, map_k, map_v, map_k, map_v, a);
}

// TMA map of the pretransposed (B, H*d, S) bf16 operand at base as 4-D
// (S, d, H, B), channel stride cs, read in (64, ceil(d/16)*16, 1, 1) boxes
// with the 128-byte swizzle: a box row is 64 positions of one channel, and
// the rows past d and the positions past S are zero-filled.
inline bool make_map_t(CUtensorMap* map, const void* base, int d, int heads, int s,
                long long cs, int batch, long long bs, bool batched) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {
      static_cast<cuuint64_t>(s), static_cast<cuuint64_t>(d),
      static_cast<cuuint64_t>(heads),
      static_cast<cuuint64_t>(batched ? batch : 1)};
  // the batch stride of a one-row map is never used: any legal value
  const long long bstride = batched ? bs : cs * d * heads + 8;
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(cs) * 2,
                                 static_cast<cuuint64_t>(cs) * d * 2,
                                 static_cast<cuuint64_t>(bstride) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>((d + 15) / 16 * 16),
                             1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, int MODE, bool PRE>
cudaError_t launch_ablate(const AblateCall& c) {
  using T = FlashTile<D, PRE>;
  FlashArgs a;
  a.o = static_cast<__nv_bfloat16*>(c.o);
  a.o_bs = c.o_bs;
  a.o_ss = c.o_ss;
  a.sq = c.sq;
  a.sk1 = c.sk;
  a.sk2 = 0;
  a.scale_log2 = c.scale_log2;
  const long long bs[3] = {c.q_bs, c.k_bs, c.v_bs};
  a.batched = 0;
  for (int i = 0; i < 3; ++i)
    if (c.batch > 1 && bs[i] != 0) a.batched |= 1 << i;
  auto batched = [&](int i) { return (a.batched >> i & 1) != 0; };
  CUtensorMap mq, mk, mv;
  bool ok;
  if constexpr (PRE)
    ok = make_map_t(&mq, c.q, D, c.heads, c.sq, c.q_ss, c.batch, c.q_bs,
                    batched(0)) &&
         make_map_t(&mk, c.k, D, c.heads, c.sk, c.k_ss, c.batch, c.k_bs,
                    batched(1)) &&
         make_map_t(&mv, c.v, D, c.heads, c.sk, c.v_ss, c.batch, c.v_bs,
                    batched(2));
  else
    ok = make_map(&mq, c.q, D, c.heads, c.sq, c.q_ss, c.batch, c.q_bs,
                  batched(0), kBlockQ) &&
         make_map(&mk, c.k, D, c.heads, c.sk, c.k_ss, c.batch, c.k_bs,
                  batched(1), T::kBK) &&
         make_map(&mv, c.v, D, c.heads, c.sk, c.v_ss, c.batch, c.v_bs,
                  batched(2), T::kBK);
  if (!ok) return cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_ablate_kernel<D, MODE, PRE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((c.sq + kBlockQ - 1) / kBlockQ, c.heads, c.batch);
  flash_ablate_kernel<D, MODE, PRE><<<grid, kThreads, T::kSmemBytes,
                                      c.stream>>>(mq, mk, mv, a);
  return cudaGetLastError();
}

template <int D, bool PRE>
cudaError_t launch_modes(const AblateCall& c) {
  switch (c.mode) {
#define MIMO_ABLATE_CASE(M) \
  case M:                   \
    return launch_ablate<D, M, PRE>(c);
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
