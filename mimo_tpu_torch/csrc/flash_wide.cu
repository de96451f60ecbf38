// Flash attention forward for wide heads (d % 64 == 0, 160 < d <= 512) on
// Hopper (sm_90a): bf16 in, bf16 out, fp32 logits, softmax state and
// accumulation.
//
// Replaces the TPU kernel mimo_tpu/ops/attention.py::flash_sdpa (JAX's
// bundled Pallas flash attention, jax.experimental.pallas.ops.tpu
// .flash_attention, forward), which the JAX package's dispatch_sdpa takes
// for Sq >= 1024 at head widths the transposed kernels do not take. On the
// main path that is the VAE's mid-block attention: one head of d = 512 over
// every latent token (6272 at 512x784, 9604 at edit's 784x784, 1024 at
// 256x256), 7 calls a 24-frame generation.
//
// Why not flash_attention.cu's body: a consumer warpgroup there holds its 64
// query rows x d of O in fp32, 256 registers a thread at d = 512, over the
// 255-register limit (flash_body.cuh asserts d <= 160).
//
// Layout and numerics as flash_attention.cu: q, k, v, o are (B, S, H*d)
// with any batch and sequence stride (last dim contiguous), head h the
// column slice [h*d, (h+1)*d); exact softmax with a running max of the raw
// logits, p = exp2(s*c - m*c) with c = log2(e)/sqrt(d); P rounded to bf16
// only as the operand of P.V, the row sum over the fp32 P. Ragged Sq and Sk
// are masked here (TMA zero-fills rows past S; keys past Sk get -inf, rows
// past Sq are not stored): no 128-padding, no segment ids. One block writes
// its rows alone in a fixed order of summation: deterministic.
//
// What bounds it on an H100: 4 d FLOPs of tensor-core work a logit (at
// d = 512 the exp2 a logit is ~1/60 of it), so the tensor cores. The design
// (a simple first kernel; speed is later work):
// - one block per (batch row, head, 64-query tile), 256 threads: two
//   warpgroups over the SAME 64 query rows; thread 0 also issues every TMA
//   load (the 4-D maps of flash_attention.cu, 64-column boxes with the
//   128-byte swizzle), each tile's as soon as both warpgroups have released
//   the last one. No producer warps and no setmaxnreg: ptxas fits every
//   thread of a block of 384 (or 288) threads into 168 registers whatever
//   setmaxnreg grants later, and a thread here needs ~200 (spills there);
//   256 threads get up to 255;
// - shared memory holds the Q tile (64 KB at d = 512) and one K and one V
//   tile of 64 keys (64 KB each), 192 KB in all; K and V have their own
//   full / empty mbarriers, so the next K tile loads during this tile's
//   softmax and P.V, and the next V tile during the next Q.K^T;
// - each warpgroup computes the whole 64 x 64 S = Q.K^T
//   (wgmma m64n64k16, both operands K-major from shared memory, d/16 steps)
//   and the same softmax on it, so both hold the same P in registers and
//   nothing is exchanged between them; the cost is Q.K^T done twice (1.5x
//   the FLOPs of the attention);
// - O's d columns are split between the two: warpgroup 0 holds the first
//   ceil(d/128) boxes of 64 columns, warpgroup 1 the rest (at d = 512,
//   4 x 32 = 128 fp32 registers a thread); P.V is wgmma m64n64k16 a box
//   with P from registers and V MN-major from shared memory (the transpose
//   bit);
// - O / l is written from registers, rows past Sq masked.
// Not here (later work): a second K/V stage (the 227 KB are spent), Q.K^T
// split between the warpgroups with P shared through shared memory, or a
// split over keys for grids under one wave (B = 1 at 6272 queries is 98
// blocks on 132 SMs).

#include "flash_body.cuh"

namespace {

constexpr int kWideBQ = 64;  // query rows a block, shared by both warpgroups
constexpr int kWideBK = 64;  // keys a K / V tile
constexpr int kWideThreads = 256;  // two warpgroups

template <int D>
struct WideTile {
  static constexpr int kBoxes = D / kBoxCols;     // 64-column boxes
  static constexpr int kMine = (kBoxes + 1) / 2;  // boxes of O in warpgroup 0
  static constexpr int kQBytes = kBoxes * kWideBQ * 128;
  static constexpr int kKVBytes = kBoxes * kWideBK * 128;  // one K or V tile
  // the Q, K and V tiles, 1 KB of alignment slack, 5 mbarriers
  static constexpr int kSmemBytes = 1024 + kQBytes + 2 * kKVBytes + 5 * 8;
  static_assert(D % 64 == 0 && D > 160 && D <= 512,
                "d % 64 == 0, 160 < d <= 512");
  static_assert(kSmemBytes <= kSmemLimit, "the tiles must fit 227 KB");
};

template <int D>
__global__ void __launch_bounds__(kWideThreads, 1)
    flash_wide_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v,
                      const FlashArgs a) {
  using T = WideTile<D>;
  extern __shared__ unsigned char smem_raw[];
  // the swizzle atoms need 1024-byte alignment (the launch asks 1 KB more)
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* q_tile = smem;  // box j: 64 rows x 128 B
  unsigned char* k_tile = smem + T::kQBytes;
  unsigned char* v_tile = k_tile + T::kKVBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_tile + T::kKVBytes);
  uint64_t* k_full = q_full + 1;
  uint64_t* k_empty = q_full + 2;
  uint64_t* v_full = q_full + 3;
  uint64_t* v_empty = q_full + 4;

  const int q0 = blockIdx.x * kWideBQ, head = blockIdx.y, b = blockIdx.z;
  const int nt = (a.sk1 + kWideBK - 1) / kWideBK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);   // thread 0's expect_tx arrivals
    mbar_init(k_full, 1);
    mbar_init(v_full, 1);
    mbar_init(k_empty, 2);  // one release from each warpgroup
    mbar_init(v_empty, 2);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0's loads: Q once, K and V tile `it` each into its one buffer
  const int bq = a.batched & 1 ? b : 0;
  const int bk = a.batched >> 1 & 1 ? b : 0;
  const int bv = a.batched >> 2 & 1 ? b : 0;
  auto load_k = [&](int it) {
    mbar_expect_tx(k_full, T::kKVBytes);
#pragma unroll
    for (int j = 0; j < T::kBoxes; ++j)
      tma_load(k_tile + j * kWideBK * 128, &map_k, j * kBoxCols, head,
               it * kWideBK, bk, k_full);
  };
  auto load_v = [&](int it) {
    mbar_expect_tx(v_full, T::kKVBytes);
#pragma unroll
    for (int j = 0; j < T::kBoxes; ++j)
      tma_load(v_tile + j * kWideBK * 128, &map_v, j * kBoxCols, head,
               it * kWideBK, bv, v_full);
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(q_full, T::kQBytes);
#pragma unroll
    for (int j = 0; j < T::kBoxes; ++j)
      tma_load(q_tile + j * kWideBQ * 128, &map_q, j * kBoxCols, head, q0, bq,
               q_full);
    load_k(0);
    load_v(0);
  }

  {
    const int cw = threadIdx.x / 128;
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int t = lane & 3;
    const bool leader = threadIdx.x % 128 == 0;
    const float c = a.scale_log2;
    // this warpgroup's boxes of O: [first, first + mine)
    const int first = cw * T::kMine;
    const int mine = cw == 0 ? T::kMine : T::kBoxes - T::kMine;
    const uint64_t dq = smem_desc(q_tile), dk = smem_desc(k_tile);

    // accumulator register 4i + 2h + e of a thread: row 16 warp + lane/4 +
    // 8h of the 64, column 8i + 2t + e (of the tile's keys in s, of box j's
    // 64 columns in o[j])
    float s[kWideBK / 2], o[T::kMine][kBoxCols / 2];
#pragma unroll
    for (int j = 0; j < T::kMine; ++j)
#pragma unroll
      for (int i = 0; i < kBoxCols / 2; ++i) o[j][i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

    mbar_wait(q_full, 0);
    for (int it = 0; it < nt; ++it) {
      const uint32_t parity = it & 1;
      // S = Q K^T over this tile's 64 keys: 4 k steps a box, 32 bytes a
      // step inside it. The loop over boxes stays rolled: unrolled, the
      // compiler may hoist every step's descriptor pair out of the tile
      // loop (64 pairs, 128 registers, at d = 512).
      mbar_wait(k_full, parity);
      wgmma_fence();
#pragma unroll 1
      for (int j = 0; j < T::kBoxes; ++j) {
        const uint64_t dqj = dq + j * (kWideBQ * 128 >> 4);
        const uint64_t dkj = dk + j * (kWideBK * 128 >> 4);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<kWideBK>(s, dqj + kk * 2, dkj + kk * 2, j != 0 || kk != 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(s);
      if (leader) mbar_arrive(k_empty);
      if (threadIdx.x == 0 && it + 1 < nt) {
        // the next K tile, once both warpgroups are done with this one
        mbar_wait(k_empty, parity);
        load_k(it + 1);
      }
      __syncwarp();

      // the last tile may be ragged: its keys past Sk were zero-filled
      // (logit 0, not -inf) and are masked here
      const int valid = a.sk1 - it * kWideBK;
      if (valid < kWideBK) {
#pragma unroll
        for (int i = 0; i < kWideBK / 2; ++i)
          if ((i / 4) * 8 + 2 * t + (i & 1) >= valid) s[i] = -INFINITY;
      }
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int i = 0; i < kWideBK / 2; i += 4) {
        mx0 = fmaxf(mx0, fmaxf(s[i], s[i + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[i + 2], s[i + 3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      // every tile holds >= 1 valid key, so the new max is finite
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float al0 = ex2((m0 - mn0) * c), al1 = ex2((m1 - mn1) * c);
      m0 = mn0;
      m1 = mn1;
      const float b0 = -mn0 * c, b1 = -mn1 * c;
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int i = 0; i < kWideBK / 2; i += 4) {
        s[i] = ex2(fmaf(s[i], c, b0));
        s[i + 1] = ex2(fmaf(s[i + 1], c, b0));
        s[i + 2] = ex2(fmaf(s[i + 2], c, b1));
        s[i + 3] = ex2(fmaf(s[i + 3], c, b1));
        rs0 += s[i] + s[i + 1];
        rs1 += s[i + 2] + s[i + 3];
      }
      l0 = l0 * al0 + rs0;  // per-thread partial sums; quad sums at the end
      l1 = l1 * al1 + rs1;
      uint32_t p[kWideBK / 16][4];
#pragma unroll
      for (int kk = 0; kk < kWideBK / 16; ++kk) {
        p[kk][0] = pack_bf16x2(s[8 * kk], s[8 * kk + 1]);
        p[kk][1] = pack_bf16x2(s[8 * kk + 2], s[8 * kk + 3]);
        p[kk][2] = pack_bf16x2(s[8 * kk + 4], s[8 * kk + 5]);
        p[kk][3] = pack_bf16x2(s[8 * kk + 6], s[8 * kk + 7]);
      }
#pragma unroll
      for (int j = 0; j < T::kMine; ++j)
#pragma unroll
        for (int i = 0; i < kBoxCols / 2; i += 4) {
          o[j][i] *= al0;
          o[j][i + 1] *= al0;
          o[j][i + 2] *= al1;
          o[j][i + 3] *= al1;
        }

      // O += P V over this warpgroup's boxes, 16 keys a step
      mbar_wait(v_full, parity);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < T::kMine; ++j) {
        if (j < mine) {
          const uint64_t dv =
              smem_desc_mn(v_tile + (first + j) * kWideBK * 128,
                           kWideBK * 128);
#pragma unroll
          for (int kk = 0; kk < kWideBK / 16; ++kk)
            wgmma_rs<kBoxCols>(o[j], p[kk], dv + kk * (16 * 128 >> 4));
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < T::kMine; ++j) fence_acc(o[j]);
      if (leader) mbar_arrive(v_empty);
      if (threadIdx.x == 0 && it + 1 < nt) {
        mbar_wait(v_empty, parity);
        load_v(it + 1);
      }
      __syncwarp();
    }

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    const int r0 = q0 + warp * 16 + (lane >> 2), r1 = r0 + 8;
    __nv_bfloat16* og = a.o + b * a.o_bs + head * D;
#pragma unroll
    for (int j = 0; j < T::kMine; ++j) {
      if (j < mine) {
#pragma unroll
        for (int i = 0; i < kBoxCols / 8; ++i) {
          const int col = (first + j) * kBoxCols + i * 8 + 2 * t;
          if (r0 < a.sq)
            *reinterpret_cast<uint32_t*>(og + r0 * a.o_ss + col) =
                pack_bf16x2(o[j][4 * i] * inv0, o[j][4 * i + 1] * inv0);
          if (r1 < a.sq)
            *reinterpret_cast<uint32_t*>(og + r1 * a.o_ss + col) =
                pack_bf16x2(o[j][4 * i + 2] * inv1, o[j][4 * i + 3] * inv1);
        }
      }
    }
  }
}

template <int D>
cudaError_t launch_wide(const void* q, const void* k, const void* v,
                        int batch, int heads, long long q_bs, long long q_ss,
                        long long k_bs, long long k_ss, long long v_bs,
                        long long v_ss, FlashArgs a, cudaStream_t stream) {
  using T = WideTile<D>;
  const long long bs[3] = {q_bs, k_bs, v_bs};
  a.batched = 0;
  for (int i = 0; i < 3; ++i)
    if (batch > 1 && bs[i] != 0) a.batched |= 1 << i;
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, D, heads, a.sq, q_ss, batch, q_bs, a.batched & 1,
                kWideBQ) ||
      !make_map(&mk, k, D, heads, a.sk1, k_ss, batch, k_bs,
                a.batched >> 1 & 1, kWideBK) ||
      !make_map(&mv, v, D, heads, a.sk1, v_ss, batch, v_bs,
                a.batched >> 2 & 1, kWideBK))
    return cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_wide_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::kSmemBytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.sq + kWideBQ - 1) / kWideBQ, heads, batch);
  flash_wide_kernel<D><<<grid, kWideThreads, T::kSmemBytes, stream>>>(
      mq, mk, mv, a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t code (0 on success). Every operand needs a 16-byte
// aligned start and batch / sequence strides that are multiples of 8
// elements (the TMA maps' rules); d one of 192, 256, ..., 512.
int mimo_flash_wide_fwd(const void* q, const void* k, const void* v, void* o,
                        int batch, int heads, int d, int sq, int sk,
                        long long q_bs, long long q_ss, long long k_bs,
                        long long k_ss, long long v_bs, long long v_ss,
                        long long o_bs, long long o_ss, float scale_log2,
                        void* stream) {
  if (sq < 1 || sk < 1 || batch < 1 || heads < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  FlashArgs a;
  a.o = static_cast<__nv_bfloat16*>(o);
  a.o_bs = o_bs;
  a.o_ss = o_ss;
  a.sq = sq;
  a.sk1 = sk;
  a.sk2 = 0;
  a.scale_log2 = scale_log2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
#define MIMO_WIDE_CASE(DD)                                                   \
  case DD:                                                                   \
    return static_cast<int>(launch_wide<DD>(q, k, v, batch, heads, q_bs,     \
                                            q_ss, k_bs, k_ss, v_bs, v_ss, a, \
                                            st));
    MIMO_WIDE_CASE(192) MIMO_WIDE_CASE(256) MIMO_WIDE_CASE(320)
    MIMO_WIDE_CASE(384) MIMO_WIDE_CASE(448) MIMO_WIDE_CASE(512)
#undef MIMO_WIDE_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
