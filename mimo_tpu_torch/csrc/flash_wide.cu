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
// What bounds it on an H100, as far as device timings can tell (no
// profiler counter was read): not the tensor cores (its tensor work alone
// would take well under half its time), and not the load latency of one
// K and one V stage: a copy with 32-key tiles in two stages, each tile
// issued a whole iteration ahead, took 1.6x the time (tools/
// time_flash_wide.py). The estimated bytes an SM receives from L2 (~19-23
// B a clock in every 64-key design timed) are no fixed ceiling either:
// that copy received the same bytes at ~60% of the rate. The time follows
// the tiles an SM works through. The lead candidates, unverified, are
// Q.K^T reading the warpgroup's Q (64 KB at d = 512) from shared memory
// again for every tile, and each warpgroup's serial chain (Q.K^T, wait,
// softmax, P.V, wait) with nothing overlapping it. A block that holds 64
// query rows and all d columns of O (the most 256 threads' registers hold
// at d = 512: 128 fp32 a thread) receives 128 KB of K and V a 64-key tile
// for 64 rows, and its two warpgroups each read all of K from shared
// memory for the same 64 rows. The design raises the rows a byte serves:
// - two blocks per 128-query tile of one (batch row, head), each holding
//   O for all 128 rows but only half of its columns (block 2i + h the
//   h-th half of the 64-column boxes, the first ceil(d/128) boxes for
//   h = 0); 256 threads, warpgroup w the rows [64w, 64w + 64), 128 fp32
//   of O a thread at d = 512. A block receives the whole K tile (64 KB)
//   but only its half of V (32 KB): 96 KB a tile for 128 rows, 3/4 of the
//   bytes a query row a key of one block over 64 rows;
// - each block computes S = Q K^T for its 128 rows over all of d (the two
//   blocks of a pair do it alike: 1.5x the attention's tensor FLOPs, for
//   which the time leaves room) and the same softmax, so both hold the
//   same P and l and nothing crosses between them; no cluster;
// - shared memory holds the Q tile (128 rows, 128 KB at d = 512), one K
//   tile (64 KB) and one V half-tile (32 KB), 224 KB, each with full /
//   empty mbarriers; thread 0 issues the TMA loads (the 4-D maps of
//   flash_attention.cu, 64-column boxes with the 128-byte swizzle), the
//   next K tile once both warpgroups have released this one, the next V
//   half-tile likewise. No producer warps and no setmaxnreg: ptxas fits
//   every thread of a block of 384 (or 288) threads into 168 registers
//   whatever setmaxnreg grants later, and a thread here needs 186;
// - Q.K^T: wgmma m64n64k16, both operands K-major from shared memory, d/16
//   steps unrolled on descriptors made opaque each tile; P.V: one wgmma
//   m64nNk16 a 16-key step with P from registers and V MN-major (the
//   transpose bit), N = 64 x the block's boxes (n256 at d = 512);
// - the warpgroup index goes through __shfl_sync, and the ragged key mask
//   is a select, so no branch the compiler cannot prove warp-uniform lies
//   between the wgmma products, which ptxas would otherwise serialize
//   (its note C7520, "WG.AR in divergent path");
// - O / l is written from registers, rows past Sq masked.
// Not here (later work): overlap of one warpgroup's softmax with the
// other's tensor work (a ping-pong), to test the serial chain; the pair
// splitting Q.K^T over d and adding the two partial S through distributed
// shared memory (each block reads half of Q and K from shared memory a
// tile); a split over keys with a fixed-order combine for grids under one
// wave (B = 1 at 6272 queries is 98 blocks on 132 SMs).

#include "flash_body.cuh"

namespace {

constexpr int kWideBQ = 128;       // query rows a block: 64 a warpgroup
constexpr int kWideBK = 64;        // keys a K / V tile
constexpr int kWideThreads = 256;  // two warpgroups

template <int D>
struct WideTile {
  static constexpr int kBoxes = D / kBoxCols;     // 64-column boxes
  static constexpr int kHalf0 = (kBoxes + 1) / 2;  // boxes of O, block 2i
  static constexpr int kHalf1 = kBoxes - kHalf0;   // block 2i + 1
  static constexpr int kQBytes = kBoxes * kWideBQ * 128;
  static constexpr int kKBytes = kBoxes * kWideBK * 128;   // a K tile
  static constexpr int kVBytes = kHalf0 * kWideBK * 128;   // a V half-tile
  // the Q, K and V tiles, 1 KB of alignment slack, 5 mbarriers
  static constexpr int kSmemBytes = 1024 + kQBytes + kKBytes + kVBytes + 5 * 8;
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
  unsigned char* q_tile = smem;  // box j: 128 rows x 128 B
  unsigned char* k_tile = smem + T::kQBytes;      // box j: 64 keys x 128 B
  unsigned char* v_tile = k_tile + T::kKBytes;    // the block's boxes of V
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_tile + T::kVBytes);
  uint64_t* k_full = q_full + 1;
  uint64_t* k_empty = q_full + 2;
  uint64_t* v_full = q_full + 3;
  uint64_t* v_empty = q_full + 4;

  const int half = blockIdx.x & 1;  // which boxes of O's columns
  const int q0 = (blockIdx.x >> 1) * kWideBQ, head = blockIdx.y, b = blockIdx.z;
  const int first = half * T::kHalf0;  // this block's boxes: [first, + mine)
  const int mine = half == 0 ? T::kHalf0 : T::kHalf1;
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

  // thread 0's loads: Q once, K tile `it` and this block's boxes of V tile
  // `it` each into its one buffer
  const int bq = a.batched & 1 ? b : 0;
  const int bk = a.batched >> 1 & 1 ? b : 0;
  const int bv = a.batched >> 2 & 1 ? b : 0;
  auto load_k = [&](int it) {
    mbar_expect_tx(k_full, T::kKBytes);
#pragma unroll
    for (int j = 0; j < T::kBoxes; ++j)
      tma_load(k_tile + j * kWideBK * 128, &map_k, j * kBoxCols, head,
               it * kWideBK, bk, k_full);
  };
  auto load_v = [&](int it) {
    mbar_expect_tx(v_full, mine * kWideBK * 128);
#pragma unroll
    for (int j = 0; j < T::kHalf0; ++j)
      if (j < mine)
        tma_load(v_tile + j * kWideBK * 128, &map_v, (first + j) * kBoxCols,
                 head, it * kWideBK, bv, v_full);
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

  // the warpgroup, read from lane 0 so the compiler knows it is the same
  // in every lane of a warp (else ptxas serializes the wgmma products)
  const int cw = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const bool leader = threadIdx.x % 128 == 0;
  const float c = a.scale_log2;
  // this warpgroup's 64 rows of every Q box
  const uint64_t dq = smem_desc(q_tile + cw * 64 * 128), dk = smem_desc(k_tile);
  const uint64_t dv = smem_desc_mn(v_tile, kWideBK * 128);

  // accumulator register 4i + 2h + e of a thread: row 16 warp + lane/4 +
  // 8h of the warpgroup's 64, column 8i + 2t + e (of the tile's keys in s,
  // of the block's mine x 64 columns of O in o)
  float s[kWideBK / 2], o[T::kHalf0 * kBoxCols / 2];
#pragma unroll
  for (int i = 0; i < T::kHalf0 * kBoxCols / 2; ++i) o[i] = 0.f;
  // the second block's accumulators where it has fewer boxes (odd d / 64)
  auto& o1 = *reinterpret_cast<float(*)[T::kHalf1 * kBoxCols / 2]>(o);
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  mbar_wait(q_full, 0);
  for (int it = 0; it < nt; ++it) {
    const uint32_t parity = it & 1;
    // S = Q K^T over this tile's 64 keys: 4 k steps a box, 32 bytes a step
    // inside it, unrolled; the descriptors are made opaque each tile, so
    // the steps add to 2 registers instead of the compiler hoisting every
    // step's pair (128 registers at d = 512) out of the tile loop
    uint64_t dqt = dq, dkt = dk;
    asm volatile("" : "+l"(dqt), "+l"(dkt));
    mbar_wait(k_full, parity);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < T::kBoxes; ++j)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<kWideBK>(s, dqt + j * (kWideBQ * 128 >> 4) + kk * 2,
                          dkt + j * (kWideBK * 128 >> 4) + kk * 2,
                          j != 0 || kk != 0);
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
    // (logit 0, not -inf) and are masked here, by a select
    const int valid = a.sk1 - it * kWideBK;
#pragma unroll
    for (int i = 0; i < kWideBK / 2; ++i)
      s[i] = (i / 4) * 8 + 2 * t + (i & 1) >= valid ? -INFINITY : s[i];
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
    for (int i = 0; i < T::kHalf0 * kBoxCols / 2; i += 4) {
      o[i] *= al0;
      o[i + 1] *= al0;
      o[i + 2] *= al1;
      o[i + 3] *= al1;
    }

    // O += P V over the block's boxes at once (B's boxes kWideBK * 128
    // bytes apart), 16 keys a step
    mbar_wait(v_full, parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWideBK / 16; ++kk) {
      const uint64_t dvk = dv + kk * (16 * 128 >> 4);
      if constexpr (T::kHalf0 == T::kHalf1)
        wgmma_rs<T::kHalf0 * kBoxCols>(o, p[kk], dvk);
      else if (half == 0)
        wgmma_rs<T::kHalf0 * kBoxCols>(o, p[kk], dvk);
      else
        wgmma_rs<T::kHalf1 * kBoxCols>(o1, p[kk], dvk);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(o);
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
  const int r0 = q0 + cw * 64 + warp * 16 + (lane >> 2), r1 = r0 + 8;
  __nv_bfloat16* og = a.o + b * a.o_bs + head * D;
#pragma unroll
  for (int j = 0; j < T::kHalf0; ++j) {
    if (j < mine) {
#pragma unroll
      for (int i = 0; i < kBoxCols / 8; ++i) {
        const int col = (first + j) * kBoxCols + i * 8 + 2 * t;
        const float* oj = o + j * kBoxCols / 2 + 4 * i;
        if (r0 < a.sq)
          *reinterpret_cast<uint32_t*>(og + r0 * a.o_ss + col) =
              pack_bf16x2(oj[0] * inv0, oj[1] * inv0);
        if (r1 < a.sq)
          *reinterpret_cast<uint32_t*>(og + r1 * a.o_ss + col) =
              pack_bf16x2(oj[2] * inv1, oj[3] * inv1);
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
  // two blocks (the two halves of O's columns) a 128-query tile
  const dim3 grid(2 * ((a.sq + kWideBQ - 1) / kWideBQ), heads, batch);
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
