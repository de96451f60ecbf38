// The GEMM tile core for Hopper (sm_90a): out = epilogue(A . W), bf16
// operands, fp32 accumulation.
//
// Replaces the TPU kernels of mimo_tpu/ops/ffn.py — _ffn_pallas_nsc/_snc
// (LN -> up-projection -> GEGLU -> down-projection -> +residual),
// _qkv_ln_pallas/_snc (LN -> one (C, 3C) GEMM), _matmul_res_pallas/_snc
// (res + x.W + b) and _matmul_pallas/_snc (x.W + b) — and the two
// projection stages of mimo_tpu/ops/temporal_attention.py
// ::temporal_attention_fused (LN + PE -> q|k|v, out-projection + bias +
// residual). gemm_kernel, the tile core, serves all of them with its
// epilogue: + bias (optional), + bias + residual, or GEGLU: a tile's kBN
// weight rows are kBN/2 value columns and the kBN/2 matching gate columns,
// and it writes h * gelu_erf(gate). Where the TPU kernel starts with a
// LayerNorm (+ PE), ops/ffn.py::gemm first runs the LN row pass of
// csrc/ln_rows.cu into a bf16 workspace, which the core then reads.
//
// Numerics follow the Pallas kernels: the product is rounded to bf16 before
// the bias; each following add and the gate multiply round to bf16; gelu is
// exact (erf) in fp32.
//
// What bounds it on an H100 (989 TFLOP/s bf16, 3.35 TB/s, each input read
// once and each output written once): the main path's products are tall
// (up to 301056 rows) and narrow (K and N from 320 to 5120). At UNet level
// 0 (K = N = 320) a product does ~160 FLOP per byte it must move, below the
// card's ~295, so the out-projection (0.115 ms bound for 385 MB), its
// residual form (0.173 ms) and LN + q|k|v (0.230 ms) are bound by bytes;
// the LN + GEGLU FFN (740 GFLOP, 0.748 ms) and every product at level 2
// (R = 19200, C = 1280: FFN 0.763 ms, q|k|v 0.191 ms, 0.064 ms for a
// (C, C) product) by tensor-core operations. The earlier core (warp-level
// m16n8k16 products from 8 warps, per-thread 16-byte async copies with a
// __syncthreads per 32-deep K tile, a block per 128 x 128 tile) reached
// 17-35% of those bounds: it was bound by instruction issue.
//
// The design:
// - wgmma.mma_async, the only path to the full tensor-core rate, on
//   128 x 160 tiles (two m64n160k16 products a 16-deep step, one group in
//   flight);
// - a producer warpgroup (one thread) keeps TMA loads
//   (cp.async.bulk.tensor) of 128 x 64 A tiles and 160 x 64 weight tiles in
//   flight through a ring of 5 stages, one full / empty mbarrier pair per
//   stage, and gives its registers to the consumers (setmaxnreg). The roles
//   split once and never meet again;
// - two consumer warpgroups in ping-pong: each takes every other tile of
//   the block, all 128 rows, so one warpgroup's epilogue runs while the
//   other's products do (at level 0, K = 320 gives a tile only 5 stages of
//   products, and the epilogue is as long). A turn barrier pair orders
//   their products;
// - both operands K-major with the 128-byte swizzle (64 bf16 = one swizzle
//   span per row). The weight is read from a copy prepared once per
//   parameter by ops/ffn.py: transposed to (N, K), zero-padded to whole
//   tiles and, for GEGLU, with each tile's value and gate columns side by
//   side, so one TMA box brings both and one thread holds a value column
//   and its gate column in its accumulators;
// - one tile width, kBN = 160: every N of the main path is a multiple
//   (N = 320 is 2 tiles, GEGLU's 1280 value columns 16 tiles of 80), so no
//   tile is padding there; other N pad their last tile;
// - a persistent grid, one block per SM, walks the tiles with the tiles of
//   one row tile next to each other (A comes from HBM about once); the ring
//   runs across tiles, so the next tile's loads overlap this one's epilogue;
// - the epilogue rounds the accumulators, adds the bias (read into shared
//   memory before the tile's products) or applies GEGLU, stages 64 rows at
//   a time in shared memory and writes them (adding the residual) in
//   16-byte vectors, a warp's stores side by side;
// - ragged edges: TMA zero-fills loads past M and K; the epilogue masks
//   rows past M and columns past N.
//
// On an H100 (700 W) this reaches 49-62% of the bound at level 2 and
// 34-68% at level 0, where the epilogue still adds to the loads' time
// instead of hiding behind them (PERF.md, Findings).
//
// The LN prologue is its own pass (one read of A, one write of the
// normalised rows) and not a step inside the tile core: done in the core,
// every column block would normalise its A tiles again (8 to 80 times over
// on the main path's N).

#include "hopper.cuh"

namespace {

constexpr int kBM = 128;             // rows of a tile
constexpr int kBN = 160;             // weight rows of a tile: the wgmma N
constexpr int kBK = 64;              // K depth of a stage: 128 bytes of bf16
constexpr int kThreads = 384;        // producer + two consumer warpgroups
constexpr int kABytes = kBM * kBK * 2;
constexpr int kBBytes = kBN * kBK * 2;
// per consumer warpgroup: a staged (64, kBN + 8) bf16 output block and its
// tile's kBN bias values
constexpr int kStagingBytes = 2 * (64 * (kBN + 8) + kBN) * 2;
// the ring (a stage: an A and a weight tile and their full / empty
// mbarriers) as deep as 227 KB of dynamic shared memory holds beside the
// two turn mbarriers, the staging and 1 KB of alignment slack
constexpr int kSmemLimit = 232448;
constexpr int kStages =
    (kSmemLimit - 16 - kStagingBytes - 1024) / (kABytes + kBBytes + 16);
constexpr int kSmemBytes =
    kStages * (kABytes + kBBytes + 16) + 16 + kStagingBytes + 1024;
static_assert(kStages >= 2 && kSmemBytes <= kSmemLimit,
              "the ring must be at least double-buffered within 227 KB");

enum Epilogue { kEpiBias = 0, kEpiBiasRes = 1, kEpiGeglu = 2 };

struct EpiArgs {
  const __nv_bfloat16* bias;
  const __nv_bfloat16* res;
  __nv_bfloat16* out;
  long long ldr, ldo;
  int m, n, k;      // output rows, output (value) columns, depth
  int col_tiles;    // tiles across N
  int tiles;        // row tiles x col_tiles
  int epilogue;
};

__device__ __forceinline__ float bf(float x) {  // round to bf16 and back
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float2 ld_bf2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void st_bf2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

__device__ __forceinline__ float geglu(float h, float g, float bh, float bg) {
  const float up_h = bf(bf(h) + bh);
  const float up_g = bf(bf(g) + bg);
  return up_h * bf(0.5f * up_g * (1.f + erff(up_g * 0.7071067811865476f)));
}

__device__ __forceinline__ void unpack8(const uint4& v, float (&f)[8]) {
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
  for (int e = 0; e < 8; ++e) f[e] = __bfloat162float(h[e]);
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  uint4 v;
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
  for (int e = 0; e < 8; ++e) h[e] = __float2bfloat16_rn(f[e]);
  return v;
}

__device__ __forceinline__ void consumer_sync(int cw) {  // one warpgroup
  asm volatile("bar.sync %0, 128;\n" :: "r"(cw + 1) : "memory");
}

// Copy a staged (64, W) bf16 block (row stride S) to out rows row0 ..,
// columns n0 .., 16 bytes a thread and a warp's stores side by side; for
// kEpiBiasRes add the residual, read in the same pattern with every load
// issued before the first store
template <int W, int S>
__device__ __forceinline__ void copy_out(const EpiArgs& e,
                                         const __nv_bfloat16* st, int row0,
                                         int n0) {
  constexpr int kVecs = W / 8, kPer = 64 * kVecs / 128;
  const int tid = threadIdx.x & 127;
  const bool res = e.epilogue == kEpiBiasRes;
  uint4 rv[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int v = tid + 128 * j;
    const int r = row0 + v / kVecs, c = n0 + v % kVecs * 8;
    rv[j] = make_uint4(0, 0, 0, 0);
    if (res && r < e.m && c < e.n)
      rv[j] = __ldg(reinterpret_cast<const uint4*>(e.res + r * e.ldr + c));
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int v = tid + 128 * j, rl = v / kVecs, cl = v % kVecs * 8;
    const int r = row0 + rl, c = n0 + cl;
    if (r >= e.m || c >= e.n) continue;
    uint4 y = *reinterpret_cast<const uint4*>(st + rl * S + cl);
    if (res) {
      float f[8], q[8];
      unpack8(y, f);
      unpack8(rv[j], q);
#pragma unroll
      for (int i = 0; i < 8; ++i) f[i] += q[i];
      y = pack8(f);
    }
    *reinterpret_cast<uint4*>(e.out + r * e.ldo + c) = y;
  }
}

// The bias of tile col_tile into sb (kBN values, 0 past N or without bias;
// GEGLU: the kBN/2 value columns' bias, then their gate columns'), one
// pair a thread. Run before the warpgroup's turn at the tensor cores, so
// the loads wait while the other warpgroup's products run.
__device__ __forceinline__ void load_bias(const EpiArgs& e, int col_tile,
                                          __nv_bfloat16* sb) {
  const int p = threadIdx.x & 127;
  if (p >= kBN / 2) return;
  const bool geglu = e.epilogue == kEpiGeglu, gate = geglu && p >= kBN / 4;
  const int c =
      col_tile * (geglu ? kBN / 2 : kBN) + 2 * p - (gate ? kBN / 2 : 0);
  uint32_t v = 0;
  if (e.bias != nullptr && c < e.n)
    v = __ldg(reinterpret_cast<const unsigned int*>(e.bias + (gate ? e.n : 0) +
                                                    c));
  reinterpret_cast<uint32_t*>(sb)[p] = v;
}

// The epilogue of 64 rows (row0 ..) of consumer cw's tile: bias or GEGLU
// in registers, the bf16 result staged in shared memory (rows of kBN + 8
// values: the pad keeps these writes free of bank conflicts), then
// copy_out. Accumulator register 4i + 2h + j of a thread holds row
// 16 warp + lane/4 + 8h, column 8i + 2 (lane % 4) + j of the 64 rows.
__device__ __forceinline__ void epilogue(const EpiArgs& e,
                                         float (&acc)[kBN / 2],
                                         const __nv_bfloat16* sb,
                                         __nv_bfloat16* st, int row0,
                                         int col_tile, int cw) {
  constexpr int S = kBN + 8;
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int rl = warp * 16 + (lane >> 2), c_in = (lane & 3) * 2;
  consumer_sync(cw);  // the last copy_out is done with `st`
  if (e.epilogue == kEpiGeglu) {
    constexpr int kHalf = kBN / 2;
    const int n0 = col_tile * kHalf;
#pragma unroll
    for (int i = 0; i < kHalf / 8; ++i) {
      const int cl = i * 8 + c_in, c = n0 + cl;
      if (c >= e.n) continue;
      const float2 bh = ld_bf2(sb + cl), bg = ld_bf2(sb + kHalf + cl);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // value column c and its gate column sit kHalf / 8 groups apart
        const int vi = 4 * i + 2 * h, gi = 4 * (i + kHalf / 8) + 2 * h;
        st_bf2(st + (rl + 8 * h) * S + cl, geglu(acc[vi], acc[gi], bh.x, bg.x),
               geglu(acc[vi + 1], acc[gi + 1], bh.y, bg.y));
      }
    }
    consumer_sync(cw);
    copy_out<kHalf, S>(e, st, row0, n0);
    return;
  }
  const int n0 = col_tile * kBN;
#pragma unroll
  for (int i = 0; i < kBN / 8; ++i) {
    const int cl = i * 8 + c_in, c = n0 + cl;
    if (c >= e.n) continue;
    const float2 b = ld_bf2(sb + cl);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // the product rounded to bf16, then + bias rounded (copy_out adds
      // the residual)
      float y0 = bf(acc[4 * i + 2 * h]), y1 = bf(acc[4 * i + 2 * h + 1]);
      if (e.bias != nullptr) {
        y0 = bf(y0 + b.x);
        y1 = bf(y1 + b.y);
      }
      st_bf2(st + (rl + 8 * h) * S + cl, y0, y1);
    }
  }
  consumer_sync(cw);
  copy_out<kBN, S>(e, st, row0, n0);
}

__global__ void __launch_bounds__(kThreads, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                const __grid_constant__ CUtensorMap map_b, const EpiArgs e) {
  extern __shared__ unsigned char smem_raw[];
  // the swizzle atoms need 1024-byte alignment (the launch asks 1 KB more)
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* a_ring = smem;
  unsigned char* b_ring = smem + kStages * kABytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(b_ring + kStages * kBBytes);
  uint64_t* empty = full + kStages;
  uint64_t* turn = empty + kStages;  // turn[cw]: the other's products done
  __nv_bfloat16* staging = reinterpret_cast<__nv_bfloat16*>(turn + 2);
  const int kt_count = (e.k + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);   // the producer's expect_tx arrival
      mbar_init(&empty[s], 1);  // the consuming warpgroup's release
    }
    mbar_init(&turn[0], 1);
    mbar_init(&turn[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer warpgroup: one thread issues every load of the block, k
    // step by k step through the block's tiles
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < e.tiles; t += gridDim.x) {
        const int row0 = t / e.col_tiles * kBM;
        const int col0 = t % e.col_tiles * kBN;
        for (int kt = 0; kt < kt_count; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);  // passes at once on lap 0
          mbar_expect_tx(&full[stage], kABytes + kBBytes);
          tma_load(a_ring + stage * kABytes, &map_a, kt * kBK, row0,
                   &full[stage]);
          tma_load(b_ring + stage * kBBytes, &map_b, kt * kBK, col0,
                   &full[stage]);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // consumer warpgroups, ping-pong: cw takes the block's tiles j = cw,
    // cw + 2, ..., all 128 rows of each (two m64 products a k step), so one
    // warpgroup's epilogue runs while the other's products do. They take
    // turns: a tile's products start once the other warpgroup has passed
    // every wait of its previous tile, so each full barrier a warpgroup
    // waits on is at most one phase ahead (a parity wait cannot tell two)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = threadIdx.x / 128 - 1;
    const bool leader = threadIdx.x % 128 == 0;
    __nv_bfloat16* st = staging + cw * 64 * (kBN + 8);
    __nv_bfloat16* sb = staging + 2 * 64 * (kBN + 8) + cw * kBN;
    for (int j = cw, t = blockIdx.x + cw * gridDim.x; t < e.tiles;
         j += 2, t += 2 * gridDim.x) {
      const int row0 = t / e.col_tiles * kBM, col_tile = t % e.col_tiles;
      load_bias(e, col_tile, sb);
      if (j > 0) mbar_wait(&turn[cw], ((j - 1) >> 1) & 1);
      // set per tile, so the registers are free during the epilogue (the
      // first product overwrites them: scale_d = 0)
      float acc0[kBN / 2], acc1[kBN / 2];
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) acc0[i] = acc1[i] = 0.f;
      int prev = -1;
      for (int kt = 0, g = j * kt_count; kt < kt_count; ++kt, ++g) {
        // k step g of the block's sequence sits in stage g % kStages, on
        // that stage's (g / kStages)-th use
        const int stage = g % kStages;
        mbar_wait(&full[stage], (g / kStages) & 1);
        const uint64_t da = smem_desc(a_ring + stage * kABytes);
        const uint64_t db = smem_desc(b_ring + stage * kBBytes);
        fence_acc(acc0);
        fence_acc(acc1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          // rows 64 .. 127 start 8 KB (512 in 16-byte units) further on
          wgmma_ss<kBN>(acc0, da + 2 * kk, db + 2 * kk, (kt | kk) != 0);
          wgmma_ss<kBN>(acc1, da + 512 + 2 * kk, db + 2 * kk, (kt | kk) != 0);
        }
        wgmma_commit();
        // the previous stage's products are done: hand its buffers back
        wgmma_wait<1>();
        fence_acc(acc0);
        fence_acc(acc1);
        if (prev >= 0 && leader) mbar_arrive(&empty[prev]);
        prev = stage;
      }
      if (leader) mbar_arrive(&turn[cw ^ 1]);
      wgmma_wait<0>();
      fence_acc(acc0);
      fence_acc(acc1);
      if (leader) mbar_arrive(&empty[prev]);
      epilogue(e, acc0, sb, st, row0, col_tile, cw);
      epilogue(e, acc1, sb, st, row0 + 64, col_tile, cw);
    }
  }
}

// TMA map of a row-major bf16 (rows, cols) matrix with row stride ld,
// read in (box_rows, 64) boxes with the 128-byte swizzle; loads past the
// edges are zero-filled
bool make_map(CUtensorMap* map, const void* base, long long rows,
              long long cols, long long ld, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 2};
  const cuuint32_t box[2] = {kBK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int launch(const CUtensorMap& map_a, const CUtensorMap& map_b,
           const EpiArgs& e, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = e.tiles < sms ? e.tiles : sms;
  gemm_kernel<<<grid, kThreads, kSmemBytes, st>>>(map_a, map_b, e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out (m, n) = epilogue(a (m, k) . W). Returns a cudaError_t code (0 on
// success).
//
// w is the weight as ops/ffn.py::prepare_weight lays it out: (col_tiles *
// 160, k) bf16, row-major, with col_tiles = ceil(n / 160), or
// ceil(n / 80) for GEGLU, whose tile j holds value columns 80 j .. and then
// the matching gate columns.
//
// epilogue: 0 = + bias (bias may be nullptr), 1 = + bias + res, 2 = GEGLU,
// with bias (2n,) in the unprepared [value | gate] order.
int mimo_gemm_fwd(const void* a, long long lda, const void* w,
                  const void* bias, const void* res, long long ldr,
                  void* out, long long ldo, int m, int n, int k, int epilogue,
                  void* stream) {
  if (m < 1 || n < 1 || k < 1 || n % 8 || k % 8 || lda % 8 || ldo % 8 ||
      ldr % 8 || epilogue < 0 || epilogue > 2 ||
      (epilogue == kEpiGeglu && bias == nullptr) ||
      (epilogue == kEpiBiasRes && res == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tile_cols = epilogue == kEpiGeglu ? kBN / 2 : kBN;
  EpiArgs e;
  e.bias = static_cast<const __nv_bfloat16*>(bias);
  e.res = static_cast<const __nv_bfloat16*>(res);
  e.out = static_cast<__nv_bfloat16*>(out);
  e.ldr = ldr;
  e.ldo = ldo;
  e.m = m;
  e.n = n;
  e.k = k;
  e.col_tiles = (n + tile_cols - 1) / tile_cols;
  e.tiles = (m + kBM - 1) / kBM * e.col_tiles;
  e.epilogue = epilogue;
  CUtensorMap map_a, map_b;
  if (!make_map(&map_a, a, m, k, lda, kBM) ||
      !make_map(&map_b, w, (long long)e.col_tiles * kBN, k, k, kBN))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(map_a, map_b, e, st);
}

}  // extern "C"
