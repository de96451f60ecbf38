// The body of the flash attention forward kernel for Hopper (sm_90a), the
// one flash design of the repo: the production kernel (flash_attention.cu,
// flash_fwd_kernel<D> = flash_body<D, kFull, false>) and the ablation
// builds of the flash-ablation tool (flash_ablate*.cu) are instantiations
// of it. flash_attention.cu states the design and what bounds it.
//
// The body is a template over an ablation mode and a layout. <D, kFull,
// false> is the production kernel; every other mode removes one piece of
// its work at compile time and keeps the rest, data dependencies included
// (`if constexpr` throughout, so the production instantiation compiles to
// the instructions it had before the modes existed; tools/compare_sass.py):
//   kFull     the production math
//   kNoExp    no MUFU ex2 per logit: p = max(x c - m c, -16) + 16, with the
//             FFMA, the running max and the rescale kept
//   kNoSm     no scale, mask, max, shuffle, rescale or ex2: p = |s| + 1 of
//             the raw product (the zero-filled keys past a ragged edge weigh
//             1 and carry v = 0)
//   kNoPV     no P.V wgmma: o register j adds s register j, the logit of
//             key (column of o register j) of the same row, which the same
//             thread holds (V tiles still loaded)
//   kNoQK     no Q.K^T wgmma: s = q[row][0] k[key][0] - 8, read from the
//             swizzled tiles
//   kNoMXU    kNoQK and kNoPV: no tensor-core work (a named barrier of the
//             warpgroup a tile stands in for the wgmma's convergence before
//             the stage is released)
//   kNoShift  no running max, shuffles or rescale: p = exp2(x c - 8)
//   kChunk2/4 the tile's Q.K^T issued as 2 / 4 wgmma groups (n64 / n32);
//             the softmax of sub-chunk c runs while the groups after it
//             (and the P.V of c - 1) are in flight; the online softmax is
//             updated per sub-chunk
// PRE (the pretransposed layout): q, k, v are (B, H*d, S) with S contiguous,
// read through 4-D maps (S, d, H, B) in boxes of 64 positions x
// ceil(d/16)*16 channel rows (rows past d zero-filled by the map, not the
// next head's channels); Q and K then enter Q.K^T MN-major (the transpose
// bits) and V enters P.V K-major. Only the ablation builds take it.

#pragma once

#include "hopper.cuh"

namespace {

constexpr int kBlockQ = 128;       // query rows a block: 2 consumer warpgroups
constexpr int kThreads = 384;      // producer + two consumer warpgroups
constexpr int kBoxCols = 64;       // columns of a TMA box: 128 bytes of bf16
constexpr int kSmemLimit = 232448; // dynamic shared memory a block may use

// Ablation modes; the numbers are the C interface's and
// mimo_tpu_torch/tools/ablate_flash.py::MODES order.
enum FlashMode : int {
  kFull = 0,
  kNoExp,
  kNoSm,
  kNoPV,
  kNoQK,
  kNoMXU,
  kNoShift,
  kChunk2,
  kChunk4,
  kNumModes
};

template <int D, bool PRE = false>
struct FlashTile {
  // keys a stage: n128 products up to d = 128, n64 above (registers)
  static constexpr int kBK = D <= 128 ? 128 : 64;
  static constexpr int kBoxes = (D + kBoxCols - 1) / kBoxCols;
  static constexpr int kKSteps = (D + 15) / 16;        // k16 steps of Q.K^T
  // a pretransposed box: 64 positions x kKSteps * 16 channel rows
  static constexpr int kBoxT = kKSteps * 16 * 128;
  static constexpr int kQBytes =
      PRE ? kBlockQ / 64 * kBoxT : kBoxes * kBlockQ * 128;
  static constexpr int kKVBytes =                      // one K or V tile
      PRE ? kBK / 64 * kBoxT : kBoxes * kBK * 128;
  static constexpr int kStageBytes = 2 * kKVBytes;
  // the ring as deep as 227 KB holds beside the Q tile, the Q mbarrier and
  // 1 KB of alignment slack; a stage: a K and a V tile, a full and an
  // empty mbarrier
  static constexpr int kStages =
      (kSmemLimit - 1024 - kQBytes - 8) / (kStageBytes + 16);
  static constexpr int kSmemBytes =
      1024 + kQBytes + kStages * (kStageBytes + 16) + 8;
  static_assert(kStages >= 2 && kSmemBytes <= kSmemLimit,
                "the K/V ring must be at least double-buffered within 227 KB");
  static_assert(D % 8 == 0 && D <= 160, "d % 8 == 0, d <= 160");
};

struct FlashArgs {
  __nv_bfloat16* o;
  long long o_bs, o_ss;
  int sq, sk1, sk2;
  // bit i set: map i (q, k, v, kb, vb) has a batch dimension; clear: one
  // batch row (the bank, or a tensor with batch stride 0)
  int batched;
  float scale_log2;          // log2(e) / sqrt(d)
};

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Element (row r, channel 0) of a swizzled tile: in the natural layout a
// row is 128 bytes whose first 16-byte chunk the 128-byte swizzle moves to
// chunk r & 7; in the pretransposed one, channel row 0 is unswizzled and
// holds 64 positions a box.
template <int D, bool PRE>
__device__ __forceinline__ float first_channel(const unsigned char* tile,
                                               int r) {
  const unsigned char* p;
  if constexpr (PRE)
    p = tile + (r >> 6) * FlashTile<D, PRE>::kBoxT + (r & 63) * 2;
  else
    p = tile + r * 128 + ((r & 7) << 4);
  return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(p));
}

template <int D, int MODE, bool PRE>
__device__ __forceinline__ void flash_body(const CUtensorMap& map_q,
                                           const CUtensorMap& map_k,
                                           const CUtensorMap& map_v,
                                           const CUtensorMap& map_kb,
                                           const CUtensorMap& map_vb,
                                           const FlashArgs& a) {
  using T = FlashTile<D, PRE>;
  constexpr int kBK = T::kBK;
  constexpr bool kRank1 = MODE == kNoQK || MODE == kNoMXU;
  constexpr bool kPick = MODE == kNoPV || MODE == kNoMXU;
  constexpr int kChunks = MODE == kChunk2 ? 2 : MODE == kChunk4 ? 4 : 1;
  static_assert(MODE >= kFull && MODE < kNumModes, "unknown ablation mode");
  static_assert(!PRE || kBK == 128, "the pretransposed layout: kBK = 128");
  static_assert(!kPick || D <= kBK, "nopv picks one key a column");
  extern __shared__ unsigned char smem_raw[];
  // the swizzle atoms need 1024-byte alignment (the launch asks 1 KB more)
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* q_tile = smem;               // box j: 128 rows x 128 B
  unsigned char* ring = smem + T::kQBytes;    // stage s: K boxes, V boxes
  uint64_t* full =
      reinterpret_cast<uint64_t*>(ring + T::kStages * T::kStageBytes);
  uint64_t* empty = full + T::kStages;
  uint64_t* q_full = empty + T::kStages;

  const int q0 = blockIdx.x * kBlockQ, head = blockIdx.y, b = blockIdx.z;
  const int nt1 = (a.sk1 + kBK - 1) / kBK;
  const int nt = nt1 + (a.sk2 + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(&full[s], 1);   // the producer's expect_tx arrival
      mbar_init(&empty[s], 2);  // one release from each consumer warpgroup
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer warpgroup: one thread issues every load of the block
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, T::kQBytes);
      if constexpr (PRE) {
        // a box of 64 queries for each consumer warpgroup
#pragma unroll
        for (int j = 0; j < kBlockQ / 64; ++j)
          tma_load(q_tile + j * T::kBoxT, &map_q, q0 + 64 * j, 0, head,
                   a.batched & 1 ? b : 0, q_full);
      } else {
#pragma unroll
        for (int j = 0; j < T::kBoxes; ++j)
          tma_load(q_tile + j * kBlockQ * 128, &map_q, j * kBoxCols, head, q0,
                   a.batched & 1 ? b : 0, q_full);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int it = 0; it < nt; ++it) {
        const bool self = it < nt1;
        const CUtensorMap* mk = self ? &map_k : &map_kb;
        const CUtensorMap* mv = self ? &map_v : &map_vb;
        const int k0 = (self ? it : it - nt1) * kBK;
        const int bk = a.batched >> (self ? 1 : 3) & 1 ? b : 0;
        const int bv = a.batched >> (self ? 2 : 4) & 1 ? b : 0;
        mbar_wait(&empty[stage], phase ^ 1);  // passes at once on lap 0
        mbar_expect_tx(&full[stage], T::kStageBytes);
        unsigned char* kt = ring + stage * T::kStageBytes;
        if constexpr (PRE) {
#pragma unroll
          for (int j = 0; j < kBK / 64; ++j) {
            tma_load(kt + j * T::kBoxT, mk, k0 + 64 * j, 0, head, bk,
                     &full[stage]);
            tma_load(kt + T::kKVBytes + j * T::kBoxT, mv, k0 + 64 * j, 0,
                     head, bv, &full[stage]);
          }
        } else {
#pragma unroll
          for (int j = 0; j < T::kBoxes; ++j) {
            tma_load(kt + j * kBK * 128, mk, j * kBoxCols, head, k0, bk,
                     &full[stage]);
            tma_load(kt + T::kKVBytes + j * kBK * 128, mv, j * kBoxCols, head,
                     k0, bv, &full[stage]);
          }
        }
        if (++stage == T::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int t = lane & 3;
    const bool leader = threadIdx.x % 128 == 0;
    const float c = a.scale_log2;
    // this warpgroup's 64 Q rows start 8 KB into each box (natural), or
    // are its own box (pretransposed, read MN-major)
    uint64_t dq;
    if constexpr (PRE)
      dq = smem_desc_mn(q_tile + cw * T::kBoxT, T::kBoxT);
    else
      dq = smem_desc(q_tile + cw * 64 * 128);

    // accumulator register 4i + 2h + e of a thread: row 16 warp + lane/4 +
    // 8h of the warpgroup's 64, column 8i + 2t + e
    float s[kBK / 2], o[D / 2];
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) s[i] = 0.f;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    [[maybe_unused]] float m0 = -INFINITY, m1 = -INFINITY;
    float l0 = 0.f, l1 = 0.f;

    mbar_wait(q_full, 0);
    // the rank-1 stand-in's q elements: channel 0 of this thread's rows
    [[maybe_unused]] float qe0 = 0.f, qe1 = 0.f;
    if constexpr (kRank1) {
      const int r = cw * 64 + warp * 16 + (lane >> 2);
      qe0 = first_channel<D, PRE>(q_tile, r);
      qe1 = first_channel<D, PRE>(q_tile, r + 8);
    }
    for (int it = 0; it < nt; ++it) {
      const int stage = it % T::kStages;
      mbar_wait(&full[stage], (it / T::kStages) & 1);
      unsigned char* kt = ring + stage * T::kStageBytes;
      [[maybe_unused]] uint64_t dk;
      if constexpr (PRE)
        dk = smem_desc_mn(kt, T::kBoxT);
      else
        dk = smem_desc(kt);

      if constexpr (kChunks > 1) {
        // S = Q K^T in kChunks wgmma groups of kN keys each, all issued
        // before the first sub-chunk's softmax
        constexpr int kN = kBK / kChunks;
        float sc[kChunks][kN / 2];
        wgmma_fence();
#pragma unroll
        for (int ch = 0; ch < kChunks; ++ch) {
#pragma unroll
          for (int kk = 0; kk < T::kKSteps; ++kk) {
            if constexpr (PRE) {
              // keys ch kN.. start in box ch kN / 64, (ch kN % 64) * 2
              // bytes into its rows
              wgmma_ss_t<kN>(sc[ch], dq + kk * (16 * 128 >> 4),
                             dk + ((ch * kN / 64) * T::kBoxT >> 4) +
                                 (ch * kN % 64) * 2 / 16 +
                                 kk * (16 * 128 >> 4),
                             kk != 0);
            } else {
              const int off = (kk / 4) * (kBlockQ * 128 >> 4) + (kk % 4) * 2;
              const int koff = (kk / 4) * (kBK * 128 >> 4) + (kk % 4) * 2;
              wgmma_ss<kN>(sc[ch], dq + off,
                           dk + koff + ch * (kN * 128 >> 4), kk != 0);
            }
          }
          wgmma_commit();
        }
        const int valid = a.sk1 - it * kBK;
#pragma unroll
        for (int ch = 0; ch < kChunks; ++ch) {
          // groups committed after sub-chunk ch's: the later Q.K^T groups
          // and, from ch = 1, the P.V of ch - 1 (whose wait at ch = 1
          // drains the rest)
          if (ch < 2)
            wgmma_wait<kChunks - 1>();
          else
            wgmma_wait<1>();
          fence_acc(sc[ch]);
          if (valid < kBK) {
#pragma unroll
            for (int i = 0; i < kN / 2; ++i)
              if (ch * kN + (i / 4) * 8 + 2 * t + (i & 1) >= valid)
                sc[ch][i] = -INFINITY;
          }
          float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
          for (int i = 0; i < kN / 2; i += 4) {
            mx0 = fmaxf(mx0, fmaxf(sc[ch][i], sc[ch][i + 1]));
            mx1 = fmaxf(mx1, fmaxf(sc[ch][i + 2], sc[ch][i + 3]));
          }
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
          // the first sub-chunk of the first tile holds a valid key, so the
          // running max is finite from then on
          const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
          const float al0 = ex2((m0 - mn0) * c), al1 = ex2((m1 - mn1) * c);
          m0 = mn0;
          m1 = mn1;
          const float b0 = -mn0 * c, b1 = -mn1 * c;
          float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
          for (int i = 0; i < kN / 2; i += 4) {
            sc[ch][i] = ex2(fmaf(sc[ch][i], c, b0));
            sc[ch][i + 1] = ex2(fmaf(sc[ch][i + 1], c, b0));
            sc[ch][i + 2] = ex2(fmaf(sc[ch][i + 2], c, b1));
            sc[ch][i + 3] = ex2(fmaf(sc[ch][i + 3], c, b1));
            rs0 += sc[ch][i] + sc[ch][i + 1];
            rs1 += sc[ch][i + 2] + sc[ch][i + 3];
          }
          l0 = l0 * al0 + rs0;
          l1 = l1 * al1 + rs1;
          uint32_t p[kN / 16][4];
#pragma unroll
          for (int kk = 0; kk < kN / 16; ++kk) {
            p[kk][0] = pack_bf16x2(sc[ch][8 * kk], sc[ch][8 * kk + 1]);
            p[kk][1] = pack_bf16x2(sc[ch][8 * kk + 2], sc[ch][8 * kk + 3]);
            p[kk][2] = pack_bf16x2(sc[ch][8 * kk + 4], sc[ch][8 * kk + 5]);
            p[kk][3] = pack_bf16x2(sc[ch][8 * kk + 6], sc[ch][8 * kk + 7]);
          }
          // o is rescaled only once the P.V of ch - 1 has finished with it
          if (ch > 0) {
            wgmma_wait<0>();
            fence_acc(o);
          }
#pragma unroll
          for (int i = 0; i < D / 2; i += 4) {
            o[i] *= al0;
            o[i + 1] *= al0;
            o[i + 2] *= al1;
            o[i + 3] *= al1;
          }
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kN / 16; ++kk) {
            const int g = ch * kN / 16 + kk;  // 16-key step of the tile
            if constexpr (PRE)
              wgmma_rs_k<D>(o, p[kk], smem_desc(kt + T::kKVBytes) +
                                          (g / 4) * (T::kBoxT >> 4) +
                                          (g % 4) * 2);
            else
              wgmma_rs<D>(o, p[kk],
                          smem_desc_mn(kt + T::kKVBytes, kBK * 128) +
                              g * (16 * 128 >> 4));
          }
          wgmma_commit();
        }
        wgmma_wait<0>();
        fence_acc(o);
        if (leader) mbar_arrive(&empty[stage]);
        continue;
      }

      // S = Q K^T over this tile's kBK keys
      if constexpr (kRank1) {
        // stand-in without the product: one FFMA a logit
#pragma unroll
        for (int i = 0; i < kBK / 8; ++i) {
          const float k0 = first_channel<D, PRE>(kt, 8 * i + 2 * t);
          const float k1 = first_channel<D, PRE>(kt, 8 * i + 2 * t + 1);
          s[4 * i] = fmaf(qe0, k0, -8.f);
          s[4 * i + 1] = fmaf(qe0, k1, -8.f);
          s[4 * i + 2] = fmaf(qe1, k0, -8.f);
          s[4 * i + 3] = fmaf(qe1, k1, -8.f);
        }
      } else {
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < T::kKSteps; ++kk) {
          if constexpr (PRE) {
            // 16 channel rows a step, both operands MN-major
            wgmma_ss_t<kBK>(s, dq + kk * (16 * 128 >> 4),
                            dk + kk * (16 * 128 >> 4), kk != 0);
          } else {
            // k step kk: box kk / 4, 32 bytes a step inside it
            const int off = (kk / 4) * (kBlockQ * 128 >> 4) + (kk % 4) * 2;
            const int koff = (kk / 4) * (kBK * 128 >> 4) + (kk % 4) * 2;
            wgmma_ss<kBK>(s, dq + off, dk + koff, kk != 0);
          }
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(s);
      }

      // the last tile of a segment may be ragged: its keys past the end
      // were zero-filled (logit 0, not -inf) and are masked here
      const int valid =
          it < nt1 ? a.sk1 - it * kBK : a.sk2 - (it - nt1) * kBK;
      if constexpr (MODE != kNoSm) {
        if (valid < kBK) {
#pragma unroll
          for (int i = 0; i < kBK / 2; ++i)
            if ((i / 4) * 8 + 2 * t + (i & 1) >= valid) s[i] = -INFINITY;
        }
      }

      if constexpr (MODE == kNoSm || MODE == kNoShift) {
        // no running max: |s| + 1, or exp2 of a fixed shift; no rescale
        float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
        for (int i = 0; i < kBK / 2; ++i) {
          if constexpr (MODE == kNoSm)
            s[i] = fabsf(s[i]) + 1.f;
          else
            s[i] = ex2(fmaf(s[i], c, -8.f));
          if (i & 2)
            rs1 += s[i];
          else
            rs0 += s[i];
        }
        l0 += rs0;
        l1 += rs1;
      } else {
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int i = 0; i < kBK / 2; i += 4) {
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
        for (int i = 0; i < kBK / 2; i += 4) {
          if constexpr (MODE == kNoExp) {
            // bounded linear stand-in of exp2: 16 at the row max, 0 on
            // masked keys
            s[i] = fmaxf(fmaf(s[i], c, b0), -16.f) + 16.f;
            s[i + 1] = fmaxf(fmaf(s[i + 1], c, b0), -16.f) + 16.f;
            s[i + 2] = fmaxf(fmaf(s[i + 2], c, b1), -16.f) + 16.f;
            s[i + 3] = fmaxf(fmaf(s[i + 3], c, b1), -16.f) + 16.f;
          } else {
            s[i] = ex2(fmaf(s[i], c, b0));
            s[i + 1] = ex2(fmaf(s[i + 1], c, b0));
            s[i + 2] = ex2(fmaf(s[i + 2], c, b1));
            s[i + 3] = ex2(fmaf(s[i + 3], c, b1));
          }
          rs0 += s[i] + s[i + 1];
          rs1 += s[i + 2] + s[i + 3];
        }
        l0 = l0 * al0 + rs0;  // per-thread partial sums; quad sums at the end
        l1 = l1 * al1 + rs1;
#pragma unroll
        for (int i = 0; i < D / 2; i += 4) {
          if constexpr (kPick) {
            // in place of P.V: column 8(i/4) + 2t + e adds P of the key of
            // the same number, held in the same thread's s register
            o[i] = fmaf(o[i], al0, s[i]);
            o[i + 1] = fmaf(o[i + 1], al0, s[i + 1]);
            o[i + 2] = fmaf(o[i + 2], al1, s[i + 2]);
            o[i + 3] = fmaf(o[i + 3], al1, s[i + 3]);
          } else {
            o[i] *= al0;
            o[i + 1] *= al0;
            o[i + 2] *= al1;
            o[i + 3] *= al1;
          }
        }
      }

      if constexpr (!kPick) {
        // O += P V: P from registers, 16 keys a step; V MN-major
        // (natural) or K-major (pretransposed)
        uint32_t p[kBK / 16][4];
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          p[kk][0] = pack_bf16x2(s[8 * kk], s[8 * kk + 1]);
          p[kk][1] = pack_bf16x2(s[8 * kk + 2], s[8 * kk + 3]);
          p[kk][2] = pack_bf16x2(s[8 * kk + 4], s[8 * kk + 5]);
          p[kk][3] = pack_bf16x2(s[8 * kk + 6], s[8 * kk + 7]);
        }
        if constexpr (PRE) {
          const uint64_t dv = smem_desc(kt + T::kKVBytes);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kBK / 16; ++kk)
            wgmma_rs_k<D>(o, p[kk],
                          dv + (kk / 4) * (T::kBoxT >> 4) + (kk % 4) * 2);
        } else {
          const uint64_t dv = smem_desc_mn(kt + T::kKVBytes, kBK * 128);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kBK / 16; ++kk)
            wgmma_rs<D>(o, p[kk], dv + kk * (16 * 128 >> 4));
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(o);
      }
      if constexpr (kRank1 && kPick) {
        // no wgmma keeps the warpgroup's warps together: wait for all four
        // (their reads of the stage done) before the stage is released
        asm volatile("bar.sync %0, 128;\n" :: "r"(1 + cw) : "memory");
      }
      if (leader) mbar_arrive(&empty[stage]);
    }

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    const int r0 = q0 + cw * 64 + warp * 16 + (lane >> 2), r1 = r0 + 8;
    __nv_bfloat16* og = a.o + b * a.o_bs + head * D;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const int col = i * 8 + 2 * t;
      if (r0 < a.sq)
        *reinterpret_cast<uint32_t*>(og + r0 * a.o_ss + col) =
            pack_bf16x2(o[4 * i] * inv0, o[4 * i + 1] * inv0);
      if (r1 < a.sq)
        *reinterpret_cast<uint32_t*>(og + r1 * a.o_ss + col) =
            pack_bf16x2(o[4 * i + 2] * inv1, o[4 * i + 3] * inv1);
    }
  }
}

// TMA map of the (B, S, H*d) bf16 operand at base as 4-D (d, H, S, B), read
// in (64, 1, rows, 1) boxes with the 128-byte swizzle: columns d..63 of a
// box and rows past S are zero-filled. `batched` == false gives the map one
// batch row (the bank, or a tensor with batch stride 0).
inline bool make_map(CUtensorMap* map, const void* base, int d, int heads, int s,
              long long ss, int batch, long long bs, bool batched, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {
      static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(heads),
      static_cast<cuuint64_t>(s),
      static_cast<cuuint64_t>(batched ? batch : 1)};
  // the batch stride of a one-row map is never used: any legal value
  const long long bstride = batched ? bs : ss * s + 8;
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(bstride) * 2};
  const cuuint32_t box[4] = {kBoxCols, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
