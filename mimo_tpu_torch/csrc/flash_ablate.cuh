// The body of the flash ablation builds (flash_ablate.cu): the first design
// of the flash attention forward kernel, kept as it was when it was the
// production kernel (mma.sync m16n8k16 on 8 warps, each warp's Q fragments
// in registers, 64-key K/V tiles double-buffered with cp.async). The
// production kernel is now the wgmma + TMA design of flash_attention.cu;
// this body is no longer it.
//
// The body is a template over an ablation mode and a K/V layout.
// FlashMode::kFull over the natural layout is the first design unchanged;
// every other instantiation removes one piece of its work and keeps the
// rest, data dependencies included, so that the time a mode saves is the
// cost of the piece it removes (see flash_ablate.cu for the meaning of each
// mode).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 128;  // query rows per block (8 warps x 16 rows)
constexpr int kBlockK = 64;   // keys per shared-memory tile
constexpr int kThreads = 256;

// Ablation modes; the numbers are the C interface's and
// mimo_tpu_torch/tools/ablate_flash.py::MODES order.
enum FlashMode : int {
  kFull = 0,   // the first design's math, unchanged
  kNoExp,      // no exp2 per logit (bounded linear stand-in)
  kNoSm,       // no scale, mask, row max, rescale or exp2
  kNoPV,       // no P.V product (a column pick of P instead)
  kNoQK,       // no Q.K^T product (a rank-1 stand-in)
  kNoMXU,      // kNoQK and kNoPV: no tensor-core work
  kNoShift,    // no running max: a fixed shift, no rescale
  kChunk2,     // each key tile in 2 sub-chunks, QK of c+1 before softmax of c
  kChunk4,     // the same in 4 sub-chunks
  kNumModes
};

// the fixed exp2-domain shift of kNoShift: exact softmax while every scaled
// logit x = s * log2(e) / sqrt(d) stays in (kFixedShift - 126,
// kFixedShift + 100], so that no exp2 overflows and no row sum underflows
constexpr float kFixedShift = 8.f;

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy that reads the first `bytes` (0..16) and
// zero-fills the rest
__device__ __forceinline__ void cp_async16_n(void* dst, const void* src,
                                             int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes));
}

// with pred false it writes 16 zero bytes and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  cp_async16_n(dst, src, pred ? 16 : 0);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// B fragment (16 keys x 8 columns) of a row-major [key][d] tile
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& b0, uint32_t& b1,
                                                  const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b0), "=r"(b1) : "r"(smem_addr(p)));
}

// B fragment (16 keys x 8 columns) of a [d][key] tile
__device__ __forceinline__ void ldmatrix_x2(uint32_t& b0, uint32_t& b1,
                                            const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b0), "=r"(b1) : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int D>
struct FlashShape {
  static constexpr int kDP = (D + 15) / 16 * 16;  // Q.K^T contraction, zero-padded
  static constexpr int kKC = kDP / 16;            // 16-deep k-chunks of Q.K^T
  static constexpr int kND = D / 8;               // 8-wide column tiles of P.V
  static constexpr int kStride = kDP + 8;         // smem row stride (elements)
  static constexpr int kVecs = kDP / 8;           // 16-byte vectors per row
  static constexpr int kTile = kBlockK * kStride;
  // Q tile + two buffers of (K tile, V tile)
  static constexpr int kSmemBytes = (kBlockQ * kStride + 4 * kTile) * 2;
  // the pretransposed layout's [d][key] K/V tiles
  static constexpr int kStrideT = kBlockK + 8;
  static constexpr int kTileT = kDP * kStrideT;
  static constexpr int kSmemBytesT = (kBlockQ * kStride + 4 * kTileT) * 2;
};

// q, k, v, kb, vb are (B, S, H*d) with `_ss` the sequence stride, or, in the
// pretransposed layout, (B, H*d, S) with `_ss` the channel stride; the last
// dim is contiguous in both. o is always (B, S, H*d).
struct FlashArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* kb;
  const __nv_bfloat16* vb;
  __nv_bfloat16* o;
  int sq, sk1, sk2;
  long long q_bs, q_ss, k_bs, k_ss, v_bs, v_ss;
  long long kb_bs, kb_ss, vb_bs, vb_ss, o_bs, o_ss;
  float scale_log2;
};

template <int D, int MODE, bool PRE>
__device__ __forceinline__ void flash_fwd_body(const FlashArgs& a,
                                               unsigned char* smem_raw) {
  using S = FlashShape<D>;
  constexpr bool kRank1 = MODE == kNoQK || MODE == kNoMXU;
  constexpr bool kPick = MODE == kNoPV || MODE == kNoMXU;
  constexpr int kNCH = MODE == kChunk2 ? 2 : MODE == kChunk4 ? 4 : 1;
  constexpr int kJ = kBlockK / 8 / kNCH;  // 8-key column tiles per sub-chunk
  constexpr int kTileE = PRE ? S::kTileT : S::kTile;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* kvs = qs + kBlockQ * S::kStride;  // [buf][K | V] tiles

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kBlockQ;
  const int col0 = blockIdx.y * D;
  const long long b = blockIdx.z;
  const int nt1 = (a.sk1 + kBlockK - 1) / kBlockK;
  const int nt = nt1 + (a.sk2 + kBlockK - 1) / kBlockK;

  // key tile `it` of the flattened [self | bank] sequence
  auto valid_keys = [&](int it) {
    return it < nt1 ? min(kBlockK, a.sk1 - it * kBlockK)
                    : min(kBlockK, a.sk2 - (it - nt1) * kBlockK);
  };

  auto load_tile = [&](int it, int buf) {
    const bool self = it < nt1;
    const int k0 = (self ? it : it - nt1) * kBlockK;
    const long long kss = self ? a.k_ss : a.kb_ss;
    const long long vss = self ? a.v_ss : a.vb_ss;
    const int valid = valid_keys(it);
    __nv_bfloat16* kd = kvs + (2 * buf) * kTileE;
    __nv_bfloat16* vd = kd + kTileE;
    if constexpr (PRE) {
      // [d][key] rows of 8 16-byte key vectors; a vector across the key
      // edge reads its valid keys and zero-fills the rest
      const __nv_bfloat16* kp =
          (self ? a.k + b * a.k_bs : a.kb + b * a.kb_bs) + col0 * kss + k0;
      const __nv_bfloat16* vp =
          (self ? a.v + b * a.v_bs : a.vb + b * a.vb_bs) + col0 * vss + k0;
      for (int i = tid; i < S::kDP * (kBlockK / 8); i += kThreads) {
        const int r = i / (kBlockK / 8), cv = i % (kBlockK / 8);
        const int n = r < D ? min(8, max(0, valid - cv * 8)) : 0;
        cp_async16_n(kd + r * S::kStrideT + cv * 8,
                     n ? kp + r * kss + cv * 8 : kp, 2 * n);
        cp_async16_n(vd + r * S::kStrideT + cv * 8,
                     n ? vp + r * vss + cv * 8 : vp, 2 * n);
      }
    } else {
      const __nv_bfloat16* kp =
          (self ? a.k + b * a.k_bs : a.kb + b * a.kb_bs) + k0 * kss + col0;
      const __nv_bfloat16* vp =
          (self ? a.v + b * a.v_bs : a.vb + b * a.vb_bs) + k0 * vss + col0;
      for (int i = tid; i < kBlockK * S::kVecs; i += kThreads) {
        const int r = i / S::kVecs, cv = i % S::kVecs;
        const bool ok = r < valid && cv * 8 < D;
        cp_async16(kd + r * S::kStride + cv * 8, ok ? kp + r * kss + cv * 8 : kp, ok);
        cp_async16(vd + r * S::kStride + cv * 8, ok ? vp + r * vss + cv * 8 : vp, ok);
      }
    }
  };

  load_tile(0, 0);
  cp_async_commit();

  // Q tile -> smem as [query][d], zero past Sq and past d
  if constexpr (PRE) {
    // transposed once per block, element by element (consecutive threads
    // read consecutive queries)
    const __nv_bfloat16* qg = a.q + b * a.q_bs + col0 * a.q_ss;
    for (int i = tid; i < kBlockQ * S::kDP; i += kThreads) {
      const int r = i % kBlockQ, c = i / kBlockQ;
      __nv_bfloat16 val = __float2bfloat16(0.f);
      if (q0 + r < a.sq && c < D) val = qg[c * a.q_ss + q0 + r];
      qs[r * S::kStride + c] = val;
    }
  } else {
    const __nv_bfloat16* qg = a.q + b * a.q_bs + col0;
    for (int i = tid; i < kBlockQ * S::kVecs; i += kThreads) {
      const int r = i / S::kVecs, cv = i % S::kVecs;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (q0 + r < a.sq && cv * 8 < D)
        val = *reinterpret_cast<const uint4*>(qg + (q0 + r) * a.q_ss + cv * 8);
      *reinterpret_cast<uint4*>(qs + r * S::kStride + cv * 8) = val;
    }
  }
  __syncthreads();

  uint32_t qf[S::kKC][4];
  const int qr = warp * 16 + g;
#pragma unroll
  for (int kc = 0; kc < S::kKC; ++kc) {
    const __nv_bfloat16* p = qs + qr * S::kStride + kc * 16 + t * 2;
    qf[kc][0] = ld32(p);
    qf[kc][1] = ld32(p + 8 * S::kStride);
    qf[kc][2] = ld32(p + 8);
    qf[kc][3] = ld32(p + 8 * S::kStride + 8);
  }
  // the rank-1 stand-in's q element (column 0 of the head) of both rows
  float qe0 = 0.f, qe1 = 0.f;
  if constexpr (kRank1) {
    qe0 = __bfloat162float(qs[qr * S::kStride]);
    qe1 = __bfloat162float(qs[(qr + 8) * S::kStride]);
  }

  float acc[S::kND][4];
#pragma unroll
  for (int n = 0; n < S::kND; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int it = 0; it < nt; ++it) {
    const int buf = it & 1;
    if (it + 1 < nt) load_tile(it + 1, buf ^ 1);
    cp_async_commit();     // (possibly empty) group of tile it + 1
    cp_async_wait_one();   // tile it has landed
    __syncthreads();

    const int valid = valid_keys(it);
    const __nv_bfloat16* ks = kvs + (2 * buf) * kTileE;
    const __nv_bfloat16* vs = ks + kTileE;

    // S = Q K^T for this warp's 16 rows x the keys of sub-chunk c
    auto qk = [&](int c, float (&s)[kJ][4]) {
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const int jj = c * kJ + j;  // 8-key column tile within the key tile
        if constexpr (kRank1) {
          // q[row][0] * k[key][0] - 8: one FFMA per logit, no mma
          float k0, k1;
          if constexpr (PRE) {
            const __nv_bfloat162 kk2 = *reinterpret_cast<const __nv_bfloat162*>(
                ks + jj * 8 + t * 2);
            k0 = __low2float(kk2);
            k1 = __high2float(kk2);
          } else {
            k0 = __bfloat162float(ks[(jj * 8 + t * 2) * S::kStride]);
            k1 = __bfloat162float(ks[(jj * 8 + t * 2 + 1) * S::kStride]);
          }
          s[j][0] = fmaf(qe0, k0, -8.f);
          s[j][1] = fmaf(qe0, k1, -8.f);
          s[j][2] = fmaf(qe1, k0, -8.f);
          s[j][3] = fmaf(qe1, k1, -8.f);
        } else {
          s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
          if constexpr (PRE) {
#pragma unroll
            for (int kc = 0; kc < S::kKC; ++kc) {
              uint32_t b0, b1;
              ldmatrix_x2_trans(
                  b0, b1, ks + (kc * 16 + (lane & 15)) * S::kStrideT + jj * 8);
              mma_16816(s[j], qf[kc], b0, b1);
            }
          } else {
            const __nv_bfloat16* kp = ks + (jj * 8 + g) * S::kStride + t * 2;
#pragma unroll
            for (int kc = 0; kc < S::kKC; ++kc)
              mma_16816(s[j], qf[kc], ld32(kp + kc * 16), ld32(kp + kc * 16 + 8));
          }
        }
      }
    };

    // softmax of sub-chunk c and O += P V over its keys
    auto softmax_pv = [&](int c, float (&s)[kJ][4]) {
      const int key0 = c * kJ * 8;
      float rs0 = 0.f, rs1 = 0.f;
      if constexpr (MODE == kNoSm) {
        // no scale, mask, max or exp2: a positive weight of the raw product
        // (the zero-filled keys past the edge weigh 1 and carry v = 0)
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = fabsf(s[j][e]) + 1.f;
          rs0 += s[j][0] + s[j][1];
          rs1 += s[j][2] + s[j][3];
        }
        l0 += rs0;
        l1 += rs1;
      } else if constexpr (MODE == kNoShift) {
        // a fixed shift in place of the running max: no row max, no
        // shuffles, no rescale of acc and l
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool ok = key0 + j * 8 + t * 2 + e < valid;
            s[j][e] = ok ? s[j][e] * a.scale_log2 : -INFINITY;
            s[j][2 + e] = ok ? s[j][2 + e] * a.scale_log2 : -INFINITY;
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = exp2f(s[j][e] - kFixedShift);
          rs0 += s[j][0] + s[j][1];
          rs1 += s[j][2] + s[j][3];
        }
        l0 += rs0;
        l1 += rs1;
      } else {
        // scale into the exp2 domain, mask the ragged key edge, row max
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool ok = key0 + j * 8 + t * 2 + e < valid;
            s[j][e] = ok ? s[j][e] * a.scale_log2 : -INFINITY;
            s[j][2 + e] = ok ? s[j][2 + e] * a.scale_log2 : -INFINITY;
            mx0 = fmaxf(mx0, s[j][e]);
            mx1 = fmaxf(mx1, s[j][2 + e]);
          }
        }
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
        // the first sub-chunk of a tile holds >= 1 valid key, so the new
        // max is finite from the first tile on
        const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
        const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
        m0 = mn0;
        m1 = mn1;
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          if constexpr (MODE == kNoExp) {
            // bounded linear stand-in of exp2(x - m): in [0, 16], 16 at the
            // row max (so row sums stay >= 16), 0 on masked keys
            s[j][0] = fmaxf(s[j][0] - mn0, -16.f) + 16.f;
            s[j][1] = fmaxf(s[j][1] - mn0, -16.f) + 16.f;
            s[j][2] = fmaxf(s[j][2] - mn1, -16.f) + 16.f;
            s[j][3] = fmaxf(s[j][3] - mn1, -16.f) + 16.f;
          } else {
            s[j][0] = exp2f(s[j][0] - mn0);
            s[j][1] = exp2f(s[j][1] - mn0);
            s[j][2] = exp2f(s[j][2] - mn1);
            s[j][3] = exp2f(s[j][3] - mn1);
          }
          rs0 += s[j][0] + s[j][1];
          rs1 += s[j][2] + s[j][3];
        }
        l0 = l0 * al0 + rs0;  // per-thread partial sums; the quad sums at the end
        l1 = l1 * al1 + rs1;
#pragma unroll
        for (int n = 0; n < S::kND; ++n) {
          if constexpr (kPick) {
            // in place of P.V: column n*8 + 2t + e of acc sums P of key
            // (n % 8) * 8 + 2t + e of every tile (acc and l differ)
            acc[n][0] = fmaf(acc[n][0], al0, s[n % kJ][0]);
            acc[n][1] = fmaf(acc[n][1], al0, s[n % kJ][1]);
            acc[n][2] = fmaf(acc[n][2], al1, s[n % kJ][2]);
            acc[n][3] = fmaf(acc[n][3], al1, s[n % kJ][3]);
          } else {
            acc[n][0] *= al0;
            acc[n][1] *= al0;
            acc[n][2] *= al1;
            acc[n][3] *= al1;
          }
        }
      }
      if constexpr (!kPick) {
        // O += P V: the S accumulator layout of two 8-key tiles is the A
        // fragment layout of one 16-key chunk
#pragma unroll
        for (int kk = 0; kk < kJ / 2; ++kk) {
          const uint32_t pa[4] = {
              pack_bf16x2(s[2 * kk][0], s[2 * kk][1]),
              pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
              pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
              pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
          if constexpr (PRE) {
            const __nv_bfloat16* vcol = vs + (lane & 7) * S::kStrideT + key0 +
                                        kk * 16 + ((lane >> 3) & 1) * 8;
#pragma unroll
            for (int n = 0; n < S::kND; ++n) {
              uint32_t b0, b1;
              ldmatrix_x2(b0, b1, vcol + n * 8 * S::kStrideT);
              mma_16816(acc[n], pa, b0, b1);
            }
          } else {
            const __nv_bfloat16* vrow =
                vs + (key0 + kk * 16 + (lane & 15)) * S::kStride;
#pragma unroll
            for (int n = 0; n < S::kND; ++n) {
              uint32_t b0, b1;
              ldmatrix_x2_trans(b0, b1, vrow + n * 8);
              mma_16816(acc[n], pa, b0, b1);
            }
          }
        }
      }
    };

    if constexpr (kNCH == 1) {
      float s[kJ][4];
      qk(0, s);
      softmax_pv(0, s);
    } else {
      // the Q.K^T of sub-chunk c + 1 is issued before the softmax of c
      float sa[kJ][4], sb[kJ][4];
      qk(0, sa);
#pragma unroll
      for (int c = 0; c < kNCH; c += 2) {
        qk(c + 1, sb);
        softmax_pv(c, sa);
        if (c + 2 < kNCH) qk(c + 2, sa);
        softmax_pv(c + 1, sb);
      }
    }
    __syncthreads();  // buffer `buf` is refilled by the next iteration's load
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int r0 = q0 + qr, r1 = r0 + 8;
  __nv_bfloat16* og = a.o + b * a.o_bs + col0;
#pragma unroll
  for (int n = 0; n < S::kND; ++n) {
    const int c = n * 8 + t * 2;
    if (r0 < a.sq)
      *reinterpret_cast<uint32_t*>(og + r0 * a.o_ss + c) =
          pack_bf16x2(acc[n][0] * inv0, acc[n][1] * inv0);
    if (r1 < a.sq)
      *reinterpret_cast<uint32_t*>(og + r1 * a.o_ss + c) =
          pack_bf16x2(acc[n][2] * inv1, acc[n][3] * inv1);
  }
}

}  // namespace
