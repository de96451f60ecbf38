// Temporal (frame-axis) attention core for Hopper (sm_90a): for every batch
// b, spatial position s and head h, an F x F softmax attention over the
// frames, 1 <= F <= 32, bf16 in and out, fp32 logits and softmax.
//
// With the GEMM tile core of gemm.cu it replaces the TPU kernel
// mimo_tpu/ops/temporal_attention.py:212 temporal_attention_fused
// (_tattn_kernel): gemm.cu runs LN + PE -> q|k|v (one (C, 3C) product) and
// the out-projection + bias + residual, this kernel the attention between.
//
// Layout: qkv is the (B*F*S, 3C) row-major output of the fused projection,
// row (b*F + f)*S + s holding [q | k | v] of frame f at position s, head h
// the column slice h*d. out is (B*F*S, C) in the same row order, so no
// transpose is needed on either side.
//
// Numerics follow the einsum path of mimo_tpu/models/unet.py::_temporal_attn:
// logits fp32 from bf16 q, k; softmax fp32; the weights rounded to bf16; the
// product with v accumulated in fp32 and rounded to bf16.
//
// What bounds it on an H100: bytes. One (b, s, h) problem does about
// 4 F^2 d FLOPs on 8 F d bytes (q, k, v read once, o written once), about
// 12 FLOP a byte against the card's bf16 ridge of ~295, so the least time
// is reading qkv and writing out once (0.23 ms for the 771 MB of UNet
// level 0). The design streams those bytes:
// - Work items are (b, a run of P consecutive positions, a group of G
//   heads). For a fixed (b, f) consecutive positions are consecutive rows,
//   so an item's q|k|v is F * P row spans of G*d columns a segment (the
//   whole 3C row when G = H). ops/temporal_attention.py::core_plan picks
//   the widest G that leaves two ring stages (fewer, longer copies cost
//   the producer less a byte), P (a stage near 48 KB) and the ring depth.
// - A persistent grid (one block per SM) walks the items. A producer warp
//   copies each span with a TMA bulk copy (cp.async.bulk; the lanes split
//   the copies) into a ring stage and counts the bytes on the stage's
//   `full` mbarrier; the ring of 2-8 stages keeps 90-185 KB in flight on
//   each SM.
// - Twelve consumer warps take the (position, head) problems of the
//   stages. Q.K^T and P.V run on the tensor cores (mma.sync m16n8k16; F
//   padded to 32 query rows and key columns, keys >= F masked to -inf; d in
//   k16 steps and one m16n8k8 step where d % 16 == 8). The softmax runs on
//   the accumulator fragments with quad shuffles, and P is packed to bf16
//   in registers as the A fragment of P.V, whose V operand comes from
//   ldmatrix.trans. mma.sync and not wgmma: a problem has at most 32 query
//   rows, so a 64-row wgmma tile would stack two problems and waste half of
//   its logits, and arithmetic is not the bound.
// - A problem is one warp's chain of dependent loads, products and
//   shuffles, so its latency, not issue, is what a consumer spends: the
//   kernel is a template over d (every k step and column chunk unrolled, so
//   the loads of a product issue together) and runs 12 consumer warps.
// - A staged row is [q | k | v] of G heads with a stride of an odd number
//   of 16-byte chunks, so the 8 frame rows one ldmatrix reads fall on
//   distinct banks. Rows past F are read as row F - 1 (finite, masked or
//   never stored), never past the stage.
// - Each warp stages its o over the q columns it has consumed and stores
//   the frames' rows with 16-byte stores, then releases the stage (`empty`
//   mbarrier, one arrival a consumer warp) for the producer to refill.

#include "hopper.cuh"

namespace {

constexpr int kMaxF = 32;       // two m16 tiles of query rows
constexpr int kConsumers = 12;  // consumer warps; one producer warp beside
constexpr int kThreads = (kConsumers + 1) * 32;
constexpr int kMaxStages = 8;
constexpr int kBarBytes = 1024;  // the ring's mbarriers, before the stages
constexpr int kSmemLimit = 232448;  // dynamic shared memory of one block
constexpr int kMaxD = 160;

struct Args {
  const __nv_bfloat16* qkv;
  __nv_bfloat16* out;
  int F, S, H, d;
  int G, P, rs, stages;  // heads and positions an item holds, row stride
  int n_items, n_pos, n_groups;
  float scale_log2;
};

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4],
                                        const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1,
                                        const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1) : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t& r0, uint32_t& r1,
                                              const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1) : "r"(smem_u32(p)));
}

// c (16 x 8, fp32) += a (16 x 16) . b (16 x 8), bf16
__device__ __forceinline__ void mma_k16(float (&c)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c (16 x 8, fp32) += a (16 x 8) . b (8 x 8), bf16
__device__ __forceinline__ void mma_k8(float (&c)[4], uint32_t a0,
                                       uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// One (position, head) problem of a stage, by one warp. q, k, v point at
// frame 0 of the head's columns; frame f is `rs` elements further on. o is
// staged over q, then stored to out (frame f at out + f * ldo).
template <int D>
__device__ __forceinline__ void attend(__nv_bfloat16* q,
                                       const __nv_bfloat16* k,
                                       const __nv_bfloat16* v,
                                       __nv_bfloat16* out, long long ldo,
                                       int F, int rs, float sl, int lane) {
  constexpr int kSteps = D / 16;        // k16 steps of Q.K^T
  constexpr bool kHalf = D % 16 != 0;   // and one k8 step
  const int g = lane >> 2, t = lane & 3, last = F - 1;
  const int mtiles = (F + 15) >> 4;  // 16-row tiles of query frames
  const int ntiles = (F + 7) >> 3;   // 8-key tiles of Q.K^T
  const int ksteps = (ntiles + 1) >> 1;  // 16-key steps of P.V
  // this lane's ldmatrix rows (frames past F read as frame F - 1) and
  // columns: Q (A of Q.K^T, one 16-row tile a load), K (B of Q.K^T, two
  // 8-key tiles a load), V (B of P.V, transposed, two 8-column tiles)
  const __nv_bfloat16* qr[2];
  const __nv_bfloat16* kr[2];
  const __nv_bfloat16* vr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    qr[i] = q + min(i * 16 + (lane & 15), last) * rs + ((lane >> 4) << 3);
    kr[i] = k + min(i * 16 + (((lane >> 4) << 3) | (lane & 7)), last) * rs +
            (((lane >> 3) & 1) << 3);
    vr[i] = v + min(i * 16 + (lane & 15), last) * rs + ((lane >> 4) << 3);
  }

  // logits
  float sc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[mt][nt][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) {
    uint32_t a[2][4], b[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (i < mtiles) ldsm_x4(a[i], qr[i] + ks * 16);
      if (2 * i < ntiles) ldsm_x4(b[i], kr[i] + ks * 16);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        if (mt < mtiles && nt < ntiles)
          mma_k16(sc[mt][nt], a[mt], b[nt >> 1][(nt & 1) * 2],
                  b[nt >> 1][(nt & 1) * 2 + 1]);
  }
  if constexpr (kHalf) {
    // the last 8 columns: A and B fragments of m16n8k8 (x2 loads at the
    // rows of lanes 0-15, column 0 of the 8)
    uint32_t a[2][2], b[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = min(i * 16 + (lane & 15), last) * rs + kSteps * 16;
      if (i < mtiles) ldsm_x2(a[i][0], a[i][1], q + row);
      if (2 * i < ntiles) ldsm_x2(b[i][0], b[i][1], k + row);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        if (mt < mtiles && nt < ntiles)
          mma_k8(sc[mt][nt], a[mt][0], a[mt][1], b[nt >> 1][nt & 1]);
  }

  // softmax of rows g and g + 8 of each tile: a row's values sit in the
  // four lanes of a quad; keys >= F masked; p = exp2(l*c - max*c), then
  // normalised and rounded to bf16 as the A fragment of P.V
  uint32_t pa[2][2][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    if (mt < mtiles) {
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        if (nt < ntiles) {
          const int key = nt * 8 + 2 * t;
          float* c = sc[mt][nt];
          if (key >= F) c[0] = c[2] = -INFINITY;
          if (key + 1 >= F) c[1] = c[3] = -INFINITY;
          mx0 = fmaxf(mx0, fmaxf(c[0], c[1]));
          mx1 = fmaxf(mx1, fmaxf(c[2], c[3]));
        }
      }
#pragma unroll
      for (int x = 1; x <= 2; x <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
      }
      const float off0 = mx0 * sl, off1 = mx1 * sl;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        if (nt < ntiles) {
          float* c = sc[mt][nt];
          c[0] = exp2f(fmaf(c[0], sl, -off0));
          c[1] = exp2f(fmaf(c[1], sl, -off0));
          c[2] = exp2f(fmaf(c[2], sl, -off1));
          c[3] = exp2f(fmaf(c[3], sl, -off1));
          sum0 += c[0] + c[1];
          sum1 += c[2] + c[3];
        }
      }
#pragma unroll
      for (int x = 1; x <= 2; x <<= 1) {
        sum0 += __shfl_xor_sync(0xffffffffu, sum0, x);
        sum1 += __shfl_xor_sync(0xffffffffu, sum1, x);
      }
      const float inv0 = 1.f / sum0, inv1 = 1.f / sum1;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (j < ksteps) {
          const float* lo = sc[mt][2 * j];
          pa[mt][j][0] = pack_bf16x2(lo[0] * inv0, lo[1] * inv0);
          pa[mt][j][1] = pack_bf16x2(lo[2] * inv1, lo[3] * inv1);
          if (2 * j + 1 < ntiles) {
            const float* hi = sc[mt][2 * j + 1];
            pa[mt][j][2] = pack_bf16x2(hi[0] * inv0, hi[1] * inv0);
            pa[mt][j][3] = pack_bf16x2(hi[2] * inv1, hi[3] * inv1);
          } else {
            pa[mt][j][2] = pa[mt][j][3] = 0u;
          }
        }
      }
    }
  }

  // every lane is done reading q: o may go over it
  __syncwarp();
  // o = P.V, 32 columns at a time (16 accumulators a lane and tile)
#pragma unroll
  for (int n0 = 0; n0 < D; n0 += 32) {
    float o[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[mt][nt][e] = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (j < ksteps) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int c = n0 + 16 * i;
          if (c + 16 <= D) {
            uint32_t b[4];
            ldsm_x4_trans(b, vr[j] + c);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              if (mt < mtiles) {
                mma_k16(o[mt][2 * i], pa[mt][j], b[0], b[1]);
                mma_k16(o[mt][2 * i + 1], pa[mt][j], b[2], b[3]);
              }
            }
          } else if (c < D) {  // the last 8 columns where d % 16 == 8
            uint32_t b0, b1;
            ldsm_x2_trans(b0, b1, vr[j] - ((lane >> 4) << 3) + c);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
              if (mt < mtiles) mma_k16(o[mt][2 * i], pa[mt][j], b0, b1);
          }
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int r0 = mt * 16 + g, r1 = r0 + 8;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = n0 + nt * 8 + 2 * t;
        if (mt < mtiles && n0 + nt * 8 < D) {
          if (r0 < F)
            *reinterpret_cast<uint32_t*>(q + r0 * rs + col) =
                pack_bf16x2(o[mt][nt][0], o[mt][nt][1]);
          if (r1 < F)
            *reinterpret_cast<uint32_t*>(q + r1 * rs + col) =
                pack_bf16x2(o[mt][nt][2], o[mt][nt][3]);
        }
      }
    }
  }
  // the frames' rows of o, D columns each, as 16-byte stores
  __syncwarp();
  constexpr int kPieces = D / 8;
  for (int i = lane; i < F * kPieces; i += 32) {
    const int f = i / kPieces, c = (i - f * kPieces) * 8;
    *reinterpret_cast<uint4*>(out + f * ldo + c) =
        *reinterpret_cast<const uint4*>(q + f * rs + c);
  }
}

// item -> batch, first position, positions present, first head
struct Item {
  int b, s0, np, h0;
};

__device__ __forceinline__ Item item_at(const Args& a, int item) {
  const int grp = item % a.n_groups, rest = item / a.n_groups;
  Item it;
  it.b = rest / a.n_pos;
  it.s0 = (rest % a.n_pos) * a.P;
  it.np = min(a.P, a.S - it.s0);
  it.h0 = grp * a.G;
  return it;
}

// global row of (frame f, position p) of an item
__device__ __forceinline__ long long row_of(const Args& a, const Item& it,
                                            int f, int p) {
  return (long long)(it.b * a.F + f) * a.S + it.s0 + p;
}

// the producer warp: for each item of this block, wait until the item's
// stage is free, then copy its spans in (lane 0 counts the bytes on the
// stage's `full` barrier; the lanes split the copies)
__device__ void produce(const Args& a, unsigned char* ring, uint64_t* full,
                        uint64_t* empty, int count, int lane) {
  const int C = a.H * a.d, cw = a.G * a.d;
  const int spans = a.G == a.H ? 1 : 3;  // copies a staged row
  const size_t stage_bytes = (size_t)a.P * a.F * a.rs * 2;
  for (int k = 0; k < count; ++k) {
    const int s = k % a.stages;
    // the stage held item k - stages: wait until its consumers release it
    if (k >= a.stages) mbar_wait(&empty[s], ((k - a.stages) / a.stages) & 1);
    __nv_bfloat16* st = reinterpret_cast<__nv_bfloat16*>(ring +
                                                         s * stage_bytes);
    const Item it = item_at(a, blockIdx.x + k * gridDim.x);
    if (lane == 0) mbar_expect_tx(&full[s], it.np * a.F * 3 * cw * 2);
    __syncwarp();
    // copy i: staged row r = p * F + f, span i % spans (q, k, v or all)
    for (int i = lane; i < it.np * a.F * spans; i += 32) {
      const int r = i / spans, seg = i - r * spans;
      const int p = r / a.F, f = r - p * a.F;
      bulk_load(st + r * a.rs + seg * cw,
                a.qkv + row_of(a, it, f, p) * 3 * C + seg * C + it.h0 * a.d,
                (3 / spans) * cw * 2, &full[s]);
    }
  }
}

// a consumer warp: the (position, head) problems j = p * G + head of each
// item, dealt to the warps in turn across items (warp w takes those with
// (k * per_item + j) % kConsumers == w), then a release of the stage
template <int D>
__device__ void consume(const Args& a, unsigned char* ring, uint64_t* full,
                        uint64_t* empty, int count, int warp, int lane) {
  const int C = a.H * D, cw = a.G * D, per_item = a.P * a.G;
  const size_t stage_bytes = (size_t)a.P * a.F * a.rs * 2;
  for (int k = 0; k < count; ++k) {
    const int s = k % a.stages;
    __nv_bfloat16* st = reinterpret_cast<__nv_bfloat16*>(ring +
                                                         s * stage_bytes);
    mbar_wait(&full[s], (k / a.stages) & 1);
    const Item it = item_at(a, blockIdx.x + k * gridDim.x);
    const int first = (warp - (k * per_item) % kConsumers + kConsumers) %
                      kConsumers;
    for (int j = first; j < per_item; j += kConsumers) {
      const int p = j / a.G;
      if (p >= it.np) break;
      const int col = (j - p * a.G) * D;
      __nv_bfloat16* base = st + p * a.F * a.rs + col;
      attend<D>(base, base + cw, base + 2 * cw,
                a.out + row_of(a, it, 0, p) * C + it.h0 * D + col,
                (long long)a.S * C, a.F, a.rs, a.scale_log2, lane);
    }
    // o went over q with generic stores; TMA writes the stage next
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1) tattn_kernel(const Args a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  unsigned char* ring = smem + kBarBytes;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(&full[s], 1);            // the producer's expect_tx arrival
      mbar_init(&empty[s], kConsumers);  // one release from each consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int count =
      (a.n_items - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  if (warp == kConsumers)
    produce(a, ring, full, empty, count, lane);
  else
    consume<D>(a, ring, full, empty, count, warp, lane);
}

using Kernel = void (*)(Args);

// the kernel of head width d, nullptr where there is none
Kernel kernel_for(int d) {
  switch (d) {
#define MIMO_TATTN_CASE(DD) \
  case DD:                  \
    return tattn_kernel<DD>;
    MIMO_TATTN_CASE(8) MIMO_TATTN_CASE(16) MIMO_TATTN_CASE(24)
    MIMO_TATTN_CASE(32) MIMO_TATTN_CASE(40) MIMO_TATTN_CASE(48)
    MIMO_TATTN_CASE(56) MIMO_TATTN_CASE(64) MIMO_TATTN_CASE(72)
    MIMO_TATTN_CASE(80) MIMO_TATTN_CASE(88) MIMO_TATTN_CASE(96)
    MIMO_TATTN_CASE(104) MIMO_TATTN_CASE(112) MIMO_TATTN_CASE(120)
    MIMO_TATTN_CASE(128) MIMO_TATTN_CASE(136) MIMO_TATTN_CASE(144)
    MIMO_TATTN_CASE(152) MIMO_TATTN_CASE(160)
#undef MIMO_TATTN_CASE
    default:
      return nullptr;
  }
}

}  // namespace

extern "C" {

// qkv (B*F*S, 3*H*d) -> out (B*F*S, H*d), both bf16 row-major, contiguous
// and 16-byte aligned. Needs 1 <= F <= 32, d % 8 == 0, d <= 160, and the
// plan of ops/temporal_attention.py::core_plan: `group` heads (a divisor of
// H) and `positions` positions an item, a staged row stride `row_stride`
// (a multiple of 8, at least 3 * group * d) and `stages` ring stages that
// fit one block. Returns a cudaError_t code.
int mimo_temporal_attention_fwd(const void* qkv, void* out, int B, int F,
                                int S, int H, int d, int group, int positions,
                                int row_stride, int stages, float scale_log2,
                                void* stream) {
  if (B < 1 || S < 1 || H < 1 || F < 1 || F > kMaxF || d < 8 || d % 8 ||
      d > kMaxD || group < 1 || H % group || positions < 1 ||
      positions > S || row_stride % 8 || row_stride < 3 * group * d ||
      stages < 2 || stages > kMaxStages)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = kBarBytes + (long long)stages * positions * F *
                                         row_stride * 2;
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.qkv = static_cast<const __nv_bfloat16*>(qkv);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.F = F;
  a.S = S;
  a.H = H;
  a.d = d;
  a.G = group;
  a.P = positions;
  a.rs = row_stride;
  a.stages = stages;
  a.n_pos = (S + positions - 1) / positions;
  a.n_groups = H / group;
  const long long items = (long long)B * a.n_pos * a.n_groups;
  if (items > (1ll << 30)) return static_cast<int>(cudaErrorInvalidValue);
  a.n_items = static_cast<int>(items);
  a.scale_log2 = scale_log2;
  const Kernel kernel = kernel_for(d);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = a.n_items < sms ? a.n_items : sms;
  void* args[] = {&a};
  err = cudaLaunchKernel(reinterpret_cast<const void*>(kernel), dim3(grid),
                         dim3(kThreads), args, static_cast<size_t>(smem),
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
