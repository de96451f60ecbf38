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
// past the key edge). wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 128;  // query rows per block (8 warps x 16 rows)
constexpr int kBlockK = 64;   // keys per shared-memory tile
constexpr int kThreads = 256;

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

// 16-byte global -> shared copy; with pred false it writes 16 zero bytes
// and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(pred ? 16 : 0));
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
};

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

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const FlashArgs a) {
  using S = FlashShape<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
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
    const __nv_bfloat16* kp =
        (self ? a.k + b * a.k_bs : a.kb + b * a.kb_bs) + k0 * kss + col0;
    const __nv_bfloat16* vp =
        (self ? a.v + b * a.v_bs : a.vb + b * a.vb_bs) + k0 * vss + col0;
    const int valid = valid_keys(it);
    __nv_bfloat16* kd = kvs + (2 * buf) * S::kTile;
    __nv_bfloat16* vd = kd + S::kTile;
    for (int i = tid; i < kBlockK * S::kVecs; i += kThreads) {
      const int r = i / S::kVecs, cv = i % S::kVecs;
      const bool ok = r < valid && cv * 8 < D;
      cp_async16(kd + r * S::kStride + cv * 8, ok ? kp + r * kss + cv * 8 : kp, ok);
      cp_async16(vd + r * S::kStride + cv * 8, ok ? vp + r * vss + cv * 8 : vp, ok);
    }
  };

  load_tile(0, 0);
  cp_async_commit();

  // Q tile -> smem, zero past Sq and past d
  const __nv_bfloat16* qg = a.q + b * a.q_bs + col0;
  for (int i = tid; i < kBlockQ * S::kVecs; i += kThreads) {
    const int r = i / S::kVecs, cv = i % S::kVecs;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < a.sq && cv * 8 < D)
      val = *reinterpret_cast<const uint4*>(qg + (q0 + r) * a.q_ss + cv * 8);
    *reinterpret_cast<uint4*>(qs + r * S::kStride + cv * 8) = val;
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
    const __nv_bfloat16* ks = kvs + (2 * buf) * S::kTile;
    const __nv_bfloat16* vs = ks + S::kTile;

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[kBlockK / 8][4];
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const __nv_bfloat16* kp = ks + (j * 8 + g) * S::kStride + t * 2;
#pragma unroll
      for (int kc = 0; kc < S::kKC; ++kc)
        mma_16816(s[j], qf[kc], ld32(kp + kc * 16), ld32(kp + kc * 16 + 8));
    }

    // scale into the exp2 domain, mask the ragged key edge, row max
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = j * 8 + t * 2 + e < valid;
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
    // every tile holds >= 1 valid key, so the new max is finite
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
      s[j][0] = exp2f(s[j][0] - mn0);
      s[j][1] = exp2f(s[j][1] - mn0);
      s[j][2] = exp2f(s[j][2] - mn1);
      s[j][3] = exp2f(s[j][3] - mn1);
      rs0 += s[j][0] + s[j][1];
      rs1 += s[j][2] + s[j][3];
    }
    l0 = l0 * al0 + rs0;  // per-thread partial sums; the quad sums at the end
    l1 = l1 * al1 + rs1;
#pragma unroll
    for (int n = 0; n < S::kND; ++n) {
      acc[n][0] *= al0;
      acc[n][1] *= al0;
      acc[n][2] *= al1;
      acc[n][3] *= al1;
    }

    // O += P V: the S accumulator layout of two 8-key tiles is the A
    // fragment layout of one 16-key chunk
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16x2(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const __nv_bfloat16* vrow = vs + (kk * 16 + (lane & 15)) * S::kStride;
#pragma unroll
      for (int n = 0; n < S::kND; ++n) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, vrow + n * 8);
        mma_16816(acc[n], pa, b0, b1);
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
