// GEMM-chain kernels for Hopper (sm_90a): out = epilogue(prologue(A) . W),
// bf16 operands, fp32 accumulation.
//
// Replaces the TPU kernels of mimo_tpu/ops/ffn.py — _ffn_pallas_nsc/_snc
// (LN -> up-projection -> GEGLU -> down-projection -> +residual),
// _qkv_ln_pallas/_snc (LN -> one (C, 3C) GEMM), _matmul_res_pallas/_snc
// (res + x.W + b) and _matmul_pallas/_snc (x.W + b) — and the two
// projection stages of mimo_tpu/ops/temporal_attention.py
// ::temporal_attention_fused (LN + PE -> q|k|v, out-projection + bias +
// residual). Two kernels serve all of them:
//
// - ln_rows_kernel, the prologue: LayerNorm of each A row (fp32
//   statistics, var = E[x^2] - E[x]^2, fp32 affine, rounded to bf16) with an
//   optional per-frame positional encoding added after the rounding (row r
//   belongs to frame (r / pe_div) % pe_frames), into a bf16 workspace;
// - gemm_kernel, the tile core, with its epilogue: + bias (optional),
//   + bias + residual, or GEGLU: the block's 128 tile columns are 64 value
//   columns and the 64 matching gate columns (weight columns j and
//   inner + j), and it writes h * gelu_erf(gate).
//
// Numerics follow the Pallas kernels: the product is rounded to bf16 before
// the bias; each following add and the gate multiply round to bf16; gelu is
// exact (erf) in fp32.
//
// What bounds it on an H100: the main path's shapes are tall (up to 301056
// rows) and narrow (K and N from 320 to 5120), so the work is tensor-core
// FLOPs over many row tiles with the weight (at most 26 MB) resident in L2.
// The design: one block of 8 warps per 128 x 128 output tile, each warp a
// 64 x 32 sub-tile of mma.sync m16n8k16; a 3-stage cp.async pipeline over
// 32-deep K tiles; A fragments by ldmatrix, B fragments by ldmatrix.trans
// straight from the row-major (K, N) weight; blocks of one row tile run
// next to each other so A is read from HBM about once. The epilogue stages
// the bf16 tile in shared memory and writes 16-byte vectors. wgmma and TMA
// are later work.
//
// The LN prologue is its own pass (one warp per row: one read of A, one
// write of the normalised rows) and not a step inside the tile core: done
// in the core, every column block normalised its A tiles again (8 to 80
// times over on the main path's N) and the pass held the tensor cores
// behind two barriers per K tile — the LN + QKV product at K = 320 took
// 1.9x the time of the product alone.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 32, kStages = 3, kThreads = 256;
constexpr int kAS = kBK + 8;  // A smem row stride (elements)
constexpr int kBS = kBN + 8;  // B smem row stride
constexpr int kCS = kBN + 8;  // output staging row stride
constexpr int kATile = kBM * kAS;
constexpr int kBTile = kBK * kBS;
constexpr int kStageElems = kATile + kBTile;
constexpr int kPipeBytes = kStages * kStageElems * 2;
constexpr int kSmemBytes = kPipeBytes;
static_assert(kBM * kCS * 2 <= kPipeBytes, "output staging fits the pipeline");

enum Epilogue { kEpiBias = 0, kEpiBiasRes = 1, kEpiGeglu = 2 };

struct GemmArgs {
  const __nv_bfloat16* a;
  const __nv_bfloat16* w;
  const __nv_bfloat16* bias;
  const __nv_bfloat16* res;
  __nv_bfloat16* out;
  long long lda, ldw, ldr, ldo;
  int m, n, k;
  int epilogue;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float bf(float x) {  // round to bf16 and back
  return __bfloat162float(__float2bfloat16_rn(x));
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

__device__ __forceinline__ uint4 ldg16(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// y = bf16(LN(x)) [+ pe] for each row of x (m, k), one warp per row:
// fp32 statistics with var = E[x^2] - E[x]^2 as in the Pallas kernels, then
// a second read of the row (from L1) to normalise it
__global__ void __launch_bounds__(256)
    ln_rows_kernel(const __nv_bfloat16* __restrict__ x, long long ldx, int m,
                   int k, const __nv_bfloat16* __restrict__ scale,
                   const __nv_bfloat16* __restrict__ bias, float eps,
                   const __nv_bfloat16* __restrict__ pe, int pe_div,
                   int pe_frames, __nv_bfloat16* __restrict__ y) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= m) return;
  const __nv_bfloat16* p = x + row * ldx;
  float s1 = 0.f, s2 = 0.f;
  for (int c = lane * 8; c < k; c += 32 * 8) {
    float f[8];
    unpack8(ldg16(p + c), f);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      s1 += f[e];
      s2 += f[e] * f[e];
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    s2 += __shfl_xor_sync(0xffffffffu, s2, o);
  }
  const float mean = s1 / k;
  const float inv = rsqrtf(s2 / k - mean * mean + eps);
  const __nv_bfloat16* pe_row =
      pe != nullptr ? pe + (long long)((row / pe_div) % pe_frames) * k
                    : nullptr;
  for (int c = lane * 8; c < k; c += 32 * 8) {
    float f[8], sc[8], bi[8];
    unpack8(ldg16(p + c), f);
    unpack8(ldg16(scale + c), sc);
    unpack8(ldg16(bias + c), bi);
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] = bf((f[e] - mean) * inv * sc[e] + bi[e]);
    if (pe_row != nullptr) {
      float q[8];
      unpack8(ldg16(pe_row + c), q);
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] += q[e];
    }
    *reinterpret_cast<uint4*>(y + (long long)row * k + c) = pack8(f);
  }
}

__global__ void __launch_bounds__(kThreads, 2) gemm_kernel(const GemmArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* pipe = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int m0 = blockIdx.y * kBM;
  const bool geglu = a.epilogue == kEpiGeglu;
  // output columns of this block: kBN, or kBN / 2 value columns for GEGLU
  const int n0 = blockIdx.x * (geglu ? kBN / 2 : kBN);
  const int kt_count = (a.k + kBK - 1) / kBK;

  // tile column c (a multiple of 8) -> weight column, or -1 past the edge
  auto weight_col = [&](int c) {
    if (!geglu) return n0 + c < a.n ? n0 + c : -1;
    const int j = c & (kBN / 2 - 1);
    if (n0 + j >= a.n) return -1;
    return (c >= kBN / 2 ? a.n : 0) + n0 + j;
  };

  auto load_tile = [&](int kt, int stage) {
    __nv_bfloat16* as = pipe + stage * kStageElems;
    __nv_bfloat16* bs = as + kATile;
    const int k0 = kt * kBK;
#pragma unroll
    for (int i = tid; i < kBM * kBK / 8; i += kThreads) {
      const int r = i / (kBK / 8), c = (i % (kBK / 8)) * 8;
      const bool ok = m0 + r < a.m && k0 + c < a.k;
      const __nv_bfloat16* src = ok ? a.a + (m0 + r) * a.lda + k0 + c : a.a;
      cp_async16(as + r * kAS + c, src, ok);
    }
#pragma unroll
    for (int i = tid; i < kBK * kBN / 8; i += kThreads) {
      const int r = i / (kBN / 8), c = (i % (kBN / 8)) * 8;
      const int wc = weight_col(c);
      const bool ok = k0 + r < a.k && wc >= 0;
      const __nv_bfloat16* src = ok ? a.w + (k0 + r) * a.ldw + wc : a.w;
      cp_async16(bs + r * kBS + c, src, ok);
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < kt_count) load_tile(s, s);
    cp_async_commit();
  }

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  for (int kt = 0; kt < kt_count; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int stage = kt % kStages;
    __nv_bfloat16* as = pipe + stage * kStageElems;
    const __nv_bfloat16* bs = as + kATile;

    const int nxt = kt + kStages - 1;
    if (nxt < kt_count) load_tile(nxt, nxt % kStages);
    cp_async_commit();

#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t af[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldmatrix_x4(af[i], as + (wm + i * 16 + (lane & 15)) * kAS + kk * 16 +
                               (lane >> 4) * 8);
      uint32_t bfr[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
        ldmatrix_x4_trans(bfr[j], bs + (kk * 16 + (lane & 15)) * kBS + wn +
                                      j * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_16816(acc[i][j], af[i], bfr[j >> 1][(j & 1) * 2],
                    bfr[j >> 1][(j & 1) * 2 + 1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // stage bf16(acc) — the dot product rounded as the Pallas kernels do
  __nv_bfloat16* cs = pipe;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = wm + i * 16 + g, c = wn + j * 8 + t * 2;
      *reinterpret_cast<__nv_bfloat162*>(cs + r * kCS + c) =
          __floats2bfloat162_rn(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<__nv_bfloat162*>(cs + (r + 8) * kCS + c) =
          __floats2bfloat162_rn(acc[i][j][2], acc[i][j][3]);
    }
  __syncthreads();

  if (geglu) {
    for (int i = tid; i < kBM * kBN / 16; i += kThreads) {
      const int r = i / (kBN / 16), c = (i % (kBN / 16)) * 8;
      const int gr = m0 + r, gc = n0 + c;
      if (gr >= a.m || gc >= a.n) continue;
      float h[8], gt[8], bh[8], bg[8], o[8];
      unpack8(*reinterpret_cast<const uint4*>(cs + r * kCS + c), h);
      unpack8(*reinterpret_cast<const uint4*>(cs + r * kCS + kBN / 2 + c), gt);
      unpack8(ldg16(a.bias + gc), bh);
      unpack8(ldg16(a.bias + a.n + gc), bg);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float up_h = bf(h[e] + bh[e]);
        const float up_g = bf(gt[e] + bg[e]);
        const float gel = 0.5f * up_g * (1.f + erff(up_g * 0.7071067811865476f));
        o[e] = up_h * bf(gel);
      }
      *reinterpret_cast<uint4*>(a.out + gr * a.ldo + gc) = pack8(o);
    }
    return;
  }
  for (int i = tid; i < kBM * kBN / 8; i += kThreads) {
    const int r = i / (kBN / 8), c = (i % (kBN / 8)) * 8;
    const int gr = m0 + r, gc = n0 + c;
    if (gr >= a.m || gc >= a.n) continue;
    float y[8];
    unpack8(*reinterpret_cast<const uint4*>(cs + r * kCS + c), y);
    if (a.bias != nullptr) {
      float b[8];
      unpack8(ldg16(a.bias + gc), b);
#pragma unroll
      for (int e = 0; e < 8; ++e) y[e] = bf(y[e] + b[e]);
    }
    if (a.epilogue == kEpiBiasRes) {
      float rv[8];
      unpack8(ldg16(a.res + gr * a.ldr + gc), rv);
#pragma unroll
      for (int e = 0; e < 8; ++e) y[e] += rv[e];
    }
    *reinterpret_cast<uint4*>(a.out + gr * a.ldo + gc) = pack8(y);
  }
}

}  // namespace

extern "C" {

// out (m, n) = epilogue(prologue(a (m, k)) . w (k, n or 2n)). Returns a
// cudaError_t code (0 on success). ln_scale == nullptr: no prologue;
// otherwise ln_out is an (m, k) bf16 workspace that receives the normalised
// rows, and the product reads it. pe may be nullptr. epilogue: 0 = + bias
// (bias may be nullptr), 1 = + bias + res, 2 = GEGLU over w's
// [value | gate] column halves.
int mimo_gemm_fwd(const void* a, long long lda, const void* w, long long ldw,
                  const void* bias, const void* res, long long ldr, void* out,
                  long long ldo, int m, int n, int k, const void* ln_scale,
                  const void* ln_bias, void* ln_out, float eps,
                  const void* pe, int pe_div, int pe_frames, int epilogue,
                  void* stream) {
  if (m < 1 || n < 1 || k < 1 || n % 8 || k % 8 || lda % 8 || ldw % 8 ||
      ldo % 8 || ldr % 8 || epilogue < 0 || epilogue > 2 ||
      (epilogue == kEpiGeglu && bias == nullptr) ||
      (epilogue == kEpiBiasRes && res == nullptr) ||
      (ln_scale != nullptr && (ln_bias == nullptr || ln_out == nullptr)) ||
      (pe != nullptr && (ln_scale == nullptr || pe_div < 1 || pe_frames < 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ln_scale != nullptr) {
    ln_rows_kernel<<<(m + 7) / 8, 256, 0, st>>>(
        static_cast<const __nv_bfloat16*>(a), lda, m, k,
        static_cast<const __nv_bfloat16*>(ln_scale),
        static_cast<const __nv_bfloat16*>(ln_bias), eps,
        static_cast<const __nv_bfloat16*>(pe), pe_div, pe_frames,
        static_cast<__nv_bfloat16*>(ln_out));
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    a = ln_out;
    lda = k;
  }
  GemmArgs g;
  g.a = static_cast<const __nv_bfloat16*>(a);
  g.w = static_cast<const __nv_bfloat16*>(w);
  g.bias = static_cast<const __nv_bfloat16*>(bias);
  g.res = static_cast<const __nv_bfloat16*>(res);
  g.out = static_cast<__nv_bfloat16*>(out);
  g.lda = lda; g.ldw = ldw; g.ldr = ldr; g.ldo = ldo;
  g.m = m; g.n = n; g.k = k;
  g.epilogue = epilogue;
  const cudaError_t e = cudaFuncSetAttribute(
      gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int cols = epilogue == kEpiGeglu ? kBN / 2 : kBN;
  const dim3 grid((n + cols - 1) / cols, (m + kBM - 1) / kBM);
  gemm_kernel<<<grid, kThreads, kSmemBytes, st>>>(g);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
