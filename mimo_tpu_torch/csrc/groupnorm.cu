// Fused GroupNorm(+row add, +SiLU) for Hopper (sm_90a), bf16 or fp32
// activations over an (N, S, C) tensor, G groups of C/G channels.
//
// Replaces the three TPU variants in mimo_tpu/ops/groupnorm.py:
// _gn_pallas_snc (_gn_snc_kernel), _gn_pallas resident (_gn_kernel) and
// _gn_pallas two-phase (_gn2_kernel). One design serves all sizes, from the
// UNet's (48, 6272, 320) to the VAE's full-resolution (8, 401408, 128):
//
//   1. gn_stats_kernel: grid (channel tiles, S-chunks, N). Each block sums
//      x + row_add and its square in fp32 over its rows, per channel, and
//      writes one partial per (n, chunk, channel). Threads of one block
//      combine in a fixed order, so the partials are deterministic.
//   2. gn_finalize_kernel: one block per n sums the partials of each group
//      over chunks and channels in a fixed order, takes
//      var = E[x^2] - E[x]^2 in fp32 (as the TPU kernel and
//      mimo_tpu/models/layers.py do), and folds mean, rsqrt(var + eps), the
//      affine and the row add into per-channel mul/add.
//   3. gn_apply_kernel: y = x * mul + add, optional SiLU in fp32, one store.
//
// What bounds it on an H100: no matrix product, 2 reads and 1 write of the
// activation, so HBM bandwidth (3.35 TB/s). The design reads and writes
// 16 bytes a thread with neighbouring threads on neighbouring channels, and
// sizes the S-chunks so that about four blocks per SM are in flight.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&f)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void store8(float* p, const float (&f)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

// part: (N, nchunk, 2, C) fp32 -- per-chunk channel sums and sums of squares
template <typename T>
__global__ void __launch_bounds__(kThreads) gn_stats_kernel(
    const T* __restrict__ x, const float* __restrict__ radd,
    float* __restrict__ part, int S, int C, int rows_per_chunk, int tx) {
  const int n = blockIdx.z, chunk = blockIdx.y, nchunk = gridDim.y;
  const int ty = kThreads / tx;
  const int lx = threadIdx.x % tx, ly = threadIdx.x / tx;
  const int cv = blockIdx.x * tx + lx;
  const bool active = ly < ty && cv * 8 < C;
  float s[8], q[8], r[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = q[i] = r[i] = 0.f;
  if (active) {
    if (radd != nullptr) load8(radd + (size_t)n * C + cv * 8, r);
    const int r0 = chunk * rows_per_chunk;
    const int r1 = min(S, r0 + rows_per_chunk);
    const T* base = x + (size_t)n * S * C + cv * 8;
    for (int row = r0 + ly; row < r1; row += ty) {
      float f[8];
      load8(base + (size_t)row * C, f);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float v = f[i] + r[i];
        s[i] += v;
        q[i] += v * v;
      }
    }
  }
  __shared__ float red[kThreads * 16];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    red[threadIdx.x * 16 + i] = s[i];
    red[threadIdx.x * 16 + 8 + i] = q[i];
  }
  __syncthreads();
  if (ly == 0 && active) {
    for (int y = 1; y < ty; ++y) {
      const float* o = red + (y * tx + lx) * 16;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        s[i] += o[i];
        q[i] += o[8 + i];
      }
    }
    float* ps = part + ((size_t)n * nchunk + chunk) * 2 * C + cv * 8;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      ps[i] = s[i];
      ps[C + i] = q[i];
    }
  }
}

// coef: (N, 2, C) fp32 -- per-channel mul and add, row add folded in
__global__ void gn_finalize_kernel(const float* __restrict__ part,
                                   const float* __restrict__ radd,
                                   const float* __restrict__ scale,
                                   const float* __restrict__ bias,
                                   float* __restrict__ coef, int S, int C,
                                   int G, int nchunk, float eps) {
  extern __shared__ float stat[];  // [G] mean, [G] rsqrt(var + eps)
  const int n = blockIdx.x;
  const int cpg = C / G;
  const float cnt = (float)S * (float)cpg;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    float sum = 0.f, sq = 0.f;
    for (int ch = 0; ch < nchunk; ++ch) {
      const float* ps = part + ((size_t)n * nchunk + ch) * 2 * C + g * cpg;
      for (int c = 0; c < cpg; ++c) {
        sum += ps[c];
        sq += ps[C + c];
      }
    }
    const float mean = sum / cnt;
    const float var = sq / cnt - mean * mean;
    stat[g] = mean;
    stat[G + g] = rsqrtf(var + eps);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const int g = c / cpg;
    const float mul = stat[G + g] * scale[c];
    float add = bias[c] - stat[g] * mul;
    if (radd != nullptr) add += radd[(size_t)n * C + c] * mul;
    coef[(size_t)n * 2 * C + c] = mul;
    coef[((size_t)n * 2 + 1) * C + c] = add;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) gn_apply_kernel(
    const T* __restrict__ x, const float* __restrict__ coef, T* __restrict__ y,
    long long total_vecs, long long sc, int C, int silu) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total_vecs; i += (long long)gridDim.x * blockDim.x) {
    const long long e = i * 8;
    const long long n = e / sc;
    const int c = (int)(e % C);
    float f[8], mul[8], add[8];
    load8(x + e, f);
    load8(coef + n * 2 * C + c, mul);
    load8(coef + (n * 2 + 1) * C + c, add);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float v = f[j] * mul[j] + add[j];
      if (silu) v = v / (1.f + expf(-v));
      f[j] = v;
    }
    store8(y + e, f);
  }
}

template <typename T>
cudaError_t launch_gn(const T* x, const float* radd, const float* scale,
                      const float* bias, T* y, float* part, float* coef,
                      int N, int S, int C, int G, int nchunk,
                      int rows_per_chunk, float eps, int silu,
                      cudaStream_t stream) {
  const int cvecs = C / 8;
  const int tx = cvecs < kThreads ? cvecs : kThreads;
  const dim3 sgrid((cvecs + tx - 1) / tx, nchunk, N);
  gn_stats_kernel<T><<<sgrid, kThreads, 0, stream>>>(x, radd, part, S, C,
                                                     rows_per_chunk, tx);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  gn_finalize_kernel<<<N, kThreads, 2 * G * sizeof(float), stream>>>(
      part, radd, scale, bias, coef, S, C, G, nchunk, eps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long total_vecs = (long long)N * S * C / 8;
  long long blocks = (total_vecs + kThreads - 1) / kThreads;
  if (blocks > 132LL * 16) blocks = 132LL * 16;
  gn_apply_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      x, coef, y, total_vecs, (long long)S * C, C, silu);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. radd may be null. part holds
// N * nchunk * 2 * C floats, coef N * 2 * C floats. Returns a cudaError_t.
int mimo_group_norm_fwd(const void* x, const void* radd, const void* scale,
                        const void* bias, void* y, void* part, void* coef,
                        int dtype, int N, int S, int C, int G, int nchunk,
                        int rows_per_chunk, float eps, int silu, void* stream) {
  if (C % 8 != 0 || C % G != 0 || nchunk < 1 || rows_per_chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ra = static_cast<const float*>(radd);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  float* pa = static_cast<float*>(part);
  float* co = static_cast<float*>(coef);
  if (dtype == 1)
    return static_cast<int>(launch_gn<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(x), ra, sc, bi,
        static_cast<__nv_bfloat16*>(y), pa, co, N, S, C, G, nchunk,
        rows_per_chunk, eps, silu, st));
  if (dtype == 0)
    return static_cast<int>(launch_gn<float>(
        static_cast<const float*>(x), ra, sc, bi, static_cast<float*>(y), pa,
        co, N, S, C, G, nchunk, rows_per_chunk, eps, silu, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
