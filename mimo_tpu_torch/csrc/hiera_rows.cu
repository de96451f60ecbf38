// The elementwise chains between the products of a Hiera block
// (decomp/hiera.py::hiera_apply, SAM 2's image encoder) as bf16 row passes
// for Hopper (sm_90a), with fp32 only in registers:
// - hiera_bias_gelu_kernel: y = bf16(gelu_erf(bf16(p + b))) over fc1's
//   product p (rows, k), the 4C-wide hidden tensor;
// - hiera_bias_res_kernel<kMap>: y = bf16(res + bf16(p + b)) over fc2's or
//   proj_attn's product; with kMap, output row r reads row map(r) of the
//   windowed product (b * windows, ws * ws, k): the inverse of the window
//   partition, padding cropped (vit.py::_window_unpartition's permute).
// They replace no TPU kernel: the JAX package leaves these chains to XLA's
// fusions (mimo_tpu/decomp/hiera.py). The eager PyTorch chain they replace
// made fp32 copies of its bf16 inputs for LayerNorm and GELU, added the
// bias, the residual and the un-partition in passes of their own.
//
// Numerics are the eager chain's, equal in every bit: the bias added in
// fp32 and rounded to bf16 (PyTorch's bf16 add), then GELU in fp32 by
// PyTorch's own formula (ATen's GeluCUDAKernelImpl: x * 0.5 * (1 + erf(x *
// M_SQRT1_2)), rounded to bf16; or the residual added in fp32, rounded.
//
// What bounds them on an H100: HBM bytes, 4 (GELU) or 6 (bias + residual)
// bytes an element against ~30 or ~3 fp32 operations. The design: each
// thread moves kUnroll 16-byte vectors (8 bf16) spaced a block apart, all
// loads issued before any arithmetic, the products and residuals read once
// with streaming loads and the bias through the read-only cache. Vector
// indices are 32-bit (the entry refuses more than 2^31 - 1 vectors).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;   // vectors a thread

struct RowArgs {
  const __nv_bfloat16* p;      // the product, (rows, k) or windowed
  const __nv_bfloat16* bias;   // (k,)
  const __nv_bfloat16* res;    // (rows, k) or null
  __nv_bfloat16* y;            // (rows, k)
  unsigned nvec;               // rows * k / 8
  unsigned kv;                 // k / 8
  // the window map (kMap): output rows are (image, h < hgt, w < wid);
  // the windowed rows (image, window row, window col, ws, ws)
  unsigned hgt, wid, ws, win_rows, win_cols;
};

__device__ __forceinline__ float bf(float x) {  // round to bf16 and back
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void unpack8(const uint4& v, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return v;
}

// ATen's exact GELU in its opmath type (float), term for term
__device__ __forceinline__ float gelu_erf(float x) {
  constexpr float kAlpha = static_cast<float>(0.70710678118654752440);
  return x * 0.5f * (1.0f + erff(x * kAlpha));
}

// the windowed row that output row r reads
__device__ __forceinline__ unsigned window_row(const RowArgs& a, unsigned r) {
  const unsigned per_image = a.hgt * a.wid;
  const unsigned image = r / per_image;
  const unsigned rem = r - image * per_image;
  const unsigned h = rem / a.wid, w = rem - (rem / a.wid) * a.wid;
  const unsigned wh = h / a.ws, ww = w / a.ws;
  const unsigned window = (image * a.win_rows + wh) * a.win_cols + ww;
  return (window * a.ws + (h - wh * a.ws)) * a.ws + (w - ww * a.ws);
}

__global__ void __launch_bounds__(kThreads) hiera_bias_gelu_kernel(
    const RowArgs a) {
  const unsigned first = blockIdx.x * (kThreads * kUnroll) + threadIdx.x;
  const uint4* p = reinterpret_cast<const uint4*>(a.p);
  const uint4* bias = reinterpret_cast<const uint4*>(a.bias);
  uint4 pv[kUnroll], bv[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const unsigned v = first + u * kThreads;
    if (v < a.nvec) {
      pv[u] = __ldcs(p + v);
      bv[u] = __ldg(bias + v % a.kv);
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const unsigned v = first + u * kThreads;
    if (v >= a.nvec) break;
    float f[8], b[8];
    unpack8(pv[u], f);
    unpack8(bv[u], b);
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] = gelu_erf(bf(f[e] + b[e]));
    reinterpret_cast<uint4*>(a.y)[v] = pack8(f);
  }
}

template <bool kMap>
__global__ void __launch_bounds__(kThreads) hiera_bias_res_kernel(
    const RowArgs a) {
  const unsigned first = blockIdx.x * (kThreads * kUnroll) + threadIdx.x;
  const uint4* bias = reinterpret_cast<const uint4*>(a.bias);
  uint4 pv[kUnroll], rv[kUnroll], bv[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const unsigned v = first + u * kThreads;
    if (v < a.nvec) {
      const unsigned r = v / a.kv, j = v - r * a.kv;
      const unsigned src = kMap ? window_row(a, r) : r;
      pv[u] = __ldcs(reinterpret_cast<const uint4*>(
          a.p + (unsigned long long)src * a.kv * 8) + j);
      rv[u] = __ldcs(reinterpret_cast<const uint4*>(a.res) + v);
      bv[u] = __ldg(bias + j);
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const unsigned v = first + u * kThreads;
    if (v >= a.nvec) break;
    float f[8], b[8], r[8];
    unpack8(pv[u], f);
    unpack8(bv[u], b);
    unpack8(rv[u], r);
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] = r[e] + bf(f[e] + b[e]);
    reinterpret_cast<uint4*>(a.y)[v] = pack8(f);
  }
}

bool aligned(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

// the arguments of a (rows, k) pass, or false where the call is refused
bool row_args(const void* p, const void* bias, const void* res, void* y,
              long long rows, int k, RowArgs* a) {
  if (rows < 1 || k < 8 || k % 8 || rows * (k / 8) > 0x7fffffffLL ||
      !aligned(p) || !aligned(bias) || !aligned(y) ||
      (res != nullptr && !aligned(res)))
    return false;
  a->p = static_cast<const __nv_bfloat16*>(p);
  a->bias = static_cast<const __nv_bfloat16*>(bias);
  a->res = static_cast<const __nv_bfloat16*>(res);
  a->y = static_cast<__nv_bfloat16*>(y);
  a->nvec = static_cast<unsigned>(rows * (k / 8));
  a->kv = static_cast<unsigned>(k / 8);
  a->hgt = a->wid = a->ws = a->win_rows = a->win_cols = 0;
  return true;
}

unsigned blocks_for(unsigned nvec) {
  return (nvec + kThreads * kUnroll - 1) / (kThreads * kUnroll);
}

}  // namespace

extern "C" {

// y (rows, k) = bf16(gelu_erf(bf16(p + bias))), all bf16, contiguous and
// 16-byte aligned, k % 8 == 0. Returns a cudaError_t code.
int mimo_hiera_bias_gelu(const void* p, const void* bias, void* y,
                         long long rows, int k, void* stream) {
  RowArgs a;
  if (!row_args(p, bias, nullptr, y, rows, k, &a))
    return static_cast<int>(cudaErrorInvalidValue);
  hiera_bias_gelu_kernel<<<blocks_for(a.nvec), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// y (rows, k) = bf16(res + bf16(p + bias)), all bf16, contiguous and 16-byte
// aligned, k % 8 == 0. ws > 0: p is windowed, (rows / (hgt * wid) images x
// win_rows x win_cols windows, ws * ws rows a window), and output row
// (image, h, w) reads its window's row (h % ws, w % ws); hgt <= win_rows *
// ws and wid <= win_cols * ws (the padding is never read). Returns a
// cudaError_t code.
int mimo_hiera_bias_res(const void* p, const void* bias, const void* res,
                        void* y, long long rows, int k, int hgt, int wid,
                        int ws, int win_rows, int win_cols, void* stream) {
  RowArgs a;
  if (res == nullptr || !row_args(p, bias, res, y, rows, k, &a))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ws == 0) {
    hiera_bias_res_kernel<false><<<blocks_for(a.nvec), kThreads, 0, s>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  if (ws < 0 || hgt < 1 || wid < 1 || rows % ((long long)hgt * wid) ||
      (long long)hgt > (long long)win_rows * ws ||
      (long long)wid > (long long)win_cols * ws ||
      rows / ((long long)hgt * wid) * win_rows * win_cols * ws * ws >
          0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  a.hgt = hgt;
  a.wid = wid;
  a.ws = ws;
  a.win_rows = win_rows;
  a.win_cols = win_cols;
  hiera_bias_res_kernel<true><<<blocks_for(a.nvec), kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
