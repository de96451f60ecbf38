// Temporal (frame-axis) attention core for Hopper (sm_90a): for every batch
// b, spatial position s and head h, an F x F softmax attention over the
// frames, F <= 32, bf16 in and out, fp32 logits and softmax.
//
// With the GEMM tile core of gemm.cu it replaces the TPU kernel
// mimo_tpu/ops/temporal_attention.py::temporal_attention_fused
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
// What bounds it on an H100: each (b, s, h) is a tiny problem (24 x 24 x d
// with d = 40, 80 or 160), about 2 F^2 d FLOPs per 3 F d loaded values, so
// the kernel is bound by reading qkv once (up to 578 MB at UNet level 0).
// The design: one warp per (b, s, h), four warps per block on neighbouring
// positions; the block stages the F rows of q, k and v of its four
// positions in shared memory with 16-byte cp.async copies, all issued
// before the first wait; lane i then computes the logits and the softmax of
// query frame i in registers, and the lanes split the head dimension for
// P.V. No tensor cores: the products are shorter than one mma tile along
// F, so this version is bound by instruction issue (each k and v element
// is converted from bf16 by every lane that reads it), not by memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxF = 32, kWarps = 4;

// shared memory of one warp: q, k, v rows (stride d + 8, 16-byte aligned)
// and the F x (F + 1) softmax weights, rounded up to 16 bytes
__host__ __device__ inline size_t warp_smem_bytes(int F, int d) {
  const size_t bytes = (size_t)3 * F * (d + 8) * sizeof(__nv_bfloat16) +
                       (size_t)F * (F + 1) * sizeof(float);
  return (bytes + 15) / 16 * 16;
}

__global__ void __launch_bounds__(kWarps * 32)
    tattn_kernel(const __nv_bfloat16* __restrict__ qkv,
                 __nv_bfloat16* __restrict__ out, int F, int S, int H, int d,
                 float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int s0 = blockIdx.x * kWarps;
  const int h = blockIdx.y, b = blockIdx.z;
  const int C = H * d, dp = d + 8, d8 = d / 8;
  const long long ld = 3LL * C;
  const size_t wbytes = warp_smem_bytes(F, d);

  // stage q, k, v of the block's positions: F rows x 3 segments x d / 8
  // chunks of 16 bytes per position
  const int per_warp = F * 3 * d8;
  for (int i = threadIdx.x; i < kWarps * per_warp; i += kWarps * 32) {
    const int w = i / per_warp, rem = i % per_warp;
    const int f = rem / (3 * d8), seg = (rem / d8) % 3, c = rem % d8;
    if (s0 + w >= S) continue;
    const __nv_bfloat16* src = qkv +
                               ((long long)(b * F + f) * S + s0 + w) * ld +
                               seg * C + h * d + c * 8;
    __nv_bfloat16* dst =
        reinterpret_cast<__nv_bfloat16*>(smem_raw + w * wbytes) +
        (seg * F + f) * dp + c * 8;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     static_cast<unsigned>(__cvta_generic_to_shared(dst))),
                 "l"(src));
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
  const int s = s0 + warp;
  if (s >= S) return;
  __nv_bfloat16* qs =
      reinterpret_cast<__nv_bfloat16*>(smem_raw + warp * wbytes);
  __nv_bfloat16* ks = qs + F * dp;
  __nv_bfloat16* vs = ks + F * dp;
  float* ps = reinterpret_cast<float*>(vs + F * dp);
  const int d2 = d / 2;

  // lane i < F: logits of query frame i against every key frame, softmax
  if (lane < F) {
    float lg[kMaxF];
#pragma unroll
    for (int j = 0; j < kMaxF; ++j) lg[j] = 0.f;
    const __nv_bfloat162* qrow =
        reinterpret_cast<const __nv_bfloat162*>(qs + lane * dp);
    for (int e = 0; e < d2; ++e) {
      const float2 qv = __bfloat1622float2(qrow[e]);
#pragma unroll
      for (int j = 0; j < kMaxF; ++j) {
        if (j < F) {
          const float2 kv = __bfloat1622float2(
              reinterpret_cast<const __nv_bfloat162*>(ks + j * dp)[e]);
          lg[j] = fmaf(qv.x, kv.x, fmaf(qv.y, kv.y, lg[j]));
        }
      }
    }
    float m = lg[0] * scale_log2;
#pragma unroll
    for (int j = 0; j < kMaxF; ++j)
      if (j < F) m = fmaxf(m, lg[j] * scale_log2);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxF; ++j) {
      if (j < F) {
        lg[j] = exp2f(lg[j] * scale_log2 - m);
        sum += lg[j];
      }
    }
    const float inv = 1.f / sum;
#pragma unroll
    for (int j = 0; j < kMaxF; ++j)
      if (j < F)
        ps[lane * (F + 1) + j] =
            __bfloat162float(__float2bfloat16_rn(lg[j] * inv));
  }
  __syncwarp();

  // P.V: the lanes split the head dimension, two columns a lane
  for (int i = 0; i < F; ++i) {
    __nv_bfloat16* orow =
        out + ((long long)(b * F + i) * S + s) * C + h * d;
    for (int e = lane; e < d2; e += 32) {
      float a0 = 0.f, a1 = 0.f;
      for (int j = 0; j < F; ++j) {
        const float p = ps[i * (F + 1) + j];
        const float2 v = __bfloat1622float2(
            reinterpret_cast<const __nv_bfloat162*>(vs + j * dp)[e]);
        a0 = fmaf(p, v.x, a0);
        a1 = fmaf(p, v.y, a1);
      }
      reinterpret_cast<__nv_bfloat162*>(orow)[e] = __floats2bfloat162_rn(a0, a1);
    }
  }
}

}  // namespace

extern "C" {

// qkv (B*F*S, 3*H*d) -> out (B*F*S, H*d), both bf16 row-major, contiguous
// and 16-byte aligned. Needs 1 <= F <= 32 and d % 8 == 0. Returns a
// cudaError_t code.
int mimo_temporal_attention_fwd(const void* qkv, void* out, int B, int F,
                                int S, int H, int d, float scale_log2,
                                void* stream) {
  if (B < 1 || S < 1 || H < 1 || F < 1 || F > kMaxF || d < 8 || d % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = kWarps * warp_smem_bytes(F, d);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        tattn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((S + kWarps - 1) / kWarps, H, B);
  tattn_kernel<<<grid, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<__nv_bfloat16*>(out),
      F, S, H, d, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
