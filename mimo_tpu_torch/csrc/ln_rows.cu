// The LayerNorm row pass for Hopper (sm_90a): y = bf16(LN(x)) [+ pe] for
// each row of a bf16 (m, k) matrix with row stride ldx, into a contiguous
// bf16 (m, k) workspace. It is the prologue of the GEMM tile core
// (csrc/gemm.cu) for LN + q|k|v, LN + GEGLU and the temporal LN + PE, and
// replaces the LayerNorm at the head of the TPU kernels of
// mimo_tpu/ops/ffn.py (_qkv_ln_pallas :245, _ffn_pallas_nsc :161, their
// SNC twins) and mimo_tpu/ops/temporal_attention.py (_tattn_kernel, :212).
//
// Numerics: fp32 statistics with var = E[x^2] - E[x]^2 as the Pallas
// kernels take them, the affine in fp32, the result rounded to bf16 and
// only then the PE added (rounded again), as _tattn_kernel does. Row r
// takes PE row (r / pe_div) % pe_frames.
//
// What bounds it on an H100: one read of x and one write of y, ~8 fp32
// operations an element, so HBM bytes (3.35 TB/s). The design:
// - a row lives in registers, so x is read once: `L` lanes share a row,
//   each holding V 16-byte vectors (lane l of the row: vectors l, l + L,
//   ..., so L lanes read L neighbouring vectors). ops/ffn.py::ln_rows_plan
//   picks L in {8, 16, 32} and V <= 6 with L * V covering K/8 with the
//   fewest idle slots: K = 320 is 8 lanes x 5 vectors (four rows a warp),
//   640 is 16 x 5, 1280 is 32 x 5, none idle. The statistics reduce over
//   the row's lanes with sub-warp shuffles;
// - a warp walks a contiguous range of row steps with the next step's rows
//   loaded before this step's are normalised (2 x 8 warps an SM keep
//   ~80 KB of loads in flight at K = 320), the PE frame stepped from row to
//   row instead of divided. The registers go to the row and its prefetch:
//   scale and bias sit in shared memory, loaded once a block, and the row
//   groups of a warp read the same 16-byte vectors of them (a broadcast);
// - rows wider than 32 x 6 vectors (K > 1536, never on the main path) and
//   calls of a few row steps a warp (UNet levels 2-3: 5-19k rows, where the
//   register kernel's two blocks an SM hold too few rows in flight and a
//   run is too short for its prefetch) take ln_rows_wide_kernel: a warp a
//   row, few registers, so many blocks an SM; the row is read from HBM once
//   and again from L1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // ln_rows_plan: LN_WARPS warps a block

struct LnArgs {
  const __nv_bfloat16* x;
  long long ldx;
  int m, k;
  const __nv_bfloat16* scale;
  const __nv_bfloat16* bias;
  float eps;
  const __nv_bfloat16* pe;     // (pe_frames, k) or null
  int pe_div, pe_frames;
  __nv_bfloat16* y;
  int steps_per_warp;
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

__device__ __forceinline__ uint4 ldg16(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// normalise one row (fp32 statistics mean / inv) into y; pe_row may be null
__device__ __forceinline__ void ln_store(const float (&f)[8], float mean,
                                         float inv, const uint4& sc,
                                         const uint4& bi,
                                         const __nv_bfloat16* pe_row,
                                         __nv_bfloat16* dst) {
  float s[8], b[8], o[8];
  unpack8(sc, s);
  unpack8(bi, b);
#pragma unroll
  for (int e = 0; e < 8; ++e) o[e] = bf((f[e] - mean) * inv * s[e] + b[e]);
  if (pe_row != nullptr) {
    float q[8];
    unpack8(ldg16(pe_row), q);
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] += q[e];
  }
  *reinterpret_cast<uint4*>(dst) = pack8(o);
}

// the V vectors of row `row` this lane holds (zero past m or past K)
template <int L, int V>
__device__ __forceinline__ void load_row(const LnArgs& a, long long row,
                                         int sub, int vecs, uint4 (&v)[V]) {
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int j = sub + L * i;
    v[i] = make_uint4(0, 0, 0, 0);
    if (row < a.m && j < vecs)
      v[i] = __ldcs(reinterpret_cast<const uint4*>(a.x + row * a.ldx + 8 * j));
  }
}

template <int L, int V>
__global__ void __launch_bounds__(kThreads, 2) ln_rows_kernel(const LnArgs a) {
  constexpr int kRows = 32 / L;  // rows a warp step
  // scale, then bias: L * V vectors each (zero past K)
  __shared__ uint4 vec_smem[2 * L * V];
  const int lane = threadIdx.x & 31, sub = lane % L;
  const int vecs = a.k / 8;
  for (int j = threadIdx.x; j < L * V; j += kThreads) {
    const bool in = j < vecs;
    vec_smem[j] = in ? ldg16(a.scale + 8 * j) : make_uint4(0, 0, 0, 0);
    vec_smem[L * V + j] = in ? ldg16(a.bias + 8 * j) : make_uint4(0, 0, 0, 0);
  }
  __syncthreads();
  const long long warp =
      (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const long long steps = (a.m + kRows - 1) / kRows;
  long long step = warp * a.steps_per_warp;
  const long long end = min(step + a.steps_per_warp, steps);
  if (step >= end) return;  // the whole warp
  long long row = step * kRows + lane / L;
  // the PE frame of `row`, and its place in the frame: divided once, then
  // stepped
  int frame = 0, rem = 0;
  if (a.pe != nullptr) {
    frame = (int)((row / a.pe_div) % a.pe_frames);
    rem = (int)(row % a.pe_div);
  }
  const float inv_k = 1.f / (float)a.k;
  uint4 cur[V];
  load_row<L, V>(a, row, sub, vecs, cur);
  for (; step < end; ++step, row += kRows) {
    uint4 nxt[V];
    load_row<L, V>(a, step + 1 < end ? row + kRows : a.m, sub, vecs, nxt);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float f[8];
      unpack8(cur[i], f);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        s1 += f[e];
        s2 += f[e] * f[e];
      }
    }
#pragma unroll
    for (int o = L / 2; o > 0; o >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    const float mean = s1 * inv_k;
    const float inv = rsqrtf(s2 * inv_k - mean * mean + a.eps);
    if (row < a.m) {
      const __nv_bfloat16* pe_row =
          a.pe != nullptr ? a.pe + (long long)frame * a.k : nullptr;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int j = sub + L * i;
        if (j >= vecs) continue;
        float f[8];
        unpack8(cur[i], f);
        ln_store(f, mean, inv, vec_smem[j], vec_smem[L * V + j],
                 pe_row != nullptr ? pe_row + 8 * j : nullptr,
                 a.y + row * a.k + 8 * j);
      }
    }
    if (a.pe != nullptr) {
      rem += kRows;
      while (rem >= a.pe_div) {
        rem -= a.pe_div;
        if (++frame == a.pe_frames) frame = 0;
      }
    }
#pragma unroll
    for (int i = 0; i < V; ++i) cur[i] = nxt[i];
  }
}

// rows wider than the register plan: a warp a row, the row read twice
__global__ void __launch_bounds__(kThreads) ln_rows_wide_kernel(const LnArgs a) {
  const long long row =
      (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= a.m) return;
  const __nv_bfloat16* p = a.x + row * a.ldx;
  float s1 = 0.f, s2 = 0.f;
  for (int c = lane * 8; c < a.k; c += 32 * 8) {
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
  const float inv_k = 1.f / (float)a.k;
  const float mean = s1 * inv_k;
  const float inv = rsqrtf(s2 * inv_k - mean * mean + a.eps);
  const __nv_bfloat16* pe_row =
      a.pe != nullptr
          ? a.pe + (long long)((row / a.pe_div) % a.pe_frames) * a.k
          : nullptr;
  for (int c = lane * 8; c < a.k; c += 32 * 8) {
    float f[8];
    unpack8(ldg16(p + c), f);
    ln_store(f, mean, inv, ldg16(a.scale + c), ldg16(a.bias + c),
             pe_row != nullptr ? pe_row + c : nullptr, a.y + row * a.k + c);
  }
}

using Kernel = void (*)(LnArgs);

template <int L>
Kernel pick(int vectors) {
  switch (vectors) {
    case 1: return ln_rows_kernel<L, 1>;
    case 2: return ln_rows_kernel<L, 2>;
    case 3: return ln_rows_kernel<L, 3>;
    case 4: return ln_rows_kernel<L, 4>;
    case 5: return ln_rows_kernel<L, 5>;
    case 6: return ln_rows_kernel<L, 6>;
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// y (m, k) = bf16(LN(x)) [+ pe[(r / pe_div) % pe_frames]] of x (m, k) with
// row stride ldx, all bf16; pe may be null. The plan (lanes a row, vectors a
// lane, row steps a warp, blocks) comes from ops/ffn.py::ln_rows_plan;
// vectors == 0 takes the wide-row kernel (blocks of 8 rows). Returns a
// cudaError_t code.
int mimo_ln_rows_fwd(const void* x, long long ldx, int m, int k,
                     const void* scale, const void* bias, float eps,
                     const void* pe, int pe_div, int pe_frames, void* y,
                     int lanes, int vectors, int steps_per_warp, int blocks,
                     void* stream) {
  if (m < 1 || k < 8 || k % 8 || ldx < k || ldx % 8 || blocks < 1 ||
      (pe != nullptr && (pe_div < 1 || pe_frames < 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  LnArgs a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.ldx = ldx;
  a.m = m;
  a.k = k;
  a.scale = static_cast<const __nv_bfloat16*>(scale);
  a.bias = static_cast<const __nv_bfloat16*>(bias);
  a.eps = eps;
  a.pe = static_cast<const __nv_bfloat16*>(pe);
  a.pe_div = pe_div;
  a.pe_frames = pe_frames;
  a.y = static_cast<__nv_bfloat16*>(y);
  a.steps_per_warp = steps_per_warp;
  Kernel kernel = nullptr;
  if (vectors == 0)
    kernel = ln_rows_wide_kernel;
  else if (lanes == 8)
    kernel = pick<8>(vectors);
  else if (lanes == 16)
    kernel = pick<16>(vectors);
  else if (lanes == 32)
    kernel = pick<32>(vectors);
  if (kernel == nullptr || (vectors > 0 && steps_per_warp < 1) ||
      (long long)lanes * vectors * 8 < (vectors > 0 ? k : 0))
    return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
