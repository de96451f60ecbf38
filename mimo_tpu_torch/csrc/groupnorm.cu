// Fused GroupNorm(+row add, +SiLU) for Hopper (sm_90a), bf16 or fp32
// activations over an (N, S, C) tensor, G groups of C/G channels.
//
// Replaces the three TPU variants in mimo_tpu/ops/groupnorm.py:
// _gn_pallas_snc (:221), _gn_pallas resident (:275) and _gn_pallas
// two-phase (:298).
//
// What bounds it on an H100: no matrix product and ~10 fp32 operations an
// element, so HBM bytes (3.35 TB/s). The least it must move is one read and
// one write of x. The statistics of a (batch row n, group) need all of its
// S rows before any row can be normalised, so x is read once only where
// those rows stay on chip until the statistics are known. Two tiers, one
// launch a call each; ops/groupnorm.py::gn_plan picks:
//
// RESIDENT (gn_resident_kernel), where the slice of a batch row and a chunk
// of whole groups fits the shared memory of a cluster of <= 8 blocks of
// <= 48 KB each (UNet levels 1-3: a slice of 33-376 KB), or else of <= 16
// blocks of <= 64 KB (a cluster size the card grants on request: UNet
// level 0 at C = 320 / 640 and the VAE's 64x98 frames, a slice of 0.8-1
// MB). Block b of a cluster copies rows b * rows ... of its (n, chunk)
// slice into shared memory (cp.async, every copy of the block in flight at
// once), sums them, and the cluster adds its blocks' group partials in rank
// order through distributed shared memory; each block then normalises its
// rows from shared memory. x is read from HBM once. The chunk is the
// fewest whole groups whose width is a multiple of 8 channels and >= 128
// bytes a row, so a row's piece is whole 16-byte vectors and a warp's
// loads cover whole sectors; where that chunk's rows fit one block (level
// 3), the widest such chunk that still does. Many small independent
// clusters of 128-thread blocks (3-5 blocks an SM) keep HBM busy while
// others sum or wait on their cluster barrier; the clusters never wait for
// each other.
//
// STREAM (gn_kernel), where the slice does not fit: UNet level 0's concat
// width (C = 960: a 1.5 MB slice) and the VAE decoder's larger frames (25
// MB and up). x is read twice. A cooperative grid of two blocks an SM
// (co-resident, so blocks may wait for each other), cut into one team a
// batch row, all batch rows at once (`teams` = N while N <= the grid;
// beyond, a team walks n = t, t + teams, ...). A team's blocks split the
// row's S rows (`rows` each). Per n, a block:
//   1. sums x + row_add and its square per channel over its rows, in fp32
//      (each thread over its rows in order, then the threads of a channel in
//      order, then a warp per group over its channels: a fixed tree), and
//      writes the group partials;
//   2. arrives on its team's counter; the last block to arrive (an integer
//      counter picks it) sums the team's partials in slot order, takes
//      var = E[x^2] - E[x]^2 in fp32 (as mimo_tpu/models/layers.py and the
//      Pallas kernels do) and publishes mean and rsqrt(var + eps); the others
//      wait for it. The order of every sum is fixed by the plan, whichever
//      block comes last, so two runs give equal bits (no float atomics);
//   3. reads its rows again, backwards (starting on what step 1 read last,
//      which L2 may still hold), folds mean, rstd, the affine and the row
//      add into per-channel mul / add held in registers (a thread keeps its
//      channels across the rows it walks) and writes y = x * mul + add
//      (+ SiLU in fp32), one rounding at the store, 16 bytes a thread,
//      neighbours side by side.
// The resident tier also folds the coefficients this way, and both keep
// every sum in a fixed order.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;   // gn_plan keeps tx * ty within this

// vectors a thread keeps in flight: 64 bytes (4 bf16 or 2 fp32 vectors)
template <typename T>
constexpr int kUnrollOf = 64 / (8 * sizeof(T));

struct GnArgs {
  const void* x;
  const float* radd;     // (N, C) or null
  const float* scale;    // (C,)
  const float* bias;     // (C,)
  void* y;
  float* part;           // (teams, team, 2G): a block's group partials
  float* stats;          // (teams, 2G): mean, then rstd, of the team's n
  unsigned* arrive;      // (teams,): arrivals of the current n, back to 0
  unsigned* flag;        // (teams,): +1 when the team's stats are out
  int N, S, C, G;
  float eps;
  int silu;
  int tx, ty, vpt;       // threads across a row's vectors, thread rows,
                         // vectors a thread takes along a row
  int team, teams, rows;
};

template <typename T> struct Vec;
template <> struct Vec<__nv_bfloat16> { uint4 v; };
template <> struct Vec<float> { float4 a, b; };

__device__ __forceinline__ Vec<__nv_bfloat16> ld_vec(const __nv_bfloat16* p) {
  return {*reinterpret_cast<const uint4*>(p)};
}
__device__ __forceinline__ Vec<float> ld_vec(const float* p) {
  const float4* q = reinterpret_cast<const float4*>(p);
  return {q[0], q[1]};
}

__device__ __forceinline__ void unpack(const Vec<__nv_bfloat16>& v,
                                       float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v.v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
__device__ __forceinline__ void unpack(const Vec<float>& v, float (&f)[8]) {
  f[0] = v.a.x; f[1] = v.a.y; f[2] = v.a.z; f[3] = v.a.w;
  f[4] = v.b.x; f[5] = v.b.y; f[6] = v.b.z; f[7] = v.b.w;
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

// wait until *flag moves on from f0; ~17 s of waiting is a lost block, not
// a slow one: trap, so the launch fails instead of hanging
__device__ __forceinline__ void wait_flag(const unsigned* flag, unsigned f0) {
  const long long t0 = clock64();
  while (ld_acquire(flag) == f0) {
    __nanosleep(64);
    if (clock64() - t0 > (1ll << 35)) __trap();
  }
}

// this thread's per-channel sums of (x + r) and (x + r)^2 over rows
// row0, row0 + step, ... < rows of the (rows, C) block src, vector cv;
// kUnroll loads in flight
template <typename T, int kUnroll>
__device__ __forceinline__ void accumulate(const T* src, int C, int cv,
                                           int row0, int step, int rows,
                                           const float (&r)[8], float (&s)[8],
                                           float (&q)[8]) {
  int row = row0;
  for (; row + (kUnroll - 1) * step < rows; row += kUnroll * step) {
    Vec<T> v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      v[u] = ld_vec(src + (size_t)(row + u * step) * C + cv * 8);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float f[8];
      unpack(v[u], f);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float a = f[e] + r[e];
        s[e] += a;
        q[e] += a * a;
      }
    }
  }
  for (; row < rows; row += step) {
    float f[8];
    unpack(ld_vec(src + (size_t)row * C + cv * 8), f);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float a = f[e] + r[e];
      s[e] += a;
      q[e] += a * a;
    }
  }
}

template <typename T>
__device__ __forceinline__ void apply8(const Vec<T>& v, const float (&mul)[8],
                                       const float (&add)[8], int silu,
                                       T* dst) {
  float f[8];
  unpack(v, f);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    float y = f[e] * mul[e] + add[e];
    if (silu) y = __fdividef(y, 1.f + __expf(-y));
    f[e] = y;
  }
  store8(dst, f);
}

// y rows of this thread, row0, row0 + step, ... < rows, walked backwards,
// from src, vector cv
template <typename T, int kUnroll>
__device__ __forceinline__ void normalise(const T* src, T* dst, int C, int cv,
                                          int row0, int step, int rows,
                                          const float (&mul)[8],
                                          const float (&add)[8], int silu) {
  const int count = row0 < rows ? (rows - 1 - row0) / step + 1 : 0;
  int i = count - 1;
  for (; i + 1 >= kUnroll; i -= kUnroll) {
    Vec<T> v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      v[u] = ld_vec(src + (size_t)(row0 + (i - u) * step) * C + cv * 8);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      apply8(v[u], mul, add, silu,
             dst + (size_t)(row0 + (i - u) * step) * C + cv * 8);
  }
  for (; i >= 0; --i) {
    const size_t off = (size_t)(row0 + i * step) * C + cv * 8;
    apply8(ld_vec(src + off), mul, add, silu, dst + off);
  }
}

__host__ __device__ __forceinline__ size_t align16(size_t b) {
  return (b + 15) & ~size_t(15);
}

// dynamic shared memory: [scratch: ty x 2C fp32] [stats: 2G fp32]
__host__ __device__ __forceinline__ size_t smem_bytes(const GnArgs& a) {
  return (size_t)a.ty * 2 * a.C * 4 + align16((size_t)2 * a.G * 4);
}

// The block's view of its work: rows r0 .. r0 + rows of every batch row
// its team takes, this thread's place in the (ty, tx) layout, and where
// its team's partials and statistics go.
struct Block {
  int team, slot, r0, rows, tx_i, ty_i, lane, warp, warps;
  float* scratch;   // shared: ty x 2C
  float* stat;      // shared: 2G (sums, then mean | rstd)

  __device__ Block(const GnArgs& a, unsigned char* base) {
    const int tid = threadIdx.x;
    team = blockIdx.x / a.team;
    slot = blockIdx.x % a.team;
    r0 = slot * a.rows;
    rows = min(a.rows, a.S - r0);
    tx_i = tid % a.tx;
    ty_i = tid / a.tx;  // ty_i >= ty: a pad thread of the last warp
    lane = tid & 31;
    warp = tid >> 5;
    warps = blockDim.x >> 5;
    scratch = reinterpret_cast<float*>(base);
    stat = scratch + (size_t)a.ty * 2 * a.C;
  }
  __device__ float* part(const GnArgs& a, int s) const {
    return a.part + ((size_t)team * a.team + s) * 2 * a.G;
  }
  __device__ float* stats(const GnArgs& a) const {
    return a.stats + (size_t)team * 2 * a.G;
  }
};

// step 1a: this thread's sums of (x + r) and (x + r)^2 over its rows of the
// block's rows src, vector cv, into its row of the scratch
template <typename T>
__device__ __forceinline__ void thread_sums(const GnArgs& a, const Block& k,
                                            const T* src, const float* radd,
                                            int cv) {
  float r[8], s[8], q[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    r[e] = radd != nullptr ? radd[cv * 8 + e] : 0.f;
    s[e] = q[e] = 0.f;
  }
  accumulate<T, kUnrollOf<T>>(src, a.C, cv, k.ty_i, a.ty, k.rows, r, s, q);
  float* sp = k.scratch + (size_t)k.ty_i * 2 * a.C + cv * 8;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    sp[e] = s[e];
    sp[a.C + e] = q[e];
  }
}

// step 1b: the threads' sums in scratch into the block's group partials:
// the thread rows of a channel in order, then a warp per (sum | square,
// group) over the group's channels
__device__ void block_partials(const GnArgs& a, const Block& k) {
  const int cpg = a.C / a.G;
  __syncthreads();
  for (int c = threadIdx.x; c < 2 * a.C; c += blockDim.x) {
    float v = k.scratch[c];
    for (int y = 1; y < a.ty; ++y) v += k.scratch[(size_t)y * 2 * a.C + c];
    k.scratch[c] = v;
  }
  __syncthreads();
  float* part = k.part(a, k.slot);
  for (int j = k.warp; j < 2 * a.G; j += k.warps) {
    const float* ch = k.scratch + (j < a.G ? 0 : a.C) + (j % a.G) * cpg;
    float v = 0.f;
    for (int c = k.lane; c < cpg; c += 32) v += ch[c];
    v = warp_sum(v);
    if (k.lane == 0) part[j] = v;
  }
  __syncthreads();
}

// step 2: arrive on the team's counter. Thread 0 keeps the flag's value
// from before the arrival in *f0; the block that arrives last
// (an integer counter picks it) sums the team's partials in slot order,
// publishes mean and rsqrt(var + eps) and moves the flag on. The order of
// every sum is fixed by the plan, whichever block comes last.
__device__ void team_arrive(const GnArgs& a, const Block& k, unsigned* f0,
                            int* s_last) {
  const int ts = k.team;
  if (threadIdx.x == 0) {
    *f0 = ld_acquire(a.flag + ts);
    __threadfence();
    *s_last = atomicAdd(a.arrive + ts, 1u) == (unsigned)a.team - 1;
    if (*s_last) __threadfence();
  }
  __syncthreads();
  if (!*s_last) return;
  const float* tp = k.part(a, 0);
  for (int j = k.warp; j < 2 * a.G; j += k.warps) {
    float v = 0.f;
    for (int b = k.lane; b < a.team; b += 32)
      v += __ldcg(tp + (size_t)b * 2 * a.G + j);
    v = warp_sum(v);
    if (k.lane == 0) k.stat[j] = v;
  }
  __syncthreads();
  const float count = (float)a.S * (float)(a.C / a.G);
  float* ts_stats = k.stats(a);
  for (int g = threadIdx.x; g < a.G; g += blockDim.x) {
    const float mean = k.stat[g] / count;
    const float var = k.stat[a.G + g] / count - mean * mean;
    ts_stats[g] = mean;
    ts_stats[a.G + g] = rsqrtf(var + a.eps);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    a.arrive[ts] = 0;
    __threadfence();
    atomicAdd(a.flag + ts, 1u);
  }
}

// the team's statistics into stat, once the flag has moved on from f0
__device__ void team_wait(const GnArgs& a, const Block& k, unsigned f0) {
  if (threadIdx.x == 0) wait_flag(a.flag + k.team, f0);
  __syncthreads();
  const float* ts_stats = k.stats(a);
  for (int j = threadIdx.x; j < 2 * a.G; j += blockDim.x)
    k.stat[j] = __ldcg(ts_stats + j);
  __syncthreads();
}

// step 3: y = x * mul + add (+ SiLU) over the block's rows src of batch
// row n, vector cv, mul / add of the thread's channels in registers for all
// its rows
template <typename T>
__device__ void thread_apply(const GnArgs& a, const Block& k, const T* src,
                             T* dst, const float* radd, int cv) {
  const int cpg = a.C / a.G;
  float mul[8], add[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int c = cv * 8 + e, g = c / cpg;
    mul[e] = k.stat[a.G + g] * a.scale[c];
    add[e] = a.bias[c] - k.stat[g] * mul[e];
    if (radd != nullptr) add[e] += radd[c] * mul[e];
  }
  normalise<T, kUnrollOf<T>>(src, dst, a.C, cv, k.ty_i, a.ty, k.rows, mul,
                             add, a.silu);
}

// The kernel: per batch row of its team, the block sums its rows from
// global memory, arrives, waits for the team's statistics and reads its rows
// again backwards (starting on what it read last, which L2 may still hold)
// to normalise them.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 2) gn_kernel(const GnArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int s_last;
  __shared__ unsigned s_f0;
  const Block k(a, smem);
  const size_t slab = (size_t)a.S * a.C;
  for (int n = k.team; n < a.N; n += a.teams) {
    const T* xb = static_cast<const T*>(a.x) + n * slab + (size_t)k.r0 * a.C;
    T* yb = static_cast<T*>(a.y) + n * slab + (size_t)k.r0 * a.C;
    const float* radd = a.radd != nullptr ? a.radd + (size_t)n * a.C : nullptr;
    // a thread's vectors: tx_i + v tx below C / 8 (none for pad threads)
    const int vecs = k.ty_i < a.ty ? a.C / 8 : 0;
    for (int cv = k.tx_i, v = 0; v < a.vpt && cv < vecs; ++v, cv += a.tx)
      thread_sums(a, k, xb, radd, cv);
    block_partials(a, k);
    team_arrive(a, k, &s_f0, &s_last);
    team_wait(a, k, s_f0);
    for (int cv = k.tx_i, v = 0; v < a.vpt && cv < vecs; ++v, cv += a.tx)
      thread_apply(a, k, xb, yb, radd, cv);
    __syncthreads();
  }
}

template <typename T>
cudaError_t launch(GnArgs a, cudaStream_t stream) {
  const size_t smem = smem_bytes(a);
  if (smem > 48 * 1024) {  // past the default only for C in the thousands
    const cudaError_t e = cudaFuncSetAttribute(
        gn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int threads = (a.tx * a.ty + 31) / 32 * 32;
  void* args[] = {&a};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(gn_kernel<T>),
                                     dim3(a.team * a.teams), dim3(threads),
                                     args, smem, stream);
}

// ---- the resident tier --------------------------------------------------

struct GnResArgs {
  const void* x;
  const float* radd;     // (N, C) or null
  const float* scale;    // (C,)
  const float* bias;     // (C,)
  void* y;
  int S, C, G;
  float eps;
  int silu;
  int cw;                // channels of a chunk (whole groups, % 8 == 0)
  int rows;              // rows a block (the last block of a cluster: fewer)
  int tx, ty;            // threads across the chunk (cw / 8), thread rows
};

// dynamic shared memory: [slice: rows x cw T] [scratch: ty x 2cw fp32]
// [partials: 2 x groups of the chunk, fp32]
__host__ __device__ __forceinline__ size_t res_smem_bytes(const GnResArgs& a,
                                                          int elem) {
  return align16((size_t)a.rows * a.cw * elem) + (size_t)a.ty * 2 * a.cw * 4 +
         align16((size_t)2 * (a.cw / (a.C / a.G)) * 4);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// A cluster of gridDim.x blocks takes the (n = blockIdx.z, chunk =
// blockIdx.y) slice; block b of it rows b * rows ... Every sum in a fixed
// order: a thread over its rows in order, the thread rows of a channel in
// order, a warp per (sum | square, group) over the group's channels, then
// every block of the cluster over the blocks' partials in rank order (each
// block computes the same totals).
template <typename T>
__global__ void __launch_bounds__(kMaxThreads) gn_resident_kernel(
    const GnResArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int k = static_cast<int>(cluster.num_blocks());
  const int r0 = static_cast<int>(cluster.block_rank()) * a.rows;
  const int rows = min(a.rows, a.S - r0);
  const int c0 = blockIdx.y * a.cw, n = blockIdx.z;
  const int cpg = a.C / a.G, gpc = a.cw / cpg;
  const int tid = threadIdx.x, tx_i = tid % a.tx, ty_i = tid / a.tx;
  const int lane = tid & 31, warp = tid >> 5, warps = blockDim.x >> 5;
  const int cv = tx_i * 8;
  // a pad thread of the last warp (ty_i >= ty) takes no rows
  const int my_rows = ty_i < a.ty ? rows : 0;
  T* slice = reinterpret_cast<T*>(smem);
  float* scratch = reinterpret_cast<float*>(
      smem + align16((size_t)a.rows * a.cw * sizeof(T)));
  float* part = scratch + (size_t)a.ty * 2 * a.cw;
  const size_t base = ((size_t)n * a.S + r0) * a.C + c0 + cv;
  const T* xg = static_cast<const T*>(a.x) + base;
  T* yg = static_cast<T*>(a.y) + base;
  const float* radd = a.radd != nullptr ? a.radd + (size_t)n * a.C + c0 : nullptr;

  // 1. the block's rows into shared memory, all copies in flight at once;
  // a thread then reads back only what it copied itself
  constexpr int kCopies = 8 * sizeof(T) / 16;
  for (int r = ty_i; r < my_rows; r += a.ty) {
#pragma unroll
    for (int h = 0; h < kCopies; ++h)
      cp_async16(slice + (size_t)r * a.cw + cv + h * (16 / sizeof(T)),
                 xg + (size_t)r * a.C + h * (16 / sizeof(T)));
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");

  // 2. this thread's per-channel sums of (x + r) and (x + r)^2
  float rv[8], s[8], q[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    rv[e] = radd != nullptr ? radd[cv + e] : 0.f;
    s[e] = q[e] = 0.f;
  }
  for (int r = ty_i; r < my_rows; r += a.ty) {
    float f[8];
    unpack(ld_vec(slice + (size_t)r * a.cw + cv), f);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float v = f[e] + rv[e];
      s[e] += v;
      q[e] += v * v;
    }
  }
  if (ty_i < a.ty) {
    float* sp = scratch + (size_t)ty_i * 2 * a.cw + cv;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      sp[e] = s[e];
      sp[a.cw + e] = q[e];
    }
  }
  __syncthreads();
  for (int c = tid; c < 2 * a.cw; c += blockDim.x) {
    float v = scratch[c];
    for (int y = 1; y < a.ty; ++y) v += scratch[(size_t)y * 2 * a.cw + c];
    scratch[c] = v;
  }
  __syncthreads();
  for (int j = warp; j < 2 * gpc; j += warps) {
    const float* ch = scratch + (j < gpc ? 0 : a.cw) + (j % gpc) * cpg;
    float v = 0.f;
    for (int c = lane; c < cpg; c += 32) v += ch[c];
    v = warp_sum(v);
    if (lane == 0) part[j] = v;
  }

  // 3. the cluster's totals, block by block in rank order; the scratch row
  // 0 (no longer needed) takes them
  cluster_arrive();
  cluster_wait();
  float* total = scratch;
  for (int j = tid; j < 2 * gpc; j += blockDim.x) {
    float v = 0.f;
    for (int b = 0; b < k; ++b) v += cluster.map_shared_rank(part, b)[j];
    total[j] = v;
  }
  cluster_arrive();  // done reading the other blocks' partials
  __syncthreads();

  // 4. y = x * mul + add (+ SiLU) from shared memory, mul / add of the
  // thread's channels in registers
  const float count = (float)a.S * (float)cpg;
  float mul[8], add[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int c = cv + e, g = c / cpg;
    const float mean = total[g] / count;
    const float rstd = rsqrtf(total[gpc + g] / count - mean * mean + a.eps);
    mul[e] = rstd * a.scale[c0 + c];
    add[e] = a.bias[c0 + c] - mean * mul[e] + rv[e] * mul[e];
  }
  for (int r = ty_i; r < my_rows; r += a.ty)
    apply8(ld_vec(slice + (size_t)r * a.cw + cv), mul, add, a.silu,
           yg + (size_t)r * a.C);
  cluster_wait();  // no block leaves while another may read its partials
}

template <typename T>
cudaError_t launch_resident(const GnResArgs& a, int N, int cluster,
                            cudaStream_t stream) {
  const size_t smem = res_smem_bytes(a, sizeof(T));
  cudaError_t e = cudaFuncSetAttribute(
      gn_resident_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e == cudaSuccess && cluster > 8)
    e = cudaFuncSetAttribute(gn_resident_kernel<T>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, a.C / a.cw, N);
  cfg.blockDim = dim3((a.tx * a.ty + 31) / 32 * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, gn_resident_kernel<T>, a);
}

}  // namespace

extern "C" {

// y = GN(x + radd)(+SiLU) over x (N, S, C); dtype 0 = float32,
// 1 = bfloat16. radd may be null. The plan (tx, ty, vpt, team, teams, rows)
// comes from ops/groupnorm.py::gn_plan; part holds teams * team * 2G
// floats, stats teams * 2G; arrive and flag hold `teams` unsigned ints
// each, arrive all zero (the kernel leaves it so). Returns a cudaError_t
// code.
int mimo_group_norm_fwd(const void* x, const void* radd, const void* scale,
                        const void* bias, void* y, void* part, void* stats,
                        void* arrive, void* flag, int dtype, int N, int S,
                        int C, int G, float eps, int silu, int tx, int ty,
                        int vpt, int team, int teams, int rows,
                        void* stream) {
  if (N < 1 || S < 1 || C % 8 != 0 || G < 1 || C % G != 0 || tx < 1 ||
      ty < 1 || tx * ty > kMaxThreads || vpt < 1 || tx * vpt < C / 8 ||
      team < 1 || teams < 1 || teams > N || rows < 1 ||
      (long long)rows * (team - 1) >= S || (long long)rows * team < S ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  GnArgs a;
  a.x = x;
  a.radd = static_cast<const float*>(radd);
  a.scale = static_cast<const float*>(scale);
  a.bias = static_cast<const float*>(bias);
  a.y = y;
  a.part = static_cast<float*>(part);
  a.stats = static_cast<float*>(stats);
  a.arrive = static_cast<unsigned*>(arrive);
  a.flag = static_cast<unsigned*>(flag);
  a.N = N;
  a.S = S;
  a.C = C;
  a.G = G;
  a.eps = eps;
  a.silu = silu;
  a.tx = tx;
  a.ty = ty;
  a.vpt = vpt;
  a.team = team;
  a.teams = teams;
  a.rows = rows;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dtype == 1 ? launch<__nv_bfloat16>(a, st)
                                     : launch<float>(a, st));
}

// The resident tier of the same function: clusters of `cluster` blocks of
// `rows` rows each, one a (batch row, chunk of cw channels); ty thread rows
// of cw / 8 threads. The plan comes from ops/groupnorm.py::gn_plan. Returns
// a cudaError_t code.
int mimo_group_norm_resident_fwd(const void* x, const void* radd,
                                 const void* scale, const void* bias, void* y,
                                 int dtype, int N, int S, int C, int G,
                                 float eps, int silu, int cw, int cluster,
                                 int rows, int ty, void* stream) {
  if (N < 1 || S < 1 || C % 8 != 0 || G < 1 || C % G != 0 || cw < 8 ||
      cw % 8 != 0 || C % cw != 0 || cw % (C / G) != 0 || ty < 1 ||
      (cw / 8) * ty > kMaxThreads || cluster < 1 || cluster > 16 ||
      rows < 1 || (long long)rows * (cluster - 1) >= S ||
      (long long)rows * cluster < S || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  GnResArgs a;
  a.x = x;
  a.radd = static_cast<const float*>(radd);
  a.scale = static_cast<const float*>(scale);
  a.bias = static_cast<const float*>(bias);
  a.y = y;
  a.S = S;
  a.C = C;
  a.G = G;
  a.eps = eps;
  a.silu = silu;
  a.cw = cw;
  a.rows = rows;
  a.tx = cw / 8;
  a.ty = ty;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dtype == 1 ? launch_resident<__nv_bfloat16>(a, N, cluster, st)
                 : launch_resident<float>(a, N, cluster, st));
}

}  // extern "C"
