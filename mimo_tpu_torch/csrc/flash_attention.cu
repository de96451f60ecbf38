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
// Numerics: exact softmax with a true running max of the raw logits (not
// the TPU kernel's Cauchy-Schwarz bound shift); p = exp2(s*c - m*c) with
// c = log2(e)/sqrt(d), in fp32. P is rounded to bf16 only as the operand of
// P.V (fp32 accumulation); the row sum uses the fp32 P.
//
// What bounds it on an H100: at the UNet's top level (d=40, Sq=6272, up to
// 12544 keys) each logit costs 4d FLOPs of tensor-core work and one exp2 on
// the special-function unit (16 a clock per SM); at d=40 the exp2 count, not
// the FLOPs, sets the bound. The first design (warp-level m16n8k16 products
// fed by per-thread fragment loads, 16-byte async copies from every thread,
// a select and a multiply per logit; flash_ablate.cuh) was bound by
// instruction issue. This one cuts the instructions around the products
// and the softmax:
// - one block per (batch row, head, 128-query tile), 384 threads: a
//   producer warpgroup whose one thread issues every TMA load
//   (cp.async.bulk.tensor, 4-D maps over (d, H, S, B), 64-column boxes with
//   the 128-byte swizzle; columns d..63 of a box and rows past a segment
//   are zero-filled), and two consumer warpgroups of 64 query rows each
//   (setmaxnreg moves the producer's registers to them);
// - the block's Q tile is loaded once; K/V tiles of kBK keys (the self
//   tiles, then the bank tiles) stream through a ring of full / empty
//   mbarrier pairs as deep as 227 KB holds;
// - Q.K^T is wgmma.mma_async m64n{kBK}k16 with both operands K-major from
//   shared memory, ceil(d/16) steps (the zero columns pad the last);
// - the softmax runs on the accumulator in registers: row max of the raw
//   logits (two quad shuffles), one FFMA and one exp2 per logit, the key
//   mask only on a segment's last tile and only if it is ragged;
// - P.V is wgmma.mma_async m64n{d}k16 with P from registers (the
//   accumulator layout of two 8-key column groups is the A fragment of one
//   16-key step) and V MN-major from shared memory (the transpose bit), so
//   V needs no transpose and P never touches shared memory;
// - O / l is written from registers, rows past Sq masked.
// Not here (later work): ping-pong between the consumer warpgroups, the
// next tile's Q.K^T issued before this tile's softmax, a persistent grid,
// exp2 partly on the FMA units.

#include "hopper.cuh"

namespace {

constexpr int kBlockQ = 128;       // query rows a block: 2 consumer warpgroups
constexpr int kThreads = 384;      // producer + two consumer warpgroups
constexpr int kBoxCols = 64;       // columns of a TMA box: 128 bytes of bf16
constexpr int kSmemLimit = 232448; // dynamic shared memory a block may use

template <int D>
struct FlashTile {
  // keys a stage: n128 products up to d = 128, n64 above (registers)
  static constexpr int kBK = D <= 128 ? 128 : 64;
  static constexpr int kBoxes = (D + kBoxCols - 1) / kBoxCols;
  static constexpr int kKSteps = (D + 15) / 16;        // k16 steps of Q.K^T
  static constexpr int kQBytes = kBoxes * kBlockQ * 128;
  static constexpr int kKVBytes = kBoxes * kBK * 128;  // one K or V tile
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

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     const __grid_constant__ CUtensorMap map_kb,
                     const __grid_constant__ CUtensorMap map_vb,
                     const FlashArgs a) {
  using T = FlashTile<D>;
  constexpr int kBK = T::kBK;
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
#pragma unroll
      for (int j = 0; j < T::kBoxes; ++j)
        tma_load(q_tile + j * kBlockQ * 128, &map_q, j * kBoxCols, head, q0,
                 a.batched & 1 ? b : 0, q_full);
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
#pragma unroll
        for (int j = 0; j < T::kBoxes; ++j) {
          tma_load(kt + j * kBK * 128, mk, j * kBoxCols, head, k0, bk,
                   &full[stage]);
          tma_load(kt + T::kKVBytes + j * kBK * 128, mv, j * kBoxCols, head,
                   k0, bv, &full[stage]);
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
    // this warpgroup's 64 Q rows start 8 KB into each box
    const uint64_t dq = smem_desc(q_tile + cw * 64 * 128);

    // accumulator register 4i + 2h + e of a thread: row 16 warp + lane/4 +
    // 8h of the warpgroup's 64, column 8i + 2t + e
    float s[kBK / 2], o[D / 2];
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) s[i] = 0.f;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

    mbar_wait(q_full, 0);
    for (int it = 0; it < nt; ++it) {
      const int stage = it % T::kStages;
      mbar_wait(&full[stage], (it / T::kStages) & 1);
      unsigned char* kt = ring + stage * T::kStageBytes;
      const uint64_t dk = smem_desc(kt);

      // S = Q K^T over this tile's kBK keys
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < T::kKSteps; ++kk) {
        // k step kk: box kk / 4, 32 bytes a step inside it
        const int off = (kk / 4) * (kBlockQ * 128 >> 4) + (kk % 4) * 2;
        const int koff = (kk / 4) * (kBK * 128 >> 4) + (kk % 4) * 2;
        wgmma_ss<kBK>(s, dq + off, dk + koff, kk != 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(s);

      // the last tile of a segment may be ragged: its keys past the end
      // were zero-filled (logit 0, not -inf) and are masked here
      const int valid =
          it < nt1 ? a.sk1 - it * kBK : a.sk2 - (it - nt1) * kBK;
      if (valid < kBK) {
#pragma unroll
        for (int i = 0; i < kBK / 2; ++i)
          if ((i / 4) * 8 + 2 * t + (i & 1) >= valid) s[i] = -INFINITY;
      }

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
        s[i] = ex2(fmaf(s[i], c, b0));
        s[i + 1] = ex2(fmaf(s[i + 1], c, b0));
        s[i + 2] = ex2(fmaf(s[i + 2], c, b1));
        s[i + 3] = ex2(fmaf(s[i + 3], c, b1));
        rs0 += s[i] + s[i + 1];
        rs1 += s[i + 2] + s[i + 3];
      }
      l0 = l0 * al0 + rs0;  // per-thread partial sums; quad sums at the end
      l1 = l1 * al1 + rs1;
#pragma unroll
      for (int i = 0; i < D / 2; i += 4) {
        o[i] *= al0;
        o[i + 1] *= al0;
        o[i + 2] *= al1;
        o[i + 3] *= al1;
      }

      // O += P V: P from registers, V MN-major, 16 keys a step
      uint32_t p[kBK / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        p[kk][0] = pack_bf16x2(s[8 * kk], s[8 * kk + 1]);
        p[kk][1] = pack_bf16x2(s[8 * kk + 2], s[8 * kk + 3]);
        p[kk][2] = pack_bf16x2(s[8 * kk + 4], s[8 * kk + 5]);
        p[kk][3] = pack_bf16x2(s[8 * kk + 6], s[8 * kk + 7]);
      }
      const uint64_t dv = smem_desc_mn(kt + T::kKVBytes, kBK * 128);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_rs<D>(o, p[kk], dv + kk * (16 * 128 >> 4));
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(o);
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
bool make_map(CUtensorMap* map, const void* base, int d, int heads, int s,
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

struct FlashOperands {
  const void *q, *k, *v, *kb, *vb;
  int batch, heads;
  long long q_bs, q_ss, k_bs, k_ss, v_bs, v_ss, kb_bs, kb_ss, vb_bs, vb_ss;
};

template <int D>
cudaError_t launch_flash(const FlashOperands& x, FlashArgs a,
                         cudaStream_t stream) {
  using T = FlashTile<D>;
  const int b = x.batch, h = x.heads;
  const long long bs[5] = {x.q_bs, x.k_bs, x.v_bs, x.kb_bs, x.vb_bs};
  a.batched = 0;
  for (int i = 0; i < 5; ++i)
    if (b > 1 && bs[i] != 0) a.batched |= 1 << i;
  auto batched = [&](int i) { return (a.batched >> i & 1) != 0; };
  CUtensorMap mq, mk, mv, mkb, mvb;
  bool ok = make_map(&mq, x.q, D, h, a.sq, x.q_ss, b, x.q_bs, batched(0),
                     kBlockQ) &&
            make_map(&mk, x.k, D, h, a.sk1, x.k_ss, b, x.k_bs, batched(1),
                     T::kBK) &&
            make_map(&mv, x.v, D, h, a.sk1, x.v_ss, b, x.v_bs, batched(2),
                     T::kBK);
  if (a.sk2 > 0)
    ok = ok &&
         make_map(&mkb, x.kb, D, h, a.sk2, x.kb_ss, b, x.kb_bs, batched(3),
                  T::kBK) &&
         make_map(&mvb, x.vb, D, h, a.sk2, x.vb_ss, b, x.vb_bs, batched(4),
                  T::kBK);
  else
    mkb = mvb = mk;  // never read: the bank segment is empty
  if (!ok) return cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::kSmemBytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.sq + kBlockQ - 1) / kBlockQ, h, b);
  flash_fwd_kernel<D><<<grid, kThreads, T::kSmemBytes, stream>>>(
      mq, mk, mv, mkb, mvb, a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* mimo_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Returns a cudaError_t code (0 on success). kb/vb may alias k/v when
// sk2 == 0 (the bank segment is then empty and never read). Every operand
// needs a 16-byte aligned start and batch / sequence strides that are
// multiples of 8 elements (the TMA maps' rules).
int mimo_flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* kb, const void* vb,
    void* o, int batch, int heads, int d, int sq, int sk1, int sk2,
    long long q_bs, long long q_ss, long long k_bs, long long k_ss,
    long long v_bs, long long v_ss, long long kb_bs, long long kb_ss,
    long long vb_bs, long long vb_ss, long long o_bs, long long o_ss,
    float scale_log2, void* stream) {
  if (sq < 1 || sk1 < 1 || sk2 < 0 || batch < 1 || heads < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const FlashOperands x = {q,    k,    v,    kb,   vb,    batch, heads,
                           q_bs, q_ss, k_bs, k_ss, v_bs,  v_ss,  kb_bs,
                           kb_ss, vb_bs, vb_ss};
  FlashArgs a;
  a.o = static_cast<__nv_bfloat16*>(o);
  a.o_bs = o_bs;
  a.o_ss = o_ss;
  a.sq = sq;
  a.sk1 = sk1;
  a.sk2 = sk2;
  a.scale_log2 = scale_log2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
#define MIMO_FLASH_CASE(DD) \
  case DD:                  \
    return static_cast<int>(launch_flash<DD>(x, a, st));
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
