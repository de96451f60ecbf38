// Ablation builds of the flash attention forward kernel (Hopper, sm_90a).
//
// Replaces the TPU kernel tools/ablate_flash.py::run (_kernel): a variant of
// the transposed flash kernel that times the production math with one piece
// removed, to split the kernel's time among its pieces. Here every build is
// the production kernel's own body (flash_body.cuh: wgmma + TMA, a producer
// warpgroup and two consumer warpgroups on an mbarrier ring) at an ablation
// mode and a layout; <d, full, natural> is the production instantiation
// itself, so `full` is bit-equal to flash_attention_nt, and `full - mode`
// is the cost of that piece of the production kernel on this card (not an
// exact decomposition: a removed piece frees issue slots for its
// neighbours).
//
// Modes (the TPU tool's names, with their meaning on Hopper; flash_body.cuh
// states each stand-in exactly):
//   full     the production kernel                        -> baseline
//   noexp    no MUFU ex2 per logit (bounded linear p)     -> exp2 cost
//   nosm     no scale, mask, max, shuffle, rescale or ex2 -> softmax cost
//   nopv     no P.V wgmma (o adds one key's p a column)   -> PV cost
//   noqk     no Q.K^T wgmma (rank-1 logits)               -> QK cost
//   nomxu    noqk and nopv: no tensor-core work           -> both products
//   noshift  no running max: exp2(x - 8), no rescale      -> shift-chain cost
//   chunk2/4 Q.K^T in 2 / 4 wgmma groups, the softmax of sub-chunk c while
//            the later groups run                         -> overlap gain
// and, for every mode, the pretransposed layout: q, k, v given as
// (B, H*d, S) with S contiguous, Q and K read MN-major by Q.K^T and V
// K-major by P.V (descriptor bits, no data movement)  -> transpose cost
//
// Outputs of full, noshift, chunk2/4 (in both layouts) are attention; the
// others are bounded stand-ins that
// mimo_tpu_torch/tools/ablate_flash.py::run_plain reproduces.
// Instantiated for the UNet's two flash widths, d = 40 and 80, in four
// sources (flash_ablate_{40,40t,80,80t}.cu) that the build compiles in
// parallel.

#include "flash_ablate_launch.cuh"

extern "C" {

// Returns a cudaError_t code (0 on success); cudaErrorInvalidValue for a d
// other than 40 or 80, an unknown mode or an empty sequence. Strides as in
// AblateCall; every operand needs a 16-byte aligned start and batch /
// sequence (or channel) strides that are multiples of 8 elements (the TMA
// maps' rules).
int mimo_flash_ablate_fwd(
    int mode, int pretransposed, const void* q, const void* k, const void* v,
    void* o, int batch, int heads, int d, int sq, int sk, long long q_bs,
    long long q_ss, long long k_bs, long long k_ss, long long v_bs,
    long long v_ss, long long o_bs, long long o_ss, float scale_log2,
    void* stream) {
  if (sq < 1 || sk < 1 || batch < 1 || heads < 1 || mode < 0 ||
      mode >= kNumModes)
    return static_cast<int>(cudaErrorInvalidValue);
  const AblateCall c = {mode, q,    k,    v,    o,    batch, heads,
                        sq,   sk,   q_bs, q_ss, k_bs, k_ss,  v_bs,
                        v_ss, o_bs, o_ss, scale_log2,
                        static_cast<cudaStream_t>(stream)};
  const bool pre = pretransposed != 0;
  if (d == 40)
    return static_cast<int>(pre ? flash_ablate_40t(c) : flash_ablate_40(c));
  if (d == 80)
    return static_cast<int>(pre ? flash_ablate_80t(c) : flash_ablate_80(c));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
