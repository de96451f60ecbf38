// Flash ablation builds at d = 80, pretransposed layout: the 9 modes of
// flash_body.cuh (see flash_ablate.cu).

#include "flash_ablate_launch.cuh"

cudaError_t flash_ablate_80t(const AblateCall& c) {
  return launch_modes<80, true>(c);
}
