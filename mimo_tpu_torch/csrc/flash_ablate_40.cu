// Flash ablation builds at d = 40, natural layout: the 9 modes of
// flash_body.cuh (see flash_ablate.cu).

#include "flash_ablate_launch.cuh"

cudaError_t flash_ablate_40(const AblateCall& c) {
  return launch_modes<40, false>(c);
}
