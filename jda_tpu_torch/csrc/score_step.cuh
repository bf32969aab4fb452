// One step of the JDA cascade's score chain (c/jda.c:395-399), shared by the
// stage-0 walk (dense0_walk.cuh) and the survivor tail (tail.cu).

#pragma once

#include <cuda_runtime.h>

namespace jda {

// (s + b - mean) / std, each op IEEE round-to-nearest, no contraction
__device__ __forceinline__ float score_step(float s, float b, float mean, float sd) {
  return __fdiv_rn(__fsub_rn(__fadd_rn(s, b), mean), sd);
}

}  // namespace jda
