// Shared pieces of the port's CUDA kernels: the reference's physics
// constants and the softened inverse cube of one pair distance.
#pragma once

#include <cuda_runtime.h>

namespace nbt {

// ver0/GSimulation.cpp:114-116, as nbody_tpu/types.py.  Both literals round
// to the same fp32 values as jnp.float32 of the Python doubles.
constexpr float kSoftening2 = 1e-3f;
constexpr float kG = 6.67259e-11f;

// 1 / (|d|^2 + eps^2)^{3/2}.  1.0f / sqrtf is IEEE-rounded under nvcc's
// default -prec-div=true -prec-sqrt=true (no --use_fast_math); rsqrtf is
// approximate and is not used.
__device__ __forceinline__ float inv_cube(float dx, float dy, float dz) {
  const float d2 = dx * dx + dy * dy + dz * dz + kSoftening2;
  const float inv = 1.0f / sqrtf(d2);
  return inv * inv * inv;
}

}  // namespace nbt
