// The float quarter-wave polynomials of ops/trig.py (SIN_COEFFS,
// COS_COEFFS) on [0, pi/2], shared by the Box-Muller normals (philox.cuh)
// and the log|psi| pair factors (pair_terms.cuh).
#pragma once

#include <cuda_runtime.h>

namespace qmc {

__device__ __forceinline__ float cos_poly(float x) {
  const float z2 = x * x;
  float acc = -2.60510641e-07f;
  acc = acc * z2 + 2.47601348e-05f;
  acc = acc * z2 + -1.38883608e-03f;
  acc = acc * z2 + 4.16666362e-02f;
  acc = acc * z2 + -4.99999994e-01f;
  acc = acc * z2 + 1.0f;
  return acc;
}

__device__ __forceinline__ float sin_poly(float x) {
  const float z2 = x * x;
  float acc = -2.38894895e-08f;
  acc = acc * z2 + 2.75252866e-06f;
  acc = acc * z2 + -1.98408615e-04f;
  acc = acc * z2 + 8.33333098e-03f;
  acc = acc * z2 + -1.66666666e-01f;
  acc = acc * z2 + 1.0f;
  return x * acc;
}

}  // namespace qmc
