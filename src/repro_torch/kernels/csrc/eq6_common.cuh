// Shared device math of the eq. (6) kernels: the stable softplus pair and
// the wire-dtype round trip, written to match the plain PyTorch versions in
// kernels/consensus.py operation for operation (no fast-math: IEEE division
// and sqrt, correctly rounded conversions).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace repro_torch {

// wire codes shared with the Python wrappers
constexpr int WIRE_F32 = 0;
constexpr int WIRE_BF16 = 1;
constexpr int WIRE_F16 = 2;

// softplus(x) = logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))
__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

// softplus^-1(y) = y + log(-expm1(-y)), stable down to y ~ 1e-38
__device__ __forceinline__ float softplus_inv(float y) {
  return y + logf(-expm1f(-y));
}

// round to nearest even through the wire dtype and decode back to fp32
template <int WIRE>
__device__ __forceinline__ float wire_roundtrip(float x) {
  if constexpr (WIRE == WIRE_BF16) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else if constexpr (WIRE == WIRE_F16) {
    return __half2float(__float2half_rn(x));
  } else {
    return x;
  }
}

// prec = softplus(rho)^-2 with an IEEE division, as 1 / (sigma * sigma)
__device__ __forceinline__ float precision(float rho) {
  const float sigma = softplus(rho);
  return 1.0f / (sigma * sigma);
}

}  // namespace repro_torch
