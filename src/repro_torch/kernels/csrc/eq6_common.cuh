// Shared device math of the eq. (6) kernels: the stable softplus pair and
// the wire-dtype round trip, written to match the plain PyTorch versions in
// kernels/consensus.py operation for operation (no fast-math: IEEE division
// and sqrt, correctly rounded conversions); and the arrival of the
// single-launch kernels.
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

// The 4 float32 lanes at x + lane0 (lane0 a multiple of 4) with VEC-lane
// loads (x + lane0 aligned to 4 VEC bytes) for the single-launch kernels;
// lanes at or past `total` read as 0, and their callers mask them.
template <int VEC>
__device__ __forceinline__ void load_group(const float* __restrict__ x, long long lane0,
                                           long long total, float (&v)[4]) {
  if (lane0 + 3 < total) {
    if constexpr (VEC == 4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(x + lane0));
      v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    } else if constexpr (VEC == 2) {
      const float2 a = __ldg(reinterpret_cast<const float2*>(x + lane0));
      const float2 b = __ldg(reinterpret_cast<const float2*>(x + lane0 + 2));
      v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = __ldg(x + lane0 + j);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = lane0 + j < total ? __ldg(x + lane0 + j) : 0.0f;
  }
}

// The last-block pattern of the single-launch kernels (payload_validity.cu,
// gauss_vi.cu).  After a barrier (the block's writes are done), thread 0 adds
// one to the arrival counter with release-acquire semantics at device scope:
// the block that brings it to gridDim.x arrives last, sees what the other
// blocks' thread 0 wrote before arriving, and resets the counter for the
// next launch on the stream.  Callers read the other blocks' results with
// ld.global.cg (L2), past any stale L1 line.
__device__ __forceinline__ bool last_block_to_arrive(unsigned int* arrivals) {
  __shared__ bool s_last;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned int before;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
                 : "=r"(before) : "l"(arrivals) : "memory");
    s_last = before == gridDim.x - 1;
    if (s_last) *arrivals = 0u;
  }
  __syncthreads();
  return s_last;
}

}  // namespace repro_torch
