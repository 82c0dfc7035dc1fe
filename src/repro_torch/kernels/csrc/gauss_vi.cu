// Fused Bayes-by-Backprop sample + KL over flat [P] float32 buffers:
//   theta[i] = mu[i] + softplus(rho[i]) * eps[i]
//   kl_parts[b] = sum over block b's lanes of
//                 log(sp / sq) + (sq*sq + d*d) / (2*sp*sp) - 1/2,
//   sq = softplus(rho), sp = softplus(rho_p), d = mu - mu_p.
// The caller sums the [grid] partials, as the JAX wrapper sums the Pallas
// kernel's per-block partials outside the kernel.
//
// Replaces the TPU kernel sample_and_kl_fused of repro/kernels/gauss_vi.py
// (pallas_call at gauss_vi.py:71), the kernel behind kernels/ops.py
// sample_and_kl.  Forward only, as the TPU kernel is.
//
// What bounds it on the H100: memory (five [P] inputs read once, one [P]
// output written once: 24 P bytes) and, at the sizes of one agent's
// posterior, the launch itself: P = 199,210 is 4.8 MB, about 1.4 us of HBM.
//
// Design:
// * A block owns TILE = 4 x 256 lanes; thread t takes lanes t, t + 256, ...,
//   so every load and store of a warp is one coalesced line.  The ragged
//   last tile is masked.  The TPU pads rho and rho_p with 1.0 so that the
//   pad lanes' KL is exactly 0; masking skips them, which is the same sum.
// * The KL sum is a fixed tree: each thread adds its lanes in order, a warp
//   folds its 32 values with shuffles, and thread 0 adds the 8 warp sums in
//   order.  No atomicAdd, so the result is the same from run to run.
// * Each product and sum is an IEEE multiply or add (__fmul_rn, __fadd_rn),
//   in the TPU kernel's op order; no contraction into fma, no fast math.
#include "eq6_common.cuh"  // softplus

namespace repro_torch {
namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 4;
constexpr int TILE = THREADS * PER_THREAD;  // lanes per block

__global__ void __launch_bounds__(THREADS)
sample_and_kl_kernel(const float* __restrict__ mu,
                     const float* __restrict__ rho,
                     const float* __restrict__ eps,
                     const float* __restrict__ mu_p,
                     const float* __restrict__ rho_p,
                     float* __restrict__ theta,
                     float* __restrict__ kl_parts, long long p) {
  __shared__ float s_warp[THREADS / 32];
  const long long base = static_cast<long long>(blockIdx.x) * TILE + threadIdx.x;
  float kl = 0.0f;
#pragma unroll
  for (int r = 0; r < PER_THREAD; ++r) {
    const long long i = base + static_cast<long long>(r) * THREADS;
    if (i < p) {
      const float m = mu[i];
      const float sq = softplus(rho[i]);
      const float sp = softplus(rho_p[i]);
      theta[i] = __fadd_rn(m, __fmul_rn(sq, eps[i]));
      const float d = __fsub_rn(m, mu_p[i]);
      const float num = __fadd_rn(__fmul_rn(sq, sq), __fmul_rn(d, d));
      const float den = __fmul_rn(__fmul_rn(2.0f, sp), sp);
      const float term = __fsub_rn(__fadd_rn(logf(sp / sq), num / den), 0.5f);
      kl = __fadd_rn(kl, term);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    kl = __fadd_rn(kl, __shfl_down_sync(0xffffffffu, kl, off));
  }
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = kl;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.0f;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) total = __fadd_rn(total, s_warp[w]);
    kl_parts[blockIdx.x] = total;
  }
}

}  // namespace
}  // namespace repro_torch

// The number of KL partials (blocks) for p lanes: the wrapper allocates them.
extern "C" long long sample_and_kl_grid(long long p) {
  return (p + repro_torch::TILE - 1) / repro_torch::TILE;
}

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int sample_and_kl_launch(const void* mu, const void* rho,
                                    const void* eps, const void* mu_p,
                                    const void* rho_p, void* theta,
                                    void* kl_parts, long long p, void* stream) {
  using namespace repro_torch;
  if (p <= 0 || sample_and_kl_grid(p) > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(sample_and_kl_grid(p)));
  sample_and_kl_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(mu), static_cast<const float*>(rho),
      static_cast<const float*>(eps), static_cast<const float*>(mu_p),
      static_cast<const float*>(rho_p), static_cast<float*>(theta),
      static_cast<float*>(kl_parts), p);
  return static_cast<int>(cudaGetLastError());
}
