// Fused Bayes-by-Backprop sample + KL over flat [P] float32 buffers, in one
// launch:
//   theta[i] = mu[i] + softplus(rho[i]) * eps[i]
//   kl = sum over i of log(sp / sq) + (sq*sq + d*d) / (2*sp*sp) - 1/2,
//   sq = softplus(rho), sp = softplus(rho_p), d = mu - mu_p.
//
// Replaces the TPU kernel sample_and_kl_fused of repro/kernels/gauss_vi.py
// (pallas_call at gauss_vi.py:71), the kernel behind kernels/ops.py
// sample_and_kl.  Forward only, as the TPU kernel is.
//
// What bounds it on the H100: memory (five [P] inputs read once, one [P]
// output written once: 24 P bytes) and, at the sizes of one agent's
// posterior, the launch itself: P = 199,210 is 4.8 MB, about 1.4 us of HBM,
// less than one launch.  The parent design ran two device kernels a call
// (the kernel, then torch.sum over its block partials).
//
// Design (one kernel per call; the launch plan is kernels/stream_plan.py):
// * Chunks of 1024 lanes; thread t of a chunk owns one group of 4
//   consecutive lanes (at 4 (chunk base + t)), loaded with 16-, 8- or 4-byte
//   loads as all six pointers allow (template VEC): the 20 input values are
//   in registers before the first softplus.  The grid is at most one wave
//   (SMs x occupancy); a block walks chunks b, b + grid, ...
// * The KL is a fixed tree in lane order, whatever VEC and the grid: each
//   thread adds its lanes in order, a warp folds its 32 values with shuffles
//   (offsets 16, 8, 4, 2, 1), thread 0 adds the 8 warp sums in order: one
//   partial per chunk.  The last block to arrive (a release-acquire add on
//   an arrival counter, eq6_common.cuh) sums the partials by the same tree,
//   thread t taking chunks t, t + 256, ... in order.  No atomic add on a
//   float: the KL is the same from run to run and on any stream
//   (tests/test_torch_stream_plan.py emulates the order).
// * Each product and sum is an IEEE multiply or add (__fmul_rn, __fadd_rn),
//   in the TPU kernel's op order; no contraction into fma, no fast math:
//   theta is bitwise sample_and_kl_plain's.
#include <initializer_list>

#include "eq6_common.cuh"  // softplus, load_group, last_block_to_arrive

namespace repro_torch {
namespace {

constexpr int THREADS = 256;
constexpr int GROUPS = 1;  // 4-lane groups a thread owns per chunk
constexpr int MIN_BLOCKS = 4;  // resident per SM: at most 64 registers a thread
constexpr long long CHUNK = THREADS * GROUPS * 4;
constexpr int WARPS = THREADS / 32;

template <int VEC>
__device__ __forceinline__ void store_group(float* __restrict__ x, long long lane0,
                                            long long total, const float (&v)[4]) {
  if (lane0 + 3 < total) {
    if constexpr (VEC == 4) {
      *reinterpret_cast<float4*>(x + lane0) = make_float4(v[0], v[1], v[2], v[3]);
    } else if constexpr (VEC == 2) {
      *reinterpret_cast<float2*>(x + lane0) = make_float2(v[0], v[1]);
      *reinterpret_cast<float2*>(x + lane0 + 2) = make_float2(v[2], v[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) x[lane0 + j] = v[j];
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (lane0 + j < total) x[lane0 + j] = v[j];
    }
  }
}

// the block's fixed tree: warp shuffles, then warp sums in order (thread 0)
__device__ __forceinline__ float block_sum(float v, float* s_warp) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  }
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.0f;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < WARPS; ++w) total = __fadd_rn(total, s_warp[w]);
  }
  __syncthreads();  // s_warp is free again
  return total;
}

template <int VEC>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
sample_and_kl_kernel(const float* __restrict__ mu, const float* __restrict__ rho,
                     const float* __restrict__ eps, const float* __restrict__ mu_p,
                     const float* __restrict__ rho_p, float* __restrict__ theta,
                     float* __restrict__ kl_out, float* __restrict__ parts,
                     unsigned int* __restrict__ arrivals, long long p) {
  __shared__ float s_warp[WARPS];
  const long long chunks = (p + CHUNK - 1) / CHUNK;
  for (long long c = blockIdx.x; c < chunks; c += gridDim.x) {
    const long long base = c * CHUNK + 4LL * threadIdx.x;
    float m[GROUPS][4], r[GROUPS][4], e[GROUPS][4], mp[GROUPS][4], rp[GROUPS][4];
#pragma unroll
    for (int u = 0; u < GROUPS; ++u) {
      const long long lane0 = base + 4LL * u * THREADS;
      load_group<VEC>(mu, lane0, p, m[u]);
      load_group<VEC>(rho, lane0, p, r[u]);
      load_group<VEC>(eps, lane0, p, e[u]);
      load_group<VEC>(mu_p, lane0, p, mp[u]);
      load_group<VEC>(rho_p, lane0, p, rp[u]);
    }
    float kl = 0.0f;
#pragma unroll
    for (int u = 0; u < GROUPS; ++u) {
      const long long lane0 = base + 4LL * u * THREADS;
      float th[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float sq = softplus(r[u][j]);
        const float sp = softplus(rp[u][j]);
        th[j] = __fadd_rn(m[u][j], __fmul_rn(sq, e[u][j]));
        const float d = __fsub_rn(m[u][j], mp[u][j]);
        const float num = __fadd_rn(__fmul_rn(sq, sq), __fmul_rn(d, d));
        const float den = __fmul_rn(__fmul_rn(2.0f, sp), sp);
        const float term = __fsub_rn(__fadd_rn(logf(sp / sq), num / den), 0.5f);
        if (lane0 + j < p) kl = __fadd_rn(kl, term);
      }
      store_group<VEC>(theta, lane0, p, th);
    }
    const float part = block_sum(kl, s_warp);
    if (threadIdx.x == 0) parts[c] = part;
  }

  if (!last_block_to_arrive(arrivals)) return;
  float acc = 0.0f;
  for (long long c = threadIdx.x; c < chunks; c += THREADS) {
    acc = __fadd_rn(acc, __ldcg(parts + c));
  }
  const float kl = block_sum(acc, s_warp);
  if (threadIdx.x == 0) *kl_out = kl;
}

const void* kernel_for(int vec) {
  switch (vec) {
    case 4: return reinterpret_cast<const void*>(sample_and_kl_kernel<4>);
    case 2: return reinterpret_cast<const void*>(sample_and_kl_kernel<2>);
    case 1: return reinterpret_cast<const void*>(sample_and_kl_kernel<1>);
    default: return nullptr;
  }
}

}  // namespace
}  // namespace repro_torch

// Blocks of the vec instance one SM keeps resident on the current device;
// < 0 on error.
extern "C" int sample_and_kl_blocks_per_sm(int vec) {
  using namespace repro_torch;
  const void* fn = kernel_for(vec);
  if (fn == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, THREADS, 0);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// kl: one float; parts: one float a chunk of scratch; arrivals: one uint32
// that is 0 and that no other launch in flight uses (the kernel leaves it
// 0).  `chunk` and `vec` come from the launch plan; the six [P] pointers
// must be aligned to 4 vec bytes.  Launch on `stream`; returns the
// cudaError_t of the launch (0 = success).
extern "C" int sample_and_kl_launch(const void* mu, const void* rho, const void* eps,
                                    const void* mu_p, const void* rho_p, void* theta, void* kl,
                                    void* parts, void* arrivals, long long p, int vec,
                                    long long chunk, int grid, void* stream) {
  using namespace repro_torch;
  const void* fn = kernel_for(vec);
  const auto align = static_cast<unsigned long long>(4 * vec);
  bool aligned = true;
  for (const void* ptr : {mu, rho, eps, mu_p, rho_p, static_cast<const void*>(theta)}) {
    aligned = aligned && reinterpret_cast<unsigned long long>(ptr) % align == 0;
  }
  if (fn == nullptr || p <= 0 || chunk != CHUNK || grid <= 0 || !aligned) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* a = static_cast<const float*>(mu);
  const auto* b = static_cast<const float*>(rho);
  const auto* c = static_cast<const float*>(eps);
  const auto* d = static_cast<const float*>(mu_p);
  const auto* e = static_cast<const float*>(rho_p);
  auto* t = static_cast<float*>(theta);
  auto* k = static_cast<float*>(kl);
  auto* s = static_cast<float*>(parts);
  auto* n = static_cast<unsigned int*>(arrivals);
  void* args[] = {&a, &b, &c, &d, &e, &t, &k, &s, &n, &p};
  return static_cast<int>(cudaLaunchKernel(fn, dim3(static_cast<unsigned>(grid)), dim3(THREADS),
                                           args, 0, static_cast<cudaStream_t>(stream)));
}
