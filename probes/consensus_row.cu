// Probe kernels for the timing study of csrc/consensus_row.cu (one agent's
// eq. (6) at N = 9, f32 wire), built and timed by probes/consensus_row.py.
// They are not part of the port: each isolates one part of the shipped
// small-N kernel or tries a layout it did not take.
//   pairs<THREADS>:  2 lanes a thread, 8-byte loads, all rows first;
//   async<THREADS>:  2 lanes a thread copied by cp.async (8 bytes) into a
//                    shared-memory ring, one commit group per row, row j
//                    summed once its group has landed;
//   stream:          1 lane a thread, tiles b, b + grid, ... with the next
//                    tile's rows loaded while this tile's are summed (a
//                    grid of 3 blocks an SM);
//   lanes<MODE>:     the shipped layout (1 lane a thread, 256 a block, all
//                    rows first); MODE 1 makes the inputs from the lane
//                    index (the arithmetic alone), MODE 2 replaces the
//                    arithmetic by two sums (the loads and stores alone).
#include <utility>

#include "../src/repro_torch/kernels/csrc/eq6_common.cuh"

namespace {

namespace rt = repro_torch;
constexpr int NB = 9;

__device__ __forceinline__ void term(float w, float r, float m, float& ap, float& am) {
  const float wp = __fmul_rn(w, rt::precision(r));  // the f32 wire's op order
  ap = __fadd_rn(ap, wp);
  am = __fadd_rn(am, __fmul_rn(wp, m));
}

__device__ __forceinline__ void store(float* mo, float* ro, long long c, float ap, float am) {
  mo[c] = am / ap;
  ro[c] = rt::softplus_inv(1.0f / sqrtf(ap));
}

template <int THREADS>
__global__ void __launch_bounds__(THREADS)
pairs_kernel(const float* __restrict__ w_row, const float* __restrict__ mean,
             const float* __restrict__ rho, float* __restrict__ mo, float* __restrict__ ro,
             long long p) {
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  for (long long g = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x; 2 * g < p;
       g += stride) {
    float w[NB];
    float2 m[NB], r[NB];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      w[j] = __ldg(w_row + j);
      m[j] = __ldg(reinterpret_cast<const float2*>(mean + j * p) + g);
      r[j] = __ldg(reinterpret_cast<const float2*>(rho + j * p) + g);
    }
    float ap[2] = {0.0f, 0.0f}, am[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      term(w[j], r[j].x, m[j].x, ap[0], am[0]);
      term(w[j], r[j].y, m[j].y, ap[1], am[1]);
    }
    store(mo, ro, 2 * g, ap[0], am[0]);
    store(mo, ro, 2 * g + 1, ap[1], am[1]);
  }
}

template <int K>
__device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;" ::"n"(K) : "memory");
}

template <int THREADS>
__global__ void __launch_bounds__(THREADS)
async_kernel(const float* __restrict__ w_row, const float* __restrict__ mean,
             const float* __restrict__ rho, float* __restrict__ mo, float* __restrict__ ro,
             long long p) {
  __shared__ float2 s_m[NB][THREADS];
  __shared__ float2 s_r[NB][THREADS];
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  for (long long g = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x; 2 * g < p;
       g += stride) {
    float w[NB];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      w[j] = __ldg(w_row + j);
      const auto sm = static_cast<unsigned>(__cvta_generic_to_shared(&s_m[j][threadIdx.x]));
      const auto sr = static_cast<unsigned>(__cvta_generic_to_shared(&s_r[j][threadIdx.x]));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(sm), "l"(mean + j * p + 2 * g)
                   : "memory");
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(sr), "l"(rho + j * p + 2 * g)
                   : "memory");
      asm volatile("cp.async.commit_group;" ::: "memory");
    }
    float ap[2] = {0.0f, 0.0f}, am[2] = {0.0f, 0.0f};
    // a thread reads back only what it copied: waiting for its own groups is enough
    [&]<int... J>(std::integer_sequence<int, J...>) {
      ([&] {
        wait_group<NB - 1 - J>();
        const float2 m = s_m[J][threadIdx.x], r = s_r[J][threadIdx.x];
        term(w[J], r.x, m.x, ap[0], am[0]);
        term(w[J], r.y, m.y, ap[1], am[1]);
      }(), ...);
    }(std::make_integer_sequence<int, NB>{});
    store(mo, ro, 2 * g, ap[0], am[0]);
    store(mo, ro, 2 * g + 1, ap[1], am[1]);
  }
}

template <int MODE>
__global__ void __launch_bounds__(256)
lanes_kernel(const float* __restrict__ w_row, const float* __restrict__ mean,
             const float* __restrict__ rho, float* __restrict__ mo, float* __restrict__ ro,
             long long p) {
  for (long long c = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x; c < p;
       c += static_cast<long long>(gridDim.x) * 256) {
    float w[NB], m[NB], r[NB];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      w[j] = __ldg(w_row + j);
      if constexpr (MODE == 1) {
        m[j] = static_cast<float>(c & 1023) * 1e-3f;
        r[j] = -4.0f + static_cast<float>((c + j) & 511) * 0.01f;
      } else {
        m[j] = __ldg(mean + j * p + c);
        r[j] = __ldg(rho + j * p + c);
      }
    }
    float ap = 0.0f, am = 0.0f;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      if constexpr (MODE == 2) {
        ap += w[j] * r[j];
        am += w[j] * m[j];
      } else {
        term(w[j], r[j], m[j], ap, am);
      }
    }
    if constexpr (MODE == 2) {
      mo[c] = am;
      ro[c] = ap;
    } else {
      store(mo, ro, c, ap, am);
    }
  }
}

__global__ void __launch_bounds__(256)
stream_kernel(const float* __restrict__ w_row, const float* __restrict__ mean,
              const float* __restrict__ rho, float* __restrict__ mo, float* __restrict__ ro,
              long long p) {
  const long long stride = static_cast<long long>(gridDim.x) * 256;
  long long c = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  float w[NB], m[NB], r[NB], m2[NB], r2[NB];
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    w[j] = __ldg(w_row + j);
    m[j] = c < p ? __ldg(mean + j * p + c) : 0.0f;
    r[j] = c < p ? __ldg(rho + j * p + c) : 0.0f;
  }
  for (; c < p; c += stride) {
    const long long next = c + stride;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      m2[j] = next < p ? __ldg(mean + j * p + next) : 0.0f;
      r2[j] = next < p ? __ldg(rho + j * p + next) : 0.0f;
    }
    float ap = 0.0f, am = 0.0f;
#pragma unroll
    for (int j = 0; j < NB; ++j) term(w[j], r[j], m[j], ap, am);
    store(mo, ro, c, ap, am);
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      m[j] = m2[j];
      r[j] = r2[j];
    }
  }
}

struct Variant {
  const void* fn;
  int threads;
  int lanes;
};

Variant variant(int v) {
  switch (v) {
    case 0: return {reinterpret_cast<const void*>(pairs_kernel<128>), 128, 2};
    case 1: return {reinterpret_cast<const void*>(async_kernel<256>), 256, 2};
    case 2: return {reinterpret_cast<const void*>(lanes_kernel<1>), 256, 1};
    case 3: return {reinterpret_cast<const void*>(lanes_kernel<2>), 256, 1};
    case 4: return {reinterpret_cast<const void*>(stream_kernel), 256, 1};
    default: return {nullptr, 0, 0};
  }
}

}  // namespace

extern "C" int probe_threads(int v) { return variant(v).threads; }
// blocks an SM of a fixed grid (the stream variant), 0 = one balanced wave
extern "C" int probe_grid_per_sm(int v) { return v == 4 ? 3 : 0; }
extern "C" int probe_lanes(int v) { return variant(v).lanes; }

// blocks of variant v one SM keeps resident; < 0 on error
extern "C" int probe_blocks_per_sm(int v) {
  const Variant k = variant(v);
  int blocks = 0;
  if (k.fn == nullptr) return -1;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k.fn,
                                                                        k.threads, 0);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// N = 9 rows, p lanes (even for the 2-lane variants); returns the cudaError_t
extern "C" int probe_launch(int v, const void* w_row, const void* mean, const void* rho,
                            void* mean_out, void* rho_out, long long p, int grid, void* stream) {
  const Variant k = variant(v);
  if (k.fn == nullptr || grid <= 0 || p % k.lanes != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  void* args[] = {&w_row, &mean, &rho, &mean_out, &rho_out, &p};
  return static_cast<int>(cudaLaunchKernel(k.fn, dim3(grid), dim3(k.threads), args, 0,
                                           static_cast<cudaStream_t>(stream)));
}
