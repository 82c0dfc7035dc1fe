// The rate of Ampere-style mma.sync on this card, for
// probes/flash_attention_f32.py --rate: each warp issues `iters` rounds of
// CHAINS independent m16n8k8 tf32 (or m16n8k16 bf16) products into its own
// accumulators, from registers, with no loads.  The sum of the accumulators
// is written so that nothing is optimised away.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int CHAINS = 8;

template <bool TF32>
__global__ void mma_rate_kernel(float* out, int iters) {
  const uint32_t x = 0x3f800000u + threadIdx.x;  // ~1.0 as f32; ~1.0 pairs as bf16
  uint32_t a[4] = {x, x ^ 1u, x ^ 2u, x ^ 3u};
  uint32_t b0 = x ^ 4u, b1 = x ^ 5u;
  float d[CHAINS][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) {
      if constexpr (TF32) {
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
            : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
      } else {
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
            : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
      }
    }
  }
  float sum = 0.0f;
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) sum += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}

}  // namespace

// tf32: 1 for m16n8k8 tf32, 0 for m16n8k16 bf16.  Returns the launch's
// cudaError_t.
extern "C" int mma_rate_launch(float* out, int blocks, int threads, int iters, int tf32,
                               void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (tf32) {
    mma_rate_kernel<true><<<blocks, threads, 0, st>>>(out, iters);
  } else {
    mma_rate_kernel<false><<<blocks, threads, 0, st>>>(out, iters);
  }
  return static_cast<int>(cudaGetLastError());
}
