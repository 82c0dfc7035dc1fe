// Per-agent validity of the exchanged eq. (6) payload.
//
// Replaces the TPU kernel repro/kernels/consensus.py:payload_validity_fused
// (pallas_call at consensus.py:461).  Agent i is valid iff for every lane c
// the wire-rounded prec_x = wire(softplus(rho)^-2) and pm_x = wire(prec *
// mean) satisfy: both finite, prec_x > 0, prec_x <= bound, |pm_x| <= bound.
// Every comparison with a NaN is false, as in the reference, so a NaN lane
// flags its agent.
//
// What bounds it on the H100: memory.  It reads mean and rho once (8 N P
// bytes) and writes N flags; the arithmetic is a few operations per byte.
//
// Design: the Pallas kernel revisits one [N, 1] output across a sequential
// grid.  Blocks on the card run in no order, so here the wrapper sets one
// int flag per agent to 1 and the grid is (lane tiles, agents): each block
// walks its tile of one agent's row with coalesced loads, reduces its verdict
// with __syncthreads_and, and a block that saw a bad lane clears its agent's
// flag with atomicAnd.  AND is order-free, so the result is deterministic.
#include "eq6_common.cuh"

namespace repro_torch {
namespace {

constexpr int THREADS = 256;
constexpr int LANES_PER_THREAD = 8;

template <int WIRE>
__global__ void __launch_bounds__(THREADS)
payload_validity_kernel(const float* __restrict__ mean,
                        const float* __restrict__ rho, int* __restrict__ ok,
                        long long p, float bound) {
  const long long row = blockIdx.y;
  const float* m = mean + row * p;
  const float* r = rho + row * p;
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  bool good = true;
  for (long long c = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
       c < p; c += stride) {
    const float prec = precision(r[c]);
    const float px = wire_roundtrip<WIRE>(prec);
    const float qx = wire_roundtrip<WIRE>(prec * m[c]);
    good = good && isfinite(px) && px > 0.0f && px <= bound && isfinite(qx) &&
           fabsf(qx) <= bound;
  }
  if (!__syncthreads_and(good) && threadIdx.x == 0) {
    atomicAnd(ok + row, 0);
  }
}

}  // namespace
}  // namespace repro_torch

// `ok` holds n int32 flags the caller set to 1.  Launch on `stream`; returns
// the cudaError_t of the launch (0 = success).
extern "C" int payload_validity_launch(const void* mean, const void* rho,
                                       void* ok, int n, long long p,
                                       float bound, int wire, void* stream) {
  using namespace repro_torch;
  if (n <= 0 || n > 65535 || p <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long per_block = static_cast<long long>(THREADS) * LANES_PER_THREAD;
  const dim3 grid(static_cast<unsigned>((p + per_block - 1) / per_block),
                  static_cast<unsigned>(n));
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* m = static_cast<const float*>(mean);
  const auto* r = static_cast<const float*>(rho);
  auto* flags = static_cast<int*>(ok);
  switch (wire) {
    case WIRE_F32:
      payload_validity_kernel<WIRE_F32><<<grid, THREADS, 0, s>>>(m, r, flags, p, bound);
      break;
    case WIRE_BF16:
      payload_validity_kernel<WIRE_BF16><<<grid, THREADS, 0, s>>>(m, r, flags, p, bound);
      break;
    case WIRE_F16:
      payload_validity_kernel<WIRE_F16><<<grid, THREADS, 0, s>>>(m, r, flags, p, bound);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
