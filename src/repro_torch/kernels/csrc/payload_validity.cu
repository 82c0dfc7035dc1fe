// Per-agent validity of the exchanged eq. (6) payload, in one launch.
//
// Replaces the TPU kernel repro/kernels/consensus.py:payload_validity_fused
// (pallas_call at consensus.py:461).  Agent i is valid iff for every lane c
// the wire-rounded prec_x = wire(softplus(rho)^-2) and pm_x = wire(prec *
// mean) satisfy: both finite, prec_x > 0, prec_x <= bound, |pm_x| <= bound.
// Every comparison with a NaN is false, as in the reference, so a NaN lane
// flags its agent.
//
// What bounds it on the H100: memory by its bytes (8 N P read, N written:
// 14.3 MB, 4.3 us of HBM at the gossip slice's N = 9, P = 199,210), but at
// that size the launch, the ~60 instructions a lane (two softplus halves,
// an IEEE division) and the reduction across blocks cost more than the
// bytes.  The parent design ran three device kernels a call (a fill, the
// check, a cast) and refused N > 65535.
//
// Design (one kernel per call; the launch plan is kernels/stream_plan.py):
// * The [N, P] buffers are streamed as one flat run of N P lanes, cut into
//   chunks of 4096.  Thread t of a chunk owns 2 groups of 4 consecutive
//   lanes (group u at 4 (chunk base + u 512 + t)), loaded with 16-, 8- or
//   4-byte loads as the pointers allow (template VEC); all 16 values are in
//   registers before the first softplus.  The grid is at most one wave
//   (SMs x occupancy: 3 blocks of 512) and a block walks chunks b, b + grid.
//   Indexing by flat lane lifts the old limit of 65535 agents: N P < 2^63.
// * A chunk may cover many rows (small P) or part of one.  Rows strictly
//   inside it are decided there: written 1, then 0 by any thread holding a
//   bad lane of that row (after a barrier, so the zeros win).  For its first
//   and last row it writes one verdict byte each into `edge`.
// * The last block to arrive (a release-acquire add on an arrival counter,
//   eq6_common.cuh) finishes the rows that cross chunks, reading each verdict
//   once: a row takes the verdict of the chunk it starts in, then every
//   later chunk of the row with a bad verdict clears it.  AND is order-free,
//   so the flags do not depend on the blocks' order.
// * Arithmetic as eq6_common.cuh: IEEE division, correctly rounded wire
//   conversions, no fast math: bit-equal to payload_validity_plain.
#include "eq6_common.cuh"

namespace repro_torch {
namespace {

constexpr int THREADS = 512;
constexpr int GROUPS = 2;  // 4-lane groups a thread owns per chunk
constexpr int MIN_BLOCKS = 3;  // resident per SM: at most 40 registers a thread
constexpr long long CHUNK = THREADS * GROUPS * 4;

// the rows of [N, P] that chunk c's lanes [first, last] fall in
struct Span {
  long long first, rf, rl;
};

__device__ __forceinline__ Span chunk_span(long long c, long long total, long long p) {
  const long long first = c * CHUNK;
  return {first, first / p, (min(first + CHUNK, total) - 1) / p};
}

template <int WIRE, int VEC>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
payload_validity_kernel(const float* __restrict__ mean, const float* __restrict__ rho,
                        unsigned char* __restrict__ ok, unsigned char* __restrict__ edge,
                        unsigned int* __restrict__ arrivals, long long n, long long p,
                        float bound) {
  __shared__ int s_head, s_tail;
  const long long total = n * p;
  const long long chunks = (total + CHUNK - 1) / CHUNK;
  for (long long c = blockIdx.x; c < chunks; c += gridDim.x) {
    const Span s = chunk_span(c, total, p);
    const long long base = s.first + 4LL * threadIdx.x;
    float m[GROUPS][4], r[GROUPS][4];
#pragma unroll
    for (int u = 0; u < GROUPS; ++u) {
      load_group<VEC>(mean, base + 4LL * u * THREADS, total, m[u]);
      load_group<VEC>(rho, base + 4LL * u * THREADS, total, r[u]);
    }
    unsigned bad = 0;  // bit 4u + j: lane j of group u
#pragma unroll
    for (int u = 0; u < GROUPS; ++u) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float prec = precision(r[u][j]);
        const float px = wire_roundtrip<WIRE>(prec);
        const float qx = wire_roundtrip<WIRE>(prec * m[u][j]);
        const bool good = isfinite(px) && px > 0.0f && px <= bound && isfinite(qx) &&
                          fabsf(qx) <= bound;
        if (!good && base + 4LL * u * THREADS + j < total) bad |= 1u << (4 * u + j);
      }
    }
    for (long long row = s.rf + 1 + threadIdx.x; row < s.rl; row += THREADS) ok[row] = 1;
    if (threadIdx.x == 0) {
      s_head = 1;
      s_tail = 1;
    }
    __syncthreads();  // the 1s above before the 0s below
    while (bad) {
      const int bit = __ffs(bad) - 1;
      bad &= bad - 1;
      const long long row = (base + 4LL * (bit >> 2) * THREADS + (bit & 3)) / p;
      if (row == s.rf) {
        s_head = 0;
      } else if (row == s.rl) {
        s_tail = 0;
      } else {
        ok[row] = 0;
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      edge[2 * c] = static_cast<unsigned char>(s_head);
      edge[2 * c + 1] = static_cast<unsigned char>(s.rf == s.rl ? s_head : s_tail);
    }
    __syncthreads();  // s_head, s_tail are reset for the next chunk
  }

  if (!last_block_to_arrive(arrivals)) return;
  // Rows that cross chunks: a row takes the verdict of the chunk it starts
  // in; then each later chunk of the row with a bad verdict clears it.
  bool any_clear = false;
  for (long long c = threadIdx.x; c < chunks; c += THREADS) {
    const Span s = chunk_span(c, total, p);
    const unsigned char head = __ldcg(edge + 2 * c);
    if (s.rf * p == s.first && s.rf != s.rl) ok[s.rf] = head;
    if (s.rl * p >= s.first) ok[s.rl] = __ldcg(edge + 2 * c + 1);
    any_clear = any_clear || (s.rf * p < s.first && head == 0);
  }
  if (!__syncthreads_or(any_clear)) return;  // and the writes above come first
  for (long long c = threadIdx.x; c < chunks; c += THREADS) {
    const Span s = chunk_span(c, total, p);
    if (s.rf * p < s.first && __ldcg(edge + 2 * c) == 0) ok[s.rf] = 0;
  }
}

template <int WIRE>
const void* instance(int vec) {
  switch (vec) {
    case 4: return reinterpret_cast<const void*>(payload_validity_kernel<WIRE, 4>);
    case 2: return reinterpret_cast<const void*>(payload_validity_kernel<WIRE, 2>);
    case 1: return reinterpret_cast<const void*>(payload_validity_kernel<WIRE, 1>);
    default: return nullptr;
  }
}

const void* kernel_for(int wire, int vec) {
  switch (wire) {
    case WIRE_F32: return instance<WIRE_F32>(vec);
    case WIRE_BF16: return instance<WIRE_BF16>(vec);
    case WIRE_F16: return instance<WIRE_F16>(vec);
    default: return nullptr;
  }
}

}  // namespace
}  // namespace repro_torch

// Blocks of the (wire, vec) instance one SM keeps resident on the current
// device (the wave is this times the SM count); < 0 on error.
extern "C" int payload_validity_blocks_per_sm(int wire, int vec) {
  using namespace repro_torch;
  const void* fn = kernel_for(wire, vec);
  if (fn == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, THREADS, 0);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// ok: n bytes (bool) written by the kernel; edge: 2 bytes a chunk of
// scratch; arrivals: one uint32 that is 0 and that no other launch in
// flight uses (the kernel leaves it 0).  `chunk` and `vec` come from the
// launch plan; the pointers must be aligned to 4 vec bytes.  Launch on
// `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int payload_validity_launch(const void* mean, const void* rho, void* ok, void* edge,
                                       void* arrivals, long long n, long long p, float bound,
                                       int wire, int vec, long long chunk, int grid,
                                       void* stream) {
  using namespace repro_torch;
  const void* fn = kernel_for(wire, vec);
  const auto align = static_cast<unsigned long long>(4 * vec);
  if (fn == nullptr || n <= 0 || p <= 0 || n > 0x7fffffffffffffffLL / p || chunk != CHUNK ||
      grid <= 0 || reinterpret_cast<unsigned long long>(mean) % align != 0 ||
      reinterpret_cast<unsigned long long>(rho) % align != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* m = static_cast<const float*>(mean);
  const auto* r = static_cast<const float*>(rho);
  auto* flags = static_cast<unsigned char*>(ok);
  auto* scratch = static_cast<unsigned char*>(edge);
  auto* counter = static_cast<unsigned int*>(arrivals);
  void* args[] = {&m, &r, &flags, &scratch, &counter, &n, &p, &bound};
  return static_cast<int>(cudaLaunchKernel(fn, dim3(static_cast<unsigned>(grid)), dim3(THREADS),
                                           args, 0, static_cast<cudaStream_t>(stream)));
}
