// Eq. (6) over CSR neighbour tables: each agent gathers only its deg(i) <= D
// neighbour rows of the flat [N, P] posterior, unmasked or masked.
//
// Replaces two TPU kernels of repro/kernels/consensus.py:
// * consensus_fused_sparse (pallas_call at consensus.py:399), MASKED = false;
// * consensus_fused_masked_sparse (pallas_call at consensus.py:572),
//   MASKED = true: an [N] int activity mask; an inactive agent copies its own
//   (mean, rho) row through untouched.
//
// Tables: neighbors [N, D] int32, padded with the agent's own id; weights
// [N, D] float32, padded with 0.0 (core/flat.py neighbor_tables).  For an
// active agent i and lane c, over d = 0 .. D-1 in order, with fp32
// accumulators (the Pallas kernel's per-wire op order):
//   f32 wire:   wp = w[i, d] / (sigma * sigma);  P += wp;  M += wp * mean
//   other wire: P += w[i, d] * wire(prec);  M += w[i, d] * wire(prec * mean)
// where sigma = softplus(rho[nbr[i, d], c]); then mean' = M / P and
// rho' = softplus^-1(1 / sqrt(P)).  Every slot is computed, the zero-weight
// pad slots too, as the reference does: 0 * a non-finite lane is NaN, so
// skipping them would change the result wherever a row is not finite.
//
// What bounds it on the H100: memory.  The unique bytes are the rows that
// some agent reads (8 P bytes each), the two output rows of every agent
// (8 N P) and the tables (8 N D, plus 4 N for the mask); the arithmetic is a
// few tens of operations per gathered lane.
//
// Design:
// * The TPU grid (N, P / BLOCK, D) carries the sum over d in VMEM scratch
//   from one grid step to the next.  Blocks on the card run in no order, so
//   here a block owns (agent i = blockIdx.y, a tile of TILE lanes) and loops
//   over d itself, with the accumulators in registers; each thread owns one
//   lane, so every gather of a warp is one coalesced 128-byte line.
// * There is no scalar prefetch: the block reads row i of the tables itself
//   (one address for the whole block, served by the cache).
// * The wrapper checks the ids of tables that come from the host; ids of
//   tables already on the card are not checked there (that would stall the
//   host on the device), so an id outside [0, N) sets its agent's row to
//   NaN here instead of reading outside the buffers.
// * MASKED: an inactive agent copies its own row directly.  It does not rely
//   on the TPU's "the last gathered tile is the own row" trick.
// * The ragged last tile is masked; the lanes are never padded.
// * Each sum is an IEEE multiply then an IEEE add (__fmul_rn, __fadd_rn), as
//   the reference writes it: no contraction into fma, no fast math.
#include "eq6_common.cuh"

namespace repro_torch {
namespace {

constexpr int TILE = 256;  // lanes per block = threads per block

template <int WIRE, bool MASKED>
__global__ void __launch_bounds__(TILE)
consensus_sparse_kernel(const int* __restrict__ neighbors,
                        const float* __restrict__ weights,
                        const int* __restrict__ active,
                        const float* __restrict__ mean,
                        const float* __restrict__ rho,
                        float* __restrict__ mean_out,
                        float* __restrict__ rho_out, int n, int d_max,
                        long long p) {
  const long long i = blockIdx.y;
  const long long col = static_cast<long long>(blockIdx.x) * TILE + threadIdx.x;
  if (col >= p) return;
  const long long o = i * p + col;
  if (MASKED && active[i] == 0) {
    mean_out[o] = mean[o];
    rho_out[o] = rho[o];
    return;
  }
  const int* nbr = neighbors + i * d_max;
  const float* wts = weights + i * d_max;
  float acc_prec = 0.0f;
  float acc_pm = 0.0f;
  for (int d = 0; d < d_max; ++d) {
    const float w = wts[d];
    const int j = nbr[d];
    if (j < 0 || j >= n) {
      acc_prec = __int_as_float(0x7fc00000);  // NaN
      acc_pm = acc_prec;
      break;
    }
    const long long idx = static_cast<long long>(j) * p + col;
    const float sigma = softplus(rho[idx]);
    const float m = mean[idx];
    if constexpr (WIRE == WIRE_F32) {
      const float wp = w / __fmul_rn(sigma, sigma);
      acc_prec = __fadd_rn(acc_prec, wp);
      acc_pm = __fadd_rn(acc_pm, __fmul_rn(wp, m));
    } else {
      const float prec = 1.0f / __fmul_rn(sigma, sigma);
      const float px = wire_roundtrip<WIRE>(prec);
      const float qx = wire_roundtrip<WIRE>(__fmul_rn(prec, m));
      acc_prec = __fadd_rn(acc_prec, __fmul_rn(w, px));
      acc_pm = __fadd_rn(acc_pm, __fmul_rn(w, qx));
    }
  }
  mean_out[o] = acc_pm / acc_prec;
  rho_out[o] = softplus_inv(1.0f / sqrtf(acc_prec));
}

template <bool MASKED>
int launch(const void* neighbors, const void* weights, const void* active,
           const void* mean, const void* rho, void* mean_out, void* rho_out,
           int n, int d_max, long long p, int wire, void* stream) {
  if (n <= 0 || n > 65535 || d_max <= 0 || p <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>((p + TILE - 1) / TILE),
                  static_cast<unsigned>(n));
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* nb = static_cast<const int*>(neighbors);
  const auto* wt = static_cast<const float*>(weights);
  const auto* a = static_cast<const int*>(active);
  const auto* m = static_cast<const float*>(mean);
  const auto* r = static_cast<const float*>(rho);
  auto* mo = static_cast<float*>(mean_out);
  auto* ro = static_cast<float*>(rho_out);
  switch (wire) {
    case WIRE_F32:
      consensus_sparse_kernel<WIRE_F32, MASKED><<<grid, TILE, 0, s>>>(
          nb, wt, a, m, r, mo, ro, n, d_max, p);
      break;
    case WIRE_BF16:
      consensus_sparse_kernel<WIRE_BF16, MASKED><<<grid, TILE, 0, s>>>(
          nb, wt, a, m, r, mo, ro, n, d_max, p);
      break;
    case WIRE_F16:
      consensus_sparse_kernel<WIRE_F16, MASKED><<<grid, TILE, 0, s>>>(
          nb, wt, a, m, r, mo, ro, n, d_max, p);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

// Launch on `stream`; each returns the cudaError_t of the launch (0 = success).
extern "C" int consensus_sparse_launch(const void* neighbors,
                                       const void* weights, const void* mean,
                                       const void* rho, void* mean_out,
                                       void* rho_out, int n, int d_max,
                                       long long p, int wire, void* stream) {
  return repro_torch::launch<false>(neighbors, weights, nullptr, mean, rho,
                                    mean_out, rho_out, n, d_max, p, wire,
                                    stream);
}

// `active` holds n int32 flags (0 = the agent copies its own row).
extern "C" int consensus_masked_sparse_launch(
    const void* neighbors, const void* weights, const void* active,
    const void* mean, const void* rho, void* mean_out, void* rho_out, int n,
    int d_max, long long p, int wire, void* stream) {
  return repro_torch::launch<true>(neighbors, weights, active, mean, rho,
                                   mean_out, rho_out, n, d_max, p, wire,
                                   stream);
}
