// Eq. (6) for ONE agent: a weight row w_row [N] over the stacked neighbour
// posteriors mean, rho [N, P] -> the agent's new mean, rho [P].
//
// Replaces the TPU kernel consensus_fused of repro/kernels/consensus.py
// (pallas_call at consensus.py:153), the kernel behind kernels/ops.py
// consensus_posterior.  For every lane c, over j = 0 .. N-1 in order, with
// fp32 accumulators, in that kernel's own op order (which differs from the
// network kernel's W @ (prec * mean)):
//   prec     = 1 / (sigma * sigma),  sigma = softplus(rho[j, c])
//   f32 wire:   wp = w[j] * prec;  P += wp;  M += wp * mean[j, c]
//   other wire: P += w[j] * wire(prec);  M += w[j] * wire(prec * mean[j, c])
//   mean' = M / P,  rho' = softplus^-1(1 / sqrt(P))
// Zero weights are computed, not skipped, as the reference does.
//
// What bounds it on the H100: memory.  Each lane of mean and rho is read
// once and each output lane written once (8 N P + 8 P bytes, plus 4 N for
// the row), against a few tens of operations per input lane.
//
// Design:
// * One block owns a tile of TILE lanes and each thread one lane, so every
//   load and store of a warp is one coalesced 128-byte line.  The ragged last
//   tile is masked; the lanes are never padded (the TPU pads rho with 1.0).
// * The TPU kernel keeps w_row whole in VMEM.  Here the row is staged in
//   shared memory WCHUNK entries at a time, so any N fits.
// * Each product and sum is an IEEE multiply then an IEEE add (__fmul_rn,
//   __fadd_rn): no contraction into fma, no fast math; rsqrt is 1 / sqrtf.
#include "eq6_common.cuh"

namespace repro_torch {
namespace {

constexpr int TILE = 256;     // lanes per block = threads per block
constexpr int WCHUNK = 1024;  // entries of w_row staged at a time

template <int WIRE>
__global__ void __launch_bounds__(TILE)
consensus_row_kernel(const float* __restrict__ w_row,
                     const float* __restrict__ mean,
                     const float* __restrict__ rho,
                     float* __restrict__ mean_out,
                     float* __restrict__ rho_out, int n, long long p) {
  __shared__ float s_w[WCHUNK];
  const long long col = static_cast<long long>(blockIdx.x) * TILE + threadIdx.x;
  const bool live = col < p;
  float acc_prec = 0.0f;
  float acc_pm = 0.0f;
  for (int j0 = 0; j0 < n; j0 += WCHUNK) {
    const int jn = min(WCHUNK, n - j0);
    __syncthreads();  // the previous chunk of the row is consumed
    for (int k = threadIdx.x; k < jn; k += TILE) s_w[k] = w_row[j0 + k];
    __syncthreads();
    if (live) {
#pragma unroll 8
      for (int jj = 0; jj < jn; ++jj) {
        const long long idx = static_cast<long long>(j0 + jj) * p + col;
        const float w = s_w[jj];
        const float prec = precision(rho[idx]);
        const float m = mean[idx];
        if constexpr (WIRE == WIRE_F32) {
          const float wp = __fmul_rn(w, prec);
          acc_prec = __fadd_rn(acc_prec, wp);
          acc_pm = __fadd_rn(acc_pm, __fmul_rn(wp, m));
        } else {
          const float px = wire_roundtrip<WIRE>(prec);
          const float qx = wire_roundtrip<WIRE>(__fmul_rn(prec, m));
          acc_prec = __fadd_rn(acc_prec, __fmul_rn(w, px));
          acc_pm = __fadd_rn(acc_pm, __fmul_rn(w, qx));
        }
      }
    }
  }
  if (live) {
    mean_out[col] = acc_pm / acc_prec;
    rho_out[col] = softplus_inv(1.0f / sqrtf(acc_prec));
  }
}

}  // namespace
}  // namespace repro_torch

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int consensus_row_launch(const void* w_row, const void* mean,
                                    const void* rho, void* mean_out,
                                    void* rho_out, int n, long long p, int wire,
                                    void* stream) {
  using namespace repro_torch;
  if (n <= 0 || p <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((p + TILE - 1) / TILE));
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* w = static_cast<const float*>(w_row);
  const auto* m = static_cast<const float*>(mean);
  const auto* r = static_cast<const float*>(rho);
  auto* mo = static_cast<float*>(mean_out);
  auto* ro = static_cast<float*>(rho_out);
  switch (wire) {
    case WIRE_F32:
      consensus_row_kernel<WIRE_F32><<<grid, TILE, 0, s>>>(w, m, r, mo, ro, n, p);
      break;
    case WIRE_BF16:
      consensus_row_kernel<WIRE_BF16><<<grid, TILE, 0, s>>>(w, m, r, mo, ro, n, p);
      break;
    case WIRE_F16:
      consensus_row_kernel<WIRE_F16><<<grid, TILE, 0, s>>>(w, m, r, mo, ro, n, p);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
