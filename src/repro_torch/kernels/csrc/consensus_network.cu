// Eq. (6) for the whole network in one pass over the flat [N, P] posterior,
// unmasked (the synchronous round) or masked (one gossip event window).
//
// Replaces two TPU kernels of repro/kernels/consensus.py:
// * consensus_fused_network (pallas_call at consensus.py:217), MASKED = false;
// * consensus_fused_masked (pallas_call at consensus.py:288), MASKED = true:
//   an [N] int activity mask; active rows get the eq. (6) row below, inactive
//   rows get their (mean, rho) copied through untouched (no softplus round
//   trip, so an idle agent is bit-stable across windows).
// Both instantiations run the same accumulation loop, so an active row of the
// masked kernel is bitwise the network kernel's row at every wire dtype.
//
// For every agent i and lane c:
//   prec_j  = softplus(rho[j, c])^-2               (fp32)
//   prec_x  = wire(prec_j), pm_x = wire(prec_j * mean[j, c])
//   P_i     = sum_j W[i, j] prec_x,  M_i = sum_j W[i, j] pm_x   (fp32)
//   mean'   = M_i / P_i,  rho' = softplus^-1(1 / sqrt(P_i))
//
// What bounds it on the H100: memory.  Each lane of mean and rho is read
// once and each lane of the two outputs written once (16 N P bytes, plus
// N^2 + N words of W and mask), against
// 2 N^2 P multiply-adds; at the main path's N = 9 that is under one operation
// per byte, far below the card's ridge point.
//
// Design:
// * One block owns a tile of TILE lanes and each thread one lane, so every
//   load and store of a warp is one coalesced 128-byte line.  The ragged
//   last tile is masked; the lanes are never padded.
// * The TPU kernel keeps W whole in VMEM.  W [N, N] fits a block's shared
//   memory only up to N ~ 238, so here the input rows are walked in chunks
//   of JC: each thread stages the wire-rounded (prec_x, pm_x) of its lane for
//   the chunk in shared memory (all JC loads in flight together), and the
//   chunk's IC x JC block of W sits beside them.
// * Output rows are walked in chunks of IC so the fp32 accumulators of a
//   chunk live in registers.  For N <= IC (the main path) the inputs are read
//   exactly once; for larger N each output chunk reads them again, mostly
//   from the 50 MB L2.
// * MASKED: only the final write differs.  An inactive row's lane is copied
//   from the inputs (a second read of that row, mostly from L2); the mask
//   entry is one address for the whole block, served by the cache.
// * No fast math: IEEE division and sqrt, rsqrt written as 1 / sqrtf.
#include "eq6_common.cuh"

namespace repro_torch {
namespace {

constexpr int TILE = 256;  // lanes per block = threads per block
constexpr int JC = 16;     // input rows staged per chunk
constexpr int IC = 16;     // output rows accumulated in registers per chunk

template <int WIRE, bool MASKED>
__global__ void __launch_bounds__(TILE)
consensus_network_kernel(const float* __restrict__ W,
                         const int* __restrict__ active,
                         const float* __restrict__ mean,
                         const float* __restrict__ rho,
                         float* __restrict__ mean_out,
                         float* __restrict__ rho_out, int n, long long p) {
  __shared__ float s_prec[JC][TILE];
  __shared__ float s_pm[JC][TILE];
  __shared__ float s_w[IC][JC];

  const int t = threadIdx.x;
  const long long col = static_cast<long long>(blockIdx.x) * TILE + t;
  const bool live = col < p;

  for (int i0 = 0; i0 < n; i0 += IC) {
    float acc_prec[IC];
    float acc_pm[IC];
#pragma unroll
    for (int ii = 0; ii < IC; ++ii) {
      acc_prec[ii] = 0.0f;
      acc_pm[ii] = 0.0f;
    }
    for (int j0 = 0; j0 < n; j0 += JC) {
      const int jn = min(JC, n - j0);
      __syncthreads();  // the previous chunk's W block is consumed
      if (live) {
        for (int jj = 0; jj < jn; ++jj) {
          const long long idx = static_cast<long long>(j0 + jj) * p + col;
          const float prec = precision(rho[idx]);
          s_prec[jj][t] = wire_roundtrip<WIRE>(prec);
          s_pm[jj][t] = wire_roundtrip<WIRE>(prec * mean[idx]);
        }
      }
      for (int k = t; k < IC * JC; k += TILE) {
        const int i = i0 + k / JC;
        const int j = j0 + k % JC;
        s_w[k / JC][k % JC] =
            (i < n && j < n) ? W[static_cast<long long>(i) * n + j] : 0.0f;
      }
      __syncthreads();
      if (live) {
        for (int jj = 0; jj < jn; ++jj) {
          const float px = s_prec[jj][t];
          const float qx = s_pm[jj][t];
#pragma unroll
          for (int ii = 0; ii < IC; ++ii) {
            acc_prec[ii] = fmaf(s_w[ii][jj], px, acc_prec[ii]);
            acc_pm[ii] = fmaf(s_w[ii][jj], qx, acc_pm[ii]);
          }
        }
      }
    }
    if (live) {
#pragma unroll
      for (int ii = 0; ii < IC; ++ii) {
        const int i = i0 + ii;
        if (i < n) {
          const long long o = static_cast<long long>(i) * p + col;
          if (MASKED && active[i] == 0) {
            mean_out[o] = mean[o];
            rho_out[o] = rho[o];
          } else {
            mean_out[o] = acc_pm[ii] / acc_prec[ii];
            rho_out[o] = softplus_inv(1.0f / sqrtf(acc_prec[ii]));
          }
        }
      }
    }
  }
}

template <bool MASKED>
int launch(const void* W, const void* active, const void* mean,
           const void* rho, void* mean_out, void* rho_out, int n, long long p,
           int wire, void* stream) {
  if (n <= 0 || p <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((p + TILE - 1) / TILE));
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* w = static_cast<const float*>(W);
  const auto* a = static_cast<const int*>(active);
  const auto* m = static_cast<const float*>(mean);
  const auto* r = static_cast<const float*>(rho);
  auto* mo = static_cast<float*>(mean_out);
  auto* ro = static_cast<float*>(rho_out);
  switch (wire) {
    case WIRE_F32:
      consensus_network_kernel<WIRE_F32, MASKED><<<grid, TILE, 0, s>>>(w, a, m, r, mo, ro, n, p);
      break;
    case WIRE_BF16:
      consensus_network_kernel<WIRE_BF16, MASKED><<<grid, TILE, 0, s>>>(w, a, m, r, mo, ro, n, p);
      break;
    case WIRE_F16:
      consensus_network_kernel<WIRE_F16, MASKED><<<grid, TILE, 0, s>>>(w, a, m, r, mo, ro, n, p);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

// Launch on `stream`; each returns the cudaError_t of the launch (0 = success).
extern "C" int consensus_network_launch(const void* W, const void* mean,
                                        const void* rho, void* mean_out,
                                        void* rho_out, int n, long long p,
                                        int wire, void* stream) {
  return repro_torch::launch<false>(W, nullptr, mean, rho, mean_out, rho_out,
                                    n, p, wire, stream);
}

// `active` holds n int32 flags (0 = the row passes through).
extern "C" int consensus_masked_launch(const void* W, const void* active,
                                       const void* mean, const void* rho,
                                       void* mean_out, void* rho_out, int n,
                                       long long p, int wire, void* stream) {
  return repro_torch::launch<true>(W, active, mean, rho, mean_out, rho_out, n,
                                   p, wire, stream);
}
