// Eq. (6) for ONE agent: a weight row w_row [N] over the stacked neighbour
// posteriors mean, rho [N, P] -> the agent's new mean, rho [P].
//
// Replaces the TPU kernel consensus_fused of repro/kernels/consensus.py
// (consensus.py:131, pallas_call at :153; body _consensus_kernel at :107),
// the kernel behind kernels/ops.py consensus_posterior.  For every lane c,
// over j = 0 .. N-1 in order, with fp32 accumulators, in that kernel's own
// op order (which differs from the network kernel's W @ (prec * mean)):
//   prec     = 1 / (sigma * sigma),  sigma = softplus(rho[j, c])
//   f32 wire:   wp = w[j] * prec;  P += wp;  M += wp * mean[j, c]
//   other wire: P += w[j] * wire(prec);  M += w[j] * wire(prec * mean[j, c])
//   mean' = M / P,  rho' = softplus^-1(1 / sqrt(P))
// Zero weights are computed, not skipped, as the reference does.  Each
// product and sum is an IEEE multiply then an IEEE add (__fmul_rn,
// __fadd_rn): no contraction into fma, no fast math; rsqrt is 1 / sqrtf.
// Every instance below runs exactly this sequence for each lane, so all of
// them give the same bits.
//
// What bounds it on the H100: instruction issue, under the bit contract.
// The bytes are each lane of mean and rho read once and the two output rows
// written once, 8 N P + 8 P + 4 N: 15.9 MB, 4.76 us at 3.35 TB/s at the
// slice's N = 9, P = 199,210.  The instructions, read from cuobjdump -sass
// of consensus_row_small_kernel<0, N>: an input element is ~60 (expf ~8,
// log1pf ~25 with its special-value check, the square and the IEEE
// reciprocal ~11 with its slow-path check, fmax, two multiplies, two adds,
// the load), an output lane ~130 more (a division, a square root, a
// reciprocal, softplus^-1 = expm1f + logf, each with its checks).  The bit
// contract fixes every one of them.  On the card that arithmetic alone, with
// the inputs made from the lane index, takes as long as the byte bound, and
// the loads alone about half as long warm (probes/consensus_row.py,
// PERF.md): the kernel is bound by issue, and what it can win is the
// overlap of its loads with that arithmetic: every load in flight at once,
// on as many warps as the SMs hold.
//
// Why not TMA: a row of the slice is 4 P = 796,840 bytes, not a multiple of
// 16, and cuTensorMapEncodeTiled requires every global stride to be one
// (cp.async.bulk likewise needs 16-byte aligned addresses), so the tensor
// memory accelerator cannot address these rows.
//
// Design (launch plan: kernels/launch_plan.py row_plan).  Both paths walk
// tiles of 256 lanes, one lane a thread, block b taking tiles b, b + grid,
// ... over a grid of at most one wave (SMs x the instance's occupancy),
// balanced so that no block walks a second tile while others idle; the
// ragged end is masked, the lanes are never padded (the TPU pads rho with
// 1.0).
// * small (N <= 16, consensus_row_small_kernel<WIRE, N>): a thread issues
//   the loads of all N rows of its lane (4 bytes each) and the N weights
//   (uniform loads into registers: no shared memory, no barrier) before the
//   first softplus.  An instance is compiled for each N, its loops unrolled
//   over exactly N rows: with no runtime row test the N = 9 instance needs
//   40 registers, so 6 blocks an SM hold the slice's 779 tiles in one pass
//   (an instance padded to a larger row count, with a runtime test a row,
//   took 48 and ran the tiles in two passes, slower warm and cold).
// * generic (any N, consensus_row_kernel<WIRE>, the first port's kernel):
//   the row of W is staged in shared memory 1024 weights at a time.  N > 16
//   runs it (a path that streamed the rows in register chunks, the next
//   chunk's loads ahead of this one's arithmetic, was slower at N = 17 and
//   no faster cold at N = 64), and consensus._row_launch(..., instance=0)
//   forces it at any N.
// Layouts tried and left (probes/consensus_row.py, PERF.md): two lanes a
// thread with 8-byte loads, into registers or through an 8-byte cp.async
// ring in shared memory, and a grid of 3 blocks an SM that loads the next
// tile's rows during this tile's arithmetic; each was slower than the
// small kernel warm and cold.
#include <utility>

#include "eq6_common.cuh"

namespace repro_torch {
namespace {

constexpr int TILE = 256;      // lanes per block = threads per block, both paths
constexpr int WCHUNK = 1024;   // generic: entries of w_row staged at a time
constexpr int ROW_N_MAX = 16;  // rows of the largest small instance

// the instance that runs n rows: the small kernel for n, else 0 (generic)
int row_instance(int n) { return n <= ROW_N_MAX ? n : 0; }

// The generic path: the first port's kernel, each lane's arithmetic as it was.
template <int WIRE>
__global__ void __launch_bounds__(TILE)
consensus_row_kernel(const float* __restrict__ w_row,
                     const float* __restrict__ mean,
                     const float* __restrict__ rho,
                     float* __restrict__ mean_out,
                     float* __restrict__ rho_out, int n, long long p) {
  __shared__ float s_w[WCHUNK];
  const long long tiles = (p + TILE - 1) / TILE;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long col = tile * TILE + threadIdx.x;
    const bool live = col < p;
    float acc_prec = 0.0f;
    float acc_pm = 0.0f;
    for (int j0 = 0; j0 < n; j0 += WCHUNK) {
      const int jn = min(WCHUNK, n - j0);
      __syncthreads();  // the previous chunk of the row (or tile) is consumed
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
}

template <int WIRE, int N>
__global__ void __launch_bounds__(TILE)
consensus_row_small_kernel(const float* __restrict__ w_row, const float* __restrict__ mean,
                           const float* __restrict__ rho, float* __restrict__ mean_out,
                           float* __restrict__ rho_out, long long p) {
  const long long tiles = (p + TILE - 1) / TILE;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long col = tile * TILE + threadIdx.x;
    if (col >= p) break;
    float w[N], m[N], r[N];  // every load issued before any is used
#pragma unroll
    for (int j = 0; j < N; ++j) {
      w[j] = __ldg(w_row + j);
      m[j] = __ldg(mean + j * p + col);
      r[j] = __ldg(rho + j * p + col);
    }
    float acc_prec = 0.0f;
    float acc_pm = 0.0f;
#pragma unroll
    for (int j = 0; j < N; ++j) {  // the reference's sums, j in order
      const float prec = precision(r[j]);
      if constexpr (WIRE == WIRE_F32) {
        const float wp = __fmul_rn(w[j], prec);
        acc_prec = __fadd_rn(acc_prec, wp);
        acc_pm = __fadd_rn(acc_pm, __fmul_rn(wp, m[j]));
      } else {
        const float px = wire_roundtrip<WIRE>(prec);
        const float qx = wire_roundtrip<WIRE>(__fmul_rn(prec, m[j]));
        acc_prec = __fadd_rn(acc_prec, __fmul_rn(w[j], px));
        acc_pm = __fadd_rn(acc_pm, __fmul_rn(w[j], qx));
      }
    }
    mean_out[col] = acc_pm / acc_prec;
    rho_out[col] = softplus_inv(1.0f / sqrtf(acc_prec));
  }
}

// instance 0: the generic kernel; 1 .. ROW_N_MAX: the small kernel for that N
template <int WIRE, int... N>
const void* row_kernel(int instance, std::integer_sequence<int, N...>) {
  const void* small[] = {reinterpret_cast<const void*>(consensus_row_small_kernel<WIRE, N + 1>)...};
  if (instance == 0) return reinterpret_cast<const void*>(consensus_row_kernel<WIRE>);
  return instance > 0 && instance <= ROW_N_MAX ? small[instance - 1] : nullptr;
}

const void* kernel_for(int wire, int instance) {
  constexpr auto kSmall = std::make_integer_sequence<int, ROW_N_MAX>{};
  switch (wire) {
    case WIRE_F32: return row_kernel<WIRE_F32>(instance, kSmall);
    case WIRE_BF16: return row_kernel<WIRE_BF16>(instance, kSmall);
    case WIRE_F16: return row_kernel<WIRE_F16>(instance, kSmall);
    default: return nullptr;
  }
}

}  // namespace
}  // namespace repro_torch

// Blocks of the (wire, instance) kernel one SM keeps resident on the current
// device (instance: the small kernel's N, or 0 the generic one); < 0 on error.
extern "C" int consensus_row_blocks_per_sm(int wire, int instance) {
  using namespace repro_torch;
  const void* fn = kernel_for(wire, instance);
  if (fn == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, fn, TILE, 0);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// `instance`: row_instance(n), or 0 for the generic kernel at any n; `grid`
// comes from the launch plan.  Launch on `stream`; returns the cudaError_t of
// the launch (0 = success).
extern "C" int consensus_row_launch(const void* w_row, const void* mean, const void* rho,
                                    void* mean_out, void* rho_out, int n, long long p, int wire,
                                    int instance, int grid, void* stream) {
  using namespace repro_torch;
  const void* fn = kernel_for(wire, instance);
  if (fn == nullptr || n <= 0 || p <= 0 || n > 0x7fffffffffffffffLL / p || grid <= 0 ||
      (instance != 0 && instance != row_instance(n))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* w = static_cast<const float*>(w_row);
  const auto* m = static_cast<const float*>(mean);
  const auto* r = static_cast<const float*>(rho);
  auto* mo = static_cast<float*>(mean_out);
  auto* ro = static_cast<float*>(rho_out);
  void* args[] = {&w, &m, &r, &mo, &ro, &n, &p};
  void* small_args[] = {&w, &m, &r, &mo, &ro, &p};
  return static_cast<int>(cudaLaunchKernel(fn, dim3(static_cast<unsigned>(grid)), dim3(TILE),
                                           instance ? small_args : args, 0,
                                           static_cast<cudaStream_t>(stream)));
}
