// Eq. (6) for the whole network in one pass over the flat [N, P] posterior,
// unmasked (the synchronous round) or masked (one gossip event window).
//
// Replaces two TPU kernels of repro/kernels/consensus.py:
// * consensus_fused_network (consensus.py:195, pallas_call at :217), with
//   `active` null;
// * consensus_fused_masked (consensus.py:261, pallas_call at :288): `active`
//   holds N bytes, nonzero = the agent merges (torch.bool storage).  An idle
//   row gets its (mean, rho) copied through untouched (no softplus round
//   trip, so an idle agent is bit-stable across windows).
// Both run the same instance, so an active row of the masked call is
// bitwise the network call's row at every wire dtype.
//
// For every agent i and lane c:
//   prec_j  = softplus(rho[j, c])^-2               (fp32, IEEE division)
//   prec_x  = wire(prec_j), pm_x = wire(prec_j * mean[j, c])
//   P_i     = sum_j W[i, j] prec_x,  M_i = sum_j W[i, j] pm_x
//             (fmaf over j ascending from 0.0f)
//   mean'   = M_i / P_i,  rho' = softplus^-1(1 / sqrtf(P_i))
//
// What bounds it on the H100: instruction issue, not bytes.  The bytes are
// each lane of mean and rho read once and of the two outputs written once,
// 16 N P (28.7 MB: 8.56 us at 3.35 TB/s at the slice's N = 9, P = 199,210).
// The instructions, read from cuobjdump -sass of consensus_small_kernel<0,
// 9>: the loop body of one output row is 290 instructions for a thread's 2
// lanes, 145 an output element (9 fmaf pairs, 4 MUFU, and the IEEE
// division, square root, reciprocal and softplus^-1 = expm1f + logf with
// their slow-path checks); loading a thread's 18 (row, lane) elements and
// turning them into (prec_x, pm_x) (the softplus pair expf + log1pf, an
// IEEE division) is 1,902 instructions of straight code, both load widths
// and the idle-row stores included, of which one path runs.  About 190
// instructions issue per element: ~340M for the slice's 1.79M elements,
// ~10 us of the card's issue (132 SMs x 4 schedulers x 32 lanes at 1.98
// GHz), above the byte bound.  The bit contract fixes every one of those
// operations.  The TPU kernel kept W in VMEM and ran the N x N contraction
// on the MXU; on the card the contraction is the small part.
//
// Design (launch plan: kernels/launch_plan.py):
// * Small N (N <= 16, consensus_small_kernel<WIRE, NB>): a thread owns a
//   pair of consecutive lanes of every row, loaded 8 bytes at a time where
//   every row allows it (`vec`: the base pointers and the row stride of
//   4 P bytes; at P = 199,210 the odd rows lie 8 bytes off 16, so 16-byte
//   loads would not do), else 4.  It loads all 2 N rows of its pair at
//   once, writes an idle row straight back from those registers, turns the
//   rest into (prec_x, pm_x) in place, and then accumulates one active
//   output row at a time over the N rows in registers: exactly N fmaf pairs
//   per row and lane, with W [N, N] and the idle flags in shared memory.
//   The rows live in registers, so an instance is compiled per row count
//   NB in {1, 2, 4, 8, 9, 16}; N runs the smallest NB >= N with rows past N
//   skipped by uniform branches (N = 9, the 3x3 grid, has its own).  Two
//   lanes a thread (not four) and the output rows left rolled keep the
//   registers few, so the slice's 99,605 pairs run as one wave of 779
//   blocks of 128 with ~6 blocks an SM: the arithmetic below needs the
//   warps to hide its latency.
// * Generic (any N, consensus_generic_kernel<WIRE>): a block owns a tile of
//   256 lanes, one lane a thread.  Input rows are walked in chunks of JC:
//   each thread stages the (prec_x, pm_x) of its lane for the chunk in
//   shared memory beside the chunk's IC x JC block of W, and output rows in
//   chunks of IC accumulate in registers (W [N, N] fits a block's shared
//   memory only up to N ~ 238).  For N > IC each output chunk reads the
//   inputs again, mostly from the 50 MB L2.  An idle row is copied from the
//   values staged in the first output chunk and accumulates nothing.
// * Both walk their lane groups or tiles grid-stride over at most one wave
//   of blocks (SMs x the instance's occupancy); the ragged end is masked,
//   the lanes never padded.
// * No fast math: IEEE division and sqrt, rsqrt written as 1 / sqrtf.
#include "eq6_common.cuh"

namespace repro_torch {
namespace {

constexpr int SMALL_N_MAX = 16;
constexpr int SMALL_THREADS = 128;
constexpr int SMALL_LANES = 2;       // lanes a thread owns on the small path
constexpr int GENERIC_TILE = 256;    // lanes per block = threads per block
constexpr int JC = 16;               // input rows staged per chunk
constexpr int IC = 16;               // output rows accumulated in registers per chunk

// the small instance (its NB) that runs n agents, 0 = the generic path
int dense_instance(int n) {
  constexpr int kInstances[] = {1, 2, 4, 8, 9, 16};  // SMALL_INSTANCES
  for (int nb : kInstances) {
    if (n <= nb) return nb;
  }
  return 0;
}

// (prec_x, pm_x) of one lane from its (rho, mean)
template <int WIRE>
__device__ __forceinline__ void wire_terms(float rho, float mean, float& px, float& qx) {
  const float prec = precision(rho);
  px = wire_roundtrip<WIRE>(prec);
  qx = wire_roundtrip<WIRE>(prec * mean);
}

// Lanes lane0, lane0 + 1 of a row of p (lane0 even, < p): one 8-byte load
// where the row is 8-byte aligned (vec 2); a lane at p reads as 0.
__device__ __forceinline__ void load_pair(const float* __restrict__ x, long long lane0,
                                          long long p, int vec, float (&v)[SMALL_LANES]) {
  if (vec == 2 && lane0 + 1 < p) {
    const float2 q = __ldg(reinterpret_cast<const float2*>(x + lane0));
    v[0] = q.x;
    v[1] = q.y;
  } else {
    v[0] = __ldg(x + lane0);
    v[1] = lane0 + 1 < p ? __ldg(x + lane0 + 1) : 0.0f;
  }
}

__device__ __forceinline__ void store_pair(float* __restrict__ x, long long lane0, long long p,
                                           int vec, const float (&v)[SMALL_LANES]) {
  if (vec == 2 && lane0 + 1 < p) {
    *reinterpret_cast<float2*>(x + lane0) = make_float2(v[0], v[1]);
  } else {
    x[lane0] = v[0];
    if (lane0 + 1 < p) x[lane0 + 1] = v[1];
  }
}

template <int WIRE, int NB>
__global__ void __launch_bounds__(SMALL_THREADS)
consensus_small_kernel(const float* __restrict__ W, const unsigned char* __restrict__ active,
                       const float* __restrict__ mean, const float* __restrict__ rho,
                       float* __restrict__ mean_out, float* __restrict__ rho_out, int n,
                       long long p, int vec) {
  __shared__ float s_w[NB][NB];
  __shared__ bool s_idle[NB];
  for (int k = threadIdx.x; k < NB * NB; k += SMALL_THREADS) {
    const int i = k / NB;
    const int j = k % NB;
    s_w[i][j] = (i < n && j < n) ? W[i * n + j] : 0.0f;
  }
  if (threadIdx.x < NB) {
    s_idle[threadIdx.x] = active != nullptr && static_cast<int>(threadIdx.x) < n &&
                          active[threadIdx.x] == 0;
  }
  __syncthreads();

  const long long groups = (p + SMALL_LANES - 1) / SMALL_LANES;
  const long long stride = static_cast<long long>(gridDim.x) * SMALL_THREADS;
  for (long long g = static_cast<long long>(blockIdx.x) * SMALL_THREADS + threadIdx.x;
       g < groups; g += stride) {
    const long long lane0 = g * SMALL_LANES;
    float x[NB][SMALL_LANES];  // mean, then pm_x
    float y[NB][SMALL_LANES];  // rho, then prec_x
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      if (j < n) {
        load_pair(mean + j * p, lane0, p, vec, x[j]);
        load_pair(rho + j * p, lane0, p, vec, y[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      if (j < n) {
        if (s_idle[j]) {  // an idle row goes back out from the registers that loaded it
          store_pair(mean_out + j * p, lane0, p, vec, x[j]);
          store_pair(rho_out + j * p, lane0, p, vec, y[j]);
        }
#pragma unroll
        for (int l = 0; l < SMALL_LANES; ++l) {
          wire_terms<WIRE>(y[j][l], x[j][l], y[j][l], x[j][l]);
        }
      }
    }
    // one output row at a time (not unrolled: the rows' registers stay few,
    // so more threads fit an SM); N fmaf pairs a row and lane
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
      if (s_idle[i]) continue;
      float acc_prec[SMALL_LANES] = {0.0f, 0.0f};
      float acc_pm[SMALL_LANES] = {0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        if (j < n) {
          const float w = s_w[i][j];
#pragma unroll
          for (int l = 0; l < SMALL_LANES; ++l) {
            acc_prec[l] = fmaf(w, y[j][l], acc_prec[l]);
            acc_pm[l] = fmaf(w, x[j][l], acc_pm[l]);
          }
        }
      }
      float m_out[SMALL_LANES], r_out[SMALL_LANES];
#pragma unroll
      for (int l = 0; l < SMALL_LANES; ++l) {
        m_out[l] = acc_pm[l] / acc_prec[l];
        r_out[l] = softplus_inv(1.0f / sqrtf(acc_prec[l]));
      }
      store_pair(mean_out + i * p, lane0, p, vec, m_out);
      store_pair(rho_out + i * p, lane0, p, vec, r_out);
    }
  }
}

template <int WIRE>
__global__ void __launch_bounds__(GENERIC_TILE)
consensus_generic_kernel(const float* __restrict__ W, const unsigned char* __restrict__ active,
                         const float* __restrict__ mean, const float* __restrict__ rho,
                         float* __restrict__ mean_out, float* __restrict__ rho_out, int n,
                         long long p, int /*vec*/) {
  __shared__ float s_prec[JC][GENERIC_TILE];
  __shared__ float s_pm[JC][GENERIC_TILE];
  __shared__ float s_w[IC][JC];
  __shared__ bool s_idle[IC];

  const int t = threadIdx.x;
  const long long tiles = (p + GENERIC_TILE - 1) / GENERIC_TILE;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long col = tile * GENERIC_TILE + t;
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
        __syncthreads();  // the previous chunk's W block and flags are consumed
        if (live) {
          for (int jj = 0; jj < jn; ++jj) {
            const long long idx = static_cast<long long>(j0 + jj) * p + col;
            const float m = mean[idx];
            const float r = rho[idx];
            if (i0 == 0 && active != nullptr && active[j0 + jj] == 0) {
              mean_out[idx] = m;  // an idle row, written once from the values staged
              rho_out[idx] = r;
            }
            wire_terms<WIRE>(r, m, s_prec[jj][t], s_pm[jj][t]);
          }
        }
        for (int k = t; k < IC * JC; k += GENERIC_TILE) {
          const int i = i0 + k / JC;
          const int j = j0 + k % JC;
          s_w[k / JC][k % JC] = (i < n && j < n) ? W[static_cast<long long>(i) * n + j] : 0.0f;
        }
        if (t < IC) s_idle[t] = active != nullptr && i0 + t < n && active[i0 + t] == 0;
        __syncthreads();
        if (live) {
          for (int jj = 0; jj < jn; ++jj) {
            const float px = s_prec[jj][t];
            const float qx = s_pm[jj][t];
#pragma unroll
            for (int ii = 0; ii < IC; ++ii) {
              if (!s_idle[ii]) {
                acc_prec[ii] = fmaf(s_w[ii][jj], px, acc_prec[ii]);
                acc_pm[ii] = fmaf(s_w[ii][jj], qx, acc_pm[ii]);
              }
            }
          }
        }
      }
      if (live) {
#pragma unroll
        for (int ii = 0; ii < IC; ++ii) {
          const int i = i0 + ii;
          if (i < n && !s_idle[ii]) {
            const long long o = static_cast<long long>(i) * p + col;
            mean_out[o] = acc_pm[ii] / acc_prec[ii];
            rho_out[o] = softplus_inv(1.0f / sqrtf(acc_prec[ii]));
          }
        }
      }
    }
  }
}

template <int WIRE>
const void* small_instance(int nb) {
  switch (nb) {
    case 1: return reinterpret_cast<const void*>(consensus_small_kernel<WIRE, 1>);
    case 2: return reinterpret_cast<const void*>(consensus_small_kernel<WIRE, 2>);
    case 4: return reinterpret_cast<const void*>(consensus_small_kernel<WIRE, 4>);
    case 8: return reinterpret_cast<const void*>(consensus_small_kernel<WIRE, 8>);
    case 9: return reinterpret_cast<const void*>(consensus_small_kernel<WIRE, 9>);
    case 16: return reinterpret_cast<const void*>(consensus_small_kernel<WIRE, 16>);
    case 0: return reinterpret_cast<const void*>(consensus_generic_kernel<WIRE>);
    default: return nullptr;
  }
}

const void* kernel_for(int wire, int nb) {
  switch (wire) {
    case WIRE_F32: return small_instance<WIRE_F32>(nb);
    case WIRE_BF16: return small_instance<WIRE_BF16>(nb);
    case WIRE_F16: return small_instance<WIRE_F16>(nb);
    default: return nullptr;
  }
}

}  // namespace
}  // namespace repro_torch

// Blocks of the (wire, nb) instance one SM keeps resident on the current
// device (nb 0 = the generic kernel); < 0 on error.
extern "C" int consensus_network_blocks_per_sm(int wire, int nb) {
  using namespace repro_torch;
  const void* fn = kernel_for(wire, nb);
  if (fn == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, fn, nb ? SMALL_THREADS : GENERIC_TILE, 0);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// `active`: null (every row merges) or n bytes, 0 = the row passes through.
// `nb`: dense_instance(n), or 0 for the generic kernel at any n.  `vec` and
// `grid` come from the launch plan; every row of mean, rho and the outputs
// must be aligned to 4 vec bytes.  Launch on `stream`; returns the
// cudaError_t of the launch (0 = success).
extern "C" int consensus_network_launch(const void* W, const void* active, const void* mean,
                                        const void* rho, void* mean_out, void* rho_out, int n,
                                        long long p, int wire, int nb, int vec, int grid,
                                        void* stream) {
  using namespace repro_torch;
  const void* fn = kernel_for(wire, nb);
  const auto align = static_cast<unsigned long long>(4 * vec);
  const auto misaligned = [align](const void* x) {
    return reinterpret_cast<unsigned long long>(x) % align != 0;
  };
  if (fn == nullptr || n <= 0 || p <= 0 || n > 0x7fffffffffffffffLL / p || grid <= 0 ||
      (nb != 0 && nb != dense_instance(n)) || (vec != 1 && vec != 2) ||
      p % vec != 0 || misaligned(mean) || misaligned(rho) || misaligned(mean_out) ||
      misaligned(rho_out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* w = static_cast<const float*>(W);
  const auto* a = static_cast<const unsigned char*>(active);
  const auto* m = static_cast<const float*>(mean);
  const auto* r = static_cast<const float*>(rho);
  auto* mo = static_cast<float*>(mean_out);
  auto* ro = static_cast<float*>(rho_out);
  void* args[] = {&w, &a, &m, &r, &mo, &ro, &n, &p, &vec};
  return static_cast<int>(cudaLaunchKernel(fn, dim3(static_cast<unsigned>(grid)),
                                           dim3(nb ? SMALL_THREADS : GENERIC_TILE), args, 0,
                                           static_cast<cudaStream_t>(stream)));
}
