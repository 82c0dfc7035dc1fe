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
// What bounds it on the H100.  The bytes are each lane of mean and rho read
// once and of the two outputs written once, 16 N P, and W once, 4 N^2:
// 28.7 MB, 8.56 us at 3.35 TB/s, at the slice's N = 9, P = 199,210; 3.27 GB,
// 975.5 us, at the 32 x 32 grid's N = 1,024 (a copy of as many bytes took
// 1.09 ms on the card).
// * The small path: instruction issue.  Read from cuobjdump -sass of
//   consensus_small_kernel<0, 9>: the loop body of one output row is 290
//   instructions for a thread's 2 lanes, 145 an output element (9 fmaf
//   pairs, 4 MUFU, and the IEEE division, square root, reciprocal and
//   softplus^-1 = expm1f + logf with their slow-path checks); loading a
//   thread's 18 (row, lane) elements and turning them into (prec_x, pm_x)
//   (the softplus pair expf + log1pf, an IEEE division) is 1,902
//   instructions of straight code, both load widths and the idle-row stores
//   included, of which one path runs.  About 190 instructions issue per
//   element: ~340M for the slice's 1.79M elements, ~10 us of the card's
//   issue (132 SMs x 4 schedulers x 32 lanes at 1.98 GHz), above the byte
//   bound.  The bit contract fixes every one of those operations.
// * The generic path: how its bytes arrive.  Its issue is the small path's
//   per element, each term computed once, plus per nonzero of the row an
//   8-byte entry load, two 16-byte shared loads and 8 fmaf for a thread's 4
//   lanes: ~1.5 ms at the grid (at most 5 nonzeros a row).  But a tile holds
//   every row's terms for T lanes, so it reads and writes each row in
//   fragments of 4 T bytes, and at P = 199,210 three rows in four begin off
//   a 32-byte sector: a fragment's edge sectors are fetched again and
//   written in part by the neighbouring tile.  At the grid T = 8 took 8.24
//   ms (3.94 where every row began on a sector), T = 16 on 512 threads 3.63
//   ms (3.24), T = 4 15.1 ms.  So T is as wide as GENERIC_SMEM allows and
//   the block as large as keeps the warps busy at one block an SM.  A
//   complete W walks N entries a row: its list loads (one L1 wavefront per
//   row of a warp) bound it, ~0.8x the replaced kernel's time at N = 1,024.
//   The TPU kernel kept W in VMEM and ran the N x N contraction on the MXU;
//   on the card the contraction is the small part, and a sparse W makes it
//   smaller still.
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
// * Generic (any N): two kernels on the call's stream.
//   consensus_generic_kernel_nonzeros lists each merging row's nonzero
//   entries of W, j ascending (one warp a row; ballot and popc keep the
//   order), as (column, weight) pairs in [N, N] scratch with a count a
//   row, and adds the entries listed to the card's walk counter; nothing of
//   W or the lists goes to the host.  consensus_generic_kernel<WIRE> then
//   gives a block a tile of T lanes (GENERIC_THREADS threads, 4 lanes each;
//   T the power of two from 4 to 2,048 whose terms fill at most
//   GENERIC_SMEM, 16 at N = 1,024) and walks tiles b, b + grid, ...  For a
//   tile it reads every source row's lanes once, copies an idle row
//   through, and keeps every row's (prec_x, pm_x) in shared memory (8 N T
//   bytes).  A block's 227 KB hold the 4-lane tile of GENERIC_N_MAX = 7,264
//   rows; a larger N is refused (a dense W is refused past 4,096 agents
//   before it reaches a kernel).  Each merging output row then
//   walks its list only: per nonzero one 8-byte entry load (L1/L2), two
//   16-byte shared loads and 8 fmaf.  So each input lane comes from HBM
//   once and its softplus is taken once; the kernel this replaced re-read
//   and recomputed every row for each chunk of 16 output rows (64 times at
//   N = 1,024, mostly from HBM: 130x its bound) and ran N fmaf pairs a lane
//   whatever W held.  The grid's degree-uniform W walks 4,992 of its
//   1,048,576 entries; a complete W walks them all.
// * The same bits as the small kernel, fmaf over j ascending from 0.0f:
//   skipping a w = 0 term leaves a sum of finite terms unchanged except
//   where the running sum is -0 (fmaf(0, x, -0) = +0 for x >= 0), and the
//   two walks then differ at most in the sign of a final zero, so an output
//   whose walked sum ends at -0 sums again over every j.  fmaf(0, inf or
//   NaN, acc) is NaN, so a tile in which any term is not finite
//   (__syncthreads_or over the tile's terms) walks every j of every row.
// * The small and the walking kernels take their lane groups or tiles
//   grid-stride over at most one wave of blocks (SMs x the instance's
//   occupancy); the ragged end is masked, the lanes never padded.
// * No fast math: IEEE division and sqrt, rsqrt written as 1 / sqrtf.
#include "eq6_common.cuh"

namespace repro_torch {
namespace {

constexpr int SMALL_N_MAX = 16;
constexpr int SMALL_THREADS = 128;
constexpr int SMALL_LANES = 2;       // lanes a thread owns on the small path
constexpr int GENERIC_THREADS = 512;  // threads per block of the generic kernel
constexpr int GENERIC_LANES = 4;     // lanes a thread owns there
constexpr int GENERIC_SMEM = 131072;  // shared-memory bytes a tile's terms fill at most
constexpr int SMEM_MAX = 232448;     // a block's shared memory on the H100 (227 KB)
constexpr int GENERIC_N_MAX = SMEM_MAX / (8 * GENERIC_LANES);  // rows the 4-lane tile holds
constexpr int NZ_WARPS = 8;          // rows (one a warp) per block of the nonzeros kernel

// the small instance (its NB) that runs n agents, 0 = the generic path
int dense_instance(int n) {
  constexpr int kInstances[] = {1, 2, 4, 8, 9, 16};  // SMALL_INSTANCES
  for (int nb : kInstances) {
    if (n <= nb) return nb;
  }
  return 0;
}

// Lanes of a generic tile for n rows: the largest power of two from
// GENERIC_LANES to GENERIC_LANES * GENERIC_THREADS whose terms, 8 n bytes a
// lane, fit GENERIC_SMEM; GENERIC_LANES where none does.
long long generic_tile(long long n) {
  long long t = GENERIC_LANES;
  while (t < GENERIC_LANES * GENERIC_THREADS && 16 * n * t <= GENERIC_SMEM) t *= 2;
  return t;
}

// Shared-memory bytes of a generic tile's terms (n <= GENERIC_N_MAX)
long long generic_smem(long long n) { return 8 * n * generic_tile(n); }

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

// Lanes lane0 .. lane0 + 3 of a row of p (lane0 a multiple of 4, < p), as
// two pairs; lanes at or past p read as 0.
__device__ __forceinline__ void load_quad(const float* __restrict__ x, long long lane0,
                                          long long p, int vec, float (&v)[GENERIC_LANES]) {
  float lo[SMALL_LANES], hi[SMALL_LANES] = {0.0f, 0.0f};
  load_pair(x, lane0, p, vec, lo);
  if (lane0 + 2 < p) load_pair(x, lane0 + 2, p, vec, hi);
  v[0] = lo[0]; v[1] = lo[1]; v[2] = hi[0]; v[3] = hi[1];
}

__device__ __forceinline__ void store_quad(float* __restrict__ x, long long lane0, long long p,
                                           int vec, const float (&v)[GENERIC_LANES]) {
  const float lo[SMALL_LANES] = {v[0], v[1]};
  const float hi[SMALL_LANES] = {v[2], v[3]};
  store_pair(x, lane0, p, vec, lo);
  if (lane0 + 2 < p) store_pair(x, lane0 + 2, p, vec, hi);
}

// Each merging row's nonzero entries of W [n, n], j ascending, as (column,
// weight bits) at entries + i n, their number at counts[i] (0 for an idle
// row); the entries listed are added to *walked.  One warp a row.
__global__ void __launch_bounds__(NZ_WARPS * 32)
consensus_generic_kernel_nonzeros(const float* __restrict__ W,
                                  const unsigned char* __restrict__ active, int n,
                                  int2* __restrict__ entries, int* __restrict__ counts,
                                  unsigned long long* __restrict__ walked) {
  __shared__ int s_count[NZ_WARPS];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int i = blockIdx.x * NZ_WARPS + warp;
  int count = 0;
  if (i < n && (active == nullptr || active[i] != 0)) {  // uniform in the warp
    const float* row = W + static_cast<long long>(i) * n;
    int2* list = entries + static_cast<long long>(i) * n;
    for (int j0 = 0; j0 < n; j0 += 32) {
      const int j = j0 + lane;
      const float w = j < n ? row[j] : 0.0f;
      const bool nonzero = w != 0.0f;  // NaN included: the walk takes what fmaf would
      const unsigned ballot = __ballot_sync(0xffffffffu, nonzero);
      if (nonzero) {
        list[count + __popc(ballot & ((1u << lane) - 1u))] = make_int2(j, __float_as_int(w));
      }
      count += __popc(ballot);
    }
  }
  if (lane == 0) {
    if (i < n) counts[i] = count;
    s_count[warp] = count;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long total = 0;
    for (int w = 0; w < NZ_WARPS; ++w) total += static_cast<unsigned long long>(s_count[w]);
    if (total != 0) atomicAdd(walked, total);
  }
}

// One output row's sums for a thread's 4 lanes of the tile: over its list
// (DENSE false) or over every j with W's row (DENSE true), fmaf from 0.0f.
template <bool DENSE>
__device__ __forceinline__ void walk_row(const float* __restrict__ w_row,
                                         const int2* __restrict__ list, int len,
                                         const float* t_prec, const float* t_pm, int tile,
                                         int q, float (&acc_prec)[GENERIC_LANES],
                                         float (&acc_pm)[GENERIC_LANES]) {
#pragma unroll
  for (int l = 0; l < GENERIC_LANES; ++l) {
    acc_prec[l] = 0.0f;
    acc_pm[l] = 0.0f;
  }
#pragma unroll 4
  for (int k = 0; k < len; ++k) {
    int j;
    float w;
    if constexpr (DENSE) {
      j = k;
      w = __ldg(w_row + k);
    } else {
      const int2 e = __ldg(list + k);
      j = e.x;
      w = __int_as_float(e.y);
    }
    const long long at = static_cast<long long>(j) * tile + q * GENERIC_LANES;
    const float4 px = *reinterpret_cast<const float4*>(t_prec + at);
    const float4 qx = *reinterpret_cast<const float4*>(t_pm + at);
    acc_prec[0] = fmaf(w, px.x, acc_prec[0]);
    acc_pm[0] = fmaf(w, qx.x, acc_pm[0]);
    acc_prec[1] = fmaf(w, px.y, acc_prec[1]);
    acc_pm[1] = fmaf(w, qx.y, acc_pm[1]);
    acc_prec[2] = fmaf(w, px.z, acc_prec[2]);
    acc_pm[2] = fmaf(w, qx.z, acc_pm[2]);
    acc_prec[3] = fmaf(w, px.w, acc_prec[3]);
    acc_pm[3] = fmaf(w, qx.w, acc_pm[3]);
  }
}

__device__ __forceinline__ bool negative_zero(float x) {
  return __float_as_uint(x) == 0x80000000u;
}

// Block b takes tiles b, b + grid, ... of `tile` lanes; thread t owns the
// lane quad q = t mod (tile / 4) of rows t div (tile / 4), + GENERIC_THREADS
// 4 / tile, ... in both phases.  Terms: [n, tile] prec_x, then [n, tile]
// pm_x, in shared memory.
template <int WIRE>
__global__ void __launch_bounds__(GENERIC_THREADS)
consensus_generic_kernel(const float* __restrict__ W, const unsigned char* __restrict__ active,
                         const int2* __restrict__ entries, const int* __restrict__ counts,
                         const float* __restrict__ mean, const float* __restrict__ rho,
                         float* __restrict__ mean_out, float* __restrict__ rho_out, int n,
                         long long p, int tile, int vec) {
  extern __shared__ float4 s_terms[];
  float* const t_prec = reinterpret_cast<float*>(s_terms);
  float* const t_pm = t_prec + static_cast<long long>(n) * tile;
  const int quads = tile / GENERIC_LANES;
  const int q = threadIdx.x % quads;
  const int row0 = threadIdx.x / quads;
  const int rows_step = GENERIC_THREADS / quads;
  const long long tiles = (p + tile - 1) / tile;
  for (long long tl = blockIdx.x; tl < tiles; tl += gridDim.x) {
    const long long lane0 = tl * tile + q * GENERIC_LANES;
    const bool live = lane0 < p;
    __syncthreads();  // the previous tile's terms are consumed
    bool bad = false;
    if (live) {
#pragma unroll 2
      for (int j = row0; j < n; j += rows_step) {
        const long long row = static_cast<long long>(j) * p;
        float m[GENERIC_LANES], r[GENERIC_LANES];
        load_quad(mean + row, lane0, p, vec, m);
        load_quad(rho + row, lane0, p, vec, r);
        if (active != nullptr && active[j] == 0) {  // an idle row, copied once
          store_quad(mean_out + row, lane0, p, vec, m);
          store_quad(rho_out + row, lane0, p, vec, r);
        }
        float4 px, qx;
        wire_terms<WIRE>(r[0], m[0], px.x, qx.x);
        wire_terms<WIRE>(r[1], m[1], px.y, qx.y);
        wire_terms<WIRE>(r[2], m[2], px.z, qx.z);
        wire_terms<WIRE>(r[3], m[3], px.w, qx.w);
        bad |= !(isfinite(px.x) && isfinite(px.y) && isfinite(px.z) && isfinite(px.w) &&
                 isfinite(qx.x) && isfinite(qx.y) && isfinite(qx.z) && isfinite(qx.w));
        const long long at = static_cast<long long>(j) * tile + q * GENERIC_LANES;
        *reinterpret_cast<float4*>(t_prec + at) = px;
        *reinterpret_cast<float4*>(t_pm + at) = qx;
      }
    }
    // a term that is not finite makes fmaf(0, x, acc) NaN: every j is walked
    bad = __syncthreads_or(bad);
    if (!live) continue;
    for (int i = row0; i < n; i += rows_step) {
      if (active != nullptr && active[i] == 0) continue;
      const float* w_row = W + static_cast<long long>(i) * n;
      float acc_prec[GENERIC_LANES], acc_pm[GENERIC_LANES];
      bool dense = bad;
      if (!dense) {
        walk_row<false>(w_row, entries + static_cast<long long>(i) * n, __ldg(counts + i),
                        t_prec, t_pm, tile, q, acc_prec, acc_pm);
#pragma unroll
        for (int l = 0; l < GENERIC_LANES; ++l) {
          dense |= lane0 + l < p && (negative_zero(acc_prec[l]) || negative_zero(acc_pm[l]));
        }
      }
      if (dense) walk_row<true>(w_row, nullptr, n, t_prec, t_pm, tile, q, acc_prec, acc_pm);
      float m_out[GENERIC_LANES], r_out[GENERIC_LANES];
#pragma unroll
      for (int l = 0; l < GENERIC_LANES; ++l) {
        m_out[l] = acc_pm[l] / acc_prec[l];
        r_out[l] = softplus_inv(1.0f / sqrtf(acc_prec[l]));
      }
      const long long row = static_cast<long long>(i) * p;
      store_quad(mean_out + row, lane0, p, vec, m_out);
      store_quad(rho_out + row, lane0, p, vec, r_out);
    }
  }
}

template <int WIRE>
const void* instance(int nb) {
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
    case WIRE_F32: return instance<WIRE_F32>(nb);
    case WIRE_BF16: return instance<WIRE_BF16>(nb);
    case WIRE_F16: return instance<WIRE_F16>(nb);
    default: return nullptr;
  }
}

// A generic instance's dynamic shared memory above 48 KB has to be asked for
// (on the current device; asking again is harmless).
cudaError_t allow_smem(const void* fn, long long smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
}

}  // namespace
}  // namespace repro_torch

// Blocks of the (wire, nb) instance one SM keeps resident on the current
// device; nb 0 = the generic kernel at n <= GENERIC_N_MAX rows, whose terms
// take generic_smem(n) bytes of shared memory.  < 0 on error.
extern "C" int consensus_network_blocks_per_sm(int wire, int nb, int n) {
  using namespace repro_torch;
  if (nb == 0 && (n <= 0 || n > GENERIC_N_MAX)) return -static_cast<int>(cudaErrorInvalidValue);
  const long long smem = nb ? 0 : generic_smem(n);
  const void* fn = kernel_for(wire, nb);
  if (fn == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(fn, smem);
  int blocks = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, fn, nb ? SMALL_THREADS : GENERIC_THREADS, static_cast<size_t>(smem));
  }
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// `active`: null (every row merges) or n bytes, 0 = the row passes through.
// `nb`: dense_instance(n), or 0 for the generic path at n <= GENERIC_N_MAX.
// `vec` and `grid` come from the launch plan; every row of mean, rho and the
// outputs must be aligned to 4 vec bytes.  The generic path also takes
// `tile` (generic_tile(n)), `entries` (2 n^2 + n int32: the lists, then the
// counts) and `walked` (the card's uint64 walk counter); the small path
// ignores them.  Launch on `stream`; returns the cudaError_t of the launches
// (0 = success).
extern "C" int consensus_network_launch(const void* W, const void* active, const void* mean,
                                        const void* rho, void* mean_out, void* rho_out, int n,
                                        long long p, int wire, int nb, int vec, int grid,
                                        int tile, void* entries, void* walked, void* stream) {
  using namespace repro_torch;
  const long long smem = nb || n <= 0 || n > GENERIC_N_MAX ? 0 : generic_smem(n);
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
  const auto s = static_cast<cudaStream_t>(stream);
  if (nb != 0) {
    void* args[] = {&w, &a, &m, &r, &mo, &ro, &n, &p, &vec};
    return static_cast<int>(cudaLaunchKernel(fn, dim3(static_cast<unsigned>(grid)),
                                             dim3(SMALL_THREADS), args, 0, s));
  }
  if (n > GENERIC_N_MAX || tile != generic_tile(n) || entries == nullptr || walked == nullptr ||
      reinterpret_cast<unsigned long long>(entries) % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* list = static_cast<int2*>(entries);
  auto* counts = reinterpret_cast<int*>(list + static_cast<long long>(n) * n);
  consensus_generic_kernel_nonzeros<<<(n + NZ_WARPS - 1) / NZ_WARPS, NZ_WARPS * 32, 0, s>>>(
      w, a, n, list, counts, static_cast<unsigned long long*>(walked));
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) err = allow_smem(fn, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int2* cl = list;
  const int* cc = counts;
  void* args[] = {&w, &a, &cl, &cc, &m, &r, &mo, &ro, &n, &p, &tile, &vec};
  return static_cast<int>(cudaLaunchKernel(fn, dim3(static_cast<unsigned>(grid)),
                                           dim3(GENERIC_THREADS), args,
                                           static_cast<size_t>(smem), s));
}
