// Eq. (6) over CSR neighbour tables: each agent gathers only its deg(i) <= D
// neighbour rows of the flat [N, P] posterior, unmasked or masked.
//
// Replaces two TPU kernels of repro/kernels/consensus.py:
// * consensus_fused_sparse (consensus.py:355, pallas_call at :399), with
//   `active` null;
// * consensus_fused_masked_sparse (consensus.py:529, pallas_call at :572):
//   `active` holds N bytes, nonzero = the agent merges (torch.bool
//   storage); an idle agent copies its own (mean, rho) row through
//   untouched.
//
// Tables: neighbors [N, D] int32, padded with the agent's own id; weights
// [N, D] float32, padded with 0.0 (core/flat.py neighbor_tables).  For an
// active agent i and lane c, over d = 0 .. D-1 in order, with fp32
// accumulators (the Pallas kernel's per-wire op order, consensus.py:335-337):
//   f32 wire:   wp = w[i, d] / s2;  P += wp;  M += wp * mean
//               with s2 = sigma * sigma, sigma = softplus(rho[nbr[i, d], c])
//   other wire: P += w[i, d] * wire(prec);  M += w[i, d] * wire(prec * mean)
//               with prec = 1 / s2
// (each product and sum rounded on its own: __fmul_rn, __fadd_rn, no fma);
// then mean' = M / P and rho' = softplus^-1(1 / sqrt(P)).  Every slot is
// computed, the zero-weight pad slots too, as the reference does: 0 * a
// non-finite lane is NaN, so skipping them would change the result wherever
// a row is not finite.  An id outside [0, N) (tables already on the card
// are not checked by the wrapper, which would stall the host) sets its
// agent's row to NaN instead of reading outside the buffers.
//
// What bounds it on the H100: instruction issue, not bytes.  The bytes are
// every row read once (8 N P), the outputs written once (8 N P) and the
// tables (8 N D): 8.56 us at the 3x3 grid's N = 9, P = 199,210.  The
// instructions, read from cuobjdump -sass of consensus_staged_kernel<0>
// (f32): the slot loop, unrolled by 4, is 349 instructions for 4 slots of
// a thread's 4 lanes, ~22 a slot and lane (the IEEE division w / s2 with
// its slow-path check, two adds, a multiply); the output of an element
// (a division, a square root, a reciprocal and softplus^-1 = expm1f + logf)
// is ~140 more, and staging it (the softplus pair expf + log1pf, a square)
// ~50.  On the grid (D = 5) that is ~300 instructions an element, ~540M for
// the 1.79M elements, ~16 us of the card's issue (132 SMs x 4 schedulers x
// 32 lanes at 1.98 GHz): twice the byte bound, and fixed by the bit
// contract (the reference divides w by s2 in every slot).  Computing a
// row's softplus once for each agent that gathers it would cost D per
// output lane: 45 softplus per lane column of the grid, where 9 rows hold
// them.
//
// Design (launch plan: kernels/launch_plan.py):
// * staged (N <= 24, consensus_staged_kernel<WIRE>): a block owns a tile of
//   256 lanes at a time (tiles b, b + grid, ...), with a launch bound of 6
//   blocks an SM (40 registers; ptxas spills a few bytes at f32, and the
//   kernel still runs faster than at 48 registers and 5 blocks).  It
//   first turns every row of the tile into its per-lane terms once,
//   (s2, mean) at f32 and
//   (prec_x, pm_x) at bf16/f16, into shared memory (2 N x 64 float4, 48 KB
//   at N = 24); an idle agent's row is written straight back from the
//   registers that loaded it.  Then each (agent, group of 4 lanes) of the
//   tile gathers its D slots from shared memory (a warp's 32 float4 reads
//   are one contiguous 512-byte run: no bank conflicts).  The slot
//   arithmetic is the gather path's, so both give the same bits.
// * gather (any N, consensus_gather_kernel<WIRE>): item k = i G + g (agent
//   i, group g of 4 lanes of the G = ceil(P / 4) groups of a row) is walked
//   grid-stride by a flat 64-bit index, so N has no limit of 65535 (a
//   grid dimension's).  Each slot's rows come from L2; consecutive threads
//   read consecutive groups of one row.
// * Loads and stores of 16, 8 or 4 bytes (`vec`, the widest that every row
//   is aligned to); a thread's lanes do not depend on it.  The grid is at
//   most one wave (SMs x the instance's occupancy).  The ragged end is
//   masked; the lanes are never padded.
#include "eq6_common.cuh"

namespace repro_torch {
namespace {

constexpr int THREADS = 256;
constexpr int GROUP = 4;                   // lanes a thread owns
constexpr int SPARSE_TILE = 256;           // lanes of a staged tile
constexpr int TILE_GROUPS = SPARSE_TILE / GROUP;
constexpr int STAGE_N_MAX = 24;            // 2 * 24 * 64 float4 = 48 KB
constexpr int STAGED_MIN_BLOCKS = 6;       // resident per SM: at most 40 registers a thread

// load_group (eq6_common.cuh) at the load width the plan chose for every row
// (kernels/launch_plan.py row_vector_width).
__device__ __forceinline__ void load_lanes(const float* __restrict__ x, long long lane0,
                                           long long total, int vec, float (&v)[4]) {
  if (vec == 4) {
    load_group<4>(x, lane0, total, v);
  } else if (vec == 2) {
    load_group<2>(x, lane0, total, v);
  } else {
    load_group<1>(x, lane0, total, v);
  }
}

// The store of load_lanes: the lanes of the group before `total`, with
// stores of `vec` lanes where the whole group lies before it.
__device__ __forceinline__ void store_lanes(float* __restrict__ x, long long lane0,
                                            long long total, int vec, const float (&v)[4]) {
  if (lane0 + 3 < total && vec == 4) {
    *reinterpret_cast<float4*>(x + lane0) = make_float4(v[0], v[1], v[2], v[3]);
  } else if (lane0 + 3 < total && vec == 2) {
    *reinterpret_cast<float2*>(x + lane0) = make_float2(v[0], v[1]);
    *reinterpret_cast<float2*>(x + lane0 + 2) = make_float2(v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (lane0 + j < total) x[lane0 + j] = v[j];
    }
  }
}

// The per-lane terms of one gathered lane: (s2, mean) at f32, (prec_x,
// pm_x) otherwise.
template <int WIRE>
__device__ __forceinline__ void lane_terms(float rho, float mean, float& a, float& b) {
  const float sigma = softplus(rho);
  const float s2 = __fmul_rn(sigma, sigma);
  if constexpr (WIRE == WIRE_F32) {
    a = s2;
    b = mean;
  } else {
    const float prec = 1.0f / s2;
    a = wire_roundtrip<WIRE>(prec);
    b = wire_roundtrip<WIRE>(__fmul_rn(prec, mean));
  }
}

// One slot of weight w added to the accumulators, from its lane's terms.
template <int WIRE>
__device__ __forceinline__ void add_slot(float w, float a, float b, float& acc_prec,
                                         float& acc_pm) {
  if constexpr (WIRE == WIRE_F32) {
    const float wp = w / a;
    acc_prec = __fadd_rn(acc_prec, wp);
    acc_pm = __fadd_rn(acc_pm, __fmul_rn(wp, b));
  } else {
    acc_prec = __fadd_rn(acc_prec, __fmul_rn(w, a));
    acc_pm = __fadd_rn(acc_pm, __fmul_rn(w, b));
  }
}

// (mean', rho') of an agent's lanes from its sums; NaN where one of its ids
// was out of range (`bad`).
__device__ __forceinline__ void finish(const float (&acc_prec)[GROUP],
                                       const float (&acc_pm)[GROUP], bool bad,
                                       float (&m_out)[GROUP], float (&r_out)[GROUP]) {
#pragma unroll
  for (int l = 0; l < GROUP; ++l) {
    m_out[l] = bad ? __int_as_float(0x7fc00000) : acc_pm[l] / acc_prec[l];
    r_out[l] = bad ? __int_as_float(0x7fc00000) : softplus_inv(1.0f / sqrtf(acc_prec[l]));
  }
}

template <int WIRE>
__global__ void __launch_bounds__(THREADS)
consensus_gather_kernel(const int* __restrict__ neighbors, const float* __restrict__ weights,
                        const unsigned char* __restrict__ active,
                        const float* __restrict__ mean, const float* __restrict__ rho,
                        float* __restrict__ mean_out, float* __restrict__ rho_out, int n,
                        int d_max, long long p, int vec) {
  const long long groups = (p + GROUP - 1) / GROUP;
  const long long items = static_cast<long long>(n) * groups;
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  for (long long k = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x; k < items;
       k += stride) {
    const long long i = k / groups;
    const long long lane0 = (k - i * groups) * GROUP;
    const long long o = i * p;
    if (active != nullptr && active[i] == 0) {
      float m[GROUP], r[GROUP];
      load_lanes(mean + o, lane0, p, vec, m);
      load_lanes(rho + o, lane0, p, vec, r);
      store_lanes(mean_out + o, lane0, p, vec, m);
      store_lanes(rho_out + o, lane0, p, vec, r);
      continue;
    }
    const int* nbr = neighbors + i * d_max;
    const float* wts = weights + i * d_max;
    float acc_prec[GROUP] = {0.0f, 0.0f, 0.0f, 0.0f};
    float acc_pm[GROUP] = {0.0f, 0.0f, 0.0f, 0.0f};
    bool bad = false;
#pragma unroll 4
    for (int d = 0; d < d_max; ++d) {
      const int j = nbr[d];
      bad = bad || j < 0 || j >= n;  // read row 0 instead; the row ends NaN
      const long long row = (j < 0 || j >= n) ? 0 : static_cast<long long>(j) * p;
      const float w = wts[d];
      float m[GROUP], r[GROUP];
      load_lanes(mean + row, lane0, p, vec, m);
      load_lanes(rho + row, lane0, p, vec, r);
#pragma unroll
      for (int l = 0; l < GROUP; ++l) {
        float a, b;
        lane_terms<WIRE>(r[l], m[l], a, b);
        add_slot<WIRE>(w, a, b, acc_prec[l], acc_pm[l]);
      }
    }
    float m_out[GROUP], r_out[GROUP];
    finish(acc_prec, acc_pm, bad, m_out, r_out);
    store_lanes(mean_out + o, lane0, p, vec, m_out);
    store_lanes(rho_out + o, lane0, p, vec, r_out);
  }
}

template <int WIRE>
__global__ void __launch_bounds__(THREADS, STAGED_MIN_BLOCKS)
consensus_staged_kernel(const int* __restrict__ neighbors, const float* __restrict__ weights,
                        const unsigned char* __restrict__ active,
                        const float* __restrict__ mean, const float* __restrict__ rho,
                        float* __restrict__ mean_out, float* __restrict__ rho_out, int n,
                        int d_max, long long p, int vec) {
  extern __shared__ float4 s_terms[];  // [n][TILE_GROUPS] a terms, then [n][TILE_GROUPS] b
  float4* s_a = s_terms;
  float4* s_b = s_terms + n * TILE_GROUPS;
  const long long groups = (p + GROUP - 1) / GROUP;
  const long long tiles = (groups + TILE_GROUPS - 1) / TILE_GROUPS;
  const int items = n * TILE_GROUPS;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long g0 = tile * TILE_GROUPS;
    __syncthreads();  // the previous tile's terms are consumed
    for (int k = threadIdx.x; k < items; k += THREADS) {
      const int j = k / TILE_GROUPS;
      const int gg = k % TILE_GROUPS;
      const long long lane0 = (g0 + gg) * GROUP;
      if (lane0 >= p) continue;
      const long long o = static_cast<long long>(j) * p;
      float m[GROUP], r[GROUP];
      load_lanes(mean + o, lane0, p, vec, m);
      load_lanes(rho + o, lane0, p, vec, r);
      if (active != nullptr && active[j] == 0) {
        store_lanes(mean_out + o, lane0, p, vec, m);
        store_lanes(rho_out + o, lane0, p, vec, r);
      }
      float a[GROUP], b[GROUP];
#pragma unroll
      for (int l = 0; l < GROUP; ++l) lane_terms<WIRE>(r[l], m[l], a[l], b[l]);
      s_a[k] = make_float4(a[0], a[1], a[2], a[3]);
      s_b[k] = make_float4(b[0], b[1], b[2], b[3]);
    }
    __syncthreads();
    for (int k = threadIdx.x; k < items; k += THREADS) {
      const int i = k / TILE_GROUPS;
      const int gg = k % TILE_GROUPS;
      const long long lane0 = (g0 + gg) * GROUP;
      if (lane0 >= p || (active != nullptr && active[i] == 0)) continue;
      const int* nbr = neighbors + static_cast<long long>(i) * d_max;
      const float* wts = weights + static_cast<long long>(i) * d_max;
      float acc_prec[GROUP] = {0.0f, 0.0f, 0.0f, 0.0f};
      float acc_pm[GROUP] = {0.0f, 0.0f, 0.0f, 0.0f};
      bool bad = false;
#pragma unroll 4
      for (int d = 0; d < d_max; ++d) {
        const int j = nbr[d];
        bad = bad || j < 0 || j >= n;  // read row 0 instead; the row ends NaN
        const int slot = ((j < 0 || j >= n) ? 0 : j) * TILE_GROUPS + gg;
        const float w = wts[d];
        const float4 a = s_a[slot];
        const float4 b = s_b[slot];
        add_slot<WIRE>(w, a.x, b.x, acc_prec[0], acc_pm[0]);
        add_slot<WIRE>(w, a.y, b.y, acc_prec[1], acc_pm[1]);
        add_slot<WIRE>(w, a.z, b.z, acc_prec[2], acc_pm[2]);
        add_slot<WIRE>(w, a.w, b.w, acc_prec[3], acc_pm[3]);
      }
      float m_out[GROUP], r_out[GROUP];
      finish(acc_prec, acc_pm, bad, m_out, r_out);
      const long long o = static_cast<long long>(i) * p;
      store_lanes(mean_out + o, lane0, p, vec, m_out);
      store_lanes(rho_out + o, lane0, p, vec, r_out);
    }
  }
}

template <int WIRE>
const void* path_instance(int staged) {
  return staged ? reinterpret_cast<const void*>(consensus_staged_kernel<WIRE>)
                : reinterpret_cast<const void*>(consensus_gather_kernel<WIRE>);
}

const void* kernel_for(int wire, int staged) {
  switch (wire) {
    case WIRE_F32: return path_instance<WIRE_F32>(staged);
    case WIRE_BF16: return path_instance<WIRE_BF16>(staged);
    case WIRE_F16: return path_instance<WIRE_F16>(staged);
    default: return nullptr;
  }
}

size_t staged_smem(int n) { return 2 * static_cast<size_t>(n) * TILE_GROUPS * sizeof(float4); }

}  // namespace
}  // namespace repro_torch

// Blocks of the (wire, staged) instance one SM keeps resident on the
// current device, the staged kernel with its shared memory for n rows;
// < 0 on error.
extern "C" int consensus_sparse_blocks_per_sm(int wire, int staged, int n) {
  using namespace repro_torch;
  const void* fn = kernel_for(wire, staged);
  if (fn == nullptr || (staged && (n <= 0 || n > STAGE_N_MAX))) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, fn, THREADS, staged ? staged_smem(n) : 0);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// `active`: null (every agent merges) or n bytes, 0 = the agent copies its
// own row.  `staged` (n <= 24 only), `vec` and `grid` come from the launch
// plan; every row of mean, rho and the outputs must be aligned to 4 vec
// bytes.  Launch on `stream`; returns the cudaError_t of the launch
// (0 = success).
extern "C" int consensus_sparse_launch(const void* neighbors, const void* weights,
                                       const void* active, const void* mean, const void* rho,
                                       void* mean_out, void* rho_out, int n, int d_max,
                                       long long p, int wire, int staged, int vec, int grid,
                                       void* stream) {
  using namespace repro_torch;
  const void* fn = kernel_for(wire, staged);
  const auto align = static_cast<unsigned long long>(4 * vec);
  const auto misaligned = [align](const void* x) {
    return reinterpret_cast<unsigned long long>(x) % align != 0;
  };
  if (fn == nullptr || n <= 0 || d_max <= 0 || p <= 0 || n > 0x7fffffffffffffffLL / p ||
      grid <= 0 || (staged && n > STAGE_N_MAX) || (vec != 1 && vec != 2 && vec != 4) ||
      p % vec != 0 || misaligned(mean) || misaligned(rho) || misaligned(mean_out) ||
      misaligned(rho_out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* nb = static_cast<const int*>(neighbors);
  const auto* wt = static_cast<const float*>(weights);
  const auto* a = static_cast<const unsigned char*>(active);
  const auto* m = static_cast<const float*>(mean);
  const auto* r = static_cast<const float*>(rho);
  auto* mo = static_cast<float*>(mean_out);
  auto* ro = static_cast<float*>(rho_out);
  void* args[] = {&nb, &wt, &a, &m, &r, &mo, &ro, &n, &d_max, &p, &vec};
  return static_cast<int>(cudaLaunchKernel(fn, dim3(static_cast<unsigned>(grid)), dim3(THREADS),
                                           args, staged ? staged_smem(n) : 0,
                                           static_cast<cudaStream_t>(stream)));
}
