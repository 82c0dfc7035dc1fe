// Eq. (6) over a ragged, destination-sorted term list: the one kernel of the
// gossip runtime's delayed delivery and edge-native segment windows.
//
// No TPU kernel: the JAX package has no pallas_call for this function.  Its
// reference runs both paths as XLA scatter-adds (.at[dst].add):
// repro/core/flat.py consensus_flat_delayed (:522) and
// consensus_flat_segments (:597), and their quarantined forms (:979,
// :1071).  A literal port would sum with atomics on the card, in an order
// that changes from run to run; this kernel takes each row's terms in a
// fixed order, so the same inputs give the same bits every run.
//
// Inputs (kernels/launch_plan.py ragged_terms builds the list on the host):
// row i of the output owns terms row_ptr[i] .. row_ptr[i + 1] - 1, each a
// source row index src[t] and a weight w[t], in the reference's summation
// order.  An index below n_x is a row of x (float32 [n_x, P]: the current
// posterior, or the transmitted one); an index s >= n_x is row s - n_x of h
// ([n_h, P] in float32, bf16 or f16: the [K N, P] history ring, or a second
// float32 buffer), decoded to fp32 before any arithmetic.  For every lane c
// of an output row with terms, with fp32 accumulators starting at 0:
//   prec = 1 / (sigma * sigma),  sigma = softplus(rho[s, c])
//   WP_FIRST (f32 wire only):  wp = w * prec;  P += wp;  M += wp * mean[s, c]
//   otherwise:                 P += w * wire(prec);  M += w * wire(prec * mean[s, c])
//   mean' = M / P,  rho' = softplus^-1(1 / sqrt(P))
// WP_FIRST is consensus_flat_delayed's association at f32 ((w prec) mean,
// flat.py:572-575); consensus_flat_segments multiplies w (prec mean) at
// every wire (flat.py:643-646).  Each product and sum is an IEEE multiply
// then an IEEE add (__fmul_rn, __fadd_rn): no contraction into fma.  Terms
// of weight 0 are computed, not skipped: 0 * a non-finite lane is NaN, as in
// the reference.  A row with no terms (an idle agent) copies source row
// pass[i] (row i of x when pass is null) through bitwise.  A source index
// outside [0, n_x + n_h) sets its row to NaN instead of reading out of
// range (the tile kernel does the same for a pass-through index).
//
// What bounds it on the H100: bytes, at 8 P per distinct source row read
// (its mean and rho lanes) plus 8 P per output row written, and instruction
// issue under the bit contract: per term the softplus pair and the IEEE
// reciprocal, per row with terms the division, square root and softplus^-1,
// as in consensus_row.cu.  A source gathered by D rows is read D times
// (from L2 where it stays there).  At the delayed
// slice's window 4 (N = 9, P = 199,210, 18 terms over 7 rows, 2 idle rows)
// the byte bound is 12.84 us at 3.35 TB/s; at N = 4,200 and full width
// (1,661 terms over 784 rows, 3,416 idle rows) it is 4.00 ms, of which the
// idle rows' copies are ~10.9 of 13.4 GB; Tensor.copy_ moves those bytes at
// 3.05 TB/s on the card.
//
// Design (launch plan: kernels/launch_plan.py segments_plan).
// consensus_segments_tile_kernel<HIST, WIRE, WP_FIRST, L> (instance 4: four
// lanes a thread where every row is aligned to a pair of elements; instance
// 1: one lane elsewhere) walks items b, b + grid, ... over a balanced grid
// of at most one wave (4 blocks an SM: at most 64 registers), by a 64-bit
// flat item index (N has no 65535 limit; N P may pass 2^31).  The host's
// order (RaggedTerms.order) lists the rows with terms first, most terms
// first: each gives tile items of 256 L lanes; the idle rows after them
// give copy items of COPY_TILE lanes, spread evenly among the tile items.
// What it does about each cost of PR 19's one-lane-a-thread kernel:
// * Per-lane work on per-row values.  The item is decoded once, as a
//   block-uniform value, with a 32-bit division where the index fits.
//   Each chunk of a row's terms is staged in shared memory by one thread a
//   term: the source validated and turned into a row offset into x or h,
//   the weight, and a kind (x, h, or out of range, which sets the row's
//   block-uniform NaN flag).  At four lanes a thread that overhead, and
//   the item's, is shared by four lanes.
// * A serial chain of dependent loads.  A thread issues the loads of all
//   of a chunk's terms (8 lanes' worth: 2 terms at L = 4) before the
//   chunk's first softplus, then sums them strictly in the list's order;
//   only the loads move.  Four lanes give the arithmetic four independent
//   chains, the row's epilogue (division, square root, softplus^-1) too.
// * Narrow idle-row copies.  A copy item is a block-wide copy of its
//   pass-through row's 4096 lanes at the widest vector both rows allow
//   (16, 8 or 4 bytes, chosen once per item), two loads of each array in
//   flight a thread; a bf16/f16 ring row is decoded lane by lane.  Spread
//   among the tile items, the copies stream while the SMs compute.
// * prec = 1 / (sigma sigma) is taken as __frcp_rn, the correctly rounded
//   reciprocal: the IEEE division's bits in fewer instructions.
// What lost (probes/consensus_segments.py; its numbers in PERF.md): 1 and 2
// lanes a thread, 8 lanes (spills under 64 registers, fewer blocks above),
// 3 blocks an SM, 16 chunk lanes, copy tiles of 1024 lanes, and the rows in
// their own order with the idle rows tiled like the others.
// Instance 0 is PR 19's kernel, consensus_segments_kernel<HIST, WIRE,
// WP_FIRST> (one lane a thread, item k = i P + c, the terms walked load by
// load), kept so that the tests and chip_smoke hold the tile kernel to its
// bits (kernels/consensus.py _segments_launch(..., instance=0)); no path
// runs it.  Times on the card: PERF.md section 6, row 9.
#include <cstdint>
#include <type_traits>

#include "eq6_common.cuh"

namespace repro_torch {
namespace {

// probes/consensus_segments.py builds the tile kernel at other values of these
#ifndef SEGMENT_CHUNK_LANES
#define SEGMENT_CHUNK_LANES 8  // lanes of terms a thread loads ahead of their arithmetic
#endif
#ifndef SEGMENT_COPY_TILE
#define SEGMENT_COPY_TILE 4096  // lanes of an idle row's item: 16 KB of mean, 16 of rho
#endif
#ifndef SEGMENT_PROBE_LANES
#define SEGMENT_PROBE_LANES 0  // 1: also instances 2 and 8 (lanes a thread)
#endif
#ifndef SEGMENT_MIN_BLOCKS
#define SEGMENT_MIN_BLOCKS 4  // tile kernel blocks an SM holds: at most 64 registers
#endif
#if SEGMENT_MIN_BLOCKS > 0
#define SEGMENT_BOUNDS __launch_bounds__(256, SEGMENT_MIN_BLOCKS)
#else
#define SEGMENT_BOUNDS __launch_bounds__(256)
#endif

constexpr int THREADS = 256;
constexpr int CHUNK_LANES = SEGMENT_CHUNK_LANES;
constexpr int COPY_TILE = SEGMENT_COPY_TILE;

// history ring codes shared with the Python wrapper (the wire codes' values)
constexpr int HIST_F32 = 0;
constexpr int HIST_BF16 = 1;
constexpr int HIST_F16 = 2;

// the kind of a staged term
constexpr int TERM_X = 0;
constexpr int TERM_H = 1;
constexpr int TERM_BAD = 2;

// the element type of h for each code (integer template arguments keep the
// instance names readable: consensus_segments_kernel<hist, wire, wp_first>)
template <int HIST> struct Ring { using T = float; };
template <> struct Ring<HIST_BF16> { using T = __nv_bfloat16; };
template <> struct Ring<HIST_F16> { using T = __half; };

__device__ __forceinline__ float decode(float x) { return x; }
__device__ __forceinline__ float decode(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float decode(__half x) { return __half2float(x); }
template <typename T> __device__ __forceinline__ float decode_bits(unsigned short b);
template <> __device__ __forceinline__ float decode_bits<__nv_bfloat16>(unsigned short b) {
  return __bfloat162float(__ushort_as_bfloat16(b));
}
template <> __device__ __forceinline__ float decode_bits<__half>(unsigned short b) {
  return __half2float(__ushort_as_half(b));
}

// a / b for 0 <= a and 0 < b, in 32 bits where both fit
__device__ __forceinline__ long long quotient(long long a, long long b) {
  if (((a | b) >> 32) == 0) {
    return static_cast<long long>(static_cast<unsigned>(a) / static_cast<unsigned>(b));
  }
  return a / b;
}

// one term's accumulation, in the reference's association; RCP takes prec's
// 1 / (sigma sigma) as the correctly rounded reciprocal __frcp_rn, the same
// bits as the IEEE division and fewer instructions
template <int WIRE, int WP_FIRST, bool RCP = false>
__device__ __forceinline__ void accumulate(float w, float r, float m, float& acc_prec,
                                           float& acc_pm) {
  float prec;
  if constexpr (RCP) {
    const float sigma = softplus(r);
    prec = __frcp_rn(sigma * sigma);
  } else {
    prec = precision(r);
  }
  if constexpr (WIRE == WIRE_F32 && WP_FIRST != 0) {
    const float wp = __fmul_rn(w, prec);
    acc_prec = __fadd_rn(acc_prec, wp);
    acc_pm = __fadd_rn(acc_pm, __fmul_rn(wp, m));
  } else {
    acc_prec = __fadd_rn(acc_prec, __fmul_rn(w, wire_roundtrip<WIRE>(prec)));
    acc_pm = __fadd_rn(acc_pm, __fmul_rn(w, wire_roundtrip<WIRE>(__fmul_rn(prec, m))));
  }
}

template <int HIST, int WIRE, int WP_FIRST>
__global__ void __launch_bounds__(THREADS)
consensus_segments_kernel(const int* __restrict__ row_ptr, const int* __restrict__ src,
                          const float* __restrict__ weight, const int* __restrict__ pass,
                          const float* __restrict__ x_mean, const float* __restrict__ x_rho,
                          const typename Ring<HIST>::T* __restrict__ h_mean,
                          const typename Ring<HIST>::T* __restrict__ h_rho,
                          float* __restrict__ mean_out, float* __restrict__ rho_out,
                          long long n_x, long long n_h, long long n, long long p) {
  const long long items = n * p;
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  for (long long k = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x; k < items;
       k += stride) {
    const long long i = k / p;
    const long long c = k - i * p;
    const int t0 = row_ptr[i];
    const int t1 = row_ptr[i + 1];
    if (t0 == t1) {  // no terms: the row passes through
      const long long s = pass != nullptr ? pass[i] : i;
      float m, r;
      if (s < n_x) {
        m = x_mean[s * p + c];
        r = x_rho[s * p + c];
      } else {
        m = decode(h_mean[(s - n_x) * p + c]);
        r = decode(h_rho[(s - n_x) * p + c]);
      }
      mean_out[k] = m;
      rho_out[k] = r;
      continue;
    }
    float acc_prec = 0.0f;
    float acc_pm = 0.0f;
    bool bad = false;
    for (int t = t0; t < t1; ++t) {
      const long long s = src[t];
      const float w = weight[t];
      float m, r;
      if (s >= 0 && s < n_x) {
        m = __ldg(x_mean + s * p + c);
        r = __ldg(x_rho + s * p + c);
      } else if (s >= n_x && s < n_x + n_h) {
        m = decode(h_mean[(s - n_x) * p + c]);
        r = decode(h_rho[(s - n_x) * p + c]);
      } else {
        bad = true;
        continue;
      }
      accumulate<WIRE, WP_FIRST>(w, r, m, acc_prec, acc_pm);
    }
    const float qnan = __int_as_float(0x7fc00000);
    mean_out[k] = bad ? qnan : acc_pm / acc_prec;
    rho_out[k] = bad ? qnan : softplus_inv(1.0f / sqrtf(acc_prec));
  }
}

// the first `lanes` (<= L; even for L > 1) of L consecutive lanes of a row of
// x or h at `a`, decoded to fp32; for L > 1 in pairs: 8-byte float32 pairs,
// 4-byte bf16/f16 pairs
template <int L, typename T>
__device__ __forceinline__ void load_lanes(const T* __restrict__ a, float (&v)[L], int lanes) {
  if constexpr (L == 1) {
    v[0] = decode(*a);
  } else if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int k = 0; k < L / 2; ++k) {
      if (2 * k < lanes) {
        const float2 q = __ldg(reinterpret_cast<const float2*>(a) + k);
        v[2 * k] = q.x;
        v[2 * k + 1] = q.y;
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < L / 2; ++k) {
      if (2 * k < lanes) {
        const unsigned int q = __ldg(reinterpret_cast<const unsigned int*>(a) + k);
        v[2 * k] = decode_bits<T>(static_cast<unsigned short>(q & 0xffffu));
        v[2 * k + 1] = decode_bits<T>(static_cast<unsigned short>(q >> 16));
      }
    }
  }
}

// the block copies `len` lanes of a float32 (mean, rho) row pair, V lanes a
// load (two loads of each array in flight a thread)
template <int V>
__device__ __forceinline__ void copy_lanes(const float* __restrict__ sm,
                                           const float* __restrict__ sr, float* __restrict__ dm,
                                           float* __restrict__ dr, int len) {
  using Vec = typename std::conditional<V == 4, float4,
                                        typename std::conditional<V == 2, float2, float>::type>::type;
  const int full = len / V * V;
#pragma unroll 2
  for (int l = threadIdx.x * V; l < full; l += THREADS * V) {
    const Vec a = __ldg(reinterpret_cast<const Vec*>(sm + l));
    const Vec b = __ldg(reinterpret_cast<const Vec*>(sr + l));
    *reinterpret_cast<Vec*>(dm + l) = a;
    *reinterpret_cast<Vec*>(dr + l) = b;
  }
  for (int l = full + threadIdx.x; l < len; l += THREADS) {  // a ragged end
    dm[l] = __ldg(sm + l);
    dr[l] = __ldg(sr + l);
  }
}

// an idle row's tile of `len` lanes: float32 rows at the widest vector both
// rows allow, bf16/f16 ring rows decoded lane by lane
template <typename T>
__device__ __forceinline__ void copy_tile(const T* sm, const T* sr, float* dm, float* dr,
                                          int len) {
  if constexpr (std::is_same<T, float>::value) {
    const auto bits = reinterpret_cast<std::uintptr_t>(sm) |
                      reinterpret_cast<std::uintptr_t>(sr) |
                      reinterpret_cast<std::uintptr_t>(dm) | reinterpret_cast<std::uintptr_t>(dr);
    if (bits % 16 == 0) {
      copy_lanes<4>(sm, sr, dm, dr, len);
    } else if (bits % 8 == 0) {
      copy_lanes<2>(sm, sr, dm, dr, len);
    } else {
      copy_lanes<1>(sm, sr, dm, dr, len);
    }
  } else {
    for (int l = threadIdx.x; l < len; l += THREADS) {
      dm[l] = decode(sm[l]);
      dr[l] = decode(sr[l]);
    }
  }
}

// row `row`'s pass-through tile: lanes c0 .. c0 + len of source row s (x or
// h), NaN when s is outside the sources
template <typename H>
__device__ __forceinline__ void pass_tile(long long s, long long c0, int len,
                                          const float* __restrict__ x_mean,
                                          const float* __restrict__ x_rho,
                                          const H* __restrict__ h_mean,
                                          const H* __restrict__ h_rho, float* mo, float* ro,
                                          long long n_x, long long n_h, long long p) {
  if (s >= 0 && s < n_x) {
    copy_tile(x_mean + s * p + c0, x_rho + s * p + c0, mo, ro, len);
  } else if (s >= n_x && s < n_x + n_h) {
    copy_tile(h_mean + (s - n_x) * p + c0, h_rho + (s - n_x) * p + c0, mo, ro, len);
  } else {
    const float qnan = __int_as_float(0x7fc00000);
    for (int l = threadIdx.x; l < len; l += THREADS) {
      mo[l] = qnan;
      ro[l] = qnan;
    }
  }
}

template <int HIST, int WIRE, int WP_FIRST, int L>
__global__ void SEGMENT_BOUNDS
consensus_segments_tile_kernel(const int* __restrict__ row_ptr, const int* __restrict__ src,
                               const float* __restrict__ weight, const int* __restrict__ pass,
                               const int* __restrict__ order,
                               const float* __restrict__ x_mean, const float* __restrict__ x_rho,
                               const typename Ring<HIST>::T* __restrict__ h_mean,
                               const typename Ring<HIST>::T* __restrict__ h_rho,
                               float* __restrict__ mean_out, float* __restrict__ rho_out,
                               long long n_x, long long n_h, long long n, long long n_active,
                               long long p) {
  constexpr int TILE = THREADS * L;
  constexpr int CHUNK = CHUNK_LANES / L > 0 ? CHUNK_LANES / L : 1;  // terms staged at a time
  __shared__ long long s_off[CHUNK];  // element offset of the term's row in x or h
  __shared__ float s_w[CHUNK];
  __shared__ int s_kind[CHUNK];
  const float qnan = __int_as_float(0x7fc00000);
  const long long tiles = (p + TILE - 1) / TILE;  // a row with terms: tiles of TILE lanes
  const long long copies = (p + COPY_TILE - 1) / COPY_TILE;  // an idle row: of COPY_TILE
  const long long tiled = n_active * tiles;
  const long long copied = (n - n_active) * copies;
  const long long items = tiled + copied;
  // Item x is the idle rows' copy item q = floor(x copied / items) when
  // floor((x + 1) copied / items) is larger, else tile item x - q: the copies
  // spread evenly among the tiles, so each SM streams copies while it computes.
  // q and x copied mod items are carried from item to item by additions (the
  // launch refuses copied grid >= 2^63).
  const long long grid = gridDim.x;
  const long long step_q = grid * copied / items;
  const long long step_r = grid * copied - step_q * items;
  long long q = blockIdx.x * copied / items;
  long long rem = blockIdx.x * copied - q * items;
  for (long long x = blockIdx.x; x < items;
       x += grid, q += step_q + (rem >= items - step_r),
       rem += step_r - (rem >= items - step_r ? items : 0)) {
    if (rem >= items - copied) {  // copy item q: a row past n_active in `order`, no terms
      const long long ri = quotient(q, copies);
      const long long c0 = (q - ri * copies) * COPY_TILE;
      const int len = static_cast<int>(p - c0 < COPY_TILE ? p - c0 : COPY_TILE);
      const long long row = order[n_active + ri];
      float* mo = mean_out + row * p + c0;
      float* ro = rho_out + row * p + c0;
      if (row_ptr[row] != row_ptr[row + 1]) {  // an order that puts a row with terms here
        for (int l = threadIdx.x; l < len; l += THREADS) {
          mo[l] = qnan;
          ro[l] = qnan;
        }
        continue;
      }
      pass_tile(pass != nullptr ? pass[row] : row, c0, len, x_mean, x_rho, h_mean, h_rho, mo,
                ro, n_x, n_h, p);
      continue;
    }
    const long long ri = quotient(x - q, tiles);  // block-uniform: once per item
    const long long c0 = (x - q - ri * tiles) * TILE;
    const long long row = order != nullptr ? order[ri] : ri;
    const int len = static_cast<int>(p - c0 < TILE ? p - c0 : TILE);
    float* mo = mean_out + row * p + c0;
    float* ro = rho_out + row * p + c0;
    const int t0 = row_ptr[row];
    const int t1 = row_ptr[row + 1];
    if (t0 == t1) {  // no terms (a list without an order): the block copies the tile
      pass_tile(pass != nullptr ? pass[row] : row, c0, len, x_mean, x_rho, h_mean, h_rho,
                mo, ro, n_x, n_h, p);
      continue;
    }
    const int lane = threadIdx.x * L;  // the thread's first lane in the tile
    // its lanes in the row: L, or fewer in the row's last tile (even: L > 1 needs P even)
    const int lanes = len - lane < L ? len - lane : L;
    const bool live = lanes > 0;
    float acc_prec[L], acc_pm[L];
#pragma unroll
    for (int l = 0; l < L; ++l) {
      acc_prec[l] = 0.0f;
      acc_pm[l] = 0.0f;
    }
    bool bad = false;
    for (int t = t0; t < t1; t += CHUNK) {
      const int kc = t1 - t < CHUNK ? t1 - t : CHUNK;
      __syncthreads();  // the previous chunk's (or item's) terms are consumed
      if (threadIdx.x < kc) {
        const long long s = src[t + threadIdx.x];
        int kind = TERM_BAD;
        long long off = 0;
        if (s >= 0 && s < n_x) {
          kind = TERM_X;
          off = s * p;
        } else if (s >= n_x && s < n_x + n_h) {
          kind = TERM_H;
          off = (s - n_x) * p;
        }
        s_kind[threadIdx.x] = kind;
        s_off[threadIdx.x] = off + c0;
        s_w[threadIdx.x] = weight[t + threadIdx.x];
      }
      __syncthreads();
      float m[CHUNK][L], r[CHUNK][L];
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {  // every load of the chunk before any arithmetic
        if (j < kc && live) {
          const long long o = s_off[j] + lane;
          if (s_kind[j] == TERM_X) {
            load_lanes<L>(x_mean + o, m[j], lanes);
            load_lanes<L>(x_rho + o, r[j], lanes);
          } else if (s_kind[j] == TERM_H) {
            load_lanes<L>(h_mean + o, m[j], lanes);
            load_lanes<L>(h_rho + o, r[j], lanes);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {  // the terms in the list's order
        if (j < kc) {
          if (s_kind[j] == TERM_BAD) {
            bad = true;
          } else if (live) {
            const float w = s_w[j];
#pragma unroll
            for (int l = 0; l < L; ++l) {
              if (l < lanes) {
                accumulate<WIRE, WP_FIRST, true>(w, r[j][l], m[j][l], acc_prec[l], acc_pm[l]);
              }
            }
          }
        }
      }
    }
    if (live) {
      float om[L], orr[L];
#pragma unroll
      for (int l = 0; l < L; ++l) {
        om[l] = bad ? qnan : acc_pm[l] / acc_prec[l];
        orr[l] = bad ? qnan : softplus_inv(1.0f / sqrtf(acc_prec[l]));
      }
      if constexpr (L == 1) {
        mo[lane] = om[0];
        ro[lane] = orr[0];
      } else {
#pragma unroll
        for (int k = 0; k < L / 2; ++k) {
          if (2 * k < lanes) {
            reinterpret_cast<float2*>(mo + lane)[k] = make_float2(om[2 * k], om[2 * k + 1]);
            reinterpret_cast<float2*>(ro + lane)[k] = make_float2(orr[2 * k], orr[2 * k + 1]);
          }
        }
      }
    }
  }
}

// instance 0: PR 19's lane kernel; 1, 4 (and 2, 8 in probe builds): the tile
// kernel with that many lanes a thread
template <int HIST, int WIRE, int WP>
const void* instance_of(int instance) {
  switch (instance) {
    case 0: return reinterpret_cast<const void*>(consensus_segments_kernel<HIST, WIRE, WP>);
    case 1: return reinterpret_cast<const void*>(consensus_segments_tile_kernel<HIST, WIRE, WP, 1>);
    case 4: return reinterpret_cast<const void*>(consensus_segments_tile_kernel<HIST, WIRE, WP, 4>);
#if SEGMENT_PROBE_LANES  // the widths probes/consensus_segments.py holds against 4
    case 2: return reinterpret_cast<const void*>(consensus_segments_tile_kernel<HIST, WIRE, WP, 2>);
    case 8: return reinterpret_cast<const void*>(consensus_segments_tile_kernel<HIST, WIRE, WP, 8>);
#endif
    default: return nullptr;
  }
}

// wp_first is an f32-wire association: other wires have only the 0 instance
template <int HIST, int WIRE>
const void* wp_instance(int wp_first, int instance) {
  if constexpr (WIRE == WIRE_F32) {
    if (wp_first) return instance_of<HIST, WIRE, 1>(instance);
  }
  return instance_of<HIST, WIRE, 0>(instance);
}

template <int HIST>
const void* wire_instance(int wire, int wp_first, int instance) {
  switch (wire) {
    case WIRE_F32: return wp_instance<HIST, WIRE_F32>(wp_first, instance);
    case WIRE_BF16: return wp_instance<HIST, WIRE_BF16>(wp_first, instance);
    case WIRE_F16: return wp_instance<HIST, WIRE_F16>(wp_first, instance);
    default: return nullptr;
  }
}

const void* kernel_for(int hist, int wire, int wp_first, int instance) {
  switch (hist) {
    case HIST_F32: return wire_instance<HIST_F32>(wire, wp_first, instance);
    case HIST_BF16: return wire_instance<HIST_BF16>(wire, wp_first, instance);
    case HIST_F16: return wire_instance<HIST_F16>(wire, wp_first, instance);
    default: return nullptr;
  }
}

bool aligned(const void* ptr, int bytes) {
  return reinterpret_cast<std::uintptr_t>(ptr) % static_cast<std::uintptr_t>(bytes) == 0;
}

}  // namespace
}  // namespace repro_torch

// Blocks of the (hist, wire, wp_first, instance) kernel one SM keeps
// resident on the current device; < 0 on error.
extern "C" int consensus_segments_blocks_per_sm(int hist, int wire, int wp_first, int instance) {
  using namespace repro_torch;
  const void* fn = kernel_for(hist, wire, wp_first, instance);
  if (fn == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, THREADS, 0);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// row_ptr [n + 1] and src [T] int32, weight [T] float32, pass null or [n]
// int32; x float32 [n_x, P]; h [n_h, P] of the `hist` type (null when
// n_h = 0); outputs float32 [n, P].  `order` (tile instances) null, or [n]
// int32: the rows with terms first (n_active of them), then the rows
// without, which the kernel copies in COPY_TILE-lane items; with a null
// order n_active must be n.  `instance` (0, 1 or 2) and `grid` come from the
// launch plan; instance 2 needs P even, x and the outputs 8-byte aligned and
// h aligned to two of its elements.  Launch on `stream`; returns the
// cudaError_t of the launch (0 = success).
extern "C" int consensus_segments_launch(const void* row_ptr, const void* src,
                                         const void* weight, const void* pass,
                                         const void* order, const void* x_mean,
                                         const void* x_rho, const void* h_mean,
                                         const void* h_rho, void* mean_out, void* rho_out,
                                         long long n_x, long long n_h, long long n,
                                         long long n_active, long long p, int hist, int wire,
                                         int wp_first, int instance, int grid, void* stream) {
  using namespace repro_torch;
  const void* fn = kernel_for(hist, wire, wp_first, instance);
  const int h_pair = hist == HIST_F32 ? 8 : 4;
  if (fn == nullptr || n <= 0 || p <= 0 || n_x <= 0 || n_h < 0 ||
      n > 0x7fffffffffffffffLL / p || n_x + n_h > 0x7fffffffffffffffLL / p || grid <= 0 ||
      (n_h > 0 && (h_mean == nullptr || h_rho == nullptr)) || row_ptr == nullptr ||
      x_mean == nullptr || x_rho == nullptr || n_active < 0 || n_active > n ||
      ((order == nullptr || instance == 0) && n_active != n) ||
      (instance != 0 && (n - n_active) * ((p + COPY_TILE - 1) / COPY_TILE) >
                            0x7fffffffffffffffLL / grid) ||
      (instance > 1 &&
       (p % 2 != 0 || !aligned(x_mean, 8) || !aligned(x_rho, 8) || !aligned(mean_out, 8) ||
        !aligned(rho_out, 8) || (n_h > 0 && (!aligned(h_mean, h_pair) ||
                                             !aligned(h_rho, h_pair)))))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  void* args[] = {&row_ptr, &src, &weight, &pass, &x_mean, &x_rho, &h_mean, &h_rho,
                  &mean_out, &rho_out, &n_x, &n_h, &n, &p};
  void* tile_args[] = {&row_ptr, &src, &weight, &pass, &order, &x_mean, &x_rho, &h_mean,
                       &h_rho, &mean_out, &rho_out, &n_x, &n_h, &n, &n_active, &p};
  return static_cast<int>(cudaLaunchKernel(fn, dim3(static_cast<unsigned>(grid)), dim3(THREADS),
                                           instance == 0 ? args : tile_args, 0,
                                           static_cast<cudaStream_t>(stream)));
}
