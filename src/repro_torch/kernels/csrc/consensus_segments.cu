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
// Inputs (kernels/launch_plan.py segment_plan builds the list on the host):
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
// outside [0, n_x + n_h) sets its lane to NaN instead of reading out of
// range.
//
// What bounds it on the H100: bytes, at 8 P per term read (the source's
// mean and rho lanes) plus 8 P per output row written or copied, and
// instruction issue under the bit contract (the per-term softplus pair and
// IEEE reciprocal, the per-row division, square root and softplus^-1, as
// in consensus_row.cu).  A term's rows are read once per output row that
// lists it: a source gathered by D rows is read D times (from L2 where it
// stays there).  On an H100 80GB HBM3 at 700 W (chip_smoke.py phase 5), a
// delayed window of the 9-agent slice at P = 199,210 (18 terms, 7 active
// rows, 2 idle) takes 32.2 us warm against a byte bound of 12.8 us (the
// distinct rows read and the rows written once), ~2,000 instructions a
// lane column of issue; 32 registers; at N = 4,200 (~1,700 terms, most
// rows idle) a call takes 5.8 ms.
//
// Design (simple and right first): one lane a thread; item k = i P + c
// (output row i, lane c) is walked grid-stride by a flat 64-bit index over
// a grid of at most one wave (SMs x occupancy), so N has no 65535 limit and
// small P still fills every thread.  Consecutive threads take consecutive
// lanes of one row, so every load and store of a warp is one coalesced run;
// the row's terms are the same for the threads of the row (uniform loads).
// No atomics, no shared memory.
#include "eq6_common.cuh"

namespace repro_torch {
namespace {

constexpr int THREADS = 256;

// history ring codes shared with the Python wrapper (the wire codes' values)
constexpr int HIST_F32 = 0;
constexpr int HIST_BF16 = 1;
constexpr int HIST_F16 = 2;

// the element type of h for each code (integer template arguments keep the
// instance names readable: consensus_segments_kernel<hist, wire, wp_first>)
template <int HIST> struct Ring { using T = float; };
template <> struct Ring<HIST_BF16> { using T = __nv_bfloat16; };
template <> struct Ring<HIST_F16> { using T = __half; };

__device__ __forceinline__ float decode(float x) { return x; }
__device__ __forceinline__ float decode(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float decode(__half x) { return __half2float(x); }

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
      const float prec = precision(r);
      if constexpr (WIRE == WIRE_F32 && WP_FIRST != 0) {
        const float wp = __fmul_rn(w, prec);
        acc_prec = __fadd_rn(acc_prec, wp);
        acc_pm = __fadd_rn(acc_pm, __fmul_rn(wp, m));
      } else {
        acc_prec = __fadd_rn(acc_prec, __fmul_rn(w, wire_roundtrip<WIRE>(prec)));
        acc_pm = __fadd_rn(acc_pm, __fmul_rn(w, wire_roundtrip<WIRE>(__fmul_rn(prec, m))));
      }
    }
    const float qnan = __int_as_float(0x7fc00000);
    mean_out[k] = bad ? qnan : acc_pm / acc_prec;
    rho_out[k] = bad ? qnan : softplus_inv(1.0f / sqrtf(acc_prec));
  }
}

// wp_first is an f32-wire association: other wires have only the 0 instance
template <int HIST, int WIRE>
const void* wp_instance(int wp_first) {
  if constexpr (WIRE == WIRE_F32) {
    if (wp_first) {
      return reinterpret_cast<const void*>(consensus_segments_kernel<HIST, WIRE, 1>);
    }
  }
  return reinterpret_cast<const void*>(consensus_segments_kernel<HIST, WIRE, 0>);
}

template <int HIST>
const void* wire_instance(int wire, int wp_first) {
  switch (wire) {
    case WIRE_F32: return wp_instance<HIST, WIRE_F32>(wp_first);
    case WIRE_BF16: return wp_instance<HIST, WIRE_BF16>(wp_first);
    case WIRE_F16: return wp_instance<HIST, WIRE_F16>(wp_first);
    default: return nullptr;
  }
}

const void* kernel_for(int hist, int wire, int wp_first) {
  switch (hist) {
    case HIST_F32: return wire_instance<HIST_F32>(wire, wp_first);
    case HIST_BF16: return wire_instance<HIST_BF16>(wire, wp_first);
    case HIST_F16: return wire_instance<HIST_F16>(wire, wp_first);
    default: return nullptr;
  }
}

}  // namespace
}  // namespace repro_torch

// Blocks of the (hist, wire, wp_first) instance one SM keeps resident on
// the current device; < 0 on error.
extern "C" int consensus_segments_blocks_per_sm(int hist, int wire, int wp_first) {
  using namespace repro_torch;
  const void* fn = kernel_for(hist, wire, wp_first);
  if (fn == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, THREADS, 0);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// row_ptr [n + 1] and src [T] int32, weight [T] float32, pass null or [n]
// int32; x float32 [n_x, P]; h [n_h, P] of the `hist` type (null when
// n_h = 0); outputs float32 [n, P].  `grid` comes from the launch plan.
// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int consensus_segments_launch(const void* row_ptr, const void* src,
                                         const void* weight, const void* pass,
                                         const void* x_mean, const void* x_rho,
                                         const void* h_mean, const void* h_rho, void* mean_out,
                                         void* rho_out, long long n_x, long long n_h,
                                         long long n, long long p, int hist, int wire,
                                         int wp_first, int grid, void* stream) {
  using namespace repro_torch;
  const void* fn = kernel_for(hist, wire, wp_first);
  if (fn == nullptr || n <= 0 || p <= 0 || n_x <= 0 || n_h < 0 ||
      n > 0x7fffffffffffffffLL / p || n_x + n_h > 0x7fffffffffffffffLL / p || grid <= 0 ||
      (n_h > 0 && (h_mean == nullptr || h_rho == nullptr)) || row_ptr == nullptr ||
      x_mean == nullptr || x_rho == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  void* args[] = {&row_ptr, &src, &weight, &pass, &x_mean, &x_rho, &h_mean, &h_rho,
                  &mean_out, &rho_out, &n_x, &n_h, &n, &p};
  return static_cast<int>(cudaLaunchKernel(fn, dim3(static_cast<unsigned>(grid)), dim3(THREADS),
                                           args, 0, static_cast<cudaStream_t>(stream)));
}
