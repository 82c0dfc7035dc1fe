// Eq. (6) for one shard of the agent axis: the two halves of a sharded
// gossip window (launch/consensus_opt.py consensus_ppermute_window).
//
// No TPU kernel of its own: the reference runs this shard body as XLA inside
// a shard_map (repro/launch/consensus_opt.py:254 _window_consensus_fn).  Its
// contract is the masked TPU kernel's, consensus_fused_masked
// (repro/kernels/consensus.py:261, pallas_call at :288), which on the card
// is consensus_network.cu: every active row this kernel writes is bitwise
// that kernel's row (small and generic instances alike) at every wire dtype.
//
// * encode (consensus_shard_encode_kernel<WIRE>): the shard's own rows of
//   (mean, rho) become its wire payload, stored in the wire dtype:
//     prec_x = wire(softplus(rho)^-2),  pm_x = wire(prec * mean)
//   (precision() and wire_roundtrip<WIRE>() of eq6_common.cuh: decoding
//   the stored bf16/f16 value gives wire_roundtrip's float exactly; at f32
//   the store is the value itself).  The caller writes them into rows
//   [row0, row0 + rows) of the shard's [N, P] statistic buffers, and the
//   rotations copy other shards' rows in, still in the wire dtype.
// * reduce (consensus_shard_reduce_kernel<WIRE>): the shard's [rows, N]
//   rows of W-tilde, its [rows] activity bytes, the assembled [N, P]
//   statistics (rows of shards no rotation brought are zeros) and its own
//   (mean, rho) rows give its [rows, P] output.  For an active row i and a
//   lane c:
//     P_i = sum_j W[i, j] prec_x[j, c],  M_i = sum_j W[i, j] pm_x[j, c]
//           (fmaf over j ascending from 0.0f, every j, zero weights too)
//     mean' = M_i / P_i,  rho' = softplus^-1(1 / sqrtf(P_i))
//   which is consensus_network.cu:14-19 term for term.  A zero-filled row
//   adds fmaf(0, 0, acc) = acc where the masked kernel adds 0 * x: the same
//   bits for a finite x; a non-finite payload of a shard no rotation
//   brought reaches no row here, as in the reference's sharded window.  An
//   idle row copies (mean, rho) through untouched.
//
// What bounds it on the H100: bytes.  The reduce reads the two [N, P]
// statistic planes once (2 N P wire bytes), the shard's own rows, and
// writes its rows: at the slice's N = 9, P = 199,210 and 3 shards of 3
// rows, 14.3 MB at f32 for the planes and 9.6 MB for the rows, ~7 us at
// 3.35 TB/s.  Its arithmetic is 2 N fmaf a lane and row plus the epilogue.
//
// Design (simple first): a block owns a tile of 256 lanes, one lane a
// thread, tiles walked grid-stride over at most one wave.  Output rows go
// in chunks of IC accumulated in registers; the statistic rows in chunks
// of JC with the IC x JC block of W and the chunk's idle flags in shared
// memory, so each (j, lane) of the planes is read once per output chunk (a
// shard of at most IC rows reads the planes once).  Encode is one lane a
// thread over the flat rows x P run.  No fast math.
#include "eq6_common.cuh"

namespace repro_torch {
namespace {

constexpr int TILE = 256;  // lanes per block = threads per block
constexpr int JC = 16;     // statistic rows staged per chunk
constexpr int IC = 16;     // output rows accumulated in registers per chunk

template <int WIRE> struct Wire;
template <> struct Wire<WIRE_F32> { using T = float; };
template <> struct Wire<WIRE_BF16> { using T = __nv_bfloat16; };
template <> struct Wire<WIRE_F16> { using T = __half; };

template <int WIRE>
__device__ __forceinline__ typename Wire<WIRE>::T encode(float x) {
  if constexpr (WIRE == WIRE_BF16) {
    return __float2bfloat16_rn(x);
  } else if constexpr (WIRE == WIRE_F16) {
    return __float2half_rn(x);
  } else {
    return x;
  }
}

template <int WIRE>
__device__ __forceinline__ float decode(typename Wire<WIRE>::T x) {
  if constexpr (WIRE == WIRE_BF16) {
    return __bfloat162float(x);
  } else if constexpr (WIRE == WIRE_F16) {
    return __half2float(x);
  } else {
    return x;
  }
}

template <int WIRE>
__global__ void __launch_bounds__(TILE)
consensus_shard_encode_kernel(const float* __restrict__ mean, const float* __restrict__ rho,
                              typename Wire<WIRE>::T* __restrict__ prec_x,
                              typename Wire<WIRE>::T* __restrict__ pm_x, long long total) {
  const long long stride = static_cast<long long>(gridDim.x) * TILE;
  for (long long k = static_cast<long long>(blockIdx.x) * TILE + threadIdx.x; k < total;
       k += stride) {
    const float prec = precision(__ldg(rho + k));
    prec_x[k] = encode<WIRE>(prec);
    pm_x[k] = encode<WIRE>(prec * __ldg(mean + k));
  }
}

template <int WIRE>
__global__ void __launch_bounds__(TILE)
consensus_shard_reduce_kernel(const float* __restrict__ W, const unsigned char* __restrict__ active,
                              const typename Wire<WIRE>::T* __restrict__ prec_x,
                              const typename Wire<WIRE>::T* __restrict__ pm_x,
                              const float* __restrict__ mean, const float* __restrict__ rho,
                              float* __restrict__ mean_out, float* __restrict__ rho_out, int rows,
                              int n, long long p) {
  __shared__ float s_w[IC][JC];
  __shared__ bool s_skip[IC];  // an idle row, or a row past `rows`

  const int t = threadIdx.x;
  const long long tiles = (p + TILE - 1) / TILE;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long col = tile * TILE + t;
    const bool live = col < p;
    for (int i0 = 0; i0 < rows; i0 += IC) {
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
        for (int k = t; k < IC * JC; k += TILE) {
          const int i = i0 + k / JC;
          const int j = j0 + k % JC;
          s_w[k / JC][k % JC] =
              (i < rows && j < n) ? W[static_cast<long long>(i) * n + j] : 0.0f;
        }
        if (t < IC) {
          s_skip[t] = i0 + t >= rows || (active != nullptr && active[i0 + t] == 0);
        }
        __syncthreads();
        if (live) {
          for (int jj = 0; jj < jn; ++jj) {
            const long long idx = static_cast<long long>(j0 + jj) * p + col;
            const float px = decode<WIRE>(prec_x[idx]);
            const float qx = decode<WIRE>(pm_x[idx]);
#pragma unroll
            for (int ii = 0; ii < IC; ++ii) {
              if (!s_skip[ii]) {
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
          if (i >= rows) continue;
          const long long o = static_cast<long long>(i) * p + col;
          if (s_skip[ii]) {  // idle: (mean, rho) through untouched
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

// kind 0 = encode, 1 = reduce
const void* kernel_for(int kind, int wire) {
  switch (wire) {
    case WIRE_F32:
      return kind ? reinterpret_cast<const void*>(consensus_shard_reduce_kernel<WIRE_F32>)
                  : reinterpret_cast<const void*>(consensus_shard_encode_kernel<WIRE_F32>);
    case WIRE_BF16:
      return kind ? reinterpret_cast<const void*>(consensus_shard_reduce_kernel<WIRE_BF16>)
                  : reinterpret_cast<const void*>(consensus_shard_encode_kernel<WIRE_BF16>);
    case WIRE_F16:
      return kind ? reinterpret_cast<const void*>(consensus_shard_reduce_kernel<WIRE_F16>)
                  : reinterpret_cast<const void*>(consensus_shard_encode_kernel<WIRE_F16>);
    default:
      return nullptr;
  }
}

}  // namespace
}  // namespace repro_torch

// Blocks of the (kind, wire) kernel one SM keeps resident on the current
// device (kind 0 = encode, 1 = reduce); < 0 on error.
extern "C" int consensus_shard_blocks_per_sm(int kind, int wire) {
  using namespace repro_torch;
  const void* fn = kernel_for(kind, wire);
  if (fn == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, TILE, 0);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// Encode `total` lanes of (mean, rho) into (prec_x, pm_x) of the wire dtype.
// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int consensus_shard_encode_launch(const void* mean, const void* rho, void* prec_x,
                                             void* pm_x, long long total, int wire, int grid,
                                             void* stream) {
  using namespace repro_torch;
  const void* fn = kernel_for(0, wire);
  if (fn == nullptr || total <= 0 || grid <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* m = static_cast<const float*>(mean);
  const auto* r = static_cast<const float*>(rho);
  void* args[] = {&m, &r, &prec_x, &pm_x, &total};
  return static_cast<int>(cudaLaunchKernel(fn, dim3(static_cast<unsigned>(grid)), dim3(TILE),
                                           args, 0, static_cast<cudaStream_t>(stream)));
}

// Reduce one shard: W [rows, n] float32, `active` null (every row merges) or
// `rows` bytes (0 = the row passes through), prec_x/pm_x [n, p] of the wire
// dtype, mean/rho and the outputs [rows, p] float32.  Launch on `stream`;
// returns the cudaError_t of the launch (0 = success).
extern "C" int consensus_shard_reduce_launch(const void* W, const void* active, const void* prec_x,
                                             const void* pm_x, const void* mean, const void* rho,
                                             void* mean_out, void* rho_out, int rows, int n,
                                             long long p, int wire, int grid, void* stream) {
  using namespace repro_torch;
  const void* fn = kernel_for(1, wire);
  if (fn == nullptr || rows <= 0 || n < rows || p <= 0 || n > 0x7fffffffffffffffLL / p ||
      grid <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* w = static_cast<const float*>(W);
  const auto* a = static_cast<const unsigned char*>(active);
  const auto* m = static_cast<const float*>(mean);
  const auto* r = static_cast<const float*>(rho);
  auto* mo = static_cast<float*>(mean_out);
  auto* ro = static_cast<float*>(rho_out);
  void* args[] = {&w, &a, &prec_x, &pm_x, &m, &r, &mo, &ro, &rows, &n, &p};
  return static_cast<int>(cudaLaunchKernel(fn, dim3(static_cast<unsigned>(grid)), dim3(TILE),
                                           args, 0, static_cast<cudaStream_t>(stream)));
}
