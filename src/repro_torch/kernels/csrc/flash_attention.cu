// Blocked flash attention, causal and/or sliding-window, over
// q [B, H, S, HD] and k, v [B, H, Sk, HD] (contiguous; Sk may differ from
// S) in float32, bfloat16 or float16, computed in float32, written in q's
// type:
//   s[q, k] = (q . k) * scale  where  mask(q, k),  else -1e30
//   mask    = (!causal || k <= q) && (!window || k > q - window)
//   out[q]  = sum_k p[q, k] v[k] / max(sum_k p[q, k], 1e-30)
// with the online softmax of the TPU kernel: a running max m (its -1e30
// guards m_safe and corr), denominator l and accumulator.  A row with no key
// left gives 0, as the TPU kernel does (not the uniform average that the
// full-materialisation oracle gives).
//
// Replaces the TPU kernel flash_attention of repro/kernels/flash_attention.py
// (pallas_call at flash_attention.py:117), the kernel behind kernels/ops.py
// attention.
//
// What bounds it on the H100: operations.  4 HD flops per unmasked (q, k)
// pair against 2 bytes per element of q, k, v and out read or written once:
// thousands of operations per byte at S = 4096.  This first kernel computes
// on the CUDA cores in fp32 (67 TFLOP/s), not on the tensor cores (989
// TFLOP/s in bf16), so it runs far from that bound; wgmma is a later step.
//
// Design (a simple kernel that is right):
// * One block per (b, h, tile of BQ = 64 query rows); the heaviest causal
//   tiles (the last ones) are launched first.  256 threads as 16 x 16:
//   thread (ty, tx) owns query rows ty + 16 i (i < 4), key columns
//   tx + 16 j of a K tile and output dims tx + 16 e.
// * The Q tile and one K and V tile at a time are staged in shared memory as
//   fp32, rows padded to HD + 1 words so the 16 threads of a row group read
//   16 different banks.  K tiles hold BK = 64 keys (32 at HD = 256, where
//   the staging takes 137 KB of the 227 KB a block may use).
// * The TPU grid walks K blocks in order with (m, l, acc) in VMEM scratch;
//   here a loop inside the block walks the K tiles, with m and l in
//   registers (replicated over the 16 threads of a row group, reduced with
//   shuffles) and acc in registers.  K tiles that the block predicate of
//   flash_attention.py:51-55, recomputed for BQ x BK, finds fully masked
//   are skipped; keys past Sk and query rows past S are masked (never
//   padded in memory).
// * exp and division are IEEE (no fast math).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace repro_torch {
namespace {

constexpr int THREADS = 256;
constexpr int BQ = 64;          // query rows per block
constexpr int ROWS = BQ / 16;   // query rows per thread
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

template <int HD>
struct Tiles {
  static constexpr int BK = HD >= 256 ? 32 : 64;  // keys per K tile
  static constexpr int COLS = BK / 16;            // key columns per thread
  static constexpr int DIMS = HD / 16;            // output dims per thread
  static constexpr int LD = HD + 1;               // padded row of Q, K, V
  static constexpr int LDP = BK + 1;              // padded row of P
  static constexpr size_t SMEM =
      sizeof(float) * (static_cast<size_t>(BQ) * LD + 2 * BK * LD + BQ * LDP);
};

// Stage rows [row0, row0 + nrows) of one (b, h) slice into shared memory as
// fp32; rows at or past `limit` are zeros.
template <typename T, int HD>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      long long row0, int nrows, long long limit) {
  constexpr int LD = Tiles<HD>::LD;
  for (int idx = threadIdx.x; idx < nrows * HD; idx += THREADS) {
    const int r = idx / HD;
    const int c = idx % HD;
    const long long row = row0 + r;
    dst[r * LD + c] = row < limit ? to_f32(src[row * HD + c]) : 0.0f;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       int s, int sk, int causal, int window, float scale) {
  using TL = Tiles<HD>;
  constexpr int BK = TL::BK, COLS = TL::COLS, DIMS = TL::DIMS;
  constexpr int LD = TL::LD, LDP = TL::LDP;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * LD;
  float* sV = sK + BK * LD;
  float* sP = sV + BK * LD;

  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int q0 = qt * BQ;
  const long long bh = static_cast<long long>(blockIdx.z) * gridDim.y + blockIdx.y;
  const T* qh = q + bh * s * HD;
  const T* kh = k + bh * sk * HD;
  const T* vh = v + bh * sk * HD;

  stage<T, HD>(sQ, qh, q0, BQ, s);

  float m[ROWS], l[ROWS], acc[ROWS][DIMS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;  // this thread's share of the row's denominator
#pragma unroll
    for (int e = 0; e < DIMS; ++e) acc[i][e] = 0.0f;
  }

  const int n_kt = (sk + BK - 1) / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    // block-level reachability (flash_attention.py:51-55 at BQ x BK)
    if (causal && k0 > q0 + BQ - 1) break;
    if (window && !(k0 + BK - 1 > q0 - window)) continue;
    __syncthreads();  // the previous tile's K, V and P are consumed
    stage<T, HD>(sK, kh, k0, BK, sk);
    stage<T, HD>(sV, vh, k0, BK, sk);
    __syncthreads();

    float sc[ROWS][COLS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < COLS; ++j) sc[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[ROWS], kv[COLS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) qv[i] = sQ[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < COLS; ++j) kv[j] = sK[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < COLS; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int qi = q0 + ty + 16 * i;
      bool ok[COLS];
      float row_max = NEG_INF;
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const int ki = k0 + tx + 16 * j;
        ok[j] = ki < sk && (!causal || ki <= qi) && (!window || ki > qi - window);
        sc[i][j] = ok[j] ? sc[i][j] * scale : NEG_INF;
        row_max = fmaxf(row_max, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {  // within the 16 threads of a row
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      }
      const float m_new = fmaxf(m[i], row_max);
      const float m_safe = m_new <= NEG_INF / 2 ? 0.0f : m_new;
      const float corr = m[i] <= NEG_INF / 2 ? 0.0f : expf(m[i] - m_safe);
      float row_sum = 0.0f;
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const float pij = ok[j] ? expf(sc[i][j] - m_safe) : 0.0f;
        sP[(ty + 16 * i) * LDP + tx + 16 * j] = pij;
        row_sum += pij;
      }
      l[i] = l[i] * corr + row_sum;
#pragma unroll
      for (int e = 0; e < DIMS; ++e) acc[i][e] *= corr;
      m[i] = m_new;
    }
    __syncthreads();  // P complete

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[ROWS], vv[DIMS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) pv[i] = sP[(ty + 16 * i) * LDP + c];
#pragma unroll
      for (int e = 0; e < DIMS; ++e) vv[e] = sV[c * LD + tx + 16 * e];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int e = 0; e < DIMS; ++e) acc[i][e] = fmaf(pv[i], vv[e], acc[i][e]);
    }
  }

  T* oh = out + bh * s * HD;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    float total = l[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      total += __shfl_xor_sync(0xffffffffu, total, off);
    }
    const float denom = fmaxf(total, 1e-30f);
    const long long qi = q0 + ty + 16 * i;
    if (qi < s) {
#pragma unroll
      for (int e = 0; e < DIMS; ++e) {
        oh[qi * HD + tx + 16 * e] = from_f32<T>(acc[i][e] / denom);
      }
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int b, int h,
           int s, int sk, int causal, int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = Tiles<HD>::SMEM;
  auto kernel = flash_attention_kernel<T, HD>;
  // above 48 KB a block's shared memory must be asked for (once per process)
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(static_cast<unsigned>((s + BQ - 1) / BQ), static_cast<unsigned>(h),
                  static_cast<unsigned>(b));
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), s, sk, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* out, int b, int h,
              int s, int sk, int hd, int causal, int window, float scale,
              cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, out, b, h, s, sk, causal, window, scale, stream);
    case 64: return launch<T, 64>(q, k, v, out, b, h, s, sk, causal, window, scale, stream);
    case 128: return launch<T, 128>(q, k, v, out, b, h, s, sk, causal, window, scale, stream);
    case 256: return launch<T, 256>(q, k, v, out, b, h, s, sk, causal, window, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace repro_torch

// dtype: 0 float32, 1 bfloat16, 2 float16.  Launch on `stream`; returns the
// cudaError_t of the launch (0 = success).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* out, int b, int h, int s, int sk, int hd,
                                      int dtype, int causal, int window, float scale,
                                      void* stream) {
  using namespace repro_torch;
  if (b <= 0 || h <= 0 || s <= 0 || sk <= 0 || b > 65535 || h > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_hd<float>(q, k, v, out, b, h, s, sk, hd, causal, window, scale, st);
    case 1:
      return launch_hd<__nv_bfloat16>(q, k, v, out, b, h, s, sk, hd, causal, window, scale, st);
    case 2: return launch_hd<__half>(q, k, v, out, b, h, s, sk, hd, causal, window, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
