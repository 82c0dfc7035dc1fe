// Flash attention on Hopper's tensor cores, for bfloat16 and float16 inputs:
// causal and/or sliding-window, over q [B, H, S, HD] and k, v [B, H, Sk, HD]
// (contiguous; Sk may differ from S), written in q's type.  It computes what
// flash_attention.cu computes (and the TPU kernel, and the plain version):
//   s[q, k] = (q . k) * scale  where  mask(q, k),  else -1e30
//   mask    = (!causal || k <= q) && (!window || k > q - window)
//   out[q]  = sum_k p[q, k] v[k] / max(sum_k p[q, k], 1e-30)
// with the online softmax's m_safe / corr guards, so a row with no key left
// gives exactly 0.  float32 inputs go to the 3xTF32 kernel of
// flash_attention.cu instead (its 2e-5 contract needs each product split in
// TF32 parts); the wrapper routes by dtype.
//
// Replaces the TPU kernel flash_attention of repro/kernels/flash_attention.py
// (pallas_call at flash_attention.py:117), the kernel behind kernels/ops.py
// attention.
//
// What bounds it on the H100: operations.  4 HD flops per unmasked (q, k)
// pair at 989 TFLOP/s (dense bf16/f16) against 2 bytes per element of q, k,
// v and out: thousands of operations per byte at S = 4096.
//
// Design (Hopper's shape):
// * One CTA of 384 threads per (b*h, 128-row query tile) on a 1-D grid (any
//   B * H up to its 2^31 - 1 blocks), the heaviest causal tiles of every
//   head launched first.  Warpgroup 2 is the producer: after
//   `setmaxnreg.dec` to 24 registers one thread issues TMA loads of Q (once)
//   and of each K and V tile into a 2-stage ring in shared memory, with a
//   "full" and an "empty" mbarrier per K slot and per V slot.  Warpgroups 0
//   and 1 are consumers (`setmaxnreg.inc` to 240), 64 query rows each.
// * Ping-pong: step j of a consumer issues P_{j-1} V_{j-1}, then
//   S_j = Q K_j^T, then runs the softmax of tile j.  Left alone, the two
//   consumers wait on the same barriers and run in lockstep, both in their
//   softmax while the tensor cores idle; two named barriers make them take
//   turns to issue, so one's softmax runs under the other's products.
// * Tiles: BQ = 128; BK = 128 keys at HD <= 128 and 64 at HD = 256, so Q and
//   two stages of K and V fit (64 KB + 128 KB at HD = 256).  Each tile sits
//   in shared memory as HD / 64 column chunks of [rows, 64] (128-byte rows,
//   TMA's 128-byte swizzle, the wgmma descriptors' layout 1) or, at HD = 32,
//   one [rows, 32] chunk with the 64-byte swizzle (layout 2); every chunk is
//   1024-byte aligned.  The tensor maps are 3-D, [B*H, S or Sk, HD], so a
//   ragged tail is zero-filled by TMA and never reads the next head.
// * S = Q K^T: wgmma m64nBKk16, Q and K both K-major from shared memory,
//   fp32 accumulation (bf16 x bf16 products are exact in fp32, so this is
//   the reference's fp32 dot up to the order of the sums).
// * The online softmax runs in the accumulator's layout: a thread holds two
//   rows, each spread over the 4 threads of a quad (two shuffles reduce it).
//   The element mask is applied only on tiles that cross the diagonal, the
//   window's edge or Sk; the K-loop bounds come from the block predicate of
//   flash_attention.py:51-55 at BQ x BK, so skipped tiles are never loaded.
//   exp is ex2.approx on log2-scaled scores.
// * O += P V with P split in two: P_hi = round(p), P_lo = round(p - P_hi) in
//   the input type, two register-A wgmma m64nHDk16 into the one fp32 O
//   accumulator, V as the B operand read MN-major (the transpose bit) from
//   its [BK, HD] rows as TMA brought them.  That costs 1.5x the useful
//   tensor-core work and keeps P at ~16 bits instead of 8, near the
//   reference's fp32 P V.
// * A K or V slot is released (one arrive per consumer warp on its "empty"
//   barrier) once the wgmmas that read it have completed (wait_group 0): K
//   after S_j, V after P V.  P V completes before S_j is issued, so P and S
//   never hold registers at once.
// * A wait on an mbarrier that spins ~2^26 times traps, so a protocol fault
//   surfaces as a launch error instead of a hang.
// What it leaves: inside a warpgroup the products and the softmax run one
// after the other (only the two warpgroups overlap), and at HD = 256 the O
// accumulator alone takes 128 registers a thread, so ptxas spills part of
// the consumer's state there (chip_smoke.py phase 1 prints the counts).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace repro_torch {
namespace {

constexpr int THREADS = 384;  // two consumer warpgroups, one producer warpgroup
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <int HD>
struct TcCfg {
  static constexpr int BQ = 128;
  static constexpr int BK = HD >= 256 ? 64 : 128;
  static constexpr int ST = 2;                    // K/V ring stages
  static constexpr int SW = HD >= 64 ? 128 : 64;  // bytes of a chunk row (= swizzle span)
  static constexpr int EC = SW / 2;               // elements of a chunk row
  static constexpr int KPC = EC / 16;             // k16 steps per chunk
  static constexpr int LAYOUT = SW == 128 ? 1 : 2;  // wgmma descriptor swizzle mode
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int KV_BYTES = BK * HD * 2;
  static constexpr int BAR_OFF = Q_BYTES + 2 * ST * KV_BYTES;
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 4 * ST) + 1024;  // + alignment slack
};

// ---- mbarriers, TMA ---------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(bar) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (spins > (1u << 26)) __trap();
  }
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// ---- wgmma ------------------------------------------------------------------

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle mode in bits 62-63.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint32_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

// The descriptor of the matrix `bytes` further on in shared memory (the start
// address field counts 16-byte units and never carries out of its 14 bits).
__device__ __forceinline__ uint64_t desc_at(uint64_t desc, uint32_t bytes) {
  return desc + (bytes >> 4);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Named barriers 1 and 2 over the 256 consumer threads: warpgroup w waits on
// barrier 1 + w for the other warpgroup's arrival.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;" :: "r"(1 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;" :: "r"(2 - wg) : "memory");
}

// Keep the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across the fence / wait around it.
template <int N>
__device__ __forceinline__ void pin(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

#define R0 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define R1 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define R2 "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
#define R3 "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define R4 "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
#define R5 "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
#define R6 "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111"
#define R7 "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
#define REGS16 R0
#define REGS32 R0 ", " R1
#define REGS64 R0 ", " R1 ", " R2 ", " R3
#define REGS128 R0 ", " R1 ", " R2 ", " R3 ", " R4 ", " R5 ", " R6 ", " R7
#define D8(o)                                                                           \
  "+f"(d[(o)]), "+f"(d[(o) + 1]), "+f"(d[(o) + 2]), "+f"(d[(o) + 3]), "+f"(d[(o) + 4]), \
      "+f"(d[(o) + 5]), "+f"(d[(o) + 6]), "+f"(d[(o) + 7])
#define D16(o) D8(o), D8((o) + 8)
#define D32(o) D16(o), D16((o) + 16)
#define D64(o) D32(o), D32((o) + 32)
#define D128(o) D64(o), D64((o) + 64)

// d[64 x N] (+)= A[64 x 16] B[16 x N], A and B K-major in shared memory.
#define WGMMA_SS(N, TY, REGS, OPS, IA, IB, IS)                                            \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" IS ", 0;\n"                          \
               "wgmma.mma_async.sync.aligned.m64n" N "k16.f32." TY "." TY " {" REGS     \
               "}, %" IA ", %" IB ", p, 1, 1, 0, 0;\n}\n"                               \
               : OPS : "l"(da), "l"(db), "r"(scale_d))
// d[64 x N] (+)= A[64 x 16] B[16 x N], A in registers, B MN-major in shared memory.
#define WGMMA_RS(N, TY, REGS, OPS, A0, A1, A2, A3, IB, IS)                                \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" IS ", 0;\n"                          \
               "wgmma.mma_async.sync.aligned.m64n" N "k16.f32." TY "." TY " {" REGS     \
               "}, {%" A0 ", %" A1 ", %" A2 ", %" A3 "}, %" IB ", p, 1, 1, 1;\n}\n"     \
               : OPS : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))

template <int N, bool F16>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db, int scale_d) {
  static_assert(N == 64 || N == 128, "QK^T tile width");
  if constexpr (N == 64) {
    if constexpr (F16) WGMMA_SS("64", "f16", REGS32, D32(0), "32", "33", "34");
    else WGMMA_SS("64", "bf16", REGS32, D32(0), "32", "33", "34");
  } else {
    if constexpr (F16) WGMMA_SS("128", "f16", REGS64, D64(0), "64", "65", "66");
    else WGMMA_SS("128", "bf16", REGS64, D64(0), "64", "65", "66");
  }
}

template <int N, bool F16>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t db,
                                         int scale_d) {
  static_assert(N == 32 || N == 64 || N == 128 || N == 256, "head dim");
  if constexpr (N == 32) {
    if constexpr (F16) WGMMA_RS("32", "f16", REGS16, D16(0), "16", "17", "18", "19", "20", "21");
    else WGMMA_RS("32", "bf16", REGS16, D16(0), "16", "17", "18", "19", "20", "21");
  } else if constexpr (N == 64) {
    if constexpr (F16) WGMMA_RS("64", "f16", REGS32, D32(0), "32", "33", "34", "35", "36", "37");
    else WGMMA_RS("64", "bf16", REGS32, D32(0), "32", "33", "34", "35", "36", "37");
  } else if constexpr (N == 128) {
    if constexpr (F16) WGMMA_RS("128", "f16", REGS64, D64(0), "64", "65", "66", "67", "68", "69");
    else WGMMA_RS("128", "bf16", REGS64, D64(0), "64", "65", "66", "67", "68", "69");
  } else {
    if constexpr (F16) {
      WGMMA_RS("256", "f16", REGS128, D128(0), "128", "129", "130", "131", "132", "133");
    } else {
      WGMMA_RS("256", "bf16", REGS128, D128(0), "128", "129", "130", "131", "132", "133");
    }
  }
}

// ---- arithmetic -------------------------------------------------------------

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// (a, b) -> the packed pair rounded to the input type, and the packed
// rounding of the remainders.
template <bool F16>
__device__ __forceinline__ void split_pair(float a, float b, uint32_t& hi, uint32_t& lo) {
  if constexpr (F16) {
    const __half2 h = __floats2half2_rn(a, b);
    const float2 hf = __half22float2(h);
    const __half2 l = __floats2half2_rn(a - hf.x, b - hf.y);
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = *reinterpret_cast<const uint32_t*>(&l);
  } else {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    const float2 hf = __bfloat1622float2(h);
    const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = *reinterpret_cast<const uint32_t*>(&l);
  }
}

template <bool F16>
__device__ __forceinline__ uint32_t pack_out(float a, float b) {
  if constexpr (F16) {
    const __half2 h = __floats2half2_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&h);
  } else {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---- the kernel -------------------------------------------------------------

template <int HD, bool F16>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v, void* __restrict__ out,
                          int bh_count, int s, int sk, int causal, int window,
                          float scale_log2) {
  using C = TcCfg<HD>;
  constexpr int BQ = C::BQ, BK = C::BK, ST = C::ST, SW = C::SW;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sK = base + C::Q_BYTES;          // + st * KV_BYTES
  const uint32_t sV = sK + ST * C::KV_BYTES;      // + st * KV_BYTES
  const uint32_t bar_q = base + C::BAR_OFF;
  const uint32_t bar_k = bar_q + 8;               // + 8 st: K slot st loaded
  const uint32_t bar_v = bar_k + 8 * ST;          // + 8 st: V slot st loaded
  const uint32_t bar_ek = bar_v + 8 * ST;         // + 8 st: K slot st read
  const uint32_t bar_ev = bar_ek + 8 * ST;        // + 8 st: V slot st read

  // block x of the flat grid: head x mod bh_count, and the heaviest causal
  // tiles of every head first (kernels/launch_plan.py attention_block)
  const int n_qt = (s + BQ - 1) / BQ;
  const int bh = static_cast<int>(blockIdx.x % static_cast<unsigned>(bh_count));
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x / static_cast<unsigned>(bh_count))) * BQ;
  // K tiles kept by the block predicate of flash_attention.py:51-55 at BQ x BK
  const int n_kt = (sk + BK - 1) / BK;
  int kt_hi = n_kt;
  if (causal) kt_hi = min(n_kt, (q0 + BQ - 1) / BK + 1);
  int kt_lo = 0;
  if (window) {
    const long long x = static_cast<long long>(q0) - window - BK + 1;
    if (x >= 0) kt_lo = static_cast<int>(x / BK) + 1;
  }
  const int n_tiles = max(0, kt_hi - kt_lo);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
#pragma unroll
    for (int st = 0; st < ST; ++st) {
      mbar_init(bar_k + 8 * st, 1);
      mbar_init(bar_v + 8 * st, 1);
      mbar_init(bar_ek + 8 * st, 8);  // one arrive per consumer warp
      mbar_init(bar_ev + 8 * st, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ---- producer warpgroup: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x == 256) {
      mbar_expect_tx(bar_q, C::Q_BYTES);
#pragma unroll
      for (int c = 0; c < HD / C::EC; ++c) {
        tma_load_3d(sQ + c * BQ * SW, &map_q, bar_q, c * C::EC, q0, bh);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % ST;
        const uint32_t ph = (i / ST) & 1;
        const int k0 = (kt_lo + i) * BK;
        mbar_wait(bar_ek + 8 * st, ph ^ 1);
        mbar_expect_tx(bar_k + 8 * st, C::KV_BYTES);
#pragma unroll
        for (int c = 0; c < HD / C::EC; ++c) {
          tma_load_3d(sK + st * C::KV_BYTES + c * BK * SW, &map_k, bar_k + 8 * st, c * C::EC,
                      k0, bh);
        }
        mbar_wait(bar_ev + 8 * st, ph ^ 1);
        mbar_expect_tx(bar_v + 8 * st, C::KV_BYTES);
#pragma unroll
        for (int c = 0; c < HD / C::EC; ++c) {
          tma_load_3d(sV + st * C::KV_BYTES + c * BK * SW, &map_v, bar_v + 8 * st, c * C::EC,
                      k0, bh);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    const int q_lo = q0 + 64 * wg;                 // this warpgroup's first row
    const int r0 = q_lo + 16 * warp + lane / 4;    // this thread's rows r0 and r0 + 8
    const int cq = 2 * (lane % 4);                 // its first column in each 8-column group

    float o[HD / 2];
#pragma unroll
    for (int j = 0; j < HD / 2; ++j) o[j] = 0.0f;
    float m0 = NEG_INF, m1 = NEG_INF;  // running max (log2-scaled) of rows r0, r0 + 8
    float l0 = 0.0f, l1 = 0.0f;        // this thread's share of their denominators

    const uint64_t desc_q = smem_desc(sQ + 64 * wg * SW, 16, 8 * SW, C::LAYOUT);
    float sc[BK / 2];                     // S of a tile, then its p
    uint32_t p_hi[BK / 4], p_lo[BK / 4];  // P of the tile before, split
    mbar_wait(bar_q, 0);
    // Step j issues P_{j-1} V_{j-1} and S_j = Q K_j^T, then runs the softmax
    // of tile j.  The two warpgroups take turns to issue (ping-pong): one's
    // softmax runs while the other's products keep the tensor cores busy.
    if (n_tiles > 0 && wg == 1) turn_pass(wg);  // warpgroup 0 goes first
    for (int j = 0; n_tiles > 0 && j <= n_tiles; ++j) {
      turn_wait(wg);
      if (j > 0) {
        const int st = (j - 1) % ST;
        const uint64_t desc_v = smem_desc(sV + st * C::KV_BYTES, BK * SW, 8 * SW, C::LAYOUT);
        mbar_wait(bar_v + 8 * st, ((j - 1) / ST) & 1);
        pin<HD / 2>(o);
        pin<BK / 4>(p_hi);
        pin<BK / 4>(p_lo);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          wgmma_rs<HD, F16>(o, p_hi + 4 * kk, desc_at(desc_v, kk * 16 * SW), 1);
        }
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          wgmma_rs<HD, F16>(o, p_lo + 4 * kk, desc_at(desc_v, kk * 16 * SW), 1);
        }
        wgmma_commit();
        wgmma_wait_all();  // P's registers are free for S before S_j is issued
        pin<HD / 2>(o);
        pin<BK / 4>(p_hi);
        pin<BK / 4>(p_lo);
        if (lane == 0) mbar_arrive(bar_ev + 8 * st);
      }
      if (j == n_tiles) {
        if (wg == 0) turn_pass(wg);
        break;
      }
      const int st = j % ST;
      const int k0 = (kt_lo + j) * BK;
      const uint64_t desc_k = smem_desc(sK + st * C::KV_BYTES, 16, 8 * SW, C::LAYOUT);
      mbar_wait(bar_k + 8 * st, (j / ST) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t chunk = kk / C::KPC, off = (kk % C::KPC) * 32;  // 32 B = 16 elements
        wgmma_ss<BK, F16>(sc, desc_at(desc_q, chunk * BQ * SW + off),
                          desc_at(desc_k, chunk * BK * SW + off), kk > 0);
      }
      wgmma_commit();
      turn_pass(wg);
      wgmma_wait_all();
      pin<BK / 2>(sc);
      if (lane == 0) mbar_arrive(bar_ek + 8 * st);

      // masked, log2-scaled scores and the row maxima
      const bool edge = static_cast<long long>(k0) + BK > sk ||
                        (causal && k0 + BK - 1 > q_lo) ||
                        (window && static_cast<long long>(k0) <= q_lo + 63LL - window);
      float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
      for (int jj = 0; jj < BK / 2; ++jj) {
        float x = sc[jj] * scale_log2;
        if (edge) {
          const int row = (jj & 2) ? r0 + 8 : r0;
          const int col = k0 + 8 * (jj / 4) + cq + (jj & 1);
          const bool ok = col < sk && (!causal || col <= row) && (!window || col > row - window);
          x = ok ? x : NEG_INF;
        }
        sc[jj] = x;
        if (jj & 2) mx1 = fmaxf(mx1, x);
        else mx0 = fmaxf(mx0, x);
      }
      mx0 = fmaxf(m0, quad_max(mx0));
      mx1 = fmaxf(m1, quad_max(mx1));
      const float ms0 = mx0 <= NEG_INF / 2 ? 0.0f : mx0;
      const float ms1 = mx1 <= NEG_INF / 2 ? 0.0f : mx1;
      const float corr0 = m0 <= NEG_INF / 2 ? 0.0f : ex2(m0 - ms0);
      const float corr1 = m1 <= NEG_INF / 2 ? 0.0f : ex2(m1 - ms1);
      m0 = mx0;
      m1 = mx1;

      // p = exp(s - m_safe) (exactly 0 where masked), split into hi + lo
      float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
      for (int jj = 0; jj < BK / 2; jj += 2) {
        const float ms = (jj & 2) ? ms1 : ms0;
        const float pa = ex2(sc[jj] - ms);
        const float pb = ex2(sc[jj + 1] - ms);
        if (jj & 2) sum1 += pa + pb;
        else sum0 += pa + pb;
        split_pair<F16>(pa, pb, p_hi[jj / 2], p_lo[jj / 2]);
      }
      l0 = l0 * corr0 + sum0;
      l1 = l1 * corr1 + sum1;
#pragma unroll
      for (int jj = 0; jj < HD / 2; ++jj) o[jj] *= (jj & 2) ? corr1 : corr0;
    }

    // out = O / max(l, 1e-30), rows past S not written
    const float inv0 = 1.0f / fmaxf(quad_sum(l0), 1e-30f);
    const float inv1 = 1.0f / fmaxf(quad_sum(l1), 1e-30f);
    uint32_t* oh = static_cast<uint32_t*>(out);
    const long long row0 = static_cast<long long>(bh) * s + r0;
#pragma unroll
    for (int n8 = 0; n8 < HD / 8; ++n8) {
      const int col = 8 * n8 + cq;
      if (r0 < s) {
        oh[(row0 * HD + col) / 2] = pack_out<F16>(o[4 * n8] * inv0, o[4 * n8 + 1] * inv0);
      }
      if (r0 + 8 < s) {
        oh[((row0 + 8) * HD + col) / 2] =
            pack_out<F16>(o[4 * n8 + 2] * inv1, o[4 * n8 + 3] * inv1);
      }
    }
  }
}

// ---- host side --------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, through the runtime (no -lcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      return static_cast<EncodeTiled>(nullptr);
    }
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A 3-D map over [bh, rows, hd] whose box is one [box_rows, sw / 2] chunk.
int make_map(CUtensorMap* map, const void* ptr, int hd, int rows, int bh, int box_rows, int sw,
             bool f16) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(hd) * 2,
                                 static_cast<cuuint64_t>(rows) * hd * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(sw / 2),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = encode(
      map, f16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
      const_cast<void*>(ptr), dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      sw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

constexpr int MAX_DEVICES = 64;

template <int HD, bool F16>
int launch(const void* q, const void* k, const void* v, void* out, int bh, int s, int sk,
           int causal, int window, float scale, cudaStream_t stream) {
  using C = TcCfg<HD>;
  CUtensorMap mq, mk, mv;
  int err = make_map(&mq, q, HD, s, bh, C::BQ, C::SW, F16);
  if (err == 0) err = make_map(&mk, k, HD, sk, bh, C::BK, C::SW, F16);
  if (err == 0) err = make_map(&mv, v, HD, sk, bh, C::BK, C::SW, F16);
  if (err != 0) return err;
  auto kernel = flash_attention_tc_kernel<HD, F16>;
  // the shared-memory attribute belongs to the current device: asked for once on each
  static cudaError_t attr[MAX_DEVICES];
  static bool asked[MAX_DEVICES];
  int device = 0;
  const cudaError_t dev_err = cudaGetDevice(&device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  if (device >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  if (!asked[device]) {
    attr[device] = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        C::SMEM);
    asked[device] = true;
  }
  if (attr[device] != cudaSuccess) return static_cast<int>(attr[device]);
  const dim3 grid(static_cast<unsigned>(bh) * static_cast<unsigned>((s + C::BQ - 1) / C::BQ));
  kernel<<<grid, THREADS, C::SMEM, stream>>>(mq, mk, mv, out, bh, s, sk, causal, window,
                                             scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

template <bool F16>
int launch_hd(const void* q, const void* k, const void* v, void* out, int bh, int s, int sk,
              int hd, int causal, int window, float scale, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<32, F16>(q, k, v, out, bh, s, sk, causal, window, scale, stream);
    case 64: return launch<64, F16>(q, k, v, out, bh, s, sk, causal, window, scale, stream);
    case 128: return launch<128, F16>(q, k, v, out, bh, s, sk, causal, window, scale, stream);
    case 256: return launch<256, F16>(q, k, v, out, bh, s, sk, causal, window, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace repro_torch

// dtype: 1 bfloat16, 2 float16.  q, k, v, out 16-byte aligned.  Launch on
// `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int flash_attention_tc_launch(const void* q, const void* k, const void* v,
                                         void* out, int bh, int s, int sk, int hd, int dtype,
                                         int causal, int window, float scale, void* stream) {
  using namespace repro_torch;
  // one block per (b * h, 128-row query tile) on a 1-D grid of at most 2^31 - 1
  if (bh <= 0 || s <= 0 || sk <= 0 || window < 0 ||
      static_cast<long long>(bh) * ((s + 127) / 128) > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) & 15) != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1: return launch_hd<false>(q, k, v, out, bh, s, sk, hd, causal, window, scale, st);
    case 2: return launch_hd<true>(q, k, v, out, bh, s, sk, hd, causal, window, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
