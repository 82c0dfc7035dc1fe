// Blocked flash attention, causal and/or sliding-window, over float32
// q [B, H, S, HD] and k, v [B, H, Sk, HD] (contiguous, 16-byte aligned; Sk
// may differ from S), computed and written in float32:
//   s[q, k] = (q . k) * scale  where  mask(q, k),  else -1e30
//   mask    = (!causal || k <= q) && (!window || k > q - window)
//   out[q]  = sum_k p[q, k] v[k] / max(sum_k p[q, k], 1e-30)
// with the online softmax of the TPU kernel: a running max m (its -1e30
// guards m_safe and corr), denominator l and accumulator.  A row with no key
// left gives 0, as the TPU kernel does (not the uniform average that the
// full-materialisation oracle gives).
//
// Replaces the TPU kernel flash_attention of repro/kernels/flash_attention.py
// (pallas_call at flash_attention.py:117) for float32 inputs; bfloat16 and
// float16 inputs go to flash_attention_tc.cu.  Its contract is 2e-5 against
// the plain version at every head dim (32, 64, 128, 256).
//
// What bounds it on the H100: operations.  The 2e-5 contract needs products
// good to about 2^-22, which one TF32 product (10 mantissa bits) is not, so
// both products run as 3xTF32 on the tensor cores: each f32 operand x is
// split into hi = rna_tf32(x) and lo = rna_tf32(x - hi) (round to nearest,
// ties away, as cvt.rna.tf32.f32), and a b is taken as
// a_hi b_hi + a_hi b_lo + a_lo b_hi in f32 accumulators (the dropped a_lo b_lo
// is ~2^-22 of |a b|).  The bound is 3 x 4 HD flops per unmasked (q, k) pair
// at the 495 TFLOP/s TF32 rate, against 4 bytes per element of q, k, v and
// out read or written once.
//
// Design (Ampere-style mma.sync, one design for every head dim):
// * Why not wgmma.  wgmma has no transpose for tf32 and reads its shared
//   operands as they lie, so 3xTF32 there needs hi and lo copies of Q and K
//   and a transposed, split V in shared memory: at HD = 128 a 128-row Q
//   alone takes 128 KB, at HD = 256 a 64-row Q takes 128 KB, and with Q
//   from shared memory a 64 x 32 x 8 tf32 wgmma reads 192 bytes a clock,
//   above the 128 that shared memory gives.  mma.sync takes its operands
//   from registers, so the split is done on register fragments and shared
//   memory holds the raw f32 tiles once.  Its cost: mma.sync runs at about
//   two thirds of the tensor cores' rate (probes/flash_attention_f32.py
//   --rate measures it), so 3xTF32 here can reach at most ~65% of the bound.
// * One block per (b * h, tile of BQ query rows) on a 1-D grid, any B * H
//   up to the grid's 2^31 - 1 blocks: block x takes head x mod (B H) and
//   tile n_qt - 1 - x div (B H), so the heaviest causal tiles (the last
//   ones) of every head are launched first.  Warp w owns query rows
//   16 w .. 16 w + 15 of the tile: the m16 rows of every mma.  4 warps
//   (BQ = 64) at HD <= 128, two blocks an SM at HD = 128; 8 warps (BQ = 128)
//   at HD = 256, where one block fills an SM (F32Cfg).
// * Loads (no synchronous staging): the Q tile once and K, V tiles of BK
//   keys (64 at HD = 32, else 32) through a ring of cp.async 16-byte copies
//   (zero-filled past S or Sk, never reading the next head); two stages, so
//   the copy of tile j + 1 runs under the arithmetic of tile j, except at
//   HD = 256, where one block fills an SM either way and one stage leaves
//   its registers to the arithmetic.  Two __syncthreads a tile.  Rows are
//   padded to HD + 8 words (Q, K) and HD + 4 (V) so every fragment load
//   below is one 8-byte access per thread with no bank conflict.
// * S = Q K^T: mma.m16n8k8 tf32, with the contraction index relabelled
//   inside each group of 8 dims (mma column t <-> dim 2t, t + 4 <-> 2t + 1),
//   so a thread's two A and two B values are adjacent words.  Each value is
//   split once (4 integer ops and a subtraction) and feeds three mmas.
// * The online softmax runs in the accumulator's layout: a thread holds
//   rows g and g + 8 of its warp, columns 2t, 2t + 1 of each 8-key group,
//   each row over the 4 threads of a quad (two shuffles reduce it).  The
//   element mask is applied only where the warp's 16 rows meet the diagonal,
//   the window's edge or Sk; a warp whose 16 rows see no key of the tile
//   skips it (the same values: a fully masked tile leaves m, l and O as they
//   are); the K-loop bounds come from the block predicate of
//   flash_attention.py:51-55 at BQ x BK, so skipped tiles are never loaded.
//   exp is ex2.approx on log2-scaled scores.
// * O += P V: P comes straight from the S accumulator, split in registers,
//   as the A operand (no round trip through shared memory): the accumulator
//   holds keys 2t, 2t + 1 of each group where the A fragment wants t, t + 4,
//   so the keys are relabelled the same way on both operands (no shuffle),
//   and the B operand reads V rows 2t and 2t + 1.  Head dims are taken in
//   pairs of 8-column tiles, even and odd dims, so one 8-byte load feeds
//   both tiles and a thread's four outputs of a 16-dim group are adjacent
//   (one 16-byte store each).
// * out = O / max(l, 1e-30), an IEEE division; rows past S are not written.
// What it leaves: about half of mma.sync's own rate.  Each warp splits every
// K and V value it reads (the warps of a block split the same tile again,
// 5 ALU ops a value beside 1.5 mmas), yet dropping ops from the split moved
// nothing on the card, so the issue slots are not what binds; 8 warps an SM
// (205 registers and 101 KB a block at HD = 128; 255 registers and 198 KB at
// HD = 256) leave the mmas' latency partly exposed.  The tensor cores' own
// f32 accumulation adds more error than the split (~7e-6 on the card
// against ~1.5e-6 for the same arithmetic in IEEE f32).
#include <cuda_runtime.h>

#include <cstdint>

namespace repro_torch {
namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// Tiles, ring stages and blocks an SM by head dim.  A warp owns 16 query
// rows; a block has 4 warps (64 rows) at HD <= 128 and 8 (128 rows) at
// HD = 256, where one block fills an SM's shared memory and its 8 warps
// hide each other's latency, as two blocks of 4 do at HD = 128.  At
// HD = 256 a single ring stage leaves its 255 registers to the arithmetic.
template <int HD>
struct F32Cfg {
  static constexpr int WARPS = HD == 256 ? 8 : 4;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int BQ = 16 * WARPS;  // query rows per block
  static constexpr int BK = HD == 32 ? 64 : 32;  // keys per K/V tile
  static constexpr int LDK = HD + 8;  // row pitch of Q and K (words): 8 g + 2 t banks
  static constexpr int LDV = HD + 4;  // row pitch of V: 8 t + 2 g banks
  static constexpr int Q_WORDS = BQ * LDK;
  static constexpr int K_WORDS = BK * LDK;
  static constexpr int STAGE_WORDS = K_WORDS + BK * LDV;
  static constexpr int ST = HD == 256 ? 1 : 2;  // ring stages
  static constexpr int SMEM = 4 * (Q_WORDS + ST * STAGE_WORDS);
  // blocks an SM should hold (registers asked of ptxas accordingly)
  static constexpr int MIN_BLOCKS = HD <= 64 ? 16 / WARPS : (HD == 128 ? 2 : 1);
};

// ---- cp.async ---------------------------------------------------------------

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// Copy rows [row0, row0 + NROWS) of one (b, h) slice [limit, HD] into shared
// memory at `dst` with row pitch LD words; rows at or past `limit` are zeros.
template <int THREADS, int HD, int LD, int NROWS>
__device__ __forceinline__ void stage(uint32_t dst, const float* __restrict__ src, int row0,
                                      int limit) {
  constexpr int CPR = HD / 4;  // 16-byte chunks a row
  static_assert(NROWS * CPR % THREADS == 0, "whole chunks per thread");
#pragma unroll
  for (int i = 0; i < NROWS * CPR / THREADS; ++i) {
    const int idx = threadIdx.x + i * THREADS;
    const int r = idx / CPR, c = idx % CPR;
    const bool ok = row0 + r < limit;
    const float* from = src + static_cast<long long>(ok ? row0 + r : 0) * HD + 4 * c;
    cp_async16(dst + 4 * (r * LD + 4 * c), from, ok);
  }
}

// ---- 3xTF32 -----------------------------------------------------------------

// x -> (hi, lo): hi = x rounded to tf32 (nearest, ties away from zero: half
// a tf32 ulp added to the magnitude's bits, the low 13 bits cleared), lo the
// same rounding of x - hi (exact in f32).  Equal to cvt.rna.tf32.f32 on
// finite inputs.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xFFFFE000u;
}

// d[16 x 8] += A[16 x 8] B[8 x 8], tf32 in, f32 accumulation.
__device__ __forceinline__ void mma(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
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

template <int HD>
__global__ void __launch_bounds__(F32Cfg<HD>::THREADS, F32Cfg<HD>::MIN_BLOCKS)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out, int bh_count,
                       int s, int sk, int causal, int window, float scale_log2) {
  using C = F32Cfg<HD>;
  constexpr int BQ = C::BQ, BK = C::BK, LDK = C::LDK, LDV = C::LDV, STAGES = C::ST;
  constexpr int T = C::THREADS;
  extern __shared__ __align__(16) float smem[];
  const float* sQ = smem;
  const float* sKV = smem + C::Q_WORDS;  // stage st: K at st * STAGE_WORDS, V after it
  const uint32_t sQ_addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t sKV_addr = sQ_addr + 4 * C::Q_WORDS;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // block x of the flat grid: head x mod bh_count, and the heaviest causal
  // tiles of every head first (kernels/launch_plan.py attention_block)
  const int n_qt = (s + BQ - 1) / BQ;
  const long long bh = blockIdx.x % static_cast<unsigned>(bh_count);
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x / static_cast<unsigned>(bh_count))) * BQ;
  const int q_lo = q0 + 16 * warp;  // this warp's first row
  const int r0 = q_lo + g;          // this thread's rows r0 and r0 + 8
  const float* qh = q + bh * s * HD;
  const float* kh = k + bh * sk * HD;
  const float* vh = v + bh * sk * HD;

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

  stage<T, HD, LDK, BQ>(sQ_addr, qh, q0, s);
  cp_async_commit();
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {  // tiles 0 .. STAGES - 2, a group each
    if (i < n_tiles) {
      const uint32_t dst = sKV_addr + 4 * i * C::STAGE_WORDS;
      stage<T, HD, LDK, BK>(dst, kh, (kt_lo + i) * BK, sk);
      stage<T, HD, LDV, BK>(dst + 4 * C::K_WORDS, vh, (kt_lo + i) * BK, sk);
    }
    cp_async_commit();
  }

  // o[8 p + 4 h + i]: dims 16 p + 2 n + h (h = 0 even, 1 odd) of the mma
  // tile's column n, i its accumulator register (rows r0, r0, r0 + 8, r0 + 8;
  // n = 2 t, 2 t + 1, 2 t, 2 t + 1)
  float o[HD / 2];
#pragma unroll
  for (int j = 0; j < HD / 2; ++j) o[j] = 0.0f;
  float m0 = NEG_INF, m1 = NEG_INF;  // running max (log2-scaled) of rows r0, r0 + 8
  float l0 = 0.0f, l1 = 0.0f;        // this thread's share of their denominators
  const float* qw = sQ + 16 * warp * LDK;

  for (int j = 0; j < n_tiles; ++j) {
    // tile j + STAGES - 1 (with one stage, tile j itself; else its copy runs
    // under the arithmetic of tile j)
    if (j + STAGES - 1 < n_tiles) {
      const int jn = j + STAGES - 1;
      const uint32_t next = sKV_addr + 4 * (jn % STAGES) * C::STAGE_WORDS;
      stage<T, HD, LDK, BK>(next, kh, (kt_lo + jn) * BK, sk);
      stage<T, HD, LDV, BK>(next + 4 * C::K_WORDS, vh, (kt_lo + jn) * BK, sk);
    }
    cp_async_commit();
    cp_async_wait<STAGES - 1>();  // all but the newest STAGES - 1 groups: Q and tile j
    __syncthreads();
    const int k0 = (kt_lo + j) * BK;
    const float* sK = sKV + (j % STAGES) * C::STAGE_WORDS;
    const float* sV = sK + C::K_WORDS;
    const bool dead = q_lo >= s || (causal && k0 > q_lo + 15) ||
                      (window && static_cast<long long>(k0) + BK - 1 <= q_lo - window);
    if (!dead) {
      // ---- S = Q K^T (column t <-> dim 2 t, t + 4 <-> 2 t + 1 in each group of 8)
      float sc[BK / 2];  // sc[4 n + i]: keys k0 + 8 n + 2 t (+1), rows r0 (+8)
#pragma unroll
      for (int jj = 0; jj < BK / 2; ++jj) sc[jj] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < HD / 8; ++kk) {
        uint32_t ah[4], al[4];
        const float2 qa = *reinterpret_cast<const float2*>(qw + g * LDK + 8 * kk + 2 * t);
        const float2 qb = *reinterpret_cast<const float2*>(qw + (g + 8) * LDK + 8 * kk + 2 * t);
        split(qa.x, ah[0], al[0]);
        split(qb.x, ah[1], al[1]);
        split(qa.y, ah[2], al[2]);
        split(qb.y, ah[3], al[3]);
        uint32_t kb_hi[BK / 8][2], kb_lo[BK / 8][2];
#pragma unroll
        for (int n = 0; n < BK / 8; ++n) {
          const float2 kb =
              *reinterpret_cast<const float2*>(sK + (8 * n + g) * LDK + 8 * kk + 2 * t);
          split(kb.x, kb_hi[n][0], kb_lo[n][0]);
          split(kb.y, kb_hi[n][1], kb_lo[n][1]);
        }
#pragma unroll
        for (int n = 0; n < BK / 8; ++n) mma(sc + 4 * n, al, kb_hi[n][0], kb_hi[n][1]);
#pragma unroll
        for (int n = 0; n < BK / 8; ++n) mma(sc + 4 * n, ah, kb_lo[n][0], kb_lo[n][1]);
#pragma unroll
        for (int n = 0; n < BK / 8; ++n) mma(sc + 4 * n, ah, kb_hi[n][0], kb_hi[n][1]);
      }

      // ---- masked, log2-scaled scores and the row maxima
      const bool edge = static_cast<long long>(k0) + BK > sk ||
                        (causal && k0 + BK - 1 > q_lo) ||
                        (window && static_cast<long long>(k0) <= q_lo + 15LL - window);
      float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
      for (int jj = 0; jj < BK / 2; ++jj) {
        float x = sc[jj] * scale_log2;
        if (edge) {
          const int row = (jj & 2) ? r0 + 8 : r0;
          const int col = k0 + 8 * (jj / 4) + 2 * t + (jj & 1);
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

      // ---- p = exp(s - m_safe) (exactly 0 where masked)
      float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
      for (int jj = 0; jj < BK / 2; ++jj) {
        const float p = ex2(sc[jj] - ((jj & 2) ? ms1 : ms0));
        if (jj & 2) sum1 += p;
        else sum0 += p;
        sc[jj] = p;
      }
      l0 = l0 * corr0 + sum0;
      l1 = l1 * corr1 + sum1;
#pragma unroll
      for (int jj = 0; jj < HD / 2; ++jj) o[jj] *= (jj & 2) ? corr1 : corr0;

      // ---- O += P V (column t <-> key 2 t, t + 4 <-> 2 t + 1 in each group of 8)
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {
        uint32_t ah[4], al[4];
        split(sc[4 * kk + 0], ah[0], al[0]);  // row r0,     key 2 t
        split(sc[4 * kk + 2], ah[1], al[1]);  // row r0 + 8, key 2 t
        split(sc[4 * kk + 1], ah[2], al[2]);  // row r0,     key 2 t + 1
        split(sc[4 * kk + 3], ah[3], al[3]);  // row r0 + 8, key 2 t + 1
        const float* v0 = sV + (8 * kk + 2 * t) * LDV + 2 * g;
#pragma unroll
        for (int p = 0; p < HD / 16; ++p) {
          // (even, odd) dims 16 p + 2 g (+1) of keys 2 t and 2 t + 1
          uint32_t eh[2], el[2], oh[2], ol[2];
          const float2 va = *reinterpret_cast<const float2*>(v0 + 16 * p);
          const float2 vb = *reinterpret_cast<const float2*>(v0 + LDV + 16 * p);
          split(va.x, eh[0], el[0]);
          split(vb.x, eh[1], el[1]);
          split(va.y, oh[0], ol[0]);
          split(vb.y, oh[1], ol[1]);
          mma(o + 8 * p, al, eh[0], eh[1]);
          mma(o + 8 * p + 4, al, oh[0], oh[1]);
          mma(o + 8 * p, ah, el[0], el[1]);
          mma(o + 8 * p + 4, ah, ol[0], ol[1]);
          mma(o + 8 * p, ah, eh[0], eh[1]);
          mma(o + 8 * p + 4, ah, oh[0], oh[1]);
        }
      }
    }
    __syncthreads();  // stage j % STAGES is free for tile j + STAGES
  }
  cp_async_wait<0>();

  // ---- out = O / max(l, 1e-30); a thread's dims 16 p + 4 t .. + 3 are adjacent
  const float d0 = fmaxf(quad_sum(l0), 1e-30f);
  const float d1 = fmaxf(quad_sum(l1), 1e-30f);
  float* oh = out + (bh * s + r0) * HD + 4 * t;
#pragma unroll
  for (int p = 0; p < HD / 16; ++p) {
    if (r0 < s) {
      *reinterpret_cast<float4*>(oh + 16 * p) =
          make_float4(o[8 * p] / d0, o[8 * p + 4] / d0, o[8 * p + 1] / d0, o[8 * p + 5] / d0);
    }
    if (r0 + 8 < s) {
      *reinterpret_cast<float4*>(oh + 8 * HD + 16 * p) =
          make_float4(o[8 * p + 2] / d1, o[8 * p + 6] / d1, o[8 * p + 3] / d1,
                      o[8 * p + 7] / d1);
    }
  }
}

constexpr int MAX_DEVICES = 64;

template <int HD>
int launch(const float* q, const float* k, const float* v, float* out, int bh, int s, int sk,
           int causal, int window, float scale, cudaStream_t stream) {
  using C = F32Cfg<HD>;
  // one block per (b * h, query tile) on a 1-D grid of at most 2^31 - 1
  if (static_cast<long long>(bh) * ((s + C::BQ - 1) / C::BQ) > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int smem = C::SMEM;
  auto kernel = flash_attention_kernel<HD>;
  // above 48 KB a block's shared memory must be asked for, once on each device
  // (the attribute belongs to the current device)
  static cudaError_t attr[MAX_DEVICES];
  static bool asked[MAX_DEVICES];
  int device = 0;
  const cudaError_t dev_err = cudaGetDevice(&device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  if (device >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  if (!asked[device]) {
    attr[device] = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        smem);
    asked[device] = true;
  }
  if (attr[device] != cudaSuccess) return static_cast<int>(attr[device]);
  const dim3 grid(static_cast<unsigned>(bh) * static_cast<unsigned>((s + C::BQ - 1) / C::BQ));
  kernel<<<grid, C::THREADS, smem, stream>>>(q, k, v, out, bh, s, sk, causal, window,
                                             scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

int launch_hd(const float* q, const float* k, const float* v, float* out, int bh, int s, int sk,
              int hd, int causal, int window, float scale, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<32>(q, k, v, out, bh, s, sk, causal, window, scale, stream);
    case 64: return launch<64>(q, k, v, out, bh, s, sk, causal, window, scale, stream);
    case 128: return launch<128>(q, k, v, out, bh, s, sk, causal, window, scale, stream);
    case 256: return launch<256>(q, k, v, out, bh, s, sk, causal, window, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace repro_torch

// float32 q, k, v, out, each 16-byte aligned (cp.async).  Launch on `stream`;
// returns the cudaError_t of the launch (0 = success).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* out, int b, int h, int s, int sk, int hd,
                                      int causal, int window, float scale, void* stream) {
  using namespace repro_torch;
  if (b <= 0 || h <= 0 || s <= 0 || sk <= 0 || window < 0 ||
      static_cast<long long>(b) * h > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) & 15) != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  return launch_hd(static_cast<const float*>(q), static_cast<const float*>(k),
                   static_cast<const float*>(v), static_cast<float*>(out), b * h, s, sk, hd,
                   causal, window, scale, static_cast<cudaStream_t>(stream));
}
