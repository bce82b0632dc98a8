// Capacity-batched expert GEMM: out[e] = x[e] @ w[e] for every expert e,
// (E, C, D) x (E, D, F) -> (E, C, F), accumulated in float32 over D and
// rounded once to the inputs' type.
//
// Replaces the Pallas TPU kernel repro/kernels/moe_gemm/kernel.py:40
// (expert_gemm_fwd -> _gemm_kernel, :22), the per-expert GEMM of the
// (E, C, d) buffer that the MoE layer gathers (static capacity: a dropped
// token is a zero row, an expert with no token still runs).  It computes
// repro_torch/kernels/moe_gemm/ref.py::reference_expert_gemm.
//
// Layout, all contiguous: x (E, C, D), w (E, D, F), out (E, C, F), one type,
// bf16 or float32.  The TPU grid's sequential K axis (accumulating in VMEM
// scratch) is a loop inside the block here, because CUDA blocks run in no
// order.  Three kernels, chosen by the type and the shape alone:
//
// - bf16, D and F multiples of 8 (every config; TMA needs 16-byte row
//   strides): expert_gemm_tma_kernel, wgmma fed by TMA.  It computes
//   out^T[e] = w[e]^T . x[e]^T, so that the weights are wgmma's M side (64
//   rows of F per consumer warpgroup, read MN-major: the transpose bit) and
//   the tokens its N side (K-major), N = C rounded up to a multiple of 8
//   (168 stays 168, the decode step's 4 becomes 8), a second grid axis
//   past 256.  A block of 384 threads owns 128 rows of F of one expert:
//   two consumer warpgroups and one producer warpgroup whose first thread
//   keeps 3 to 6 K steps of 64 (a 16 KB w tile and an x tile) in flight in
//   a ring of mbarrier-guarded stages (128-byte swizzle, zero fill past C,
//   D and F); setmaxnreg moves registers from the producer (40) to the
//   consumers (232).  The grid's fastest axis walks an expert's F tiles,
//   so L2 serves the x re-reads.  The float32 (F, N) tile goes through
//   shared memory (the ring, once drained) and leaves as 16-byte row
//   stores, rounded to nearest even once.  csrc/hopper.cuh holds the TMA,
//   mbarrier and wgmma helpers.  The gradient's two products launch the
//   same kernel's transpose-bit variants on the operands where they lie
//   (expert_gemm_tma_bf16; see the TMA section): dX = dY . W^T reads w
//   K-major, dW = X^T . dY reads dY and x MN-major, so no transposed copy
//   is made; their blocks are persistent and store by TMA.
// - bf16, D or F not a multiple of 8 (the ragged test shapes only):
//   expert_gemm_bf16_kernel, tensor cores through the wmma API (16 x 16 x
//   16 bf16 products, float accumulators in registers), K step 32, a
//   three-stage cp.async ring where D or F is a multiple of 8, element
//   loads otherwise; tiles of 64 x 64 (C > 16) or 16 x 128 (C <= 16).
// - float32: the float32 cores, a 64 x 64 tile, K step 16, each of 256
//   threads accumulating a 4 x 4 block with explicit fused multiply-adds
//   (__fmaf_rn, which --fmad=false leaves alone) in order k = 0 .. D - 1.
//
// Bound on an H100 SXM, at the serve shapes (bf16): the prefill's
// (128, 168, 2048) x (128, 2048, 768) moves 524 MB (403 MB of it weights)
// for 67.6 GFLOP: 0.156 ms at 3.35 TB/s against 0.068 ms at 989 TFLOP/s,
// bytes bound.  The decode step's (128, 4, 2048) x (128, 2048, 768) moves
// 406 MB for 1.6 GFLOP: 0.121 ms, bytes bound; static capacity reads every
// expert's weights each step, empty experts too (the JAX semantics, kept).
// What the design does: every weight element is read from device memory
// once per launch (C <= 256), by TMA, several steps ahead of the products,
// and the MMA rows are weights, so a decode step's four tokens waste no
// MMA rows of weights, only N columns (8 for 4).  The backward at the
// training shape (C = 168) reads w once for dX and writes dW once, 403 MB
// each at qwen's gate/up: 0.303 ms for the pair at 3.35 TB/s, bytes bound;
// dW's K is only 168, so its x and dY tiles are read again from L2 for
// every (f, d) tile, which the 128 x 256 tiles keep to 4.5 bytes a result.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  // 16 bytes global -> shared, asynchronous; zero-filled when !pred
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// An (R x K) tile of a row-major matrix g (row stride ld, nrows x ncols)
// at (r0, k0) into shared memory s (row stride lds), zero outside the
// matrix.  `vec`: ld and ncols are multiples of 8 and g is 16-byte aligned,
// and the tile moves as asynchronous 16-byte copies (completed by
// cp_async_wait); otherwise element by element, synchronously.
template <int R, int K, int THREADS>
__device__ __forceinline__ void load_tile(bf16* s, int lds,
                                          const bf16* __restrict__ g, int ld,
                                          int r0, int k0, int nrows,
                                          int ncols, bool vec) {
  if (vec) {
    constexpr int KV = K / 8;
    for (int idx = threadIdx.x; idx < R * KV; idx += THREADS) {
      const int r = idx / KV, c = (idx % KV) * 8;
      const bool live = r0 + r < nrows && k0 + c < ncols;
      cp_async16(s + r * lds + c,
                 live ? g + (long long)(r0 + r) * ld + k0 + c : g, live);
    }
  } else {
    for (int idx = threadIdx.x; idx < R * K; idx += THREADS) {
      const int r = idx / K, c = idx % K;
      bf16 val = __ushort_as_bfloat16((unsigned short)0);
      if (r0 + r < nrows && k0 + c < ncols)
        val = g[(long long)(r0 + r) * ld + k0 + c];
      s[r * lds + c] = val;
    }
  }
}

// WM x WN warps, each computing FM x FN fragments of 16 x 16.
template <int WM, int WN, int FM, int FN>
struct BfTile {
  static constexpr int BC = WM * FM * 16;
  static constexpr int BF = WN * FN * 16;
  static constexpr int BK = 32;
  static constexpr int THREADS = WM * WN * 32;
  static constexpr int LDA = BK + 8;  // bf16 elements (80-byte rows)
  static constexpr int LDB = BF + 8;
  static constexpr int LDC = BF + 4;  // floats
  static constexpr int STAGES = 3;    // K steps in flight
  static constexpr int A_STAGE = BC * LDA;
  static constexpr int B_STAGE = BK * LDB;
};

template <int WM, int WN, int FM, int FN>
__global__ void __launch_bounds__(WM * WN * 32)
expert_gemm_bf16_kernel(const bf16* __restrict__ x,
                        const bf16* __restrict__ w, bf16* __restrict__ out,
                        int C, int D, int F, int vec_x, int vec_w) {
  using P = BfTile<WM, WN, FM, FN>;
  __shared__ __align__(32) bf16 s_a[P::STAGES * P::A_STAGE];
  __shared__ __align__(32) bf16 s_b[P::STAGES * P::B_STAGE];
  __shared__ __align__(32) float s_c[P::BC * P::LDC];

  const int f0 = blockIdx.x * P::BF, c0 = blockIdx.y * P::BC;
  const int e = blockIdx.z;
  const bf16* xe = x + (long long)e * C * D;
  const bf16* we = w + (long long)e * D * F;
  const int warp = threadIdx.x / 32;
  const int wm = warp / WN, wn = warp % WN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  // a ring of STAGES K steps: step t lives in stage t % STAGES; the copies
  // of steps t + 1 .. t + STAGES - 1 are in flight while step t computes
  const int nk = (D + P::BK - 1) / P::BK;
  auto load = [&](int t) {
    const int st = t % P::STAGES, k0 = t * P::BK;
    load_tile<P::BC, P::BK, P::THREADS>(s_a + st * P::A_STAGE, P::LDA, xe, D,
                                        c0, k0, C, D, vec_x != 0);
    load_tile<P::BK, P::BF, P::THREADS>(s_b + st * P::B_STAGE, P::LDB, we, F,
                                        k0, f0, D, F, vec_w != 0);
  };
#pragma unroll
  for (int t = 0; t < P::STAGES - 1; ++t) {
    if (t < nk) load(t);
    cp_async_commit();
  }
  for (int t = 0; t < nk; ++t) {
    cp_async_wait<P::STAGES - 2>();  // step t has landed (this thread's)
    __syncthreads();  // ... every thread's; and step t - 1 is computed
    if (t + P::STAGES - 1 < nk) load(t + P::STAGES - 1);
    cp_async_commit();
    const bf16* a_st = s_a + (t % P::STAGES) * P::A_STAGE;
    const bf16* b_st = s_b + (t % P::STAGES) * P::B_STAGE;
#pragma unroll
    for (int kk = 0; kk < P::BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(a[i], a_st + (wm * FM + i) * 16 * P::LDA + kk,
                               P::LDA);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(b[j], b_st + kk * P::LDB + (wn * FN + j) * 16,
                               P::LDB);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(
          s_c + (wm * FM + i) * 16 * P::LDC + (wn * FN + j) * 16, acc[i][j],
          P::LDC, wmma::mem_row_major);
  __syncthreads();
  bf16* oe = out + (long long)e * C * F;
  for (int idx = threadIdx.x; idx < P::BC * P::BF; idx += P::THREADS) {
    const int r = idx / P::BF, c = idx % P::BF;
    if (c0 + r < C && f0 + c < F)
      oe[(long long)(c0 + r) * F + f0 + c] =
          __float2bfloat16_rn(s_c[r * P::LDC + c]);
  }
}

constexpr int F32_BC = 64, F32_BF = 64, F32_BK = 16, F32_THREADS = 256;

__global__ void __launch_bounds__(F32_THREADS)
expert_gemm_f32_kernel(const float* __restrict__ x,
                       const float* __restrict__ w, float* __restrict__ out,
                       int C, int D, int F) {
  __shared__ float s_a[F32_BK][F32_BC + 4];  // x tile, transposed (k-major)
  __shared__ float s_b[F32_BK][F32_BF + 4];
  const int f0 = blockIdx.x * F32_BF, c0 = blockIdx.y * F32_BC;
  const int e = blockIdx.z;
  const float* xe = x + (long long)e * C * D;
  const float* we = w + (long long)e * D * F;
  const int tid = threadIdx.x;
  const int tr = tid / 16, tc = tid % 16;  // rows tr + 16 i, cols tc + 16 j

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < D; k0 += F32_BK) {
    for (int idx = tid; idx < F32_BC * F32_BK; idx += F32_THREADS) {
      const int r = idx / F32_BK, kk = idx % F32_BK;
      s_a[kk][r] = (c0 + r < C && k0 + kk < D)
                       ? xe[(long long)(c0 + r) * D + k0 + kk]
                       : 0.0f;
    }
    for (int idx = tid; idx < F32_BK * F32_BF; idx += F32_THREADS) {
      const int kk = idx / F32_BF, c = idx % F32_BF;
      s_b[kk][c] = (k0 + kk < D && f0 + c < F)
                       ? we[(long long)(k0 + kk) * F + f0 + c]
                       : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < F32_BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = s_a[kk][tr + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = s_b[kk][tc + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* oe = out + (long long)e * C * F;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = c0 + tr + 16 * i;
    if (r >= C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = f0 + tc + 16 * j;
      if (c < F) oe[(long long)r * F + c] = acc[i][j];
    }
  }
}

template <int WM, int WN, int FM, int FN>
int launch_bf16(const bf16* x, const bf16* w, bf16* out, int E, int C, int D,
                int F, cudaStream_t stream) {
  using P = BfTile<WM, WN, FM, FN>;
  const int vec_x = (D % 8 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  const int vec_w = (F % 8 == 0) && (reinterpret_cast<uintptr_t>(w) % 16 == 0);
  const dim3 grid((unsigned)((F + P::BF - 1) / P::BF),
                  (unsigned)((C + P::BC - 1) / P::BC), (unsigned)E);
  expert_gemm_bf16_kernel<WM, WN, FM, FN><<<grid, P::THREADS, 0, stream>>>(
      x, w, out, C, D, F, vec_x, vec_w);
  return (int)cudaGetLastError();
}


// ------------------------------------- bf16, D and F multiples of 8: TMA
// out[e][n][m] = sum_k A[e][m][k] . B[e][k][n], as wgmma's (M, N) tile
// with M the contiguous axis of out: 64 rows of M a consumer warpgroup,
// two a block; N at most 256 a tile, a grid axis (or tile index) beyond;
// K in steps of 64.  TA and TB are the operands' transpose bits:
//   A, TA = 1 (MN-major): stored (E, K, M), two boxes of (64 of M, 64 of K);
//   A, TA = 0 (K-major):  stored (E, M, K), one box of (64 of K, 128 of M);
//   B, TB = 0 (K-major):  stored (E, N, K), one box of (64 of K, N rows);
//   B, TB = 1 (MN-major): stored (E, K, N), N / 64 boxes of (64 of N, 64
//   of K), so N is a multiple of 64 (the box's zero fill pads it).
// The forward is (TA, TB) = (1, 0): A = w (E, D, F), B = x (E, C, D),
// out (E, C, F).  The backward reads its operands where they lie:
//   dX: (0, 0), A = w (E, d, f) (M = d, K = f), B = dY (E, C, f) (N = C);
//   dW: (1, 1), A = dY (E, C, f) (M = f, K = C), B = x (E, C, d) (N = d).
// One producer warpgroup (its first thread starts the loads) keeps STAGES
// steps of (A tile, B tile) in flight.  PERSIST = false (the forward): one
// block a tile, grid (M tiles, N tiles, E), the ring reused for the
// epilogue, which leaves as 16-byte row stores.  PERSIST = true (the
// backward): a block walks tiles blockIdx.x, + gridDim.x, ... (M fastest,
// then N, then the expert) with an epilogue buffer of its own, two
// 128-byte-swizzled boxes of (64 of M, N rows) that one TMA store each
// writes out (clipped at the tensor's edge) while the consumers go on to
// the next tile's products and the producer loads it; the launcher picks
// the number of blocks.
template <int N, int TA, int TB, bool PERSIST>
struct GemmTma {
  static constexpr int BF = 128;            // M rows of a block
  static constexpr int BK = 64;             // K of a step (one 128-byte box)
  static constexpr int A_BYTES = BK * BF * 2;
  static constexpr int B_BYTES = N * BK * 2;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int EPI_LD = BF + 8;     // the forward's epilogue row
  static constexpr int EPI_BYTES = PERSIST ? N * BF * 2 : 0;
  static constexpr int RING = (PERSIST ? 216 : 200) * 1024 - EPI_BYTES;
  static constexpr int STAGES = RING / STAGE < 6 ? RING / STAGE : 6;
  static constexpr int THREADS = 384;
  static constexpr size_t SMEM = 1024 + (size_t)STAGES * STAGE + EPI_BYTES
                                 + 2 * STAGES * sizeof(uint64_t);
  static_assert(N % 8 == 0 && N <= 256, "N: a multiple of 8, at most 256");
  static_assert(TB == 0 || N % 64 == 0, "an MN-major B is whole boxes");
  static_assert(STAGES >= (PERSIST ? 2 : 3)
                && (PERSIST || STAGES * STAGE >= N * EPI_LD * 2),
                "the forward's epilogue reuses the ring");
};

template <int N, int TA, int TB, bool PERSIST>
__global__ void __launch_bounds__(384, 1)
expert_gemm_tma_kernel(const __grid_constant__ CUtensorMap map_a,
                       const __grid_constant__ CUtensorMap map_b,
                       const __grid_constant__ CUtensorMap map_out,
                       bf16* __restrict__ out, int n_all, int K, int M,
                       int m_tiles, int n_tiles, int tiles) {
  using P = GemmTma<N, TA, TB, PERSIST>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + P::STAGES * P::STAGE
                                               + P::EPI_BYTES);
  uint64_t* empty = full + P::STAGES;
  // the forward stages its epilogue in the drained ring
  bf16* epi = reinterpret_cast<bf16*>(PERSIST ? ring + P::STAGES * P::STAGE
                                              : ring);

  const int nk = (K + P::BK - 1) / P::BK;
  const int t_first = PERSIST ? (int)blockIdx.x : 0;
  const int t_step = PERSIST ? (int)gridDim.x : 1;
  const int t_end = PERSIST ? tiles : 1;
  // (m0, n0, e) of the tile t
  auto tile_at = [&](int t, int& m0, int& n0, int& e) {
    if constexpr (PERSIST) {
      m0 = (t % m_tiles) * P::BF;
      n0 = ((t / m_tiles) % n_tiles) * N;
      e = t / (m_tiles * n_tiles);
    } else {
      m0 = blockIdx.x * P::BF;
      n0 = blockIdx.y * N;
      e = blockIdx.z;
    }
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < P::STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);  // a consumer warp each
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup
    hopper::regs_dec<40>();
    if (threadIdx.x == 0) {
      hopper::prefetch_map(&map_a);
      hopper::prefetch_map(&map_b);
      int i = 0;  // steps loaded, over every tile of this block
      for (int t = t_first; t < t_end; t += t_step) {
        int m0, n0, e;
        tile_at(t, m0, n0, e);
        for (int kt = 0; kt < nk; ++kt, ++i) {
          const int st = i % P::STAGES;
          const int k0 = kt * P::BK;
          hopper::mbar_wait(&empty[st], ((i / P::STAGES) & 1) ^ 1);
          hopper::mbar_expect_tx(&full[st], P::STAGE);
          uint8_t* sa = ring + st * P::STAGE;
          uint8_t* sb = sa + P::A_BYTES;
          if (TA) {
            hopper::tma_load_3d(sa, &map_a, &full[st], m0, k0, e);
            hopper::tma_load_3d(sa + P::A_BYTES / 2, &map_a, &full[st],
                                m0 + 64, k0, e);
          } else {
            hopper::tma_load_3d(sa, &map_a, &full[st], k0, m0, e);
          }
          if (TB) {
            for (int b = 0; b < N / 64; ++b)
              hopper::tma_load_3d(sb + b * P::BK * 128, &map_b, &full[st],
                                  n0 + 64 * b, k0, e);
          } else {
            hopper::tma_load_3d(sb, &map_b, &full[st], k0, n0, e);
          }
        }
      }
    }
    return;
  }

  // consumer warpgroup c: M rows m0 + 64 c ..; acc holds (64 of M, N)
  hopper::regs_inc<232>();
  const int c = threadIdx.x / 128 - 1;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int fr = 64 * c + 16 * warp + lane / 4;
  int i = 0;
  for (int t = t_first; t < t_end; t += t_step) {
    int m0, n0, e;
    tile_at(t, m0, n0, e);
    float acc[N / 2];
#pragma unroll
    for (int j = 0; j < N / 2; ++j) acc[j] = 0.0f;

    for (int kt = 0; kt < nk; ++kt, ++i) {
      const int st = i % P::STAGES;
      hopper::mbar_wait(&full[st], (i / P::STAGES) & 1);
      // consumer c's 64 rows of M: box c (MN-major) or rows 64 c .. of the
      // one box (K-major), both A_BYTES / 2 on
      const uint8_t* sa = ring + st * P::STAGE + c * (P::A_BYTES / 2);
      const uint8_t* sb = ring + st * P::STAGE + P::A_BYTES;
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < P::BK / 16; ++kk) {
        const uint64_t da =
            TA ? hopper::desc_sw128(sa + kk * 16 * 128, P::A_BYTES / 2, 1024)
               : hopper::desc_sw128(sa + kk * 32, 16, 1024);
        const uint64_t db =
            TB ? hopper::desc_sw128(sb + kk * 16 * 128, P::BK * 128, 1024)
               : hopper::desc_sw128(sb + kk * 32, 16, 1024);
        hopper::WgmmaSS<N, TA, TB>::run(acc, da, db, 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs<N / 2>(acc);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[st]);
    }

    if constexpr (PERSIST) {
      // epilogue: the tile, rounded once, into consumer c's box of (64 of
      // M, N rows) in the 128-byte swizzle (the 16-byte chunk of column m
      // of row n at chunk (m / 8) ^ (n % 8)), then one TMA store a box;
      // the first barrier: the last tile's stores have read the buffer
      if (threadIdx.x == 128) hopper::bulk_wait_read<0>();
      hopper::named_sync(1, 256);
      uint8_t* box = reinterpret_cast<uint8_t*>(epi) + c * N * 128;
      const int col = 16 * warp + lane / 4;
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int n = 8 * j + 2 * (lane % 4) + x;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = col + 8 * h;
            *reinterpret_cast<bf16*>(box + n * 128
                                     + ((((m >> 3) ^ (n & 7)) << 4)
                                        | ((m & 7) << 1))) =
                __float2bfloat16_rn(acc[4 * j + 2 * h + x]);
          }
        }
      hopper::fence_proxy_async();
      hopper::named_sync(1, 256);
      if (threadIdx.x == 128) {
        hopper::tma_store_3d(&map_out, epi, m0, n0, e);
        hopper::tma_store_3d(&map_out,
                             reinterpret_cast<uint8_t*>(epi) + N * 128,
                             m0 + 64, n0, e);
        hopper::bulk_commit();
      }
    } else {
      // epilogue: the (N, 128) bf16 tile, rounded once, for row-wise
      // 16-byte stores; the first barrier: every consumer has read the
      // ring
      hopper::named_sync(1, 256);
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int x = 0; x < 2; ++x)
            epi[(8 * j + 2 * (lane % 4) + x) * P::EPI_LD + fr + 8 * h] =
                __float2bfloat16_rn(acc[4 * j + 2 * h + x]);
      hopper::named_sync(1, 256);
      bf16* oe = out + (long long)e * n_all * M;
      for (int idx = threadIdx.x - 128; idx < N * (P::BF / 8); idx += 256) {
        const int n = idx / (P::BF / 8), f = (idx % (P::BF / 8)) * 8;
        if (n0 + n < n_all && m0 + f < M)
          *reinterpret_cast<uint4*>(oe + (long long)(n0 + n) * M + m0 + f) =
              *reinterpret_cast<const uint4*>(epi + n * P::EPI_LD + f);
      }
    }
  }
  // the block's shared memory outlives the last store's reads of it
  if (PERSIST && threadIdx.x == 128) hopper::bulk_wait_read<0>();
}

// The tensor maps of A and B (see GemmTma): A (E, M, K) or (E, K, M), B
// (E, N, K) or (E, K, N), all contiguous.
template <int N, int TA, int TB, bool PERSIST>
int launch_tma(const bf16* a, const bf16* b, bf16* out, int E, int n_all,
               int K, int M, int n_tiles, int blocks, cudaStream_t stream) {
  using P = GemmTma<N, TA, TB, PERSIST>;
  CUtensorMap map_a, map_b, map_out{};
  int rc = TA ? hopper::make_map_bf16(&map_a, a, M, K, E, P::BK)
              : hopper::make_map_bf16(&map_a, a, K, M, E, P::BF);
  if (rc == 0)
    rc = TB ? hopper::make_map_bf16(&map_b, b, n_all, K, E, P::BK)
            : hopper::make_map_bf16(&map_b, b, K, n_all, E, N);
  // out (E, n_all, M), boxes of (64 of M, N rows): the backward's stores
  if (rc == 0 && PERSIST)
    rc = hopper::make_map_bf16(&map_out, out, M, n_all, E, N);
  if (rc != 0) return rc;
  auto kern = expert_gemm_tma_kernel<N, TA, TB, PERSIST>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int m_tiles = (M + P::BF - 1) / P::BF;
  const long long tiles = (long long)m_tiles * n_tiles * E;
  if (tiles >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const dim3 grid =
      PERSIST ? dim3((unsigned)(blocks > 0 && blocks < tiles ? blocks
                                                             : tiles))
              : dim3((unsigned)m_tiles, (unsigned)n_tiles, (unsigned)E);
  kern<<<grid, P::THREADS, P::SMEM, stream>>>(map_a, map_b, map_out, out,
                                              n_all, K, M, m_tiles, n_tiles,
                                              (int)tiles);
  return (int)cudaGetLastError();
}

// The forward: N = C split into the fewest tiles of at most 256, each
// rounded up to a multiple of 8
int launch_tma_any(const bf16* x, const bf16* w, bf16* out, int E, int C,
                   int D, int F, cudaStream_t stream) {
  const int n_tiles = (C + 255) / 256;
  const int n = ((C + n_tiles - 1) / n_tiles + 7) / 8 * 8;
  switch (n / 8) {
#define HOPPER_GEMM_CASE(K)                                          \
  case K:                                                            \
    return launch_tma<8 * K, 1, 0, false>(w, x, out, E, C, D, F, n_tiles, \
                                          0, stream);
    HOPPER_GEMM_CASE(1) HOPPER_GEMM_CASE(2) HOPPER_GEMM_CASE(3)
    HOPPER_GEMM_CASE(4) HOPPER_GEMM_CASE(5) HOPPER_GEMM_CASE(6)
    HOPPER_GEMM_CASE(7) HOPPER_GEMM_CASE(8) HOPPER_GEMM_CASE(9)
    HOPPER_GEMM_CASE(10) HOPPER_GEMM_CASE(11) HOPPER_GEMM_CASE(12)
    HOPPER_GEMM_CASE(13) HOPPER_GEMM_CASE(14) HOPPER_GEMM_CASE(15)
    HOPPER_GEMM_CASE(16) HOPPER_GEMM_CASE(17) HOPPER_GEMM_CASE(18)
    HOPPER_GEMM_CASE(19) HOPPER_GEMM_CASE(20) HOPPER_GEMM_CASE(21)
    HOPPER_GEMM_CASE(22) HOPPER_GEMM_CASE(23) HOPPER_GEMM_CASE(24)
    HOPPER_GEMM_CASE(25) HOPPER_GEMM_CASE(26) HOPPER_GEMM_CASE(27)
    HOPPER_GEMM_CASE(28) HOPPER_GEMM_CASE(29) HOPPER_GEMM_CASE(30)
    HOPPER_GEMM_CASE(31) HOPPER_GEMM_CASE(32)
#undef HOPPER_GEMM_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// The backward's products on the operands where they lie: (ta, tb) = (0, 0)
// (dX) or (1, 1) (dW); N split into the fewest tiles of at most 256, each
// rounded up to a multiple of 64 (whole boxes; the zero fill pads them)
template <int TA, int TB>
int launch_tma_bwd(const bf16* a, const bf16* b, bf16* out, int E, int n_all,
                   int K, int M, int blocks, cudaStream_t stream) {
  const int n_tiles = (n_all + 255) / 256;
  const int n = ((n_all + n_tiles - 1) / n_tiles + 63) / 64 * 64;
  switch (n / 64) {
    case 1:
      return launch_tma<64, TA, TB, true>(a, b, out, E, n_all, K, M, n_tiles,
                                          blocks, stream);
    case 2:
      return launch_tma<128, TA, TB, true>(a, b, out, E, n_all, K, M,
                                           n_tiles, blocks, stream);
    case 3:
      return launch_tma<192, TA, TB, true>(a, b, out, E, n_all, K, M,
                                           n_tiles, blocks, stream);
    case 4:
      return launch_tma<256, TA, TB, true>(a, b, out, E, n_all, K, M,
                                           n_tiles, blocks, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C interface for ctypes.  Returns the cudaError_t of the launch (0 on
// success) or a negative code of hopper::make_map_bf16; the caller checks
// the shapes (E, C, D, F >= 1, E and the number of C tiles at most 65535;
// bf16 with D and F multiples of 8: 16-byte aligned bases).
extern "C" int expert_gemm_bf16(const void* x, const void* w, void* out,
                                int E, int C, int D, int F, void* stream) {
  const bf16* xt = static_cast<const bf16*>(x);
  const bf16* wt = static_cast<const bf16*>(w);
  bf16* ot = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D % 8 == 0 && F % 8 == 0)
    return launch_tma_any(xt, wt, ot, E, C, D, F, st);
  if (C <= 16) return launch_bf16<1, 4, 1, 2>(xt, wt, ot, E, C, D, F, st);
  return launch_bf16<2, 2, 2, 2>(xt, wt, ot, E, C, D, F, st);
}

// The backward's two products without copies (bf16, 16-byte aligned
// bases, M and the contiguous extents multiples of 8): out (E, n_all, M) =
// A . B with (ta, tb) = (0, 0): a (E, M, K), b (E, n_all, K) (dX = dY . W^T:
// a = w, b = dY), or (1, 1): a (E, K, M), b (E, K, n_all) (dW = X^T . dY:
// a = dY, b = x).  `blocks`: how many persistent blocks walk the tiles (0:
// one block a tile).  Returns as expert_gemm_bf16.
extern "C" int expert_gemm_tma_bf16(const void* a, const void* b, void* out,
                                    int E, int M, int n_all, int K, int ta,
                                    int tb, int blocks, void* stream) {
  const bf16* at = static_cast<const bf16*>(a);
  const bf16* bt = static_cast<const bf16*>(b);
  bf16* ot = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ta == 0 && tb == 0)
    return launch_tma_bwd<0, 0>(at, bt, ot, E, n_all, K, M, blocks, st);
  if (ta == 1 && tb == 1)
    return launch_tma_bwd<1, 1>(at, bt, ot, E, n_all, K, M, blocks, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int expert_gemm_f32(const void* x, const void* w, void* out,
                               int E, int C, int D, int F, void* stream) {
  const dim3 grid((unsigned)((F + F32_BF - 1) / F32_BF),
                  (unsigned)((C + F32_BC - 1) / F32_BC), (unsigned)E);
  expert_gemm_f32_kernel<<<grid, F32_THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(out), C, D, F);
  return (int)cudaGetLastError();
}

extern "C" const char* expert_gemm_error_string(int code) {
  return hopper::error_string(code);
}
