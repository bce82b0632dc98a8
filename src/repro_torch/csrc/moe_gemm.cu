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
//   mbarrier and wgmma helpers.
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
// MMA rows of weights, only N columns (8 for 4).

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
// out^T[e] = w[e]^T . x[e]^T: the weights are wgmma's M side (64 rows of F
// a consumer warpgroup, two a block), the tokens its N side (N = C rounded
// up to a multiple of 8, at most 256, a grid axis beyond); K = D in steps
// of 64.  One producer warpgroup (its first thread issues the loads) keeps
// STAGES steps of (w tile, x tile) in flight.
template <int N>
struct GemmTma {
  static constexpr int BF = 128;            // F rows of a block
  static constexpr int BK = 64;             // D of a step (one 128-byte box)
  static constexpr int W_BYTES = BK * BF * 2;
  static constexpr int X_BYTES = N * BK * 2;
  static constexpr int STAGE = W_BYTES + X_BYTES;
  static constexpr int STAGES = (200 * 1024) / STAGE < 6
                                    ? (200 * 1024) / STAGE : 6;
  static constexpr int EPI_LD = BF + 8;     // bf16 row stride of the epilogue
  static constexpr int THREADS = 384;
  static constexpr size_t SMEM = 1024 + (size_t)STAGES * STAGE
                                 + 2 * STAGES * sizeof(uint64_t);
  static_assert(N % 8 == 0 && N <= 256, "N: a multiple of 8, at most 256");
  static_assert(STAGES >= 3 && STAGES * STAGE >= N * EPI_LD * 2,
                "the epilogue reuses the ring");
};

template <int N>
__global__ void __launch_bounds__(GemmTma<N>::THREADS, 1)
expert_gemm_tma_kernel(const __grid_constant__ CUtensorMap map_x,
                       const __grid_constant__ CUtensorMap map_w,
                       bf16* __restrict__ out, int C, int D, int F) {
  using P = GemmTma<N>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + P::STAGES * P::STAGE);
  uint64_t* empty = full + P::STAGES;

  const int f0 = blockIdx.x * P::BF, n0 = blockIdx.y * N, e = blockIdx.z;
  const int nk = (D + P::BK - 1) / P::BK;

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
      hopper::prefetch_map(&map_x);
      hopper::prefetch_map(&map_w);
      for (int t = 0; t < nk; ++t) {
        const int st = t % P::STAGES;
        hopper::mbar_wait(&empty[st], ((t / P::STAGES) & 1) ^ 1);
        hopper::mbar_expect_tx(&full[st], P::STAGE);
        uint8_t* sw = ring + st * P::STAGE;
        hopper::tma_load_3d(sw, &map_w, &full[st], f0, t * P::BK, e);
        hopper::tma_load_3d(sw + P::W_BYTES / 2, &map_w, &full[st], f0 + 64,
                            t * P::BK, e);
        hopper::tma_load_3d(sw + P::W_BYTES, &map_x, &full[st], t * P::BK,
                            n0, e);
      }
    }
    return;
  }

  // consumer warpgroup c: F rows f0 + 64 c ..; acc holds (64 of F, N of C)
  hopper::regs_inc<232>();
  const int c = threadIdx.x / 128 - 1;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;

  for (int t = 0; t < nk; ++t) {
    const int st = t % P::STAGES;
    hopper::mbar_wait(&full[st], (t / P::STAGES) & 1);
    const uint8_t* sw = ring + st * P::STAGE + c * (P::W_BYTES / 2);
    const uint8_t* sx = ring + st * P::STAGE + P::W_BYTES;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < P::BK / 16; ++kk)
      hopper::WgmmaSS<N, 1, 0>::run(
          acc, hopper::desc_sw128(sw + kk * 16 * 128, P::W_BYTES / 2, 1024),
          hopper::desc_sw128(sx + kk * 32, 16, 1024), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs<N / 2>(acc);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[st]);
  }

  // epilogue: every load has landed and been read, so the ring holds the
  // (N, 128) bf16 tile, rounded once, for row-wise 16-byte stores
  hopper::named_sync(1, 256);
  bf16* epi = reinterpret_cast<bf16*>(ring);
  const int fr = 64 * c + 16 * warp + lane / 4;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int x = 0; x < 2; ++x)
        epi[(8 * j + 2 * (lane % 4) + x) * P::EPI_LD + fr + 8 * h] =
            __float2bfloat16_rn(acc[4 * j + 2 * h + x]);
  hopper::named_sync(1, 256);
  bf16* oe = out + (long long)e * C * F;
  for (int idx = threadIdx.x - 128; idx < N * (P::BF / 8); idx += 256) {
    const int n = idx / (P::BF / 8), f = (idx % (P::BF / 8)) * 8;
    if (n0 + n < C && f0 + f < F)
      *reinterpret_cast<uint4*>(oe + (long long)(n0 + n) * F + f0 + f) =
          *reinterpret_cast<const uint4*>(epi + n * P::EPI_LD + f);
  }
}

template <int N>
int launch_tma(const bf16* x, const bf16* w, bf16* out, int E, int C, int D,
               int F, int n_tiles, cudaStream_t stream) {
  using P = GemmTma<N>;
  CUtensorMap map_x, map_w;
  int rc = hopper::make_map_bf16(&map_x, x, D, C, E, N);
  if (rc == 0) rc = hopper::make_map_bf16(&map_w, w, F, D, E, P::BK);
  if (rc != 0) return rc;
  cudaError_t err = cudaFuncSetAttribute(
      expert_gemm_tma_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)P::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((F + P::BF - 1) / P::BF), (unsigned)n_tiles,
                  (unsigned)E);
  expert_gemm_tma_kernel<N><<<grid, P::THREADS, P::SMEM, stream>>>(
      map_x, map_w, out, C, D, F);
  return (int)cudaGetLastError();
}

// N = C split into the fewest tiles of at most 256, each rounded up to a
// multiple of 8
int launch_tma_any(const bf16* x, const bf16* w, bf16* out, int E, int C,
                   int D, int F, cudaStream_t stream) {
  const int n_tiles = (C + 255) / 256;
  const int n = ((C + n_tiles - 1) / n_tiles + 7) / 8 * 8;
  switch (n / 8) {
#define HOPPER_GEMM_CASE(K) \
  case K:                   \
    return launch_tma<8 * K>(x, w, out, E, C, D, F, n_tiles, stream);
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
