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
// bf16 or float32.  Grid (ceil(F / BF), ceil(C / BC), E): one block per
// (F tile, C tile, expert).  The TPU grid's sequential K axis (accumulating
// in VMEM scratch) is a loop inside the block here, because CUDA blocks run
// in no order: each step stages an x tile and a w tile in shared memory,
// zero past C, D and F (so any C, D and F work), and accumulates.
//
// - bf16: tensor cores through the wmma API (16 x 16 x 16 bf16 products,
//   float accumulators in registers), K step 32, the x and w tiles of the
//   next two steps in flight as 16-byte asynchronous copies (cp.async, a
//   three-stage ring) where D or F is a multiple of 8, element loads
//   otherwise.  Two tiles: 64 x 64 (four warps of 32 x 32)
//   for the prefill's C = 168, and 16 x 128 (four warps of 16 x 32) for
//   C <= 16, the decode step's C = 4, so that a block wastes little of its
//   work on empty capacity rows.  The float tile goes through shared memory
//   to the bf16 output, rounded to nearest even once.
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
// What the design does: each weight element is read once per C tile (once
// in decode, three times at C = 168, where L2 may serve the repeats), with
// 16-byte copies kept in flight across K steps; the products run on the
// tensor cores, so the bf16 kernel waits on memory, not arithmetic.  TMA
// and wgmma are later steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

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

}  // namespace

// Plain C interface for ctypes.  Returns the cudaError_t of the launch (0 on
// success); the caller checks the shapes (E, C, D, F >= 1, E and the number
// of C tiles at most 65535).
extern "C" int expert_gemm_bf16(const void* x, const void* w, void* out,
                                int E, int C, int D, int F, void* stream) {
  const bf16* xt = static_cast<const bf16*>(x);
  const bf16* wt = static_cast<const bf16*>(w);
  bf16* ot = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
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
  return cudaGetErrorString((cudaError_t)code);
}
