// Flash attention, backward pass: dQ, dK and dV of the forward in
// flash_attention.cu, with GQA, causal and sliding-window masks and the
// gemma2 logit soft-cap.
//
// Replaces no TPU kernel: the JAX package trains by differentiating its jnp
// attention (repro/models/attention.py:98 attention_forward_kv -> _sdpa) and
// its models never call the Pallas forward (models/attention.py:5).  The
// port's forward does run its kernel, so the gradient must be a kernel too.
// It computes what torch autograd computes through
// repro_torch/kernels/flash/ref.py::reference_attention, in the steps of
// ref.py::attention_bwd (its plain model):
//
//   s    = (q . k) * sm_scale;  s = cap * tanh(s / cap) if cap > 0
//   P    = visible ? exp(s - lse) : 0     lse = the row's log-sum-exp
//   D    = rowsum(dO o O)
//   dP   = dO . v^T
//   dS   = P o (dP - D) [o (1 - (s / cap)^2) with the soft-cap]
//   dQ   = sm_scale * dS . k     dK = sm_scale * dS^T . q     dV = P^T . dO
//
// Masks by row index from 0 for q and k, as the forward (Sq != Skv allowed);
// a q row that sees no key has P = 0, so its dQ is 0 and it adds nothing to
// dK and dV (the plain version's torch.where gives the same).  Layout, all
// contiguous: q, o, dO, dQ (BHq, Sq, hd); k, v, dK, dV (BHkv, Skv, hd); q row
// block bh reads kv row block bh / group (the kv-major GQA fold of ops.py).
// Every output element is owned by one block (no float atomics), and every
// sum is taken in a fixed order, so two runs on the same inputs give the
// same bits.  The designs, chosen by the shape alone before the launch
// (kernels/flash/kernel.py::tc_backward):
//
// - bf16 with hd 64 or 128 (the training shape, gemma2's and qwen's heads):
//   the tensor cores, flash_attention_bwd_bf16_tc.  Every product is a
//   wgmma of bf16 operands with float32 accumulators; P and dS are rounded
//   to bf16 in registers before the products that take them
//   (ref.attention_bwd(bf16_products=True) is the plain model).  The
//   forward writes each row's log-sum-exp in log2 units (its LSE instance,
//   launched by the autograd function), so no pass recomputes q . k^T for
//   the row statistics.  Three launches:
//   1. bwd_delta_tc: D = rowsum(dO o O), a warp a row (bytes only).
//   2. bwd_dkdv_tc, a block a (64-row kv tile, kv head), 1-D grid with the
//      first kv tiles first (the longest under the causal mask): k and v
//      resident; the (q head, q tile) pairs that see the tile dealt to two
//      consumer warpgroups in turns, each fed (q, dO, lse, D) through a TMA
//      ring of its own by a producer warp (setmaxnreg 24 / 240).  A pair
//      is S^T = k q^T and dP^T = v dO^T (both K-major from shared memory),
//      P^T and dS^T in registers, then dV += P^T dO and dK += dS^T q with
//      P^T and dS^T as the register A operand and dO, q read MN-major.  The
//      consumers' two partial dK and dV meet in shared memory at the end
//      (two terms: the same bits in either order).  Splitting a kv head's
//      pairs over two warpgroups of one block, rather than giving each a kv
//      tile of its own, doubles the blocks at the training shape (B 4, Hkv
//      4, S 512: 128 blocks for 132 SMs, against 64).
//   3. bwd_dq_tc, a block a (128-row q tile, q head), the last q tiles
//      first: two consumer warpgroups of 64 rows with q and dO resident, a
//      ring of (k, v) tiles as the forward's (setmaxnreg 40 / 232); S = q
//      k^T and dP = dO v^T, then dQ += dS k with k read MN-major.
//   TMA needs the lse and D rows 16-byte aligned, so both are (BHq, Sq
//   rounded up to 64) float32; the rows past Sq are never read as values.
// - bf16 with hd 256 (recurrentgemma's local attention): the tensor cores
//   too, flash_attention_bwd_bf16_tc256, the same D pass and LSE, P and
//   dS rounded as above.  A (64, 256) float32 accumulator is 128
//   registers a thread.
//   2. bwd_dkdv_tc256, a block a (64-row kv tile, kv head, split of the
//      group's q heads).  dK and dV together would be 256 registers, so
//      the two consumer warpgroups share every (q tile, kv tile) pair and
//      each owns one half of hd of dK and dV: consumer c computes S^T and
//      dP^T for the pair's 32 q columns 32 c .. (m64n32 over all of hd),
//      P^T and dS^T there, and hands them over, rounded to bf16, through
//      a shared 64 x 64 tile laid out as a K-major operand; then each adds
//      the products over all 64 columns to its half (m64n128, A from
//      shared memory), so no product runs twice.  Two stages of 64 KB (q
//      and dO) beside k and v resident (64 KB) and 32 KB of exchange
//      tiles fill 226 KB of shared memory.  The training shape has 2 x 40
//      kv tiles for 132 SMs, so a kv head's 16 q heads are split over
//      blocks (kernel.py::dkdv_splits: the fewest splits that give two
//      blocks an SM), each writing float32 partial sums, and
//      bwd_dkdv_sum256 adds them in split order (no atomics).
//   3. bwd_dq_tc256, a block a (128-row q tile, q head), the last first:
//      each consumer's 64 rows' dQ in its own accumulator (128 registers,
//      with S and dP of a whole kv tile, 64 more), q and dO resident (128
//      KB), k and v streamed through three 32 KB slots in load order (k_t,
//      v_t, k_{t+1}, ...), a slot freed as soon as its tile is read.
// - float32, and bf16 at other head dims (8 and 32 among the checked
//   shapes): the float32 cores, flash_attention_bwd_{bf16,f32}, three
//   kernels:
//   1. bwd_prep_kernel, one block per (q tile, bh): the row max m and 1 / l
//      (the log-sum-exp without its log), by walking the visible kv tiles
//      with an online max and sum, and D (the float32 forward writes no
//      row statistics);
//   2. bwd_dkdv_kernel, one block per (kv tile, kv head): K and V of its
//      tile in shared memory, dK and dV in registers; it walks the group's
//      q heads and the q tiles that can see its tile, recomputing P and dS;
//   3. bwd_dq_kernel, one block per (q tile, bh): q, dO, m, 1 / l and D of
//      its tile in shared memory, dQ in registers; it walks the visible kv
//      tiles.
//   Tiles are float32 in shared memory (rows padded by one float against
//   bank conflicts): 64 rows a tile up to hd 128, 32 at hd 256; each thread
//   holds an (R/16 x R/16) slice of a score tile and an (R/8 x HDMAX/32)
//   slice of an accumulator; every product is an explicit fused
//   multiply-add (__fmaf_rn), which --fmad=false leaves alone; exp and tanh
//   are the accurate ones.
//
// Bound on an H100 SXM at the training shape (B = 4, Hq = 32, Hkv = 4,
// S = 512, hd = 128, causal, bf16): the 8 input and output arrays (q, k,
// v, o, dO, dQ, dK, dV) are 75.5 MB, 0.0225 ms at 3.35 TB/s; the five
// products of the backward over the visible (q, k) pairs are 21.5 GFLOP,
// 0.0218 ms at the bf16 tensor-core peak (989 TFLOP/s): bytes bound it,
// narrowly.  The tensor-core design does seven products where the bound
// counts five (S and dP in both kernels), over whole 64 x 64 tiles (the
// diagonal's masked halves included), and reads q, dO, k and v from L2
// once per tile pair rather than once; the float32-core design runs at 67
// TFLOP/s at best.  At recurrentgemma's training shape (B = 2, Hq = 16,
// Hkv = 1, S = 2560, hd = 256, causal, window 2048) the visible pairs'
// five products are 258 GFLOP, 0.261 ms at the bf16 peak, against 0.053
// ms of bytes: operations bound it, and the float32-core kernels' eight
// products at 67 TFLOP/s take at least 6.2 ms; the hd 256 design does
// seven products on the tensor cores, its dK/dV blocks reading 64 KB of q
// and dO from L2 a pair.  Measured on an NVIDIA H100 80GB HBM3, 700.00 W,
// by kernel_probe.py --parent DIR --steps scan256: 0.953 ms in turns with
// the float32-core kernels' 35 ms (3.6x the bound; SDPA's backward with
// the window as a mask takes 2.9), dK/dV 0.47 and dQ 0.42 of it (each
// kernel cut in turn); dK/dV's S^T and dP^T at N = 32, both operands read
// from shared memory, are the suspect, not yet measured apart.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int HDMAX>
struct Tiles {
  static constexpr int BR = HDMAX == 256 ? 32 : 64;  // rows of a q or kv tile
  static constexpr int LD = HDMAX + 1;   // row stride of an hd-wide tile
  static constexpr int LS = BR + 1;      // row stride of a score tile
  static constexpr int MI = BR / 16;     // score rows a thread: sr * MI + i
  static constexpr int MJ = BR / 16;     // score columns a thread: sc + 16 j
  static constexpr int RPT = BR / 8;     // acc rows a thread: rg * RPT + i
  static constexpr int NC = HDMAX / 32;  // acc columns a thread: cg + 32 j
  static constexpr int TPR = THREADS / BR;  // lanes a row in row reductions
  static constexpr int CPT = BR / TPR;      // score columns a lane there
  // k, v, q, dO tiles; P and dS tiles; m, 1 / l and D of the q tile
  static constexpr size_t SMEM =
      sizeof(float) * (4 * BR * LD + 2 * BR * LS + 3 * BR);
};

__device__ __forceinline__ bool visible(int q_pos, int k_pos, int sq, int skv,
                                        int causal, int window) {
  bool ok = q_pos < sq && k_pos < skv;
  if (causal) ok = ok && k_pos <= q_pos;
  if (window > 0) ok = ok && k_pos > q_pos - window;
  return ok;
}

// rows [0, rows) of an (rows, hd) array into a float32 (BR, LD) tile, zeros
// past them and past hd
template <typename T, int HDMAX>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int rows,
                                          int hd) {
  using P = Tiles<HDMAX>;
  for (int e = threadIdx.x; e < P::BR * HDMAX; e += THREADS) {
    const int r = e / HDMAX, c = e % HDMAX;
    dst[r * P::LD + c] =
        (r < rows && c < hd) ? to_f(src[(long long)r * hd + c]) : 0.0f;
  }
}

// acc[i][j] = a row (sr MI + i) . b row (sc + 16 j) over hd
template <int HDMAX>
__device__ __forceinline__ void tile_dot(
    float (&acc)[Tiles<HDMAX>::MI][Tiles<HDMAX>::MJ], const float* a,
    const float* b, int hd) {
  using P = Tiles<HDMAX>;
  const int sr = threadIdx.x >> 4, sc = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < P::MI; ++i)
#pragma unroll
    for (int j = 0; j < P::MJ; ++j) acc[i][j] = 0.0f;
  for (int d = 0; d < hd; ++d) {
    float x[P::MI], y[P::MJ];
#pragma unroll
    for (int i = 0; i < P::MI; ++i) x[i] = a[(sr * P::MI + i) * P::LD + d];
#pragma unroll
    for (int j = 0; j < P::MJ; ++j) y[j] = b[(sc + 16 * j) * P::LD + d];
#pragma unroll
    for (int i = 0; i < P::MI; ++i)
#pragma unroll
      for (int j = 0; j < P::MJ; ++j)
        acc[i][j] = __fmaf_rn(x[i], y[j], acc[i][j]);
  }
}

template <bool CAP>
__device__ __forceinline__ float score(float dot, float sm_scale,
                                       float softcap) {
  const float x = dot * sm_scale;
  return CAP ? softcap * tanhf(x / softcap) : x;
}

// P and dS of a thread's score slice, from its q . k and dO . v slices, into
// the (BR, LS) tiles s_p (when not null) and s_ds; rows are q rows from q0,
// columns kv rows from k0
template <int HDMAX, bool CAP>
__device__ __forceinline__ void p_and_ds(
    const float (&sacc)[Tiles<HDMAX>::MI][Tiles<HDMAX>::MJ],
    const float (&dpacc)[Tiles<HDMAX>::MI][Tiles<HDMAX>::MJ], float* s_p,
    float* s_ds, const float* s_m, const float* s_rl, const float* s_dl,
    int q0, int k0,
    int sq, int skv, int causal, int window, float sm_scale, float softcap) {
  using P = Tiles<HDMAX>;
  const int sr = threadIdx.x >> 4, sc = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < P::MI; ++i) {
#pragma unroll
    for (int j = 0; j < P::MJ; ++j) {
      const int r = sr * P::MI + i, c = sc + 16 * j;
      float p = 0.0f, ds = 0.0f;
      if (visible(q0 + r, k0 + c, sq, skv, causal, window)) {
        const float s = score<CAP>(sacc[i][j], sm_scale, softcap);
        p = expf(s - s_m[r]) * s_rl[r];
        ds = p * (dpacc[i][j] - s_dl[r]);
        if (CAP) {
          const float u = s / softcap;
          ds = ds * (1.0f - u * u);
        }
      }
      if (s_p != nullptr) s_p[r * P::LS + c] = p;
      s_ds[r * P::LS + c] = ds;
    }
  }
}

template <typename T, int HDMAX, bool CAP>
__global__ void __launch_bounds__(THREADS, 1)
bwd_prep_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ o, const T* __restrict__ dout,
                float* __restrict__ row_m, float* __restrict__ row_rl,
                float* __restrict__ delta, int group,
                int sq, int skv, int hd, int causal, int window,
                float sm_scale, float softcap) {
  using P = Tiles<HDMAX>;
  extern __shared__ float smem[];
  float* s_q = smem;
  float* s_k = s_q + P::BR * P::LD;
  float* s_s = s_k + P::BR * P::LD;  // (BR, LS): scores

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * P::BR;
  const int rows = min(P::BR, sq - q0);
  const T* kb = k + (long long)(bh / group) * skv * hd;
  load_tile<T, HDMAX>(s_q, q + ((long long)bh * sq + q0) * hd, rows, hd);

  // this lane's row of the reductions, and its columns rs CPT ..
  const int rr = tid / P::TPR, rs = tid % P::TPR;
  const int sr = tid >> 4, sc = tid & 15;
  float m = NEG_INF, l = 0.0f;

  int k_lo = 0, k_hi = skv;
  if (causal) k_hi = min(skv, q0 + rows);
  if (window > 0) k_lo = max(0, q0 - window + 1);
  for (int t = k_lo / P::BR; t < (k_hi + P::BR - 1) / P::BR; ++t) {
    const int k0 = t * P::BR;
    __syncthreads();  // the last tile's reads of s_k and s_s are done
    load_tile<T, HDMAX>(s_k, kb + (long long)k0 * hd, min(P::BR, skv - k0),
                        hd);
    __syncthreads();
    float acc[P::MI][P::MJ];
    tile_dot<HDMAX>(acc, s_q, s_k, hd);
    // the raw products go to shared memory; each lane of the reductions
    // scores and masks its own columns there (no soft-cap code inside the
    // unrolled loop over the register tile)
#pragma unroll
    for (int i = 0; i < P::MI; ++i)
#pragma unroll
      for (int j = 0; j < P::MJ; ++j)
        s_s[(sr * P::MI + i) * P::LS + sc + 16 * j] = acc[i][j];
    __syncthreads();
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < P::CPT; ++j) {
      const int c = rs * P::CPT + j;
      float& x = s_s[rr * P::LS + c];
      x = visible(q0 + rr, k0 + c, sq, skv, causal, window)
              ? score<CAP>(x, sm_scale, softcap)
              : NEG_INF;
      mx = fmaxf(mx, x);
    }
#pragma unroll
    for (int off = 1; off < P::TPR; off <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m, mx);
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < P::CPT; ++j) {
      const int c = rs * P::CPT + j;
      if (visible(q0 + rr, k0 + c, sq, skv, causal, window))
        sum += expf(s_s[rr * P::LS + c] - m_new);
    }
#pragma unroll
    for (int off = 1; off < P::TPR; off <<= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    l = l * expf(m - m_new) + sum;  // exp(0) = 1 while both are -1e30
    m = m_new;
  }

  // D = rowsum(dO o O), TPR lanes a row
  float d_acc = 0.0f;
  if (rr < rows) {
    const long long base = ((long long)bh * sq + q0 + rr) * hd;
    for (int c = rs; c < hd; c += P::TPR)
      d_acc = __fmaf_rn(to_f(dout[base + c]), to_f(o[base + c]), d_acc);
  }
#pragma unroll
  for (int off = 1; off < P::TPR; off <<= 1)
    d_acc += __shfl_xor_sync(0xffffffffu, d_acc, off);
  if (rs == 0 && rr < rows) {
    const long long at = (long long)bh * sq + q0 + rr;
    // a row that sees no key has l = 0; its m and 1 / l are never read
    row_m[at] = m;
    row_rl[at] = l > 0.0f ? 1.0f / l : 0.0f;
    delta[at] = d_acc;
  }
}

template <typename T, int HDMAX, bool CAP>
__global__ void __launch_bounds__(THREADS, 1)
bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ row_m,
                const float* __restrict__ row_rl,
                const float* __restrict__ delta, T* __restrict__ dk,
                T* __restrict__ dv, int group, int sq, int skv, int hd,
                int causal, int window, float sm_scale, float softcap) {
  using P = Tiles<HDMAX>;
  extern __shared__ float smem[];
  float* s_k = smem;
  float* s_v = s_k + P::BR * P::LD;
  float* s_q = s_v + P::BR * P::LD;
  float* s_do = s_q + P::BR * P::LD;
  float* s_p = s_do + P::BR * P::LD;
  float* s_ds = s_p + P::BR * P::LS;
  float* s_m = s_ds + P::BR * P::LS;
  float* s_rl = s_m + P::BR;
  float* s_dl = s_rl + P::BR;

  const int tid = threadIdx.x;
  const int kvh = blockIdx.y;
  const int k0 = blockIdx.x * P::BR;
  const int cols = min(P::BR, skv - k0);  // live kv rows of this tile
  const long long kv_base = ((long long)kvh * skv + k0) * hd;
  load_tile<T, HDMAX>(s_k, k + kv_base, cols, hd);
  load_tile<T, HDMAX>(s_v, v + kv_base, cols, hd);

  const int rg = tid >> 5, cg = tid & 31;
  float acc_dk[P::RPT][P::NC], acc_dv[P::RPT][P::NC];
#pragma unroll
  for (int i = 0; i < P::RPT; ++i)
#pragma unroll
    for (int j = 0; j < P::NC; ++j) acc_dk[i][j] = acc_dv[i][j] = 0.0f;

  // the q rows that can see some row of this kv tile
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(sq, k0 + cols - 1 + window) : sq;
  for (int g = 0; g < group; ++g) {
    const int bh = kvh * group + g;
    for (int t = q_lo / P::BR; t < (q_hi + P::BR - 1) / P::BR; ++t) {
      const int q0 = t * P::BR;
      const int rows = min(P::BR, sq - q0);
      const long long q_base = ((long long)bh * sq + q0) * hd;
      __syncthreads();  // the last tile's reads of s_q, s_do, s_p, s_ds done
      load_tile<T, HDMAX>(s_q, q + q_base, rows, hd);
      load_tile<T, HDMAX>(s_do, dout + q_base, rows, hd);
      if (tid < P::BR) {
        const long long at = (long long)bh * sq + q0 + tid;
        s_m[tid] = tid < rows ? row_m[at] : 0.0f;
        s_rl[tid] = tid < rows ? row_rl[at] : 0.0f;
        s_dl[tid] = tid < rows ? delta[at] : 0.0f;
      }
      __syncthreads();
      float sacc[P::MI][P::MJ], dpacc[P::MI][P::MJ];
      tile_dot<HDMAX>(sacc, s_q, s_k, hd);
      tile_dot<HDMAX>(dpacc, s_do, s_v, hd);
      p_and_ds<HDMAX, CAP>(sacc, dpacc, s_p, s_ds, s_m, s_rl, s_dl, q0, k0,
                           sq, skv, causal, window, sm_scale, softcap);
      __syncthreads();
      // dV[kv] += sum_q P[q][kv] dO[q];  dK[kv] += sum_q dS[q][kv] q[q]
      for (int qq = 0; qq < rows; ++qq) {
        float dov[P::NC], qv[P::NC];
#pragma unroll
        for (int j = 0; j < P::NC; ++j) {
          dov[j] = s_do[qq * P::LD + cg + 32 * j];
          qv[j] = s_q[qq * P::LD + cg + 32 * j];
        }
#pragma unroll
        for (int i = 0; i < P::RPT; ++i) {
          const float p = s_p[qq * P::LS + rg * P::RPT + i];
          const float ds = s_ds[qq * P::LS + rg * P::RPT + i];
#pragma unroll
          for (int j = 0; j < P::NC; ++j) {
            acc_dv[i][j] = __fmaf_rn(p, dov[j], acc_dv[i][j]);
            acc_dk[i][j] = __fmaf_rn(ds, qv[j], acc_dk[i][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < P::RPT; ++i) {
    const int r = rg * P::RPT + i;
    if (r >= cols) continue;
#pragma unroll
    for (int j = 0; j < P::NC; ++j) {
      const int c = cg + 32 * j;
      if (c < hd) {
        put(dk + kv_base + (long long)r * hd + c, acc_dk[i][j] * sm_scale);
        put(dv + kv_base + (long long)r * hd + c, acc_dv[i][j]);
      }
    }
  }
}

template <typename T, int HDMAX, bool CAP>
__global__ void __launch_bounds__(THREADS, 1)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ row_m,
              const float* __restrict__ row_rl,
              const float* __restrict__ delta, T* __restrict__ dq, int group,
              int sq, int skv, int hd,
              int causal, int window, float sm_scale, float softcap) {
  using P = Tiles<HDMAX>;
  extern __shared__ float smem[];
  float* s_k = smem;
  float* s_v = s_k + P::BR * P::LD;
  float* s_q = s_v + P::BR * P::LD;
  float* s_do = s_q + P::BR * P::LD;
  float* s_ds = s_do + P::BR * P::LD + P::BR * P::LS;
  float* s_m = s_ds + P::BR * P::LS;
  float* s_rl = s_m + P::BR;
  float* s_dl = s_rl + P::BR;

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * P::BR;
  const int rows = min(P::BR, sq - q0);
  const long long q_base = ((long long)bh * sq + q0) * hd;
  const T* kb = k + (long long)(bh / group) * skv * hd;
  const T* vb = v + (long long)(bh / group) * skv * hd;
  load_tile<T, HDMAX>(s_q, q + q_base, rows, hd);
  load_tile<T, HDMAX>(s_do, dout + q_base, rows, hd);
  if (tid < P::BR) {
    const long long at = (long long)bh * sq + q0 + tid;
    s_m[tid] = tid < rows ? row_m[at] : 0.0f;
    s_rl[tid] = tid < rows ? row_rl[at] : 0.0f;
    s_dl[tid] = tid < rows ? delta[at] : 0.0f;
  }

  const int rg = tid >> 5, cg = tid & 31;
  float acc[P::RPT][P::NC];
#pragma unroll
  for (int i = 0; i < P::RPT; ++i)
#pragma unroll
    for (int j = 0; j < P::NC; ++j) acc[i][j] = 0.0f;

  int k_lo = 0, k_hi = skv;
  if (causal) k_hi = min(skv, q0 + rows);
  if (window > 0) k_lo = max(0, q0 - window + 1);
  for (int t = k_lo / P::BR; t < (k_hi + P::BR - 1) / P::BR; ++t) {
    const int k0 = t * P::BR;
    const int cols = min(P::BR, skv - k0);
    __syncthreads();  // the last tile's reads of s_k, s_v and s_ds are done
    load_tile<T, HDMAX>(s_k, kb + (long long)k0 * hd, cols, hd);
    load_tile<T, HDMAX>(s_v, vb + (long long)k0 * hd, cols, hd);
    __syncthreads();
    float sacc[P::MI][P::MJ], dpacc[P::MI][P::MJ];
    tile_dot<HDMAX>(sacc, s_q, s_k, hd);
    tile_dot<HDMAX>(dpacc, s_do, s_v, hd);
    p_and_ds<HDMAX, CAP>(sacc, dpacc, nullptr, s_ds, s_m, s_rl, s_dl, q0,
                         k0, sq, skv, causal, window, sm_scale, softcap);
    __syncthreads();
    // dQ[q] += sum_kv dS[q][kv] k[kv]
    for (int kk = 0; kk < cols; ++kk) {
      float kv[P::NC];
#pragma unroll
      for (int j = 0; j < P::NC; ++j) kv[j] = s_k[kk * P::LD + cg + 32 * j];
#pragma unroll
      for (int i = 0; i < P::RPT; ++i) {
        const float ds = s_ds[(rg * P::RPT + i) * P::LS + kk];
#pragma unroll
        for (int j = 0; j < P::NC; ++j)
          acc[i][j] = __fmaf_rn(ds, kv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < P::RPT; ++i) {
    const int r = rg * P::RPT + i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < P::NC; ++j) {
      const int c = cg + 32 * j;
      if (c < hd) put(dq + q_base + (long long)r * hd + c, acc[i][j] * sm_scale);
    }
  }
}

template <typename T, int HDMAX, bool CAP>
int launch_cap(const T* q, const T* k, const T* v, const T* o, const T* dout,
               T* dq, T* dk, T* dv, float* stats, float* delta, int bhq,
               int bhkv, int sq, int skv, int hd, int causal, int window,
               float sm_scale, float softcap, cudaStream_t stream) {
  using P = Tiles<HDMAX>;
  constexpr int smem = (int)P::SMEM;
  auto prep = bwd_prep_kernel<T, HDMAX, CAP>;
  auto dkdv = bwd_dkdv_kernel<T, HDMAX, CAP>;
  auto dqk = bwd_dq_kernel<T, HDMAX, CAP>;
  cudaError_t err = cudaFuncSetAttribute(
      prep, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int group = bhq / bhkv;
  float* row_m = stats;
  float* row_rl = stats + (long long)bhq * sq;
  const dim3 grid_q((unsigned)((sq + P::BR - 1) / P::BR), (unsigned)bhq);
  const dim3 grid_kv((unsigned)((skv + P::BR - 1) / P::BR), (unsigned)bhkv);
  prep<<<grid_q, THREADS, smem, stream>>>(q, k, o, dout, row_m, row_rl,
                                          delta, group, sq, skv, hd, causal,
                                          window, sm_scale, softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dkdv<<<grid_kv, THREADS, smem, stream>>>(q, k, v, dout, row_m, row_rl,
                                           delta, dk, dv, group, sq, skv, hd,
                                           causal, window, sm_scale, softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dqk<<<grid_q, THREADS, smem, stream>>>(q, k, v, dout, row_m, row_rl,
                                         delta, dq, group, sq, skv, hd, causal,
                                         window, sm_scale, softcap);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, void* dq, void* dk, void* dv, void* stats,
           void* delta, int bhq, int bhkv, int sq, int skv, int hd,
           int causal, int window, float sm_scale, float softcap,
           void* stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* ot = static_cast<const T*>(o);
  const T* dot = static_cast<const T*>(dout);
  T* dqt = static_cast<T*>(dq);
  T* dkt = static_cast<T*>(dk);
  T* dvt = static_cast<T*>(dv);
  float* l = static_cast<float*>(stats);
  float* d = static_cast<float*>(delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FLASH_BWD_LAUNCH(HD, CAP)                                            \
  return launch_cap<T, HD, CAP>(qt, kt, vt, ot, dot, dqt, dkt, dvt, l, d,   \
                                bhq, bhkv, sq, skv, hd, causal, window,     \
                                sm_scale, softcap, st)
  const bool cap = softcap > 0.0f;
  if (hd <= 64) {
    if (cap) FLASH_BWD_LAUNCH(64, true);
    FLASH_BWD_LAUNCH(64, false);
  }
  if (hd <= 128) {
    if (cap) FLASH_BWD_LAUNCH(128, true);
    FLASH_BWD_LAUNCH(128, false);
  }
  if (cap) FLASH_BWD_LAUNCH(256, true);
  FLASH_BWD_LAUNCH(256, false);
#undef FLASH_BWD_LAUNCH
}

// ------------------------------------- bf16, hd 64 or 128: the tensor cores
// (see the header).  Tiles are 64 rows; every operand tile arrives by TMA
// as boxes of 64 columns (128-byte swizzle, zero fill past Sq, Skv), and
// one tile serves as a K-major operand (S, dP: the reduction runs along
// hd) and as an MN-major one (dV, dK, dQ: along its rows).
using bf16 = __nv_bfloat16;
constexpr float LOG2E = 1.4426950408889634f;

template <int HD>
struct Tc {
  static constexpr int BOXES = HD / 64;      // 64-column boxes of a row
  static constexpr int TILE = 64 * HD * 2;   // a 64-row bf16 tile
  static constexpr int THREADS = 384;
  // dK/dV: k and v resident; a ring a consumer of (q, dO) tiles and their
  // rows' lse and D
  static constexpr int KV_STAGES = HD == 128 ? 2 : 3;
  static constexpr size_t KV_SMEM =
      1024 + 2 * TILE + 2 * KV_STAGES * 2 * TILE
      + 2 * KV_STAGES * 2 * 64 * sizeof(float)
      + (1 + 4 * KV_STAGES) * sizeof(uint64_t);
  // dQ: each consumer's q and dO resident; a ring of (k, v) tiles
  static constexpr int Q_STAGES = HD == 128 ? 3 : 4;
  static constexpr size_t Q_SMEM = 1024 + 4 * TILE + Q_STAGES * 2 * TILE
                                   + (1 + 2 * Q_STAGES) * sizeof(uint64_t);
  // the dK/dV exchange of partial sums fits in a consumer's ring
  static_assert(KV_STAGES * 2 * TILE >= 64 * HD * (int)sizeof(float), "");
};

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// P and dS of one score in place: s (the raw q . k) becomes P = exp2(s2 -
// lse2), s2 the score in log2 units as the forward computes it; dp (dO .
// v) becomes dS = P (dP - D) [(1 - t^2) under the soft-cap, t = tanh(s
// sm_scale / cap)]; both 0 where the pair is not visible (a pad's lse or D
// may be anything)
template <bool CAP>
__device__ __forceinline__ void p_and_ds_tc(float& s, float& dp, float lse2,
                                            float dl, bool ok, float sm_scale,
                                            float scale2, float softcap) {
  float s2, fac = 1.0f;
  if (CAP) {
    const float t = tanhf(s * sm_scale / softcap);
    s2 = softcap * t * LOG2E;
    fac = 1.0f - t * t;
  } else {
    s2 = s * scale2;
  }
  const float p = exp2f(s2 - lse2);
  float ds = p * (dp - dl);
  if (CAP) ds = ds * fac;
  s = ok ? p : 0.0f;
  dp = ok ? ds : 0.0f;
}

// a warpgroup's (64, HD) float32 accumulator, times `scale`, rounded to bf16
// into rows r0 and r0 + 8 (those below `rows`) of the (rows, HD) array at
// `out`
template <int HD>
__device__ __forceinline__ void store_acc(bf16* out, const float* acc,
                                          float scale, int r0, int rows,
                                          int cq) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + (long long)r * HD + 8 * j
                                         + cq) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h] * scale,
                                acc[4 * j + 2 * h + 1] * scale);
  }
}

// D = rowsum(dO o O) into delta[bh * sq_pad + q], a warp a row
__global__ void __launch_bounds__(256)
bwd_delta_tc(const bf16* __restrict__ o, const bf16* __restrict__ dout,
             float* __restrict__ delta, int rows, int sq, int sq_pad,
             int hd) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const long long base = (long long)row * hd;
  float acc = 0.0f;
  for (int c = 2 * lane; c < hd; c += 64) {
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(dout + base + c));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(o + base + c));
    acc = __fmaf_rn(a.x, b.x, acc);
    acc = __fmaf_rn(a.y, b.y, acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[(long long)(row / sq) * sq_pad + row % sq] = acc;
}

// dK and dV: a block a (64-row kv tile, kv head), the kv tiles in order
// (under the causal mask the first sees the most q rows, so the longest
// blocks start first).  Its q work is the (q head of the group, 64-row q
// tile) pairs that can see the kv tile, dealt alternately to two consumer
// warpgroups, each with a ring of its own that a producer warp fills (warp
// 0 also loads k and v once).  Each consumer sums its pairs' products into
// its own (64, HD) dK and dV; at the end they trade halves through shared
// memory and each writes one of the two sums.
template <int HD, bool CAP>
__global__ void __launch_bounds__(384, 1)
bwd_dkdv_tc(const __grid_constant__ CUtensorMap map_q,
            const __grid_constant__ CUtensorMap map_k,
            const __grid_constant__ CUtensorMap map_v,
            const __grid_constant__ CUtensorMap map_do,
            const float* __restrict__ lse, const float* __restrict__ delta,
            bf16* __restrict__ dk, bf16* __restrict__ dv, int group, int bhkv,
            int sq, int skv, int sq_pad, int causal, int window,
            float sm_scale, float softcap) {
  using P = Tc<HD>;
  constexpr int S = P::KV_STAGES;
  constexpr int RING = S * 2 * P::TILE;  // a consumer's ring, in bytes
  extern __shared__ uint8_t smem_raw[];
  uint8_t* s_k = align1024(smem_raw);
  uint8_t* s_v = s_k + P::TILE;
  uint8_t* rings = s_v + P::TILE;
  float* stats = reinterpret_cast<float*>(rings + 2 * RING);  // [c][st][2][64]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(stats + 2 * S * 128);
  uint64_t* full = kv_full + 1;    // [c][st]
  uint64_t* empty = full + 2 * S;  // [c][st]

  const int kvh = blockIdx.x % bhkv;
  const int k0 = (blockIdx.x / bhkv) * 64;
  const int k_last = min(k0 + 64, skv) - 1;
  // the q rows that can see some row of this kv tile, in 64-row tiles
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(sq, k_last + window) : sq;
  const int t_lo = q_lo / 64;
  const int n_t = q_lo < q_hi ? (q_hi + 63) / 64 - t_lo : 0;
  const int items = group * n_t;  // item i: q head i / n_t, tile i % n_t

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int i = 0; i < 2 * S; ++i) {
      hopper::mbar_init(&full[i], 1);
      hopper::mbar_init(&empty[i], 4);  // a consumer warp each
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup: warp w fills ring w
    hopper::regs_dec<24>();
    const int w = threadIdx.x / 32;
    if (w < 2 && threadIdx.x % 32 == 0) {
      if (w == 0) {
        hopper::prefetch_map(&map_q);
        hopper::prefetch_map(&map_k);
        hopper::prefetch_map(&map_v);
        hopper::prefetch_map(&map_do);
        hopper::mbar_expect_tx(kv_full, 2 * P::TILE);
        for (int b = 0; b < P::BOXES; ++b) {
          hopper::tma_load_3d(s_k + b * 64 * 128, &map_k, kv_full, 64 * b,
                              k0, kvh);
          hopper::tma_load_3d(s_v + b * 64 * 128, &map_v, kv_full, 64 * b,
                              k0, kvh);
        }
      }
      for (int i = w, j = 0; i < items; i += 2, ++j) {
        const int st = w * S + j % S;
        hopper::mbar_wait(&empty[st], ((j / S) & 1) ^ 1);
        const int g = i / n_t;
        const int q0 = (t_lo + i - g * n_t) * 64;
        const int bh = kvh * group + g;
        hopper::mbar_expect_tx(&full[st], 2 * P::TILE + 512);
        uint8_t* dst = rings + st * 2 * P::TILE;
        for (int b = 0; b < P::BOXES; ++b) {
          hopper::tma_load_3d(dst + b * 64 * 128, &map_q, &full[st], 64 * b,
                              q0, bh);
          hopper::tma_load_3d(dst + P::TILE + b * 64 * 128, &map_do,
                              &full[st], 64 * b, q0, bh);
        }
        const long long at = (long long)bh * sq_pad + q0;
        hopper::bulk_load(stats + st * 128, lse + at, 256, &full[st]);
        hopper::bulk_load(stats + st * 128 + 64, delta + at, 256, &full[st]);
      }
    }
    return;
  }

  // consumer c: its kv rows kr and kr + 8, its q columns 8 j + cq + {0, 1}
  hopper::regs_inc<240>();
  const int c = threadIdx.x / 128 - 1;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int kr = k0 + warp * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  const float scale2 = sm_scale * LOG2E;

  float dk_acc[HD / 2], dv_acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dk_acc[i] = dv_acc[i] = 0.0f;

  hopper::mbar_wait(kv_full, 0);
  for (int i = c, j = 0; i < items; i += 2, ++j) {
    const int st = c * S + j % S;
    const int g = i / n_t;
    const int q0 = (t_lo + i - g * n_t) * 64;
    hopper::mbar_wait(&full[st], (j / S) & 1);
    const uint8_t* s_q = rings + st * 2 * P::TILE;
    const uint8_t* s_do = s_q + P::TILE;
    const float* s_lse = stats + st * 128;
    const float* s_dl = s_lse + 64;

    // S^T = k . q^T and dP^T = v . dO^T, (64 kv rows, 64 q columns)
    float s[32], dp[32];
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int off = (kk / 4) * 64 * 128 + (kk % 4) * 32;
      hopper::WgmmaSS<64, 0, 0>::run(
          s, hopper::desc_sw128(s_k + off, 16, 1024),
          hopper::desc_sw128(s_q + off, 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int off = (kk / 4) * 64 * 128 + (kk % 4) * 32;
      hopper::WgmmaSS<64, 0, 0>::run(
          dp, hopper::desc_sw128(s_v + off, 16, 1024),
          hopper::desc_sw128(s_do + off, 16, 1024), kk > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs<32>(s);
    hopper::fence_regs<32>(dp);

#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * jj + cq + e;
        const float lse2 = s_lse[col], dl = s_dl[col];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int idx = 4 * jj + 2 * h + e;
          p_and_ds_tc<CAP>(s[idx], dp[idx], lse2, dl,
                           visible(q0 + col, kr + 8 * h, sq, skv, causal,
                                   window),
                           sm_scale, scale2, softcap);
        }
      }
    }

    // dV += P^T . dO and dK += dS^T . q: P^T and dS^T, rounded to bf16, are
    // already the A fragments; dO and q are read MN-major
    hopper::fence_regs<HD / 2>(dv_acc);
    hopper::fence_regs<HD / 2>(dk_acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hopper::WgmmaRS<HD, 1>::run(
          dv_acc, pack_bf16(s[8 * kk], s[8 * kk + 1]),
          pack_bf16(s[8 * kk + 2], s[8 * kk + 3]),
          pack_bf16(s[8 * kk + 4], s[8 * kk + 5]),
          pack_bf16(s[8 * kk + 6], s[8 * kk + 7]),
          hopper::desc_sw128(s_do + kk * 16 * 128, 64 * 128, 1024), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hopper::WgmmaRS<HD, 1>::run(
          dk_acc, pack_bf16(dp[8 * kk], dp[8 * kk + 1]),
          pack_bf16(dp[8 * kk + 2], dp[8 * kk + 3]),
          pack_bf16(dp[8 * kk + 4], dp[8 * kk + 5]),
          pack_bf16(dp[8 * kk + 6], dp[8 * kk + 7]),
          hopper::desc_sw128(s_q + kk * 16 * 128, 64 * 128, 1024), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs<HD / 2>(dv_acc);
    hopper::fence_regs<HD / 2>(dk_acc);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[st]);
  }

  // the two partial sums: consumer 0 hands its dV over and writes dK,
  // consumer 1 hands its dK over and writes dV; each sum has two terms,
  // so it has the same bits whichever is added to which.  A consumer's
  // ring is idle once its last tile is read.
  float* mine = reinterpret_cast<float*>(rings + c * RING);
  const float* theirs = reinterpret_cast<const float*>(rings + (1 - c) * RING);
  if (c == 0) {
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) mine[i * 128 + tid] = dv_acc[i];
  } else {
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) mine[i * 128 + tid] = dk_acc[i];
  }
  hopper::named_sync(1, 256);
  const long long head = (long long)kvh * skv * HD;
  if (c == 0) {
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dk_acc[i] += theirs[i * 128 + tid];
    store_acc<HD>(dk + head, dk_acc, sm_scale, kr, skv, cq);
  } else {
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dv_acc[i] += theirs[i * 128 + tid];
    store_acc<HD>(dv + head, dv_acc, 1.0f, kr, skv, cq);
  }
}

// dQ: a block a (128-row q tile, q head), the last q tiles first (under the
// causal mask they see the most kv tiles); two consumer warpgroups of 64 q
// rows with their q and dO resident, a producer thread streaming (k, v)
// tiles through a ring, as the forward does.
template <int HD, bool CAP>
__global__ void __launch_bounds__(384, 1)
bwd_dq_tc(const __grid_constant__ CUtensorMap map_q,
          const __grid_constant__ CUtensorMap map_k,
          const __grid_constant__ CUtensorMap map_v,
          const __grid_constant__ CUtensorMap map_do,
          const float* __restrict__ lse, const float* __restrict__ delta,
          bf16* __restrict__ dq, int group, int bhq, int sq, int skv,
          int sq_pad, int causal, int window, float sm_scale, float softcap) {
  using P = Tc<HD>;
  constexpr int S = P::Q_STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* s_q = align1024(smem_raw);       // consumer c's at + c TILE
  uint8_t* s_do = s_q + 2 * P::TILE;        // likewise
  uint8_t* ring = s_do + 2 * P::TILE;       // stage: k tile, v tile
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring + S * 2 * P::TILE);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + S;

  const int n_qt = (sq + 127) / 128;
  const int bh = blockIdx.x % bhq;
  const int q0 = (n_qt - 1 - (int)blockIdx.x / bhq) * 128;
  const int q_last = min(q0 + 128, sq) - 1;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? min(skv, q_last + 1) : skv;
  const int t_lo = k_lo / 64;
  const int t_hi = (k_hi + 63) / 64;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);  // a consumer warp each
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup
    hopper::regs_dec<40>();
    if (threadIdx.x == 0) {
      hopper::prefetch_map(&map_q);
      hopper::prefetch_map(&map_k);
      hopper::prefetch_map(&map_v);
      hopper::prefetch_map(&map_do);
      hopper::mbar_expect_tx(q_full, 4 * P::TILE);
      for (int c = 0; c < 2; ++c)
        for (int b = 0; b < P::BOXES; ++b) {
          hopper::tma_load_3d(s_q + c * P::TILE + b * 64 * 128, &map_q,
                              q_full, 64 * b, q0 + 64 * c, bh);
          hopper::tma_load_3d(s_do + c * P::TILE + b * 64 * 128, &map_do,
                              q_full, 64 * b, q0 + 64 * c, bh);
        }
      const int kvh = bh / group;
      for (int t = t_lo, i = 0; t < t_hi; ++t, ++i) {
        const int st = i % S;
        hopper::mbar_wait(&empty[st], ((i / S) & 1) ^ 1);
        hopper::mbar_expect_tx(&full[st], 2 * P::TILE);
        uint8_t* dst = ring + st * 2 * P::TILE;
        for (int b = 0; b < P::BOXES; ++b) {
          hopper::tma_load_3d(dst + b * 64 * 128, &map_k, &full[st], 64 * b,
                              t * 64, kvh);
          hopper::tma_load_3d(dst + P::TILE + b * 64 * 128, &map_v,
                              &full[st], 64 * b, t * 64, kvh);
        }
      }
    }
    return;
  }

  // consumer c: q rows qa + ..; this thread's rows r0 and r0 + 8, its kv
  // columns 8 j + cq + {0, 1} of a tile
  hopper::regs_inc<232>();
  const int c = threadIdx.x / 128 - 1;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int qa = q0 + 64 * c;
  const int r0 = qa + warp * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  const float scale2 = sm_scale * LOG2E;
  const uint8_t* s_qc = s_q + c * P::TILE;
  const uint8_t* s_doc = s_do + c * P::TILE;
  float lse2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    const long long at = (long long)bh * sq_pad + r;
    lse2[h] = r < sq ? lse[at] : 0.0f;
    dl[h] = r < sq ? delta[at] : 0.0f;
  }

  float dq_acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dq_acc[i] = 0.0f;

  hopper::mbar_wait(q_full, 0);
  for (int t = t_lo, i = 0; t < t_hi; ++t, ++i) {
    const int st = i % S;
    const int k0 = t * 64;
    // a tile no row of this consumer sees adds nothing
    const bool dead = k0 >= skv || (causal && k0 > qa + 63)
                      || (window > 0 && k0 + 63 <= qa - window);
    hopper::mbar_wait(&full[st], (i / S) & 1);
    if (!dead) {
      const uint8_t* s_k = ring + st * 2 * P::TILE;
      const uint8_t* s_v = s_k + P::TILE;
      // S = q . k^T and dP = dO . v^T, (64 q rows, 64 kv columns)
      float s[32], dp[32];
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int off = (kk / 4) * 64 * 128 + (kk % 4) * 32;
        hopper::WgmmaSS<64, 0, 0>::run(
            s, hopper::desc_sw128(s_qc + off, 16, 1024),
            hopper::desc_sw128(s_k + off, 16, 1024), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int off = (kk / 4) * 64 * 128 + (kk % 4) * 32;
        hopper::WgmmaSS<64, 0, 0>::run(
            dp, hopper::desc_sw128(s_doc + off, 16, 1024),
            hopper::desc_sw128(s_v + off, 16, 1024), kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs<32>(s);
      hopper::fence_regs<32>(dp);

#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k_pos = k0 + 8 * jj + cq + e;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int idx = 4 * jj + 2 * h + e;
            p_and_ds_tc<CAP>(s[idx], dp[idx], lse2[h], dl[h],
                             visible(r0 + 8 * h, k_pos, sq, skv, causal,
                                     window),
                             sm_scale, scale2, softcap);
          }
        }
      }

      // dQ += dS . k: dS, rounded to bf16, is the A fragment; k MN-major
      hopper::fence_regs<HD / 2>(dq_acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::WgmmaRS<HD, 1>::run(
            dq_acc, pack_bf16(dp[8 * kk], dp[8 * kk + 1]),
            pack_bf16(dp[8 * kk + 2], dp[8 * kk + 3]),
            pack_bf16(dp[8 * kk + 4], dp[8 * kk + 5]),
            pack_bf16(dp[8 * kk + 6], dp[8 * kk + 7]),
            hopper::desc_sw128(s_k + kk * 16 * 128, 64 * 128, 1024), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs<HD / 2>(dq_acc);
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[st]);
  }
  store_acc<HD>(dq + (long long)bh * sq * HD, dq_acc, sm_scale, r0, sq, cq);
}

template <int HD, bool CAP>
int launch_tc(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
              const bf16* dout, const float* lse, bf16* dq, bf16* dk,
              bf16* dv, float* delta, int bhq, int bhkv, int sq, int skv,
              int causal, int window, float sm_scale, float softcap,
              cudaStream_t stream) {
  using P = Tc<HD>;
  CUtensorMap map_q, map_k, map_v, map_do;
  int rc = hopper::make_map_bf16(&map_q, q, HD, sq, bhq, 64);
  if (rc == 0) rc = hopper::make_map_bf16(&map_do, dout, HD, sq, bhq, 64);
  if (rc == 0) rc = hopper::make_map_bf16(&map_k, k, HD, skv, bhkv, 64);
  if (rc == 0) rc = hopper::make_map_bf16(&map_v, v, HD, skv, bhkv, 64);
  if (rc != 0) return rc;
  auto dkdv = bwd_dkdv_tc<HD, CAP>;
  auto dqk = bwd_dq_tc<HD, CAP>;
  cudaError_t err = cudaFuncSetAttribute(
      dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::KV_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::Q_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int sq_pad = (sq + 63) / 64 * 64;
  const int group = bhq / bhkv;
  const long long rows = (long long)bhq * sq;
  bwd_delta_tc<<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      o, dout, delta, (int)rows, sq, sq_pad, HD);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dkdv<<<(unsigned)((skv + 63) / 64 * bhkv), P::THREADS, P::KV_SMEM,
         stream>>>(map_q, map_k, map_v, map_do, lse, delta, dk, dv, group,
                   bhkv, sq, skv, sq_pad, causal, window, sm_scale, softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dqk<<<(unsigned)((sq + 127) / 128 * bhq), P::THREADS, P::Q_SMEM,
        stream>>>(map_q, map_k, map_v, map_do, lse, delta, dq, group, bhq,
                  sq, skv, sq_pad, causal, window, sm_scale, softcap);
  return (int)cudaGetLastError();
}

// ------------------------------------------- bf16, hd 256: the tensor cores
// (see the header).  In dK/dV a consumer warpgroup's (64, 256) float32
// accumulators, dK and dV, would be 256 registers a thread, so each of the
// two consumers owns one half of hd (128 columns) of both, and the two
// share each (q tile, kv tile) pair: consumer c computes S^T and dP^T for
// the pair's q columns 32 c .. 32 c + 31 over all of hd (m64n32), P^T and
// dS^T there, and stores them rounded to bf16 into a shared 64 x 64 tile
// laid out as TMA lays out a K-major operand; after a barrier of the two,
// each adds the products over all 64 columns to its half (m64n128, P^T or
// dS^T from shared memory, dO or q MN-major).  No product runs twice.  The
// exchange tiles are double-buffered by the pair's parity, so one barrier
// a pair orders every write and read of them.  dQ needs one accumulator,
// so its consumers own 64 rows each (bwd_dq_tc256).
struct Tc256 {
  static constexpr int HD = 256;
  static constexpr int BOXES = 4;              // 64-column boxes of a row
  static constexpr int TILE = 64 * HD * 2;     // a 64-row bf16 tile, 32 KB
  static constexpr int XT = 64 * 64 * 2;       // a 64 x 64 bf16 exchange tile
  static constexpr int STAGES = 2;
  static constexpr int THREADS = 384;
  // dK/dV: k and v resident, a ring of (q, dO) tiles and their rows' lse
  // and D, two (P^T, dS^T) exchange pairs: 231,464 bytes
  static constexpr size_t KV_SMEM = 1024 + 2 * TILE + STAGES * 2 * TILE
                                    + 2 * 2 * XT
                                    + STAGES * 128 * sizeof(float)
                                    + (1 + 2 * STAGES) * sizeof(uint64_t);
};
static_assert(Tc256::KV_SMEM <= 232448, "");

// a bf16 pair (columns col, col + 1; col even) into row `row` of a 64 x 64
// tile laid out as a 128-byte-swizzled K-major operand (a row of 128 bytes,
// its 16-byte chunks permuted by row % 8; the tile 1024-byte aligned)
__device__ __forceinline__ void put_pair_sw128(uint8_t* tile, int row,
                                               int col, uint32_t pair) {
  const int chunk = (col >> 3) ^ (row & 7);
  *reinterpret_cast<uint32_t*>(tile + row * 128 + chunk * 16
                               + (col & 7) * 2) = pair;
}

// the products over hd of a 64-row tile at `a` (K-major, M) with rows
// 32 c .. 32 c + 31 of a 64-row tile at `b` (K-major, N = 32) into d
__device__ __forceinline__ void half_scores(float* d, const uint8_t* a,
                                            const uint8_t* b, int c) {
#pragma unroll
  for (int kk = 0; kk < Tc256::HD / 16; ++kk) {
    const int off = (kk / 4) * 64 * 128 + (kk % 4) * 32;
    hopper::WgmmaSS<32, 0, 0>::run(
        d, hopper::desc_sw128(a + off, 16, 1024),
        hopper::desc_sw128(b + c * 32 * 128 + off, 16, 1024), kk > 0);
  }
}

// d += x . t[:, 128 c .. 128 c + 127]: x a 64 x 64 exchange tile (K-major),
// t a 64-row tile of hd 256 read MN-major (its rows are the reduction)
__device__ __forceinline__ void half_product(float* d, const uint8_t* x,
                                             const uint8_t* t, int c) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    hopper::WgmmaSS<128, 0, 1>::run(
        d, hopper::desc_sw128(x + kk * 32, 16, 1024),
        hopper::desc_sw128(t + c * 2 * 64 * 128 + kk * 16 * 128, 64 * 128,
                           1024),
        1);
}

// dK and dV at hd 256: a block a (64-row kv tile, kv head, split of the
// group's q heads), kv tile major, the first kv tiles first (the longest
// under the causal mask).  Its items, the (q head of its split, 64-row q
// tile) pairs that can see the kv tile, run on both consumers together
// through one ring that a producer thread fills (k and v once, then q, dO
// and their rows' lse and D an item).  Each consumer's half of the float32
// sums goes to part_dk, part_dv [split][kv head][kv row][256];
// bwd_dkdv_sum256 adds the splits in order.
template <bool CAP>
__global__ void __launch_bounds__(384, 1)
bwd_dkdv_tc256(const __grid_constant__ CUtensorMap map_q,
               const __grid_constant__ CUtensorMap map_k,
               const __grid_constant__ CUtensorMap map_v,
               const __grid_constant__ CUtensorMap map_do,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ part_dk, float* __restrict__ part_dv,
               int group, int splits, int bhkv, int sq, int skv, int sq_pad,
               int causal, int window, float sm_scale, float softcap) {
  using P = Tc256;
  constexpr int S = P::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* s_k = align1024(smem_raw);
  uint8_t* s_v = s_k + P::TILE;
  uint8_t* ring = s_v + P::TILE;              // stage: q tile, dO tile
  uint8_t* xch = ring + S * 2 * P::TILE;      // [parity]: P^T, dS^T
  float* stats = reinterpret_cast<float*>(xch + 4 * P::XT);  // [st][2][64]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(stats + S * 128);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + S;

  const int per_tile = bhkv * splits;
  const int k0 = (blockIdx.x / per_tile) * 64;
  const int kvh = (blockIdx.x % per_tile) / splits;
  const int split = blockIdx.x % splits;
  const int heads = group / splits;             // q heads of a split
  const int k_last = min(k0 + 64, skv) - 1;
  // the q rows that can see some row of this kv tile, in 64-row tiles
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(sq, k_last + window) : sq;
  const int t_lo = q_lo / 64;
  const int n_t = q_lo < q_hi ? (q_hi + 63) / 64 - t_lo : 0;
  const int items = heads * n_t;  // item i: head i / n_t, q tile i % n_t

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);  // a consumer warp each
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup
    hopper::regs_dec<24>();
    if (threadIdx.x == 0) {
      hopper::prefetch_map(&map_q);
      hopper::prefetch_map(&map_k);
      hopper::prefetch_map(&map_v);
      hopper::prefetch_map(&map_do);
      hopper::mbar_expect_tx(kv_full, 2 * P::TILE);
      for (int b = 0; b < P::BOXES; ++b) {
        hopper::tma_load_3d(s_k + b * 64 * 128, &map_k, kv_full, 64 * b, k0,
                            kvh);
        hopper::tma_load_3d(s_v + b * 64 * 128, &map_v, kv_full, 64 * b, k0,
                            kvh);
      }
      for (int i = 0; i < items; ++i) {
        const int st = i % S;
        hopper::mbar_wait(&empty[st], ((i / S) & 1) ^ 1);
        const int bh = kvh * group + split * heads + i / n_t;
        const int q0 = (t_lo + i % n_t) * 64;
        hopper::mbar_expect_tx(&full[st], 2 * P::TILE + 512);
        uint8_t* dst = ring + st * 2 * P::TILE;
        for (int b = 0; b < P::BOXES; ++b) {
          hopper::tma_load_3d(dst + b * 64 * 128, &map_q, &full[st], 64 * b,
                              q0, bh);
          hopper::tma_load_3d(dst + P::TILE + b * 64 * 128, &map_do,
                              &full[st], 64 * b, q0, bh);
        }
        const long long at = (long long)bh * sq_pad + q0;
        hopper::bulk_load(stats + st * 128, lse + at, 256, &full[st]);
        hopper::bulk_load(stats + st * 128 + 64, delta + at, 256, &full[st]);
      }
    }
    return;
  }

  // consumer c: its tile rows rl and rl + 8 (kv rows kr, kr + 8), its q
  // columns 32 c + 8 j + cq + {0, 1} of a pair, its hd columns 128 c + 8 j
  // + cq + {0, 1} of dK and dV
  hopper::regs_inc<240>();
  const int c = threadIdx.x / 128 - 1;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int rl = warp * 16 + lane / 4;
  const int kr = k0 + rl;
  const int cq = 2 * (lane % 4);
  const float scale2 = sm_scale * LOG2E;

  float dk_acc[64], dv_acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk_acc[i] = dv_acc[i] = 0.0f;

  hopper::mbar_wait(kv_full, 0);
  for (int i = 0; i < items; ++i) {
    const int st = i % S;
    const int q0 = (t_lo + i % n_t) * 64;
    hopper::mbar_wait(&full[st], (i / S) & 1);
    const uint8_t* s_q = ring + st * 2 * P::TILE;
    const uint8_t* s_do = s_q + P::TILE;
    const float* s_lse = stats + st * 128;
    const float* s_dl = s_lse + 64;
    uint8_t* x_p = xch + (i & 1) * 2 * P::XT;
    uint8_t* x_ds = x_p + P::XT;

    // S^T = k . q^T and dP^T = v . dO^T at this consumer's 32 q columns
    float s[16], dp[16];
    hopper::wgmma_fence();
    half_scores(s, s_k, s_q, c);
    half_scores(dp, s_v, s_do, c);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs<16>(s);
    hopper::fence_regs<16>(dp);

#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 32 * c + 8 * jj + cq + e;
        const float lse2 = s_lse[col], dl = s_dl[col];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int idx = 4 * jj + 2 * h + e;
          p_and_ds_tc<CAP>(s[idx], dp[idx], lse2, dl,
                           visible(q0 + col, kr + 8 * h, sq, skv, causal,
                                   window),
                           sm_scale, scale2, softcap);
        }
      }
    }
    // P^T and dS^T, rounded to bf16, into the exchange tiles
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = rl + 8 * h, col = 32 * c + 8 * jj + cq;
        put_pair_sw128(x_p, row, col,
                       pack_bf16(s[4 * jj + 2 * h], s[4 * jj + 2 * h + 1]));
        put_pair_sw128(x_ds, row, col,
                       pack_bf16(dp[4 * jj + 2 * h], dp[4 * jj + 2 * h + 1]));
      }
    }
    hopper::fence_proxy_async();
    hopper::named_sync(1, 256);  // both halves of P^T and dS^T written

    // dV[:, half] += P^T . dO[:, half] and dK[:, half] += dS^T . q[:, half]
    hopper::fence_regs<64>(dv_acc);
    hopper::fence_regs<64>(dk_acc);
    hopper::wgmma_fence();
    half_product(dv_acc, x_p, s_do, c);
    half_product(dk_acc, x_ds, s_q, c);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs<64>(dv_acc);
    hopper::fence_regs<64>(dk_acc);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[st]);
  }

  const long long head = ((long long)split * bhkv + kvh) * skv * P::HD;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = kr + 8 * h;
    if (r >= skv) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const long long at = head + (long long)r * P::HD + 128 * c + 8 * j + cq;
      *reinterpret_cast<float2*>(part_dk + at) =
          make_float2(dk_acc[4 * j + 2 * h], dk_acc[4 * j + 2 * h + 1]);
      *reinterpret_cast<float2*>(part_dv + at) =
          make_float2(dv_acc[4 * j + 2 * h], dv_acc[4 * j + 2 * h + 1]);
    }
  }
}

// dK and dV from the splits' partial sums: each element's terms added in
// split order (the same bits every run), dK times sm_scale, rounded to
// bf16; four elements a thread
__global__ void __launch_bounds__(256)
bwd_dkdv_sum256(const float* __restrict__ part_dk,
                const float* __restrict__ part_dv, bf16* __restrict__ dk,
                bf16* __restrict__ dv, long long n, int splits,
                float sm_scale) {
  const long long i = ((long long)blockIdx.x * 256 + threadIdx.x) * 4;
  if (i >= n) return;
  float4 a = *reinterpret_cast<const float4*>(part_dk + i);
  float4 b = *reinterpret_cast<const float4*>(part_dv + i);
  for (int s = 1; s < splits; ++s) {
    const float4 x = *reinterpret_cast<const float4*>(part_dk + s * n + i);
    const float4 y = *reinterpret_cast<const float4*>(part_dv + s * n + i);
    a = make_float4(__fadd_rn(a.x, x.x), __fadd_rn(a.y, x.y),
                    __fadd_rn(a.z, x.z), __fadd_rn(a.w, x.w));
    b = make_float4(__fadd_rn(b.x, y.x), __fadd_rn(b.y, y.y),
                    __fadd_rn(b.z, y.z), __fadd_rn(b.w, y.w));
  }
  __nv_bfloat162* k2 = reinterpret_cast<__nv_bfloat162*>(dk + i);
  __nv_bfloat162* v2 = reinterpret_cast<__nv_bfloat162*>(dv + i);
  k2[0] = __floats2bfloat162_rn(a.x * sm_scale, a.y * sm_scale);
  k2[1] = __floats2bfloat162_rn(a.z * sm_scale, a.w * sm_scale);
  v2[0] = __floats2bfloat162_rn(b.x, b.y);
  v2[1] = __floats2bfloat162_rn(b.z, b.w);
}

// dQ at hd 256: a block a (128-row q tile, q head), the last q tiles first
// (under the causal mask they see the most kv tiles); two consumer
// warpgroups of 64 q rows with their q and dO resident, each computing
// its rows' S = q k^T and dP = dO v^T over a whole kv tile and dQ += dS k
// into its (64, 256) accumulator (two m64n128 halves, dS from registers):
// no exchange.  q and dO fill 128 KB, so k and v stream through a ring of
// three 32 KB slots, k_t, v_t, k_{t+1}, ... in load order: a consumer
// frees v's slot once dP is computed and k's once dQ is, so the next
// tile's k is in flight during a tile and its v during dS and dQ.
struct Dq256 {
  static constexpr int SLOTS = 3;
  static constexpr size_t SMEM = 1024 + 4 * Tc256::TILE
                                 + SLOTS * Tc256::TILE
                                 + (1 + 2 * SLOTS) * sizeof(uint64_t);
};
static_assert(Dq256::SMEM <= 232448, "");

template <bool CAP>
__global__ void __launch_bounds__(384, 1)
bwd_dq_tc256(const __grid_constant__ CUtensorMap map_q,
             const __grid_constant__ CUtensorMap map_k,
             const __grid_constant__ CUtensorMap map_v,
             const __grid_constant__ CUtensorMap map_do,
             const float* __restrict__ lse, const float* __restrict__ delta,
             bf16* __restrict__ dq, int group, int bhq, int sq, int skv,
             int sq_pad, int causal, int window, float sm_scale,
             float softcap) {
  using P = Tc256;
  constexpr int SLOTS = Dq256::SLOTS;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* s_q = align1024(smem_raw);       // consumer c's at + c TILE
  uint8_t* s_do = s_q + 2 * P::TILE;        // likewise
  uint8_t* ring = s_do + 2 * P::TILE;       // slots: k_t, v_t, k_{t+1}, ..
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring + SLOTS * P::TILE);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + SLOTS;

  const int n_qt = (sq + 127) / 128;
  const int bh = blockIdx.x % bhq;
  const int q0 = (n_qt - 1 - (int)blockIdx.x / bhq) * 128;
  const int q_last = min(q0 + 128, sq) - 1;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? min(skv, q_last + 1) : skv;
  const int t_lo = k_lo / 64;
  const int t_hi = (k_hi + 63) / 64;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < SLOTS; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);  // a consumer warp each
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup
    hopper::regs_dec<24>();
    if (threadIdx.x == 0) {
      hopper::prefetch_map(&map_q);
      hopper::prefetch_map(&map_k);
      hopper::prefetch_map(&map_v);
      hopper::prefetch_map(&map_do);
      hopper::mbar_expect_tx(q_full, 4 * P::TILE);
      for (int c = 0; c < 2; ++c)
        for (int b = 0; b < P::BOXES; ++b) {
          hopper::tma_load_3d(s_q + c * P::TILE + b * 64 * 128, &map_q,
                              q_full, 64 * b, q0 + 64 * c, bh);
          hopper::tma_load_3d(s_do + c * P::TILE + b * 64 * 128, &map_do,
                              q_full, 64 * b, q0 + 64 * c, bh);
        }
      const int kvh = bh / group;
      for (int n = 0; n < 2 * (t_hi - t_lo); ++n) {  // k_t, then v_t
        const int sl = n % SLOTS;
        hopper::mbar_wait(&empty[sl], ((n / SLOTS) & 1) ^ 1);
        hopper::mbar_expect_tx(&full[sl], P::TILE);
        const CUtensorMap* map = n % 2 ? &map_v : &map_k;
        for (int b = 0; b < P::BOXES; ++b)
          hopper::tma_load_3d(ring + sl * P::TILE + b * 64 * 128, map,
                              &full[sl], 64 * b, (t_lo + n / 2) * 64, kvh);
      }
    }
    return;
  }

  // consumer c: q rows qa + ..; this thread's rows r0 and r0 + 8, its kv
  // columns 8 j + cq + {0, 1} of a tile, its hd columns 8 j + cq + {0, 1}
  hopper::regs_inc<240>();
  const int c = threadIdx.x / 128 - 1;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int qa = q0 + 64 * c;
  const int r0 = qa + warp * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  const float scale2 = sm_scale * LOG2E;
  const uint8_t* s_qc = s_q + c * P::TILE;
  const uint8_t* s_doc = s_do + c * P::TILE;
  float lse2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    const long long at = (long long)bh * sq_pad + r;
    lse2[h] = r < sq ? lse[at] : 0.0f;
    dl[h] = r < sq ? delta[at] : 0.0f;
  }

  float dq_acc[P::HD / 2];
#pragma unroll
  for (int i = 0; i < P::HD / 2; ++i) dq_acc[i] = 0.0f;

  hopper::mbar_wait(q_full, 0);
  for (int t = t_lo, i = 0; t < t_hi; ++t, ++i) {
    const int nk = 2 * i, nv = 2 * i + 1;  // the tile's loads
    const int sk = nk % SLOTS, sv = nv % SLOTS;
    const int k0 = t * 64;
    // a tile no row of this consumer sees adds nothing
    const bool dead = k0 >= skv || (causal && k0 > qa + 63)
                      || (window > 0 && k0 + 63 <= qa - window);
    hopper::mbar_wait(&full[sk], (nk / SLOTS) & 1);
    hopper::mbar_wait(&full[sv], (nv / SLOTS) & 1);
    const uint8_t* s_k = ring + sk * P::TILE;
    const uint8_t* s_v = ring + sv * P::TILE;
    float s[32], dp[32];
    if (!dead) {
      // S = q . k^T and dP = dO . v^T, (64 q rows, 64 kv columns)
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < P::HD / 16; ++kk) {
        const int off = (kk / 4) * 64 * 128 + (kk % 4) * 32;
        hopper::WgmmaSS<64, 0, 0>::run(
            s, hopper::desc_sw128(s_qc + off, 16, 1024),
            hopper::desc_sw128(s_k + off, 16, 1024), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < P::HD / 16; ++kk) {
        const int off = (kk / 4) * 64 * 128 + (kk % 4) * 32;
        hopper::WgmmaSS<64, 0, 0>::run(
            dp, hopper::desc_sw128(s_doc + off, 16, 1024),
            hopper::desc_sw128(s_v + off, 16, 1024), kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs<32>(s);
      hopper::fence_regs<32>(dp);
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[sv]);  // v_t is read
    if (!dead) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k_pos = k0 + 8 * jj + cq + e;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int idx = 4 * jj + 2 * h + e;
            p_and_ds_tc<CAP>(s[idx], dp[idx], lse2[h], dl[h],
                             visible(r0 + 8 * h, k_pos, sq, skv, causal,
                                     window),
                             sm_scale, scale2, softcap);
          }
        }
      }
      // dQ += dS . k: dS, rounded to bf16, is the A fragment; k MN-major,
      // in two halves of hd
      hopper::fence_regs<P::HD / 2>(dq_acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t a0 = pack_bf16(dp[8 * kk], dp[8 * kk + 1]);
        const uint32_t a1 = pack_bf16(dp[8 * kk + 2], dp[8 * kk + 3]);
        const uint32_t a2 = pack_bf16(dp[8 * kk + 4], dp[8 * kk + 5]);
        const uint32_t a3 = pack_bf16(dp[8 * kk + 6], dp[8 * kk + 7]);
#pragma unroll
        for (int half = 0; half < 2; ++half)
          hopper::WgmmaRS<128, 1>::run(
              dq_acc + 64 * half, a0, a1, a2, a3,
              hopper::desc_sw128(s_k + half * 2 * 64 * 128 + kk * 16 * 128,
                                 64 * 128, 1024),
              1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs<P::HD / 2>(dq_acc);
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[sk]);  // k_t is read
  }
  store_acc<P::HD>(dq + (long long)bh * sq * P::HD, dq_acc, sm_scale, r0, sq,
                   cq);
}

template <bool CAP>
int launch_tc256(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
                 const bf16* dout, const float* lse, bf16* dq, bf16* dk,
                 bf16* dv, float* delta, float* part, int bhq, int bhkv,
                 int sq, int skv, int splits, int causal, int window,
                 float sm_scale, float softcap, cudaStream_t stream) {
  using P = Tc256;
  const int group = bhq / bhkv;
  if (splits < 1 || group % splits != 0) return (int)cudaErrorInvalidValue;
  CUtensorMap map_q, map_k, map_v, map_do;
  int rc = hopper::make_map_bf16(&map_q, q, P::HD, sq, bhq, 64);
  if (rc == 0) rc = hopper::make_map_bf16(&map_do, dout, P::HD, sq, bhq, 64);
  if (rc == 0) rc = hopper::make_map_bf16(&map_k, k, P::HD, skv, bhkv, 64);
  if (rc == 0) rc = hopper::make_map_bf16(&map_v, v, P::HD, skv, bhkv, 64);
  if (rc != 0) return rc;
  auto dkdv = bwd_dkdv_tc256<CAP>;
  auto dqk = bwd_dq_tc256<CAP>;
  cudaError_t err = cudaFuncSetAttribute(
      dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::KV_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Dq256::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int sq_pad = (sq + 63) / 64 * 64;
  const long long rows = (long long)bhq * sq;
  bwd_delta_tc<<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      o, dout, delta, (int)rows, sq, sq_pad, P::HD);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)bhkv * skv * P::HD;
  dkdv<<<(unsigned)((skv + 63) / 64 * bhkv * splits), P::THREADS,
         P::KV_SMEM, stream>>>(map_q, map_k, map_v, map_do, lse, delta, part,
                               part + splits * n, group, splits, bhkv, sq,
                               skv, sq_pad, causal, window, sm_scale,
                               softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_dkdv_sum256<<<(unsigned)((n / 4 + 255) / 256), 256, 0, stream>>>(
      part, part + splits * n, dk, dv, n, splits, sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dqk<<<(unsigned)((sq + 127) / 128 * bhq), P::THREADS, Dq256::SMEM,
        stream>>>(map_q, map_k, map_v, map_do, lse, delta, dq, group, bhq,
                  sq, skv, sq_pad, causal, window, sm_scale, softcap);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes.  Returns the cudaError_t of the launches (0
// on success).  stats (2, BHq, Sq) and delta (BHq, Sq) are float32 scratch
// the caller allocates (stats: each row's max, then 1 / its sum); the caller
// checks the shapes (1 <= hd <= 256, BHq a multiple of
// BHkv, BHq <= 65535, Sq and Skv > 0, everything contiguous, one type).
extern "C" int flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, void* stats, void* delta,
    int bhq, int bhkv, int sq, int skv, int hd, int causal, int window,
    float sm_scale, float softcap, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, dout, dq, dk, dv, stats, delta, bhq,
                               bhkv, sq, skv, hd, causal, window, sm_scale,
                               softcap, stream);
}

extern "C" int flash_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, void* stats, void* delta,
    int bhq, int bhkv, int sq, int skv, int hd, int causal, int window,
    float sm_scale, float softcap, void* stream) {
  return launch<float>(q, k, v, o, dout, dq, dk, dv, stats, delta, bhq, bhkv,
                       sq, skv, hd, causal, window, sm_scale, softcap, stream);
}

// The tensor-core backward (bf16, hd 64 or 128; another hd returns
// cudaErrorInvalidValue): lse (BHq, sq_pad) float32 from the forward's LSE
// instance, sq_pad = Sq rounded up to a multiple of 64; delta (BHq, sq_pad)
// float32 scratch.  Returns the cudaError_t of the launches or a negative
// code of hopper::make_map_bf16; the caller checks the shapes (BHq a
// multiple of BHkv, Sq and Skv > 0, 16-byte aligned bases, everything
// contiguous, one type).
extern "C" int flash_attention_bwd_bf16_tc(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    void* delta, int bhq, int bhkv, int sq, int skv, int hd, int causal,
    int window, float sm_scale, float softcap, void* stream) {
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* ot = static_cast<const bf16*>(o);
  const bf16* dot = static_cast<const bf16*>(dout);
  const float* lt = static_cast<const float*>(lse);
  bf16* dqt = static_cast<bf16*>(dq);
  bf16* dkt = static_cast<bf16*>(dk);
  bf16* dvt = static_cast<bf16*>(dv);
  float* dl = static_cast<float*>(delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FLASH_BWD_TC(HD, CAP)                                                \
  return launch_tc<HD, CAP>(qt, kt, vt, ot, dot, lt, dqt, dkt, dvt, dl, bhq, \
                            bhkv, sq, skv, causal, window, sm_scale,        \
                            softcap, st)
  const bool cap = softcap > 0.0f;
  if (hd == 64) {
    if (cap) FLASH_BWD_TC(64, true);
    FLASH_BWD_TC(64, false);
  }
  if (hd == 128) {
    if (cap) FLASH_BWD_TC(128, true);
    FLASH_BWD_TC(128, false);
  }
#undef FLASH_BWD_TC
  return (int)cudaErrorInvalidValue;
}

// The tensor-core backward at hd 256 (bf16): as flash_attention_bwd_bf16_tc,
// and part, float32 scratch of 2 * splits * BHkv * Skv * 256 elements for
// the dK/dV blocks' partial sums (kernels/flash/kernel.py::dkdv_splits
// picks splits, which must divide the group BHq / BHkv; another returns
// cudaErrorInvalidValue).
extern "C" int flash_attention_bwd_bf16_tc256(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    void* delta, void* part, int bhq, int bhkv, int sq, int skv, int splits,
    int causal, int window, float sm_scale, float softcap, void* stream) {
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* ot = static_cast<const bf16*>(o);
  const bf16* dot = static_cast<const bf16*>(dout);
  const float* lt = static_cast<const float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto fn = softcap > 0.0f ? launch_tc256<true> : launch_tc256<false>;
  return fn(qt, kt, vt, ot, dot, lt, static_cast<bf16*>(dq),
            static_cast<bf16*>(dk), static_cast<bf16*>(dv),
            static_cast<float*>(delta), static_cast<float*>(part), bhq, bhkv,
            sq, skv, splits, causal, window, sm_scale, softcap, st);
}

extern "C" const char* flash_attention_bwd_error_string(int code) {
  return hopper::error_string(code);
}
