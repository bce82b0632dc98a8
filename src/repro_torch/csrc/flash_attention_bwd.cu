// Flash attention, backward pass: dQ, dK and dV of the forward in
// flash_attention.cu, with GQA, causal and sliding-window masks and the
// gemma2 logit soft-cap, computing in float32 on bf16 or float32 inputs.
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
//   P    = visible ? exp(s - m) / l : 0   m = row max, l = sum_visible exp(s - m)
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
//
// Three kernels, one launch of the C entry point (flash_attention_bwd_*):
//
// 1. bwd_prep_kernel, one block per (q tile, bh): the row max m and 1 / l
//    (the log-sum-exp without its log), by walking the visible kv tiles
//    with an online max and sum, and D.  The
//    forward kernels are left as they are (no LSE output): the serve path's
//    output stays bit-identical by construction, and the bf16 forward's
//    consumer warpgroups hold 232 registers a thread with no room to spare.
//    The price is one more q . k^T product.
// 2. bwd_dkdv_kernel, one block per (kv tile, kv head): K and V of its tile
//    in shared memory, dK and dV in registers; it walks the group's q heads
//    and the q tiles that can see its tile, recomputing P and dS.
// 3. bwd_dq_kernel, one block per (q tile, bh): q, dO, m, 1 / l and D of its
//    tile in shared memory, dQ in registers; it walks the visible kv tiles.
//
// Every output element is owned by one thread of one block, so there are
// no float atomics and the result does not change from run to run.  Tiles
// are float32 in shared memory (rows padded by one float against bank
// conflicts): 64 rows a tile up to hd 128, 32 at hd 256; each thread holds
// an (R/16 x R/16) slice of a score tile and an (R/8 x HDMAX/32) slice of an
// accumulator; every product is an explicit fused multiply-add (__fmaf_rn),
// which --fmad=false leaves alone; exp and tanh are the accurate ones.
//
// Bound on an H100 SXM at the training shape (B = 4, Hq = 32, Hkv = 4,
// S = 512, hd = 128, causal, bf16): the 8 input and output arrays (q, k,
// v, o, dO, dQ, dK, dV) are 75.5 MB, 0.0225 ms at 3.35 TB/s; the five
// products of the backward over the visible (q, k) pairs are 21.5 GFLOP,
// 0.0218 ms at the bf16 tensor-core peak (989 TFLOP/s): bytes bound it,
// narrowly.  This design runs on the float32 cores (67 TFLOP/s, 0.32 ms for
// those 21.5 GFLOP), does seven products and the prep pass's one where the
// bound counts five, and keeps one block an SM (166 KB of shared memory at
// hd 128): it is right first; wgmma, TMA and a Hopper redesign wait for a
// later PR (ROADMAP queue 2, F12).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

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

extern "C" const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
