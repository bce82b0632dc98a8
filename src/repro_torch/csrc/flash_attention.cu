// Flash attention, forward pass: online-softmax attention over kv tiles with
// float32 (m, l, o), GQA, causal and sliding-window masks and the gemma2
// logit soft-cap.
//
// Replaces the Pallas TPU kernel repro/kernels/flash/kernel.py:89
// (flash_attention_fwd -> _flash_kernel, :28).  It computes what
// repro_torch/kernels/flash/ref.py::reference_attention computes, in the
// TPU kernel's steps:
//
//   s   = (q . k) * sm_scale;  s = softcap * tanh(s / softcap) if softcap > 0
//   ok  = k_pos < kv_len [&& k_pos <= q_pos] [&& k_pos > q_pos - window]
//   s   = ok ? s : -1e30
//   m'  = max(m, max_j s);  p = ok ? exp(s - m') : 0;  c = exp(m - m')
//   l'  = c * l + sum_j p;  o' = o * c + p . v
//   out = o / (l == 0 ? 1 : l)                (a row that sees no key is 0)
//
// q_pos and k_pos are row indices from 0, as in the TPU kernel.  Layout,
// all contiguous: q (BHq, Sq, hd), k and v (BHkv, Skv, hd), out (BHq, Sq,
// hd) in q's type; q row block bh reads kv row block bh / group (group =
// BHq / BHkv), the kv-major GQA fold of ops.py.  The TPU grid's sequential
// kv axis (ki, carrying m, l and o in VMEM) is a loop inside the block
// here, because CUDA blocks run in no order.  A kv tile that the causal or
// window mask hides from every row of the q tile is skipped (there p = 0
// and c = 1, so the result is the same); the mask is evaluated only on
// tiles that cross the diagonal, the window's edge or kv_len.  exp, tanh
// and the final division are the accurate ones (no fast math), and every
// multiply-add of the softmax is an explicit fused one (__fmaf_rn), which
// --fmad=false leaves alone.
//
// Two kernels, chosen by the inputs' type:
//
// - bf16 (flash_bf16_kernel): the tensor cores.  q . k^T and p . v are
//   wgmma products of bf16 operands with float32 accumulators: p is
//   rounded to bf16 before p . v (ref.py::reference_attention_bf16_p is
//   the plain model of that rounding), which leaves the TPU kernel's
//   float32 arithmetic; m, l and o stay float32 in registers.  A block of
//   384 threads owns 128 q rows: two consumer warpgroups of 64 rows each
//   (S = Q K^T as m64n64k16 from shared memory, both K-major; the float32
//   S, rounded to bf16 pairs, is already the A fragment of O += P V, whose
//   B operand v is read MN-major), and one producer warpgroup whose first
//   thread issues TMA loads: q once, then k and v tiles of 64 rows into a
//   ring of 2 (hd 256), 3 (hd 128) or 4 (hd <= 64) stages, each with a full
//   and an empty mbarrier; setmaxnreg moves registers from the producer
//   (40) to the consumers (232: a 64 x 256 float32 o is 128 of them).  The
//   tensor maps are rank 3, (hd, S, BH), with 128-byte swizzle and boxes
//   of 64 columns: hd is padded to 64, 128 or 256 by the box's zero fill,
//   and rows past Sq or Skv arrive as zeros instead of the next head's
//   rows (the TPU kernel's 0 * NaN guard).  TMA needs 16-byte row strides,
//   so hd is a multiple of 8 (the wrapper raises otherwise); the tiles are
//   fixed (64 x 64 per warpgroup).  csrc/hopper.cuh holds the TMA,
//   mbarrier and wgmma helpers.  Training launches a second instance
//   (flash_attention_bf16_lse, hd 64, 128 and 256: the shapes whose
//   backward runs on the tensor cores) that also writes each row's
//   log-sum-exp in log2 units, m + log2(l), for flash_attention_bwd.cu;
//   the serve path's instance is compiled without that store, so its
//   output is unchanged.
// - float32 (flash_fwd_kernel): the TPU kernel's float32 arithmetic on the
//   float32 cores, one block of 256 threads per (q tile, bh), q, k, v and
//   the scores in float32 shared tiles (113.5 KB at hd 128), each thread
//   an 8 x (HDMAX / 32) slice of o in registers; block_q x block_k (at most
//   64 x 64) is its tile and changes only the order of float32 sums.
//
// Bound on an H100 SXM, bf16: at qwen's serve shape (B = 4, Hq = 32, Hkv =
// 4, S = 512, hd = 128, causal) the visible (q, k) pairs need 8.6 GFLOP
// against 37.7 MB of q, k, v and out: 0.0087 ms at the bf16 tensor-core
// peak, 0.0113 ms at 3.35 TB/s, so bytes bound it; at recurrentgemma's
// (B = 4, Hq = 16, Hkv = 1, S = 2560, hd = 256, window 2048) 206 GFLOP of
// visible pairs, 0.209 ms: operations bound it.  What the design does:
// every q, k and v element is read from device memory once per (128-row q
// block, kv tile), by TMA, two to four tiles ahead of the products; both
// products run on the tensor cores, so the float32 exp of the softmax and
// the tiles that cross the mask's edge are what remain between the kernel
// and its bound.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int TILE = 64;       // q rows and kv rows per tile, at most
constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;


__device__ __forceinline__ bool visible(int q_pos, int k_pos, int c,
                                        int cols, int causal, int window) {
  bool ok = c < cols;                     // in this tile and k_pos < kv_len
  if (causal) ok = ok && k_pos <= q_pos;
  if (window > 0) ok = ok && k_pos > q_pos - window;
  return ok;
}

template <int HDMAX>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * TILE * (HDMAX + 1) + TILE * HDMAX
                          + TILE * (TILE + 1) + 3 * TILE);
}

template <int HDMAX>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 int group, int sq, int skv, int hd, int block_q,
                 int block_k, int causal, int window, float sm_scale,
                 float softcap) {
  constexpr int QK = HDMAX + 1;           // row stride of the q and k tiles
  constexpr int SS = TILE + 1;            // row stride of the score tile
  constexpr int NC = HDMAX / 32;          // acc columns per thread
  extern __shared__ float smem[];
  float* s_q = smem;                      // (TILE, QK)
  float* s_k = s_q + TILE * QK;           // (TILE, QK)
  float* s_v = s_k + TILE * QK;           // (TILE, HDMAX)
  float* s_s = s_v + TILE * HDMAX;        // (TILE, SS): scores, then p
  float* s_m = s_s + TILE * SS;           // (TILE,) running max
  float* s_l = s_m + TILE;                // (TILE,) running sum
  float* s_c = s_l + TILE;                // (TILE,) this tile's correction

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * block_q;
  const int rows = min(block_q, sq - q0);  // live q rows of this tile
  const float* qb = q + ((long long)bh * sq + q0) * hd;
  const float* kb = k + (long long)(bh / group) * skv * hd;
  const float* vb = v + (long long)(bh / group) * skv * hd;

  for (int e = tid; e < TILE * HDMAX; e += THREADS) {
    const int r = e / HDMAX, c = e % HDMAX;
    s_q[r * QK + c] =
        (r < rows && c < hd) ? qb[(long long)r * hd + c] : 0.0f;
  }
  if (tid < TILE) {
    s_m[tid] = NEG_INF;
    s_l[tid] = 0.0f;
  }

  // this thread's slice of acc: rows rg * 8 + i, columns cg + 32 * j
  const int rg = tid >> 5, cg = tid & 31;
  float acc[8][NC];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.0f;
  // this thread's scores: rows sr * 4 + i, columns sc + 16 * j
  const int sr = tid >> 4, sc = tid & 15;
  // this thread's row statistics: row rr, columns rs * 16 .. rs * 16 + 15
  const int rr = tid >> 2, rs = tid & 3;

  // the kv rows some row of this q tile can see
  int k_lo = 0, k_hi = skv;
  if (causal) k_hi = min(skv, q0 + rows);
  if (window > 0) k_lo = max(0, q0 - window + 1);
  const int t_lo = k_lo / block_k;
  const int t_hi = (k_hi + block_k - 1) / block_k;

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * block_k;
    const int cols = min(block_k, skv - k0);
    __syncthreads();  // the last tile's reads of s_k, s_v and s_s are done
    for (int e = tid; e < TILE * HDMAX; e += THREADS) {
      const int r = e / HDMAX, c = e % HDMAX;
      const bool live = r < cols && c < hd;
      const long long g = (long long)(k0 + r) * hd + c;
      s_k[r * QK + c] = live ? kb[g] : 0.0f;
      s_v[r * HDMAX + c] = live ? vb[g] : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    for (int d = 0; d < hd; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = s_q[(sr * 4 + i) * QK + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = s_k[(sc + 16 * j) * QK + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = __fmaf_rn(a[i], b[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = sr * 4 + i, c = sc + 16 * j;
        float x = s[i][j] * sm_scale;
        if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
        s_s[r * SS + c] =
            visible(q0 + r, k0 + c, c, cols, causal, window) ? x : NEG_INF;
      }
    }
    __syncthreads();

    {  // online softmax: four neighbouring lanes share a row
      float mx = NEG_INF;
      for (int j = 0; j < 16; ++j) mx = fmaxf(mx, s_s[rr * SS + rs * 16 + j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = s_m[rr];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
      for (int j = 0; j < 16; ++j) {
        const int c = rs * 16 + j;
        const float p = visible(q0 + rr, k0 + c, c, cols, causal, window)
                            ? expf(s_s[rr * SS + c] - m_new)
                            : 0.0f;
        s_s[rr * SS + c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (rs == 0) {
        const float corr = expf(m_prev - m_new);  // 1 while both are -1e30
        s_c[rr] = corr;
        s_l[rr] = corr * s_l[rr] + sum;
        s_m[rr] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float corr = s_c[rg * 8 + i];
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] *= corr;
    }
    for (int kk = 0; kk < cols; ++kk) {
      float vv[NC];
#pragma unroll
      for (int j = 0; j < NC; ++j) vv[j] = s_v[kk * HDMAX + cg + 32 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float p = s_s[(rg * 8 + i) * SS + kk];
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[i][j] = __fmaf_rn(p, vv[j], acc[i][j]);
      }
    }
  }
  __syncthreads();  // s_l is final (also when no kv tile was visible)

  float* ob = out + ((long long)bh * sq + q0) * hd;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = rg * 8 + i;
    if (r >= rows) continue;
    const float l = s_l[r];
    const float denom = l == 0.0f ? 1.0f : l;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = cg + 32 * j;
      if (c < hd) ob[(long long)r * hd + c] = acc[i][j] / denom;
    }
  }
}

template <int HDMAX>
int launch_hd(const float* q, const float* k, const float* v, float* out,
              int bhq, int bhkv, int sq, int skv, int hd, int block_q,
              int block_k, int causal, int window, float sm_scale,
              float softcap, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HDMAX>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<HDMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((sq + block_q - 1) / block_q), (unsigned)bhq);
  flash_fwd_kernel<HDMAX><<<grid, THREADS, smem, stream>>>(
      q, k, v, out, bhq / bhkv, sq, skv, hd, block_q, block_k, causal, window,
      sm_scale, softcap);
  return (int)cudaGetLastError();
}

int launch_f32(const void* q, const void* k, const void* v, void* out,
               int bhq, int bhkv, int sq, int skv, int hd, int block_q,
               int block_k, int causal, int window, float sm_scale,
               float softcap, void* stream) {
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  float* ot = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd <= 64)
    return launch_hd<64>(qt, kt, vt, ot, bhq, bhkv, sq, skv, hd, block_q,
                         block_k, causal, window, sm_scale, softcap, st);
  if (hd <= 128)
    return launch_hd<128>(qt, kt, vt, ot, bhq, bhkv, sq, skv, hd, block_q,
                          block_k, causal, window, sm_scale, softcap, st);
  return launch_hd<256>(qt, kt, vt, ot, bhq, bhkv, sq, skv, hd, block_q,
                        block_k, causal, window, sm_scale, softcap, st);
}

// ------------------------------------------------ bf16: tensor cores
// Two consumer warpgroups of 64 q rows each and one producer warpgroup
// (its first thread issues every TMA load) a block of 384 threads; kv
// tiles of 64 rows in a ring of STAGES stages; HDP, the head dim padded to
// a multiple of 64 (the box's zero fill pads it).
template <int HDP>
struct FlashBf16 {
  static constexpr int BM = 64;             // q rows of a consumer
  static constexpr int CONSUMERS = 2;
  static constexpr int BQ = BM * CONSUMERS;  // q rows of a block
  static constexpr int BN = 64;             // kv rows of a tile
  static constexpr int BOXES = HDP / 64;    // 64-column boxes of a row
  static constexpr int STAGES = HDP == 256 ? 2 : HDP == 128 ? 3 : 4;
  static constexpr int Q_BYTES = BM * HDP * 2;   // a consumer's q tile
  static constexpr int KV_BYTES = BN * HDP * 2;  // a k or a v tile
  static constexpr int THREADS = 128 * (CONSUMERS + 1);
  static constexpr size_t SMEM = 1024 + CONSUMERS * Q_BYTES
                                 + STAGES * 2 * KV_BYTES
                                 + (1 + 2 * STAGES) * sizeof(uint64_t);
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The scores of a thread's S fragment (rows r0 and r0 + 8, columns c0 + 8 j
// + {0, 1}) in log2 units: s * sm_scale * log2(e), or with the soft-cap
// softcap * tanh(s * sm_scale / softcap) * log2(e); -1e30 where masked
// (MASK: the tile crosses the diagonal, the window's edge or kv_len).
template <int BN, bool MASK, bool CAP>
__device__ __forceinline__ void scores(float* s, int r0, int c0, int skv,
                                       int causal, int window, float sm_scale,
                                       float scale2, float softcap) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * j + 2 * h + e];
        if (CAP)
          x = softcap * tanhf(x * sm_scale / softcap) * LOG2E;
        else
          x *= scale2;
        if (MASK) {
          const int k_pos = c0 + 8 * j + e;
          if (!visible(r0 + 8 * h, k_pos, k_pos, skv, causal, window))
            x = NEG_INF;
        }
      }
    }
  }
}

// LSE: also write each row's log-sum-exp of its scores in log2 units, m +
// log2(l), to lse[bh * sq_pad + row] (0 for a row that sees no key): the
// instance that the autograd function launches, for the backward; the
// serve path's instance (LSE = false) has no such code.
template <int HDP, bool CAP, bool LSE>
__global__ void __launch_bounds__(FlashBf16<HDP>::THREADS, 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap map_q,
                  const __grid_constant__ CUtensorMap map_k,
                  const __grid_constant__ CUtensorMap map_v,
                  __nv_bfloat16* __restrict__ out, int group, int sq,
                  int skv, int hd, int causal, int window, float sm_scale,
                  float softcap, float* __restrict__ lse, int sq_pad) {
  using P = FlashBf16<HDP>;
  constexpr int BN = P::BN;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* s_q = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* s_kv = s_q + P::CONSUMERS * P::Q_BYTES;  // stage: k tile, v tile
  uint64_t* q_full = reinterpret_cast<uint64_t*>(
      s_kv + P::STAGES * 2 * P::KV_BYTES);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + P::STAGES;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * P::BQ;
  // the kv tiles some row of this block can see
  const int q_last = min(q0 + P::BQ, sq) - 1;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? min(skv, q_last + 1) : skv;
  const int t_lo = k_lo / BN;
  const int t_hi = (k_hi + BN - 1) / BN;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < P::STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4 * P::CONSUMERS);  // a warp each
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
      hopper::mbar_expect_tx(q_full, P::CONSUMERS * P::Q_BYTES);
      for (int c = 0; c < P::CONSUMERS; ++c)
        for (int b = 0; b < P::BOXES; ++b)
          hopper::tma_load_3d(s_q + c * P::Q_BYTES + b * P::BM * 128, &map_q,
                              q_full, 64 * b, q0 + c * P::BM, bh);
      const int kvh = bh / group;
      for (int t = t_lo, i = 0; t < t_hi; ++t, ++i) {
        const int st = i % P::STAGES;
        hopper::mbar_wait(&empty[st], ((i / P::STAGES) & 1) ^ 1);
        hopper::mbar_expect_tx(&full[st], 2 * P::KV_BYTES);
        uint8_t* sk = s_kv + st * 2 * P::KV_BYTES;
        for (int b = 0; b < P::BOXES; ++b) {
          hopper::tma_load_3d(sk + b * BN * 128, &map_k, &full[st], 64 * b,
                              t * BN, kvh);
          hopper::tma_load_3d(sk + P::KV_BYTES + b * BN * 128, &map_v,
                              &full[st], 64 * b, t * BN, kvh);
        }
      }
    }
    return;
  }

  // consumer warpgroup c: q rows q0 + 64 c ..; this thread's rows r0 and
  // r0 + 8, its columns 8 j + 2 (lane % 4) + {0, 1} of every 8
  hopper::regs_inc<232>();
  const int c = threadIdx.x / 128 - 1;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int qa = q0 + c * P::BM;               // first row of this consumer
  const int r0 = qa + warp * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  const uint8_t* s_qc = s_q + c * P::Q_BYTES;
  const float scale2 = sm_scale * LOG2E;  // scores in log2 units

  float o[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) o[i] = 0.0f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.0f, 0.0f};  // this thread's part of the row sums

  hopper::mbar_wait(q_full, 0);
  for (int t = t_lo, i = 0; t < t_hi; ++t, ++i) {
    const int st = i % P::STAGES;
    const int k0 = t * BN;
    // a tile no row of this consumer sees leaves m, l and o as they are
    const bool dead = k0 >= skv || (causal && k0 > qa + P::BM - 1)
                      || (window > 0 && k0 + BN - 1 <= qa - window);
    const bool whole = k0 + BN <= skv && (!causal || k0 + BN - 1 <= qa)
                       && (window <= 0 || k0 > qa + P::BM - 1 - window);
    hopper::mbar_wait(&full[st], (i / P::STAGES) & 1);
    if (!dead) {
      const uint8_t* sk = s_kv + st * 2 * P::KV_BYTES;
      const uint8_t* sv = sk + P::KV_BYTES;
      float s[BN / 2];
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk) {
        const int box = kk / 4, off = (kk % 4) * 32;
        hopper::WgmmaSS<BN, 0, 0>::run(
            s,
            hopper::desc_sw128(s_qc + box * P::BM * 128 + off, 16, 1024),
            hopper::desc_sw128(sk + box * BN * 128 + off, 16, 1024),
            kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs<BN / 2>(s);

      // scores in log2 units, the mask (only on a tile that crosses the
      // diagonal, the window's edge or kv_len), the online softmax
      float corr[2];
      if (whole)
        scores<BN, false, CAP>(s, r0, k0 + cq, skv, causal, window,
                               sm_scale, scale2, softcap);
      else
        scores<BN, true, CAP>(s, r0, k0 + cq, skv, causal, window,
                              sm_scale, scale2, softcap);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = NEG_INF;
#pragma unroll
        for (int j = 0; j < BN / 4; ++j)
          mx = fmaxf(mx, s[4 * (j / 2) + 2 * h + j % 2]);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[h], mx);
        // while a row has seen no key, m is -1e30: subtract 0 so that its
        // masked scores give p = exp2(-1e30) = 0 (o and l are still 0)
        const float m_use = m_new == NEG_INF ? 0.0f : m_new;
        corr[h] = exp2f(m[h] - m_use);
        m[h] = m_new;
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < BN / 4; ++j) {
          const int idx = 4 * (j / 2) + 2 * h + j % 2;
          s[idx] = exp2f(s[idx] - m_use);
          sum += s[idx];
        }
        l[h] = __fmaf_rn(corr[h], l[h], sum);
      }
#pragma unroll
      for (int j = 0; j < HDP / 8; ++j) {
        o[4 * j + 0] *= corr[0];
        o[4 * j + 1] *= corr[0];
        o[4 * j + 2] *= corr[1];
        o[4 * j + 3] *= corr[1];
      }

      // o += p . v: p, rounded to bf16, is already the A fragment
      hopper::fence_regs<HDP / 2>(o);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        const uint32_t a0 = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
        const uint32_t a1 = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        const uint32_t a2 = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        const uint32_t a3 = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
        const uint8_t* vk = sv + kk * 16 * 128;
        if constexpr (HDP == 64) {
          hopper::WgmmaRS<64, 1>::run(
              o, a0, a1, a2, a3, hopper::desc_sw128(vk, BN * 128, 1024), 1);
        } else {
#pragma unroll
          for (int half = 0; half < HDP / 128; ++half)
            hopper::WgmmaRS<128, 1>::run(
                o + 64 * half, a0, a1, a2, a3,
                hopper::desc_sw128(vk + half * 2 * BN * 128, BN * 128, 1024),
                1);
        }
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs<HDP / 2>(o);
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[st]);
  }

  __nv_bfloat16* ob = out + (long long)bh * sq * hd;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lr = l[h];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const float denom = lr == 0.0f ? 1.0f : lr;
    const int r = r0 + 8 * h;
    if (r >= sq) continue;
    if constexpr (LSE) {
      if (lane % 4 == 0)
        lse[(long long)bh * sq_pad + r] = lr > 0.0f ? m[h] + log2f(lr) : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j) {
      const int col = 8 * j + cq;
      if (col < hd)
        *reinterpret_cast<__nv_bfloat162*>(ob + (long long)r * hd + col) =
            __floats2bfloat162_rn(o[4 * j + 2 * h] / denom,
                                  o[4 * j + 2 * h + 1] / denom);
    }
  }
}

template <int HDP, bool LSE>
int launch_bf16_hd(const void* q, const void* k, const void* v, void* out,
                   int bhq, int bhkv, int sq, int skv, int hd, int causal,
                   int window, float sm_scale, float softcap, float* lse,
                   int sq_pad, cudaStream_t stream) {
  using P = FlashBf16<HDP>;
  CUtensorMap map_q, map_k, map_v;
  int rc = hopper::make_map_bf16(&map_q, q, hd, sq, bhq, P::BM);
  if (rc == 0) rc = hopper::make_map_bf16(&map_k, k, hd, skv, bhkv, P::BN);
  if (rc == 0) rc = hopper::make_map_bf16(&map_v, v, hd, skv, bhkv, P::BN);
  if (rc != 0) return rc;
  auto kern = softcap > 0.0f ? flash_bf16_kernel<HDP, true, LSE>
                             : flash_bf16_kernel<HDP, false, LSE>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((sq + P::BQ - 1) / P::BQ), (unsigned)bhq);
  kern<<<grid, P::THREADS, P::SMEM, stream>>>(
      map_q, map_k, map_v, static_cast<__nv_bfloat16*>(out), bhq / bhkv, sq,
      skv, hd, causal, window, sm_scale, softcap, lse, sq_pad);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes.  Returns the cudaError_t of the launch (0 on
// success) or a negative code of hopper::make_map_bf16; the caller checks
// the shapes (1 <= hd <= 256, BHq a multiple of BHkv, BHq <= 65535; bf16:
// hd a multiple of 8, 16-byte aligned bases; float32: 1 <= block_q,
// block_k <= 64, which bf16 ignores: its tiles are fixed).
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* out, int bhq,
                                    int bhkv, int sq, int skv, int hd,
                                    int block_q, int block_k, int causal,
                                    int window, float sm_scale, float softcap,
                                    void* stream) {
  (void)block_q;
  (void)block_k;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd <= 64)
    return launch_bf16_hd<64, false>(q, k, v, out, bhq, bhkv, sq, skv, hd,
                                     causal, window, sm_scale, softcap,
                                     nullptr, 0, st);
  if (hd <= 128)
    return launch_bf16_hd<128, false>(q, k, v, out, bhq, bhkv, sq, skv, hd,
                                      causal, window, sm_scale, softcap,
                                      nullptr, 0, st);
  return launch_bf16_hd<256, false>(q, k, v, out, bhq, bhkv, sq, skv, hd,
                                    causal, window, sm_scale, softcap,
                                    nullptr, 0, st);
}

// The same forward, also writing each row's log-sum-exp (log2 units) to
// lse (BHq, sq_pad) float32, sq_pad = Sq rounded up to a multiple of 64
// (rows past Sq are left as they are): for the tensor-core backward, so
// hd 64, 128 or 256 only (another returns cudaErrorInvalidValue).
extern "C" int flash_attention_bf16_lse(const void* q, const void* k,
                                        const void* v, void* out, void* lse,
                                        int bhq, int bhkv, int sq, int skv,
                                        int hd, int causal, int window,
                                        float sm_scale, float softcap,
                                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  const int sq_pad = (sq + 63) / 64 * 64;
  if (hd == 64)
    return launch_bf16_hd<64, true>(q, k, v, out, bhq, bhkv, sq, skv, hd,
                                    causal, window, sm_scale, softcap, l,
                                    sq_pad, st);
  if (hd == 128)
    return launch_bf16_hd<128, true>(q, k, v, out, bhq, bhkv, sq, skv, hd,
                                     causal, window, sm_scale, softcap, l,
                                     sq_pad, st);
  if (hd == 256)
    return launch_bf16_hd<256, true>(q, k, v, out, bhq, bhkv, sq, skv, hd,
                                     causal, window, sm_scale, softcap, l,
                                     sq_pad, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* out, int bhq,
                                   int bhkv, int sq, int skv, int hd,
                                   int block_q, int block_k, int causal,
                                   int window, float sm_scale, float softcap,
                                   void* stream) {
  return launch_f32(q, k, v, out, bhq, bhkv, sq, skv, hd, block_q,
                    block_k, causal, window, sm_scale, softcap, stream);
}

extern "C" const char* flash_attention_error_string(int code) {
  return hopper::error_string(code);
}
