// Flash attention, forward pass: online-softmax attention over kv tiles with
// float32 (m, l, acc), GQA, causal and sliding-window masks and the gemma2
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
//   l'  = c * l + sum_j p;  acc' = acc * c + p . v
//   out = acc / (l == 0 ? 1 : l)              (a row that sees no key is 0)
//
// q_pos and k_pos are row indices from 0, as in the TPU kernel.  Everything
// is float32 (bf16 inputs are widened on load, the output is rounded once);
// products accumulate with explicit fused multiply-adds (__fmaf_rn), which
// --fmad=false leaves alone.  exp, tanh and the final division are the
// accurate ones (no fast math).
//
// Layout, all contiguous: q (BHq, Sq, hd), k and v (BHkv, Skv, hd), out
// (BHq, Sq, hd) in q's type; q row block bh reads kv row block bh / group
// (group = BHq / BHkv), the kv-major GQA fold of ops.py.  Grid
// (ceil(Sq / block_q), BHq): one block of 256 threads per (q tile, bh).
// The TPU grid's sequential kv axis (ki, carrying m, l and acc in VMEM) is
// a loop inside the block here, because CUDA blocks run in no order.  A kv
// tile that the causal or window mask hides from every row of the q tile is
// skipped: there p = 0 and c = 1, so the result is the same.  Padded kv
// rows (past Skv) and q rows (past Sq) are never read: the shared tiles are
// zero there (the TPU kernel's 0 * NaN guard), and masked.
//
// Shared memory per block: the q tile, the k tile (rows padded by one word
// against bank conflicts), the v tile, the score tile and the row
// statistics, all float32: 113.5 KB at head dim 128 (set with
// cudaFuncSetAttribute, above the 48 KB default).  Each thread keeps an
// 8 x (HDMAX / 32) slice of acc in registers.
//
// Bound on an H100 SXM: at the serve shape (B = 4, Hq = 32, Hkv = 4, S =
// 512, hd = 128, causal, bf16) the visible (q, k) pairs need 8.6 GFLOP
// against 37.7 MB of q, k, v and out: 0.0087 ms at the bf16 tensor-core
// peak, 0.0113 ms at 3.35 TB/s, so bytes bound it.  This kernel runs on the
// float32 cores (67 TFLOP/s peak, 0.13 ms for the same work), since the TPU
// kernel's arithmetic is float32 throughout; it is far from its bound by
// design.  What the design does: every q, k and v element is read from
// device memory once per (q tile, kv tile) and reused from shared memory 64
// times, and causal tiles above the diagonal are skipped, halving the work.
// Tensor cores (mma / wgmma on bf16 q, k and p) are a later step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 64;       // q rows and kv rows per tile, at most
constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

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

template <typename T, int HDMAX>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int group,
                 int sq, int skv, int hd, int block_q, int block_k,
                 int causal, int window, float sm_scale, float softcap) {
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
  const T* qb = q + ((long long)bh * sq + q0) * hd;
  const T* kb = k + (long long)(bh / group) * skv * hd;
  const T* vb = v + (long long)(bh / group) * skv * hd;

  for (int e = tid; e < TILE * HDMAX; e += THREADS) {
    const int r = e / HDMAX, c = e % HDMAX;
    s_q[r * QK + c] =
        (r < rows && c < hd) ? widen(qb[(long long)r * hd + c]) : 0.0f;
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
      s_k[r * QK + c] = live ? widen(kb[g]) : 0.0f;
      s_v[r * HDMAX + c] = live ? widen(vb[g]) : 0.0f;
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

  T* ob = out + ((long long)bh * sq + q0) * hd;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = rg * 8 + i;
    if (r >= rows) continue;
    const float l = s_l[r];
    const float denom = l == 0.0f ? 1.0f : l;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = cg + 32 * j;
      if (c < hd) ob[(long long)r * hd + c] = narrow<T>(acc[i][j] / denom);
    }
  }
}

template <typename T, int HDMAX>
int launch_hd(const T* q, const T* k, const T* v, T* out, int bhq, int bhkv,
              int sq, int skv, int hd, int block_q, int block_k, int causal,
              int window, float sm_scale, float softcap,
              cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HDMAX>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HDMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((sq + block_q - 1) / block_q), (unsigned)bhq);
  flash_fwd_kernel<T, HDMAX><<<grid, THREADS, smem, stream>>>(
      q, k, v, out, bhq / bhkv, sq, skv, hd, block_q, block_k, causal, window,
      sm_scale, softcap);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int bhq,
           int bhkv, int sq, int skv, int hd, int block_q, int block_k,
           int causal, int window, float sm_scale, float softcap,
           void* stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd <= 32)
    return launch_hd<T, 32>(qt, kt, vt, ot, bhq, bhkv, sq, skv, hd, block_q,
                            block_k, causal, window, sm_scale, softcap, st);
  if (hd <= 64)
    return launch_hd<T, 64>(qt, kt, vt, ot, bhq, bhkv, sq, skv, hd, block_q,
                            block_k, causal, window, sm_scale, softcap, st);
  if (hd <= 128)
    return launch_hd<T, 128>(qt, kt, vt, ot, bhq, bhkv, sq, skv, hd, block_q,
                             block_k, causal, window, sm_scale, softcap, st);
  return launch_hd<T, 256>(qt, kt, vt, ot, bhq, bhkv, sq, skv, hd, block_q,
                           block_k, causal, window, sm_scale, softcap, st);
}

}  // namespace

// Plain C interface for ctypes.  Returns the cudaError_t of the launch (0 on
// success); the caller checks the shapes (1 <= hd <= 256, 1 <= block_q,
// block_k <= 64, BHq a multiple of BHkv, BHq <= 65535).
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* out, int bhq,
                                    int bhkv, int sq, int skv, int hd,
                                    int block_q, int block_k, int causal,
                                    int window, float sm_scale, float softcap,
                                    void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, bhq, bhkv, sq, skv, hd, block_q,
                               block_k, causal, window, sm_scale, softcap,
                               stream);
}

extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* out, int bhq,
                                   int bhkv, int sq, int skv, int hd,
                                   int block_q, int block_k, int causal,
                                   int window, float sm_scale, float softcap,
                                   void* stream) {
  return launch<float>(q, k, v, out, bhq, bhkv, sq, skv, hd, block_q,
                       block_k, causal, window, sm_scale, softcap, stream);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
