// WKV6 (RWKV6 "Finch") forward pass: the linear recurrence with per-channel
// data-dependent decay and the current-token bonus u, carrying an (hd x hd)
// float32 state per (batch, head) through the sequence:
//
//   y_t[j]  = sum_i r_t[i] S[i][j] + (sum_i r_t[i] u[i] k_t[i]) v_t[j]
//   S[i][j] <- exp(log_w_t[i]) S[i][j] + k_t[i] v_t[j]
//
// Replaces the Pallas TPU kernel repro/kernels/rwkv6/kernel.py:66
// (wkv6_fwd -> _wkv6_kernel, :22), which computes the same function in its
// chunked form (64 tokens a grid step, the state in VMEM scratch across the
// sequential chunk axis).  It computes what
// repro_torch/kernels/rwkv6/ref.py::reference_wkv6 (the sequential oracle)
// and ::wkv6_chunked (the chunked plain version) compute, and also writes
// the final state, which _wkv6_kernel leaves in its scratch and the model's
// decode starts from.
//
// Layout, all contiguous, the model's (no fold, no copies): r, k, v
// (B, S, H, hd) in T (bf16 or float32), log_w (B, S, H, hd) float32, u
// (H, hd) float32; y (B, S, H, hd) in T, state (B, H, hd, hd) float32.
// Grid (B * H): one block per (batch, head); the TPU grid's sequential
// chunk axis is the token loop inside the block, because CUDA blocks run
// in no order.  The head dim is padded to HD = 32, 64 or 128 (the padding
// staged as 0, so it adds exactly nothing).  The state is spread over
// GROUPS = 8 row groups: thread (g, j) holds rows g HD/8 .. (g+1) HD/8 - 1
// of columns j and j + HD/2 in registers (4 HD threads; 256 threads and 16
// floats a thread at hd 64), so a row read from shared memory serves two
// columns.  Every TOKENS tokens: (1) the raw r, k, v and log_w of the next
// group are already on their way into the other half of a double buffer
// (cp.async, 16 bytes a copy, where rows and pointers are 16-byte aligned;
// plain loads otherwise); (2) after a barrier the block converts this
// group to float32 r, k, v, exp(log_w) and r u k; (3) after a barrier one
// thread in each THREADS / TOKENS adds up a token's bonus sum_i r u k in i
// order, and every thread walks the tokens, reading its rows four at a
// time (16-byte broadcast loads), updating its state and writing its row
// group's partial y of each column; (4) after a barrier the threads take
// the (token, column) pairs, add the 8 partials in a fixed tree order and
// the bonus times v, and write y.  Any S works (the last group may be
// short), head dims up to 128.
//
// The recurrence is the per-token one, not the TPU kernel's chunked form:
// on the card the state fits in registers, so a token costs about 4 hd^2
// float32 operations for the whole head, where the chunked form spends
// some chunk times more on its intra-chunk pair tensor to turn the
// recurrence into matrix products for the MXU, and needs exp of a
// cumulated log-decay, which is inexact at the model's clip -exp(8).
// Each state element is updated as S = fma(w, S, k v) with k v rounded,
// the same operations in the same order as the first version of this
// kernel, so the final state does not depend on the thread layout; only
// y's summation order does.  Products use explicit fused multiply-adds
// (__fmaf_rn), which --fmad=false leaves alone; exp is the accurate one.
//
// Bound on an H100 SXM at the serve shape (B = 4, S = 512, H = 64,
// hd = 64; r, k, v, y bf16, log_w float32): 105 MB moved (inputs read
// once, y and the final state written once), 0.031 ms at 3.35 TB/s; about
// 4 hd^2 operations per token and head, 2.1 GFLOP, 0.032 ms at the 67
// TFLOP/s float32 peak.  What bounded the first version: a column of the
// state a thread, so 256 blocks of two warps, some four warps an SM, one a
// scheduler, waiting on shared-memory reads and each token's chain of
// dependent operations, with every load of a group of tokens behind a
// barrier.  This design brings 8 warps a block (some 16 an SM) and loads
// the next tokens under the compute of these.  What bounds it, measured on
// an H100 80GB HBM3 at 700 W by kernel_probe.py: leaving the token walk
// out saves 0.085 of its 0.162 ms (48 float32 operations a thread and
// token, at 16 warps an SM); leaving out the staging, the conversion or
// the combine saves 0.025, 0.011 and 0.011 ms, so they do not overlap the
// walk.  Moving them to helper warps, spreading the
// state over 16 row groups or giving a thread 4 or 8 columns was slower
// on the same card: their instructions compete for the same issue slots,
// and fewer warps hide less latency.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TOKENS = 16;     // tokens staged in shared memory at a time
constexpr int GROUPS = 8;      // row groups of the state

template <typename T, int HD>
struct Wkv {
  static constexpr int THREADS = GROUPS * HD / 2;
  static constexpr int ROWS = HD / GROUPS;     // rows of the state a thread
  static constexpr int TILE = TOKENS * HD;     // one staged array
  // raw log_w (x2), converted r, k, v, w, ruk, partial y (x GROUPS), u,
  // the bonus of each token; then raw r, k, v (x2 each) in T
  static constexpr size_t SMEM =
      sizeof(float) * ((2 + 5 + GROUPS) * TILE + HD + TOKENS)
      + sizeof(T) * 6 * TILE;
};

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// n rows of hd elements, `stride` elements apart, into dst (rows HD apart):
// asynchronous 16-byte copies when `vec`, else synchronous element copies
template <int HD, int THREADS, typename E>
__device__ __forceinline__ void stage(E* dst, const E* __restrict__ src,
                                      long long stride, int n, int hd,
                                      bool vec) {
  if (vec) {
    constexpr int PER = 16 / sizeof(E);
    const int chunks = hd / PER;
    for (int c = threadIdx.x; c < n * chunks; c += THREADS) {
      const int tt = c / chunks;
      const int q = (c - tt * chunks) * PER;
      cp_async16(dst + tt * HD + q, src + tt * stride + q);
    }
  } else {
    for (int e = threadIdx.x; e < n * hd; e += THREADS) {
      const int tt = e / hd;
      const int i = e - tt * hd;
      dst[tt * HD + i] = src[tt * stride + i];
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(Wkv<T, HD>::THREADS)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ log_w,
            const float* __restrict__ u, T* __restrict__ y,
            float* __restrict__ state, int S, int H, int hd, bool vec) {
  using P = Wkv<T, HD>;
  constexpr int THREADS = P::THREADS, ROWS = P::ROWS, TILE = P::TILE;
  extern __shared__ __align__(16) unsigned char smem[];
  float* raw_w = reinterpret_cast<float*>(smem);   // [2][TOKENS][HD]
  float* sr = raw_w + 2 * TILE;                    // [TOKENS][HD] each
  float* sk = sr + TILE;
  float* sv = sk + TILE;
  float* sw = sv + TILE;                           // exp(log_w)
  float* sb = sw + TILE;                           // r u k, into the bonus
  float* py = sb + TILE;                           // [TOKENS][GROUPS][HD]
  float* su = py + GROUPS * TILE;                  // [HD]
  float* s_bo = su + HD;                           // [TOKENS]
  T* raw_r = reinterpret_cast<T*>(s_bo + TOKENS);  // [2][TOKENS][HD] each
  T* raw_k = raw_r + 2 * TILE;
  T* raw_v = raw_k + 2 * TILE;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int tid = threadIdx.x;
  const int g = tid / (HD / 2);                    // row group
  const int j0 = tid - g * (HD / 2), j1 = j0 + HD / 2;
  const int row0 = g * ROWS;
  const long long stride = (long long)H * hd;      // token to token
  const size_t base = ((size_t)b * S * H + h) * hd;

  for (int i = tid; i < HD; i += THREADS)
    su[i] = i < hd ? u[(size_t)h * hd + i] : 0.0f;
  auto stage_group = [&](int t0, int buf) {
    const int n = min(TOKENS, S - t0);
    const size_t off = base + (size_t)t0 * stride;
    stage<HD, THREADS>(raw_r + buf * TILE, r + off, stride, n, hd, vec);
    stage<HD, THREADS>(raw_k + buf * TILE, k + off, stride, n, hd, vec);
    stage<HD, THREADS>(raw_v + buf * TILE, v + off, stride, n, hd, vec);
    stage<HD, THREADS>(raw_w + buf * TILE, log_w + off, stride, n, hd, vec);
  };

  float s0[ROWS], s1[ROWS];         // s0[l] = S[row0 + l][j0], s1: j1
#pragma unroll
  for (int l = 0; l < ROWS; ++l) s0[l] = s1[l] = 0.0f;

  const int n_groups = (S + TOKENS - 1) / TOKENS;
  if (n_groups > 0) stage_group(0, 0);
  cp_async_commit();
  for (int grp = 0; grp < n_groups; ++grp) {
    const int t0 = grp * TOKENS;
    const int n = min(TOKENS, S - t0);
    const int buf = grp & 1;
    if (grp + 1 < n_groups) stage_group(t0 + TOKENS, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();             // this group's copies (this thread's)
    __syncthreads();                // everyone's; the last group consumed
    for (int e = tid; e < n * HD; e += THREADS) {
      const int i = e % HD;
      const int o = buf * TILE + e;
      float rr = 0.0f, kk = 0.0f, vv = 0.0f, ww = 0.0f, bb = 0.0f;
      if (i < hd) {
        rr = widen(raw_r[o]);
        kk = widen(raw_k[o]);
        vv = widen(raw_v[o]);
        ww = expf(raw_w[o]);
        bb = __fmul_rn(__fmul_rn(rr, su[i]), kk);
      }
      sr[e] = rr;
      sk[e] = kk;
      sv[e] = vv;
      sw[e] = ww;
      sb[e] = bb;
    }
    __syncthreads();
    // the bonus sum_i r u k of token tt, in i order, by one thread in each
    // THREADS / TOKENS
    if (tid % (THREADS / TOKENS) == 0 && tid / (THREADS / TOKENS) < n) {
      const float* b_row = sb + (tid / (THREADS / TOKENS)) * HD;
      float bo = 0.0f;
#pragma unroll
      for (int i = 0; i < HD; ++i) bo = __fadd_rn(bo, b_row[i]);
      s_bo[tid / (THREADS / TOKENS)] = bo;
    }
    for (int tt = 0; tt < n; ++tt) {
      const float v0 = sv[tt * HD + j0], v1 = sv[tt * HD + j1];
      float a0[2] = {0.0f, 0.0f}, a1[2] = {0.0f, 0.0f};
#pragma unroll
      for (int i4 = 0; i4 < ROWS / 4; ++i4) {
        const int at = tt * HD + row0 + 4 * i4;
        const float4 r4 = *reinterpret_cast<const float4*>(sr + at);
        const float4 k4 = *reinterpret_cast<const float4*>(sk + at);
        const float4 w4 = *reinterpret_cast<const float4*>(sw + at);
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
        const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int l = 4 * i4 + c;
          a0[c & 1] = __fmaf_rn(rr[c], s0[l], a0[c & 1]);
          a1[c & 1] = __fmaf_rn(rr[c], s1[l], a1[c & 1]);
          s0[l] = __fmaf_rn(ww[c], s0[l], __fmul_rn(kk[c], v0));
          s1[l] = __fmaf_rn(ww[c], s1[l], __fmul_rn(kk[c], v1));
        }
      }
      float* p = py + (tt * GROUPS + g) * HD;
      p[j0] = __fadd_rn(a0[0], a0[1]);
      p[j1] = __fadd_rn(a1[0], a1[1]);
    }
    __syncthreads();
    // y of each (token, column): the 8 partials in a fixed tree order, and
    // the bonus
    for (int e = tid; e < n * HD; e += THREADS) {
      const int tt = e / HD;
      const int j = e - tt * HD;
      if (j < hd) {
        float part[GROUPS];
#pragma unroll
        for (int gg = 0; gg < GROUPS; ++gg)
          part[gg] = py[(tt * GROUPS + gg) * HD + j];
#pragma unroll
        for (int w = 1; w < GROUPS; w *= 2)
#pragma unroll
          for (int gg = 0; gg < GROUPS; gg += 2 * w)
            part[gg] = __fadd_rn(part[gg], part[gg + w]);
        y[base + (size_t)(t0 + tt) * stride + j] =
            narrow<T>(__fmaf_rn(s_bo[tt], sv[e], part[0]));
      }
    }
  }
  float* out = state + (size_t)bh * hd * hd;
#pragma unroll
  for (int l = 0; l < ROWS; ++l) {
    const int i = row0 + l;
    if (i < hd) {
      if (j0 < hd) out[(size_t)i * hd + j0] = s0[l];
      if (j1 < hd) out[(size_t)i * hd + j1] = s1[l];
    }
  }
}

template <typename T, int HD>
int launch_hd(const void* r, const void* k, const void* v, const float* lw,
              const float* u, void* y, float* state, int B, int S, int H,
              int hd, int threads, int smem, cudaStream_t stream) {
  using P = Wkv<T, HD>;
  if (threads != P::THREADS || (size_t)smem != P::SMEM)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(r)
      | reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)
      | reinterpret_cast<uintptr_t>(lw);
  const bool vec = (hd * sizeof(T)) % 16 == 0 && hd % 4 == 0
      && ptrs % 16 == 0;
  wkv6_kernel<T, HD><<<(unsigned)(B * H), P::THREADS, P::SMEM, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), lw, u, static_cast<T*>(y), state, S, H, hd,
      vec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* lw,
           const void* u, void* y, void* state, int B, int S, int H, int hd,
           int threads, int smem, void* stream) {
  if (hd < 1 || hd > 128) return (int)cudaErrorInvalidValue;
  const float* lwf = static_cast<const float*>(lw);
  const float* uf = static_cast<const float*>(u);
  float* st = static_cast<float*>(state);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd <= 32)
    return launch_hd<T, 32>(r, k, v, lwf, uf, y, st, B, S, H, hd, threads,
                            smem, s);
  if (hd <= 64)
    return launch_hd<T, 64>(r, k, v, lwf, uf, y, st, B, S, H, hd, threads,
                            smem, s);
  return launch_hd<T, 128>(r, k, v, lwf, uf, y, st, B, S, H, hd, threads,
                           smem, s);
}

}  // namespace

// Plain C interface for ctypes.  `threads` and `smem` are kernel.py::
// launch_geometry's; a launch they do not describe is refused with
// cudaErrorInvalidValue.  Returns the cudaError_t of the launch.
extern "C" int wkv6_bf16(const void* r, const void* k, const void* v,
                         const void* log_w, const void* u, void* y,
                         void* state, int B, int S, int H, int hd,
                         int threads, int smem, void* stream) {
  return launch<__nv_bfloat16>(r, k, v, log_w, u, y, state, B, S, H, hd,
                               threads, smem, stream);
}

extern "C" int wkv6_f32(const void* r, const void* k, const void* v,
                        const void* log_w, const void* u, void* y,
                        void* state, int B, int S, int H, int hd,
                        int threads, int smem, void* stream) {
  return launch<float>(r, k, v, log_w, u, y, state, B, S, H, hd, threads,
                       smem, stream);
}

extern "C" const char* wkv6_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

