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
// Grid (B * H): one block per (batch, head), HD threads (the head dim
// rounded up to 32, 64 or 128).  The TPU grid's sequential chunk axis is
// the token loop inside the block here, because CUDA blocks run in no
// order.  Thread j owns column j of the state, HD floats in registers.
// Every TOKENS tokens, the block stages r, k, v, exp(log_w) and r * u * k
// of those tokens in shared memory (all float32) with one barrier, then
// each thread walks them without one: for each token it reads the staged
// rows four at a time (16-byte loads of the same words for every thread, a
// broadcast), accumulates y_j and the bonus in four partial sums, and
// updates its column.  Any S works (the last group of tokens may be
// short), head dims up to 128 (the rows are padded to 32, 64 or 128 and
// the padding never read).
//
// Why the per-token recurrence and not the TPU kernel's chunked form: on
// the card the state fits in registers (a column a thread), so a token
// costs about 4 hd^2 float32 operations for the whole head, where the
// chunked form spends some chunk times more on its intra-chunk pair
// tensor to turn the recurrence into matrix products for the MXU.  The
// recurrence also needs no exp of a cumulated log-decay, so fast decay
// (log_w = -15, or the model's clip at -exp(8)) only drives terms to 0.
// Products use explicit fused multiply-adds (__fmaf_rn), which
// --fmad=false leaves alone; exp is the accurate one.
//
// Bound on an H100 SXM at the serve shape (B = 4, S = 512, H = 64,
// hd = 64; r, k, v, y bf16, log_w float32): 105 MB moved (inputs read
// once, y and the final state written once), 0.031 ms at 3.35 TB/s; about
// 4 hd^2 operations per token and head, 2.1 GFLOP, 0.032 ms at the 67
// TFLOP/s float32 peak.  What bounds this design is neither: 256 blocks of
// 64 threads are two warps a block, some four an SM, so each SM issues
// from few warps and waits on its shared-memory reads and on each token's
// chain of dependent operations.  The 16-byte reads of the staged rows
// (four rows an instruction, not one) and the four partial sums shorten
// both; splitting a head's state over more warps (rows of the state, y
// summed across them) is a later step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TOKENS = 16;     // tokens staged in shared memory at a time

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

template <typename T, int HD>
__global__ void __launch_bounds__(HD)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ log_w,
            const float* __restrict__ u, T* __restrict__ y,
            float* __restrict__ state, int S, int H, int hd) {
  __shared__ __align__(16) float sr[TOKENS][HD];
  __shared__ __align__(16) float sk[TOKENS][HD];
  __shared__ __align__(16) float sv[TOKENS][HD];
  __shared__ __align__(16) float sw[TOKENS][HD];
  __shared__ __align__(16) float sb[TOKENS][HD];  // r u k, into the bonus

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int j = threadIdx.x;
  const float* uh = u + (size_t)h * hd;

  float s[HD];                      // column j of the state: s[i] = S[i][j]
#pragma unroll
  for (int i = 0; i < HD; ++i) s[i] = 0.0f;

  for (int t0 = 0; t0 < S; t0 += TOKENS) {
    const int n = min(TOKENS, S - t0);
    __syncthreads();                // the previous group is consumed
    for (int e = j; e < n * hd; e += HD) {
      const int tt = e / hd;
      const int i = e - tt * hd;
      const size_t g = (((size_t)b * S + t0 + tt) * H + h) * hd + i;
      const float rr = widen(r[g]);
      const float kk = widen(k[g]);
      sr[tt][i] = rr;
      sk[tt][i] = kk;
      sv[tt][i] = widen(v[g]);
      sw[tt][i] = expf(log_w[g]);
      sb[tt][i] = __fmul_rn(__fmul_rn(rr, uh[i]), kk);
    }
    __syncthreads();
    if (j < hd) {
      for (int tt = 0; tt < n; ++tt) {
        const float vj = sv[tt][j];
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        float bonus[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        // rows i .. i + 3 of the staged token in one 16-byte load each;
        // row i goes to partial sum i % 4
#pragma unroll
        for (int i4 = 0; i4 < HD / 4; ++i4) {
          const float4 r4 = reinterpret_cast<const float4*>(sr[tt])[i4];
          const float4 k4 = reinterpret_cast<const float4*>(sk[tt])[i4];
          const float4 w4 = reinterpret_cast<const float4*>(sw[tt])[i4];
          const float4 b4 = reinterpret_cast<const float4*>(sb[tt])[i4];
          const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
          const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
          const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
          const float bb[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int i = 4 * i4 + c;
            if (i < hd) {
              acc[c] = __fmaf_rn(rr[c], s[i], acc[c]);
              bonus[c] = __fadd_rn(bonus[c], bb[c]);
              s[i] = __fmaf_rn(ww[c], s[i], __fmul_rn(kk[c], vj));
            }
          }
        }
        const float a = __fadd_rn(__fadd_rn(acc[0], acc[1]),
                                  __fadd_rn(acc[2], acc[3]));
        const float bo = __fadd_rn(__fadd_rn(bonus[0], bonus[1]),
                                   __fadd_rn(bonus[2], bonus[3]));
        const size_t g = (((size_t)b * S + t0 + tt) * H + h) * hd + j;
        y[g] = narrow<T>(__fmaf_rn(bo, vj, a));
      }
    }
  }
  if (j < hd) {
    float* out = state + (size_t)bh * hd * hd + j;
#pragma unroll
    for (int i = 0; i < HD; ++i)
      if (i < hd) out[(size_t)i * hd] = s[i];
  }
}

template <typename T, int HD>
int launch_hd(const void* r, const void* k, const void* v, const float* lw,
              const float* u, void* y, float* state, int B, int S, int H,
              int hd, cudaStream_t stream) {
  wkv6_kernel<T, HD><<<(unsigned)(B * H), HD, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), lw, u, static_cast<T*>(y), state, S, H, hd);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* lw,
           const void* u, void* y, void* state, int B, int S, int H, int hd,
           void* stream) {
  if (hd < 1 || hd > 128) return (int)cudaErrorInvalidValue;
  const float* lwf = static_cast<const float*>(lw);
  const float* uf = static_cast<const float*>(u);
  float* st = static_cast<float*>(state);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd <= 32) return launch_hd<T, 32>(r, k, v, lwf, uf, y, st, B, S, H, hd, s);
  if (hd <= 64) return launch_hd<T, 64>(r, k, v, lwf, uf, y, st, B, S, H, hd, s);
  return launch_hd<T, 128>(r, k, v, lwf, uf, y, st, B, S, H, hd, s);
}

}  // namespace

extern "C" int wkv6_bf16(const void* r, const void* k, const void* v,
                         const void* log_w, const void* u, void* y,
                         void* state, int B, int S, int H, int hd,
                         void* stream) {
  return launch<__nv_bfloat16>(r, k, v, log_w, u, y, state, B, S, H, hd,
                               stream);
}

extern "C" int wkv6_f32(const void* r, const void* k, const void* v,
                        const void* log_w, const void* u, void* y,
                        void* state, int B, int S, int H, int hd,
                        void* stream) {
  return launch<float>(r, k, v, log_w, u, y, state, B, S, H, hd, stream);
}

extern "C" const char* wkv6_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
