// RG-LRU scan (Griffin / RecurrentGemma): the gated diagonal linear
// recurrence h_t = exp(log_a_t) h_{t-1} + b_t, elementwise over the rnn
// width, from h_0 = 0.
//
// Replaces the Pallas TPU kernel repro/kernels/rglru/kernel.py:55
// (rglru_fwd -> _rglru_kernel, :25), which evaluates the recurrence in
// closed form over 64-token chunks (a (chunk x chunk) decay-ratio tensor
// per width block, the running h in VMEM scratch across the sequential
// chunk axis).  It computes what
// repro_torch/kernels/rglru/ref.py::reference_rglru computes, step by
// step in the same order (a multiply, then an add), in float32.
//
// Layout, all contiguous: log_a (B, S, W) float32, b (B, S, W) in T (bf16
// or float32); h (B, S, W) in T.  The model's path launches rglru_f32
// only: models/rglru.py computes the gates, and so b, in float32 whatever
// the weights' dtype.  rglru_bf16 keeps the TPU kernel's dtype contract (h
// in b's dtype, bf16 b included) for callers of ops.rglru_scan_op.  Grid (ceil(W / 64), B): one thread per
// (batch, channel), neighbouring threads on neighbouring channels, so each
// step's loads and stores are coalesced.  The TPU grid's sequential chunk
// axis is the loop over t inside the thread here, because CUDA blocks run
// in no order.  Each thread loads STEPS steps of log_a and b into
// registers before it walks them, so that many loads are in flight while
// the dependent chain of multiplies and adds runs.  Any S and W.
//
// Bound on an H100 SXM at the serve shape (B = 4, S = 2560, W = 4096,
// float32): 503 MB moved (log_a and b read once, h written once), 0.150 ms
// at 3.35 TB/s; 3 operations an element (exp, multiply, add), far below
// the arithmetic peak, so bytes bound it.  What the design does about it:
// only B * W = 16384 threads exist, about 124 an SM, so each keeps STEPS
// steps of loads (8 bytes each) in flight to keep enough bytes moving.  A
// chunked two-pass scan (each chunk's local scan, then a carry pass) would
// give the card more threads for small B * W; that is a later step.
//
// The backward (rglru_bwd_*; no TPU kernel to replace: the JAX package
// differentiates its jax.lax.associative_scan, and the Pallas forward has
// no backward).  With g_t = dh_t + a_{t+1} g_{t+1} (g_S = 0), db_t = g_t
// and dlog_a_t = g_t a_t h_{t-1} (h_{-1} = 0), from the forward's saved h;
// h0 needs no gradient (models/rglru.py folds it into b_0).  The same
// layout walking t backwards, STEPS steps of log_a, dh and h loaded ahead;
// each step a multiply and an add for g, an exp and two multiplies for
// dlog_a, in that order, as ref.py::rglru_backward computes them.  Bound at
// the training shape (B = 2, S = 2560, W = 4096, float32): log_a, h and dh
// read, dlog_a and db written once, 419 MB, 0.125 ms at 3.35 TB/s; it
// takes 0.34 ms on an H100 80GB HBM3 at 700 W, where its 8192 threads,
// two warps an SM, keep too few loads in flight (the chunked two-pass scan
// would serve both directions).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 64;
constexpr int STEPS = 16;      // steps loaded ahead into registers

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

template <typename T>
__global__ void __launch_bounds__(THREADS)
rglru_kernel(const float* __restrict__ log_a, const T* __restrict__ b,
             T* __restrict__ h_out, int S, int W) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  if (w >= W) return;
  const size_t base = (size_t)blockIdx.y * S * W + w;
  float h = 0.0f;
  for (int t0 = 0; t0 < S; t0 += STEPS) {
    float la[STEPS], bb[STEPS];
#pragma unroll
    for (int s = 0; s < STEPS; ++s) {
      if (t0 + s < S) {
        const size_t g = base + (size_t)(t0 + s) * W;
        la[s] = log_a[g];
        bb[s] = widen(b[g]);
      }
    }
#pragma unroll
    for (int s = 0; s < STEPS; ++s) {
      if (t0 + s < S) {
        h = __fadd_rn(__fmul_rn(expf(la[s]), h), bb[s]);
        h_out[base + (size_t)(t0 + s) * W] = narrow<T>(h);
      }
    }
  }
}

template <typename T>
int launch(const void* log_a, const void* b, void* h, int B, int S, int W,
           void* stream) {
  const dim3 grid((unsigned)((W + THREADS - 1) / THREADS), (unsigned)B);
  rglru_kernel<T><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(log_a), static_cast<const T*>(b),
      static_cast<T*>(h), S, W);
  return (int)cudaGetLastError();
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
rglru_bwd_kernel(const float* __restrict__ log_a, const T* __restrict__ h,
                 const T* __restrict__ dh, float* __restrict__ dlog_a,
                 T* __restrict__ db, int S, int W) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  if (w >= W) return;
  const size_t base = (size_t)blockIdx.y * S * W + w;
  float g = 0.0f, a_next = 0.0f;
  for (int t1 = S - 1; t1 >= 0; t1 -= STEPS) {
    float la[STEPS], dd[STEPS], hp[STEPS];
#pragma unroll
    for (int s = 0; s < STEPS; ++s) {
      const int t = t1 - s;
      if (t >= 0) {
        const size_t at = base + (size_t)t * W;
        la[s] = log_a[at];
        dd[s] = widen(dh[at]);
        hp[s] = t > 0 ? widen(h[at - W]) : 0.0f;
      }
    }
#pragma unroll
    for (int s = 0; s < STEPS; ++s) {
      const int t = t1 - s;
      if (t >= 0) {
        const size_t at = base + (size_t)t * W;
        g = __fadd_rn(dd[s], __fmul_rn(a_next, g));
        const float a = expf(la[s]);
        db[at] = narrow<T>(g);
        dlog_a[at] = __fmul_rn(__fmul_rn(g, a), hp[s]);
        a_next = a;
      }
    }
  }
}

template <typename T>
int launch_bwd(const void* log_a, const void* h, const void* dh,
               void* dlog_a, void* db, int B, int S, int W, void* stream) {
  const dim3 grid((unsigned)((W + THREADS - 1) / THREADS), (unsigned)B);
  rglru_bwd_kernel<T><<<grid, THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(log_a), static_cast<const T*>(h),
      static_cast<const T*>(dh), static_cast<float*>(dlog_a),
      static_cast<T*>(db), S, W);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rglru_bf16(const void* log_a, const void* b, void* h, int B,
                          int S, int W, void* stream) {
  return launch<__nv_bfloat16>(log_a, b, h, B, S, W, stream);
}

extern "C" int rglru_f32(const void* log_a, const void* b, void* h, int B,
                         int S, int W, void* stream) {
  return launch<float>(log_a, b, h, B, S, W, stream);
}

// the backward: log_a, dlog_a float32; h (the forward's output), dh, db in
// the entry's dtype; all (B, S, W), contiguous
extern "C" int rglru_bwd_bf16(const void* log_a, const void* h,
                              const void* dh, void* dlog_a, void* db, int B,
                              int S, int W, void* stream) {
  return launch_bwd<__nv_bfloat16>(log_a, h, dh, dlog_a, db, B, S, W,
                                   stream);
}

extern "C" int rglru_bwd_f32(const void* log_a, const void* h,
                             const void* dh, void* dlog_a, void* db, int B,
                             int S, int W, void* stream) {
  return launch_bwd<float>(log_a, h, dh, dlog_a, db, B, S, W, stream);
}

extern "C" const char* rglru_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
