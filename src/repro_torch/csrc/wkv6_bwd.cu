// WKV6 (RWKV6 "Finch") backward: the gradients of the forward in
// csrc/wkv6.cu,
//
//   y_t = S_{t-1}^T r_t + (sum_i r_t[i] u[i] k_t[i]) v_t
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T,   w = exp(log_w),   S_{-1} = 0,
//
// given dy (B, S, H, hd) and, optionally, the gradient dS of the final
// state (B, H, hd, hd) (null: zero).  With G_t = dL/dS_t, G_{T-1} = dS and
// G_{t-1} = diag(w_t) G_t + r_t dy_t^T:
//
//   dr_t = S_{t-1} dy_t + u o k_t (v_t . dy_t)
//   dk_t = G_t v_t + u o r_t (v_t . dy_t)
//   dv_t = G_t^T k_t + (sum_i r_t u k_t) dy_t
//   dlog_w_t = w_t o rowsum(G_t o S_{t-1})
//   du = sum_{b, t} r_t o k_t (v_t . dy_t)
//
// No TPU kernel to replace: the JAX package differentiates its jnp WKV6
// (repro/models/rwkv6.py::wkv6_chunked; its Pallas forward,
// repro/kernels/rwkv6/kernel.py:66 wkv6_fwd, has no backward).  This is the
// gradient of row 6's kernel, which the trainer needs on the card.
// ref.py::wkv6_backward is its plain version: the same function with both
// states held (S_{t-1} stored for every t), in float32.
//
// Design.  dlog_w needs G_t and S_{t-1} at the same t, but S runs forward
// in time and G backward, and neither can be run the other way (S_{t-1} =
// (S_t - k v^T) / w_t fails where w underflows, which at the model's clip
// log_w = -exp(8) it does).  So dlog_w comes from the pair identity: with
// P(s, t) = r_t o k_s o prod_{s<tau<t} w_tau (v_s . dy_t), the pairs that
// span token m give dlog_w_m = sum_{s<m<t} P(s, t), and
//
//   dlog_w_m = sum_{t>m} c_t - sum_{s>=m} e_s,
//   c_t = r_t o w_{t-1} o (S_{t-2} dy_t)      (pairs (s, t), s <= t-2)
//   e_s = k_s o w_{s+1} o (G_{s+1} v_s)       (pairs (s, t), t >= s+2),
//
// the final state entering as a token T with c_T = w_{T-1} o rowsum(dS o
// S_{T-2}).  Pairs of neighbours, which would cancel exactly between the
// two sums, are left out of both: every term kept carries a decay factor,
// so at the clip (w = 0) every term is 0 and dlog_w is exactly 0, and at
// S 512 in float32 the result is within 1.5e-6 of the largest |dlog_w|
// against a float64 reference (tests/test_torch_wkv6.py, which holds this
// algorithm, emulated in torch, to the direct form).  Both walks run one
// token behind (S_{t-2}, G_{s+1}) so that the decay multiplies a product
// and is not subtracted out of one.
//
// Launch 1, wkv6_bwd_scan, grid (B * H, 3): one block a (batch, head) and
// role; CUDA blocks run in no set order, so the token loops run inside the
// block, and no block reads another's output.
//   role 0: forward in time over S_{t-2} -> dr, c (into the dlog_w buffer),
//           c_T, and this (b, h)'s du in t order;
//   role 1: backward in time over G_{s+1} -> dk, e (scratch);
//   role 2: backward in time over G^T -> dv.
// Roles 0 and 1 lay the state out by rows: thread (i, q) holds hd / P
// columns of row i, in quads at (c4 P + q) 4 (P = 4 threads a row,
// neighbouring lanes, each quad one 16-byte load of a staged vector), so
// the row sums S dy, G v are P-lane shuffles; role 2 holds G by columns
// (thread (j, q): rows in the same quads), so G^T k is too.  Each walk
// keeps two partial sums a dot product and updates its state element in
// the loop that reads it.  The dot products
// that every row needs (v . dy) are summed by each row's P lanes alike
// (xor butterflies give every lane the same bits).  Tokens are staged
// TOKENS at a time in shared memory as float32 (r, k, v, w, dy), with the
// token before and after the group; a token outside [0, S) is staged as
// r = k = v = dy = 0, w = 1, which makes the walks' first steps exact.
// Launch 2, wkv6_bwd_finish, one thread a (b, h, i): dlog_w's suffix sums
// in place (t from S-1 down, FINISH_STEPS tokens loaded ahead), and du =
// sum over b in b order.  No atomics:
// every run gives the same bits.
//
// Bound on an H100 SXM at the training shape (B = 4, S = 512, H = 64,
// hd = 64, bf16 r, k, v, dy): 12 hd^2 float32 operations a token and head
// (three walks of 4 hd^2), 6.4 GFLOP, 0.096 ms at 67 TFLOP/s; 184 MB moved
// (r, k, v, dy read and dr, dk, dv written in bf16, log_w read and dlog_w
// written in float32), 0.055 ms at 3.35 TB/s.  This first design takes
// 0.95 ms there (an H100 80GB HBM3 at 700 W): 3 * B * H blocks of 4 hd
// threads, each group's loads behind a barrier, as the forward's first
// version ran.  Each staged vector is read as float4 quads of columns and
// a state element is updated in the loop that reads it, because
// shared-memory load instructions, more than arithmetic, bound the walks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TOKENS = 16;      // tokens staged at a time
constexpr int PARTS = 4;        // threads a row (roles 0, 1) or column (2)
constexpr int WINDOW = TOKENS + 2;
constexpr int FINISH_THREADS = 128;
constexpr int FINISH_STEPS = 16;  // tokens of c and e loaded ahead

template <int HD>
struct Bwd {
  static constexpr int THREADS = HD * PARTS;
  static constexpr int NC = HD / PARTS;     // state elements a thread
  // r, k, v, w, dy staged as float32 over WINDOW tokens, and u
  static constexpr size_t SMEM = sizeof(float) * (5 * WINDOW * HD + HD);
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

// the sum over a row's (or column's) PARTS neighbouring lanes; every lane
// gets the same bits (a + b == b + a)
__device__ __forceinline__ float parts_sum(float x) {
#pragma unroll
  for (int m = 1; m < PARTS; m *= 2)
    x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, m));
  return x;
}

template <typename T, int HD>
__global__ void __launch_bounds__(Bwd<HD>::THREADS)
wkv6_bwd_scan(const T* __restrict__ r, const T* __restrict__ k,
              const T* __restrict__ v, const float* __restrict__ log_w,
              const float* __restrict__ u, const T* __restrict__ dy,
              const float* __restrict__ d_state, T* __restrict__ dr,
              T* __restrict__ dk, T* __restrict__ dv,
              float* __restrict__ c_buf, float* __restrict__ e_buf,
              float* __restrict__ c_tail, float* __restrict__ du_part,
              int S, int H, int hd) {
  using P = Bwd<HD>;
  constexpr int THREADS = P::THREADS, NC = P::NC;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sr = reinterpret_cast<float*>(smem);   // [WINDOW][HD] each
  float* sk = sr + WINDOW * HD;
  float* sv = sk + WINDOW * HD;
  float* sw = sv + WINDOW * HD;
  float* sdy = sw + WINDOW * HD;
  float* su = sdy + WINDOW * HD;                  // [HD]

  const int bh = blockIdx.x;
  const int role = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int tid = threadIdx.x;
  const int me = tid / PARTS;       // row (roles 0, 1) or column (role 2)
  const int q = tid - me * PARTS;
  const long long stride = (long long)H * hd;       // token to token
  const size_t base = ((size_t)b * S * H + h) * hd;
  const float* ds = d_state ? d_state + (size_t)bh * hd * hd : nullptr;

  for (int i = tid; i < HD; i += THREADS)
    su[i] = i < hd ? u[(size_t)h * hd + i] : 0.0f;
  __syncthreads();                  // su, read below before any staging
  // tokens t0 - 1 .. t0 + n of a group into window rows 0 .. n + 1
  auto stage = [&](int t0, int n) {
    __syncthreads();                // the last group consumed
    for (int e = tid; e < (n + 2) * HD; e += THREADS) {
      const int row = e / HD;
      const int i = e - row * HD;
      const int t = t0 - 1 + row;
      float rr = 0.0f, kk = 0.0f, vv = 0.0f, ww = 1.0f, dd = 0.0f;
      if (i < hd && t >= 0 && t < S) {
        const size_t g = base + (size_t)t * stride + i;
        rr = widen(r[g]);
        kk = widen(k[g]);
        vv = widen(v[g]);
        ww = expf(log_w[g]);
        dd = widen(dy[g]);
      }
      sr[e] = rr;
      sk[e] = kk;
      sv[e] = vv;
      sw[e] = ww;
      sdy[e] = dd;
    }
    __syncthreads();
  };
  const int n_groups = (S + TOKENS - 1) / TOKENS;
  // this thread's NC state elements: quads c4 of four neighbouring columns
  // (roles 0, 1) or rows (role 2), at (c4 * PARTS + q) * 4, so that a
  // warp's four lanes of a row read 64 neighbouring bytes with one float4
  // load each
  auto at4 = [&](int c4) { return (c4 * PARTS + q) * 4; };
  float st[NC];                     // S, G or G^T: this thread's elements
  if (role == 0) {
    // forward: st = S_{t-2} (row `me`)
#pragma unroll
    for (int c = 0; c < NC; ++c) st[c] = 0.0f;
    const int i = me;
    const float ui = su[i];
    float du_acc = 0.0f;
    int last_n = 0;
    for (int grp = 0; grp < n_groups; ++grp) {
      const int t0 = grp * TOKENS;
      const int n = min(TOKENS, S - t0);
      stage(t0, n);
      last_n = n;
      for (int tt = 0; tt < n; ++tt) {
        const int row = tt + 1;
        const float* dyt = sdy + row * HD;
        const float* vt = sv + row * HD;
        const float* vp = sv + (row - 1) * HD;
        const float wp = sw[(row - 1) * HD + i];
        const float kp = sk[(row - 1) * HD + i];
        const float kt = sk[row * HD + i];
        const float rt = sr[row * HD + i];
        float a[2] = {0.0f, 0.0f}, pv[2] = {0.0f, 0.0f}, vd[2] = {0.0f, 0.0f};
#pragma unroll
        for (int c4 = 0; c4 < NC / 4; ++c4) {
          const int j = at4(c4);
          const float4 d4 = *reinterpret_cast<const float4*>(dyt + j);
          const float4 p4 = *reinterpret_cast<const float4*>(vp + j);
          const float4 t4 = *reinterpret_cast<const float4*>(vt + j);
          const float dd[4] = {d4.x, d4.y, d4.z, d4.w};
          const float pp[4] = {p4.x, p4.y, p4.z, p4.w};
          const float tv[4] = {t4.x, t4.y, t4.z, t4.w};
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int c = 4 * c4 + x;
            a[x & 1] = __fmaf_rn(st[c], dd[x], a[x & 1]);
            pv[x & 1] = __fmaf_rn(pp[x], dd[x], pv[x & 1]);
            vd[x & 1] = __fmaf_rn(tv[x], dd[x], vd[x & 1]);
            st[c] = __fmaf_rn(wp, st[c], __fmul_rn(kp, pp[x]));
          }
        }
        const float as = parts_sum(__fadd_rn(a[0], a[1]));
        const float pvs = parts_sum(__fadd_rn(pv[0], pv[1]));
        const float vds = parts_sum(__fadd_rn(vd[0], vd[1]));
        const float wa = __fmul_rn(wp, as);
        const float ukv = __fmul_rn(__fmul_rn(ui, kt), vds);
        if (q == 0 && i < hd) {
          const size_t g = base + (size_t)(t0 + tt) * stride + i;
          dr[g] = narrow<T>(__fadd_rn(__fadd_rn(wa, __fmul_rn(kp, pvs)),
                                      ukv));
          c_buf[g] = __fmul_rn(rt, wa);
        }
        du_acc = __fmaf_rn(__fmul_rn(rt, kt), vds, du_acc);
      }
    }
    // the final state as token T: c_T = w_{T-1} o rowsum(dS o S_{T-2})
    float ct = 0.0f;
    if (ds != nullptr && i < hd) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int j = at4(c / 4) + c % 4;
        if (j < hd) ct = __fmaf_rn(ds[(size_t)i * hd + j], st[c], ct);
      }
    }
    ct = parts_sum(ct);
    if (q == 0 && i < hd) {
      c_tail[(size_t)bh * hd + i] = __fmul_rn(sw[last_n * HD + i], ct);
      du_part[(size_t)bh * hd + i] = du_acc;
    }
  } else if (role == 1) {
    // backward: st = G_{s+1} (row `me`), G_S taken as dS with w_S = 1
    const int i = me;
    const float ui = su[i];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int j = at4(c / 4) + c % 4;
      st[c] = (ds != nullptr && i < hd && j < hd) ? ds[(size_t)i * hd + j]
                                                  : 0.0f;
    }
    for (int grp = n_groups - 1; grp >= 0; --grp) {
      const int t0 = grp * TOKENS;
      const int n = min(TOKENS, S - t0);
      stage(t0, n);
      for (int tt = n - 1; tt >= 0; --tt) {
        const int row = tt + 1;
        const int s = t0 + tt;
        const float* vs = sv + row * HD;
        const float* dys = sdy + row * HD;
        const float* dyn = sdy + (row + 1) * HD;
        const float wn = sw[(row + 1) * HD + i];
        const float rn = sr[(row + 1) * HD + i];
        const float ks = sk[row * HD + i];
        const float rs = sr[row * HD + i];
        float bl[2] = {0.0f, 0.0f}, pd[2] = {0.0f, 0.0f}, vd[2] = {0.0f, 0.0f};
#pragma unroll
        for (int c4 = 0; c4 < NC / 4; ++c4) {
          const int j = at4(c4);
          const float4 v4 = *reinterpret_cast<const float4*>(vs + j);
          const float4 n4 = *reinterpret_cast<const float4*>(dyn + j);
          const float4 s4 = *reinterpret_cast<const float4*>(dys + j);
          const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
          const float nn[4] = {n4.x, n4.y, n4.z, n4.w};
          const float ss[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int c = 4 * c4 + x;
            bl[x & 1] = __fmaf_rn(st[c], vv[x], bl[x & 1]);
            pd[x & 1] = __fmaf_rn(nn[x], vv[x], pd[x & 1]);
            vd[x & 1] = __fmaf_rn(vv[x], ss[x], vd[x & 1]);
            st[c] = __fmaf_rn(wn, st[c], __fmul_rn(rn, nn[x]));
          }
        }
        const float bls = parts_sum(__fadd_rn(bl[0], bl[1]));
        const float pds = parts_sum(__fadd_rn(pd[0], pd[1]));
        const float vds = parts_sum(__fadd_rn(vd[0], vd[1]));
        const float wb = __fmul_rn(wn, bls);
        if (q == 0 && i < hd) {
          const size_t g = base + (size_t)s * stride + i;
          dk[g] = narrow<T>(__fadd_rn(
              __fadd_rn(wb, __fmul_rn(rn, pds)),
              __fmul_rn(__fmul_rn(ui, rs), vds)));
          e_buf[g] = s == S - 1 ? 0.0f : __fmul_rn(ks, wb);
        }
      }
    }
  } else {
    // backward: st = G_s^T (column `me`)
    const int j = me;
    float uq[NC];                   // u at this thread's rows
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int i = at4(c / 4) + c % 4;
      uq[c] = su[i];
      st[c] = (ds != nullptr && i < hd && j < hd) ? ds[(size_t)i * hd + j]
                                                  : 0.0f;
    }
    for (int grp = n_groups - 1; grp >= 0; --grp) {
      const int t0 = grp * TOKENS;
      const int n = min(TOKENS, S - t0);
      stage(t0, n);
      for (int tt = n - 1; tt >= 0; --tt) {
        const int row = tt + 1;
        const float* ks = sk + row * HD;
        const float* rs = sr + row * HD;
        const float* ws = sw + row * HD;
        const float dj = sdy[row * HD + j];
        float pk[2] = {0.0f, 0.0f}, bo[2] = {0.0f, 0.0f};
#pragma unroll
        for (int c4 = 0; c4 < NC / 4; ++c4) {
          const int i = at4(c4);
          const float4 k4 = *reinterpret_cast<const float4*>(ks + i);
          const float4 r4 = *reinterpret_cast<const float4*>(rs + i);
          const float4 w4 = *reinterpret_cast<const float4*>(ws + i);
          const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
          const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
          const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int c = 4 * c4 + x;
            pk[x & 1] = __fmaf_rn(st[c], kk[x], pk[x & 1]);
            bo[x & 1] = __fmaf_rn(__fmul_rn(rr[x], uq[c]), kk[x], bo[x & 1]);
            st[c] = __fmaf_rn(ww[x], st[c], __fmul_rn(rr[x], dj));
          }
        }
        const float pks = parts_sum(__fadd_rn(pk[0], pk[1]));
        const float bos = parts_sum(__fadd_rn(bo[0], bo[1]));
        if (q == 0 && j < hd)
          dv[base + (size_t)(t0 + tt) * stride + j] =
              narrow<T>(__fmaf_rn(bos, dj, pks));
      }
    }
  }
}

// dlog_w_m = c_T + sum_{t>m} c_t - sum_{s>=m} e_s, from m = S-1 down, in
// place over the c values in dlog_w; and du = sum_b du_part[b] in b order
__global__ void __launch_bounds__(FINISH_THREADS)
wkv6_bwd_finish(float* __restrict__ dlog_w, const float* __restrict__ e_buf,
                const float* __restrict__ c_tail,
                const float* __restrict__ du_part, float* __restrict__ du,
                int B, int S, int H, int hd) {
  const long long idx = (long long)blockIdx.x * FINISH_THREADS + threadIdx.x;
  const long long per_b = (long long)H * hd;
  if (idx >= B * per_b) return;
  const int b = (int)(idx / per_b);
  const int hi = (int)(idx - b * per_b);         // h * hd + i
  const size_t base = (size_t)b * S * per_b + hi;
  float acc = c_tail[idx];
  for (int m1 = S - 1; m1 >= 0; m1 -= FINISH_STEPS) {
    float c[FINISH_STEPS], e[FINISH_STEPS];   // loaded ahead
#pragma unroll
    for (int s = 0; s < FINISH_STEPS; ++s) {
      const int m = m1 - s;
      if (m >= 0) {
        const size_t g = base + (size_t)m * per_b;
        c[s] = dlog_w[g];
        e[s] = e_buf[g];
      }
    }
#pragma unroll
    for (int s = 0; s < FINISH_STEPS; ++s) {
      const int m = m1 - s;
      if (m >= 0) {
        acc = __fsub_rn(acc, e[s]);
        dlog_w[base + (size_t)m * per_b] = acc;
        acc = __fadd_rn(acc, c[s]);
      }
    }
  }
  if (b == 0) {
    float s = 0.0f;
    for (int bb = 0; bb < B; ++bb) s = __fadd_rn(s, du_part[bb * per_b + hi]);
    du[hi] = s;
  }
}

template <typename T, int HD>
int launch_hd(const void* r, const void* k, const void* v, const float* lw,
              const float* u, const void* dy, const float* d_state, void* dr,
              void* dk, void* dv, float* dlog_w, float* du, float* scratch,
              int B, int S, int H, int hd, int threads, int smem,
              cudaStream_t stream) {
  using P = Bwd<HD>;
  if (threads != P::THREADS || (size_t)smem != P::SMEM)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_bwd_scan<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const size_t numel = (size_t)B * S * H * hd;
  float* e_buf = scratch;
  float* c_tail = scratch + numel;
  float* du_part = c_tail + (size_t)B * H * hd;
  wkv6_bwd_scan<T, HD><<<dim3((unsigned)(B * H), 3), P::THREADS, P::SMEM,
                         stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), lw, u, static_cast<const T*>(dy), d_state,
      static_cast<T*>(dr), static_cast<T*>(dk), static_cast<T*>(dv), dlog_w,
      e_buf, c_tail, du_part, S, H, hd);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n_threads = (long long)B * H * hd;
  wkv6_bwd_finish<<<(unsigned)((n_threads + FINISH_THREADS - 1)
                               / FINISH_THREADS),
                    FINISH_THREADS, 0, stream>>>(dlog_w, e_buf, c_tail,
                                                 du_part, du, B, S, H, hd);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* lw,
           const void* u, const void* dy, const void* d_state, void* dr,
           void* dk, void* dv, void* dlog_w, void* du, void* scratch, int B,
           int S, int H, int hd, int threads, int smem, void* stream) {
  if (hd < 1 || hd > 128) return (int)cudaErrorInvalidValue;
  const float* lwf = static_cast<const float*>(lw);
  const float* uf = static_cast<const float*>(u);
  const float* dsf = static_cast<const float*>(d_state);
  float* dlw = static_cast<float*>(dlog_w);
  float* duf = static_cast<float*>(du);
  float* scr = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd <= 32)
    return launch_hd<T, 32>(r, k, v, lwf, uf, dy, dsf, dr, dk, dv, dlw, duf,
                            scr, B, S, H, hd, threads, smem, s);
  if (hd <= 64)
    return launch_hd<T, 64>(r, k, v, lwf, uf, dy, dsf, dr, dk, dv, dlw, duf,
                            scr, B, S, H, hd, threads, smem, s);
  return launch_hd<T, 128>(r, k, v, lwf, uf, dy, dsf, dr, dk, dv, dlw, duf,
                           scr, B, S, H, hd, threads, smem, s);
}

}  // namespace

// Plain C interface for ctypes.  r, k, v, dy, dr, dk, dv (B, S, H, hd) in
// the entry's dtype; log_w, dlog_w (B, S, H, hd), u, du (H, hd), d_state
// (B, H, hd, hd) (null: zero) float32; scratch float32 of B S H hd + 2 B H
// hd elements.  `threads` and `smem` are kernel.py::bwd_geometry's; a
// launch they do not describe is refused with cudaErrorInvalidValue.
// Returns the cudaError_t of the launches.
extern "C" int wkv6_bwd_bf16(const void* r, const void* k, const void* v,
                             const void* log_w, const void* u,
                             const void* dy, const void* d_state, void* dr,
                             void* dk, void* dv, void* dlog_w, void* du,
                             void* scratch, int B, int S, int H, int hd,
                             int threads, int smem, void* stream) {
  return launch<__nv_bfloat16>(r, k, v, log_w, u, dy, d_state, dr, dk, dv,
                               dlog_w, du, scratch, B, S, H, hd, threads,
                               smem, stream);
}

extern "C" int wkv6_bwd_f32(const void* r, const void* k, const void* v,
                            const void* log_w, const void* u, const void* dy,
                            const void* d_state, void* dr, void* dk,
                            void* dv, void* dlog_w, void* du, void* scratch,
                            int B, int S, int H, int hd, int threads,
                            int smem, void* stream) {
  return launch<float>(r, k, v, log_w, u, dy, d_state, dr, dk, dv, dlog_w,
                       du, scratch, B, S, H, hd, threads, smem, stream);
}

extern "C" const char* wkv6_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
