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
// Each walk is laid out as the forward kernel's (csrc/wkv6.cu): the head
// dim padded to HD = 32, 64 or 128, GROUPS = 8 groups of the index the
// walk sums over (the columns j in roles 0 and 1, the rows i in role 2),
// thread (g, l) holding the R = HD / 8 indices of group g for the two
// neighbouring lane indices 2 l and 2 l + 1 (4 HD threads; 256 and 16
// state elements a thread at hd 64).  A warp's lanes share g, so the
// vectors over the summed index (dy_t and v_{t-1}; v_s and dy_{s+1}; k_s,
// r_s and w_s) are 16-byte broadcast loads from shared memory, a lane's
// two w and k (or r, dy) one load each, and each token's sums over them
// are partials, one a group, added after the group's walk.  A walk does,
// per state element and token, its product's fused multiply-add and the
// update S = fma(w, S, k v) with k v rounded (3 instructions); the dot
// products that do not depend on the state, v_t . dy_t, v_t . dy_{t+1}
// and sum_i r u k, are summed once a token, by 8 neighbouring lanes (each
// HD / 8 elements in order, then a butterfly over the 8), and enter only
// the sums after the walk.  Tokens come TOKENS at a time, with the
// neighbour token a walk needs (t0 - 1 in role 0, t0 + n in role 1):
// (1) while a group is walked, the next group's raw r, k, v, dy and log_w
// (role 2: no v) are on their way into the other half of a double buffer
// (cp.async, 16 bytes a copy, issued by the upper half of the block's
// warps, where rows and pointers are 16-byte aligned; plain loads by all
// otherwise); a token outside [0, S) is staged as r = k = v = dy = 0,
// w = 1, which makes the walks' first steps exact; (2) after a barrier,
// the block converts the three vectors the walk reads to float32 (w =
// exp(log_w), once a token) and sums the tokens' dot products; (3) after
// a barrier the walk; (4) after a barrier, an item a token's ITEM
// neighbouring lane indices: the GROUPS partials in a fixed tree order,
// the token's scalars, and one 8- or 16-byte store of dr (and c), dk (and
// e) or dv, a warp's items whole rows.  The registers are bounded so that
// three blocks share an SM where shared memory allows (80 at hd 64 bf16).
// Launch 2, wkv6_bwd_finish, one thread a (b, h, i): dlog_w's suffix sums
// in place (t from S-1 down, FINISH_STEPS tokens loaded ahead), and du =
// sum over b in b order.  No atomics: every run gives the same bits.
//
// Bound on an H100 SXM at the training shape (B = 4, S = 512, H = 64,
// hd = 64, bf16 r, k, v, dy): 12 hd^2 float32 operations a token and head
// (three walks of 4 hd^2), 6.4 GFLOP, 0.096 ms at 67 TFLOP/s; 184 MB moved
// (r, k, v, dy read and dr, dk, dv written in bf16, log_w read and dlog_w
// written in float32), 0.055 ms at 3.35 TB/s.  The walks do 15 hd^2 (the
// rounded k v is a multiply of its own), so the bound is below the work.
// Measured on an NVIDIA H100 80GB HBM3, 700.00 W, by kernel_probe.py
// --parent DIR --steps rec_bwd: 0.492 ms in turns with the first design's
// 0.951 (its dot products repeated by every row's lanes, every load of a
// group behind a barrier, one element stored a token by one lane a row).
// Leaving out a phase saves: the staging 0.072 ms (not the memory: copies
// from rows resident in L2 cost as much, and dropping their wait saves
// nothing; a warp that starts copies stalls, so the upper half of the
// warps issue them while the lower half sums the dot products), the
// conversion and scalars 0.056, the walks 0.075, 0.041 and 0.073, the
// sums and stores 0.050, the finish 0.051: the phases hardly overlap at
// three blocks an SM.  In turns, the copies by every warp take 0.522 ms,
// no register bound 0.500, a head's three roles launched together 0.517.
// Also slower, in trials on the same card: 1-D bulk copies of a row,
// 8-token groups, the sums sharing a phase with the next group's
// conversion, the copies spread over the walk, the finish's loads
// double-buffered.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TOKENS = 16;      // tokens a group
constexpr int GROUPS = 8;       // groups of the state's reduced index
constexpr int WINDOW = TOKENS + 1;   // a group and its neighbour token
constexpr int SCALARS = 36;     // two per window row, padded to 16 bytes
constexpr int ITEM = 4;         // outputs an item of the sums
constexpr int FINISH_THREADS = 128;
constexpr int FINISH_STEPS = 64;  // tokens of c and e loaded ahead

template <typename T, int HD>
struct Bwd {
  static constexpr int THREADS = GROUPS * HD / 2;
  static constexpr int R = HD / GROUPS;      // reduced indices a thread
  static constexpr int ROW = WINDOW * HD;    // one staged array
  // raw log_w (x2), three float32 arrays, the walks' partial sums, u, the
  // per-token scalars; then raw r, k, v, dy (x2 each) in T
  static constexpr size_t SMEM =
      sizeof(float) * ((2 + 3) * ROW + TOKENS * GROUPS * HD + HD + SCALARS)
      + sizeof(T) * 8 * ROW;
  // blocks an SM can hold by shared memory (228 KB, 1 KB a block reserved)
  // and threads, at most 3: the registers are bounded to let them in
  static constexpr int MIN_BLOCKS =
      3 * (SMEM + 1024) <= 233472 && 3 * THREADS <= 2048   ? 3
      : 2 * (SMEM + 1024) <= 233472 && 2 * THREADS <= 2048 ? 2
                                                            : 1;
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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// tokens first .. first + rows - 1 of one (batch, head), `stride` elements
// apart from src (its token 0), into dst (rows HD apart): when `vec`,
// asynchronous 16-byte copies by the upper half of the block's threads
// (the lower half sums the tokens' dot products meanwhile, and a warp
// that starts copies stalls on them), else synchronous element copies by
// all; a token outside [0, S) (only the first or the last row can be) is
// staged as zeros
template <int HD, int THREADS, typename E>
__device__ __forceinline__ void stage(E* dst, const E* __restrict__ src,
                                      long long stride, int first, int rows,
                                      int S, int hd, bool vec) {
  const int tid = threadIdx.x;
  const int lo = first < 0 ? 1 : 0;            // rows lo .. hi - 1 exist
  const int hi = first + rows > S ? S - first : rows;
  if (vec) {
    constexpr int PER = 16 / sizeof(E);
    constexpr int CHUNKS = HD / PER;            // a padded row's 16 bytes
    constexpr int HALF = THREADS / 2;
    for (int c = tid - HALF + lo * CHUNKS; tid >= HALF && c < hi * CHUNKS;
         c += HALF) {
      const int row = c / CHUNKS;
      const int q = (c - row * CHUNKS) * PER;
      if (q < hd)
        cp_async16(dst + row * HD + q, src + (first + row) * stride + q);
    }
  } else {
    for (int e = tid + lo * HD; e < hi * HD; e += THREADS) {
      const int row = e / HD;
      const int i = e - row * HD;
      if (i < hd) dst[e] = src[(first + row) * stride + i];
    }
  }
  if (lo == 1)
    for (int i = tid; i < HD; i += THREADS) dst[i] = narrow<E>(0.0f);
  for (int e = hi * HD + tid; e < rows * HD; e += THREADS)
    dst[e] = narrow<E>(0.0f);
}

// two neighbouring elements of a staged row (the first at an even index)
// as float32, by one load
__device__ __forceinline__ float2 pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 pair(const __nv_bfloat16* p) {
  const unsigned q = *reinterpret_cast<const unsigned*>(p);
  return make_float2(__uint_as_float(q << 16),
                     __uint_as_float(q & 0xffff0000u));
}

// SEG elements of a staged row (16-byte aligned) as float32, by 16- or
// 8-byte loads
template <int SEG>
__device__ __forceinline__ void load_seg(const float* p, float* out) {
#pragma unroll
  for (int m = 0; m < SEG; m += 4) {
    const float4 q = *reinterpret_cast<const float4*>(p + m);
    out[m] = q.x;
    out[m + 1] = q.y;
    out[m + 2] = q.z;
    out[m + 3] = q.w;
  }
}
template <int SEG>
__device__ __forceinline__ void load_seg(const __nv_bfloat16* p,
                                         float* out) {
  // a bf16 is the upper half of its float32
#pragma unroll
  for (int m = 0; m < SEG; m += 4) {
    const uint2 q = *reinterpret_cast<const uint2*>(p + m);
    out[m] = __uint_as_float(q.x << 16);
    out[m + 1] = __uint_as_float(q.x & 0xffff0000u);
    out[m + 2] = __uint_as_float(q.y << 16);
    out[m + 3] = __uint_as_float(q.y & 0xffff0000u);
  }
}

// a segment's share of a dot product: x_i y_i (x_i times `scale` first,
// rounded) added for the segment's SEG elements in order by fused
// multiply-adds
template <int SEG, typename T>
__device__ __forceinline__ float seg_dot(const T* x, const T* y,
                                         const float* scale) {
  float xs[SEG], ys[SEG];
  load_seg<SEG>(x, xs);
  load_seg<SEG>(y, ys);
  float acc = 0.0f;
#pragma unroll
  for (int m = 0; m < SEG; ++m)
    acc = __fmaf_rn(scale ? __fmul_rn(xs[m], scale[m]) : xs[m], ys[m], acc);
  return acc;
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

// the sum of N partials (N a power of two, `stride` floats apart, 16-byte
// aligned) in tree order, neighbours first
template <int N>
__device__ __forceinline__ float4 group_tree(const float* p, int stride) {
  float4 q[N];
#pragma unroll
  for (int i = 0; i < N; ++i)
    q[i] = *reinterpret_cast<const float4*>(p + i * stride);
#pragma unroll
  for (int w = 1; w < N; w *= 2)
#pragma unroll
    for (int i = 0; i < N; i += 2 * w) q[i] = add4(q[i], q[i + w]);
  return q[0];
}

// two outputs as the 4 bytes of a bf16 pair
__device__ __forceinline__ unsigned bf16_pair(float a, float b) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(a))
         | (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(b)) << 16;
}

// ITEM outputs at out, as one 8-byte (bf16) or 16-byte (float32) store
// (aligned), or, where `vec` is false, those below `lim` one by one
__device__ __forceinline__ void store_item(__nv_bfloat16* out,
                                           const float* val, bool vec,
                                           int lim) {
  if (vec) {
    *reinterpret_cast<uint2*>(out) =
        make_uint2(bf16_pair(val[0], val[1]), bf16_pair(val[2], val[3]));
  } else {
#pragma unroll
    for (int x = 0; x < ITEM; ++x)
      if (x < lim) out[x] = __float2bfloat16_rn(val[x]);
  }
}
__device__ __forceinline__ void store_item(float* out, const float* val,
                                           bool vec, int lim) {
  if (vec) {
    *reinterpret_cast<float4*>(out) =
        make_float4(val[0], val[1], val[2], val[3]);
  } else {
#pragma unroll
    for (int x = 0; x < ITEM; ++x)
      if (x < lim) out[x] = val[x];
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(Bwd<T, HD>::THREADS, Bwd<T, HD>::MIN_BLOCKS)
wkv6_bwd_scan(const T* __restrict__ r, const T* __restrict__ k,
              const T* __restrict__ v, const float* __restrict__ log_w,
              const float* __restrict__ u, const T* __restrict__ dy,
              const float* __restrict__ d_state, T* __restrict__ dr,
              T* __restrict__ dk, T* __restrict__ dv,
              float* __restrict__ c_buf, float* __restrict__ e_buf,
              float* __restrict__ c_tail, float* __restrict__ du_part,
              int S, int H, int hd, bool vec) {
  using P = Bwd<T, HD>;
  constexpr int THREADS = P::THREADS, R = P::R, ROW = P::ROW;
  constexpr int SEG = HD / 8;   // a dot product's elements a lane
  extern __shared__ __align__(16) unsigned char smem[];
  float* raw_w = reinterpret_cast<float*>(smem);   // [2][WINDOW][HD]
  float* ca = raw_w + 2 * ROW;                     // [WINDOW][HD] each
  float* cb = ca + ROW;
  float* cc = cb + ROW;                            // exp(log_w)
  float* part = cc + ROW;                          // [TOKENS][GROUPS][HD]
  float* su = part + TOKENS * GROUPS * HD;         // [HD]
  float* sa = su + HD;                             // [WINDOW] each
  float* sb = sa + WINDOW;
  T* raw_r = reinterpret_cast<T*>(su + HD + SCALARS);  // [2][WINDOW][HD]
  T* raw_k = raw_r + 2 * ROW;
  T* raw_v = raw_k + 2 * ROW;
  T* raw_dy = raw_v + 2 * ROW;

  const int bh = blockIdx.x;
  const int role = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int tid = threadIdx.x;
  const int g = tid / (HD / 2);                    // reduced-index group
  const int l0 = 2 * (tid - g * (HD / 2)), l1 = l0 + 1;   // neighbours
  const long long stride = (long long)H * hd;      // token to token
  const size_t base = ((size_t)b * S * H + h) * hd;

  for (int i = tid; i < 2 * ROW; i += THREADS) {
    raw_w[i] = 0.0f;
    raw_r[i] = raw_k[i] = raw_v[i] = raw_dy[i] = narrow<T>(0.0f);
  }
  for (int i = tid; i < HD; i += THREADS)
    su[i] = i < hd ? u[(size_t)h * hd + i] : 0.0f;
  __syncthreads();   // the zeroed pads, before any copy lands
  // a group's window: role 0 the tokens t0 - 1 .. t0 + n - 1, role 1
  // t0 .. t0 + n, role 2 t0 .. t0 + n - 1; role 2 reads no v
  const int lead = role == 0 ? 1 : 0;
  auto stage_group = [&](int grp, int buf) {
    const int t0 = grp * TOKENS;
    const int rows = min(TOKENS, S - t0) + (role == 2 ? 0 : 1);
    const int first = t0 - lead;
    stage<HD, THREADS>(raw_r + buf * ROW, r + base, stride, first, rows, S,
                       hd, vec);
    stage<HD, THREADS>(raw_k + buf * ROW, k + base, stride, first, rows, S,
                       hd, vec);
    if (role != 2)
      stage<HD, THREADS>(raw_v + buf * ROW, v + base, stride, first, rows,
                         S, hd, vec);
    stage<HD, THREADS>(raw_dy + buf * ROW, dy + base, stride, first, rows,
                       S, hd, vec);
    stage<HD, THREADS>(raw_w + buf * ROW, log_w + base, stride, first, rows,
                       S, hd, vec);
  };

  // this thread's state: 2 R elements, lane index l0 or l1 (the row i in
  // roles 0 and 1, the column j in role 2) by the reduced indices
  // g R .. g R + R - 1 (the columns, or in role 2 the rows)
  float s0[R], s1[R];
#pragma unroll
  for (int c = 0; c < R; ++c) {
    const int x = g * R + c;
    s0[c] = s1[c] = 0.0f;
    if (d_state != nullptr && role != 0 && x < hd) {
      const float* ds = d_state + (size_t)bh * hd * hd;
      if (role == 1) {
        if (l0 < hd) s0[c] = ds[(size_t)l0 * hd + x];
        if (l1 < hd) s1[c] = ds[(size_t)l1 * hd + x];
      } else {
        if (l0 < hd) s0[c] = ds[(size_t)x * hd + l0];
        if (l1 < hd) s1[c] = ds[(size_t)x * hd + l1];
      }
    }
  }
  float du_acc = 0.0f;

  const int n_groups = (S + TOKENS - 1) / TOKENS;
  int grp = role == 0 ? 0 : n_groups - 1;
  const int step = role == 0 ? 1 : -1;
  stage_group(grp, 0);
  cp_async_commit();
  for (int it = 0; it < n_groups; ++it, grp += step) {
    const int buf = it & 1;
    const int t0 = grp * TOKENS;
    const int n = min(TOKENS, S - t0);
    const int rows = n + (role == 2 ? 0 : 1);
    cp_async_wait_all();
    __syncthreads();   // this group staged; the last group's sums read
    if (it + 1 < n_groups) stage_group(grp + step, buf ^ 1);
    cp_async_commit();
    const T* rr = raw_r + buf * ROW;
    const T* rk = raw_k + buf * ROW;
    const T* rv = raw_v + buf * ROW;
    const T* rd = raw_dy + buf * ROW;
    const float* rw = raw_w + buf * ROW;
    // float32 copies of the vectors the walk reads (roles 0, 1: v, dy and
    // w; role 2: k, r and w)
    for (int e = tid; e < rows * HD; e += THREADS) {
      ca[e] = role == 2 ? widen(rk[e]) : widen(rv[e]);
      cb[e] = role == 2 ? widen(rr[e]) : widen(rd[e]);
      cc[e] = expf(rw[e]);
    }
    // the per-token scalars, 8 neighbouring lanes a row (a segment of SEG
    // elements each, then a butterfly over the 8): roles 0, 1 v_t . dy_t
    // and v_t . dy_{t+1} (into sa, sb at t's row; role 0 keeps the second
    // at t + 1's row); role 2 the bonus sum_i r u k (into sa)
    for (int task = tid; task < (rows * 8 + 31) / 32 * 32; task += THREADS) {
      const int row = task / 8, i0 = (task % 8) * SEG;
      float x = 0.0f, y = 0.0f;
      if (row < rows) {
        if (role == 2) {
          x = seg_dot<SEG>(rr + row * HD + i0, rk + row * HD + i0, su + i0);
        } else {
          x = seg_dot<SEG>(rv + row * HD + i0, rd + row * HD + i0,
                           (const float*)nullptr);
          const int lo = role == 0 ? row - 1 : row;
          if (lo >= 0 && lo + 1 < rows)
            y = seg_dot<SEG>(rv + lo * HD + i0, rd + (lo + 1) * HD + i0,
                             (const float*)nullptr);
        }
      }
#pragma unroll
      for (int m = 1; m < 8; m *= 2) {
        x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, m));
        y = __fadd_rn(y, __shfl_xor_sync(0xffffffffu, y, m));
      }
      if (row < rows && task % 8 == 0) {
        sa[row] = x;
        sb[row] = y;
      }
    }
    __syncthreads();   // the float32 rows and the scalars
    // the walk: a partial sum over this thread's R reduced indices, for its
    // two lane indices, a token; the state updated in the same loop
    if (role == 0) {
      // S_{t-2} by rows: a_i = sum_j S_ij dy_t[j], then
      // S_ij <- w_{t-1}[i] S_ij + k_{t-1}[i] v_{t-1}[j]
      for (int tt = 0; tt < n; ++tt) {
        const float* dyt = cb + (tt + 1) * HD + g * R;
        const float* vp = ca + tt * HD + g * R;
        const float2 w01 = pair(cc + tt * HD + l0);
        const float2 k01 = pair(rk + tt * HD + l0);
        const float w0 = w01.x, w1 = w01.y, k0 = k01.x, k1 = k01.y;
        float a0[2] = {0.0f, 0.0f}, a1[2] = {0.0f, 0.0f};
#pragma unroll
        for (int c4 = 0; c4 < R / 4; ++c4) {
          const float4 d4 = *reinterpret_cast<const float4*>(dyt + 4 * c4);
          const float4 p4 = *reinterpret_cast<const float4*>(vp + 4 * c4);
          const float dd[4] = {d4.x, d4.y, d4.z, d4.w};
          const float pp[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int c = 4 * c4 + x;
            a0[x & 1] = __fmaf_rn(s0[c], dd[x], a0[x & 1]);
            a1[x & 1] = __fmaf_rn(s1[c], dd[x], a1[x & 1]);
            s0[c] = __fmaf_rn(w0, s0[c], __fmul_rn(k0, pp[x]));
            s1[c] = __fmaf_rn(w1, s1[c], __fmul_rn(k1, pp[x]));
          }
        }
        float* pt = part + (tt * GROUPS + g) * HD;
        *reinterpret_cast<float2*>(pt + l0) =
            make_float2(__fadd_rn(a0[0], a0[1]), __fadd_rn(a1[0], a1[1]));
      }
    } else if (role == 1) {
      // G_{s+1} by rows: b_i = sum_j G_ij v_s[j], then
      // G_ij <- w_{s+1}[i] G_ij + r_{s+1}[i] dy_{s+1}[j]
      for (int tt = n - 1; tt >= 0; --tt) {
        const float* vs = ca + tt * HD + g * R;
        const float* dyn = cb + (tt + 1) * HD + g * R;
        const float2 w01 = pair(cc + (tt + 1) * HD + l0);
        const float2 r01 = pair(rr + (tt + 1) * HD + l0);
        const float w0 = w01.x, w1 = w01.y, r0 = r01.x, r1 = r01.y;
        float a0[2] = {0.0f, 0.0f}, a1[2] = {0.0f, 0.0f};
#pragma unroll
        for (int c4 = 0; c4 < R / 4; ++c4) {
          const float4 v4 = *reinterpret_cast<const float4*>(vs + 4 * c4);
          const float4 n4 = *reinterpret_cast<const float4*>(dyn + 4 * c4);
          const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
          const float nn[4] = {n4.x, n4.y, n4.z, n4.w};
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int c = 4 * c4 + x;
            a0[x & 1] = __fmaf_rn(s0[c], vv[x], a0[x & 1]);
            a1[x & 1] = __fmaf_rn(s1[c], vv[x], a1[x & 1]);
            s0[c] = __fmaf_rn(w0, s0[c], __fmul_rn(r0, nn[x]));
            s1[c] = __fmaf_rn(w1, s1[c], __fmul_rn(r1, nn[x]));
          }
        }
        float* pt = part + (tt * GROUPS + g) * HD;
        *reinterpret_cast<float2*>(pt + l0) =
            make_float2(__fadd_rn(a0[0], a0[1]), __fadd_rn(a1[0], a1[1]));
      }
    } else {
      // G_s by columns: p_j = sum_i G_ij k_s[i], then
      // G_ij <- w_s[i] G_ij + r_s[i] dy_s[j]
      for (int tt = n - 1; tt >= 0; --tt) {
        const float* ks = ca + tt * HD + g * R;
        const float* rs = cb + tt * HD + g * R;
        const float* ws = cc + tt * HD + g * R;
        const float2 d01 = pair(rd + tt * HD + l0);
        const float d0 = d01.x, d1 = d01.y;
        float a0[2] = {0.0f, 0.0f}, a1[2] = {0.0f, 0.0f};
#pragma unroll
        for (int c4 = 0; c4 < R / 4; ++c4) {
          const float4 k4 = *reinterpret_cast<const float4*>(ks + 4 * c4);
          const float4 r4 = *reinterpret_cast<const float4*>(rs + 4 * c4);
          const float4 w4 = *reinterpret_cast<const float4*>(ws + 4 * c4);
          const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
          const float rq[4] = {r4.x, r4.y, r4.z, r4.w};
          const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int c = 4 * c4 + x;
            a0[x & 1] = __fmaf_rn(s0[c], kk[x], a0[x & 1]);
            a1[x & 1] = __fmaf_rn(s1[c], kk[x], a1[x & 1]);
            s0[c] = __fmaf_rn(ww[x], s0[c], __fmul_rn(rq[x], d0));
            s1[c] = __fmaf_rn(ww[x], s1[c], __fmul_rn(rq[x], d1));
          }
        }
        float* pt = part + (tt * GROUPS + g) * HD;
        *reinterpret_cast<float2*>(pt + l0) =
            make_float2(__fadd_rn(a0[0], a0[1]), __fadd_rn(a1[0], a1[1]));
      }
    }
    __syncthreads();   // the partial sums
    // the sums: an item is ITEM neighbouring lane indices of one token, the
    // GROUPS partials added in a fixed tree order, the outputs stored as
    // whole 8- or 16-byte pieces of the token's row (a warp's items cover
    // whole rows)
    for (int e = tid; e < n * (HD / ITEM); e += THREADS) {
      const int tt = e / (HD / ITEM);
      const int x0 = (e - tt * (HD / ITEM)) * ITEM;
      if (x0 >= hd) continue;
      const float4 tot = group_tree<GROUPS>(part + tt * GROUPS * HD + x0,
                                            HD);
      const float sum[ITEM] = {tot.x, tot.y, tot.z, tot.w};
      const size_t at = base + (size_t)(t0 + tt) * stride + x0;
      const int lim = hd - x0;
      float out[ITEM], side[ITEM];
      if (role == 0) {
        // dr_t = w_{t-1} a + k_{t-1} (v_{t-1} . dy_t) + u k_t (v_t . dy_t),
        // c_t = r_t w_{t-1} a
        float wp[ITEM], kp[ITEM], kt[ITEM], rt[ITEM];
        load_seg<ITEM>(cc + tt * HD + x0, wp);
        load_seg<ITEM>(rk + tt * HD + x0, kp);
        load_seg<ITEM>(rk + (tt + 1) * HD + x0, kt);
        load_seg<ITEM>(rr + (tt + 1) * HD + x0, rt);
#pragma unroll
        for (int x = 0; x < ITEM; ++x) {
          const float wa = __fmul_rn(wp[x], sum[x]);
          out[x] = __fadd_rn(__fadd_rn(wa, __fmul_rn(kp[x], sb[tt + 1])),
                             __fmul_rn(__fmul_rn(su[x0 + x], kt[x]),
                                       sa[tt + 1]));
          side[x] = __fmul_rn(rt[x], wa);
        }
        store_item(dr + at, out, vec, lim);
        store_item(c_buf + at, side, vec, lim);
      } else if (role == 1) {
        // dk_s = w_{s+1} b + r_{s+1} (v_s . dy_{s+1}) + u r_s (v_s . dy_s),
        // e_s = k_s w_{s+1} b (0 at s = S - 1)
        const bool end = t0 + tt == S - 1;
        float wn[ITEM], rn[ITEM], rs[ITEM], ks[ITEM];
        load_seg<ITEM>(cc + (tt + 1) * HD + x0, wn);
        load_seg<ITEM>(rr + (tt + 1) * HD + x0, rn);
        load_seg<ITEM>(rr + tt * HD + x0, rs);
        load_seg<ITEM>(rk + tt * HD + x0, ks);
#pragma unroll
        for (int x = 0; x < ITEM; ++x) {
          const float wb = __fmul_rn(wn[x], sum[x]);
          out[x] = __fadd_rn(__fadd_rn(wb, __fmul_rn(rn[x], sb[tt])),
                             __fmul_rn(__fmul_rn(su[x0 + x], rs[x]), sa[tt]));
          side[x] = end ? 0.0f : __fmul_rn(ks[x], wb);
        }
        store_item(dk + at, out, vec, lim);
        store_item(e_buf + at, side, vec, lim);
      } else {
        // dv_s = G_s^T k_s + (sum_i r u k) dy_s
        float dj[ITEM];
        load_seg<ITEM>(rd + tt * HD + x0, dj);
#pragma unroll
        for (int x = 0; x < ITEM; ++x)
          out[x] = __fmaf_rn(sa[tt], dj[x], sum[x]);
        store_item(dv + at, out, vec, lim);
      }
    }
    // du: this (b, h)'s sum_t r_t k_t (v_t . dy_t), a row a thread, in t
    // order
    if (role == 0 && tid < hd)
      for (int tt = 0; tt < n; ++tt)
        du_acc = __fmaf_rn(__fmul_rn(widen(rr[(tt + 1) * HD + tid]),
                                     widen(rk[(tt + 1) * HD + tid])),
                           sa[tt + 1], du_acc);
  }
  if (role != 0) return;
  // the final state as token T: c_T = w_{T-1} o rowsum(dS o S_{T-2}), a
  // partial over this thread's columns, then the GROUPS partials in the
  // sums' tree order
  __syncthreads();   // the last sums read the partials
  float ct0 = 0.0f, ct1 = 0.0f;
  if (d_state != nullptr) {
    const float* ds = d_state + (size_t)bh * hd * hd;
#pragma unroll
    for (int c = 0; c < R; ++c) {
      const int j = g * R + c;
      if (j < hd) {
        if (l0 < hd) ct0 = __fmaf_rn(ds[(size_t)l0 * hd + j], s0[c], ct0);
        if (l1 < hd) ct1 = __fmaf_rn(ds[(size_t)l1 * hd + j], s1[c], ct1);
      }
    }
  }
  part[g * HD + l0] = ct0;
  part[g * HD + l1] = ct1;
  __syncthreads();
  if (tid < hd) {
    float p[GROUPS];
#pragma unroll
    for (int gg = 0; gg < GROUPS; ++gg) p[gg] = part[gg * HD + tid];
#pragma unroll
    for (int w = 1; w < GROUPS; w *= 2)
#pragma unroll
      for (int gg = 0; gg < GROUPS; gg += 2 * w)
        p[gg] = __fadd_rn(p[gg], p[gg + w]);
    // w_{T-1}: the last group's last window row
    const int last_n = S - (n_groups - 1) * TOKENS;
    c_tail[(size_t)bh * hd + tid] = __fmul_rn(cc[last_n * HD + tid], p[0]);
    du_part[(size_t)bh * hd + tid] = du_acc;
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
  using P = Bwd<T, HD>;
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
  // 16-byte copies and stores: rows of a whole number of 16-byte pieces
  // (then every token's row starts on one) from 16-byte aligned bases
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(r)
      | reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)
      | reinterpret_cast<uintptr_t>(dy) | reinterpret_cast<uintptr_t>(lw)
      | reinterpret_cast<uintptr_t>(dr) | reinterpret_cast<uintptr_t>(dk)
      | reinterpret_cast<uintptr_t>(dv) | reinterpret_cast<uintptr_t>(dlog_w)
      | reinterpret_cast<uintptr_t>(e_buf);
  const bool vec = (hd * sizeof(T)) % 16 == 0 && hd % 4 == 0
      && ptrs % 16 == 0;
  wkv6_bwd_scan<T, HD><<<dim3((unsigned)(B * H), 3), P::THREADS, P::SMEM,
                         stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), lw, u, static_cast<const T*>(dy), d_state,
      static_cast<T*>(dr), static_cast<T*>(dk), static_cast<T*>(dv), dlog_w,
      e_buf, c_tail, du_part, S, H, hd, vec);
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
