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
// in b's dtype, bf16 b included) for callers of ops.rglru_scan_op.  The
// TPU grid's sequential chunk axis is a loop over t inside a thread here,
// a thread a (batch row, channel), because CUDA blocks run in no order.
//
// Bound on an H100 SXM, float32: log_a and b read once, h written once, 12
// bytes an element against 3 operations (exp, multiply, add), so bytes
// bound it: 0.150 ms at the serve shape (B = 4, S = 2560, W = 4096; 503
// MB), 0.075 ms at the training shape (2, 2560, 4096), 0.038 ms at a
// 4-rank model axis's serve shape (4, 2560, 1024).  The first design (one
// thread a channel, 16 steps of loads ahead in registers) took 0.265 ms,
// 0.229 ms at the rank shape: with B * W threads, 31 to 124 an SM, a
// thread's 2560 dependent steps and its loads' latency are the time.  The
// chunked scan (rglru_chunked_kernel; kernels/rglru/kernel.py::
// fwd_geometry gives its launch, which the launch checks): time cut into
// chunks of 256 steps (longer past 16 chunks), a block of 16 warps a
// (chunk, 32 channels), each warp a segment of 16 steps held in
// registers.  A segment is walked twice: from 0 for its summary (end
// state e and product A of its a), then from its carry (the chunks and
// segments before it folded in order, h = A h + e) for its h.  Log_a and b
// are read once; a chunk's carry waits only on the first walks of earlier
// chunks, whose blocks took an earlier ticket.  The first segment has the
// plain version's bits; later ones differ by their carries' roundings (a <
// 1 damps them: one float32 ulp of h was the most seen).  Any S and W.
// Measured on an NVIDIA H100 80GB HBM3, 700.00 W, by kernel_probe.py
// --parent DIR --steps scan256, in turns with the first design: 0.096 ms
// against 0.243 at the training shape and 0.053 against 0.229 at the rank
// shape (79 % and 72 % of the bound; its loads half of it, its walks a
// quarter, its carries 3 %).  The backward's TMA ring run forwards (a
// block of 32 channels, a thread each; the plain version's bits) is no
// faster where channels are many: at S = 2560 and B * W of 16384 to 32768
// it took 0.6 % more to 3.3 % less than this scan (the serve shape 0.182
// ms against 0.185; kernel_probe.py --parent DIR --steps scan_sweep, DIR
// a checkout with both, in turns), so this scan runs at every shape.

// The backward (rglru_bwd_*; no TPU kernel to replace: the JAX package
// differentiates its jax.lax.associative_scan, and the Pallas forward has
// no backward).  With g_t = dh_t + a_{t+1} g_{t+1} (g_S = 0), db_t = g_t
// and dlog_a_t = g_t a_t h_{t-1} (h_{-1} = 0), from the forward's saved h;
// h0 needs no gradient (models/rglru.py folds it into b_0).  Each step a
// multiply and an add for g, an exp and two multiplies for dlog_a, in that
// order, as ref.py::rglru_backward computes them, so the float32 results
// are its bits.  Bound at the training shape (B = 2, S = 2560, W = 4096,
// float32): log_a, h and dh read, dlog_a and db written once, 419 MB,
// 0.125 ms at 3.35 TB/s.  The first design (one thread a channel loading
// 16 steps ahead into registers) took 0.34 ms there: its 8192 threads, two
// warps an SM, had bytes in flight only in bursts (leaving its loads out
// saved 0.22 of 0.34 ms).
// Design: a block of BWD_CHANNELS channels, a thread each, walks t
// backwards through a ring in shared memory of BWD_STAGES stages, each a
// TMA box of (BWD_CHANNELS x BWD_STEPS) of log_a, h (one step earlier)
// and dh on one mbarrier, BWD_STAGES - 1 stages ahead (some 36 KB in
// flight a block at float32, two blocks an SM); the outputs go to
// BWD_OUTS tiles in shared memory and out by TMA stores, a tile reused
// once its store has read it.  Chunks are aligned to t = 0 (the first
// one walked may reach past S - 1, where the boxes arrive as zeros: a = 1
// and g stays exactly 0, and nothing is stored), because a TMA store at a
// negative coordinate stopped the kernel with an illegal instruction on
// the card.  Rows that are not a whole number of 16 bytes (W not a
// multiple of 4 at float32, of 8 at bf16) or unaligned addresses take the
// first design's per-thread loads inside the same kernel; the launch's
// threads, stages and shared memory are kernel.py::bwd_geometry's, which
// the launcher checks.  Measured on an NVIDIA H100 80GB HBM3, 700.00 W, by
// kernel_probe.py --parent DIR --steps rec_bwd: 0.165 ms in turns with the
// first design's 0.341, 76 % of the bound; leaving out the loads saves
// 0.037 ms, the stores 0.030, the walk 0.012: the walk alone, a warp on
// its SM sub-partition running 2560 steps of expf, takes about 0.126 ms,
// which the loads now overlap (a chunk's exps computed first, or the walk
// fully unrolled, change nothing).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

// the forward (see the note above)
constexpr int SCAN_WARPS = 16;   // warps a block: a chunk's segments
constexpr int SCAN_STEPS = 16;   // steps a warp holds in registers at once
constexpr long long CARRY_SPINS = 1LL << 22;  // polls of a flag, at most
// the backward (see the note above)
constexpr int BWD_CHANNELS = 32;  // channels a block, a thread each
constexpr int BWD_STEPS = 32;     // steps a box
constexpr int BWD_STAGES = 4;     // stages of the ring
constexpr int BWD_OUTS = 3;       // output tiles
constexpr int PLAIN_STEPS = 16;   // steps loaded ahead, unaligned rows

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

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ void store_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

// The chunked forward: time in `chunks` chunks of `len` steps, a block a
// (chunk, batch row, 32 channels), a lane a channel; each of its
// SCAN_WARPS warps owns a segment of len / SCAN_WARPS steps (`reps`
// register loads of SCAN_STEPS steps each, a load's steps all in flight
// at once), walks it from h = 0 for its end state e and the product A of
// its a (pass 1) and hands (A, e) over in shared memory.  Warp 0 folds the
// segments in order into the chunk's summary (sum_a, sum_e
// [chunk][batch][channel]; the last chunk's is never read) and raises the
// block's flag; warp j + 1 (j < k) waits for chunk j's flag and brings its
// summary to shared memory, so the waits and loads overlap.  Each warp
// then folds, in order, the chunks before this one and the segments
// before its own (h = A h + e) into its carry and walks its segment again
// (pass 2) from the values still in its registers (reps 1; else
// reloaded, mostly from L2), writing h: log_a and b are read from device
// memory once.  Blocks take their (chunk, ...) from a ticket in launch
// order, chunk major, so every block a block waits on took its ticket
// before it, and runs or has run: the waits cannot deadlock (a flag
// polled CARRY_SPINS times traps, so the launch fails instead of hanging
// or writing a wrong h).  Steps past S
// are a = 1, b = 0, which change no state.  The first segment has the
// plain version's bits; every later one differs from them by the
// roundings of its carry's folds.
// two blocks an SM (64 registers a thread) where b is float32, the model's
// path; bf16 b (its conversions) would spill there, so one
template <typename T>
__global__ void __launch_bounds__(SCAN_WARPS * 32, sizeof(T) == 4 ? 2 : 1)
rglru_chunked_kernel(const float* __restrict__ log_a,
                     const T* __restrict__ b, T* __restrict__ h_out, int B,
                     int S, int W, int chunks, int reps, int groups,
                     float* __restrict__ sum_a, float* __restrict__ sum_e,
                     unsigned* __restrict__ flags) {
  __shared__ unsigned s_ticket;
  __shared__ float s_a[SCAN_WARPS][32], s_e[SCAN_WARPS][32];
  __shared__ float s_ca[SCAN_WARPS][32], s_ce[SCAN_WARPS][32];
  if (threadIdx.x == 0) {
    s_ticket = atomicAdd(flags + chunks * groups, 1u);
  }
  __syncthreads();
  const int ticket = (int)s_ticket;
  const int k = ticket / groups, g = ticket % groups;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int w_groups = (W + 31) / 32;
  const int bb = g / w_groups;
  const int w = (g % w_groups) * 32 + lane;
  const bool live = w < W;
  const int seg = SCAN_STEPS * reps;               // steps a warp
  const int t_w = (k * SCAN_WARPS + warp) * seg;   // its first step
  const size_t base = (size_t)bb * S * W + (live ? w : 0);
  float x[SCAN_STEPS], y[SCAN_STEPS];  // a = exp(log_a) and b of a load
  auto load = [&](int r) {
    const int t0 = t_w + r * SCAN_STEPS;
    const float* pa = log_a + base + (size_t)min(t0, S - 1) * W;
    const T* pb = b + base + (size_t)min(t0, S - 1) * W;
#pragma unroll
    for (int j = 0; j < SCAN_STEPS; ++j) {
      const bool in = live && t0 + j < S;
      x[j] = in ? pa[(size_t)j * W] : 0.0f;
      y[j] = in ? widen(pb[(size_t)j * W]) : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < SCAN_STEPS; ++j) x[j] = expf(x[j]);
  };

  // pass 1: the segment's summary
  float e = 0.0f, prod = 1.0f;
  for (int r = 0; r < reps; ++r) {
    load(r);
#pragma unroll
    for (int j = 0; j < SCAN_STEPS; ++j) {
      e = __fadd_rn(__fmul_rn(x[j], e), y[j]);
      prod = __fmul_rn(x[j], prod);
    }
  }
  s_a[warp][lane] = prod;
  s_e[warp][lane] = e;
  __syncthreads();

  if (warp == 0 && k + 1 < chunks) {
    // the chunk's summary, for the chunks after it
    float ce = 0.0f, ca = 1.0f;
#pragma unroll
    for (int v = 0; v < SCAN_WARPS; ++v) {
      ce = __fadd_rn(__fmul_rn(s_a[v][lane], ce), s_e[v][lane]);
      ca = __fmul_rn(s_a[v][lane], ca);
    }
    if (live) {
      const size_t at = ((size_t)k * B + bb) * W + w;
      sum_a[at] = ca;
      sum_e[at] = ce;
    }
    __syncwarp();  // the lanes' stores, then the release that covers them
    if (lane == 0) store_release(flags + k * groups + g, 1u);
  }
  const int j = warp - 1;
  if (j >= 0 && j < k) {  // chunk j's summary, once its flag is up
    if (lane == 0) {
      for (long long n = 0; load_acquire(flags + j * groups + g) == 0u; ++n)
        if (n >= CARRY_SPINS) __trap();  // a lost carry fails the launch
    }
    __syncwarp();
    const size_t at = ((size_t)j * B + bb) * W + (live ? w : 0);
    s_ca[j][lane] = __ldcg(sum_a + at);
    s_ce[j][lane] = __ldcg(sum_e + at);
  }
  __syncthreads();

  // the carry: the chunks before this one, then the segments before this
  // warp's, folded in order
  float h = 0.0f;
  for (int j = 0; j < k; ++j)
    h = __fadd_rn(__fmul_rn(s_ca[j][lane], h), s_ce[j][lane]);
  for (int v = 0; v < warp; ++v)
    h = __fadd_rn(__fmul_rn(s_a[v][lane], h), s_e[v][lane]);

  // pass 2: the segment's h from its carry
  for (int r = 0; r < reps; ++r) {
    if (reps > 1) load(r);
    const int t0 = t_w + r * SCAN_STEPS;
    T* out = h_out + base + (size_t)min(t0, S - 1) * W;
#pragma unroll
    for (int j = 0; j < SCAN_STEPS; ++j) {
      h = __fadd_rn(__fmul_rn(x[j], h), y[j]);
      if (live && t0 + j < S) out[(size_t)j * W] = narrow<T>(h);
    }
  }
}

// the forward's launch; `threads`, `chunks` and `len` are
// kernel.py::fwd_geometry's, and a launch they do not describe is refused
// with cudaErrorInvalidValue.  scratch: the chunks' summaries, 2 * chunks
// * B * W float32, then their flags and the ticket, chunks * groups + 1
// uint32 (groups = B * ceil(W / 32)), zeroed here
template <typename T>
int launch(const void* log_a, const void* b, void* h, int B, int S, int W,
           int threads, int chunks, int len, void* scratch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int per_chunk = SCAN_WARPS * SCAN_STEPS;
  if (threads != SCAN_WARPS * 32 || chunks < 1 || chunks > SCAN_WARPS
      || len < per_chunk
      || len % per_chunk != 0
      || (long long)chunks * len < S || (long long)(chunks - 1) * len >= S)
    return (int)cudaErrorInvalidValue;
  const int groups = B * ((W + 31) / 32);
  float* sums = static_cast<float*>(scratch);
  const size_t n = (size_t)chunks * B * W;
  unsigned* flags = reinterpret_cast<unsigned*>(sums + 2 * n);
  cudaError_t err = cudaMemsetAsync(
      flags, 0, ((size_t)chunks * groups + 1) * sizeof(unsigned), st);
  if (err != cudaSuccess) return (int)err;
  rglru_chunked_kernel<T><<<(unsigned)(chunks * groups), SCAN_WARPS * 32, 0,
                            st>>>(
      static_cast<const float*>(log_a), static_cast<const T*>(b),
      static_cast<T*>(h), B, S, W, chunks, len / per_chunk, groups, sums,
      sums + n, flags);
  return (int)cudaGetLastError();
}

// the backward's walk of one step for one channel: g = dh_t + a_{t+1} g,
// db_t = g and dlog_a_t = g a_t h_{t-1}, in that order; a_next becomes a_t
template <typename T>
__device__ __forceinline__ void bwd_step(float la, float dd, float hp,
                                         float& g, float& a_next, T* db,
                                         float* dla) {
  g = __fadd_rn(dd, __fmul_rn(a_next, g));
  const float a = expf(la);
  *db = narrow<T>(g);
  *dla = __fmul_rn(__fmul_rn(g, a), hp);
  a_next = a;
}

// The ring: BWD_STAGES stages of (BWD_CHANNELS x BWD_STEPS) boxes of log_a,
// h (one step earlier) and dh, and BWD_OUTS output tiles of dlog_a and db,
// each box and tile 128-byte aligned; the stages' mbarriers after them
template <typename T>
struct BwdRing {
  static constexpr int TILE = BWD_CHANNELS * BWD_STEPS;  // elements a box
  static constexpr int H = TILE * 4;                     // offsets in a stage
  static constexpr int DH = H + TILE * (int)sizeof(T);
  static constexpr int STAGE = DH + TILE * (int)sizeof(T);
  static constexpr int DB = TILE * 4;                    // offset in a tile
  static constexpr int OUT = DB + TILE * (int)sizeof(T);
  // 128 bytes to align the ring, the stages, the tiles, the mbarriers
  static constexpr size_t SMEM =
      128 + (size_t)BWD_STAGES * STAGE + (size_t)BWD_OUTS * OUT
      + 8 * BWD_STAGES;
};

template <typename T>
__global__ void __launch_bounds__(BWD_CHANNELS)
rglru_bwd_kernel(const __grid_constant__ CUtensorMap map_la,
                 const __grid_constant__ CUtensorMap map_h,
                 const __grid_constant__ CUtensorMap map_dh,
                 const __grid_constant__ CUtensorMap map_dla,
                 const __grid_constant__ CUtensorMap map_db,
                 const float* __restrict__ log_a, const T* __restrict__ h,
                 const T* __restrict__ dh, float* __restrict__ dlog_a,
                 T* __restrict__ db, int S, int W, bool tma) {
  const int c = threadIdx.x;
  const int c0 = blockIdx.x * BWD_CHANNELS;
  const int b = blockIdx.y;
  float g = 0.0f, a_next = 0.0f;
  if (!tma) {
    // rows of W elements not 16-byte aligned: each thread loads its own
    // channel, PLAIN_STEPS steps ahead into registers
    const int w = c0 + c;
    if (w >= W) return;
    const size_t base = (size_t)b * S * W + w;
    for (int t1 = S - 1; t1 >= 0; t1 -= PLAIN_STEPS) {
      float la[PLAIN_STEPS], dd[PLAIN_STEPS], hp[PLAIN_STEPS];
#pragma unroll
      for (int s = 0; s < PLAIN_STEPS; ++s) {
        const int t = t1 - s;
        if (t >= 0) {
          const size_t at = base + (size_t)t * W;
          la[s] = log_a[at];
          dd[s] = widen(dh[at]);
          hp[s] = t > 0 ? widen(h[at - W]) : 0.0f;
        }
      }
#pragma unroll
      for (int s = 0; s < PLAIN_STEPS; ++s) {
        const int t = t1 - s;
        if (t >= 0) {
          const size_t at = base + (size_t)t * W;
          bwd_step(la[s], dd[s], hp[s], g, a_next, db + at, dlog_a + at);
        }
      }
    }
    return;
  }
  using P = BwdRing<T>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  unsigned char* outs = ring + BWD_STAGES * P::STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(outs + BWD_OUTS * P::OUT);
  const int n_chunks = (S + BWD_STEPS - 1) / BWD_STEPS;
  // chunk k holds steps t0 .. t0 + BWD_STEPS - 1, t0 = (n_chunks - 1 - k)
  // STEPS: the first chunk may reach past S - 1, where TMA fills log_a and
  // dh with zeros (a = 1, and g stays exactly 0 until t = S - 1) and stores
  // nothing; h_{-1} of the last chunk arrives as 0 the same way
  auto issue = [&](int k) {
    const int st = k % BWD_STAGES;
    unsigned char* s = ring + st * P::STAGE;
    const int t0 = (n_chunks - 1 - k) * BWD_STEPS;
    hopper::mbar_expect_tx(&full[st], P::STAGE);
    hopper::tma_load_3d(s, &map_la, &full[st], c0, t0, b);
    hopper::tma_load_3d(s + P::H, &map_h, &full[st], c0, t0 - 1, b);
    hopper::tma_load_3d(s + P::DH, &map_dh, &full[st], c0, t0, b);
  };
  if (c == 0) {
    hopper::prefetch_map(&map_la);
    hopper::prefetch_map(&map_h);
    hopper::prefetch_map(&map_dh);
    for (int s = 0; s < BWD_STAGES; ++s) hopper::mbar_init(&full[s], 1);
    hopper::fence_barrier_init();
    for (int k = 0; k < BWD_STAGES && k < n_chunks; ++k) issue(k);
  }
  __syncthreads();
  for (int k = 0; k < n_chunks; ++k) {
    const int st = k % BWD_STAGES;
    hopper::mbar_wait(&full[st], (k / BWD_STAGES) & 1);
    const unsigned char* s = ring + st * P::STAGE;
    const float* la = reinterpret_cast<const float*>(s);
    const T* hp = reinterpret_cast<const T*>(s + P::H);
    const T* dd = reinterpret_cast<const T*>(s + P::DH);
    unsigned char* o = outs + (k % BWD_OUTS) * P::OUT;
    float* o_dla = reinterpret_cast<float*>(o);
    T* o_db = reinterpret_cast<T*>(o + P::DB);
#pragma unroll 8
    for (int j = BWD_STEPS - 1; j >= 0; --j) {
      const int e = j * BWD_CHANNELS + c;
      bwd_step(la[e], widen(dd[e]), widen(hp[e]), g, a_next, o_db + e,
               o_dla + e);
    }
    hopper::fence_proxy_async();
    // the store of chunk k - 2 has read its tile, which chunk k + 1 writes
    if (c == 0) hopper::bulk_wait_read<BWD_OUTS - 2>();
    __syncthreads();  // the stage read, the tile written, by every thread
    if (c == 0) {
      const int t0 = (n_chunks - 1 - k) * BWD_STEPS;
      hopper::tma_store_3d(&map_dla, o_dla, c0, t0, b);
      hopper::tma_store_3d(&map_db, o_db, c0, t0, b);
      hopper::bulk_commit();
      if (k + BWD_STAGES < n_chunks) issue(k + BWD_STAGES);
    }
  }
  // the block's shared memory outlives the last stores' reads of it
  if (c == 0) hopper::bulk_wait_read<0>();
}

template <typename T>
int launch_bwd(const void* log_a, const void* h, const void* dh,
               void* dlog_a, void* db, int B, int S, int W, int threads,
               int stages, int smem, void* stream) {
  using P = BwdRing<T>;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(log_a)
      | reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(dh)
      | reinterpret_cast<uintptr_t>(dlog_a) | reinterpret_cast<uintptr_t>(db);
  const bool tma = ((size_t)W * sizeof(T)) % 16 == 0 && W % 4 == 0
      && ptrs % 16 == 0;
  if (threads != BWD_CHANNELS || stages != (tma ? BWD_STAGES : 0)
      || (size_t)smem != (tma ? P::SMEM : 0))
    return (int)cudaErrorInvalidValue;
  CUtensorMap maps[5] = {};
  if (tma) {
    constexpr bool BF16 = sizeof(T) == 2;
    const uint64_t w = W, s = S, nb = B;
    int rc = hopper::make_map_plain(&maps[0], false, log_a, w, s, nb,
                                    BWD_CHANNELS, BWD_STEPS);
    if (rc == 0)
      rc = hopper::make_map_plain(&maps[1], BF16, h, w, s, nb, BWD_CHANNELS,
                                  BWD_STEPS);
    if (rc == 0)
      rc = hopper::make_map_plain(&maps[2], BF16, dh, w, s, nb, BWD_CHANNELS,
                                  BWD_STEPS);
    if (rc == 0)
      rc = hopper::make_map_plain(&maps[3], false, dlog_a, w, s, nb,
                                  BWD_CHANNELS, BWD_STEPS);
    if (rc == 0)
      rc = hopper::make_map_plain(&maps[4], BF16, db, w, s, nb, BWD_CHANNELS,
                                  BWD_STEPS);
    if (rc != 0) return rc;
    const cudaError_t err = cudaFuncSetAttribute(
        rglru_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)((W + BWD_CHANNELS - 1) / BWD_CHANNELS),
                  (unsigned)B);
  rglru_bwd_kernel<T><<<grid, BWD_CHANNELS, (size_t)smem,
                        static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4],
      static_cast<const float*>(log_a), static_cast<const T*>(h),
      static_cast<const T*>(dh), static_cast<float*>(dlog_a),
      static_cast<T*>(db), S, W, tma);
  return (int)cudaGetLastError();
}

}  // namespace

// the forward: log_a float32, b and h in the entry's dtype, all (B, S, W),
// contiguous; `threads`, `chunks`, `len` and `scratch` as launch() takes
// them.  Returns the cudaError_t of the launch.
extern "C" int rglru_bf16(const void* log_a, const void* b, void* h, int B,
                          int S, int W, int threads, int chunks, int len,
                          void* scratch, void* stream) {
  return launch<__nv_bfloat16>(log_a, b, h, B, S, W, threads, chunks, len,
                               scratch, stream);
}

extern "C" int rglru_f32(const void* log_a, const void* b, void* h, int B,
                         int S, int W, int threads, int chunks, int len,
                         void* scratch, void* stream) {
  return launch<float>(log_a, b, h, B, S, W, threads, chunks, len, scratch,
                       stream);
}

// the backward: log_a, dlog_a float32; h (the forward's output), dh, db in
// the entry's dtype; all (B, S, W), contiguous.  `threads`, `stages` and
// `smem` are kernel.py::bwd_geometry's; a launch they do not describe is
// refused with cudaErrorInvalidValue.  Returns the cudaError_t of the
// launch, or a negative code of hopper::make_map_plain.
extern "C" int rglru_bwd_bf16(const void* log_a, const void* h,
                              const void* dh, void* dlog_a, void* db, int B,
                              int S, int W, int threads, int stages,
                              int smem, void* stream) {
  return launch_bwd<__nv_bfloat16>(log_a, h, dh, dlog_a, db, B, S, W,
                                   threads, stages, smem, stream);
}

extern "C" int rglru_bwd_f32(const void* log_a, const void* h,
                             const void* dh, void* dlog_a, void* db, int B,
                             int S, int W, int threads, int stages, int smem,
                             void* stream) {
  return launch_bwd<float>(log_a, h, dh, dlog_a, db, B, S, W, threads,
                           stages, smem, stream);
}

extern "C" const char* rglru_error_string(int code) {
  return hopper::error_string(code);
}
