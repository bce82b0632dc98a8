// CCM stage-2 exchange scorer: the ten work components of candidate cluster
// pairs of a batch of lock events, (the fused entry) the CCM work combine
// and eq. 9's memory feasibility of each shortlisted pair, and (the window
// entry, ccm_scorer_spec_f64, described above its kernel below) a whole
// speculative lock event a row: flow matrix, features, scores, combine and
// selection, the row staged by bulk copies (TMA, hopper.cuh).
//
// Replaces the Pallas TPU kernel repro/kernels/ccm_scorer/kernel.py:35
// (_scorer_kernel, launched by score_tiles_fwd with grid=(E,)) and the
// XLA-compiled kind="spec" body (repro/kernels/ccm_scorer/jit.py:253).
// All three kernels evaluate repro_torch/kernels/ccm_scorer/ref.py::
// score_planes term for term, through one __device__ function
// (score_lane), so the expression tree, its association, nan_max and the
// masked tail are written once.
//
// Layout (repro_torch/kernels/ccm_scorer/layout.py), all contiguous:
//   av (E, N_AV, A), bv (E, N_AV, B), pm (E, N_PM, A, B), sc (E, N_SC)
//
// ccm_scorer_{f64,f32}, the full tile -> out (E, N_OUT, A, B):
// one thread per (event, ia, ib) lane; grid = (ceil(A*B / 128), E).  Lanes
// past the event's (na, nb) are the masked tail: 0 on the load/flow/homing
// planes, +inf on the memory planes.  The tests and chip_smoke.py hold it
// to its plain version; the balancer no longer calls it.
//
// ccm_scorer_pairs_{f64,f32}, the balancer's entry: the shortlisted pairs
// only, as the JAX package's pair path scores them (kind="pairs",
// repro/kernels/ccm_scorer/jit.py:213, ref.score_pairs_xp), with the
// combine on the card as well:
//   + cf (E, N_CF) float64 combine rows (alpha, beta, gamma, delta,
//     speed_a, speed_b, mem_cap_a, mem_cap_b), even in the float32 tier,
//     whose planes are widened exactly to float64 before the combine;
//   + offs (E + 1) int32 and pairs (P, 2) int32 (ia, ib), ragged per event
//   -> out (3, P) float64: w_a, w_b, feasible (0.0 / 1.0).
// One block per event, one thread per pair (looping past PAIR_THREADS); the
// event's scalar and combine rows are staged once in shared memory.  A pair
// gathers its a-column, b-column and pairwise entries, evaluates the ten
// planes, and combines them in the association of ops.combine_work_pairs:
// W = (((alpha*load)/speed + beta*off) + gamma*on) + delta*hom, feasible =
// mem_a <= cap_a && mem_b <= cap_b under memory_constraint (a NaN compares
// false, as in numpy), and W = +inf where infeasible (a NaN W stays where
// feasible, as np.where keeps it).
//
// Bitwise contract: the tree uses only add, sub, max, compare and select,
// and the combine's products, quotients and sums are the _rn intrinsics, so
// every result is the IEEE result of the same operations, in the same
// order, as the plain version and the host combine (float64 and float32
// alike).  Build without --use_fast_math and with --fmad=false, so that no
// contraction creeps in anywhere.  np.maximum and torch.maximum propagate
// NaN, while CUDA's fmax returns the other operand, so max is the explicit
// select nan_max below (torch.maximum's rule, including which operand a tie
// returns).
//
// What bounds it on an H100: at the balancer's sizes (E = 1..8 events, P <=
// 32 pairs each, kilobytes in all) neither bytes nor operations do; one
// launch and the dependent round trips to memory (offsets and rows, then
// the pair's indices, then its features) do, a few microseconds, most of it
// the launch itself.  So the design spends exactly one launch per scorer
// call, stores no full tile (3 * P results, not 10 * E * A * B planes) and
// makes no second pass for the combine; the host copies one packed buffer
// in and one (3, P) block out (ccm_scorer_copy, from and to pinned memory)
// and waits once (ccm_scorer_sync), each a plain C call, since every
// Python step of the call costs microseconds on the host.  The full tile, where it is large (E = 64, A
// = B = 128), is bound by bytes: its pairwise planes and output are touched
// once each, coalesced along ib, and the per-candidate rows are re-read
// from L1/L2.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int N_AV = 14;
constexpr int N_PM = 6;
constexpr int N_SC = 32;
constexpr int N_OUT = 10;
constexpr int N_CF = 8;
constexpr int THREADS = 128;
constexpr int PAIR_THREADS = 64;

// layout.AV
enum { AV_INTRA = 0, AV_OUT_OWN, AV_IN_OWN, AV_OUT_PEER, AV_IN_PEER,
       AV_OUT_OTHER, AV_IN_OTHER, AV_LOAD, AV_MEM, AV_OVH, AV_S_RM, AV_H_RM,
       AV_S_ADD_PEER, AV_H_ADD_PEER };
// layout.PM
enum { PM_X_AB = 0, PM_X_BA, PM_CS_A, PM_CH_A, PM_CS_B, PM_CH_B };
// layout.SC
enum { SC_F_AB = 0, SC_F_BA, SC_F_AA, SC_F_BB, SC_F_AO, SC_F_OA, SC_F_BO,
       SC_F_OB, SC_BASE_SENT_A, SC_BASE_RECV_A, SC_BASE_SENT_B,
       SC_BASE_RECV_B, SC_VOL_AA, SC_VOL_BB, SC_LOAD_A, SC_LOAD_B,
       SC_SHARED_A, SC_SHARED_B, SC_HOM_A, SC_HOM_B, SC_MEM_BASE_A,
       SC_MEM_TASK_A, SC_OVH_A, SC_MEM_BASE_B, SC_MEM_TASK_B, SC_OVH_B,
       SC_NA, SC_NB, SC_SPEED_A, SC_SPEED_B, SC_MEM_CAP_A, SC_MEM_CAP_B };
// layout.OUT
enum { OUT_LOAD_A = 0, OUT_LOAD_B, OUT_OFF_A, OUT_OFF_B, OUT_ON_A, OUT_ON_B,
       OUT_HOM_A, OUT_HOM_B, OUT_MEM_A, OUT_MEM_B };
// layout.CF, the float64 combine row of an event
enum { CF_ALPHA = 0, CF_BETA, CF_GAMMA, CF_DELTA, CF_SPEED_A, CF_SPEED_B,
       CF_MEM_CAP_A, CF_MEM_CAP_B };
static_assert(N_SC + N_CF <= PAIR_THREADS, "one load per thread stages the "
              "scalar and combine rows");

// torch.maximum / np.maximum: a NaN operand wins (the first one if both)
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  return (a < b) ? b : a;
}

// The ten planes of lane (ia, ib) of one event, masked: ``a`` and ``b``
// point at the lane's a- and b-columns (feature i at a[i * a_n], b[i *
// b_n]), ``p`` at its pairwise entries (plane k at p[k * ab]), ``s`` at the
// event's scalars (global or shared memory).
template <typename T>
__device__ __forceinline__ void score_lane(const T* a, int a_n, const T* b,
                                           int b_n, const T* p, long long ab,
                                           const T* s, int ia, int ib,
                                           T (&o)[N_OUT]) {
  const T c_intra = a[AV_INTRA * a_n], r_intra = b[AV_INTRA * b_n];
  const T c_out_own = a[AV_OUT_OWN * a_n], r_out_own = b[AV_OUT_OWN * b_n];
  const T c_in_own = a[AV_IN_OWN * a_n], r_in_own = b[AV_IN_OWN * b_n];
  const T c_out_peer = a[AV_OUT_PEER * a_n], r_out_peer = b[AV_OUT_PEER * b_n];
  const T c_in_peer = a[AV_IN_PEER * a_n], r_in_peer = b[AV_IN_PEER * b_n];
  const T c_out_other = a[AV_OUT_OTHER * a_n];
  const T r_out_other = b[AV_OUT_OTHER * b_n];
  const T c_in_other = a[AV_IN_OTHER * a_n], r_in_other = b[AV_IN_OTHER * b_n];
  const T c_load = a[AV_LOAD * a_n], r_load = b[AV_LOAD * b_n];
  const T c_mem = a[AV_MEM * a_n], r_mem = b[AV_MEM * b_n];
  const T c_ovh = a[AV_OVH * a_n], r_ovh = b[AV_OVH * b_n];
  const T c_s_rm = a[AV_S_RM * a_n], r_s_rm = b[AV_S_RM * b_n];
  const T c_h_rm = a[AV_H_RM * a_n], r_h_rm = b[AV_H_RM * b_n];
  const T c_s_add_peer = a[AV_S_ADD_PEER * a_n];
  const T r_s_add_peer = b[AV_S_ADD_PEER * b_n];
  const T c_h_add_peer = a[AV_H_ADD_PEER * a_n];
  const T r_h_add_peer = b[AV_H_ADD_PEER * b_n];

  const T x_ab = p[PM_X_AB * ab], x_ba = p[PM_X_BA * ab];
  const T cs_a = p[PM_CS_A * ab], ch_a = p[PM_CH_A * ab];
  const T cs_b = p[PM_CS_B * ab], ch_b = p[PM_CH_B * ab];

  const T f_ab = s[SC_F_AB], f_ba = s[SC_F_BA];
  const T f_aa = s[SC_F_AA], f_bb = s[SC_F_BB];
  const T f_ao = s[SC_F_AO], f_oa = s[SC_F_OA];
  const T f_bo = s[SC_F_BO], f_ob = s[SC_F_OB];

  // --- flows after the exchange (ref.py score_planes, same association) ---
  const T sent_a = x_ba + (r_out_own - r_intra + r_out_other)
                   + (c_in_own - c_intra)
                   + (f_ab - c_out_peer - r_in_peer + x_ab)
                   + (f_ao - c_out_other);
  const T recv_a = x_ab + (r_in_own - r_intra + r_in_other)
                   + (c_out_own - c_intra)
                   + (f_ba - r_out_peer - c_in_peer + x_ba)
                   + (f_oa - c_in_other);
  const T on_a0 = r_intra + (r_out_peer - x_ba)
                  + (r_in_peer - x_ab)
                  + (f_aa - (c_out_own + c_in_own - c_intra));
  const T sent_b = x_ab + (c_out_own - c_intra + c_out_other)
                   + (r_in_own - r_intra)
                   + (f_ba - r_out_peer - c_in_peer + x_ba)
                   + (f_bo - r_out_other);
  const T recv_b = x_ba + (c_in_own - c_intra + c_in_other)
                   + (r_out_own - r_intra)
                   + (f_ab - c_out_peer - r_in_peer + x_ab)
                   + (f_ob - r_in_other);
  const T on_b0 = c_intra + (c_out_peer - x_ab)
                  + (c_in_peer - x_ba)
                  + (f_bb - (r_out_own + r_in_own - r_intra));

  const T off_a = nan_max(s[SC_BASE_SENT_A] + (sent_a - (f_ab + f_ao)),
                          s[SC_BASE_RECV_A] + (recv_a - (f_ba + f_oa)));
  const T off_b = nan_max(s[SC_BASE_SENT_B] + (sent_b - (f_ba + f_bo)),
                          s[SC_BASE_RECV_B] + (recv_b - (f_ab + f_ob)));
  const T on_a = s[SC_VOL_AA] + (on_a0 - f_aa);
  const T on_b = s[SC_VOL_BB] + (on_b0 - f_bb);

  const T load_a = s[SC_LOAD_A] - c_load + r_load;
  const T load_b = s[SC_LOAD_B] + c_load - r_load;

  // --- homing / shared-memory transitions ---------------------------------
  const T shared_a = s[SC_SHARED_A] - c_s_rm + r_s_add_peer + cs_a;
  const T shared_b = s[SC_SHARED_B] - r_s_rm + c_s_add_peer + cs_b;
  const T hom_a = s[SC_HOM_A] - c_h_rm + r_h_add_peer + ch_a;
  const T hom_b = s[SC_HOM_B] - r_h_rm + c_h_add_peer + ch_b;

  // --- memory (eq. 9 inputs) ----------------------------------------------
  const T mem_a = s[SC_MEM_BASE_A] + s[SC_MEM_TASK_A] - c_mem + r_mem
                  + shared_a + nan_max(s[SC_OVH_A], r_ovh);
  const T mem_b = s[SC_MEM_BASE_B] + s[SC_MEM_TASK_B] + c_mem - r_mem
                  + shared_b + nan_max(s[SC_OVH_B], c_ovh);

  // --- masked tail: the float lane index against the float bounds ---------
  const bool live = ((T)ia <= s[SC_NA]) && ((T)ib <= s[SC_NB]);
  const T zero = (T)0;
  const T inf = (T)INFINITY;
  o[OUT_LOAD_A] = live ? load_a : zero;
  o[OUT_LOAD_B] = live ? load_b : zero;
  o[OUT_OFF_A] = live ? off_a : zero;
  o[OUT_OFF_B] = live ? off_b : zero;
  o[OUT_ON_A] = live ? on_a : zero;
  o[OUT_ON_B] = live ? on_b : zero;
  o[OUT_HOM_A] = live ? hom_a : zero;
  o[OUT_HOM_B] = live ? hom_b : zero;
  o[OUT_MEM_A] = live ? mem_a : inf;
  o[OUT_MEM_B] = live ? mem_b : inf;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ccm_scorer_kernel(const T* __restrict__ av, const T* __restrict__ bv,
                  const T* __restrict__ pm, const T* __restrict__ sc,
                  T* __restrict__ out, int a_n, int b_n) {
  const long long ab = (long long)a_n * b_n;
  const long long lane = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (lane >= ab) return;
  const long long e = blockIdx.y;
  const int ia = (int)(lane / b_n);
  const int ib = (int)(lane % b_n);
  T o[N_OUT];
  score_lane<T>(av + e * N_AV * a_n + ia, a_n, bv + e * N_AV * b_n + ib, b_n,
                pm + e * N_PM * ab + lane, ab, sc + e * N_SC, ia, ib, o);
  T* dst = out + e * N_OUT * ab + lane;       // plane k at dst[k * ab]
#pragma unroll
  for (int k = 0; k < N_OUT; ++k) dst[k * ab] = o[k];
}

// ops.combine_work_pairs' W, rounded step by step: no contraction.
__device__ __forceinline__ double combine_work(const double* cf, double load,
                                               double speed, double off,
                                               double on, double hom) {
  const double w = __ddiv_rn(__dmul_rn(cf[CF_ALPHA], load), speed);
  return __dadd_rn(__dadd_rn(__dadd_rn(w, __dmul_rn(cf[CF_BETA], off)),
                             __dmul_rn(cf[CF_GAMMA], on)),
                   __dmul_rn(cf[CF_DELTA], hom));
}

template <typename T>
__global__ void __launch_bounds__(PAIR_THREADS)
ccm_scorer_pairs_kernel(const T* __restrict__ av, const T* __restrict__ bv,
                        const T* __restrict__ pm, const T* __restrict__ sc,
                        const double* __restrict__ cf,
                        const int* __restrict__ offs,
                        const int2* __restrict__ pairs,
                        double* __restrict__ out, int a_n, int b_n,
                        int p_total, int mem_constraint) {
  __shared__ T s_sc[N_SC];
  __shared__ double s_cf[N_CF];
  const long long ab = (long long)a_n * b_n;
  const long long e = blockIdx.x;
  const int t = threadIdx.x;
  if (t < N_SC) {
    s_sc[t] = sc[e * N_SC + t];
  } else if (t < N_SC + N_CF) {
    s_cf[t - N_SC] = cf[e * N_CF + (t - N_SC)];
  }
  const int p_end = offs[e + 1];
  const int p_start = offs[e];
  __syncthreads();

  const T* a0 = av + e * N_AV * a_n;
  const T* b0 = bv + e * N_AV * b_n;
  const T* pm0 = pm + e * N_PM * ab;
  for (int p = p_start + t; p < p_end; p += PAIR_THREADS) {
    const int2 pair = pairs[p];
    const int ia = pair.x, ib = pair.y;
    T o[N_OUT];
    score_lane<T>(a0 + ia, a_n, b0 + ib, b_n, pm0 + (long long)ia * b_n + ib,
                  ab, s_sc, ia, ib, o);
    const bool feasible =
        !mem_constraint || ((double)o[OUT_MEM_A] <= s_cf[CF_MEM_CAP_A]
                            && (double)o[OUT_MEM_B] <= s_cf[CF_MEM_CAP_B]);
    const double w_a = combine_work(s_cf, (double)o[OUT_LOAD_A],
                                     s_cf[CF_SPEED_A], (double)o[OUT_OFF_A],
                                     (double)o[OUT_ON_A],
                                     (double)o[OUT_HOM_A]);
    const double w_b = combine_work(s_cf, (double)o[OUT_LOAD_B],
                                     s_cf[CF_SPEED_B], (double)o[OUT_OFF_B],
                                     (double)o[OUT_ON_B],
                                     (double)o[OUT_HOM_B]);
    out[p] = feasible ? w_a : (double)INFINITY;
    out[(long long)p_total + p] = feasible ? w_b : (double)INFINITY;
    out[2LL * p_total + p] = feasible ? 1.0 : 0.0;
  }
}

// ---------------------------------------------------------------------------
// ccm_scorer_spec_f64, the speculative window: one block per window row
// (one captured lock event), the whole event on the card.  It replaces the
// JAX package's XLA-compiled kind="spec" body
// (repro/kernels/ccm_scorer/jit.py:253-375, per row :271-358; no Pallas
// kernel there) and computes it in the summation order its plain version
// fixes (repro_torch/kernels/ccm_scorer/ref.py::score_spec_rows), bit for
// bit:
//
//   1. staging: thread 0 starts one bulk copy (TMA, 1-D, completing on an
//      mbarrier) of the row's tail (host feature rows, pair corrections,
//      scalars, pair indices, coefficients) and two of each of the first
//      SPEC_STAGES edge chunks (bins, volumes; SPEC_CHUNK edges a chunk, a
//      ring of SPEC_STAGES buffers, refilled as chunks are consumed);
//      meanwhile the block zeroes the G x G flow matrix F (G = 3 + (A-1) +
//      (B-1), layout.spec_groups);
//   2. the scatter, F[bin] += volume over the edges, without float
//      atomics and in edge order.  Warp w owns the bins b with
//      b % SPEC_WARPS == w (a hash, so that the bins of one source group,
//      which real rows fill unevenly, spread over the warps).  The block
//      splits each chunk, one edge a thread, into its owner warps' lists
//      in edge order: a ballot per owner gives each edge its place among
//      the warp's edges of that owner, the warps' counts an exclusive
//      prefix per owner (integers only).  Each warp then takes its list
//      32 edges at a time: __match_any_sync groups the lanes by bin, the
//      runs of one bin are laid end to end in lane (= edge) order in a
//      buffer of 32 (an exclusive scan of their lengths over the runs'
//      leaders), and the lowest lane of each run adds them to F[bin] one by
//      one, the loads independent of the sum.  So each bin sums its edges
//      in edge order from 0.0, as np.bincount does (the host's F, bit for
//      bit), distinct bins go in parallel, and the chain is about the
//      row's longest bin, which no order-keeping scatter avoids (real rows
//      put many edges into few bins).  Bin 0,
//      F[0, 0] (other ranks to other ranks), is skipped: no slice sum,
//      feature or pair reads it (the slices start at column and row 1,
//      the features at group sa = 3, the pair entries at fa, fb >= sa),
//      and no real edge lands there (every edge of a row has an end on
//      rank a or b), only the pad edges (bin 0, volume 0).  F lives in
//      shared memory where it fits (A = B = 64 at most) and in a global
//      slab of the block's own (f_global, W x G x G) beyond: the same
//      arithmetic either way;
//   3. the slice sums row_to_a/b, col_from_a/b (4 G chains) and the four
//      flow scalars read off F (f_ao, f_oa, f_bo, f_ob), one thread a
//      chain, each a sequential sum in ascending index added to its direct
//      entry (F[g, 1] + (F[g, sa] + ... )); then the four flow scalars
//      over the slice sums (f_ab, f_ba, f_aa, f_bb) on warp 0; the scalars
//      land in the staged tail's scalar row;
//   4. one thread a shortlist slot: the pair's a- and b-columns (the seven
//      flow-derived rows from F and the slices, the seven host rows from
//      the tail) and its six pairwise entries (x_ab, x_ba from F, zero off
//      the candidate grid, and the four host corrections) as local arrays
//      of stride 1, then score_lane -- the one expression tree of all
//      three kernels -- combine_work (_rn intrinsics) and feasibility as
//      mem <= cap (caps pre-scaled, +inf when the constraint is off);
//   5. select: a slot counts when it is below the row's pair count, is
//      feasible and improves by more than 1e-12 (diff = w_before -
//      max(w_a, w_b)); else its score is -inf (infeasible slots hold NaN
//      diffs, inf - inf, which this masks, so no score is NaN).  Each
//      thread keeps its slots' first maximum, then a butterfly of warp
//      shuffles keeps the larger score, the lower slot on a tie: the first
//      maximum.  With P <= 32 warp 0 alone scores and selects (the other
//      warps leave after step 3); above, the warps' winners meet in shared
//      memory;
//   -> out (W, 4) float64: [slot, score, w_a, w_b] of the winner.
//
// What bounds it: at the balancer's sizes (W = 1..64 rows, eb = 32..1024
// edges, A = B = 16, P = 32) a row is some 8-20 KB, so neither bytes nor
// operations do (the bound is some 2e-5 ms at W 8, eb 256): latency does,
// one launch and the chain of dependent steps: the staging round trip,
// the split (three block barriers a chunk), the longest run of one bin,
// one slice sum and one flow scalar over them, one slot's tree and
// quotients, and a log2(32)-step shuffle.  The design spends one launch a
// window and one round trip for the row (eb <= SPEC_STAGES * SPEC_CHUNK;
// beyond, a chunk is copied as soon as the split has consumed its
// buffer), keeps every thread of the block busy in the split and the
// slice sums, and returns four numbers a row.
// The bulk copies move 16-byte granules: rows start 16-byte aligned (the
// row stride is even, the buffer aligned), eb is even, and the tail's copy
// may read the one pad value of an odd row length (stride >= row_len + 1).
constexpr int SPEC_THREADS = 256;
constexpr int SPEC_WARPS = SPEC_THREADS / 32;   // a power of two
constexpr int SPEC_CHUNK = 256;     // edges in a staging buffer
constexpr int SPEC_STAGES = 4;      // staging buffers of edges
static_assert(SPEC_CHUNK == SPEC_THREADS, "the split takes a chunk's edges "
              "one a thread");
constexpr int N_MISC = 6;           // alpha, beta, gamma, delta, w_before, p
constexpr int MAX_SMEM = 232448;    // one block's opt-in limit on sm_90
constexpr int DEFAULT_SMEM = 48 * 1024;
// the tail's and the staging buffers' mbarriers, in whole 16-byte granules
constexpr int SPEC_BARS_BYTES = (8 * (1 + SPEC_STAGES) + 15) / 16 * 16;
constexpr unsigned FULL_MASK = 0xffffffffu;

struct SpecGeom {
  int sa, sb, g_n;
  long long o_w, o_av, o_bv, o_pm, o_sc, o_ia, o_ib, o_ms, row_len;
};

// layout.spec_offsets and layout.spec_groups
__host__ __device__ inline SpecGeom spec_geom(int eb, int a_n, int b_n,
                                              int p_n) {
  SpecGeom g;
  g.sa = 3;
  g.sb = 3 + (a_n - 1);
  g.g_n = g.sb + (b_n - 1);
  g.o_w = eb;
  g.o_av = g.o_w + eb;
  g.o_bv = g.o_av + 7LL * a_n;
  g.o_pm = g.o_bv + 7LL * b_n;
  g.o_sc = g.o_pm + 4LL * p_n;
  g.o_ia = g.o_sc + N_SC;
  g.o_ib = g.o_ia + p_n;
  g.o_ms = g.o_ib + p_n;
  g.row_len = g.o_ms + N_MISC;
  return g;
}

// The staged tail (o_av .. row_len) in doubles, rounded up to whole
// 16-byte granules.
__host__ __device__ inline long long spec_tail(const SpecGeom& g) {
  const long long n = g.row_len - g.o_av;
  return n + (n & 1);
}

// Dynamic shared memory of one block, in bytes (kernel.spec_smem_bytes):
// the mbarriers, the tail, the edge buffers, F (when it lives there), the
// four slice sums, the warps' winners, each warp's edge list (volumes, int
// bins) and run buffer, and the split's counts.
inline long long spec_smem_bytes(int a_n, int b_n, int p_n, bool f_in_smem) {
  const SpecGeom g = spec_geom(0, a_n, b_n, p_n);
  const long long g_n = g.g_n;
  const long long doubles = spec_tail(g) + 2LL * SPEC_STAGES * SPEC_CHUNK
                            + (f_in_smem ? g_n * g_n : 0) + 4 * g_n
                            + 4 * SPEC_WARPS + SPEC_WARPS * (SPEC_CHUNK + 32);
  return SPEC_BARS_BYTES + 8 * doubles
         + 4LL * SPEC_WARPS * (SPEC_CHUNK + SPEC_WARPS + 1);
}

// s + (x[0] + x[stride] + ... ) (n terms from 0.0), one rounding each, in
// order; the terms loaded four at a time, so that only the additions chain.
__device__ __forceinline__ double seq_sum(double s,
                                          const double* __restrict__ x,
                                          int stride, int n) {
  double acc = 0.0;
  for (int k = 0; k < n; k += 4) {
    double v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = k + u < n ? x[(k + u) * stride] : 0.0;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (k + u < n) acc = __dadd_rn(acc, v[u]);
    }
  }
  return __dadd_rn(s, acc);
}

// Copy edge chunk c (its bins and its volumes) into staging buffer
// c % SPEC_STAGES; completes on that buffer's mbarrier.
__device__ __forceinline__ void spec_stage_chunk(double* edges,
                                                 const double* row, int eb,
                                                 int c, uint64_t* bars) {
  const int s = c % SPEC_STAGES;
  const int e0 = c * SPEC_CHUNK;
  const unsigned bytes = 8u * (unsigned)min(SPEC_CHUNK, eb - e0);
  double* dst = edges + 2 * SPEC_CHUNK * s;
  hopper::mbar_expect_tx(&bars[1 + s], 2 * bytes);
  hopper::bulk_load(dst, row + e0, bytes, &bars[1 + s]);
  hopper::bulk_load(dst + SPEC_CHUNK, row + eb + e0, bytes, &bars[1 + s]);
}

// The seven flow-derived feature rows (layout.AV intra .. in_other) of the
// candidate at group q, from F and its side's (own) and the other side's
// (peer) slice sums; zero for lane 0, the empty candidate.
__device__ __forceinline__ void spec_flow_rows(
    double* v, const double* F, int G, int q, bool on, const double* own_row,
    const double* own_col, const double* peer_row, const double* peer_col) {
  v[AV_INTRA] = on ? F[q * G + q] : 0.0;
  v[AV_OUT_OWN] = on ? own_row[q] : 0.0;
  v[AV_IN_OWN] = on ? own_col[q] : 0.0;
  v[AV_OUT_PEER] = on ? peer_row[q] : 0.0;
  v[AV_IN_PEER] = on ? peer_col[q] : 0.0;
  v[AV_OUT_OTHER] = on ? F[q * G] : 0.0;
  v[AV_IN_OTHER] = on ? F[q] : 0.0;
}

// The first maximum over a warp's (score, slot) candidates: the larger
// score, the lower slot on a tie (scores are never NaN); every lane ends
// with the winner and its works.
__device__ __forceinline__ void warp_first_max(double& s, int& j, double& wa,
                                               double& wb) {
  for (int off = 16; off > 0; off >>= 1) {
    const double os = __shfl_xor_sync(FULL_MASK, s, off);
    const int oj = __shfl_xor_sync(FULL_MASK, j, off);
    const double oa = __shfl_xor_sync(FULL_MASK, wa, off);
    const double ob = __shfl_xor_sync(FULL_MASK, wb, off);
    if (os > s || (os == s && oj < j)) {
      s = os;
      j = oj;
      wa = oa;
      wb = ob;
    }
  }
}

__global__ void __launch_bounds__(SPEC_THREADS)
ccm_scorer_spec_kernel(const double* __restrict__ buf,
                       double* __restrict__ out,
                       double* __restrict__ f_global, int eb, int a_n,
                       int b_n, int p_n, int stride) {
  extern __shared__ __align__(16) unsigned char spec_smem[];
  const SpecGeom g = spec_geom(eb, a_n, b_n, p_n);
  const int G = g.g_n, sa = g.sa, sb = g.sb, GG = G * G;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const double* row = buf + (long long)blockIdx.x * stride;
  const int n_chunks = (eb + SPEC_CHUNK - 1) / SPEC_CHUNK;

  uint64_t* bars = reinterpret_cast<uint64_t*>(spec_smem);  // tail, stages
  double* tail = reinterpret_cast<double*>(spec_smem + SPEC_BARS_BYTES);
  double* edges = tail + spec_tail(g);   // stage s: bins, then volumes
  double* sp = edges + 2 * SPEC_STAGES * SPEC_CHUNK;
  double* F;
  if (f_global != nullptr) {
    F = f_global + (long long)blockIdx.x * GG;
  } else {
    F = sp;
    sp += GG;
  }
  double* slices = sp;  sp += 4 * G;   // row_to_a, row_to_b, col_from_a/b
  double* best = sp;  sp += 4 * SPEC_WARPS;   // (score, slot, w_a, w_b)
  double* cvol = sp;  sp += SPEC_WARPS * SPEC_CHUNK;  // the warps' lists
  double* crun = sp;  sp += SPEC_WARPS * 32;
  int* cbin = reinterpret_cast<int*>(sp);    // then the split counts
  int* split = cbin + SPEC_WARPS * SPEC_CHUNK;
  double* sc = tail + (g.o_sc - g.o_av);
  const double* ms = tail + (g.o_ms - g.o_av);

  // 1. staging under zeroing F
  if (t == 0) {
    for (int i = 0; i <= SPEC_STAGES; ++i) hopper::mbar_init(&bars[i], 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (t == 0) {
    const unsigned bytes = 8u * (unsigned)spec_tail(g);
    hopper::mbar_expect_tx(&bars[0], bytes);
    hopper::bulk_load(tail, row + g.o_av, bytes, &bars[0]);
    for (int c = 0; c < min(n_chunks, SPEC_STAGES); ++c) {
      spec_stage_chunk(edges, row, eb, c, bars);
    }
  }
  for (int i = t; i < GG; i += SPEC_THREADS) F[i] = 0.0;
  __syncthreads();

  // 2. the scatter, edge order kept per bin: the block splits each chunk,
  // one edge a thread, into its owner warps' lists, in edge order; each
  // warp then takes its list 32 edges at a time: each bin's edges laid end
  // to end in order, its leader adds them up
  int* wbin = cbin + warp * SPEC_CHUNK;      // this warp's list
  double* wvol = cvol + warp * SPEC_CHUNK;
  double* wrun = crun + warp * 32;           // a group's runs of one bin
  for (int c = 0; c < n_chunks; ++c) {
    const int s = c % SPEC_STAGES;
    hopper::mbar_wait(&bars[1 + s], (c / SPEC_STAGES) & 1);
    const double* sbin = edges + 2 * SPEC_CHUNK * s;
    const double* svol = sbin + SPEC_CHUNK;
    const int n = min(SPEC_CHUNK, eb - c * SPEC_CHUNK);
    // this thread's edge: its owner warp (none: SPEC_WARPS), its place
    // among the warp's edges of that owner, and each owner's count
    const int b = t < n ? (int)sbin[t] : 0;
    const int owner = b > 0 && b < GG ? b & (SPEC_WARPS - 1) : SPEC_WARPS;
    unsigned peers = 0u;
    int count = 0;
#pragma unroll
    for (int o = 0; o < SPEC_WARPS; ++o) {
      const unsigned mask = __ballot_sync(FULL_MASK, owner == o);
      if (owner == o) peers = mask;
      if (lane == o) count = __popc(mask);
    }
    if (lane < SPEC_WARPS) split[warp * SPEC_WARPS + lane] = count;
    __syncthreads();
    if (t < SPEC_WARPS) {     // owner t's list: offsets over the warps
      int k[SPEC_WARPS];
#pragma unroll
      for (int w = 0; w < SPEC_WARPS; ++w) k[w] = split[w * SPEC_WARPS + t];
      int at = 0;
#pragma unroll
      for (int w = 0; w < SPEC_WARPS; ++w) {
        split[w * SPEC_WARPS + t] = at;
        at += k[w];
      }
      split[SPEC_WARPS * SPEC_WARPS + t] = at;
    }
    __syncthreads();
    if (owner < SPEC_WARPS) {
      const int at = split[warp * SPEC_WARPS + owner]
                     + __popc(peers & ((1u << lane) - 1));
      cbin[owner * SPEC_CHUNK + at] = b;
      cvol[owner * SPEC_CHUNK + at] = svol[t];
    }
    __syncthreads();                    // buffer s is consumed
    if (t == 0 && c + SPEC_STAGES < n_chunks) {
      spec_stage_chunk(edges, row, eb, c + SPEC_STAGES, bars);
    }
    const int cnt = split[SPEC_WARPS * SPEC_WARPS + warp];
    for (int j0 = 0; j0 < cnt; j0 += 32) {
      const bool in = j0 + lane < cnt;
      const int bin = in ? wbin[j0 + lane] : -1;
      const double v = in ? wvol[j0 + lane] : 0.0;
      const unsigned same = __match_any_sync(FULL_MASK, bin);
      const unsigned before = same & ((1u << lane) - 1);
      const bool leads = in && before == 0;
      const int len = __popc(same);
      // the runs end to end in their leaders' lane order: an exclusive
      // scan of the run lengths over the leaders
      int end_at = leads ? len : 0;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(FULL_MASK, end_at, d);
        if (lane >= d) end_at += y;
      }
      const int run_at = __shfl_sync(FULL_MASK, end_at - (leads ? len : 0),
                                     __ffs(same) - 1);
      if (in) wrun[run_at + __popc(before)] = v;
      __syncwarp();
      if (leads) {
        double acc = F[bin];
#pragma unroll 4
        for (int r = 0; r < len; ++r) acc = __dadd_rn(acc, wrun[run_at + r]);
        F[bin] = acc;
      }
      __syncwarp();
    }
  }
  hopper::mbar_wait(&bars[0], 0);      // the tail has landed
  __syncthreads();

  // 3. the slice sums and the flow scalars read off F: chain k of each
  // block of gp (>= G + 4, whole warps) is a group's slice sum, its last
  // ones (block 0) the four scalars; one loop, so a warp does not diverge
  const int gp = (G + 4 + 31) & ~31;
  for (int k = t; k < 4 * gp; k += SPEC_THREADS) {
    const int which = k / gp, r = k - which * gp;
    double s0 = 0.0;
    const double* x = F;
    int xs = 1, n = 0;
    double* dst = nullptr;
    if (r < G) {
      const bool to_a = (which & 1) == 0;   // rows into a / cols out of a
      const int lo = to_a ? sa : sb, len = to_a ? sb - sa : G - sb;
      if (which < 2) {                  // row_to_a / row_to_b of group r
        s0 = F[r * G + 1 + which];
        x = F + r * G + lo;
      } else {                          // col_from_a / col_from_b
        s0 = F[(which - 1) * G + r];
        x = F + lo * G + r;
        xs = G;
      }
      n = len;
      dst = slices + which * G + r;
    } else if (which == 0 && r < G + 4) {
      const int f = r - G;              // f_ao, f_oa, f_bo, f_ob
      const bool a_side = f < 2, col = (f & 1) == 0;
      const int lo = a_side ? sa : sb;
      n = a_side ? sb - sa : G - sb;
      s0 = col ? F[(a_side ? 1 : 2) * G] : F[a_side ? 1 : 2];
      x = col ? F + lo * G : F + lo;
      xs = col ? G : 1;
      dst = sc + SC_F_AO + f;
    }
    if (dst != nullptr) *dst = seq_sum(s0, x, xs, n);
  }
  __syncthreads();
  const double* rta = slices;
  const double* rtb = slices + G;
  const double* cfa = slices + 2 * G;
  const double* cfb = slices + 3 * G;
  if (t < 4) {    // f_ab, f_ba, f_aa, f_bb over the slice sums
    const double* x = (t == 0 || t == 3) ? rtb : rta;
    const bool a_cols = (t & 1) == 0;   // f_ab, f_aa sum over the a groups
    sc[SC_F_AB + t] = seq_sum(x[a_cols ? 1 : 2], x + (a_cols ? sa : sb), 1,
                              a_cols ? sb - sa : G - sb);
  }
  if (p_n > 32) {
    __syncthreads();
  } else {
    if (warp != 0) return;
    __syncwarp();
  }

  // 4. one thread a shortlist slot, each thread's first maximum
  const double* hav = tail;                          // host rows of a
  const double* hbv = tail + 7 * a_n;
  const double* pmh = tail + (g.o_pm - g.o_av);
  const double* iaf = tail + (g.o_ia - g.o_av);
  const double* ibf = tail + (g.o_ib - g.o_av);
  const double w_before = ms[4];
  const double p_count = ms[5];
  double best_s = -(double)INFINITY, best_a = 0.0, best_b = 0.0;
  int best_j = INT_MAX;
  for (int p = t; p < p_n; p += SPEC_THREADS) {
    const int ia = (int)iaf[p];
    const int ib = (int)ibf[p];
    double av[N_AV], bv[N_AV], pe[N_PM], o[N_OUT];
    spec_flow_rows(av, F, G, sa - 1 + ia, ia > 0, rta, cfa, rtb, cfb);
    spec_flow_rows(bv, F, G, sb - 1 + ib, ib > 0, rtb, cfb, rta, cfa);
#pragma unroll
    for (int k = 0; k < 7; ++k) {
      av[AV_LOAD + k] = hav[k * a_n + ia];
      bv[AV_LOAD + k] = hbv[k * b_n + ib];
    }
    const bool on = ia >= 1 && ib >= 1;
    const int fa = sa - 1 + ia, fb = sb - 1 + ib;
    pe[PM_X_AB] = on ? F[fa * G + fb] : 0.0;
    pe[PM_X_BA] = on ? F[fb * G + fa] : 0.0;
#pragma unroll
    for (int k = 0; k < 4; ++k) pe[PM_CS_A + k] = pmh[k * p_n + p];
    score_lane<double>(av, 1, bv, 1, pe, 1, sc, ia, ib, o);
    const bool feasible = o[OUT_MEM_A] <= sc[SC_MEM_CAP_A]
                          && o[OUT_MEM_B] <= sc[SC_MEM_CAP_B];
    const double w_a = combine_work(ms, o[OUT_LOAD_A], sc[SC_SPEED_A],
                                    o[OUT_OFF_A], o[OUT_ON_A], o[OUT_HOM_A]);
    const double w_b = combine_work(ms, o[OUT_LOAD_B], sc[SC_SPEED_B],
                                    o[OUT_OFF_B], o[OUT_ON_B], o[OUT_HOM_B]);
    const double diff = __dsub_rn(w_before, nan_max(w_a, w_b));
    const bool valid = (double)p < p_count;
    const double score = (valid && feasible && diff > 1e-12)
                         ? diff : -(double)INFINITY;
    if (best_j == INT_MAX || score > best_s) {
      best_s = score;
      best_j = p;
      best_a = w_a;
      best_b = w_b;
    }
  }

  // 5. the first maximum: within the warp, then across the warps
  warp_first_max(best_s, best_j, best_a, best_b);
  if (p_n > 32) {
    if (lane == 0) {
      best[4 * warp] = best_s;
      best[4 * warp + 1] = (double)best_j;
      best[4 * warp + 2] = best_a;
      best[4 * warp + 3] = best_b;
    }
    __syncthreads();
    if (warp != 0) return;
    const bool has = lane < SPEC_WARPS;
    best_s = has ? best[4 * lane] : -(double)INFINITY;
    best_j = has ? (int)best[4 * lane + 1] : INT_MAX;
    best_a = has ? best[4 * lane + 2] : 0.0;
    best_b = has ? best[4 * lane + 3] : 0.0;
    warp_first_max(best_s, best_j, best_a, best_b);
  }
  if (t == 0) {
    double* o = out + 4LL * blockIdx.x;
    o[0] = (double)best_j;
    o[1] = best_s;
    o[2] = best_a;
    o[3] = best_b;
  }
}

// Returned for an index off its tile (a bin outside F, a pair outside the
// lanes); no CUDA error code is negative.
constexpr int BAD_INDEX = -1;

int launch_spec(const double* buf, double* out, double* f_global, int w_n,
                int eb, int a_n, int b_n, int p_n, int stride,
                const double* host_buf, cudaStream_t stream) {
  const SpecGeom g = spec_geom(eb, a_n, b_n, p_n);
  // the bulk copies' 16-byte granules: an even eb and row stride, room for
  // the tail's rounded copy, an aligned buffer
  if (eb % 2 != 0 || stride % 2 != 0 || stride < g.o_av + spec_tail(g)
      || reinterpret_cast<uintptr_t>(buf) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const double gg = (double)g.g_n * g.g_n;
  // the launcher's host copy of the rows, checked here: a bin or a pair
  // off its tile would write or read outside F and the lanes
  if (host_buf != nullptr) {
    for (int w = 0; w < w_n; ++w) {
      const double* row = host_buf + (long long)w * stride;
      for (int e = 0; e < eb; ++e) {
        if (!(row[e] >= 0.0 && row[e] < gg)) return BAD_INDEX;
      }
      for (int p = 0; p < p_n; ++p) {
        const double ia = row[g.o_ia + p], ib = row[g.o_ib + p];
        if (!(ia >= 0.0 && ia < a_n && ib >= 0.0 && ib < b_n)) {
          return BAD_INDEX;
        }
      }
    }
  }
  const long long smem = spec_smem_bytes(a_n, b_n, p_n, f_global == nullptr);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (smem > DEFAULT_SMEM) {
    const cudaError_t rc = cudaFuncSetAttribute(
        ccm_scorer_spec_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  ccm_scorer_spec_kernel<<<(unsigned)w_n, SPEC_THREADS, (size_t)smem,
                           stream>>>(buf, out, f_global, eb, a_n, b_n, p_n,
                                     stride);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* av, const T* bv, const T* pm, const T* sc, T* out,
           int e_n, int a_n, int b_n, cudaStream_t stream) {
  const long long ab = (long long)a_n * b_n;
  const dim3 grid((unsigned)((ab + THREADS - 1) / THREADS), (unsigned)e_n);
  ccm_scorer_kernel<T><<<grid, THREADS, 0, stream>>>(av, bv, pm, sc, out,
                                                     a_n, b_n);
  return (int)cudaGetLastError();
}

constexpr int BAD_PAIR = BAD_INDEX;   // a pair off its tile

template <typename T>
int launch_pairs(const T* av, const T* bv, const T* pm, const T* sc,
                 const double* cf, const int* offs, const int* pairs,
                 double* out, int e_n, int a_n, int b_n, int p_total,
                 int mem_constraint, const int* host_pairs,
                 cudaStream_t stream) {
  // the launcher's host copy of the pairs, checked here rather than in
  // Python: a pair off its tile would read outside the tiles
  if (host_pairs != nullptr) {
    for (long long i = 0; i < 2LL * p_total; i += 2) {
      if (host_pairs[i] < 0 || host_pairs[i] >= a_n || host_pairs[i + 1] < 0
          || host_pairs[i + 1] >= b_n) {
        return BAD_PAIR;
      }
    }
  }
  ccm_scorer_pairs_kernel<T><<<(unsigned)e_n, PAIR_THREADS, 0, stream>>>(
      av, bv, pm, sc, cf, offs, reinterpret_cast<const int2*>(pairs), out,
      a_n, b_n, p_total, mem_constraint);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes.  Each returns the cudaError_t of the launch
// (0 on success) or BAD_PAIR / BAD_INDEX; the caller checks the shapes (e_n, a_n, b_n
// >= 1; pairs 8-byte aligned) and, unless it passes host_pairs, that every
// pair lies inside its padded tile.
extern "C" int ccm_scorer_f64(const double* av, const double* bv,
                              const double* pm, const double* sc, double* out,
                              int e_n, int a_n, int b_n, void* stream) {
  return launch<double>(av, bv, pm, sc, out, e_n, a_n, b_n,
                        (cudaStream_t)stream);
}

extern "C" int ccm_scorer_f32(const float* av, const float* bv,
                              const float* pm, const float* sc, float* out,
                              int e_n, int a_n, int b_n, void* stream) {
  return launch<float>(av, bv, pm, sc, out, e_n, a_n, b_n,
                       (cudaStream_t)stream);
}

extern "C" int ccm_scorer_pairs_f64(const double* av, const double* bv,
                                    const double* pm, const double* sc,
                                    const double* cf, const int* offs,
                                    const int* pairs, double* out, int e_n,
                                    int a_n, int b_n, int p_total,
                                    int mem_constraint,
                                    const int* host_pairs, void* stream) {
  return launch_pairs<double>(av, bv, pm, sc, cf, offs, pairs, out, e_n, a_n,
                              b_n, p_total, mem_constraint, host_pairs,
                              (cudaStream_t)stream);
}

extern "C" int ccm_scorer_pairs_f32(const float* av, const float* bv,
                                    const float* pm, const float* sc,
                                    const double* cf, const int* offs,
                                    const int* pairs, double* out, int e_n,
                                    int a_n, int b_n, int p_total,
                                    int mem_constraint,
                                    const int* host_pairs, void* stream) {
  return launch_pairs<float>(av, bv, pm, sc, cf, offs, pairs, out, e_n, a_n,
                             b_n, p_total, mem_constraint, host_pairs,
                             (cudaStream_t)stream);
}

// The speculative window: buf (W, stride) float64 rows in the
// layout.spec_offsets(eb, a_n, b_n, p_n) layout (row_len values, then
// padding up to stride), out (W, 4) float64, f_global a (W, G, G) float64
// scratch slab or null (F in shared memory).  Refused (cudaErrorInvalidValue)
// unless eb and stride are even, stride >= row_len rounded up to even and
// buf is 16-byte aligned.  The caller checks the shapes (W, eb, a_n, b_n,
// p_n >= 1; G * G < 2^31) and, unless it passes host_buf (a host copy of
// buf, checked here before the launch), that every bin and pair lies
// inside its tile.
extern "C" int ccm_scorer_spec_f64(const double* buf, double* out,
                                   double* f_global, int w_n, int eb, int a_n,
                                   int b_n, int p_n, int stride,
                                   const double* host_buf, void* stream) {
  return launch_spec(buf, out, f_global, w_n, eb, a_n, b_n, p_n, stride,
                     host_buf, (cudaStream_t)stream);
}

// The launcher's copies and its wait, on its stream: one copy of the
// packed buffer in and one of the (3, P) result out, from and to pinned
// host memory, so both are asynchronous.
extern "C" int ccm_scorer_copy(void* dst, const void* src, long long nbytes,
                               void* stream) {
  return (int)cudaMemcpyAsync(dst, src, (size_t)nbytes, cudaMemcpyDefault,
                              (cudaStream_t)stream);
}

extern "C" int ccm_scorer_sync(void* stream) {
  return (int)cudaStreamSynchronize((cudaStream_t)stream);
}

extern "C" const char* ccm_scorer_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
