// CCM stage-2 exchange scorer: the ten work components of every candidate
// cluster pair of a batch of lock events.
//
// Replaces the Pallas TPU kernel repro/kernels/ccm_scorer/kernel.py:35
// (_scorer_kernel, launched by score_tiles_fwd with grid=(E,)).  It computes
// repro_torch/kernels/ccm_scorer/ref.py::score_planes term for term.
//
// Layout (repro_torch/kernels/ccm_scorer/layout.py), all contiguous:
//   av (E, N_AV, A), bv (E, N_AV, B), pm (E, N_PM, A, B), sc (E, N_SC)
//   -> out (E, N_OUT, A, B)
// One thread per (event, ia, ib) lane; grid = (ceil(A*B / 128), E).  A lane
// reads its 14 a-features, 14 b-features, 6 pairwise planes and the event's
// scalars, and writes all ten output planes from registers.  Lanes past the
// event's (na, nb) are the masked tail: 0 on the load/flow/homing planes,
// +inf on the memory planes.
//
// Bitwise contract: the tree uses only add, sub, max, compare and select, in
// the exact left-to-right association of ref.py, so every lane is the IEEE
// result of the same operations as the plain version (float64 and float32
// alike).  Build without --use_fast_math and with --fmad=false (nothing here
// multiplies, but no contraction may ever creep in).  np.maximum and
// torch.maximum propagate NaN, while CUDA's fmax returns the other operand,
// so max is the explicit select nan_max below (torch.maximum's rule,
// including which operand a tie returns).
//
// Bound on an H100 SXM (3.35 TB/s HBM3): the kernel must read each input
// once and write the output once, E*(14*(A+B) + 6*A*B + 32 + 10*A*B)
// elements of sizeof(T) bytes, against about 108 add/sub/max/compare
// operations per lane, so it is bound by bytes (16 elements, 128 B in
// float64, per lane against 108 operations).  Design: the pairwise planes
// and the output, which are the A*B-sized traffic, are touched exactly once
// each, coalesced along ib; the per-candidate rows (A+B sized) are re-read
// by the lanes that share them and are served from L1/L2.  At the main
// path's tiles (E = 1..8, A, B <= 13: tens of kilobytes) the bound is a few
// nanoseconds and the launch itself costs microseconds, so the kernel is
// kept simple; launch count and the host copies around it are the lever.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int N_AV = 14;
constexpr int N_PM = 6;
constexpr int N_SC = 32;
constexpr int N_OUT = 10;
constexpr int THREADS = 128;

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
       SC_NA, SC_NB };
// layout.OUT
enum { OUT_LOAD_A = 0, OUT_LOAD_B, OUT_OFF_A, OUT_OFF_B, OUT_ON_A, OUT_ON_B,
       OUT_HOM_A, OUT_HOM_B, OUT_MEM_A, OUT_MEM_B };

// torch.maximum / np.maximum: a NaN operand wins (the first one if both)
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  return (a < b) ? b : a;
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

  const T* a = av + e * N_AV * a_n + ia;      // a-feature i at a[i * a_n]
  const T* b = bv + e * N_AV * b_n + ib;      // b-feature i at b[i * b_n]
  const T* p = pm + e * N_PM * ab + lane;     // plane k at p[k * ab]
  const T* s = sc + e * N_SC;
  T* o = out + e * N_OUT * ab + lane;         // plane k at o[k * ab]

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
  o[OUT_LOAD_A * ab] = live ? load_a : zero;
  o[OUT_LOAD_B * ab] = live ? load_b : zero;
  o[OUT_OFF_A * ab] = live ? off_a : zero;
  o[OUT_OFF_B * ab] = live ? off_b : zero;
  o[OUT_ON_A * ab] = live ? on_a : zero;
  o[OUT_ON_B * ab] = live ? on_b : zero;
  o[OUT_HOM_A * ab] = live ? hom_a : zero;
  o[OUT_HOM_B * ab] = live ? hom_b : zero;
  o[OUT_MEM_A * ab] = live ? mem_a : inf;
  o[OUT_MEM_B * ab] = live ? mem_b : inf;
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

}  // namespace

// Plain C interface for ctypes.  Each returns the cudaError_t of the launch
// (0 on success); the caller checks the shapes (e_n, a_n, b_n >= 1).
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

extern "C" const char* ccm_scorer_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
