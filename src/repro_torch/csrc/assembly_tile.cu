// MoM matrix-assembly tile: the regularised Green's-function quadrature of
// the paper's application (section VI), one output entry per (i, j).
//
// Replaces the Pallas TPU kernel repro/kernels/assembly/kernel.py:25
// (_tile_kernel, launched by assembly_tile_fwd over a (row-block, col-block)
// grid).  It computes repro_torch/kernels/assembly/ref.py::reference_tile
// term for term:
//
//   d    = sqrt(sq + 1e-12),  sq = |x_i - y_j|^2
//   Z_ij = couple_ij ? sum_{q<Q} w_q cos((3 d) r_q) / ((d + e_q) + 1e-3) : 0
//   r_q  = (q + 0.5) / Q,  w_q = 1 / Q,  e_q = 0.05 r_q
//
// r_q, w_q and e_q are double expressions in the reference (Python floats)
// that reach the float32 arithmetic rounded once each; the kernel computes
// them in double and rounds them to float once, into a shared-memory table.
// The ladder keeps the reference's order of operations and its q = 0..Q-1
// accumulation order.  sq is (dx*dx + dy*dy) + dz*dz in the direct mode, or
// the expansion max((|x|^2 + |y|^2) - 2<x, y>, 0) with K = 3 (three
// multiply-adds, no tensor core) when mxu_distance is set.  Build without
// --use_fast_math (cos reaches about 10.4 here, where __cosf loses
// accuracy), with IEEE division and sqrt (nvcc's defaults) and with
// --fmad=false.
//
// Layout, all contiguous: pr (nr, 3) float, pc (nc, 3) float, couple
// (nr, nc) uint8 (a bool tensor) -> out (nr, nc) float.  Grid
// (ceil(nc / block_c), ceil(nr / block_r)); a block of THREADS threads owns
// one block_r x block_c tile: it stages the tile's row and column
// coordinates and the quadrature table in shared memory, then its threads
// walk the tile's entries with stride THREADS, neighbouring threads on
// neighbouring columns (coalesced writes).  The ragged last tiles are
// bounds-checked: nothing is read or written past nr or nc.  An entry whose
// couple is 0 is written 0 without running the ladder (the reference masks
// it afterwards; the value is the same).
//
// Bound on an H100 SXM: per coupled entry the ladder is Q steps of a
// multiply, a cos, a multiply, two adds, a divide and an accumulate, against
// 5 bytes of mask and output per entry, so every Q >= 4 is bound by
// operations, not bytes.  Design: the coordinates are staged once per tile
// and the table once per block, so the loop body touches only registers and
// shared memory; the grid has one block per tile, so a caller sizes tiles
// to fill the 132 SMs (the application's tasks are at most 96 x 96 and use
// 16 x 16 tiles).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

template <bool kMxu>
__global__ void __launch_bounds__(THREADS)
assembly_tile_kernel(const float* __restrict__ pr,
                     const float* __restrict__ pc,
                     const unsigned char* __restrict__ couple,
                     float* __restrict__ out, int nr, int nc, int quad_order,
                     int block_r, int block_c) {
  extern __shared__ float smem[];
  float* s_pr = smem;                          // (block_r, 3)
  float* s_pc = s_pr + 3 * block_r;            // (block_c, 3)
  float* s_rq = s_pc + 3 * block_c;            // (Q,) r_q
  float* s_eq = s_rq + quad_order;             // (Q,) 0.05 r_q

  const int r0 = blockIdx.y * block_r;
  const int c0 = blockIdx.x * block_c;
  const int rows = min(block_r, nr - r0);
  const int cols = min(block_c, nc - c0);
  const int tid = threadIdx.x;

  for (int k = tid; k < 3 * rows; k += THREADS) s_pr[k] = pr[3 * r0 + k];
  for (int k = tid; k < 3 * cols; k += THREADS) s_pc[k] = pc[3 * c0 + k];
  for (int q = tid; q < quad_order; q += THREADS) {
    const double r = (q + 0.5) / quad_order;
    s_rq[q] = (float)r;
    s_eq[q] = (float)(0.05 * r);
  }
  const float w = (float)(1.0 / quad_order);
  __syncthreads();

  for (int e = tid; e < rows * cols; e += THREADS) {
    const int i = e / cols;
    const int j = e - i * cols;
    const long long o = (long long)(r0 + i) * nc + (c0 + j);
    if (!couple[o]) {
      out[o] = 0.0f;
      continue;
    }
    const float x0 = s_pr[3 * i], x1 = s_pr[3 * i + 1], x2 = s_pr[3 * i + 2];
    const float y0 = s_pc[3 * j], y1 = s_pc[3 * j + 1], y2 = s_pc[3 * j + 2];
    float sq;
    if (kMxu) {
      const float xx = (x0 * x0 + x1 * x1) + x2 * x2;
      const float yy = (y0 * y0 + y1 * y1) + y2 * y2;
      const float xy = (x0 * y0 + x1 * y1) + x2 * y2;
      sq = (xx + yy) - 2.0f * xy;
      sq = sq < 0.0f ? 0.0f : sq;  // cancellation; NaN stays NaN
    } else {
      const float d0 = x0 - y0, d1 = x1 - y1, d2 = x2 - y2;
      sq = (d0 * d0 + d1 * d1) + d2 * d2;
    }
    const float d = sqrtf(sq + 1e-12f);
    const float kd = 3.0f * d;
    float acc = 0.0f;
    for (int q = 0; q < quad_order; ++q) {
      acc = acc + w * cosf(kd * s_rq[q]) / ((d + s_eq[q]) + 1e-3f);
    }
    out[o] = acc;
  }
}

template <bool kMxu>
int launch(const float* pr, const float* pc, const unsigned char* couple,
           float* out, int nr, int nc, int quad_order, int block_r,
           int block_c, cudaStream_t stream) {
  const dim3 grid((unsigned)((nc + block_c - 1) / block_c),
                  (unsigned)((nr + block_r - 1) / block_r));
  const size_t smem = sizeof(float) * (3 * (size_t)(block_r + block_c)
                                       + 2 * (size_t)quad_order);
  assembly_tile_kernel<kMxu><<<grid, THREADS, smem, stream>>>(
      pr, pc, couple, out, nr, nc, quad_order, block_r, block_c);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes.  Returns the cudaError_t of the launch (0 on
// success); the caller checks the shapes (nr, nc, quad_order, block_r,
// block_c >= 1, shared memory under 48 KB).
extern "C" int assembly_tile_f32(const float* pr, const float* pc,
                                 const unsigned char* couple, float* out,
                                 int nr, int nc, int quad_order, int block_r,
                                 int block_c, int mxu_distance, void* stream) {
  if (mxu_distance) {
    return launch<true>(pr, pc, couple, out, nr, nc, quad_order, block_r,
                        block_c, (cudaStream_t)stream);
  }
  return launch<false>(pr, pc, couple, out, nr, nc, quad_order, block_r,
                       block_c, (cudaStream_t)stream);
}

extern "C" const char* assembly_tile_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
