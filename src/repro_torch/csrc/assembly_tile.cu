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
// Each term keeps the reference's order of operations and the terms are
// added in q = 0..Q-1 order, so the output does not depend on the launch
// geometry.  sq is (dx*dx + dy*dy) + dz*dz in the direct mode, or the
// expansion max((|x|^2 + |y|^2) - 2<x, y>, 0) with K = 3 (three
// multiply-adds, no tensor core) when mxu_distance is set.  Build without
// --use_fast_math (cos reaches about 10.4 here, where __cosf loses
// accuracy), with IEEE division and sqrt (nvcc's defaults) and with
// --fmad=false.
//
// Layout, all contiguous: pr (nr, 3) float, pc (nc, 3) float, couple
// (nr, nc) uint8 (a bool tensor) -> out (nr, nc) float.  The launch
// geometry comes from repro_torch/kernels/assembly/kernel.py::
// launch_geometry: a block owns a tile_r x tile_c tile of entries (the
// caller's tile cut to at most 256 / lanes entries) and gives each entry
// `lanes` threads, about sqrt(Q) of them.  Grid (ceil(nc / tile_c),
// ceil(nr / tile_r)).  A block stages its tile's coordinates, its mask (in
// 4-byte words where the rows are word-aligned) and the quadrature table
// in shared memory, each thread issuing its loads before its stores, so
// the staging costs one round trip to memory.  Then, for each segment of
// at most `segment` quadrature steps: the lanes of an entry compute its
// terms (lane l takes steps l, l + lanes, ...) into a shared-memory row,
// and after one barrier thread e adds entry e's row in q order to its
// running sum (rows padded to an odd length, so the owners read distinct
// banks).  The owners write the tile, neighbouring threads on neighbouring
// columns (coalesced).  The ragged last tiles are bounds-checked: nothing
// is read or written past nr or nc.  An uncoupled entry is written 0
// without running its ladder (the reference masks it afterwards; the value
// is the same).
//
// Bound on an H100 SXM: per coupled entry the ladder is Q steps of a
// multiply, a cos, a multiply, two adds, a divide and an accumulate, against
// 5 bytes of mask and output per entry, so every Q >= 4 is bound by
// operations, not bytes.  What bounded the first design (one thread an
// entry, walking its whole ladder; 16 x 16 tiles of 256 threads): a 96 x 96
// task was 288 warps on 36 SMs, so at Q = 192 each thread ran 192 steps of a
// branching cos with too few warps to hide its latency (0.028 ms device
// time against a 0.0002 ms bound), and 96 of the 132 SMs idled; and its
// staging took three round trips to memory one after another.  This design
// spreads a ladder over about sqrt(Q) lanes (8 at Q = 192: 2304 warps on
// every SM), which measured fastest on an H100 among 1 to 32 lanes; the
// ordered sum costs one shared-memory read and one add a step on one
// lane, against a cos and a divide on another.  What bounds it now: at
// Q = 4 the launch and one round trip to memory (an empty kernel of the
// same grid takes some 2 of its 3.5 microseconds); at Q = 192 the issue of
// the ladder's some 60 instructions a step (cos's range reduction and
// polynomial, the IEEE divide), which nothing here may shorten without
// changing the result.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 256;

template <bool kMxu>
__global__ void __launch_bounds__(MAX_THREADS)
assembly_tile_kernel(const float* __restrict__ pr,
                     const float* __restrict__ pc,
                     const unsigned char* __restrict__ couple,
                     float* __restrict__ out, int nr, int nc, int quad_order,
                     int tile_r, int tile_c, int lanes, int segment) {
  extern __shared__ float smem[];
  const int slots = tile_r * tile_c;
  const int pitch = segment | 1;               // odd: owners on distinct banks
  float* s_pr = smem;                          // (tile_r, 3)
  float* s_pc = s_pr + 3 * tile_r;             // (tile_c, 3)
  float* s_rq = s_pc + 3 * tile_c;             // (Q,) r_q
  float* s_eq = s_rq + quad_order;             // (Q,) 0.05 r_q
  float* s_term = s_eq + quad_order;           // (slots, pitch) terms
  unsigned char* s_cp =                        // (slots,) mask
      reinterpret_cast<unsigned char*>(s_term + slots * pitch);

  const int r0 = blockIdx.y * tile_r;
  const int c0 = blockIdx.x * tile_c;
  const int rows = min(tile_r, nr - r0);
  const int cols = min(tile_c, nc - c0);
  const int n = rows * cols;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;

  // stage the coordinates, the mask (entry e = i * cols + j at s_cp[e], in
  // 4-byte words where the rows are word-aligned) and the quadrature table;
  // each thread issues its loads before its stores, so the block waits on
  // one round trip to memory
  const unsigned char* cp = couple + (long long)r0 * nc + c0;
  const bool wide = ((nc | c0 | cols) & 3) == 0
                    && (reinterpret_cast<uintptr_t>(couple) & 3) == 0;
  const int words = wide ? cols >> 2 : cols;   // mask loads a row
  const int todo = max(max(3 * rows, 3 * cols), max(rows * words,
                                                    quad_order));
  for (int k = tid; k < todo; k += nthreads) {
    const float x = k < 3 * rows ? pr[3 * r0 + k] : 0.0f;
    const float y = k < 3 * cols ? pc[3 * c0 + k] : 0.0f;
    unsigned m = 0;
    const int i = k / words;
    if (i < rows) {
      const unsigned char* src = cp + (long long)i * nc;
      m = wide ? reinterpret_cast<const unsigned*>(src)[k - i * words]
               : src[k - i * words];
    }
    if (k < quad_order) {
      const double r = (k + 0.5) / quad_order;
      s_rq[k] = (float)r;
      s_eq[k] = (float)(0.05 * r);
    }
    if (k < 3 * rows) s_pr[k] = x;
    if (k < 3 * cols) s_pc[k] = y;
    if (i < rows) {
      if (wide) {
        reinterpret_cast<unsigned*>(s_cp)[k] = m;
      } else {
        s_cp[k] = (unsigned char)m;
      }
    }
  }
  const float w = (float)(1.0 / quad_order);
  __syncthreads();

  // this thread's lane of entry e's ladder
  const int e = tid / lanes;
  const int lane = tid - e * lanes;
  const bool live = e < n && s_cp[e];
  float d = 0.0f, kd = 0.0f;
  if (live) {
    const int i = e / cols;
    const int j = e - i * cols;
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
    d = sqrtf(sq + 1e-12f);
    kd = 3.0f * d;
  }
  // thread tid adds up entry tid's terms
  const bool owner = tid < n && s_cp[tid];
  const float* row = s_term + tid * pitch;
  float acc = 0.0f;
  for (int q0 = 0; q0 < quad_order; q0 += segment) {
    const int m = min(segment, quad_order - q0);
    if (live) {
      float* mine = s_term + e * pitch;
      for (int q = lane; q < m; q += lanes) {
        mine[q] = w * cosf(kd * s_rq[q0 + q])
                  / ((d + s_eq[q0 + q]) + 1e-3f);
      }
    }
    __syncthreads();
    if (owner) {
      for (int q = 0; q < m; ++q) acc = acc + row[q];
    }
    if (q0 + segment < quad_order) __syncthreads();  // the rows are reused
  }
  if (tid < n) {
    const int i = tid / cols;
    out[(long long)(r0 + i) * nc + c0 + (tid - i * cols)] = owner ? acc : 0.0f;
  }
}

size_t smem_bytes(int quad_order, int tile_r, int tile_c, int segment) {
  const size_t slots = (size_t)tile_r * tile_c;
  return sizeof(float) * (3 * (size_t)(tile_r + tile_c)
                          + 2 * (size_t)quad_order + slots * (segment | 1))
         + slots;
}

template <bool kMxu>
int launch(const float* pr, const float* pc, const unsigned char* couple,
           float* out, int nr, int nc, int quad_order, int tile_r,
           int tile_c, int lanes, int segment, int threads, int smem,
           cudaStream_t stream) {
  if (quad_order < 1 || tile_r < 1 || tile_c < 1 || lanes < 1
      || segment < 1 || segment > quad_order || threads > MAX_THREADS
      || threads % 32 != 0 || threads < tile_r * tile_c * lanes
      || (size_t)smem < smem_bytes(quad_order, tile_r, tile_c, segment)) {
    return (int)cudaErrorInvalidValue;
  }
  if (smem > 48 * 1024) {           // past the default, opt in (a host call)
    cudaError_t err = cudaFuncSetAttribute(
        assembly_tile_kernel<kMxu>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)((nc + tile_c - 1) / tile_c),
                  (unsigned)((nr + tile_r - 1) / tile_r));
  assembly_tile_kernel<kMxu><<<grid, threads, smem, stream>>>(
      pr, pc, couple, out, nr, nc, quad_order, tile_r, tile_c, lanes,
      segment);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes.  The geometry (tile, lanes, segment,
// threads, shared bytes) is kernel.py::launch_geometry's; an inconsistent
// one is refused with cudaErrorInvalidValue.  Returns the cudaError_t of
// the launch (0 on success).
extern "C" int assembly_tile_f32(const float* pr, const float* pc,
                                 const unsigned char* couple, float* out,
                                 int nr, int nc, int quad_order, int tile_r,
                                 int tile_c, int lanes, int segment,
                                 int threads, int smem, int mxu_distance,
                                 void* stream) {
  if (mxu_distance) {
    return launch<true>(pr, pc, couple, out, nr, nc, quad_order, tile_r,
                        tile_c, lanes, segment, threads, smem,
                        (cudaStream_t)stream);
  }
  return launch<false>(pr, pc, couple, out, nr, nc, quad_order, tile_r,
                       tile_c, lanes, segment, threads, smem,
                       (cudaStream_t)stream);
}

extern "C" const char* assembly_tile_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
