// Hopper (sm_90a) building blocks shared by the port's bf16 tensor-core
// kernels (flash_attention.cu, moe_gemm.cu), the CCM window kernel
// (ccm_scorer.cu) and the RG-LRU backward's ring (rglru.cu):
// shared-memory barriers (mbarrier), TMA tile loads and stores
// (cp.async.bulk.tensor) and the tensor maps that describe them, 1-D bulk
// copies (cp.async.bulk), warpgroup register hand-off (setmaxnreg), and
// warpgroup matrix products (wgmma.mma_async) on 128-byte-swizzled shared
// tiles.
//
// Tile layout.  Every operand tile is loaded by TMA with
// CU_TENSOR_MAP_SWIZZLE_128B and a box whose inner extent is 64 bf16 (128
// bytes): a box of R rows is R x 128 bytes, 1024-byte aligned, with the 16-byte
// chunks of row r permuted by r % 8.  wgmma reads such a tile through a
// matrix descriptor (desc_sw128) in one of two ways:
//   K-major (the reduction dimension is the contiguous one, q and k of
//   attention, the tokens of the expert GEMM): rows are M or N, 8-row groups
//   1024 bytes apart (SBO); a k16 step inside the 64-wide box advances the
//   start address by 32 bytes, the next box by R x 128.
//   MN-major (the transpose bit; v of attention and the expert weights,
//   whose rows are the reduction dimension): rows are K, 8-row groups 1024
//   bytes apart (SBO); a k16 step advances by 16 rows = 2048 bytes; the next
//   64 columns of M or N lie one box further on (LBO = the box's bytes).
// Accumulators are float32 in registers, in wgmma's m64nN layout: thread t
// of the warpgroup holds rows 16 (t / 32) + (t % 32) / 4 + 8 i and columns
// 8 j + 2 (t % 4) + e in d[4 j + 2 i + e].
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------ mbarriers
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// arrive once and expect `bytes` of TMA traffic before the phase completes
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// wait until the phase of parity `parity` has completed (a fresh barrier
// counts its phase before 0, parity 1, as completed)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// ----------------------------------------------------------------- TMA
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}
// the box of a rank-3 map at element coordinates (c0, c1, c2), innermost
// first, into shared memory; completes `bytes` (the box's) on `bar`.
// Elements outside the tensor arrive as zeros.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// the box at shared `src` (laid out as a load of the same map would leave
// it) to a rank-3 map at element coordinates (c0, c1, c2); elements
// outside the tensor are not written.  Asynchronous: bulk_commit groups
// the stores started so far, bulk_wait_read<N> waits until all but the last
// N groups have read their shared memory.  Shared memory written by
// threads is made visible to the store by fence_proxy_async (each writer)
// and a barrier before the store starts.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// `bytes` (a multiple of 16) of contiguous memory from global `src` to
// shared `dst`, both 16-byte aligned, by one bulk copy (no tensor map);
// completes `bytes` on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ----------------------------------------------- warpgroup registers
template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
// a barrier over the `threads` threads (whole warps) that name `id` (1..15;
// 0 is __syncthreads)
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---------------------------------------------------------------- wgmma
// matrix descriptor of a 128-byte-swizzled tile at p (see the top note)
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4)
         | static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16
         | static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32
         | static_cast<uint64_t>(1) << 62;
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving an accumulator's reads or writes across
// an asynchronous wgmma
template <int R>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The operand lists of wgmma: accumulators d[0 .. R) as "%3 .. " (A and B
// from shared memory: %0, %1 the descriptors, %2 scale-d) or "%6 .. " (A
// from registers: %0 .. %3 its fragment, %4 B's descriptor, %5 scale-d).
#define HOPPER_SS_ACC_4 "%3, %4, %5, %6"
#define HOPPER_SS_ACC_8 HOPPER_SS_ACC_4 ", %7, %8, %9, %10"
#define HOPPER_SS_ACC_12 HOPPER_SS_ACC_8 ", %11, %12, %13, %14"
#define HOPPER_SS_ACC_16 HOPPER_SS_ACC_12 ", %15, %16, %17, %18"
#define HOPPER_SS_ACC_20 HOPPER_SS_ACC_16 ", %19, %20, %21, %22"
#define HOPPER_SS_ACC_24 HOPPER_SS_ACC_20 ", %23, %24, %25, %26"
#define HOPPER_SS_ACC_28 HOPPER_SS_ACC_24 ", %27, %28, %29, %30"
#define HOPPER_SS_ACC_32 HOPPER_SS_ACC_28 ", %31, %32, %33, %34"
#define HOPPER_SS_ACC_36 HOPPER_SS_ACC_32 ", %35, %36, %37, %38"
#define HOPPER_SS_ACC_40 HOPPER_SS_ACC_36 ", %39, %40, %41, %42"
#define HOPPER_SS_ACC_44 HOPPER_SS_ACC_40 ", %43, %44, %45, %46"
#define HOPPER_SS_ACC_48 HOPPER_SS_ACC_44 ", %47, %48, %49, %50"
#define HOPPER_SS_ACC_52 HOPPER_SS_ACC_48 ", %51, %52, %53, %54"
#define HOPPER_SS_ACC_56 HOPPER_SS_ACC_52 ", %55, %56, %57, %58"
#define HOPPER_SS_ACC_60 HOPPER_SS_ACC_56 ", %59, %60, %61, %62"
#define HOPPER_SS_ACC_64 HOPPER_SS_ACC_60 ", %63, %64, %65, %66"
#define HOPPER_SS_ACC_68 HOPPER_SS_ACC_64 ", %67, %68, %69, %70"
#define HOPPER_SS_ACC_72 HOPPER_SS_ACC_68 ", %71, %72, %73, %74"
#define HOPPER_SS_ACC_76 HOPPER_SS_ACC_72 ", %75, %76, %77, %78"
#define HOPPER_SS_ACC_80 HOPPER_SS_ACC_76 ", %79, %80, %81, %82"
#define HOPPER_SS_ACC_84 HOPPER_SS_ACC_80 ", %83, %84, %85, %86"
#define HOPPER_SS_ACC_88 HOPPER_SS_ACC_84 ", %87, %88, %89, %90"
#define HOPPER_SS_ACC_92 HOPPER_SS_ACC_88 ", %91, %92, %93, %94"
#define HOPPER_SS_ACC_96 HOPPER_SS_ACC_92 ", %95, %96, %97, %98"
#define HOPPER_SS_ACC_100 HOPPER_SS_ACC_96 ", %99, %100, %101, %102"
#define HOPPER_SS_ACC_104 HOPPER_SS_ACC_100 ", %103, %104, %105, %106"
#define HOPPER_SS_ACC_108 HOPPER_SS_ACC_104 ", %107, %108, %109, %110"
#define HOPPER_SS_ACC_112 HOPPER_SS_ACC_108 ", %111, %112, %113, %114"
#define HOPPER_SS_ACC_116 HOPPER_SS_ACC_112 ", %115, %116, %117, %118"
#define HOPPER_SS_ACC_120 HOPPER_SS_ACC_116 ", %119, %120, %121, %122"
#define HOPPER_SS_ACC_124 HOPPER_SS_ACC_120 ", %123, %124, %125, %126"
#define HOPPER_SS_ACC_128 HOPPER_SS_ACC_124 ", %127, %128, %129, %130"
#define HOPPER_RS_ACC_4 "%6, %7, %8, %9"
#define HOPPER_RS_ACC_8 HOPPER_RS_ACC_4 ", %10, %11, %12, %13"
#define HOPPER_RS_ACC_12 HOPPER_RS_ACC_8 ", %14, %15, %16, %17"
#define HOPPER_RS_ACC_16 HOPPER_RS_ACC_12 ", %18, %19, %20, %21"
#define HOPPER_RS_ACC_20 HOPPER_RS_ACC_16 ", %22, %23, %24, %25"
#define HOPPER_RS_ACC_24 HOPPER_RS_ACC_20 ", %26, %27, %28, %29"
#define HOPPER_RS_ACC_28 HOPPER_RS_ACC_24 ", %30, %31, %32, %33"
#define HOPPER_RS_ACC_32 HOPPER_RS_ACC_28 ", %34, %35, %36, %37"
#define HOPPER_RS_ACC_36 HOPPER_RS_ACC_32 ", %38, %39, %40, %41"
#define HOPPER_RS_ACC_40 HOPPER_RS_ACC_36 ", %42, %43, %44, %45"
#define HOPPER_RS_ACC_44 HOPPER_RS_ACC_40 ", %46, %47, %48, %49"
#define HOPPER_RS_ACC_48 HOPPER_RS_ACC_44 ", %50, %51, %52, %53"
#define HOPPER_RS_ACC_52 HOPPER_RS_ACC_48 ", %54, %55, %56, %57"
#define HOPPER_RS_ACC_56 HOPPER_RS_ACC_52 ", %58, %59, %60, %61"
#define HOPPER_RS_ACC_60 HOPPER_RS_ACC_56 ", %62, %63, %64, %65"
#define HOPPER_RS_ACC_64 HOPPER_RS_ACC_60 ", %66, %67, %68, %69"
#define HOPPER_ACC_OPS_4 "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
#define HOPPER_ACC_OPS_8 HOPPER_ACC_OPS_4, \
    "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
#define HOPPER_ACC_OPS_12 HOPPER_ACC_OPS_8, \
    "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
#define HOPPER_ACC_OPS_16 HOPPER_ACC_OPS_12, \
    "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define HOPPER_ACC_OPS_20 HOPPER_ACC_OPS_16, \
    "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
#define HOPPER_ACC_OPS_24 HOPPER_ACC_OPS_20, \
    "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
#define HOPPER_ACC_OPS_28 HOPPER_ACC_OPS_24, \
    "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
#define HOPPER_ACC_OPS_32 HOPPER_ACC_OPS_28, \
    "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define HOPPER_ACC_OPS_36 HOPPER_ACC_OPS_32, \
    "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
#define HOPPER_ACC_OPS_40 HOPPER_ACC_OPS_36, \
    "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
#define HOPPER_ACC_OPS_44 HOPPER_ACC_OPS_40, \
    "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43])
#define HOPPER_ACC_OPS_48 HOPPER_ACC_OPS_44, \
    "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
#define HOPPER_ACC_OPS_52 HOPPER_ACC_OPS_48, \
    "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51])
#define HOPPER_ACC_OPS_56 HOPPER_ACC_OPS_52, \
    "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
#define HOPPER_ACC_OPS_60 HOPPER_ACC_OPS_56, \
    "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59])
#define HOPPER_ACC_OPS_64 HOPPER_ACC_OPS_60, \
    "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define HOPPER_ACC_OPS_68 HOPPER_ACC_OPS_64, \
    "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67])
#define HOPPER_ACC_OPS_72 HOPPER_ACC_OPS_68, \
    "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71])
#define HOPPER_ACC_OPS_76 HOPPER_ACC_OPS_72, \
    "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75])
#define HOPPER_ACC_OPS_80 HOPPER_ACC_OPS_76, \
    "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
#define HOPPER_ACC_OPS_84 HOPPER_ACC_OPS_80, \
    "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83])
#define HOPPER_ACC_OPS_88 HOPPER_ACC_OPS_84, \
    "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87])
#define HOPPER_ACC_OPS_92 HOPPER_ACC_OPS_88, \
    "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91])
#define HOPPER_ACC_OPS_96 HOPPER_ACC_OPS_92, \
    "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
#define HOPPER_ACC_OPS_100 HOPPER_ACC_OPS_96, \
    "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99])
#define HOPPER_ACC_OPS_104 HOPPER_ACC_OPS_100, \
    "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103])
#define HOPPER_ACC_OPS_108 HOPPER_ACC_OPS_104, \
    "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107])
#define HOPPER_ACC_OPS_112 HOPPER_ACC_OPS_108, \
    "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111])
#define HOPPER_ACC_OPS_116 HOPPER_ACC_OPS_112, \
    "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115])
#define HOPPER_ACC_OPS_120 HOPPER_ACC_OPS_116, \
    "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119])
#define HOPPER_ACC_OPS_124 HOPPER_ACC_OPS_120, \
    "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123])
#define HOPPER_ACC_OPS_128 HOPPER_ACC_OPS_124, \
    "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])


// d (+)= A . B, m64nNk16, bf16 in, float32 out; A and B from shared memory
// through descriptors; TA, TB: the transpose bits (1 = MN-major).
// scale_d = 0 overwrites d.
template <int N, int TA, int TB>
struct WgmmaSS;
#define HOPPER_WGMMA_SS(N, R, TA, TB)                                        \
  template <>                                                                \
  struct WgmmaSS<N, TA, TB> {                                                \
    __device__ __forceinline__ static void run(float* d, uint64_t da,        \
                                               uint64_t db, int scale_d) {   \
      asm volatile(                                                          \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n"                        \
          "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {"      \
          HOPPER_SS_ACC_##R "}, %0, %1, p, 1, 1, " #TA ", " #TB ";\n}\n"     \
          : "+l"(da), "+l"(db), "+r"(scale_d), HOPPER_ACC_OPS_##R);          \
    }                                                                        \
  };

// d (+)= A . B, m64nNk16, A from registers (four bf16 pairs a thread, the
// layout of the accumulator rows and columns 2 (t % 4) + {0, 1} (+ 8)),
// B from shared memory; TB: B's transpose bit.
template <int N, int TB>
struct WgmmaRS;
#define HOPPER_WGMMA_RS(N, R, TB)                                            \
  template <>                                                                \
  struct WgmmaRS<N, TB> {                                                    \
    __device__ __forceinline__ static void run(float* d, uint32_t a0,        \
                                               uint32_t a1, uint32_t a2,     \
                                               uint32_t a3, uint64_t db,     \
                                               int scale_d) {                \
      asm volatile(                                                          \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %5, 0;\n"                        \
          "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {"      \
          HOPPER_RS_ACC_##R "}, {%0, %1, %2, %3}, %4, p, 1, 1, " #TB         \
          ";\n}\n"                                                           \
          : "+r"(a0), "+r"(a1), "+r"(a2), "+r"(a3), "+l"(db), "+r"(scale_d), \
            HOPPER_ACC_OPS_##R);                                             \
    }                                                                        \
  };

// the products the kernels run: the expert GEMM's forward (weights
// MN-major, tokens K-major, N any multiple of 8 up to 256) and backward
// (dX: both K-major; dW: both MN-major; N a multiple of 64), attention's
// q . k^T (both K-major, N = 64) and p . v (p from registers, v MN-major),
// which its backward reuses (S, dP and their transposes K-major; dV, dK
// and dQ with P or dS from registers and dO, q or k MN-major); at hd 256
// the backward's S^T and dP^T a half tile at a time (both K-major, N = 32)
// and dV, dK a half of hd at a time with P^T or dS^T from shared memory
// (K-major) and dO or q MN-major (N = 128)
HOPPER_WGMMA_SS(8, 4, 1, 0)
HOPPER_WGMMA_SS(16, 8, 1, 0)
HOPPER_WGMMA_SS(24, 12, 1, 0)
HOPPER_WGMMA_SS(32, 16, 1, 0)
HOPPER_WGMMA_SS(40, 20, 1, 0)
HOPPER_WGMMA_SS(48, 24, 1, 0)
HOPPER_WGMMA_SS(56, 28, 1, 0)
HOPPER_WGMMA_SS(64, 32, 1, 0)
HOPPER_WGMMA_SS(72, 36, 1, 0)
HOPPER_WGMMA_SS(80, 40, 1, 0)
HOPPER_WGMMA_SS(88, 44, 1, 0)
HOPPER_WGMMA_SS(96, 48, 1, 0)
HOPPER_WGMMA_SS(104, 52, 1, 0)
HOPPER_WGMMA_SS(112, 56, 1, 0)
HOPPER_WGMMA_SS(120, 60, 1, 0)
HOPPER_WGMMA_SS(128, 64, 1, 0)
HOPPER_WGMMA_SS(136, 68, 1, 0)
HOPPER_WGMMA_SS(144, 72, 1, 0)
HOPPER_WGMMA_SS(152, 76, 1, 0)
HOPPER_WGMMA_SS(160, 80, 1, 0)
HOPPER_WGMMA_SS(168, 84, 1, 0)
HOPPER_WGMMA_SS(176, 88, 1, 0)
HOPPER_WGMMA_SS(184, 92, 1, 0)
HOPPER_WGMMA_SS(192, 96, 1, 0)
HOPPER_WGMMA_SS(200, 100, 1, 0)
HOPPER_WGMMA_SS(208, 104, 1, 0)
HOPPER_WGMMA_SS(216, 108, 1, 0)
HOPPER_WGMMA_SS(224, 112, 1, 0)
HOPPER_WGMMA_SS(232, 116, 1, 0)
HOPPER_WGMMA_SS(240, 120, 1, 0)
HOPPER_WGMMA_SS(248, 124, 1, 0)
HOPPER_WGMMA_SS(256, 128, 1, 0)
HOPPER_WGMMA_SS(32, 16, 0, 0)
HOPPER_WGMMA_SS(64, 32, 0, 0)
HOPPER_WGMMA_SS(128, 64, 0, 0)
HOPPER_WGMMA_SS(192, 96, 0, 0)
HOPPER_WGMMA_SS(256, 128, 0, 0)
HOPPER_WGMMA_SS(128, 64, 0, 1)
HOPPER_WGMMA_SS(64, 32, 1, 1)
HOPPER_WGMMA_SS(128, 64, 1, 1)
HOPPER_WGMMA_SS(192, 96, 1, 1)
HOPPER_WGMMA_SS(256, 128, 1, 1)
HOPPER_WGMMA_RS(64, 32, 1)
HOPPER_WGMMA_RS(128, 64, 1)

// ------------------------------------------------------ host: tensor maps
// cuTensorMapEncodeTiled, reached through the runtime so that a library
// needs no -lcuda
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A rank-3 bf16 tensor (d0 innermost, contiguous) as a map with 128-byte
// swizzle and a box of (64, rows, 1).  Returns 0, or a negative code: -1
// no driver entry point, -2 an unaligned base or row stride, otherwise
// -1000 - the CUresult of the encoding.
inline int make_map_bf16(CUtensorMap* map, const void* ptr, uint64_t d0,
                         uint64_t d1, uint64_t d2, uint32_t rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return -1;
  if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0 || (d0 * 2) % 16 != 0)
    return -2;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * 2, d0 * d1 * 2};
  const cuuint32_t box[3] = {64, rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -1000 - static_cast<int>(r);
}

// A rank-3 float32 or bf16 tensor (d0 innermost, contiguous) as a map
// without swizzle and a box of (box0, box1, 1): a box lands in shared
// memory (128-byte aligned) as box1 rows of box0 elements, and a store
// takes it from there laid out the same way.  box0 times the element's
// bytes must be a multiple of 16.  Returns as make_map_bf16.
inline int make_map_plain(CUtensorMap* map, bool bf16, const void* ptr,
                          uint64_t d0, uint64_t d1, uint64_t d2,
                          uint32_t box0, uint32_t box1) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return -1;
  const uint64_t size = bf16 ? 2 : 4;
  if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0 || (d0 * size) % 16 != 0)
    return -2;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * size, d0 * d1 * size};
  const cuuint32_t box[3] = {box0, box1, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map,
                        bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                             : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                        3, const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -1000 - static_cast<int>(r);
}

// the message of a launch's return code: a cudaError_t, or one of
// make_map_bf16's (make_map_plain's)
inline const char* error_string(int code) {
  if (code == -1) return "cuTensorMapEncodeTiled not found in the driver";
  if (code == -2) return "TMA needs a 16-byte aligned base and row stride";
  if (code <= -1000)
    return "cuTensorMapEncodeTiled failed (CUresult = -1000 - code)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // namespace hopper
