// Building blocks for the port's tensor-core kernels on Hopper (sm_90a):
// 16-byte cp.async with zero fill, ldmatrix (plain and transposed) and
// the m16n8k16 mma.sync on bf16 or f16 operands with f32 accumulation;
// and for the warpgroup MMA (wgmma): the shared-memory matrix descriptor
// of a 128-byte-swizzled tile, fence / commit / wait, one m64nNk16 issue
// on bf16 or f16 operands (N = 64 or 128), and the mbarrier operations
// that pace a ring of tiles filled by TMA.
//
// Fragment layouts of mma.m16n8k16 (lane = threadIdx.x % 32, g = lane / 4,
// t = lane % 4), each register two 16-bit values, the lower index low:
//   A (16 x 16, row-major): a[0] = (g, 2t..2t+1), a[1] = (g + 8, 2t..),
//                           a[2] = (g, 2t + 8..),  a[3] = (g + 8, 2t + 8..)
//   B (16 x 8, k x n):      b[0] = (k 2t..2t+1, n g), b[1] = (k 2t + 8.., n g)
//   C (16 x 8, f32):        c[0..1] = (g, 2t..2t+1), c[2..3] = (g + 8, 2t..)

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>
#include <type_traits>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared without passing through registers. With
// ok == false nothing is read (src-size 0) and the 16 bytes become zero;
// src must still be a valid address.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 matrices of 16-bit values; lanes 8i..8i+7 give the row
// addresses of matrix i, which lands in r[i]
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// the same, each matrix transposed on the way (a k-major tile read as
// the B operand)
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a * b on the tensor cores; T is __nv_bfloat16 or __half
template <typename T>
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, __half>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// two f32 values rounded to a packed pair of T, lo in the low half
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __half>::value) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

// ---------------------------------------------------------------------------
// Warpgroup MMA (wgmma) and the mbarriers of a TMA ring
// ---------------------------------------------------------------------------
//
// Both operands are read from shared memory in the 128-byte swizzle that
// TMA writes with CU_TENSOR_MAP_SWIZZLE_128B: a tile is cut into atoms
// of 8 rows of 128 bytes (64 bf16 or f16 values), each atom 1024-byte
// aligned, and the 16-byte chunk c of row r of an atom lies at chunk
// c ^ (r % 8). A (64 x 16, M x K) is K-major: its rows are rows of x,
// the next 8 rows one atom (1024 bytes) on, and the k16 step kk of a
// 64-wide atom starts 32 * kk bytes into it. B (16 x N, K x N) is
// N-major, as w is stored: an atom holds 8 rows of K by 64 columns, the
// next 8 rows of K one atom (1024 bytes) on, the next 64 columns
// ``lbo`` bytes on.
//
// Accumulator fragment of m64nNk16 (thread t of the warpgroup, w = t / 32,
// g = (t % 32) / 4, q = t % 4): d[4j + 0..1] = rows 16w + g, columns
// 8j + 2q and 8j + 2q + 1; d[4j + 2..3] = row 16w + g + 8, the same
// columns: the mma.sync C layout, once per 8 columns.

// the descriptor of a 128-byte-swizzled operand at smem: start address,
// leading byte offset (K-major: unused, 1; N-major: the next 64 columns),
// stride byte offset (the next 8 rows: 1024), layout 1 = 128B swizzle
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, uint32_t lbo) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFFu) >> 4) | (uint64_t((lbo & 0x3FFFFu) >> 4) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

// order this warpgroup's register and shared-memory accesses before the
// wgmma that follows
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N of this warpgroup's committed wgmma groups are
// pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accesses of an accumulator across the
// asynchronous MMAs that own it
template <int R>
__device__ __forceinline__ void wgmma_fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define REPRO_WGMMA_M64N64K16(TY)                                             \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"            \
      "%0,%1,%2,%3,%4,%5,%6,%7,"                                              \
      "%8,%9,%10,%11,%12,%13,%14,%15,"                                        \
      "%16,%17,%18,%19,%20,%21,%22,%23,"                                      \
      "%24,%25,%26,%27,%28,%29,%30,%31"                                       \
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"                                      \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                       \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                       \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                     \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),                   \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),                   \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),                   \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),                   \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])                    \
      : "l"(da), "l"(db), "r"(1))

#define REPRO_WGMMA_M64N128K16(TY)                                            \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"           \
      "%0,%1,%2,%3,%4,%5,%6,%7,"                                              \
      "%8,%9,%10,%11,%12,%13,%14,%15,"                                        \
      "%16,%17,%18,%19,%20,%21,%22,%23,"                                      \
      "%24,%25,%26,%27,%28,%29,%30,%31,"                                      \
      "%32,%33,%34,%35,%36,%37,%38,%39,"                                      \
      "%40,%41,%42,%43,%44,%45,%46,%47,"                                      \
      "%48,%49,%50,%51,%52,%53,%54,%55,"                                      \
      "%56,%57,%58,%59,%60,%61,%62,%63"                                       \
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"                                      \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                       \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                       \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                     \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),                   \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),                   \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),                   \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),                   \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),                   \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),                   \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),                   \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),                   \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),                   \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),                   \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),                   \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),                   \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                    \
      : "l"(da), "l"(db), "r"(1))

// d (64 x N, f32) += A (64 x 16) * B (16 x N) from their descriptors; A
// K-major, B N-major (transposed); T is __nv_bfloat16 or __half
template <typename T, int N>
__device__ __forceinline__ void wgmma_m64k16(float (&d)[N / 2], uint64_t da,
                                             uint64_t db) {
  static_assert(N == 64 || N == 128, "m64nNk16 is issued for N = 64, 128");
  constexpr bool F16 = std::is_same<T, __half>::value;
  if constexpr (N == 64) {
    if constexpr (F16) REPRO_WGMMA_M64N64K16("f16");
    else REPRO_WGMMA_M64N64K16("bf16");
  } else {
    if constexpr (F16) REPRO_WGMMA_M64N128K16("f16");
    else REPRO_WGMMA_M64N128K16("bf16");
  }
}

#undef REPRO_WGMMA_M64N64K16
#undef REPRO_WGMMA_M64N128K16

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// make the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// arrive and expect ``bytes`` more of transactions (the TMA loads that
// complete on this barrier) in the current phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the phase of parity ``parity`` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

}  // namespace
