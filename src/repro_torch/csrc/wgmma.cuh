// Hopper (sm_90a) warpgroup matrix-multiply helpers shared by the bf16
// tensor-core kernels (flash_attention.cu, ssd_scan.cu): shared-memory
// descriptors for 128-byte-swizzled bf16 tiles and the wgmma.mma_async
// m64n64k16 forms with fp32 accumulators.
//
// Tile layout: a bf16 tile of R rows is stored as column chunks of 64
// values, each chunk R rows of 128 bytes, 1024-byte aligned, with the
// 16-byte unit u of row r at unit u ^ (r % 8): the layout a TMA copy with
// CU_TENSOR_MAP_SWIZZLE_128B writes, and the one the descriptors below
// describe (swizzle_off gives a value's byte offset).
//
// Register layout of a 64 x 64 fp32 accumulator in a warpgroup: thread
// (warp w, lane l) holds rows 16w + l/4 (its "row 0") and that + 8 ("row
// 1"); value j sits in row (j >> 1) & 1, column 8 (j >> 2) + 2 (l % 4) +
// (j & 1).  The same registers, rounded to bf16 in pairs, are the A
// operand of a 64 x 16 product for each 16 columns (wgmma_rs).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace sm90 {

constexpr int kRowBytes = 128;     // one swizzled row: 64 bf16 of one chunk
constexpr int kAtomBytes = 1024;   // 8 rows of 128 bytes: the swizzle's period

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of value (r, col) in a swizzled tile of `rows` rows.
__device__ __forceinline__ uint32_t swizzle_off(int r, int col, int rows) {
  return (col >> 6) * rows * kRowBytes + r * kRowBytes +
         ((((col & 63) >> 3) ^ (r & 7)) << 4) + (col & 7) * 2;
}

// A wgmma shared-memory descriptor for a 128-byte-swizzled operand whose
// 8-row atoms lie 1024 bytes apart.  Both offset fields hold 1024: for a
// K-major operand (K contiguous) the leading offset is unused, and for an
// MN-major one (MN contiguous, 64 values an instruction) only the 8-row
// stride along K is used, whichever field the hardware reads it from.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr) {
  constexpr uint64_t kOff = kAtomBytes >> 4;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (kOff << 16) | (kOff << 32) | (1ull << 62);
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

// Keeps the compiler from touching registers that an in-flight wgmma
// reads or writes before wgmma_wait has returned.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (64 x 64, fp32) (+)= A (64 x 16) . B (16 x 64), both bf16 in shared
// memory; scale_d 0 overwrites d.  kTransA / kTransB 0: the operand is
// K-major (A 64 rows of 16 contiguous K values, B 64 rows of 16, so the
// product is A . B^T of the stored rows); 1: MN-major (16 rows of 64
// contiguous M or N values).
template <int kTransA = 0, int kTransB = 0>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTransA), "n"(kTransB));
}

// d (64 x 64, fp32) += A (64 x 16 bf16 in registers) . B (16 x 64, MN-major
// in shared memory: the transpose bit is set).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "n"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);  // .x = lo sits in the low half
  return *reinterpret_cast<uint32_t*>(&t);
}

}  // namespace sm90
