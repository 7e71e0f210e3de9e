// Split TF32 on Hopper's tensor cores: the pieces the tensor-core kernels
// share (the grid decoders' trunk, grid_trunk_tc.cuh, and the train
// backwards' weight-gradient reduction, wgrad_tc.cuh).  An operand x is split
// as big = tf32(x), small = tf32(x - big) (round to nearest, ties away), and
// a product as big_a big_b + small_a big_b + big_a small_b, which keeps
// float32's accuracy (tests/test_torch_split_tf32.py).  The products are
// wgmma.m64n128k8.f32.tf32.tf32 with A's fragment in registers and B in
// shared memory, K-major: 8 x 16-byte core matrices without swizzle
// (tc_desc), or 128-byte rows with the 128-byte swizzle (tc_desc_sw128).
// Also the mbarrier helpers the kernels' rings share (CTA scope).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t tc_smem(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// x = big + small: big = x rounded to TF32 (10 mantissa bits; to nearest,
// ties away from zero, as cvt.rna.tf32.f32 rounds: add half of the 13
// dropped bits' range, then clear them), small = x - big rounded the same
// way.  Integer arithmetic: the same bits as cvt.rna, at the integer
// units' rate rather than the conversions' (PERF.md).
__device__ __forceinline__ void tc_split(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  small = (__float_as_uint(x - __uint_as_float(big)) + 0x1000u) & 0xFFFFE000u;
}

// Descriptor of a K-major operand tile without swizzle: core matrices of 8
// rows x 16 bytes, 128 contiguous bytes each; the two along K 128 bytes
// apart (leading byte offset), successive 8-row groups (along N for B, M
// for A) 256 bytes apart (stride byte offset).
__device__ __forceinline__ uint64_t tc_desc(const float* tile) {
  return (uint64_t)((tc_smem(tile) & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16)
         | ((uint64_t)(256 >> 4) << 32);
}

// Descriptor of a K-major operand with 128-byte swizzle: rows of 128 bytes
// (32 tf32 along K), 16-byte column c of row r stored at column c ^ (r % 8),
// 8-row atoms 1024 bytes apart (stride byte offset) on a 1024-byte-aligned
// base; `tile` may lie 32 bytes a k step into the rows.  The leading byte
// offset is unused (1).
__device__ __forceinline__ uint64_t tc_desc_sw128(const float* tile) {
  return (uint64_t)((tc_smem(tile) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16)
         | ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void tc_wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void tc_wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void tc_wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Pins the accumulators at this point of the program: the compiler must not
// move their reads or writes across the asynchronous products.
__device__ __forceinline__ void tc_fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d[64] (+)= A (64 x 8, this thread's fragment a) x B^T (B: 128 x 8 at desc).
// A fragment: a[0] = (point 16 warp + lane/4, k lane%4), a[1] the point + 8,
// a[2] and a[3] the same at k + 4.  d[4i + r]: point 16 warp + lane/4 (+ 8
// for r >= 2), feature 8i + 2 (lane%4) (+ 1 for odd r).
__device__ __forceinline__ void tc_wgmma(float (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// mbarriers in this block's shared memory (CTA scope)
__device__ __forceinline__ void tc_mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(tc_smem(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void tc_mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(tc_smem(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void tc_mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(tc_smem(bar)), "r"(parity) : "memory");
  } while (!done);
}

// Makes this thread's generic-proxy writes to shared memory visible to the
// async proxy (wgmma's operand reads); a barrier follows.
__device__ __forceinline__ void tc_fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
