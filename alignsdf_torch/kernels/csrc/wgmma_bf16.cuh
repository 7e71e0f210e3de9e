// bf16 on Hopper's tensor cores: the product of the bf16 k step of the grid
// decoders (grid_trunk_tc.cuh with TcBf16; K3 and K6 serving a bf16
// plan) and of K2's, K4's and K5's bf16 forwards, chains and
// weight-gradient reductions.
// wgmma.m64n128k16.f32.bf16.bf16 with A's fragment in registers and B in
// shared memory, K-major, as 8 x 16-byte core matrices without swizzle: the
// same byte layout and descriptor (tc_desc) as the TF32 tiles of
// wgmma_tf32.cuh, whose 16 bytes hold 8 bf16 values along k instead of 4
// tf32.  One product a k step of 16, accumulated in float32: the JAX
// package's bf16 contract (jnp.dot of bf16 operands with
// preferred_element_type=float32).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_tf32.cuh"

// The register holding the bf16 pair (lo, hi), lo in the low half, of two
// floats that hold bf16 values: their top 16 bits, exactly (one PRMT).
__device__ __forceinline__ uint32_t tc_pack_bf16(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// 4 floats that hold bf16 values as 4 bf16 in 8 bytes, in order (exact).
__device__ __forceinline__ uint2 tc_pack4_bf16(float4 v) {
  return make_uint2(tc_pack_bf16(v.x, v.y), tc_pack_bf16(v.z, v.w));
}

// x rounded to the nearest bf16 (ties to even), as a float.
__device__ __forceinline__ float tc_round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// d[64] (+)= A (64 x 16 bf16, this thread's fragment a) x B^T (B: 128 x 16
// bf16 at desc).  A fragment: a[0] = (point 16 warp + lane/4, k 2 (lane%4)
// and + 1), a[1] the point + 8, a[2] and a[3] the same at k + 8; the lower k
// in each register's low half.  d as tc_wgmma's.
__device__ __forceinline__ void tc_wgmma_bf16(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
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
