// The train backwards' weight-gradient reduction (kernels K2, K4 and K5) on
// Hopper's tensor cores: C (K, N) += A (K, m) . B (N, m)^T, A a layer's input
// (an activation, the latent or the embedding) and B its pre-activation
// gradient, both feature-major [feature][point] with row stride m; C holds
// zeros or a sum to add to.  The TPU kernels accumulate dW in VMEM across a
// sequential grid; blocks on Hopper run in parallel, so the points are split
// into chunks (split K) whose partial sums are added into C with atomicAdd.
//
// What bounds it: arithmetic.  At the flagship --pa_feat widths (K4) a step
// reduces 2 trunks x 786,944 weights over 128,000 points, 0.40 TFLOP: 6.0 ms
// at the CUDA cores' float32 rate, 2.4 ms in split TF32 on the tensor cores
// (three TF32 products a multiply-add, 494.7 TFLOP/s).  Each operand is
// read once from device memory if L2 serves the re-reads (about 0.4 GB a
// step, 0.1 ms).
//
// Design: split TF32 on wgmma.m64n128k8 (wgmma_tf32.cuh).  The points are
// wgmma's K, so A and B, feature-major, are already K-major, as tf32 wgmma
// wants: nothing is transposed.  A block of two warpgroups owns a 128 x 256
// tile of C (each warpgroup 64 rows and two 128-column halves: 128 float32
// accumulators a thread) and one chunk of points, which it walks in stages
// of 32 points (4 k steps).  Both operands are run-time data, so the split
// happens on the card:
//  - A goes from shared memory into registers, where each thread splits its
//    fragment (big = round to nearest, ties away, in integer arithmetic;
//    small = the same of x - big), as the grid trunk does;
//  - B serves as the big half as it lands: wgmma reads a float32 as TF32 by
//    dropping its 13 low bits, so the raw tile is trunc(B).  Only the small
//    half, B - trunc(B) (exact in float32), is computed and stored, into a
//    tile of its own.  Truncating both halves leaves B within 2^-21 of
//    itself, float32's accuracy (tests/test_torch_split_tf32.py).
// The stages land by cp.async (16 bytes a thread, zero past K, N or the
// chunk) in a ring of three, two stages ahead of the products, so that no
// thread holds a load in registers; A and B share one layout, 128-byte
// rows of 32 points whose 16-byte columns are XOR-swizzled by the row (B's
// is wgmma's 128-byte swizzle; it spreads A's fragment loads over the 32
// banks).  Shared memory: 3 x 48 KB of stages and 2 x 32 KB of small
// halves; one block an SM.
//
// Bytes: each block reads its 128 rows of A and 256 rows of B over its
// chunk, so A is read ceil(N / 256) times and B ceil(K / 128) times from L2
// (a 512 x 512 layer: 2 and 4 times, 1.6 GB at m = 128,000).  The grid is
// ordered tile-fastest, so the blocks of one chunk run together and share
// its strips in L2; device memory then sees each operand about once.  The
// grid holds about two blocks an SM in all, and the chunks are as long as
// that allows (but at most WG_MAX_CHUNK), to keep the atomics (K x N a
// chunk) few.
//
// Narrow shapes (the embedding's dX, K = 6 or 9; the final layer, N = 1 or
// 2 + C) take the same design, zero-padded to the tile: a warpgroup whose 64
// rows lie past K issues no product, and N <= 128 takes a copy of the kernel
// with one column half (wgrad_tc_kernel_n128), so the padding costs little
// beyond zero fills of shared memory, and such a call is bound by reading
// its wide operand once.  There is no CUDA-core route.
//
// bf16 operands (K2's, K4's and K5's bf16 backwards) take another design,
// wgrad_bf16_tc.cuh (TMA, clusters with multicast, warp-specialised wgmma),
// which launch_wgrad's bf16 overload runs.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_tf32.cuh"
#include "wgrad_bf16_tc.cuh"

#define WG_BM 128       // rows of C a block: two warpgroups of 64
#define WG_BN 256       // columns of C a block: two halves of 128 (wgmma's N)
#define WG_BP 32        // points a stage: 4 k steps of 8, one 128-byte row
#define WG_THREADS 256
#define WG_RING 3       // stages in flight: the products' and two landing
// The tensor cores' float32 accumulation errs in proportion to the number of
// terms it sums (at m = 128,000 against float64, 512 x 512: 2.3e-5 of the
// largest entry with 3,904-point chunks, 1.5e-5 with 2,048, 7.4e-6 with
// 1,024, where cuBLAS's float32 errs by 1.1e-6), so a chunk is at most this
// long, whatever m; the atomics then add the chunks' sums.  2,048 costs 1-2%
// of a K4 step's reductions, 1,024 ~10% (tools/time_weight_grad.py).
#define WG_MAX_CHUNK 2048
// a stage: A's 128 rows, then B's 256, each 32 points with the 16-byte
// column q of row r at column q ^ (r % 8); then, apart, B's small halves
#define WG_STAGE_FLOATS ((WG_BM + WG_BN) * WG_BP)
#define WG_SMALL_FLOATS (WG_BN * WG_BP)
#define WG_SMEM_BYTES ((WG_RING * WG_STAGE_FLOATS + 2 * WG_SMALL_FLOATS) * 4)
#define WG_COPIES ((WG_BM + WG_BN) * WG_BP / 4 / WG_THREADS)  // 16-byte copies a thread a stage: 12
#define WG_A_COPIES (WG_BM * WG_BP / 4 / WG_THREADS)          // of which A's: 4

// Float index of element (r, p) of a stage's [rows][32] tiles.
__device__ __forceinline__ int wg_swz(int r, int p) {
  return r * WG_BP + ((((p >> 2) ^ r) & 7) << 2) + (p & 3);
}

// This thread's copies of the stage at points p .. p + 31 into `stage`: copy
// i is row 8 (tid / 64 + 4 i) + tid % 8 of [A's 128 rows; B's 256 rows], its
// 16-byte column q = tid / 8 % 8, points p + 4 q .. + 3; zeros past K, N or
// p_end.  vec: the rows are 16-byte aligned (m % 4 == 0), so a copy is all
// in or all out; otherwise 4-byte copies.
__device__ __forceinline__ void wg_copy(float* stage, const float* __restrict__ A,
                                        const float* __restrict__ B, int K, int N, int m, int k0,
                                        int n0, int p, int p_end, bool vec, int tid) {
  const int q = (tid >> 3) & 7, pt = p + 4 * q;
#pragma unroll
  for (int i = 0; i < WG_COPIES; ++i) {
    const int r = 8 * ((tid >> 6) + 4 * i) + (tid & 7);
    const bool is_a = i < WG_A_COPIES;
    const int row = is_a ? k0 + r : n0 + r - WG_BM;
    const bool ok = row < (is_a ? K : N);
    const float* base = is_a ? A : B;  // read from only where a copy has bytes
    const float* src = base + (size_t)(ok ? row : 0) * m + pt;
    const uint32_t dst = tc_smem(stage + wg_swz(r, 4 * q));
    if (vec) {
      const bool in = ok && pt < p_end;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                   :: "r"(dst), "l"(in ? src : base), "r"(in ? 16 : 0) : "memory");
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in = ok && pt + e < p_end;
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
                     :: "r"(dst + 4 * e), "l"(in ? src + e : base), "r"(in ? 4 : 0) : "memory");
      }
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Stage s's copies into its ring slot, or an empty group past the chunk.
__device__ __forceinline__ void wg_copy_next(float* smem, int s, int stages,
                                             const float* __restrict__ A,
                                             const float* __restrict__ B, int K, int N, int m,
                                             int k0, int n0, int p_begin, int p_end, bool vec,
                                             int tid) {
  if (s < stages) {
    wg_copy(smem + (s % WG_RING) * WG_STAGE_FLOATS, A, B, K, N, m, k0, n0, p_begin + s * WG_BP,
            p_end, vec, tid);
  } else {
    asm volatile("cp.async.commit_group;" ::: "memory");
  }
}

// B's small halves, B - trunc(B), of a landed stage into `small` (the same
// layout): this thread's 8 of B's 16-byte columns, the ones it copied.
__device__ __forceinline__ void wg_small(float* small, const float* stage, int tid) {
  const int q = (tid >> 3) & 7;
#pragma unroll
  for (int i = WG_A_COPIES; i < WG_COPIES; ++i) {
    const int r = 8 * ((tid >> 6) + 4 * i) + (tid & 7) - WG_BM;
    const int at = wg_swz(r, 4 * q);
    const float4 x = *reinterpret_cast<const float4*>(stage + WG_BM * WG_BP + at);
    float4 y;
    y.x = x.x - __uint_as_float(__float_as_uint(x.x) & 0xFFFFE000u);
    y.y = x.y - __uint_as_float(__float_as_uint(x.y) & 0xFFFFE000u);
    y.z = x.z - __uint_as_float(__float_as_uint(x.z) & 0xFFFFE000u);
    y.w = x.w - __uint_as_float(__float_as_uint(x.w) & 0xFFFFE000u);
    *reinterpret_cast<float4*>(small + at) = y;
  }
}

// acc (rows 64 wg .., columns 128 h ..) added into C; d[4i + r]: row 16 warp
// + lane/4 (+ 8 for r >= 2), column 8i + 2 (lane % 4) (+ 1 for odd r).
__device__ __forceinline__ void wg_add(const float (&acc)[64], float* __restrict__ C, int K,
                                       int N, int row0, int col0, int lane) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = row0 + (lane >> 2) + (r >= 2 ? 8 : 0);
      const int col = col0 + 8 * i + 2 * (lane & 3) + (r & 1);
      if (row < K && col < N) atomicAdd(C + (size_t)row * N + col, acc[4 * i + r]);
    }
  }
}

// The block's tile of C over its chunk of points; NH column halves of 128
// (2, or 1 where N <= 128).  Per stage: the copies of the stage two ahead
// are issued into the slot the previous stage freed; then the products of
// its 4 k steps (each step's A fragment split in registers, its 3 NH
// products issued after one wgmma fence and committed as a group, which
// the warpgroup waits for before the next step, but for the last); while
// the last runs, the next stage's copies are waited for and its small
// halves made.  Each stage's copies are one cp.async group (an empty one
// past the chunk), so "all but the newest group" is always the next stage.
template <int NH>
__device__ __forceinline__ void wgrad_tile(const float* __restrict__ A,
                                           const float* __restrict__ B, float* __restrict__ C,
                                           int K, int N, int m, int chunk, int tiles_k, bool vec,
                                           float* smem) {
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int k0 = (blockIdx.x % tiles_k) * WG_BM, n0 = (blockIdx.x / tiles_k) * WG_BN;
  const int p_begin = blockIdx.y * chunk, p_end = min(m, p_begin + chunk);
  const int stages = (p_end - p_begin + WG_BP - 1) / WG_BP;
  const bool rows_on = k0 + 64 * wg < K;  // uniform over the warpgroup
  float* small = smem + WG_RING * WG_STAGE_FLOATS;
  // this thread's A fragment: rows 16 warp + lane / 4 (+ 8), points lane %
  // 4 (+ 4) of each k step's 8
  const int ar = 64 * wg + 16 * warp + (lane >> 2), t4 = lane & 3;
  float acc0[64], acc1[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0.f;

  // stages 0 and 1 in flight
  wg_copy(smem, A, B, K, N, m, k0, n0, p_begin, p_end, vec, tid);
  wg_copy_next(smem, 1, stages, A, B, K, N, m, k0, n0, p_begin, p_end, vec, tid);
  asm volatile("cp.async.wait_group 1;" ::: "memory");
  tc_fence_proxy_async();
  __syncthreads();
  wg_small(small, smem, tid);
  tc_fence_proxy_async();
  __syncthreads();
  for (int st = 0; st < stages; ++st) {
    wg_copy_next(smem, st + 2, stages, A, B, K, N, m, k0, n0, p_begin, p_end, vec, tid);
    const float* cur = smem + (st % WG_RING) * WG_STAGE_FLOATS;
    const float* cur_small = small + (st & 1) * WG_SMALL_FLOATS;
    if (rows_on) {
#pragma unroll
      for (int j = 0; j < WG_BP / 8; ++j) {
        // k step j: 32 bytes into each 128-byte row; column half h: rows 128 h on
        const float* bt = cur + WG_BM * WG_BP + 8 * j;
        const uint64_t bb0 = tc_desc_sw128(bt), bb1 = tc_desc_sw128(bt + 128 * WG_BP);
        uint32_t ab[4], as[4];
        tc_split(cur[wg_swz(ar, 8 * j + t4)], ab[0], as[0]);
        tc_split(cur[wg_swz(ar + 8, 8 * j + t4)], ab[1], as[1]);
        tc_split(cur[wg_swz(ar, 8 * j + t4 + 4)], ab[2], as[2]);
        tc_split(cur[wg_swz(ar + 8, 8 * j + t4 + 4)], ab[3], as[3]);
        const float* bs = cur_small + 8 * j;
        const uint64_t bs0 = tc_desc_sw128(bs), bs1 = tc_desc_sw128(bs + 128 * WG_BP);
        tc_fence_acc(acc0);
        if (NH > 1) tc_fence_acc(acc1);
        tc_wgmma_fence();
        tc_wgmma(acc0, ab, bb0, 1);
        tc_wgmma(acc0, as, bb0, 1);
        tc_wgmma(acc0, ab, bs0, 1);
        if (NH > 1) {
          tc_wgmma(acc1, ab, bb1, 1);
          tc_wgmma(acc1, as, bb1, 1);
          tc_wgmma(acc1, ab, bs1, 1);
        }
        tc_wgmma_commit();
        if (j + 1 < WG_BP / 8) {
          tc_wgmma_wait();
          tc_fence_acc(acc0);
          if (NH > 1) tc_fence_acc(acc1);
        }
      }
    }
    if (st + 1 < stages) {  // the next stage has landed: its small halves
      asm volatile("cp.async.wait_group 1;" ::: "memory");
      tc_fence_proxy_async();
      __syncthreads();
      wg_small(small + ((st + 1) & 1) * WG_SMALL_FLOATS,
               smem + ((st + 1) % WG_RING) * WG_STAGE_FLOATS, tid);
      tc_fence_proxy_async();
    }
    if (rows_on) {
      tc_wgmma_wait();
      tc_fence_acc(acc0);
      if (NH > 1) tc_fence_acc(acc1);
    }
    __syncthreads();  // this stage's slot and small halves are free
  }
  if (!rows_on) return;
  const int row0 = k0 + 64 * wg + 16 * warp;
  wg_add(acc0, C, K, N, row0, n0, lane);
  if (NH > 1) wg_add(acc1, C, K, N, row0, n0 + 128, lane);
}

// Two kernels, named apart for the profiler: N > 128 columns, and N <= 128
// (the final layer's rows, the classifier's), whose second half would be
// padding.
__global__ void __launch_bounds__(WG_THREADS, 1)
wgrad_tc_kernel(const float* __restrict__ A, const float* __restrict__ B, float* __restrict__ C,
                int K, int N, int m, int chunk, int tiles_k, int vec) {
  extern __shared__ __align__(1024) float smem[];
  wgrad_tile<2>(A, B, C, K, N, m, chunk, tiles_k, vec, smem);
}

__global__ void __launch_bounds__(WG_THREADS, 1)
wgrad_tc_kernel_n128(const float* __restrict__ A, const float* __restrict__ B,
                     float* __restrict__ C, int K, int N, int m, int chunk, int tiles_k, int vec) {
  extern __shared__ __align__(1024) float smem[];
  wgrad_tile<1>(A, B, C, K, N, m, chunk, tiles_k, vec, smem);
}

// C (K, N) += A (K, m) . B (N, m)^T, A and B float32 (split TF32, here) or
// bf16 (launch_wgrad_bf16, wgrad_bf16_tc.cuh, which takes `overlap`).  C
// must hold zeros (or a sum to add to).  Returns 0 or the launch's error
// (bf16: launch_wgrad_bf16's).
static int launch_wgrad(const float* A, const float* B, float* C, int K, int N, int m,
                        cudaStream_t stream) {
  if (K <= 0 || N <= 0 || m <= 0) return 0;
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) sms = 132;
  }
  const bool narrow = N <= 128;
  const void* kernel = narrow ? (const void*)wgrad_tc_kernel_n128 : (const void*)wgrad_tc_kernel;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         WG_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int tiles_k = (K + WG_BM - 1) / WG_BM, tiles_n = (N + WG_BN - 1) / WG_BN;
  const int tiles = tiles_k * tiles_n;
  // about two blocks an SM in all, each chunk at least 256 points and at
  // most WG_MAX_CHUNK
  int splits = (2 * sms + tiles - 1) / tiles;
  const int max_splits = (m + 255) / 256;
  if (splits > max_splits) splits = max_splits;
  const int min_splits = (m + WG_MAX_CHUNK - 1) / WG_MAX_CHUNK;
  if (splits < min_splits) splits = min_splits;
  if (splits > 65535) splits = 65535;
  if (splits < 1) splits = 1;
  int chunk = (m + splits - 1) / splits;
  chunk = (chunk + WG_BP - 1) / WG_BP * WG_BP;
  splits = (m + chunk - 1) / chunk;
  const int vec = m % 4 == 0 && (uintptr_t)A % 16 == 0 && (uintptr_t)B % 16 == 0;
  const dim3 grid(tiles, splits);
  if (narrow) {
    wgrad_tc_kernel_n128<<<grid, WG_THREADS, WG_SMEM_BYTES, stream>>>(A, B, C, K, N, m, chunk,
                                                                      tiles_k, vec);
  } else {
    wgrad_tc_kernel<<<grid, WG_THREADS, WG_SMEM_BYTES, stream>>>(A, B, C, K, N, m, chunk,
                                                                 tiles_k, vec);
  }
  return (int)cudaGetLastError();
}

static int launch_wgrad(const __nv_bfloat16* A, const __nv_bfloat16* B, float* C, int K, int N,
                        int m, cudaStream_t stream, bool overlap = false) {
  return launch_wgrad_bf16(A, B, C, K, N, m, stream, overlap);
}
