// The float32 tile product of kernel K5's forward and backward chain (K2's
// and K4's run on the tensor cores, train_fwd_tc.cuh and chain_tc.cuh): a block
// of NTHREADS threads owns a tile of TILE_P points whose activations stay in
// shared memory as [feature][point].  A layer is computed in chunks of
// OCHUNK output features, each thread holding an 8x4 (feature x point)
// register tile of accumulators; weights ([k][out], out contiguous, zero
// padded to multiples of OCHUNK) stream from global memory -- they sit in the
// 50 MB L2 -- through a BK x OCHUNK shared-memory tile that the block shares
// across its points, the next tile prefetched into registers while the
// current one is used.  Plain float32 FMAs, no TF32.

#pragma once

#include <cuda_runtime.h>

#define TILE_P 32      // points per block
#define NTHREADS 256   // threads per block
#define OCHUNK 256     // output features per chunk
#define BK 32          // k depth of one weight tile

// Weight tile [BK][OCHUNK] of W ([k][out_pad]) at rows k0.., columns oc..:
// 2048 float4, 8 per thread, 64 threads per row (coalesced).
__device__ __forceinline__ void load_tile(float4 (&pre)[8], const float* __restrict__ w,
                                          int out_pad, int k0, int oc, int tid) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    int f = tid + i * NTHREADS;
    int row = f >> 6, col = (f & 63) << 2;
    pre[i] = __ldg(reinterpret_cast<const float4*>(w + (size_t)(k0 + row) * out_pad + oc + col));
  }
}

__device__ __forceinline__ void store_tile(float* ws, const float4 (&pre)[8], int tid) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    int f = tid + i * NTHREADS;
    reinterpret_cast<float4*>(ws)[f] = pre[i];
  }
}

// acc[i][j] += sum_k W[k][oc + ty*8 + i] in[k][tx*4 + j] over k < k_pad.
__device__ __forceinline__ void tile_product(float (&acc)[8][4], const float* __restrict__ w,
                                             int out_pad, int k_pad, const float* in,
                                             float* ws, int oc, int tid) {
  const int tx = tid & 7;   // points tx*4 .. tx*4+3
  const int ty = tid >> 3;  // features ty*8 .. ty*8+7 of the chunk
  float4 pre[8];
  load_tile(pre, w, out_pad, 0, oc, tid);
  for (int k0 = 0; k0 < k_pad; k0 += BK) {
    __syncthreads();  // every thread is done reading the previous tile
    store_tile(ws, pre, tid);
    __syncthreads();
    if (k0 + BK < k_pad) load_tile(pre, w, out_pad, k0 + BK, oc, tid);
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(in + (k0 + kk) * TILE_P + tx * 4);
      const float4 w0 = *reinterpret_cast<const float4*>(ws + kk * OCHUNK + ty * 8);
      const float4 w1 = *reinterpret_cast<const float4*>(ws + kk * OCHUNK + ty * 8 + 4);
      const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(wv[i], av[j], acc[i][j]);
    }
  }
}
