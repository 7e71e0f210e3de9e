// The train decoders' shared pieces (kernels K2, K4 and K5): the hash dropout
// gate and the backward's reductions over the points.
//
// gate_hash is bit for bit the TPU kernels' _dropout_gate: a murmur3-style
// finalizer of (seed, layer, global row, lane) in uint32 arithmetic; a unit
// is kept where the hash is below round(keep * 2^32).
//
// The TPU kernels accumulate dW and db in VMEM across a sequential grid.
// Blocks on Hopper run in parallel, so the backward writes each layer's
// pre-activation gradient dpre (out_pad, M) to device memory and reduces it:
// wgrad_tc.cuh's launch_wgrad forms C[k][n] += sum_p A[k][p] B[n][p] (A and
// B feature-major) on the tensor cores; colsum_kernel here sums dpre over
// segments of the points.

#pragma once

#include <cuda_runtime.h>

#include "wgrad_tc.cuh"

#define COLSUM_THREADS 256  // colsum_kernel's block: a warp a feature

// The finalizer of gate_hash; the tensor-core forward (train_fwd_tc.cuh)
// hoists the row's and layer's terms out of its loop over lanes.
__device__ __forceinline__ unsigned gate_mix(unsigned h) {
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ unsigned gate_hash(unsigned seed, unsigned layer, unsigned row,
                                              unsigned col) {
  return gate_mix(seed ^ (row * 0x9E3779B1u) ^ (col * 0x85EBCA6Bu) ^ (layer * 0xC2B2AE35u));
}

// out[s][o] = sum of d[o][p] over segment s (per_segment: scene tables), or
// out[o] += that sum (a global bias; out must hold zeros).
__global__ void __launch_bounds__(COLSUM_THREADS)
colsum_kernel(const float* __restrict__ d, float* __restrict__ out, int rows, int m, int seg,
              int per_segment) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int o = blockIdx.x * (COLSUM_THREADS / 32) + warp;
  if (o >= rows) return;
  const int s = blockIdx.y;
  const int begin = s * seg, end = min(m, begin + seg);
  float v = 0.f;
  for (int q = begin + lane; q < end; q += 32) v += __ldg(d + (size_t)o * m + q);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if (lane == 0) {
    if (per_segment) out[(size_t)s * rows + o] = v;
    else atomicAdd(out + o, v);
  }
}

static int launch_colsum(const float* d, float* out, int rows, int m, int seg, int per_segment,
                         cudaStream_t stream) {
  const unsigned segments = (unsigned)((m + seg - 1) / seg);
  colsum_kernel<<<dim3((rows + COLSUM_THREADS / 32 - 1) / (COLSUM_THREADS / 32), segments),
                  COLSUM_THREADS, 0, stream>>>(d, out, rows, m, seg, per_segment);
  return (int)cudaGetLastError();
}
