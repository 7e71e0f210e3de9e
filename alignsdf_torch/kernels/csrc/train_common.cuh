// The train decoders' shared pieces (kernels K2 and K4): the hash dropout
// gate, the embedding's gradient over a tile, dx_last's transposed add and
// the backward's reductions over the points.
//
// gate_hash is bit for bit the TPU kernels' _dropout_gate: a murmur3-style
// finalizer of (seed, layer, global row, lane) in uint32 arithmetic; a unit
// is kept where the hash is below round(keep * 2^32).
//
// The TPU kernels accumulate dW and db in VMEM across a sequential grid.
// Blocks on Hopper run in parallel, so the backward writes each layer's
// pre-activation gradient dpre (out_pad, M) to device memory and reduces it
// here: wgrad_kernel forms C[k][n] += sum_p A[k][p] B[n][p] (A and B
// feature-major, K = M split across blocks, partial sums added with
// atomicAdd); colsum_kernel sums dpre over segments of the points.

#pragma once

#include <cuda_runtime.h>

#include "tile_product.cuh"

__device__ __forceinline__ unsigned gate_hash(unsigned seed, unsigned layer, unsigned row,
                                              unsigned col) {
  unsigned h = seed ^ (row * 0x9E3779B1u) ^ (col * 0x85EBCA6Bu) ^ (layer * 0xC2B2AE35u);
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  h ^= h >> 16;
  return h;
}

// dembs[c][p] += sum_o X[c][o] d[o][p] over a tile: X (e, out_pad) in device
// memory, d [out_pad][TILE_P] and dembs [e][TILE_P] in shared memory.
__device__ __forceinline__ void demb_accumulate(const float* __restrict__ x, int out_pad, int e,
                                                const float* d, float* dembs, int tid) {
  for (int i = tid; i < e * TILE_P; i += NTHREADS) {
    const int c = i / TILE_P, q = i % TILE_P;
    const float* xr = x + (size_t)c * out_pad;
    float s = 0.f;
    for (int o = 0; o < out_pad; ++o) s = fmaf(__ldg(xr + o), d[o * TILE_P + q], s);
    dembs[i] += s;
  }
}

// d[k][q] += src[first + q][k] over a tile's points (rows < m) and features
// k < w, src row-major (M, w): the classifier's dx_last added to the final
// layer's input gradient.  A lane is a point, each warp takes blocks of 32
// features, skewed by the lane so that the 32 lanes write 32 banks; a lane's
// 128-byte row segment stays in L1 across the 32 steps.
__device__ __forceinline__ void add_transposed(float* d, const float* __restrict__ src, int w,
                                               int m, int first, int tid) {
  const int lane = tid & 31, row = first + lane;
  if (row >= m) return;
  const float* s = src + (size_t)row * w;
  for (int k0 = (tid >> 5) * 32; k0 < w; k0 += NTHREADS) {
    for (int j = 0; j < 32; ++j) {
      const int k = k0 + ((lane + j) & 31);
      if (k < w) d[k * TILE_P + lane] += __ldg(s + k);
    }
  }
}

#define WG_T 64   // output tile edge
#define WG_K 32   // points per step

__global__ void __launch_bounds__(NTHREADS)
wgrad_kernel(const float* __restrict__ A, const float* __restrict__ B, float* __restrict__ C,
             int K, int N, int m, int chunk) {
  __shared__ float As[WG_K][WG_T + 1];
  __shared__ float Bs[WG_K][WG_T + 1];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int n0 = blockIdx.x * WG_T, k0 = blockIdx.y * WG_T;
  const int p_begin = blockIdx.z * chunk, p_end = min(m, p_begin + chunk);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int p0 = p_begin; p0 < p_end; p0 += WG_K) {
#pragma unroll
    for (int i = 0; i < (WG_T * WG_K) / NTHREADS; ++i) {
      const int f = tid + i * NTHREADS;
      const int r = f / WG_K, c = f % WG_K, pt = p0 + c;
      const bool in = pt < p_end;
      As[c][r] = (in && k0 + r < K) ? __ldg(A + (size_t)(k0 + r) * m + pt) : 0.f;
      Bs[c][r] = (in && n0 + r < N) ? __ldg(B + (size_t)(n0 + r) * m + pt) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < WG_K; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty * 4 + i;
    if (k >= K) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) atomicAdd(C + (size_t)k * N + n, acc[i][j]);
    }
  }
}

// C (K, N) += A (K, m) . B (N, m)^T.  C must hold zeros (or a sum to add to).
static int launch_wgrad(const float* A, const float* B, float* C, int K, int N, int m,
                        cudaStream_t stream) {
  const int gx = (N + WG_T - 1) / WG_T, gy = (K + WG_T - 1) / WG_T;
  // split M so the grid holds ~8 blocks per SM, each at least 128 points
  int splits = (8 * 132 + gx * gy - 1) / (gx * gy);
  const int max_splits = (m + 127) / 128;
  if (splits > max_splits) splits = max_splits;
  if (splits < 1) splits = 1;
  int chunk = (m + splits - 1) / splits;
  chunk = (chunk + WG_K - 1) / WG_K * WG_K;
  splits = (m + chunk - 1) / chunk;
  wgrad_kernel<<<dim3(gx, gy, splits), NTHREADS, 0, stream>>>(A, B, C, K, N, m, chunk);
  return (int)cudaGetLastError();
}

// out[s][o] = sum of d[o][p] over segment s (per_segment: scene tables), or
// out[o] += that sum (a global bias; out must hold zeros).
__global__ void __launch_bounds__(NTHREADS)
colsum_kernel(const float* __restrict__ d, float* __restrict__ out, int rows, int m, int seg,
              int per_segment) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int o = blockIdx.x * (NTHREADS / 32) + warp;
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
  colsum_kernel<<<dim3((rows + 7) / 8, segments), NTHREADS, 0, stream>>>(d, out, rows, m, seg,
                                                                         per_segment);
  return (int)cudaGetLastError();
}
