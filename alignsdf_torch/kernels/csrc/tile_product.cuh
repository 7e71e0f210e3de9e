// The fused grid decoders' shared trunk code (kernels K1 and K3): a block of
// NTHREADS threads owns a tile of TILE_P points whose activations stay in
// shared memory as [feature][point].  A hidden layer is computed in chunks of
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

// One hidden layer over the tile (offsets into prm; -1 = absent):
// out[o][p] = relu(b[o] + sum_k W[k][o] in[k][p] + sum_c Lat[c][o] lat[c][p]
//                  + X[:, o] . xyz[p]),
// W (in_pad, out_pad), Lat (lat_pad, out_pad), X (3, out_pad).
// Inlined, so a caller that passes lat_off = -1 compiles without the latent.
__device__ __forceinline__ void hidden_layer(const float* __restrict__ prm, int w_off, int x_off,
                                             int lat_off, int b_off, int in_pad, int out_pad,
                                             int lat_pad, const float* in, const float* lat,
                                             float* out, float* ws, const float* xyz, int tid) {
  const int tx = tid & 7;
  const int ty = tid >> 3;
  for (int oc = 0; oc < out_pad; oc += OCHUNK) {
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    if (w_off >= 0) tile_product(acc, prm + w_off, out_pad, in_pad, in, ws, oc, tid);
    if (lat_off >= 0) tile_product(acc, prm + lat_off, out_pad, lat_pad, lat, ws, oc, tid);

#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int o = oc + ty * 8 + i;
      const float bo = __ldg(prm + b_off + o);
      float wx = 0.f, wy = 0.f, wz = 0.f;
      if (x_off >= 0) {
        wx = __ldg(prm + x_off + o);
        wy = __ldg(prm + x_off + out_pad + o);
        wz = __ldg(prm + x_off + 2 * out_pad + o);
      }
      float r[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = tx * 4 + j;
        float v = acc[i][j] + bo;
        if (x_off >= 0) v += wx * xyz[p] + wy * xyz[TILE_P + p] + wz * xyz[2 * TILE_P + p];
        r[j] = fmaxf(v, 0.f);
      }
      *reinterpret_cast<float4*>(out + o * TILE_P + tx * 4) = make_float4(r[0], r[1], r[2], r[3]);
    }
  }
  __syncthreads();  // `out` is complete before the next layer reads it
}

// oacc[r][p] += sum_k fin[r][k] act[k][p] (+ fin_xyz[r] . xyz[p]) for the
// n_rows final rows fin (n_rows, last_pad) at fin_off and fin_xyz (n_rows, 3)
// at fin_xyz_off (-1 = absent); lanes are points (conflict-free).  Each row
// is four partial sums over k = 0, 1, 2, 3 (mod 4), added in that order.
// Two rows (the SDFs): warp w sums part w%4 of row w/4, through `red`
// (NTHREADS floats of scratch).  More rows (the classifier's): a warp takes
// whole rows and runs their four parts as independent chains, so that 8 rows
// cost about one pass of 2, not four; the sums are the same.
__device__ void final_rows(const float* __restrict__ prm, int fin_off, int fin_xyz_off,
                           int last_pad, int n_rows, const float* act, float* red, float* oacc,
                           const float* xyz, int tid) {
  const int p = tid & 31, w = tid >> 5;
  if (n_rows > 2) {
    for (int r = w; r < n_rows; r += NTHREADS / 32) {
      const float* f = prm + fin_off + r * last_pad;
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
      for (int k = 0; k < last_pad; k += 4) {
        s0 = fmaf(__ldg(f + k), act[k * TILE_P + p], s0);
        s1 = fmaf(__ldg(f + k + 1), act[(k + 1) * TILE_P + p], s1);
        s2 = fmaf(__ldg(f + k + 2), act[(k + 2) * TILE_P + p], s2);
        s3 = fmaf(__ldg(f + k + 3), act[(k + 3) * TILE_P + p], s3);
      }
      float v = s0 + s1 + s2 + s3;
      if (fin_xyz_off >= 0) {
        const float* fx = prm + fin_xyz_off + r * 3;
        v += fx[0] * xyz[p] + fx[1] * xyz[TILE_P + p] + fx[2] * xyz[2 * TILE_P + p];
      }
      oacc[r * TILE_P + p] += v;
    }
    __syncthreads();
    return;
  }
  const int r = w >> 2, part = w & 3;
  const float* f = prm + fin_off + r * last_pad;
  float s = 0.f;
  for (int k = part; k < last_pad; k += 4) s = fmaf(__ldg(f + k), act[k * TILE_P + p], s);
  red[w * TILE_P + p] = s;
  __syncthreads();
  if (tid < 2 * TILE_P) {
    const int rr = tid / TILE_P, pp = tid % TILE_P;
    float v = red[(rr * 4 + 0) * TILE_P + pp] + red[(rr * 4 + 1) * TILE_P + pp]
            + red[(rr * 4 + 2) * TILE_P + pp] + red[(rr * 4 + 3) * TILE_P + pp];
    if (fin_xyz_off >= 0) {
      const float* fx = prm + fin_xyz_off + rr * 3;
      v += fx[0] * xyz[pp] + fx[1] * xyz[TILE_P + pp] + fx[2] * xyz[2 * TILE_P + pp];
    }
    oacc[tid] += v;
  }
  __syncthreads();
}
