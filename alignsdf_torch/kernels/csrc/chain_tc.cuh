// The train backwards' reverse chain on Hopper's tensor cores (kernels K2,
// K4 and K5).  Per point, for each trunk, from the final layer down:
//   dpre_last = dy (1 - y^2),
//   dpre_{l-1} = (dpre_l W_l^T) * gate_{l-1},  gate = (a > 0) s from the
//                stored gated activation a (s = 1/keep on dropout layers),
//   d(emb)    = sum over layers with X of dpre_l X_l^T,
//   dlat      = sum over layers with Lat of dpre_l Lat_l^T (K4; K5's
//               d(head), x0's leading columns, with X_l[:h] as Lat_l),
// and every dpre_l is written to device memory as (out_pad, M), where the
// weight-gradient reduction (wgrad_tc.cuh) and colsum read it.
//
// The design is the grid trunk's (grid_trunk_tc.cuh) run backwards.  A block
// of TC_THREADS threads owns TC_P = 64 points.  Their dpre stays in one
// shared-memory buffer as [feature][point] (tc_swz), updated in place layer
// by layer.  A layer's product reads its dpre (depth = the layer's out_pad)
// as wgmma's A from the buffer, split in registers, and the layer's
// transposed weights as B: for dx the depth is the layer's out-features and
// the outputs its in-features, so B is tile_weights(W^T) with out_pad as k.
// K4's latent layers put Lat^T beside W^T, one run of output groups [dx |
// dlat] (in_pad + c_pad <= 512), so one pass over dpre serves both; K5's
// layers with X put X[:h]^T there, [dx | d(head)].  The
// tiles are split and tiled once a step when the trunk is packed, laid out
// as one stream in the order the chain reads them (each trunk's from its
// last hidden layer down), and stream through the trunk's ring (tc_fill,
// tc_steps) by bulk copy.  Split TF32 (three products a k step) keeps
// float32's accuracy (tests/test_torch_split_tf32.py emulates it).
//
// After a layer's products the raw outputs go to the buffer (every warp is
// past reading its dpre), then a pass over 16-byte runs of 4 points gates
// the dx rows with the stored activation, written back and, coalesced, to
// dpre_{l-1} in device memory (a feature row of 64 points is 256 contiguous
// bytes); K4's dlat rows are added into a block-owned scratch (c_pad, M) in
// device memory by plain read-modify-write (no atomics, a fixed order), K5's
// d(head) rows so into its d(x0) (e, M): the
// buffer (128 KB) and the ring (88 KB) leave no room for a 64 KB dlat
// accumulator, and a ring shorter than the trunk's tuned 11 slots is untried.
// The gate's rows are prefetched into L2 when the layer's products start,
// so that their reads from device memory overlap the products.  Work run
// beside the products instead, a slice a k step between the products'
// launch and their wait (dpre's write-out, d(emb)), measured slower: the
// k-step loop is the critical path (PERF.md).
//
// What bounds it: arithmetic.  K2's chain at the flagship widths is 0.525 M
// multiply-adds a point a trunk (0.268 TFLOP a step of two trunks over
// 128,000 points), split TF32 1.63 ms; K4's 0.787 M (0.403 TFLOP), 2.44 ms.
// The gates' reads and dpre's writes, ~14 KB a point a trunk (3.7 GB a K2
// step), take 1.1 ms at HBM's rate.  As measured on an H100 (PERF.md), the
// products run at ~1.9x their bound, as the grid trunk's do, and take ~60%
// of a block's cycles; the passes between them, where the tensor cores
// idle, most of the rest (the gates ~20% in K2, K4's DRAM-bound tap stage
// ~15%).
//
// Small products stay on the CUDA cores: the final layer's 1-2 rows (their
// weights staged in shared memory), the classifier's dx_last, and d(emb)
// (N = e), whose x each warp holds in registers for its eighth of the
// features and broadcasts by shuffle.  A latent_in final layer's input
// gradient (ch_final_in: K2's d(emb), K4's dlat and d(emb), K5's d(x0))
// reads the final rows' dpre from oacc and its weights through L1, a
// thread a (point, input row), and stores the chain's first term there:
// nothing more is staged, so shared memory stays 231,776 bytes (bf16
// 231,856) at the flagship's width.
//
// Shared memory: the ring (TC_SLOTS x 8 KB), the buffer CH_ROWS x 64 x 4 =
// 128 KB, the trunk's small rows (tc_shared) and d(emb)'s partial sums
// (8 KB): 231,776 bytes, one block an SM.  K4's tap stage, after the chain,
// reuses the buffer.
//
// bf16 (K2, K4 and K5 with TcBf16, the JAX kernels' backwards with cdtype
// bfloat16, decoder_train_kernel.py:609-640, :207-285 and
// decoder_train_pixel.py:464-487): the same chain templated on the trunk's
// arithmetic.  The gates come from the bf16 residuals (8 bytes
// a 4-point run); every product takes dpre rounded to bf16: the gate pass
// (and the final rows, whose dy (1 - y^2) is rounded before its dx) writes
// dpre twice, float32 for colsum's bias sums, which JAX takes of the
// unrounded dpre, and rounded to bf16 for the weight-gradient reduction
// (wgrad_tc.cuh's bf16 route), and keeps the rounded value in the buffer,
// the A of the next dx product (one wgmma.m64n128k16 bf16 a k step of 16,
// tiles of W^T from tile_weights(W^T, bf16)) and of d(emb) on the CUDA
// cores against the bf16-rounded X.  dx_last is added in float32 before
// the gate, as JAX adds it.  Bytes a dpre element: 4 + 2 written, 4 read by
// colsum and 2 by the reduction (from L2 once per 128 rows of dW), against
// 4 written and 4 + 4 read had the reduction rounded a float32 dpre itself.
// Shared memory: 22 ring slots of 4 KB (88 KB, as float32's 11 of 8 KB), 22
// barriers: 231,856 bytes.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_trunk_tc.cuh"

#define CH_ROWS TC_MAX_OUT  // the dpre buffer's rows: at most 512 features
#define CH_EMB 4            // d(emb) columns a round
#define CH_WARPS (TC_THREADS / 32)
#define CH_BATCH 16         // 16-byte runs a thread has in flight in a pass

// CH_PROBE, 0 in the package's build: tools/time_train_chain.py builds
// copies that leave parts of the chain out, to time the rest apart: 1 the
// products (and the ring), 2 the gate and dlat passes (and their
// prefetches), 4 d(emb), 8 K4's tap stage, 64 the gates' loads, 128 the
// gates' stores; their results are wrong.  32 clocks the phases of each
// block on its thread 0 (ChClock).
#ifndef CH_PROBE
#define CH_PROBE 0
#endif

struct ChShared {
  TcShared tc;  // ring, act = the dpre buffer, oacc = the final rows' dpre, full
  float* red;   // [CH_WARPS][CH_EMB][TC_P]: d(emb)'s partial sums; the final rows' weights
};

template <class Cfg = TcF32>
__host__ __device__ inline size_t ch_tc_bytes() {
  return (tc_smem_bytes<Cfg>(CH_ROWS) + 15) / 16 * 16;
}

template <class Cfg = TcF32>
__host__ __device__ inline size_t ch_smem_bytes() {
  return ch_tc_bytes<Cfg>() + sizeof(float) * CH_WARPS * CH_EMB * TC_P;
}

template <class Cfg = TcF32>
__device__ __forceinline__ ChShared ch_shared(float* base) {
  ChShared s;
  s.tc = tc_shared<Cfg>(base, CH_ROWS);
  s.red = base + ch_tc_bytes<Cfg>() / sizeof(float);
  return s;
}

// The tile stream as the trunk's ring reads it (tc_fill): one run of
// tiles, trunk 1's (K4) from tile `split` on.
template <class Cfg = TcF32>
__device__ __forceinline__ TcPlan ch_stream(int split) {
  TcPlan plan;
  plan.split = split;
  plan.stream[0] = 0;
  plan.stream[1] = split * Cfg::kTile;
  return plan;
}

// Thread 0, before the block's first barrier: the ring's barriers and its
// first Cfg::kSlots tiles.
template <class Cfg = TcF32>
__device__ __forceinline__ void ch_init(const float* tiles, const TcPlan& plan, const TcShared& s,
                                        int total) {
  if (CH_PROBE & 1) return;
  for (int i = 0; i < Cfg::kSlots; ++i) tc_mbar_init(&s.full[i], 1);
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  for (int j = 0; j < Cfg::kSlots; ++j) tc_fill<Cfg>(tiles, plan, s, j, total);
}

// 16 bytes at p (16-byte aligned) that this block reads once: past L1, so
// that they do not evict the small operands the block reads again.
__device__ __forceinline__ float4 ch_ld_once(const float* p) {
  float4 v;
  asm("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p));
  return v;
}

// The same for 4 bf16 at p (8 bytes, 8-byte aligned), as 4 floats.
__device__ __forceinline__ float4 ch_ld_once(const __nv_bfloat16* p) {
  uint32_t lo, hi;
  asm("ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];" : "=r"(lo), "=r"(hi) : "l"(p));
  return make_float4(__uint_as_float(lo << 16), __uint_as_float(lo & 0xFFFF0000u),
                     __uint_as_float(hi << 16), __uint_as_float(hi & 0xFFFF0000u));
}

// Rows [0, rows) of act (row stride m) at this block's points into L2, ahead
// of the gate pass that reads them, to be kept there over the streaming
// dpre stores (evict_last): each row's first, middle and last point.
template <class T = float>
__device__ __forceinline__ void ch_prefetch(const T* act, int rows, int m, int first,
                                            int tid) {
  if (CH_PROBE & 2) return;
  const int last = min(TC_P, m - first) - 1;
  for (int i = tid; i < rows * 3; i += TC_THREADS) {
    const int k = i / 3, part = i % 3;
    const int p = part == 2 ? last : min(part * 32, last);
    asm volatile("prefetch.global.L2::evict_last [%0];" :: "l"(act + (size_t)k * m + first + p));
  }
}

// A layer's product: this warpgroup's output groups wg and wg + 2 of
// `groups` over dpre rows [0, depth), from ring tile `slot` on.
template <class Cfg = TcF32>
__device__ __forceinline__ void ch_product(float (&acc0)[64], float (&acc1)[64], int depth,
                                           int groups, int slot, const float* __restrict__ tiles,
                                           const TcPlan& plan, const TcShared& s, int total,
                                           int wg, int wt, int p0, int t4) {
  const int mine = (groups > wg) + (groups > wg + 2);
#pragma unroll
  for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0.f;
  if (CH_PROBE & 1) return;
  if (mine == 2) {
    tc_steps<2, Cfg>(acc0, acc1, depth / Cfg::kK, 0, false, groups, slot, tiles, plan, s, total,
                     wg, wt, p0, t4);
  } else if (mine == 1) {
    tc_steps<1, Cfg>(acc0, acc1, depth / Cfg::kK, 0, false, groups, slot, tiles, plan, s, total,
                     wg, wt, p0, t4);
  }
}

// The raw outputs of group j (this thread's 64 accumulators) into buffer rows
// 128 j .. 128 j + 127.
__device__ __forceinline__ void ch_store(const float (&acc)[64], int j, float* buf, int p0,
                                         int t4) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int o = j * TC_GROUP + 8 * i + 2 * t4;
    buf[tc_swz(o, p0)] = acc[4 * i];
    buf[tc_swz(o + 1, p0)] = acc[4 * i + 1];
    buf[tc_swz(o, p0 + 8)] = acc[4 * i + 2];
    buf[tc_swz(o + 1, p0 + 8)] = acc[4 * i + 3];
  }
}

// A warpgroup's stores of a layer's outputs: groups wg and wg + 2 of
// `groups`.
__device__ __forceinline__ void ch_store_groups(const float (&acc0)[64], const float (&acc1)[64],
                                                int groups, float* buf, int wg, int p0, int t4) {
  if (groups > wg) ch_store(acc0, wg, buf, p0, t4);
  if (groups > wg + 2) ch_store(acc1, wg + 2, buf, p0, t4);
}

// 4 floats rounded to bf16, as floats.
__device__ __forceinline__ float4 ch_round4(float4 v) {
  return make_float4(tc_round_bf16(v.x), tc_round_bf16(v.y), tc_round_bf16(v.z),
                     tc_round_bf16(v.w));
}

// Buffer rows [0, rows) gated by the stored activation act (rows, M): v =
// a > 0 ? v s : 0, written back and to dpre (rows, M) as streaming stores
// (evicted from L2 first).  A thread takes
// runs of 4 points (a warp two rows of 64 points), CH_BATCH runs'
// loads in flight.  With bf16 residuals (T = __nv_bfloat16) v goes to dpre
// unrounded, rounded to bf16 into dpre16, and rounded into the buffer.
template <class T = float>
__device__ __forceinline__ void ch_gate(float* buf, int rows, const T* __restrict__ act,
                                        float s, float* __restrict__ dpre, int m, int first,
                                        int tid, __nv_bfloat16* __restrict__ dpre16 = nullptr) {
  if (CH_PROBE & 2) return;
  constexpr bool kBf16 = sizeof(T) == 2;
  const int n = rows * (TC_P / 4);
  for (int i0 = tid; i0 < n; i0 += CH_BATCH * TC_THREADS) {
    float4 a[CH_BATCH];
#pragma unroll
    for (int u = 0; u < CH_BATCH; ++u) {
      const int i = i0 + u * TC_THREADS, k = i >> 4, p = (i & 15) << 2;
      a[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < n && first + p < m)
        a[u] = CH_PROBE & 64 ? make_float4(1.f, 1.f, 1.f, 1.f) : ch_ld_once(act + (size_t)k * m + first + p);
    }
#pragma unroll
    for (int u = 0; u < CH_BATCH; ++u) {
      const int i = i0 + u * TC_THREADS, k = i >> 4, p = (i & 15) << 2;
      if (i >= n) continue;
      float4* d = reinterpret_cast<float4*>(buf + tc_swz(k, p));
      float4 v = *d;
      v.x = a[u].x > 0.f ? v.x * s : 0.f;
      v.y = a[u].y > 0.f ? v.y * s : 0.f;
      v.z = a[u].z > 0.f ? v.z * s : 0.f;
      v.w = a[u].w > 0.f ? v.w * s : 0.f;
      const bool out = !(CH_PROBE & 128) && first + p < m;
      if (out) __stcs(reinterpret_cast<float4*>(dpre + (size_t)k * m + first + p), v);
      if constexpr (kBf16) {
        v = ch_round4(v);
        if (out)
          __stcs(reinterpret_cast<uint2*>(dpre16 + (size_t)k * m + first + p), tc_pack4_bf16(v));
      }
      *d = v;
    }
  }
}

// Buffer rows [row0, row0 + rows) into dst (rows, M) at this block's points:
// stored where `store`, else added (each 16-byte run read and written by one
// thread, in the same order every time).
__device__ __forceinline__ void ch_accumulate(const float* buf, int row0, int rows,
                                              float* __restrict__ dst, bool store, int m,
                                              int first, int tid) {
  if (CH_PROBE & 2) return;
  const int n = rows * (TC_P / 4);
  for (int i0 = tid; i0 < n; i0 += CH_BATCH * TC_THREADS) {
    float4 a[CH_BATCH];
#pragma unroll
    for (int u = 0; u < CH_BATCH; ++u) {
      const int i = i0 + u * TC_THREADS, k = i >> 4, p = (i & 15) << 2;
      a[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (!store && i < n && first + p < m)
        a[u] = *reinterpret_cast<const float4*>(dst + (size_t)k * m + first + p);
    }
#pragma unroll
    for (int u = 0; u < CH_BATCH; ++u) {
      const int i = i0 + u * TC_THREADS, k = i >> 4, p = (i & 15) << 2;
      if (i >= n || first + p >= m) continue;
      const float4 v = *reinterpret_cast<const float4*>(buf + tc_swz(row0 + k, p));
      *reinterpret_cast<float4*>(dst + (size_t)k * m + first + p) =
          make_float4(a[u].x + v.x, a[u].y + v.y, a[u].z + v.z, a[u].w + v.w);
    }
  }
}

// The final layer on the CUDA cores: its pre-activation gradient g = dy (1 -
// y^2) (n_out <= 2 rows of y, dy at row stride m; written to dpre (n_out, M)
// and kept in g [n_out][TC_P]), then its input's raw gradient dx[k][p] =
// sum_r w[k][r] g[r][p] (w (in_pad, n_out), staged in ws) into buffer rows
// k < in_pad.  With dpre16 (bf16), g is also written there rounded to
// bf16, and the rounded g makes dx (w then holds bf16 values: exact
// products).
__device__ __forceinline__ void ch_final(const float* __restrict__ y, const float* __restrict__ dy,
                                         float* __restrict__ dpre, const float* __restrict__ w,
                                         int n_out, int in_pad, int m, int first, float* g,
                                         float* ws, float* buf, int tid,
                                         __nv_bfloat16* __restrict__ dpre16 = nullptr) {
  if (tid < n_out * TC_P) {
    const int r = tid / TC_P, p = tid % TC_P;
    float v = 0.f;
    if (first + p < m) {
      const size_t at = (size_t)r * m + first + p;
      const float yv = y[at];
      v = dy[at] * (1.f - yv * yv);
      dpre[at] = v;
      if (dpre16) {
        v = tc_round_bf16(v);
        dpre16[at] = __float2bfloat16_rn(v);
      }
    }
    g[tid] = v;
  }
  for (int i = tid; i < in_pad * n_out; i += TC_THREADS) ws[i] = __ldg(w + i);
  __syncthreads();
  // a thread: one point, every fourth feature
  const int p = tid % TC_P;
  const float g0 = g[p], g1 = n_out > 1 ? g[TC_P + p] : 0.f;
  for (int k = tid / TC_P; k < in_pad; k += TC_THREADS / TC_P)
    buf[tc_swz(k, p)] = n_out > 1 ? fmaf(ws[2 * k + 1], g1, ws[2 * k] * g0) : ws[k] * g0;
}

// The input gradient of a latent_in final layer on the CUDA cores:
// dst[p][c] (+)= sum_r w[c][r] g[r][p] for c < rows, w (rows, n_out), g
// ch_final's dpre [n_out][TC_P] (bf16: rounded, and w holds bf16 values:
// exact products), entry (p, c) at dst + p ld_p + c ld_c (K2's and K4's
// d(emb) (M, e): ld_p = e, ld_c = 1; K4's dlat scratch and K5's d(x0),
// (rows, M): ld_p = 1, ld_c = M).  Stored where `store` (the chain's first
// term there), else added; each entry by one thread.  A thread a point, so
// that a warp's stores to a (rows, M) row are contiguous.
__device__ __forceinline__ void ch_final_in(const float* g, const float* __restrict__ w, int rows,
                                            int n_out, float* __restrict__ dst, size_t ld_p,
                                            size_t ld_c, bool store, int m, int first, int tid) {
  for (int i = tid; i < rows * TC_P; i += TC_THREADS) {
    const int c = i / TC_P, p = i % TC_P;
    if (first + p >= m) continue;
    float v = __ldg(w + (size_t)c * n_out) * g[p];
    if (n_out > 1) v = fmaf(__ldg(w + (size_t)c * n_out + 1), g[TC_P + p], v);
    float* out = dst + (size_t)(first + p) * ld_p + (size_t)c * ld_c;
    *out = store ? v : *out + v;
  }
}

// Buffer rows k < w += src[first + p][k], src (M, w) row-major: the
// classifier's dx_last added to the final layer's input gradient.  The
// block's rows of src are one contiguous run, read coalesced, CH_BATCH
// values a thread in flight.
__device__ __forceinline__ void ch_add_rows(float* buf, const float* __restrict__ src, int w, int m,
                                            int first, int tid) {
  const int n = min(TC_P, m - first) * w;
  src += (size_t)first * w;
  for (int i0 = tid; i0 < n; i0 += CH_BATCH * TC_THREADS) {
    float v[CH_BATCH];
#pragma unroll
    for (int u = 0; u < CH_BATCH; ++u) {
      const int i = i0 + u * TC_THREADS;
      v[u] = i < n ? __ldg(src + i) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < CH_BATCH; ++u) {
      const int i = i0 + u * TC_THREADS;
      if (i < n) buf[tc_swz(i % w, i / w)] += v[u];
    }
  }
}

// d(emb) of the layer whose dpre fills buffer rows [0, out_pad): demb[p][c]
// (+)= sum_o x[c][o] dpre[o][p], x (e, out_pad), entry (p, c) at demb + p
// ld_p + c ld_c (K2's and K4's (M, e): ld_p = e, ld_c = 1; K5's tail of its
// (e, M) d(x0): ld_p = 1, ld_c = M).  Warp w sums an
// eighth of the features (len <= 64 of them), a lane a point and the point
// 32 on, CH_EMB columns a round; the warp's x for the round sits in its
// lanes' registers (feature o0 + lane and o0 + 32 + lane) and reaches every
// lane by shuffle, so the round reads x from device memory once.  The warps
// meet in red.  `store`: the first layer with x stores, the later ones add
// (each entry by the same thread).
__device__ void ch_demb(const float* buf, int out_pad, const float* __restrict__ x, int e,
                        float* __restrict__ demb, size_t ld_p, size_t ld_c, bool store, int m,
                        int first, float* red, int tid) {
  if (CH_PROBE & 4) return;
  const int lane = tid & 31, warp = tid >> 5;
  const int len = out_pad / CH_WARPS, o0 = warp * len;
  for (int c0 = 0; c0 < e; c0 += CH_EMB) {
    float xr[CH_EMB][2], s[CH_EMB][2];
#pragma unroll
    for (int j = 0; j < CH_EMB; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o = 32 * h + lane;
        xr[j][h] = c0 + j < e && o < len ? __ldg(x + (size_t)(c0 + j) * out_pad + o0 + o) : 0.f;
        s[j][h] = 0.f;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      for (int src = 0; src < 32 && 32 * h + src < len; ++src) {
        const int o = o0 + 32 * h + src;
        const float d0 = buf[tc_swz(o, lane)], d1 = buf[tc_swz(o, lane + 32)];
#pragma unroll
        for (int j = 0; j < CH_EMB; ++j) {
          const float xv = __shfl_sync(0xffffffffu, xr[j][h], src);
          s[j][0] = fmaf(xv, d0, s[j][0]);
          s[j][1] = fmaf(xv, d1, s[j][1]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < CH_EMB; ++j) {
      red[(warp * CH_EMB + j) * TC_P + lane] = s[j][0];
      red[(warp * CH_EMB + j) * TC_P + lane + 32] = s[j][1];
    }
    __syncthreads();
    for (int i = tid; i < TC_P * CH_EMB; i += TC_THREADS) {
      const int pp = i % TC_P, j = i / TC_P, c = c0 + j;
      if (c < e && first + pp < m) {
        float v = 0.f;
#pragma unroll
        for (int w = 0; w < CH_WARPS; ++w) v += red[(w * CH_EMB + j) * TC_P + pp];
        float* out = demb + (size_t)(first + pp) * ld_p + (size_t)c * ld_c;
        *out = store ? v : *out + v;
      }
    }
    __syncthreads();
  }
}

// The phases of a block on its thread 0, in clock cycles, where CH_PROBE has
// 32 (tools/time_train_chain.py): tick(ph) adds the cycles since the last
// tick to phase ph; flush() adds them into ch_cycles.  Nothing otherwise.
#define CH_PHASES 8  // ring set-up, final rows, gates, products, d(emb), stores, dlat, taps
#if CH_PROBE & 32
__device__ unsigned long long ch_cycles[CH_PHASES];
extern "C" int ch_read_cycles(unsigned long long* out) {
  const cudaError_t err = cudaMemcpyFromSymbol(out, ch_cycles, sizeof(ch_cycles));
  const unsigned long long zero[CH_PHASES] = {};
  return err != cudaSuccess ? (int)err : (int)cudaMemcpyToSymbol(ch_cycles, zero, sizeof(zero));
}
#endif
struct ChClock {
  long long last, acc[CH_PHASES];
  __device__ __forceinline__ ChClock() {
    if (CH_PROBE & 32) {
      last = clock64();
      for (int i = 0; i < CH_PHASES; ++i) acc[i] = 0;
    }
  }
  __device__ __forceinline__ void tick(int ph) {
    if (CH_PROBE & 32) {
      const long long now = clock64();
      acc[ph] += now - last;
      last = now;
    }
  }
  __device__ __forceinline__ void flush(int tid) const {
#if CH_PROBE & 32
    if (tid == 0)
      for (int i = 0; i < CH_PHASES; ++i) atomicAdd(&ch_cycles[i], (unsigned long long)acc[i]);
#endif
  }
};

// Host: the tiles of a chain layer (depth out_pad, `cols` outputs), or -1
// where the chain does not take it: cols a multiple of TC_GROUP up to
// CH_ROWS (the outputs go back to the buffer), out_pad likewise.
template <class Cfg = TcF32>
static inline int ch_layer_tiles(int out_pad, int cols) {
  if (out_pad < TC_GROUP || out_pad % TC_GROUP || out_pad > CH_ROWS) return -1;
  if (cols < 0 || cols % TC_GROUP || cols > CH_ROWS) return -1;
  return out_pad / Cfg::kK * (cols / TC_GROUP);
}
