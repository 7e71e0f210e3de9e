// Pixel-aligned train decoder (kernel K4) for NVIDIA Hopper (sm_90a):
// forward and backward of both trunks on a per-point latent sampled from the
// HeadNet feature map.
//
// Replaces alignsdf_tpu/ops/decoder_train_pixel.py:fused_pixel_decoder, its
// forward _fused_pixel_fwd (body _fwd_kernel) and its backward
// _fused_pixel_bwd (body _bwd_kernel), unbanded and banded (band=..., the
// windowed d(table) of _bwd_kernel :605-632).  For each point (row r of M,
// scene r / nps):
//   lat = bicubic sample of the scene's (HW, C) table at (xp, yp) (Keys,
//         A = -0.75, zero padding: a tap off the map weighs 0) where mask
//         is 1, else the scene's mean row;
// then each trunk runs on [lat | emb]: layer l computes
//   acc = a_{l-1} @ W_l (if W) + lat @ Lat_l + emb @ X_l (layer 0 and the
//         latent_in layers) + b_l,
// ReLU and the hash dropout gate on hidden layers, tanh on the last.  Both
// trunks draw from one seed; trunk t hashes layer + layer_off[t] (the object
// trunk layer + n_layers, as the TPU kernel does).  The projection to
// (xp, yp, mask) runs outside, in plain PyTorch, so that autograd carries
// d(xp), d(yp) on to the predicted hand root.  The first trunk's last hidden
// gated activation is the classifier's x_last (_fused_pixel_fwd :431-434):
// the forward already stores it as a residual, so the wrapper returns a view
// of it, and the backward adds its gradient dx_last (M, h) to that trunk's
// final-layer input gradient before the last hidden gate (_trunk_backward
// :489-490), as K2 does.
//
// What bounds it: arithmetic.  At the flagship width (C = 256, 6 embedding
// columns, hidden 512 -> 250 -> 512 -> 512 -> 1) a trunk costs 0.787 M
// multiply-adds per point forward and twice that backward, against ~10 KB a
// point of residuals; the sampling is 16 taps x C (8 kFLOP a point each way)
// from a 268 MB table.  Forward and backward run split TF32 on wgmma, as
// K2's: the forward on train_fwd_tc.cuh, the backward's chain on
// chain_tc.cuh and its weight-gradient reduction on wgrad_tc.cuh.
//
// Forward (pixel_train_fwd_tc_kernel): K2's tensor-core forward
// (train_fwd_tc.cuh, 64 points a block) with K3's gather as its fill.  The
// block gathers its points' latent once into buffer rows [0, c_pad) (one
// thread a channel, so a warp reads 128 contiguous bytes of a tap's row) and
// stores it as the residual (c_pad, M); layer 0 of the first trunk runs on
// those rows, and every later layer that reads the latent (the latent_in
// layers, the second trunk's layer 0) reloads it from that residual, which
// this block just wrote and L2 still holds, into the rows right above its
// activation rows: one product over [activation; latent] against [W; Lat]
// tiles.  The embedding enters in the epilogue, as K2's.
//
// Backward.  The TPU kernel forms d(table) per scene as a dense wxy @ dlat
// product accumulated across a sequential grid; here each point scatters
// its 16 taps with atomics instead:
//  1. pixel_train_bwd_chain_tc_kernel, per 64-point tile: K2's reverse
//     chain on the tensor cores (chain_tc.cuh) over both trunks (each
//     layer's dpre written to device memory, d(emb) added per point), plus
//     dlat = sum over the latent layers of dpre @ Lat^T in the same products
//     as dx ([W^T | Lat^T]), summed over both trunks into a block-owned
//     scratch (c_pad, M) in device memory.  Then, back in shared memory,
//     from dlat: d(table) += wy wx dlat at each tap (atomicAdd), d(mean) +=
//     dlat for points outside the image (summed over the tile's points of
//     one scene first), and d(xp) = sum over taps of wy gx (fe . dlat),
//     d(yp) = sum of gy wx (fe . dlat), with gx = -K'(col - xp), gy =
//     -K'(row - yp); 0 outside the image.
//  2. wgrad_tc_kernel / colsum_kernel (train_common.cuh) per layer: dW from the
//     activations, dLat from the latent residual, dX from the embedding, db.
// One call of pixel_train_bwd enqueues all of these on one stream.
//
// The band (JAX make_fused_train_decoder_pixel(band=...), PixelStatic.band
// :103).  On the TPU a band cuts the dense contractions wxy^T fe and wxy dlat
// to `band` rows of the table around a block's points (_weight_tile
// :164-182, the forward's row window :248-253, the backward's :605-632),
// chosen per call by a fits flag (:420-425, :755-757).  Here the forward
// gathers only each point's 16 taps, so it has nothing to cut and stays as
// it is.  The backward's tap stage has: its per-tap atomics collide where a
// tile's points share map rows, which is what a batch sorted by row
// (data/pixel_sort.py, or the plan's device sort) makes.  With `band` set,
// each tile bounds the rows its in-image points' taps touch, per scene
// segment of the tile (floor(yp) - 1 .. floor(yp) + 2, clamped; JAX's
// per-block bounds :976-992 without the TPU's row alignment), and a
// segment whose rows fit `band` from r0 = min(bottom, hf - band) sums its
// d(table) in shared memory instead: a (band x wf) x BAND_CH window over the
// ring and the buffer, free once the chain has ended, filled with shared
// atomics a pass of BAND_CH channels, then each touched cell's channels
// flushed with one global atomic each.  A segment that does not fit takes
// the per-tap atomics (JAX's fits fallback, per segment instead of per
// call).  d(mean), d(xp) and d(yp) are the same either way, and so are the
// summed terms: round(wy wx) dlat in float32 (wy wx in float32).  A band the
// shared memory cannot hold (band_rows_max) is refused.
//
// bf16 (the launchers' int `bf16`; the JAX kernel with cdtype bfloat16,
// decoder_train_pixel.py:347-362, :149-182, :259-267, :464-487, :607-640):
// the same kernels on the trunk's TcBf16 arithmetic, as K2's, one
// wgmma.m64n128k16 bf16 product a k step of 16 against bf16 tiles; the pack
// holds the weights, the mean and the embedding rounded to bf16 (the biases
// float32) and a bf16 copy of the table, packed once a step, which the
// gather and the tap stage read (half the bytes of the float32 table).  The
// gather rounds each tap weight wy wx, formed in float32, to bf16 (the
// product, not each factor, as JAX's dense wxy tile is rounded; K3's bf16
// LatentFill rounds the same way), sums the 16 exact products in float32 and
// rounds the latent to bf16: its residual, stored as bf16.  Each gated
// activation is rounded to bf16 and stored as bf16.  The chain writes each
// dpre twice, float32 (colsum) and rounded to bf16 (the reductions:
// wgrad_tc.cuh's bf16 route, dW from the bf16 residuals, dLat from the bf16
// latent, dX from the embedding's bf16 copy emb16), and its products and
// d(emb) take the rounded dpre.  The latent's gradient is summed in
// float32 (the scratch) and rounded as the tap stage reads it: d(table)
// scatters round(wy wx) dlat, d(mean) sums the rounded dlat, and d(xp),
// d(yp) take the dot products of the bf16 table with the rounded dlat and
// the float32 Keys weights and derivatives.

#include <cuda_runtime.h>
#include <stdint.h>

#include "chain_tc.cuh"
#include "keys_cubic.cuh"
#include "train_common.cuh"
#include "train_fwd_tc.cuh"

#define EMB_MAX 64     // embedding columns
#define MAX_LAYERS 8
#define MAX_TRUNKS 2
#define MAX_OUT 2

struct PLayer {
  const float *w, *wt;     // (in_pad, out_pad) and its transpose (final layer)
  const float* lat;        // latent weights (c_pad, out_pad)
  const float *x, *b;      // embedding weights (e, out_pad), bias (out_pad)
  float *act, *dpre;       // residual (out_pad, M; bf16 in bf16), pre-activation grad (out_pad, M)
  float *dw, *dlat, *dx, *db;
  int in_pad, out_pad, dropout;
  __nv_bfloat16* dpre16;   // bf16: dpre rounded, the reductions' operand
};

struct PTrunk {
  int n_layers, n_out, row_off, layer_off;
  PLayer layers[MAX_LAYERS];
};

struct PPlan {
  int n_trunks, e, m, nps, n_scenes, c, c_pad, hf, wf;
  const float *emb, *table, *mean, *xp, *yp, *mask;  // emb (e, M), table (B, HW, C), mean (B, C)
  float *lat, *y;  // latent residual (c_pad, M; bf16 in bf16), y (rows, M)
  const float* dy;
  float *demb, *dtable, *dmean, *dxp, *dyp;
  const float* dx_last;  // (M, xl_w), the first trunk's, or null
  int xl_w;
  float* dlatent;        // the backward's latent gradient (c_pad, M): scratch
  const float* tiles;    // the backward chain's weight tiles (chain_tc.cuh)
  long long tiles_len;   // their floats
  const float* fwd;      // the forward's weight tiles (train_fwd_tc.cuh)
  long long fwd_len;     // their floats
  const __nv_bfloat16* table16;  // bf16: the table (B, HW, C) as bf16, the taps' operand
  const __nv_bfloat16* emb16;    // bf16: the embedding (e, M) as bf16, dX's operand
  int band;              // the backward's banded tap stage: its window's rows, 0 = none
  int* tile_fit;         // band: per tile, its segments that took the window, or null
  PTrunk trunks[MAX_TRUNKS];
};

// One entry of the table: a float, or a bf16 as a float (exact).
__device__ __forceinline__ float tab_ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float tab_ld(const __nv_bfloat16* p) {
  return __uint_as_float((unsigned)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
}

// The backward's per-point tap data of a 64-point tile (threads 0 .. TC_P -
// 1, one point each): tw[q][16] = 4 row weights, 4 column weights, then 4
// row and 4 column derivative weights; trc[q][8] = 4 row offsets (row * wf,
// -1 off the map) and 4 columns (-1 off); flag[q] = the point lies in the
// image; scn[q] = its scene.
__device__ __forceinline__ void tile_taps(const PPlan& p, int first, int tid, float* tw, int* trc,
                                          int* flag, int* scn) {
  if (tid >= TC_P) return;
  const int row = first + tid;
  const bool live = row < p.m;
  scn[tid] = live ? row / p.nps : 0;
  const int in = live && p.mask[row] > 0.f;
  flag[tid] = in;
  if (!in) return;
  const float xp = p.xp[row], yp = p.yp[row];
  const float x0 = floorf(xp), y0 = floorf(yp);
  float* w = tw + tid * 16;
  keys_taps(yp - y0, w);
  keys_taps(xp - x0, w + 4);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = (int)y0 + i - 1, col = (int)x0 + i - 1;
    trc[tid * 8 + i] = (r >= 0 && r < p.hf) ? r * p.wf : -1;
    trc[tid * 8 + 4 + i] = (col >= 0 && col < p.wf) ? col : -1;
    w[8 + i] = -keys_grad((float)r - yp);
    w[12 + i] = -keys_grad((float)col - xp);
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// The forward's per-point tap table (threads 0 .. TC_P - 1, one point
// each): tw[q][16] the 16 taps' weights wy wx (tap (i, j) at 4 i + j, i the
// row's), toff[q][16] their pixels' offsets row * wf + col, a tap off the
// map weighing 0 at offset 0, so that the gather's 16 loads a point are
// unconditional and issue together; flag[q] = the point lies in the image;
// scn[q] = its scene.  kBf16: each weight wy wx rounded to bf16.
template <bool kBf16>
__device__ __forceinline__ void fw_taps(const PPlan& p, int first, int tid, float* tw, int* toff,
                                        int* flag, int* scn) {
  if (tid >= TC_P) return;
  const int row = first + tid;
  const bool live = row < p.m;
  scn[tid] = live ? row / p.nps : 0;
  const int in = live && p.mask[row] > 0.f;
  flag[tid] = in;
  if (!in) return;
  const float xp = p.xp[row], yp = p.yp[row];
  const float x0 = floorf(xp), y0 = floorf(yp);
  float wy[4], wx[4];
  keys_taps(yp - y0, wy);
  keys_taps(xp - x0, wx);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = (int)y0 + i - 1;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = (int)x0 + j - 1;
      const bool on = r >= 0 && r < p.hf && col >= 0 && col < p.wf;
      const float w = wy[i] * wx[j];
      tw[tid * 16 + 4 * i + j] = on ? (kBf16 ? tc_round_bf16(w) : w) : 0.f;
      toff[tid * 16 + 4 * i + j] = on ? r * p.wf + col : 0;
    }
  }
}

// The latent of the block's points into buffer rows [0, c_pad): the sum of
// a point's 16 weighted taps of its scene's table, or the scene's mean row
// outside the image; 0 in the padding channels and past M.  One thread a
// channel, so that a warp reads 128 contiguous bytes of a tap's row (64 of
// the bf16 table); runs of 4 points together (tc_swz keeps them
// contiguous), 64 loads in flight.  kBf16: the table is bf16 and the sum is
// rounded to bf16 (the mean row holds bf16 values).
template <bool kBf16, class T>
__device__ void fw_gather(const PPlan& p, const T* table, const float* tw, const int* toff,
                          const int* flag, const int* scn, float* buf, int first, int tid) {
  if (FW_PROBE & 8) return;
  const size_t hw = (size_t)p.hf * p.wf;
  for (int ch = tid; ch < p.c_pad; ch += TC_THREADS) {
    for (int q0 = 0; q0 < TC_P; q0 += 4) {
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int q = q0 + k;
        float s = 0.f;
        if (ch < p.c && first + q < p.m) {
          if (!flag[q]) {
            s = __ldg(p.mean + (size_t)scn[q] * p.c + ch);
          } else {
            const T* tab = table + (size_t)scn[q] * hw * p.c + ch;
#pragma unroll
            for (int t = 0; t < 16; ++t)
              s = fmaf(tw[q * 16 + t], tab_ld(tab + (size_t)toff[q * 16 + t] * p.c), s);
            if (kBf16) s = tc_round_bf16(s);
          }
        }
        v[k] = s;
      }
      *reinterpret_cast<float4*>(buf + tc_swz(ch, q0)) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// The forward's tap table beside the trunk's shared memory (fw_taps): 16
// weights, 16 offsets, a flag and a scene a point.
#define FW_TAP_BYTES (34 * sizeof(float) * TC_P)

// Cfg: the trunk's arithmetic (TcF32 or TcBf16); R: the residuals' type
// (float or __nv_bfloat16).
template <class Cfg, class R>
__global__ void __launch_bounds__(TC_THREADS, 1)
pixel_train_fwd_tc_kernel(const PPlan p, int rows, int total, unsigned seed, unsigned thresh,
                          float scale) {
  extern __shared__ __align__(128) float smem[];
  const TcShared s = tc_shared<Cfg>(smem, rows);
  float* tw = reinterpret_cast<float*>(s.full + Cfg::kSlots);  // [TC_P][16]
  int* toff = reinterpret_cast<int*>(tw + 16 * TC_P);         // [TC_P][16]
  int* flag = toff + 16 * TC_P;                                // [TC_P]
  int* scn = flag + TC_P;                                      // [TC_P]
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127, lane = tid & 31, t4 = lane & 3;
  const int p0 = 16 * (wt >> 5) + (lane >> 2);  // this thread's points: p0, p0 + 8
  const int first = blockIdx.x * TC_P;
  const TcPlan plan = fw_stream(total);
  FwClock clk;
  constexpr bool kBf16 = Cfg::kBf16;
  R* lat = reinterpret_cast<R*>(p.lat);
  if (tid == 0) fw_init<Cfg>(p.fwd, plan, s, total);
  fw_taps<kBf16>(p, first, tid, tw, toff, flag, scn);
  __syncthreads();
  clk.tick(0);
  if constexpr (kBf16) {
    fw_gather<true>(p, p.table16, tw, toff, flag, scn, s.act, first, tid);
  } else {
    fw_gather<false>(p, p.table, tw, toff, flag, scn, s.act, first, tid);
  }
  __syncthreads();
  fw_store(s.act, p.c_pad, lat, p.m, first, false, tid);
  clk.tick(1);

  const int ra = first + p0, rb = ra + 8;
  float acc0[64], acc1[64];
  int slot = 0;
  for (int t = 0; t < p.n_trunks; ++t) {
    const PTrunk& T = p.trunks[t];
    for (int l = 0; l < T.n_layers - 1; ++l) {
      const PLayer& L = T.layers[l];
      const int act_rows = L.w ? L.in_pad : 0, lat_rows = L.lat ? p.c_pad : 0;
      if (lat_rows > 0 && (t > 0 || l > 0)) {
        // the latent above the activation rows (no warp reads those rows
        // now: the previous layer's store pass reads rows below act_rows)
        fw_load(s.act, act_rows, lat_rows, static_cast<const R*>(lat), p.m, first, tid);
        __syncthreads();
        clk.tick(1);
      }
      const int groups = L.out_pad / TC_GROUP, depth = act_rows + lat_rows;
      fw_product<Cfg>(acc0, acc1, depth, groups, slot, p.fwd, plan, s, total, wg, wt, p0, t4);
      slot += depth / Cfg::kK * groups;
      __syncthreads();  // every warp is done reading the layer's input
      clk.tick(2);
      const unsigned layer = (unsigned)(l + T.layer_off);
      const unsigned ka = fw_key(seed, layer, (unsigned)ra), kb = fw_key(seed, layer, (unsigned)rb);
      if (groups > wg)
        fw_epilogue(acc0, wg, L.x, p.e, L.out_pad, p.emb + first, p.m, ra < p.m, rb < p.m, L.b,
                    L.b, L.dropout, ka, kb, thresh, scale, s.act, p0, t4, kBf16);
      if (groups > wg + 2)
        fw_epilogue(acc1, wg + 2, L.x, p.e, L.out_pad, p.emb + first, p.m, ra < p.m, rb < p.m,
                    L.b, L.b, L.dropout, ka, kb, thresh, scale, s.act, p0, t4, kBf16);
      __syncthreads();
      clk.tick(3);
      fw_store(s.act, L.out_pad, reinterpret_cast<R*>(L.act), p.m, first, true, tid);
      clk.tick(4);
    }
    // the final layer, with the latent (the residual this block stored) and
    // the embedding where latent_in names it; its barriers free the buffer
    // for the next trunk
    const PLayer& F = T.layers[T.n_layers - 1];
    fw_final(F.wt, F.b, T.n_out, F.in_pad, s.act, s.red, p.y + (size_t)T.row_off * p.m, p.m,
             first, tid, FwIn<R>{F.lat, lat + first, F.lat ? p.c : 0},
             FwIn<float>{F.x, p.emb + first, F.lat ? p.e : 0});
    clk.tick(5);
  }
  clk.flush(tid);
}

// ---------------------------------------------------------------------------
// backward 1: the reverse chain and the sampling's gradients per 64-point
// tile, the chain on the tensor cores
// ---------------------------------------------------------------------------

// The tap stage's shared floats at the buffer's end: dlat transposed to
// [TC_P][c_pad + 1], then the tap table (tile_taps: 26 words a point).
__host__ __device__ inline int tap_stage_floats(int c_pad) {
  return (TC_P * (c_pad + 1) + 3) / 4 * 4 + 26 * TC_P;
}

#define BAND_CH 16              // channels a pass of the band's window holds
#define BAND_SEG (4 * TC_P + 4)  // ints: each segment's lo, hi, r0, fit; the touched count
#define BAND_LIST (16 * TC_P)    // ints: a segment's touched cells (16 taps a point at most)

// The most rows the band's window takes on a wf-column map: from the ring's
// start to the tap stage's floats go the segment scratch, the cell list,
// band x wf touched flags and the band x wf x BAND_CH window.
template <class Cfg>
__host__ __device__ inline int band_rows_max(int wf, int c_pad) {
  const long long room = (long long)Cfg::kSlots * Cfg::kTile + (long long)CH_ROWS * TC_P
                         - tap_stage_floats(c_pad) - BAND_SEG - BAND_LIST;
  return (int)(room / ((long long)wf * (BAND_CH + 1)));
}

// The band's bounds of each scene segment of the tile (segment k: the
// tile's points of scene scn[0] + k), from its in-image points' rows:
// lo / hi the least and largest floor(yp), r0 = min(max(lo - 1, 0), hf -
// band), fit = 1 where the taps' rows up to min(hi + 2, hf - 1) lie below
// r0 + band; fit = 0 for a segment with no point in the image (nothing to
// scatter).  Ends with a barrier.
__device__ void band_bounds(const PPlan& p, int first, int tid, const int* flag, const int* scn,
                            int* seg) {
  int *lo = seg, *hi = seg + TC_P, *r0 = seg + 2 * TC_P, *fit = seg + 3 * TC_P;
  for (int k = tid; k < TC_P; k += TC_THREADS) {
    lo[k] = 0x7fffffff;
    hi[k] = -1;
  }
  __syncthreads();
  if (tid < TC_P && first + tid < p.m && flag[tid]) {
    const int y0 = (int)floorf(p.yp[first + tid]);
    atomicMin(lo + scn[tid] - scn[0], y0);
    atomicMax(hi + scn[tid] - scn[0], y0);
  }
  __syncthreads();
  if (tid < TC_P) {
    if (hi[tid] < lo[tid]) {
      r0[tid] = 0;
      fit[tid] = 0;
    } else {
      const int bot = max(lo[tid] - 1, 0), top = min(hi[tid] + 2, p.hf - 1);
      r0[tid] = min(bot, p.hf - p.band);
      fit[tid] = top < r0[tid] + p.band;
    }
  }
  __syncthreads();
}

// d(table) of the tile's fitting segments through the window (see the
// header): per segment, its taps' cells marked, listed and zeroed; per pass
// of BAND_CH channels, each tap's round(wy wx) dlat added into its cell with
// a shared atomic (one warp a point, its lanes over 32 / BAND_CH taps and
// BAND_CH channels), then each listed cell's channels flushed to d(table)
// with one global atomic and zeroed.  `room` is the ring's start.
template <bool kBf16>
__device__ void band_window(const PPlan& p, int first, int tid, const float* tw, const int* trc,
                            const int* flag, const int* scn, const float* dlt, int ld, int* seg,
                            float* room) {
  const int *r0 = seg + 2 * TC_P, *fit = seg + 3 * TC_P;
  int* count = seg + 4 * TC_P;
  int* list = reinterpret_cast<int*>(room) + BAND_SEG;
  int* touched = list + BAND_LIST;
  const int cells = p.band * p.wf;
  float* win = reinterpret_cast<float*>(touched + cells);  // [cells][BAND_CH]
  const int live = min(TC_P, p.m - first);
  const int n_seg = scn[live - 1] - scn[0] + 1;
  const int warp = tid >> 5, lane = tid & 31, cl = lane % BAND_CH;
  const size_t hw = (size_t)p.hf * p.wf;
  for (int i = tid; i < cells; i += TC_THREADS) touched[i] = 0;
  int taken = 0;
  for (int k = 0; k < n_seg; ++k) {
    if (!fit[k]) continue;
    ++taken;
    const int sc = scn[0] + k, base = r0[k] * p.wf;
    if (tid == 0) *count = 0;
    __syncthreads();  // the flags are clear, the count is 0
    for (int i = tid; i < 16 * TC_P; i += TC_THREADS) {
      const int q = i >> 4, t = i & 15;
      if (q >= live || !flag[q] || scn[q] != sc) continue;
      const int r = trc[q * 8 + (t >> 2)], col = trc[q * 8 + 4 + (t & 3)];
      if (r >= 0 && col >= 0) touched[r - base + col] = 1;
    }
    __syncthreads();
    for (int i = tid; i < cells; i += TC_THREADS)
      if (touched[i]) list[atomicAdd(count, 1)] = i;
    __syncthreads();
    const int n = *count;
    for (int i = tid; i < n * BAND_CH; i += TC_THREADS)
      win[list[i / BAND_CH] * BAND_CH + i % BAND_CH] = 0.f;
    __syncthreads();
    for (int c0 = 0; c0 < p.c; c0 += BAND_CH) {
      const int ch = c0 + cl;
      for (int q = warp; q < live; q += TC_THREADS / 32) {
        if (!flag[q] || scn[q] != sc) continue;
        const float* wq = tw + q * 16;
        const float d = ch < p.c ? dlt[q * ld + ch] : 0.f;
        for (int t = lane / BAND_CH; t < 16; t += 32 / BAND_CH) {
          const int r = trc[q * 8 + (t >> 2)], col = trc[q * 8 + 4 + (t & 3)];
          if (r < 0 || col < 0) continue;
          const float w = wq[t >> 2] * wq[4 + (t & 3)];
          atomicAdd(win + (r - base + col) * BAND_CH + cl, (kBf16 ? tc_round_bf16(w) : w) * d);
        }
      }
      __syncthreads();
      for (int i = tid; i < n * BAND_CH; i += TC_THREADS) {
        const int cell = list[i / BAND_CH], c = c0 + i % BAND_CH;
        float* v = win + cell * BAND_CH + i % BAND_CH;
        if (c < p.c) atomicAdd(p.dtable + ((size_t)sc * hw + base + cell) * p.c + c, *v);
        *v = 0.f;
      }
      __syncthreads();
    }
    for (int i = tid; i < n; i += TC_THREADS) touched[list[i]] = 0;
  }
  if (p.tile_fit && tid == 0) p.tile_fit[first / TC_P] = taken;
}

// Cfg, R: as the forward's.
template <class Cfg, class R>
__global__ void __launch_bounds__(TC_THREADS, 1)
pixel_train_bwd_chain_tc_kernel(const PPlan p, int total, int split, float scale) {
  extern __shared__ __align__(128) float smem[];
  constexpr bool kBf16 = Cfg::kBf16;
  const ChShared s = ch_shared<Cfg>(smem);
  float* buf = s.tc.act;
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127, lane = tid & 31, t4 = lane & 3;
  const int p0 = 16 * (wt >> 5) + (lane >> 2);  // this thread's points: p0, p0 + 8
  const int first = blockIdx.x * TC_P;
  const TcPlan plan = ch_stream<Cfg>(split);
  auto act = [&](const PLayer& L) { return reinterpret_cast<const R*>(L.act); };
  ChClock clk;
  if (tid == 0) ch_init<Cfg>(p.tiles, plan, s.tc, total);
  clk.tick(0);

  float acc0[64], acc1[64];
  int slot = 0;
  bool demb_stored = false, dlat_stored = false;
  for (int t = 0; t < p.n_trunks; ++t) {
    const PTrunk& T = p.trunks[t];
    // the final layer, then its input's gradient (plus dx_last on the first
    // trunk) gated by the last hidden layer's recovered gate
    const int last = T.n_layers - 1;
    const PLayer& F = T.layers[last];
    const PLayer& H = T.layers[last - 1];
    ch_prefetch(act(H), F.in_pad, p.m, first, tid);
    ch_final(p.y + (size_t)T.row_off * p.m, p.dy + (size_t)T.row_off * p.m, F.dpre, F.w, T.n_out,
             F.in_pad, p.m, first, s.tc.oacc, s.red, buf, tid, F.dpre16);
    if (F.lat) {  // a latent_in final layer: dlat (all c_pad rows) and d(emb)
      ch_final_in(s.tc.oacc, F.lat, p.c_pad, T.n_out, p.dlatent, 1, p.m, !dlat_stored, p.m,
                  first, tid);
      ch_final_in(s.tc.oacc, F.x, p.e, T.n_out, p.demb, p.e, 1, !demb_stored, p.m, first, tid);
      dlat_stored = demb_stored = true;
    }
    if (t == 0 && p.dx_last) {
      __syncthreads();
      ch_add_rows(buf, p.dx_last, p.xl_w, p.m, first, tid);
    }
    __syncthreads();
    clk.tick(1);
    ch_gate(buf, F.in_pad, act(H), H.dropout ? scale : 1.f, H.dpre, p.m, first, tid, H.dpre16);
    __syncthreads();
    clk.tick(2);

    // hidden layer l: one product of dpre_l with [W_l^T | Lat_l^T], the dx
    // rows gated into dpre_{l-1}, the dlat rows added into the scratch;
    // d(emb) from dpre_l at the latent layers
    for (int l = last - 1; l >= 0; --l) {
      const PLayer& L = T.layers[l];
      const int dx_rows = l > 0 ? L.in_pad : 0, lat_rows = L.lat ? p.c_pad : 0;
      const int groups = (dx_rows + lat_rows) / TC_GROUP;
      if (dx_rows > 0) ch_prefetch(act(T.layers[l - 1]), dx_rows, p.m, first, tid);
      ch_product<Cfg>(acc0, acc1, L.out_pad, groups, slot, p.tiles, plan, s.tc, total, wg, wt, p0,
                      t4);
      slot += L.out_pad / Cfg::kK * groups;
      if (L.x) {
        __syncthreads();
        clk.tick(3);
        ch_demb(buf, L.out_pad, L.x, p.e, p.demb, p.e, 1, !demb_stored, p.m, first,
                s.red, tid);
        demb_stored = true;
        clk.tick(4);
      }
      __syncthreads();  // every warp is done reading dpre_l
      clk.tick(3);
      ch_store_groups(acc0, acc1, groups, buf, wg, p0, t4);
      __syncthreads();
      clk.tick(5);
      if (dx_rows > 0) {
        const PLayer& P = T.layers[l - 1];
        ch_gate(buf, dx_rows, act(P), P.dropout ? scale : 1.f, P.dpre, p.m, first, tid,
                P.dpre16);
      }
      clk.tick(2);
      if (lat_rows > 0) {
        ch_accumulate(buf, dx_rows, lat_rows, p.dlatent, !dlat_stored, p.m, first, tid);
        dlat_stored = true;
      }
      __syncthreads();
      clk.tick(6);
    }
  }

  // the sampling's gradients (CH_PROBE 8 leaves them out).  dlat
  // transposed to [TC_P][c_pad + 1] at the buffer's end (rounded to bf16 in
  // bf16), so that a warp reading one point's channels hits 32 banks; the
  // tap table after it.  The band's scratch and window start at the ring.
  if (CH_PROBE & 8) return;
  const int ld = p.c_pad + 1;
  float* dlt = buf + CH_ROWS * TC_P - tap_stage_floats(p.c_pad);
  float* tw = dlt + (TC_P * ld + 3) / 4 * 4;           // [TC_P][16]
  int* trc = reinterpret_cast<int*>(tw + 16 * TC_P);  // [TC_P][8]
  int* flag = trc + 8 * TC_P;
  int* scn = flag + TC_P;
  tile_taps(p, first, tid, tw, trc, flag, scn);
  for (int i = tid; i < p.c_pad * TC_P; i += TC_THREADS) {
    const int c = i / TC_P, q = i % TC_P;
    const float d = first + q < p.m ? p.dlatent[(size_t)c * p.m + first + q] : 0.f;
    dlt[q * ld + c] = kBf16 ? tc_round_bf16(d) : d;
  }
  __syncthreads();
  int* seg = reinterpret_cast<int*>(s.tc.ring);
  if (p.band) {
    tc_fence_proxy_async();  // the ring's tiles were the async proxy's
    band_bounds(p, first, tid, flag, scn, seg);
  }

  // the taps: one warp a point, lanes over channels; d(table) with per-tap
  // atomics where the point's segment does not take the band's window
  const int warp = tid >> 5;
  const size_t hw = (size_t)p.hf * p.wf;
  for (int q = warp; q < TC_P; q += TC_THREADS / 32) {
    const int row = first + q;
    if (row >= p.m) continue;
    float tdx = 0.f, tdy = 0.f;
    const bool scatter = !p.band || !seg[3 * TC_P + scn[q] - scn[0]];
    if (flag[q]) {
      const float* wq = tw + q * 16;
      const size_t base = (size_t)scn[q] * hw;
      for (int i = 0; i < 4; ++i) {
        const int r = trc[q * 8 + i];
        if (r < 0) continue;
        for (int j = 0; j < 4; ++j) {
          const int col = trc[q * 8 + 4 + j];
          if (col < 0) continue;
          const size_t off = (base + r + col) * p.c;
          const float wgt = kBf16 ? tc_round_bf16(wq[i] * wq[4 + j]) : wq[i] * wq[4 + j];
          float part = 0.f;
#pragma unroll 8
          for (int ch = lane; ch < p.c; ch += 32) {
            const float d = dlt[q * ld + ch];
            part = fmaf(kBf16 ? tab_ld(p.table16 + off + ch) : __ldg(p.table + off + ch), d, part);
            if (scatter) atomicAdd(p.dtable + off + ch, wgt * d);
          }
          tdx = fmaf(wq[i] * wq[12 + j], part, tdx);
          tdy = fmaf(wq[8 + i] * wq[4 + j], part, tdy);
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      tdx += __shfl_down_sync(0xffffffffu, tdx, off);
      tdy += __shfl_down_sync(0xffffffffu, tdy, off);
    }
    if (lane == 0) {
      p.dxp[row] = tdx;
      p.dyp[row] = tdy;
    }
  }

  if (p.band) band_window<kBf16>(p, first, tid, tw, trc, flag, scn, dlt, ld, seg, s.tc.ring);

  // the mean row: points outside the image, summed per scene over the tile
  for (int ch = tid; ch < p.c; ch += TC_THREADS) {
    float sum = 0.f;
    int sc = -1;
    for (int q = 0; q < TC_P; ++q) {
      if (first + q >= p.m || flag[q]) continue;
      if (scn[q] != sc) {
        if (sc >= 0) atomicAdd(p.dmean + (size_t)sc * p.c + ch, sum);
        sum = 0.f;
        sc = scn[q];
      }
      sum += dlt[q * ld + ch];
    }
    if (sc >= 0) atomicAdd(p.dmean + (size_t)sc * p.c + ch, sum);
  }
  if (CH_PROBE & 32) {
    __syncthreads();
    clk.tick(7);
    clk.flush(tid);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

#define HEAD 34
#define PER_TRUNK 4
#define PER_LAYER 15

// desc (int64): [n_trunks, e, m, nps, n_scenes, c, c_pad, hf, wf, emb, table,
// mean, xp, yp, mask, lat, y, dy, demb, dtable, dmean, dxp, dyp, dx_last,
// xl_w, dlatent, tiles, tiles_len, fwd, fwd_len, table16, emb16, band,
// tile_fit, then per trunk: n_layers, n_out, row_off, layer_off, then per
// layer: w, wt, lat, x, b, act, dpre, dw, dlat, dx, db, in_pad, out_pad,
// dropout, dpre16].  band (0 = none) and tile_fit (int32 per tile, or 0)
// only in a backward.
// Pointers are device addresses, 0 = absent; wt only on the final layer;
// table16 and emb16 only in bf16, where they are required, dpre16 only in a
// bf16 backward, where it is.  dlatent (c_pad, M) is the backward's scratch;
// the tiles (the backward's) run trunk by trunk from the last hidden layer
// down, each layer's tile_weights([W^T | Lat^T]) of depth out_pad (W^T where
// l > 0, Lat^T where it reads the latent); the forward's (fwd) trunk by trunk
// in layer order, each hidden layer's tile_weights([W; Lat]) of depth in_pad
// + c_pad (W where l > 0, Lat where it reads the latent); split TF32 halves
// in float32, bf16 tiles in bf16.
static int parse(const long long* desc, int len, PPlan* p, bool backward, bool bf16) {
  if (len < HEAD) return -1;
  p->n_trunks = (int)desc[0];
  p->e = (int)desc[1];
  p->m = (int)desc[2];
  p->nps = (int)desc[3];
  p->n_scenes = (int)desc[4];
  p->c = (int)desc[5];
  p->c_pad = (int)desc[6];
  p->hf = (int)desc[7];
  p->wf = (int)desc[8];
  p->emb = (const float*)desc[9];
  p->table = (const float*)desc[10];
  p->mean = (const float*)desc[11];
  p->xp = (const float*)desc[12];
  p->yp = (const float*)desc[13];
  p->mask = (const float*)desc[14];
  p->lat = (float*)desc[15];
  p->y = (float*)desc[16];
  p->dy = (const float*)desc[17];
  p->demb = (float*)desc[18];
  p->dtable = (float*)desc[19];
  p->dmean = (float*)desc[20];
  p->dxp = (float*)desc[21];
  p->dyp = (float*)desc[22];
  p->dx_last = (const float*)desc[23];
  p->xl_w = (int)desc[24];
  p->dlatent = (float*)desc[25];
  p->tiles = (const float*)desc[26];
  p->tiles_len = desc[27];
  p->fwd = (const float*)desc[28];
  p->fwd_len = desc[29];
  p->table16 = (const __nv_bfloat16*)desc[30];
  p->emb16 = (const __nv_bfloat16*)desc[31];
  p->band = (int)desc[32];
  p->tile_fit = (int*)desc[33];
  if (bf16 && (!p->table16 || !p->emb16)) return -1;
  if (p->band < 0 || p->band > p->hf || ((p->band || p->tile_fit) && !backward)) return -1;
  if (p->n_trunks < 1 || p->n_trunks > MAX_TRUNKS || p->e < 1 || p->e > EMB_MAX) return -1;
  if (p->m <= 0 || p->m % 4 || p->nps <= 0 || p->m % p->nps || p->m / p->nps != p->n_scenes)
    return -1;
  if (p->c < 1 || p->c_pad < p->c || p->c_pad % TC_GROUP || p->hf < 1 || p->wf < 1) return -1;
  if (!p->emb || !p->table || !p->mean || !p->xp || !p->yp || !p->mask || !p->lat || !p->y)
    return -1;
  if (backward && (!p->dy || !p->demb || !p->dtable || !p->dmean || !p->dxp || !p->dyp
                   || !p->dlatent)) return -1;
  int pos = HEAD;
  for (int t = 0; t < p->n_trunks; ++t) {
    if (pos + PER_TRUNK > len) return -1;
    PTrunk& T = p->trunks[t];
    T.n_layers = (int)desc[pos];
    T.n_out = (int)desc[pos + 1];
    T.row_off = (int)desc[pos + 2];
    T.layer_off = (int)desc[pos + 3];
    pos += PER_TRUNK;
    if (T.n_layers < 2 || T.n_layers > MAX_LAYERS || T.n_out < 1 || T.n_out > MAX_OUT) return -1;
    if (T.row_off < 0 || T.layer_off < 0 || pos + PER_LAYER * T.n_layers > len) return -1;
    for (int l = 0; l < T.n_layers; ++l, pos += PER_LAYER) {
      const long long* d = desc + pos;
      PLayer& L = T.layers[l];
      L.w = (const float*)d[0]; L.wt = (const float*)d[1]; L.lat = (const float*)d[2];
      L.x = (const float*)d[3]; L.b = (const float*)d[4];
      L.act = (float*)d[5]; L.dpre = (float*)d[6];
      L.dw = (float*)d[7]; L.dlat = (float*)d[8]; L.dx = (float*)d[9]; L.db = (float*)d[10];
      L.in_pad = (int)d[11]; L.out_pad = (int)d[12]; L.dropout = (int)d[13];
      L.dpre16 = (__nv_bfloat16*)d[14];
      const bool hidden = l < T.n_layers - 1;
      if (!L.b) return -1;
      if (l == 0 ? (L.w || !L.lat || L.in_pad != 0)
                 : (!L.w || L.in_pad != T.layers[l - 1].out_pad)) return -1;
      if (!hidden && !L.wt) return -1;
      // the latent and the embedding enter together, at layer 0 and the
      // latent_in layers
      if (!L.lat != !L.x) return -1;
      if (hidden) {
        if (L.out_pad < TC_GROUP || L.out_pad % TC_GROUP || !L.act) return -1;
      } else if (L.out_pad != T.n_out || L.dropout) {  // a latent_in final layer: lat, x
        return -1;
      }
      if (backward && (!L.dpre || !L.db || (L.w && !L.dw) || (L.lat && (!L.dlat || !L.dx))))
        return -1;
      if (backward && bf16 && !L.dpre16) return -1;
    }
  }
  if (pos != len) return -1;
  if (p->dx_last) {
    const PTrunk& T = p->trunks[0];
    if (!backward || p->xl_w < 1 || p->xl_w > T.layers[T.n_layers - 1].in_pad) return -1;
  }
  return 0;
}

// The forward's tiles, trunk by trunk in layer order; -1 where a layer is
// outside the forward (train_fwd_tc.cuh) or the stream's length disagrees.
// *rows: the buffer rows the widest layer needs (its depth or its width).
template <class Cfg>
static int fwd_tiles(const PPlan& p, int* rows) {
  int total = 0;
  *rows = p.c_pad;
  for (int t = 0; t < p.n_trunks; ++t) {
    const PTrunk& T = p.trunks[t];
    for (int l = 0; l < T.n_layers - 1; ++l) {
      const PLayer& L = T.layers[l];
      const int depth = (L.w ? L.in_pad : 0) + (L.lat ? p.c_pad : 0);
      const int n = fw_layer_tiles<Cfg>(depth, L.out_pad);
      if (n < 0) return -1;
      total += n;
      if (depth > *rows) *rows = depth;
      if (L.out_pad > *rows) *rows = L.out_pad;
    }
  }
  if (*rows > TC_MAX_OUT || p.fwd_len != (long long)total * Cfg::kTile || !p.fwd) return -1;
  return total;
}

template <class Cfg, class R>
static int launch_fwd(const PPlan& p, unsigned seed, unsigned thresh, float scale,
                      cudaStream_t stream) {
  int rows;
  const int total = fwd_tiles<Cfg>(p, &rows);
  if (total < 0) return -1;
  const size_t smem = tc_smem_bytes<Cfg>(rows) + FW_TAP_BYTES;
  if (smem > 232448) return -1;
  cudaError_t err = cudaFuncSetAttribute(pixel_train_fwd_tc_kernel<Cfg, R>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((p.m + TC_P - 1) / TC_P);
  pixel_train_fwd_tc_kernel<Cfg, R><<<blocks, TC_THREADS, smem, stream>>>(p, rows, total, seed,
                                                                          thresh, scale);
  return (int)cudaGetLastError();
}

// bf16: the TcBf16 kernel with bf16 residuals, else split TF32 with float32.
extern "C" int pixel_train_fwd(const long long* desc, int len, unsigned seed, unsigned thresh,
                               float scale, int bf16, void* stream) {
  PPlan p;
  if (parse(desc, len, &p, false, bf16)) return -1;
  return bf16 ? launch_fwd<TcBf16, __nv_bfloat16>(p, seed, thresh, scale, (cudaStream_t)stream)
              : launch_fwd<TcF32, float>(p, seed, thresh, scale, (cudaStream_t)stream);
}

// The chain's tiles of trunk t: each hidden layer's, from the last down;
// -1 where a layer is outside the chain (chain_tc.cuh).
template <class Cfg>
static int chain_tiles(const PPlan& p, const PTrunk& T) {
  int total = 0;
  for (int l = T.n_layers - 2; l >= 0; --l) {
    const PLayer& L = T.layers[l];
    const int n = ch_layer_tiles<Cfg>(L.out_pad, (l > 0 ? L.in_pad : 0) + (L.lat ? p.c_pad : 0));
    if (n < 0) return -1;
    total += n;
  }
  return total;
}

template <class Cfg, class R>
static int launch_bwd(const PPlan& p, float scale, cudaStream_t s) {
  int split = 0, total = 0;
  for (int t = 0; t < p.n_trunks; ++t) {
    const int n = chain_tiles<Cfg>(p, p.trunks[t]);
    if (n < 0) return -1;
    if (t == 0) split = n;
    total += n;
  }
  if (p.n_trunks == 1) split = total;
  if (p.tiles_len != (long long)total * Cfg::kTile || !p.tiles) return -1;
  // the tap stage's transposed dlat and tap table fit the buffer, and the
  // band's window the room before them
  if (tap_stage_floats(p.c_pad) > CH_ROWS * TC_P) return -1;
  if (p.band > band_rows_max<Cfg>(p.wf, p.c_pad)) return -1;
  const size_t smem = ch_smem_bytes<Cfg>();
  cudaError_t err = cudaFuncSetAttribute(pixel_train_bwd_chain_tc_kernel<Cfg, R>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((p.m + TC_P - 1) / TC_P);
  pixel_train_bwd_chain_tc_kernel<Cfg, R><<<blocks, TC_THREADS, smem, s>>>(p, total, split,
                                                                           scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  constexpr bool kBf16 = Cfg::kBf16;
  static_assert(kBf16 == (sizeof(R) == 2), "bf16 arithmetic keeps bf16 residuals");
  // bf16: every reduction after the first overlaps the kernel before it
  // (launch_wgrad_bf16); the first reads the chain's dpre
  int reductions = 0;
  for (int t = 0; t < p.n_trunks; ++t) {
    const PTrunk& T = p.trunks[t];
    for (int l = 0; l < T.n_layers; ++l) {
      const PLayer& L = T.layers[l];
      // bf16: the bf16 residuals, latent and embedding copy against the
      // rounded dpre; float32: the float32 ones against dpre
      using B16 = const __nv_bfloat16*;
      int rc = 0;
      if (L.w) {
        const float* a = T.layers[l - 1].act;
        rc = kBf16 ? launch_wgrad(reinterpret_cast<B16>(a), L.dpre16, L.dw, L.in_pad, L.out_pad,
                                  p.m, s, reductions++ > 0)
                   : launch_wgrad(a, L.dpre, L.dw, L.in_pad, L.out_pad, p.m, s);
        if (rc) return rc;
      }
      if (L.lat) {
        rc = kBf16 ? launch_wgrad(reinterpret_cast<B16>(p.lat), L.dpre16, L.dlat, p.c_pad,
                                  L.out_pad, p.m, s, reductions++ > 0)
                   : launch_wgrad(p.lat, L.dpre, L.dlat, p.c_pad, L.out_pad, p.m, s);
        if (rc) return rc;
        rc = kBf16 ? launch_wgrad(p.emb16, L.dpre16, L.dx, p.e, L.out_pad, p.m, s,
                                  reductions++ > 0)
                   : launch_wgrad(p.emb, L.dpre, L.dx, p.e, L.out_pad, p.m, s);
        if (rc) return rc;
      }
      if ((rc = launch_colsum(L.dpre, L.db, L.out_pad, p.m, 4096, 0, s))) return rc;
    }
  }
  return 0;
}

// The largest band the backward's tap stage holds (band_rows_max).
extern "C" int pixel_train_band_rows_max(int wf, int c_pad, int bf16) {
  return bf16 ? band_rows_max<TcBf16>(wf, c_pad) : band_rows_max<TcF32>(wf, c_pad);
}

// d(table), d(mean), every dw / dlat / dx and db must hold zeros on entry.
extern "C" int pixel_train_bwd(const long long* desc, int len, float scale, int bf16,
                               void* stream) {
  PPlan p;
  if (parse(desc, len, &p, true, bf16)) return -1;
  return bf16 ? launch_bwd<TcBf16, __nv_bfloat16>(p, scale, (cudaStream_t)stream)
              : launch_bwd<TcF32, float>(p, scale, (cudaStream_t)stream);
}
