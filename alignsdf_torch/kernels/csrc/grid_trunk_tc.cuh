// The grid decoders' shared trunk on Hopper's tensor cores (kernels K1, K3
// and K6; K2's, K4's and K5's train forwards and backward chains reuse its
// ring and k-step loop, train_fwd_tc.cuh and chain_tc.cuh).  A block of
// TC_THREADS threads owns a tile of TC_P = 64 points.  Their activations
// stay in one shared-memory buffer as [feature][point] and each hidden layer
// updates it in place: its two warpgroups hold the layer's whole output for
// the 64 points in registers (wgmma accumulators), and after a barrier write
// it back over the layer's input.
//
// Arithmetic: split TF32 on the tensor cores, accumulated in float32.  Each
// operand x is split as big = tf32(x), small = tf32(x - big) (round to
// nearest, ties away: tc_split), and each k step runs three products,
// big_a big_w + small_a big_w + big_a small_w (small_a small_w, ~2^-22 of
// the product, is dropped).  That keeps float32 accuracy, where one TF32
// pass errs by ~1e-3 at the flagship's widths, over the kernels' 1e-4
// contract (tests/test_torch_split_tf32.py emulates both).
//
// The product is wgmma.m64n128k8.f32.tf32.tf32: M = the block's 64 points,
// with A (the activations) loaded from shared memory into registers, where
// the split costs three instructions an element; N = 128 output features,
// with B (the weights) in shared memory, K-major, as 8 x 16-byte core
// matrices without swizzle; K = 8.  Warpgroup w takes output groups w and
// w + 2 of a layer (128 features each), so a layer is at most 512 wide.
//
// Weights: split once, when the plan is packed.  The plan stores each layer
// as tiles of 128 outputs x 8 k, big then small, each half the exact
// shared-memory image of one B operand, in the order the warpgroups read
// them (k step major, then output group), each layer's followed by its
// epilogue tile (bias and xyz weights), so that a trunk's tiles are one
// contiguous stream.  They stream by 1-D bulk copy (cp.async.bulk ...
// mbarrier::complete_tx) into a ring of TC_SLOTS tiles, each slot with a
// `full` mbarrier; thread 0 fills the ring, and a warpgroup refills the
// slots of its previous k step with the tiles TC_SLOTS further on right
// after it has issued the current step's products, so the refill overlaps
// them.  No slot needs an `empty` barrier and no thread is set aside as a
// producer; the warpgroup's barrier that closes each k step is what lets a
// slot be refilled (per-warp `empty` barriers instead let the warps drift
// and measured slower).
//
// Per-point inputs (K3's sampled latent, K6's materialized input row x0)
// have no tile of their own: before a layer that reads them the kernel's
// `fill` writes them into the activation rows just above the layer's
// activation input, and the layer runs one product over [activation;
// input] against the layer's packed [W; W_in] tiles.  Where the input is
// wider than the rows left above the activation (K6's 320-column x0 above
// a 256-row activation in a 544-row buffer), it is staged in chunks: fill,
// run the chunk's k steps, barrier, fill the next; the accumulators stay in
// registers across the chunks and the tiles stream on in order, so the
// ring does not change.  A final layer that reads the input (K6's fin_lat)
// restages it over the dead activation rows after the final rows and runs
// the SDF rows a second time.
//
// What bounds it, as measured on an H100 (PERF.md): the chain each
// warpgroup runs per k step around its products (moving the refills off it,
// the same bytes, cut K1 by a fifth; a twelfth slot changed nothing), the
// epilogues and K3's gathers, during which the tensor cores idle, and now
// perhaps L2: K1 streams ~277 GB of tiles a 128^3 pass, ~5.4 TB/s.
// Splitting the weights on the card instead halves the bytes read from L2
// but puts the split (12 KB of shared memory traffic a tile, beside the
// products' 12 KB of B reads), the proxy fence that makes it visible to
// wgmma and a barrier on that chain; a converter warpgroup doing it for
// both left the products waiting on its pipeline.
//
// Shared memory (bytes, rows = the activation buffer's, 512 at the K1
// flagship, 544 at most): the ring TC_SLOTS x 8 KB, activations rows x 64 x
// 4, xyz, two SDF rows' accumulators, 256 floats of scratch and the
// barriers: 223,576 at rows = 512, 231,768 at 544 (K3 adds its 4,352-byte
// tap table).  Registers: 128 accumulators a thread (two groups of 64), 8
// for the split A fragment; 256 threads a block (a 288-thread block with a
// producer warp got 168 registers and spilled), one block an SM.
//
// The final rows (2 SDF rows, and the classifier's on the first trunk) stay
// float32 dot products on the CUDA cores; rows 0-1 take tanh after all
// trunks have added theirs, the class rows go straight to the output.
//
// bf16 (TcBf16, a bf16 plan of K3, the JAX package's grid kernels with
// dtype=bfloat16, decoder_kernel.py:1040; K1's and K6's bf16 plans run
// grid_trunk_bf16_tc.cuh instead): the same
// ring, k-step loop and epilogues as a template parameter.  A k step is one
// wgmma.m64n128k16.f32.bf16.bf16 (wgmma_bf16.cuh) over 16 k; A is packed
// into bf16 pairs from the activation buffer, which holds bf16-rounded
// values, so the packing is exact; B is a 128 x 16 bf16 tile of 4 KB, a
// quarter of split TF32's bytes a k.  The ring's 88 KB hold 22 such tiles;
// an epilogue tile (float32: bias and the bf16-rounded xyz weights) takes
// two of them, not always adjacent in the ring.  The epilogue rounds each
// ReLU output to bf16 (tc_round_bf16).  The final rows' weights hold
// bf16-rounded values in float32, so their products with the bf16
// activations are exact and their sums float32, as JAX's bf16 dot with
// float32 accumulation.  The activations' swizzle stays tc_swz: a bf16
// fragment's loads meet 2-way bank conflicts there.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_bf16.cuh"
#include "wgmma_tf32.cuh"

#define TC_P 64            // points per block: wgmma's M
#define TC_THREADS 256     // two warpgroups
#define TC_GROUP 128       // output features of a weight tile: wgmma's N
#define TC_K 8             // k depth of a weight tile: wgmma's K for tf32
#define TC_TILE 1024       // floats in a tile half (TC_GROUP x TC_K)
#define TC_SLOTS 11        // ring depth, in tiles (big and small)
#define TC_MAX_OUT 512     // two groups a warpgroup
#define TC_MAX_TRUNKS 2
#define TC_MAX_HIDDEN 8
#define TC_SDF_ROWS 2      // rows 0-1 take tanh
#define TC_MAX_ROWS 128    // 2 SDF rows + 126 classes

// The trunk's arithmetic: a k step's depth, a ring slot (floats), the ring's
// slots and the slots an epilogue tile takes.
struct TcF32 {   // split TF32: a tile = 128 outputs x 8 k, big then small (8 KB)
  static constexpr bool kBf16 = false;
  static constexpr int kK = TC_K, kTile = 2 * TC_TILE, kSlots = TC_SLOTS, kEpi = 1;
};
struct TcBf16 {  // bf16: a tile = 128 outputs x 16 k (4 KB)
  static constexpr bool kBf16 = true;
  static constexpr int kK = 16, kTile = TC_TILE, kSlots = 2 * TC_SLOTS, kEpi = 2;
};

// Offsets into prm (floats; -1 = none).  w: the tiles of the layer's
// activation rows (in_pad of them); lat (K3, K6): the tiles of its per-point
// input rows (lat_pad), which follow w's when both are present.  b: the
// layer's epilogue tile, the bias at 0 and the xyz weights' rows at
// TC_MAX_OUT, 2 TC_MAX_OUT and 3 TC_MAX_OUT; x = b + TC_MAX_OUT if it has xyz
// weights.  fin_lat (K6): the final layer's (n_rows, lat_pad) weights on the
// input rows, of which the kernel reads rows 0-1 (the class rows read no
// input); tc_take_plan sets it to -1, K6's launcher after it.
struct TcLayer { int w, x, lat, b, in_pad, out_pad; };
struct TcTrunk {
  int n_hidden, fin, fin_xyz, fin_lat, last_pad;
  TcLayer layers[TC_MAX_HIDDEN];
};
// stream[t]: the offset of trunk t's tile stream; split: trunk 1's first
// tile (both set by tc_take_plan)
struct TcPlan {
  int n_trunks, fin_b, rows, n_rows, lat_pad, stream[TC_MAX_TRUNKS], split;
  TcTrunk trunks[TC_MAX_TRUNKS];
};

struct TcShared {
  float* ring;      // [TC_SLOTS][2][TC_TILE]: tiles, big then small
  float* act;       // [rows][TC_P], swizzled (tc_swz)
  float* xyz;       // [3][TC_P]
  float* oacc;      // [TC_SDF_ROWS][TC_P]: the SDF rows summed over trunks
  float* red;       // [TC_THREADS]: the final rows' scratch
  uint64_t* full;   // [TC_SLOTS]: a tile has landed
};

template <class Cfg = TcF32>
__host__ __device__ inline size_t tc_smem_bytes(int rows) {
  return sizeof(float) * ((size_t)Cfg::kSlots * Cfg::kTile + (size_t)rows * TC_P + 3 * TC_P
                          + TC_SDF_ROWS * TC_P + TC_THREADS)
         + sizeof(uint64_t) * Cfg::kSlots;
}

template <class Cfg = TcF32>
__device__ __forceinline__ TcShared tc_shared(float* base, int rows) {
  TcShared s;
  s.ring = base;
  s.act = s.ring + Cfg::kSlots * Cfg::kTile;
  s.xyz = s.act + rows * TC_P;
  s.oacc = s.xyz + 3 * TC_P;
  s.red = s.oacc + TC_SDF_ROWS * TC_P;
  s.full = reinterpret_cast<uint64_t*>(s.red + TC_THREADS);
  return s;
}

// Element (k, p) of the activation buffer.  The XOR spreads the A-fragment
// loads (k = k0 + lane % 4, p = 16 warp + lane / 4) over all 32 banks.
__device__ __forceinline__ int tc_swz(int k, int p) { return k * TC_P + (p ^ ((k & 3) << 3)); }

// ---- barriers and copies --------------------------------------------------

// bytes (a multiple of 16) from global src to shared dst, counted on bar
__device__ __forceinline__ void tc_bulk_load(float* dst, const float* src, int bytes,
                                             uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
               "[%0], [%1], %2, [%3];"
               :: "r"(tc_smem(dst)), "l"(src), "r"(bytes), "r"(tc_smem(bar)) : "memory");
}

// named barrier 1 + w: warpgroup w alone (0 is __syncthreads)
__device__ __forceinline__ void tc_warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;" :: "r"(1 + wg) : "memory");
}

// ---- the trunk ------------------------------------------------------------

// Product depth of a layer: its activation rows, then its latent rows.
__host__ __device__ inline int tc_depth(const TcLayer& L, int lat_pad) {
  return (L.w >= 0 ? L.in_pad : 0) + (L.lat >= 0 ? lat_pad : 0);
}

// Tile j (in the order the warpgroups read them; Cfg::kTile floats each)
// into its slot, j % kSlots, counted on the slot's barrier; nothing past the
// last tile.
template <class Cfg = TcF32>
__device__ __forceinline__ void tc_fill(const float* prm, const TcPlan& plan, const TcShared& s,
                                        int j, int total) {
  if (j >= total) return;
  const int pos = j % Cfg::kSlots;
  const float* src = prm + (j < plan.split ? plan.stream[0] + (size_t)j * Cfg::kTile
                                           : plan.stream[1] + (size_t)(j - plan.split) * Cfg::kTile);
  tc_mbar_expect_tx(&s.full[pos], Cfg::kTile * 4);
  tc_bulk_load(s.ring + pos * Cfg::kTile, src, Cfg::kTile * 4, &s.full[pos]);
}

// Tiles in layer L: its weight tiles, then its epilogue tile.
template <class Cfg = TcF32>
__host__ __device__ inline int tc_tiles(const TcLayer& L, int lat_pad) {
  return tc_depth(L, lat_pad) / Cfg::kK * (L.out_pad / TC_GROUP) + Cfg::kEpi;
}

template <class Cfg = TcF32>
__host__ __device__ inline int tc_total_tiles(const TcPlan& plan) {
  int total = 0;
  for (int t = 0; t < plan.n_trunks; ++t)
    for (int l = 0; l < plan.trunks[t].n_hidden; ++l)
      total += tc_tiles<Cfg>(plan.trunks[t].layers[l], plan.lat_pad);
  return total;
}

// Thread 0, before the block's first barrier: the ring's barriers and its
// first kSlots tiles.
template <class Cfg = TcF32>
__device__ __forceinline__ void tc_init(const float* prm, const TcPlan& plan, const TcShared& s) {
  for (int i = 0; i < Cfg::kSlots; ++i) tc_mbar_init(&s.full[i], 1);  // the filler's expect_tx
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  const int total = tc_total_tiles<Cfg>(plan);
  for (int j = 0; j < Cfg::kSlots; ++j) tc_fill<Cfg>(prm, plan, s, j, total);
}

// A layer's product for warpgroup wg, which owns NG of its output groups
// (wg, then wg + 2), over `steps` k steps from tile slot0, reading
// activation rows row0 on; `acc_on`: add to the accumulators from the first
// step (a later chunk of the layer's input).  Each step: the
// A fragment split (TcF32) or packed (TcBf16) in registers, a wait for the
// warpgroup's tiles, then the NG groups' products (3 each in split TF32, 1
// in bf16) issued together (every operand defined before the wgmma
// fence, so ptxas need not serialize them); while they run, one thread
// refills the previous step's slots, which every warp of the warpgroup was
// past at the step's closing barrier.
template <int NG, class Cfg = TcF32>
__device__ __forceinline__ void tc_steps(float (&acc0)[64], float (&acc1)[64], int steps,
                                         int row0, bool acc_on, int groups, int slot0,
                                         const float* __restrict__ prm, const TcPlan& plan,
                                         const TcShared& s, int total, int wg, int wt, int p0,
                                         int t4) {
  constexpr int SL = Cfg::kSlots;
  for (int st = 0; st < steps; ++st) {
    uint32_t ab[4], as[4];
    if constexpr (Cfg::kBf16) {
      const int k = row0 + st * Cfg::kK + 2 * t4;
      ab[0] = tc_pack_bf16(s.act[tc_swz(k, p0)], s.act[tc_swz(k + 1, p0)]);
      ab[1] = tc_pack_bf16(s.act[tc_swz(k, p0 + 8)], s.act[tc_swz(k + 1, p0 + 8)]);
      ab[2] = tc_pack_bf16(s.act[tc_swz(k + 8, p0)], s.act[tc_swz(k + 9, p0)]);
      ab[3] = tc_pack_bf16(s.act[tc_swz(k + 8, p0 + 8)], s.act[tc_swz(k + 9, p0 + 8)]);
    } else {
      const int k = row0 + st * TC_K + t4;
      tc_split(s.act[tc_swz(k, p0)], ab[0], as[0]);
      tc_split(s.act[tc_swz(k, p0 + 8)], ab[1], as[1]);
      tc_split(s.act[tc_swz(k + 4, p0)], ab[2], as[2]);
      tc_split(s.act[tc_swz(k + 4, p0 + 8)], ab[3], as[3]);
    }
    const int sl = slot0 + st * groups + wg;
    const int pos0 = sl % SL, pos1 = (sl + 2) % SL;
    tc_mbar_wait(&s.full[pos0], (sl / SL) & 1);
    if (NG > 1) tc_mbar_wait(&s.full[pos1], ((sl + 2) / SL) & 1);
    const float* t0 = s.ring + pos0 * Cfg::kTile;
    const float* t1 = s.ring + pos1 * Cfg::kTile;
    if constexpr (Cfg::kBf16) {
      const uint64_t d0 = tc_desc(t0), d1 = tc_desc(t1);
      const int scale_d = st > 0 || acc_on;
      tc_fence_acc(acc0);
      if (NG > 1) tc_fence_acc(acc1);
      tc_wgmma_fence();
      tc_wgmma_bf16(acc0, ab, d0, scale_d);
      if (NG > 1) tc_wgmma_bf16(acc1, ab, d1, scale_d);
    } else {
      const uint64_t big0 = tc_desc(t0), small0 = tc_desc(t0 + TC_TILE);
      const uint64_t big1 = tc_desc(t1), small1 = tc_desc(t1 + TC_TILE);
      const int scale_d = st > 0 || acc_on;
      tc_fence_acc(acc0);
      if (NG > 1) tc_fence_acc(acc1);
      tc_wgmma_fence();
      tc_wgmma(acc0, ab, big0, scale_d);
      tc_wgmma(acc0, as, big0, 1);
      tc_wgmma(acc0, ab, small0, 1);
      if (NG > 1) {
        tc_wgmma(acc1, ab, big1, scale_d);
        tc_wgmma(acc1, as, big1, 1);
        tc_wgmma(acc1, ab, small1, 1);
      }
    }
    tc_wgmma_commit();
    if (wt == 0 && st > 0) {
      tc_fill<Cfg>(prm, plan, s, sl - groups + SL, total);
      if (NG > 1) tc_fill<Cfg>(prm, plan, s, sl - groups + 2 + SL, total);
    }
    tc_wgmma_wait();
    tc_fence_acc(acc0);
    if (NG > 1) tc_fence_acc(acc1);
    tc_warpgroup_sync(wg);
  }
  if (wt == 0 && steps > 0) {  // the last step's slots
    const int sl = slot0 + (steps - 1) * groups + wg;
    tc_fill<Cfg>(prm, plan, s, sl + SL, total);
    if (NG > 1) tc_fill<Cfg>(prm, plan, s, sl + 2 + SL, total);
  }
}

// out[o][p] = relu(acc + b[o] + X[:, o] . xyz[p]) for this thread's 64
// accumulators of group j (acc is 0 for a layer without a product), rounded
// to bf16 with `bf16`; b and X from the layer's epilogue tile in the ring:
// its rows 0-1 (b, X's x row) at `epi`, rows 2-3 (X's y and z rows) at
// `epi_hi` (epi + 2 TC_MAX_OUT, or a bf16 ring's next slot).
__device__ __forceinline__ void tc_epilogue(const float (&acc)[64], bool has, int j,
                                            const float* epi, const float* epi_hi, bool has_x,
                                            float* act, const float* xyz, int p0, int t4,
                                            bool bf16 = false) {
  const float xa = xyz[p0], ya = xyz[TC_P + p0], za = xyz[2 * TC_P + p0];
  const float xb = xyz[p0 + 8], yb = xyz[TC_P + p0 + 8], zb = xyz[2 * TC_P + p0 + 8];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int o = j * TC_GROUP + 8 * i + 2 * t4;
    const float2 b = *reinterpret_cast<const float2*>(epi + o);
    float v0 = b.x, v1 = b.y, v2 = b.x, v3 = b.y;
    if (has) {
      v0 += acc[4 * i];
      v1 += acc[4 * i + 1];
      v2 += acc[4 * i + 2];
      v3 += acc[4 * i + 3];
    }
    if (has_x) {
      const float2 wx = *reinterpret_cast<const float2*>(epi + TC_MAX_OUT + o);
      const float2 wy = *reinterpret_cast<const float2*>(epi_hi + o);
      const float2 wz = *reinterpret_cast<const float2*>(epi_hi + TC_MAX_OUT + o);
      v0 += wx.x * xa + wy.x * ya + wz.x * za;
      v1 += wx.y * xa + wy.y * ya + wz.y * za;
      v2 += wx.x * xb + wy.x * yb + wz.x * zb;
      v3 += wx.y * xb + wy.y * yb + wz.y * zb;
    }
    v0 = fmaxf(v0, 0.f);
    v1 = fmaxf(v1, 0.f);
    v2 = fmaxf(v2, 0.f);
    v3 = fmaxf(v3, 0.f);
    if (bf16) {
      v0 = tc_round_bf16(v0);
      v1 = tc_round_bf16(v1);
      v2 = tc_round_bf16(v2);
      v3 = tc_round_bf16(v3);
    }
    act[tc_swz(o, p0)] = v0;
    act[tc_swz(o + 1, p0)] = v1;
    act[tc_swz(o, p0 + 8)] = v2;
    act[tc_swz(o + 1, p0 + 8)] = v3;
  }
}

// Rows 0-1 of f (row stride `stride`) over activation rows 0 .. depth - 1
// (a multiple of 8) into red: thread = row, half of k, point.
__device__ __forceinline__ void tc_sdf_partial(const float* __restrict__ f, int stride, int depth,
                                               const TcShared& s, int tid) {
  const int r = tid >> 7, half = (tid >> 6) & 1, p = tid & (TC_P - 1);
  f += r * stride;
  const int k_lo = half * (depth >> 1), k_hi = k_lo + (depth >> 1);
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  for (int k = k_lo; k < k_hi; k += 4) {
    const float4 fw = __ldg(reinterpret_cast<const float4*>(f + k));
    s0 = fmaf(fw.x, s.act[tc_swz(k, p)], s0);
    s1 = fmaf(fw.y, s.act[tc_swz(k + 1, p)], s1);
    s2 = fmaf(fw.z, s.act[tc_swz(k + 2, p)], s2);
    s3 = fmaf(fw.w, s.act[tc_swz(k + 3, p)], s3);
  }
  s.red[tid] = (s0 + s1) + (s2 + s3);
}

// After a barrier: red's two halves (and the xyz term of fin_xyz, if >= 0)
// added into oacc; a barrier follows.
__device__ __forceinline__ void tc_sdf_add(const float* __restrict__ prm, int fin_xyz,
                                           const TcShared& s, int tid) {
  if (tid < TC_SDF_ROWS * TC_P) {
    const int r = tid / TC_P, p = tid % TC_P;
    float v = s.red[r * 2 * TC_P + p] + s.red[r * 2 * TC_P + TC_P + p];
    if (fin_xyz >= 0) {
      const float* fx = prm + fin_xyz + r * 3;
      v += fx[0] * s.xyz[p] + fx[1] * s.xyz[TC_P + p] + fx[2] * s.xyz[2 * TC_P + p];
    }
    s.oacc[tid] += v;
  }
}

// The final rows of trunk T over the last activation: the SDF rows 0-1 are
// added into oacc (tc_sdf_partial, tc_sdf_add); with n_rows > 2 the class
// rows (the first trunk's) go straight to out with their bias (warp = row,
// lane = points lane and lane + 32).
__device__ void tc_final_rows(const float* __restrict__ prm, const TcTrunk& T, int n_rows,
                              int fin_b, const TcShared& s, float* __restrict__ out,
                              long long first, int m, int tid) {
  const int last = T.last_pad;
  tc_sdf_partial(prm + T.fin, last, last, s, tid);
  if (n_rows > TC_SDF_ROWS) {
    const int lane = tid & 31;
    for (int r = TC_SDF_ROWS + (tid >> 5); r < n_rows; r += TC_THREADS / 32) {
      const float* f = prm + T.fin + r * last;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f, c0 = 0.f, c1 = 0.f, c2 = 0.f, c3 = 0.f;
      for (int k = 0; k < last; k += 4) {
        const float4 fw = __ldg(reinterpret_cast<const float4*>(f + k));
        a0 = fmaf(fw.x, s.act[tc_swz(k, lane)], a0);
        a1 = fmaf(fw.y, s.act[tc_swz(k + 1, lane)], a1);
        a2 = fmaf(fw.z, s.act[tc_swz(k + 2, lane)], a2);
        a3 = fmaf(fw.w, s.act[tc_swz(k + 3, lane)], a3);
        c0 = fmaf(fw.x, s.act[tc_swz(k, lane + 32)], c0);
        c1 = fmaf(fw.y, s.act[tc_swz(k + 1, lane + 32)], c1);
        c2 = fmaf(fw.z, s.act[tc_swz(k + 2, lane + 32)], c2);
        c3 = fmaf(fw.w, s.act[tc_swz(k + 3, lane + 32)], c3);
      }
      float va = (a0 + a1) + (a2 + a3), vc = (c0 + c1) + (c2 + c3);
      if (T.fin_xyz >= 0) {
        const float* fx = prm + T.fin_xyz + r * 3;
        va += fx[0] * s.xyz[lane] + fx[1] * s.xyz[TC_P + lane] + fx[2] * s.xyz[2 * TC_P + lane];
        vc += fx[0] * s.xyz[lane + 32] + fx[1] * s.xyz[TC_P + lane + 32]
              + fx[2] * s.xyz[2 * TC_P + lane + 32];
      }
      const float bias = __ldg(prm + fin_b + r);
      if (first + lane < m) out[(size_t)r * m + first + lane] = va + bias;
      if (first + lane + 32 < m) out[(size_t)r * m + first + lane + 32] = vc + bias;
    }
  }
  __syncthreads();
  tc_sdf_add(prm, T.fin_xyz, s, tid);
  __syncthreads();
}

// The block's 256 threads: every trunk's hidden layers, then its final
// rows; at the end rows 0-1 with their bias and tanh.  xyz and oacc (zeroed)
// are ready, and the ring filled (tc_init).  fill(t, row0, c0, count, tid)
// writes trunk t's per-point input columns c0 .. c0 + count - 1 (zeros past
// its width) into activation rows row0 .. row0 + count - 1, before a layer
// with input rows (K3, K6) or a final layer with fin_lat (K6); K1 has none.
// Fill::kChunks: whether the input may need more than one chunk (K6); the
// others take it whole, as their plans' rows provide.  Cfg: the trunk's
// arithmetic (TcF32 or TcBf16).
template <class Cfg, class Fill>
__device__ void tc_consume(const float* __restrict__ prm, const TcPlan& plan, const TcShared& s,
                           const Fill& fill, float* __restrict__ out, long long first, int m,
                           int tid) {
  const int wg = tid >> 7, wt = tid & 127, lane = tid & 31, t4 = lane & 3;
  const int p0 = 16 * (wt >> 5) + (lane >> 2);  // this thread's points: p0, p0 + 8
  float acc0[64], acc1[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0.f;
  const int total = tc_total_tiles<Cfg>(plan);
  int slot = 0;
  for (int t = 0; t < plan.n_trunks; ++t) {
    const TcTrunk& T = plan.trunks[t];
    for (int l = 0; l < T.n_hidden; ++l) {
      const TcLayer& L = T.layers[l];
      const int groups = L.out_pad / TC_GROUP;
      const int mine = (groups > wg) + (groups > wg + 2);  // groups wg and wg + 2
      const int act_rows = L.w >= 0 ? L.in_pad : 0;
      const int in_rows = L.lat >= 0 ? plan.lat_pad : 0;
      int steps = 0, c0 = 0;  // the layer's k steps run, input rows staged so far
      if (!Fill::kChunks) {  // K1, K3: the input rows, if any, fit above the activation
        if (in_rows > 0) {
          fill(t, act_rows, 0, in_rows, tid);
          __syncthreads();
        }
        steps = (act_rows + in_rows) / Cfg::kK;
        if (mine == 2) {
          tc_steps<2, Cfg>(acc0, acc1, steps, 0, false, groups, slot, prm, plan, s, total, wg, wt,
                           p0, t4);
        } else if (mine == 1) {
          tc_steps<1, Cfg>(acc0, acc1, steps, 0, false, groups, slot, prm, plan, s, total, wg, wt,
                           p0, t4);
        }
        c0 = in_rows;
      }
      // K6: the input rows go above the activation rows, in chunks of what
      // the buffer holds there
      const int cap = plan.rows - act_rows;
      while (Fill::kChunks && (c0 < in_rows || steps == 0)) {
        const int count = min(cap, in_rows - c0);  // 0: no input rows
        if (count > 0) {
          if (c0 > 0) __syncthreads();  // every warp is past the previous chunk
          fill(t, act_rows, c0, count, tid);
          __syncthreads();
        }
        const int run = ((c0 == 0 ? act_rows : 0) + count) / Cfg::kK;
        const int row0 = c0 == 0 ? 0 : act_rows;
        const int slot0 = slot + steps * groups;
        if (mine == 2) {
          tc_steps<2, Cfg>(acc0, acc1, run, row0, steps > 0, groups, slot0, prm, plan, s, total,
                           wg, wt, p0, t4);
        } else if (mine == 1) {
          tc_steps<1, Cfg>(acc0, acc1, run, row0, steps > 0, groups, slot0, prm, plan, s, total,
                           wg, wt, p0, t4);
        }
        steps += run;
        c0 += count;
        if (run == 0) break;  // a layer without a product
      }
      slot += steps * groups;  // now the epilogue tile's (kEpi slots)
      constexpr int SL = Cfg::kSlots;
      for (int e = 0; e < Cfg::kEpi; ++e)
        tc_mbar_wait(&s.full[(slot + e) % SL], ((slot + e) / SL) & 1);
      const float* epi = s.ring + (slot % SL) * Cfg::kTile;
      const float* epi_hi = Cfg::kEpi == 1 ? epi + 2 * TC_MAX_OUT
                                           : s.ring + ((slot + 1) % SL) * Cfg::kTile;
      __syncthreads();  // every warp is done reading the layer's input
      if (mine > 0)
        tc_epilogue(acc0, steps > 0, wg, epi, epi_hi, L.x >= 0, s.act, s.xyz, p0, t4, Cfg::kBf16);
      if (mine > 1)
        tc_epilogue(acc1, steps > 0, wg + 2, epi, epi_hi, L.x >= 0, s.act, s.xyz, p0, t4,
                    Cfg::kBf16);
      __syncthreads();
      if (tid == 0)
        for (int e = 0; e < Cfg::kEpi; ++e) tc_fill<Cfg>(prm, plan, s, slot + e + SL, total);
      slot += Cfg::kEpi;
    }
    // only the first trunk carries class rows (the plan packs them there)
    tc_final_rows(prm, T, t == 0 ? plan.n_rows : TC_SDF_ROWS, plan.fin_b, s, out, first, m, tid);
    // a final layer on the input rows (K6's x0, K3's latent where latent_in
    // names it): restaged over the dead activation rows, the SDF rows a
    // second time (K3: one chunk, its rows hold the latent whole)
    for (int c0 = 0; T.fin_lat >= 0 && c0 < plan.lat_pad; c0 += plan.rows) {
      const int count = min(plan.rows, plan.lat_pad - c0);
      fill(t, 0, c0, count, tid);
      __syncthreads();
      tc_sdf_partial(prm + T.fin_lat + c0, plan.lat_pad, count, s, tid);
      __syncthreads();
      tc_sdf_add(prm, -1, s, tid);
      __syncthreads();
    }
  }
  if (tid < TC_SDF_ROWS * TC_P) {
    const int r = tid / TC_P, p = tid % TC_P;
    if (first + p < m) out[(size_t)r * m + first + p] = tanhf(s.oacc[tid] + prm[plan.fin_b + r]);
  }
}

struct TcNoFill {
  static constexpr bool kChunks = false;
  __device__ void operator()(int, int, int, int, int) const {}
};

// Host: reads a descriptor's trunks from desc[pos] on (per trunk: n_hidden,
// fin, fin_xyz, last_pad, then per hidden layer: w, x, lat (K3's only), b,
// in_pad, out_pad) into p, whose head the launcher has read, and says
// whether the whole plan is one this trunk takes, with extra_smem bytes of
// the kernel's own beside tc_smem_bytes; `chunks`: the kernel stages its
// input rows in chunks (K6), else a layer's activation and input rows must
// fit the buffer together.  Sets the stream offsets.  The one check of a
// plan: the launchers return -1 where it fails.  Cfg: the plan's arithmetic
// (its tiles' size and depth).
template <class Cfg = TcF32>
static bool tc_take_plan(TcPlan& p, const int* desc, int desc_len, int pos, bool with_lat,
                         size_t extra_smem, bool chunks = false) {
  constexpr int K = Cfg::kK, TILE = Cfg::kTile;
  if (p.n_trunks < 1 || p.n_trunks > TC_MAX_TRUNKS) return false;
  const int per = with_lat ? 6 : 5;
  for (int t = 0; t < p.n_trunks; ++t) {
    TcTrunk& T = p.trunks[t];
    if (pos + 4 > desc_len) return false;
    T.n_hidden = desc[pos];
    T.fin = desc[pos + 1];
    T.fin_xyz = desc[pos + 2];
    T.fin_lat = -1;
    T.last_pad = desc[pos + 3];
    pos += 4;
    if (T.n_hidden < 1 || T.n_hidden > TC_MAX_HIDDEN || pos + T.n_hidden * per > desc_len)
      return false;
    for (int l = 0; l < T.n_hidden; ++l, pos += per) {
      TcLayer& L = T.layers[l];
      L.w = desc[pos];
      L.x = desc[pos + 1];
      L.lat = with_lat ? desc[pos + 2] : -1;
      L.b = desc[pos + per - 3];
      L.in_pad = desc[pos + per - 2];
      L.out_pad = desc[pos + per - 1];
    }
  }
  if (pos != desc_len) return false;
  if (p.n_rows < TC_SDF_ROWS || p.n_rows > TC_MAX_ROWS) return false;
  if (p.rows < TC_GROUP || p.rows % K || p.lat_pad < 0 || p.lat_pad % K) return false;
  if (p.fin_b < 0 || tc_smem_bytes<Cfg>(p.rows) + extra_smem > 232448) return false;
  int tiles = 0;
  for (int t = 0; t < p.n_trunks; ++t) {
    TcTrunk& T = p.trunks[t];
    if (T.fin < 0 || (T.fin & 3)) return false;  // final rows load as float4
    if (t == 1) p.split = tiles;
    int prev = 0, next = -1;  // next: where the trunk's stream goes on
    for (int l = 0; l < T.n_hidden; ++l) {
      const TcLayer& L = T.layers[l];
      const int groups = L.out_pad / TC_GROUP;
      if (L.out_pad % TC_GROUP || L.out_pad < TC_GROUP || L.out_pad > TC_MAX_OUT ||
          L.out_pad > p.rows) return false;
      // layer 0 reads no activation rows (its input is folded); the others
      // read exactly the previous layer's output
      if (l == 0 ? L.w >= 0 : (L.w < 0 || L.in_pad != prev)) return false;
      if (L.lat >= 0 && p.lat_pad == 0) return false;
      // the input rows are staged above the activation rows (in chunks of
      // at least one k step)
      const int depth = tc_depth(L, p.lat_pad);
      if (chunks ? (L.w >= 0 ? L.in_pad : 0) + (L.lat >= 0 ? K : 0) > p.rows : depth > p.rows)
        return false;
      // the stream: the weight tiles (the latent rows' after the activation
      // rows'), then the epilogue tile, with xyz rows at b + TC_MAX_OUT
      const int start = depth > 0 ? (L.w >= 0 ? L.w : L.lat) : L.b;
      if (start < 0 || (start & 3) || (next >= 0 && start != next)) return false;
      if (l == 0) p.stream[t] = start;
      if (L.w >= 0 && L.lat >= 0 && L.lat != L.w + L.in_pad / K * groups * TILE) return false;
      if (L.b != start + depth / K * groups * TILE) return false;
      if (L.x >= 0 && L.x != L.b + TC_MAX_OUT) return false;
      next = L.b + 2 * TC_TILE;  // the epilogue tile: 2 TC_TILE floats in both
      tiles += tc_tiles<Cfg>(L, p.lat_pad);
      prev = L.out_pad;
    }
    if (T.last_pad != prev) return false;
  }
  if (p.n_trunks == 1) p.split = tiles;
  return true;
}
