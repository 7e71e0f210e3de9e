// K2's bf16 backward chain on Hopper (train_bwd_chain_bf16_kernel) and the
// fixed-order sum of its bias partials (train_bwd_chain_bf16_db_kernel).
//
// Replaces, with the reduction after it (wgrad_bf16_tc.cuh), the backward of
// alignsdf_tpu/ops/decoder_train_kernel.py:_fused_scene_bwd (:652) with
// cdtype bfloat16, whose kernel _bwd_kernel_scene (:597-640) computes per
// point, from the final layer down:
//   dpre_last = dy (1 - y^2), rounded to bf16 before its dx,
//   dx        = round(dpre_l) W_l^T (bf16 products, float32 sums),
//               + dx_last (the classifier's x_last gradient) at the final
//               layer's input, in float32, before the gate,
//   dpre_{l-1} = dx (a_{l-1} > 0) s, a_{l-1} the bf16 residual, s = 1/keep
//               on dropout layers,
//   d(emb)   += round(dpre_l) X_l^T on layers (the final one too) with X,
//   db_l      = the sum of the unrounded dpre_l: per scene on scene-bias
//               layers, over every point elsewhere,
// and every round(dpre_l) written as dpre16 (out_pad, M), the operand of the
// weight-gradient reduction.  The same values as chain_tc.cuh's bf16 chain,
// which K4 and K5 keep; train_decode_backward_reference is the plain version.
//
// What bounds it: bytes.  At the flagship's widths (512 -> 256 -> 512 -> 512
// -> 1) over 64 scenes x 2000 points and two trunks, the residuals read (2
// bytes each) and dpre16 written (2 bytes each) are 1.84 GB of the ~1.85 a
// step (y, dy, the weights, d(emb) and db the rest): 0.55 ms at 3.35 TB/s,
// against 0.27 TFLOP of products, 0.27 ms at bf16's dense rate.
//
// The design, by what held chain_tc.cuh's bf16 route back (1-5):
//  (1, 2) A from shared memory.  A block owns 64 points.  Their dpre stays
//    in a bf16 buffer laid out as wgmma's shared-memory A operand (K-major,
//    128-byte swizzle: 8 blocks of 64 features x 64 points x 128 bytes,
//    64 KB), so a k step's A is a descriptor and nothing is packed in
//    registers.  Two consumer warpgroups take output groups wg and wg + 2
//    of a layer (wgmma.m64n128k16, B = tile_weights(W^T, bf16) tiles).
//  (2) A producer and a pipeline.  One thread of the producer warpgroup
//    streams the trunk's tiles through a ring of CB_RING stages (a stage:
//    one k step's tiles of every output group, up to 16 KB) with full and
//    empty mbarriers.  The consumers keep the next k step issued before
//    they wait for the one before (wgmma.wait_group 1) and release its
//    slot; no warpgroup-wide barrier a k step.  setmaxnreg gives the
//    producers' registers to the consumers.
//  (3) The weights from L2 once per cluster.  Blocks run in clusters of
//    CB_CLUSTER; each stage is cut in CB_CLUSTER pieces, each block loads
//    one and multicasts it to every block of the cluster (1-D bulk copies,
//    cp.async.bulk ... .multicast::cluster), and a slot is refilled once
//    every consumer of the cluster has released it.  Tile bytes read from
//    L2: 1.05 MB a trunk per cluster, 2.1 GB a flagship step, against 4.2
//    GB one block at a time.
//  (4, 5) The gate and the bias sums in the epilogue.  The producer
//    warpgroup's other three warps stage the residual rows of the next
//    dpre (features x the block's 64 points, bf16) into an io buffer by
//    bulk copy while the consumers run the product.  The epilogue gates the
//    float32 accumulators with them, adds their column sums (the unrounded
//    dpre) into per-quarter partials (a quarter: a warp's 16 points) by
//    shuffles, rounds to bf16 and writes the value twice: into the A
//    buffer (the next product's operand) and over its residual in the io
//    buffer, from which those warps store the rows to dpre16 by bulk copy.
//    No float32 dpre is written, and no colsum runs.
//
// The in-place buffer: both warpgroups read all of dpre_l as A, so
// dpre_{l-1} overwrites it only after both have waited for their last
// product (a barrier of the 256 consumer threads a layer); a second 64 KB
// buffer does not fit beside the ring and the io buffer.
//
// db.  Each quarter sums its dpre per scene segment (one pass where its 16
// points lie in one scene; where they straddle, one masked pass a scene):
// its first segment into qh, its last into qt, and a scene wholly inside
// the quarter straight into db.  A walk over the four quarters per feature
// then joins the segments: a scene wholly inside the block is stored into
// db, the block's first segment into its partial slot 0, its last (where
// another) into slot 1.  train_bwd_chain_bf16_db_kernel then sums, per scene
// and feature that span blocks, the slots of those blocks in block order
// (32 warps in a fixed order, then their sums in warp order).  Global-bias
// layers are one scene of all M points.  No atomics: db is bit-reproducible
// from run to run.  The partials take 2 x 4 bytes a feature a block (16 MB
// a flagship step), written and read once.
//
// Kept on the CUDA cores: the final layer (dpre_last, its dpre16 and db,
// and its input gradient computed straight into the accumulators'
// layout, dx_last added) and a latent_in final layer's d(emb) (its first
// term).  d(emb) of a hidden layer with X runs on the tensor cores instead
// (one wgmma.m64n16k16 a k step of the A buffer against 16 columns of X
// staged in shared memory), by warpgroup 0 while warpgroup 1 starts the
// next product.
//
// Shared memory (bytes): A 65,536; the ring CB_RING x 16,384 = 65,536; the
// io buffer 512 rows x 144 (a row of 64 points padded by 16 bytes, so that
// the epilogue's reads of rows 2 apart meet no bank conflict) = 73,728; qh
// and qt 2 x 4 x 512 x 4 = 16,384 (d(emb)'s staged X over them); the final
// rows' dpre 512 and weights 4,096; 10 barriers; the block's scene
// segments 80; 1,024 of alignment: 226,976 of 232,448.
//
// Rows a bulk copy cannot move (M % 8 != 0, so a row of 64 points is not
// 16-byte aligned, or a residual or dpre16 not 16-byte aligned) are copied
// by those three warps with 8-byte loads and stores instead.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_bf16.cuh"     // tc_round_bf16, tc_pack_bf16
#include "wgrad_bf16_tc.cuh"  // the cluster's helpers, wb_wgmma, the mbarriers, the descriptors

#define CB_P 64              // points a block: wgmma's M
#define CB_THREADS 384       // consumer warpgroups 0 and 1, then the producer warpgroup
#define CB_CONSUMERS 256
#define CB_IO_THREADS 96     // warps 9-11: the io buffer's copies
#define CB_MAX_OUT 512       // hidden widths: four output groups of 128
#define CB_MAX_LAYERS 10
#define CB_EMB_MAX 64
#define CB_TILE 4096         // bytes of a 128-output x 16-k bf16 tile
#define CB_STAGE (4 * CB_TILE)
#define CB_RING 4
#define CB_CLUSTER 2
#define CB_IO_LD 144         // bytes a row of the io buffer
#define CB_DB_THREADS 1024   // the db kernel's block: 32 warps
#define CB_PLAN_INTS 8
// shared memory offsets from the 1024-aligned base
#define CB_OFF_RING 65536
#define CB_OFF_IO (CB_OFF_RING + CB_RING * CB_STAGE)
#define CB_OFF_QH (CB_OFF_IO + CB_MAX_OUT * CB_IO_LD)
#define CB_OFF_QT (CB_OFF_QH + 4 * CB_MAX_OUT * 4)
#define CB_OFF_G (CB_OFF_QT + 4 * CB_MAX_OUT * 4)
#define CB_OFF_WS (CB_OFF_G + 2 * CB_P * 4)
#define CB_OFF_BAR (CB_OFF_WS + CB_MAX_OUT * 2 * 4)
#define CB_OFF_SEG (CB_OFF_BAR + 8 * (2 * CB_RING + 2))
#define CB_SMEM (CB_OFF_SEG + 2 * 40 + 1024)

// CH_PROBE 32 (tools/time_train_chain.py's clocked copy; 0 in the
// package's build): the consumers' thread 0 adds each phase's cycles
// (final rows, waits for the residual rows, products with their ring
// waits, epilogue and gate, the db walk, d(emb)), the producer thread its
// waits for a free slot and an io thread its waits for the stores' reads,
// into cb_cycles.  The chain's other CH_PROBE bits do not apply here.
#ifndef CH_PROBE
#define CH_PROBE 0
#endif
// set-up, final rows, row waits, products, epilogue, db walk, d(emb), producer waits
#define CB_PHASES 8
#if CH_PROBE & 32
__device__ unsigned long long cb_cycles[CB_PHASES + 1];  // + the stores' waits
extern "C" int cb_read_cycles(unsigned long long* out) {
  const cudaError_t err = cudaMemcpyFromSymbol(out, cb_cycles, sizeof(cb_cycles));
  const unsigned long long zero[CB_PHASES + 1] = {};
  return err != cudaSuccess ? (int)err : (int)cudaMemcpyToSymbol(cb_cycles, zero, sizeof(zero));
}
#endif
struct CbClock {
  long long last, acc[CB_PHASES + 1];
  __device__ __forceinline__ CbClock() {
    if (CH_PROBE & 32) {
      last = clock64();
      for (int i = 0; i <= CB_PHASES; ++i) acc[i] = 0;
    }
  }
  __device__ __forceinline__ void tick(int ph) {
    if (CH_PROBE & 32) {
      const long long now = clock64();
      acc[ph] += now - last;
      last = now;
    }
  }
  __device__ __forceinline__ void flush(bool on) const {
#if CH_PROBE & 32
    if (on)
      for (int i = 0; i <= CB_PHASES; ++i)
        if (acc[i]) atomicAdd(&cb_cycles[i], (unsigned long long)acc[i]);
#endif
  }
};

struct CbLayer {
  const __nv_bfloat16* act;  // hidden layers: the gated activation (out_pad, M)
  __nv_bfloat16* dpre16;     // dpre rounded (out_pad, M)
  const float* x;            // (e, out_pad) bf16 values, or null
  float* db;                 // (n_scenes, out_pad) with scene_bias, else (out_pad)
  float* part;               // the db partials, [blocks][2][out_pad]
  int out_pad, scene_bias, dropout;
  int items;                 // the db kernel's first block for this layer
};

struct CbArgs {
  int n_layers, n_out, e, m, nps, xl_w;
  int blocks;   // blocks with points: ceil(M / 64); the grid rounds up to a cluster
  int bulk;     // rows move by bulk copy
  int db_items; // the db kernel's blocks
  float scale;  // 1 / keep
  const float* y;        // (n_out, M)
  const float* dy;       // (n_out, M)
  const float* dx_last;  // (M, xl_w) or null
  const float* wf;       // the final layer's w (in_pad, n_out), bf16 values
  float* demb;           // (M, e)
  const float* tiles;    // the chain's tiles, bf16 pairs, from the last hidden layer down
  CbLayer layers[CB_MAX_LAYERS];  // the final layer's act is null, its x the final X
};

__device__ __forceinline__ void cb_bar_consumers() {
  asm volatile("bar.sync 1, 256;" ::: "memory");
}
__device__ __forceinline__ void cb_bar_io() {
  asm volatile("bar.sync 2, 96;" ::: "memory");
}
__device__ __forceinline__ void cb_wgmma_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
}
__device__ __forceinline__ int cb_cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return (int)r;
}

// bytes (a multiple of 16) from global src to shared dst, in every block of
// the cluster (cs > 1: at dst's offset there, counted on bar's), else here
__device__ __forceinline__ void cb_bulk_load(uint32_t dst, const void* src, int bytes,
                                             uint64_t* bar, int cs) {
  if (cs > 1) {
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
                 ".multicast::cluster [%0], [%1], %2, [%3], %4;"
                 :: "r"(dst), "l"(src), "r"(bytes), "r"(tc_smem(bar)),
                    "h"((uint16_t)((1u << cs) - 1)) : "memory");
  } else {
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
                 "[%0], [%1], %2, [%3];"
                 :: "r"(dst), "l"(src), "r"(bytes), "r"(tc_smem(bar)) : "memory");
  }
}

// bytes (a multiple of 16) from shared src to global dst
__device__ __forceinline__ void cb_bulk_store(void* dst, uint32_t src, int bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               :: "l"(dst), "r"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cb_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(tc_smem(bar)) : "memory");
}

// Waits for the phase of `parity` of bar to complete: the loop inside one
// asm statement, so that the compiler sees no divergent path there.
__device__ __forceinline__ void cb_wait(uint64_t* bar, int parity) {
  asm volatile("{\n.reg .pred done;\n"
               "WAIT:\n"
               "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
               "@!done bra.uni WAIT;\n}\n"
               :: "r"(tc_smem(bar)), "r"(parity) : "memory");
}

// Keeps half of v[0, 2 half) and adds the partner's (lane ^ mask) same half:
// after it v[k], k < half, is v's entry k (lane & mask clear) or k + half
// (set), summed over the two lanes.
template <int HALF, int N>
__device__ __forceinline__ void cb_halve(float (&v)[N], int mask, int lane) {
  const bool hi = lane & mask;
#pragma unroll
  for (int k = 0; k < HALF; ++k) {
    const float keep = hi ? v[k + HALF] : v[k];
    const float send = hi ? v[k] : v[k + HALF];
    v[k] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
  }
}

// Byte offset of dpre (point pt, feature o) in the A buffer (feature pairs
// o, o + 1 share 4 bytes for even o).
__device__ __forceinline__ uint32_t cb_a_off(int pt, int o) {
  return (uint32_t)((o >> 6) * 8192 + pt * 128 + ((((o >> 3) & 7) ^ (pt & 7)) << 4) + (o & 7) * 2);
}

// A block's scene segments for one segment length (n_per_scene, or M for
// a global bias), worked out once at the start (no division in the
// epilogues): the scene of its first point, of each quarter's first and
// last point (clamped to M), and its last point.
struct CbSeg {
  int nps, head, last, quarters, s0[4], s1[4];
};

__device__ __forceinline__ void cb_seg_init(CbSeg& g, int nps, int first, int m) {
  g.nps = nps;
  g.head = min(first, m - 1) / nps;
  g.last = min(first + CB_P - 1, m - 1);
  g.quarters = first < m ? (g.last - first) / 16 + 1 : 0;
  for (int q = 0; q < 4; ++q) {
    const int qs = min(first + 16 * q, m - 1);
    g.s0[q] = qs / nps;
    g.s1[q] = min(qs + 15, m - 1) / nps;
  }
}

// A segment's sum of feature o: stored into db where the scene lies wholly
// in this block (points first .. g.last), else into the block's partial
// slot 0 (the block's first segment) or 1.
__device__ __forceinline__ void cb_emit(const CbArgs& p, const CbLayer& L, const CbSeg& g, int sc,
                                        int o, float v, int first) {
  const int start = sc * g.nps, end = min(start + g.nps, p.m) - 1;
  if (start >= first && end <= g.last)
    L.db[(size_t)(L.scene_bias ? sc : 0) * L.out_pad + o] = v;
  else
    L.part[((size_t)blockIdx.x * 2 + (sc == g.head ? 0 : 1)) * L.out_pad + o] = v;
}

// The column sums of group j's gated dpre (acc: d[4i + 2r + c] at point p0
// + 8r, feature 128 j + 8 i + 2 t4 + c) over this warp's quarter of the
// block's points, per scene segment (sa, sb: the scenes of points p0 and
// p0 + 8): the first into qh, the last into qt, scenes wholly inside the
// quarter into db.
__device__ __forceinline__ void cb_db_group(const CbLayer& L, const CbSeg& g,
                                            const float (&acc)[64], int j, float* qh, float* qt,
                                            int quarter, int sa, int sb, int lane) {
  if (quarter >= g.quarters) return;  // warp-uniform
  const int t4 = lane & 3, s_lo = g.s0[quarter], s_hi = g.s1[quarter];
  for (int sc = s_lo; sc <= s_hi; ++sc) {
    float v[32];
#pragma unroll
    for (int kk = 0; kk < 32; ++kk) {
      const int i = kk >> 1, c = kk & 1;
      v[kk] = (sa == sc ? acc[4 * i + c] : 0.f) + (sb == sc ? acc[4 * i + 2 + c] : 0.f);
    }
    cb_halve<16>(v, 4, lane);
    cb_halve<8>(v, 8, lane);
    cb_halve<4>(v, 16, lane);
    const int base = 16 * ((lane >> 2) & 1) + 8 * ((lane >> 3) & 1) + 4 * ((lane >> 4) & 1);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int kk = base + k;
      const int o = 128 * j + 8 * (kk >> 1) + 2 * t4 + (kk & 1);
      if (sc == s_lo) qh[quarter * CB_MAX_OUT + o] = v[k];
      else if (sc == s_hi) qt[quarter * CB_MAX_OUT + o] = v[k];
      else L.db[(size_t)sc * L.out_pad + o] = v[k];
    }
  }
}

// The epilogue of group j: gate the accumulators with the residual rows in
// io (a > 0 ? v s : 0; 0 past M), keep the unrounded value in acc, write it
// rounded into the A buffer and over its residual in io.
__device__ __forceinline__ void cb_gate_group(float (&acc)[64], int j, float s, uint8_t* abuf,
                                              uint8_t* io, int first, int m, int p0, int t4) {
  const bool va = first + p0 < m, vb = first + p0 + 8 < m;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int o = 128 * j + 8 * i + 2 * t4;
    float r[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {  // u = 2 r + c: point p0 + 8 r, feature o + c
      const int pt = p0 + 8 * (u >> 1), oo = o + (u & 1);
      uint16_t* cell = reinterpret_cast<uint16_t*>(io + oo * CB_IO_LD + pt * 2);
      const float a = __uint_as_float((uint32_t)*cell << 16);
      const float v = ((u >> 1) ? vb : va) && a > 0.f ? acc[4 * i + u] * s : 0.f;
      acc[4 * i + u] = v;
      r[u] = tc_round_bf16(v);
      *cell = (uint16_t)(__float_as_uint(r[u]) >> 16);
    }
    *reinterpret_cast<uint32_t*>(abuf + cb_a_off(p0, o)) = tc_pack_bf16(r[0], r[1]);
    *reinterpret_cast<uint32_t*>(abuf + cb_a_off(p0 + 8, o)) = tc_pack_bf16(r[2], r[3]);
  }
}

// The walk that joins a layer's quarter partials into segments, a feature a
// thread (consumers, after the epilogue's barrier).
__device__ __forceinline__ void cb_db_walk(const CbArgs& p, const CbLayer& L, const CbSeg& g,
                                           const float* qh, const float* qt, int first, int tid) {
  for (int o = tid; g.quarters > 0 && o < L.out_pad; o += CB_CONSUMERS) {
    int cs = g.head;
    float cur = 0.f;
    for (int qd = 0; qd < g.quarters; ++qd) {
      if (g.s0[qd] != cs) {
        cb_emit(p, L, g, cs, o, cur, first);
        cur = 0.f;
        cs = g.s0[qd];
      }
      cur += qh[qd * CB_MAX_OUT + o];
      if (g.s1[qd] != g.s0[qd]) {
        cb_emit(p, L, g, cs, o, cur, first);
        cur = qt[qd * CB_MAX_OUT + o];
        cs = g.s1[qd];
      }
    }
    cb_emit(p, L, g, cs, o, cur, first);
  }
}

// d[8] += A (64 x 16 at da) x B^T (16 x 16 at db), both bf16 in shared
// memory; d[4i + r]: point 16 warp + lane/4 (+ 8 for r >= 2), column 8i +
// 2 (lane%4) (+ 1 for odd r).
__device__ __forceinline__ void cb_wgmma_n16(float (&d)[8], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "l"(da), "l"(db), "r"(1));
}

// d(emb) of the layer whose dpre fills the A buffer, on the tensor cores,
// by warpgroup 0 (wt its thread): demb[pt][c] (+)= sum_o dpre[pt][o]
// x[c][o], 16 columns of x at a time staged in xs (16 KB, over qh and qt,
// which the walk is done reading) as a B operand (K-major core matrices of
// 8 columns x 8 features, tile_weights' layout), one wgmma.m64n16k16 a k
// step against the A buffer.  `store`: the first term.
__device__ void cb_demb(const CbArgs& p, const CbLayer& L, const uint8_t* abuf, uint8_t* xs,
                        bool store, int first, int wt, int p0, int t4) {
  for (int c0 = 0; c0 < p.e; c0 += 16) {
    // a thread's pairs of features k = 2 (wt + 128 h), all loads issued
    // before the first store
    float2 v[16][CB_MAX_OUT / 256];
#pragma unroll
    for (int n = 0; n < 16; ++n) {
#pragma unroll
      for (int h = 0; h < CB_MAX_OUT / 256; ++h) {
        const int k = 2 * (wt + 128 * h);
        const float* xr = L.x + (size_t)(c0 + n) * L.out_pad + k;
        v[n][h] = c0 + n < p.e && k < L.out_pad ? __ldg(reinterpret_cast<const float2*>(xr))
                                                 : make_float2(0.f, 0.f);
      }
    }
#pragma unroll
    for (int n = 0; n < 16; ++n) {
#pragma unroll
      for (int h = 0; h < CB_MAX_OUT / 256; ++h) {
        const int k = 2 * (wt + 128 * h);
        if (k < L.out_pad)
          *reinterpret_cast<uint32_t*>(xs + (k >> 4) * 512 + (n >> 3) * 256 + ((k >> 3) & 1) * 128
                                       + (n & 7) * 16 + (k & 7) * 2) =
              tc_pack_bf16(v[n][h].x, v[n][h].y);
      }
    }
    tc_fence_proxy_async();
    asm volatile("bar.sync 3, 128;" ::: "memory");  // xs staged for the warpgroup's products
    float d[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) d[i] = 0.f;
    tc_wgmma_fence();
    for (int st = 0; st < L.out_pad / 16; ++st)
      cb_wgmma_n16(d, tc_desc_sw128(reinterpret_cast<const float*>(abuf + (st >> 2) * 8192
                                                                   + (st & 3) * 32)),
                   tc_desc(reinterpret_cast<const float*>(xs + st * 512)));
    tc_wgmma_commit();
    tc_wgmma_wait();
    wb_fence_acc(d);
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int pt = p0 + 8 * ((u >> 1) & 1), c = c0 + 8 * (u >> 2) + 2 * t4 + (u & 1);
      if (c < p.e && first + pt < p.m) {
        float* out = p.demb + (size_t)(first + pt) * p.e + c;
        *out = store ? d[u] : *out + d[u];
      }
    }
    asm volatile("bar.sync 3, 128;" ::: "memory");  // every product is done with xs
  }
}

// The final layer's input gradient of group j straight into the
// accumulators' layout: sum_r w[o][r] round(g[r][pt]) (w holds bf16 values:
// exact products), plus dx_last[pt][o] where given.
__device__ __forceinline__ void cb_final_dx(const CbArgs& p, float (&acc)[64], int j,
                                            const float* g, const float* ws, int first, int p0,
                                            int t4) {
  const float ga = tc_round_bf16(g[p0]), gb = tc_round_bf16(g[p0 + 8]);
  const float ha = p.n_out > 1 ? tc_round_bf16(g[CB_P + p0]) : 0.f;
  const float hb = p.n_out > 1 ? tc_round_bf16(g[CB_P + p0 + 8]) : 0.f;
  const bool va = first + p0 < p.m, vb = first + p0 + 8 < p.m;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {  // u = 2 r + c: point p0 + 8 r, feature o + c
      const int o = 128 * j + 8 * i + 2 * t4 + (u & 1);
      const bool b = u >> 1;
      float v = p.n_out > 1 ? fmaf(ws[2 * o + 1], b ? hb : ha, ws[2 * o] * (b ? gb : ga))
                            : ws[o] * (b ? gb : ga);
      if (p.dx_last && o < p.xl_w && (b ? vb : va))
        v += __ldg(p.dx_last + (size_t)(first + p0 + 8 * b) * p.xl_w + o);
      acc[4 * i + u] = v;
    }
  }
}

// The weight producer (one thread): every k step's tiles of every hidden
// layer l >= 1, from the last down, a stage each, this block's piece
// multicast to the cluster; then the last stages' releases, so that no
// block of the cluster arrives here after this block has left.
__device__ void cb_produce(const CbArgs& p, uint8_t* ring, uint64_t* full, uint64_t* empty,
                          int rank, int cs, CbClock& clk) {
  const uint8_t* src = reinterpret_cast<const uint8_t*>(p.tiles);
  int s = 0;
  for (int l = p.n_layers - 2; l >= 1; --l) {
    const int bytes = p.layers[l - 1].out_pad / 128 * CB_TILE, piece = bytes / cs;
    for (int st = 0; st < p.layers[l].out_pad / 16; ++st, ++s, src += bytes) {
      const int slot = s % CB_RING;
      if (s >= CB_RING) tc_mbar_wait(&empty[slot], ((s / CB_RING) - 1) & 1);
      clk.tick(7);
      tc_mbar_expect_tx(&full[slot], bytes);
      cb_bulk_load(tc_smem(ring + slot * CB_STAGE + rank * piece), src + rank * piece, piece,
                   &full[slot], cs);
    }
  }
  for (int k = max(0, s - CB_RING); k < s; ++k)
    tc_mbar_wait(&empty[k % CB_RING], (k / CB_RING) & 1);
  clk.tick(7);
}

// The io warps (t = 0 .. 95): for each dpre_k the consumers form, from the
// last hidden layer's down to layer 0's, layer k's residual rows into io
// (they gate dpre_k), then, after the consumers' epilogue, dpre16_k's rows
// (written over them) out of io.
__device__ void cb_io(const CbArgs& p, uint8_t* io, uint64_t* io_full, uint64_t* io_done,
                      int first, int t, CbClock& clk) {
  const int valid = max(0, min(CB_P, p.m - first));  // points of this block
  const int n = p.n_layers - 1;                      // epilogues: layers n - 1 .. 0
  for (int k = n - 1; k >= -1; --k) {
    if (k < n - 1) {  // layer k + 1's dpre16 is in io
      tc_mbar_wait(io_done, (n - 2 - k) & 1);
      const CbLayer& D = p.layers[k + 1];
      if (p.bulk) {
        for (int o = t; valid > 0 && o < D.out_pad; o += CB_IO_THREADS)
          cb_bulk_store(D.dpre16 + (size_t)o * p.m + first, tc_smem(io + o * CB_IO_LD), valid * 2);
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      } else {
        for (int i = t; i < D.out_pad * 16; i += CB_IO_THREADS) {
          const int o = i >> 4, pt = (i & 15) * 4;
          if (pt < valid)
            *reinterpret_cast<uint2*>(D.dpre16 + (size_t)o * p.m + first + pt) =
                *reinterpret_cast<const uint2*>(io + o * CB_IO_LD + pt * 2);
        }
      }
      clk.tick(CB_PHASES);
      cb_bar_io();  // every io thread's rows are out before any row comes in
    }
    if (k < 0) break;
    const CbLayer& A = p.layers[k];
    if (p.bulk) {
      if (t == 0) tc_mbar_expect_tx(io_full, valid * 2 * A.out_pad);
      cb_bar_io();  // the bytes are expected before any lands
      for (int o = t; valid > 0 && o < A.out_pad; o += CB_IO_THREADS)
        cb_bulk_load(tc_smem(io + o * CB_IO_LD), A.act + (size_t)o * p.m + first, valid * 2,
                     io_full, 1);
    } else {
      for (int i = t; i < A.out_pad * 16; i += CB_IO_THREADS) {
        const int o = i >> 4, pt = (i & 15) * 4;
        if (pt < valid)
          *reinterpret_cast<uint2*>(io + o * CB_IO_LD + pt * 2) =
              __ldg(reinterpret_cast<const uint2*>(A.act + (size_t)o * p.m + first + pt));
      }
      cb_arrive(io_full);
    }
  }
  if (p.bulk) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// Releases a ring slot in every block of the cluster: threads 0 .. cs - 1 of
// the warpgroup (wt) arrive, one a block, by a predicate rather than a
// branch, so that the products around it stay in one uniform path.
__device__ __forceinline__ void cb_release(uint64_t* bar, int cs, int wt) {
  asm volatile("{\n.reg .pred p;\n.reg .b32 remote;\n"
               "setp.lt.s32 p, %1, %2;\n"
               "mapa.shared::cluster.u32 remote, %0, %3;\n"
               "@p mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n"
               :: "r"(tc_smem(bar)), "r"(wt), "r"(cs), "r"(wt < cs ? wt : 0) : "memory");
}

// A layer's product dx = dpre_k W_k^T for a warpgroup that owns NG output
// groups (wg, then wg + 2): `steps` k steps of 16 from ring stage `stage`
// on, the A buffer's dpre by descriptor, each step issued before the one
// before is waited for and its slot released.
template <int NG>
__device__ __forceinline__ void cb_product(float (&acc0)[64], float (&acc1)[64], int steps,
                                           int& stage, const uint8_t* abuf, const uint8_t* ring,
                                           uint64_t* full, uint64_t* empty, int cs, int wg,
                                           int wt) {
#pragma unroll
  for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0.f;
  for (int st = 0; st < steps; ++st, ++stage) {
    const int slot = stage % CB_RING;
    cb_wait(&full[slot], (stage / CB_RING) & 1);
    if constexpr (NG > 0) {
      const uint8_t* t = ring + slot * CB_STAGE;
      const uint64_t da = tc_desc_sw128(reinterpret_cast<const float*>(
          abuf + (st >> 2) * 8192 + (st & 3) * 32));
      tc_wgmma_fence();
      wb_wgmma<128>(acc0, da, tc_desc(reinterpret_cast<const float*>(t + wg * CB_TILE)));
      if constexpr (NG > 1)
        wb_wgmma<128>(acc1, da, tc_desc(reinterpret_cast<const float*>(t + (wg + 2) * CB_TILE)));
      tc_wgmma_commit();
      if (st > 0) {
        cb_wgmma_wait1();  // the step before is done: its slot is free
        cb_release(&empty[(stage - 1) % CB_RING], cs, wt);
      }
    } else {
      cb_release(&empty[slot], cs, wt);
    }
  }
  if constexpr (NG > 0) {
    tc_wgmma_wait();
    tc_fence_acc(acc0);
    tc_fence_acc(acc1);
    cb_release(&empty[(stage - 1) % CB_RING], cs, wt);
  }
}

__global__ void __launch_bounds__(CB_THREADS, 1)
train_bwd_chain_bf16_kernel(const CbArgs p) {
  extern __shared__ uint8_t cb_raw[];
  uint8_t* sm = cb_raw + ((1024 - (tc_smem(cb_raw) & 1023)) & 1023);  // the swizzle's 1 KB atoms
  uint8_t* abuf = sm;
  uint8_t* ring = sm + CB_OFF_RING;
  uint8_t* io = sm + CB_OFF_IO;
  float* qh = reinterpret_cast<float*>(sm + CB_OFF_QH);
  float* qt = reinterpret_cast<float*>(sm + CB_OFF_QT);
  float* g = reinterpret_cast<float*>(sm + CB_OFF_G);
  float* ws = reinterpret_cast<float*>(sm + CB_OFF_WS);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + CB_OFF_BAR);
  uint64_t* empty = full + CB_RING;
  uint64_t* io_full = empty + CB_RING;
  uint64_t* io_done = io_full + 1;
  CbSeg* seg = reinterpret_cast<CbSeg*>(sm + CB_OFF_SEG);  // [0] scenes, [1] all M points
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cs = cb_cluster_size(), rank = wb_cluster_rank();
  const int first = blockIdx.x * CB_P, last = p.n_layers - 1;
  CbClock clk;
  if (tid == 0) {
    for (int i = 0; i < CB_RING; ++i) {
      tc_mbar_init(full + i, 1);
      tc_mbar_init(empty + i, 2 * cs);
    }
    tc_mbar_init(io_full, p.bulk ? 1 : CB_IO_THREADS);
    tc_mbar_init(io_done, CB_CONSUMERS);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    cb_seg_init(seg[0], p.nps, first, p.m);
    cb_seg_init(seg[1], p.m, first, p.m);
  }
  wb_cluster_sync();  // every block's barriers are set before a copy or an arrival reaches them

  if (warp >= 8) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (warp == 8) {
      if (lane == 0) {
        cb_produce(p, ring, full, empty, rank, cs, clk);
        clk.flush(true);
      }
    } else {
      cb_io(p, io, io_full, io_done, first, tid - 288, clk);
      clk.flush(tid == 288);
    }
    return;
  }

  // the consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  // the warpgroup's index broadcast from lane 0, so that the compiler knows
  // it uniform over each warp (the products' paths branch on it)
  const int wg = __shfl_sync(0xffffffffu, warp >> 2, 0);
  const int wt = tid & 127, t4 = lane & 3, quarter = warp & 3;
  const int p0 = 16 * quarter + (lane >> 2);  // this thread's points: p0, p0 + 8
  // their scenes (points past M take the last one's)
  const int sa = min(first + p0, p.m - 1) / p.nps, sb = min(first + p0 + 8, p.m - 1) / p.nps;
  clk.tick(0);

  // the final layer: g = dy (1 - y^2) (unrounded), its dpre16 and db; its
  // input's gradient (from g rounded) straight into the accumulators
  const CbLayer& F = p.layers[last];
  const CbLayer& H = p.layers[last - 1];
  if (tid < p.n_out * CB_P) {
    const int r = tid / CB_P, pt = tid % CB_P;
    float v = 0.f;
    if (first + pt < p.m) {
      const size_t at = (size_t)r * p.m + first + pt;
      const float yv = p.y[at];
      v = p.dy[at] * (1.f - yv * yv);
      F.dpre16[at] = __float2bfloat16_rn(v);
    }
    g[tid] = v;
  }
  for (int i = tid; i < H.out_pad * p.n_out; i += CB_CONSUMERS) ws[i] = __ldg(p.wf + i);
  cb_bar_consumers();
  if (warp < p.n_out && first < p.m) {  // db of final row `warp`
    const CbSeg& fs = seg[F.scene_bias ? 0 : 1];
    const float* gr = g + warp * CB_P;
    if (fs.head == fs.s1[fs.quarters - 1]) {  // the block in one scene: a warp's sum
      float v = gr[lane] + gr[lane + 32];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) cb_emit(p, F, fs, fs.head, warp, v, first);
    } else if (lane == 0) {  // a walk over the points
      int cs0 = fs.head;
      float cur = 0.f;
      for (int pt = 0; first + pt <= fs.last; ++pt) {
        const int sc = (first + pt) / fs.nps;
        if (sc != cs0) {
          cb_emit(p, F, fs, cs0, warp, cur, first);
          cur = 0.f;
          cs0 = sc;
        }
        cur += gr[pt];
      }
      cb_emit(p, F, fs, cs0, warp, cur, first);
    }
  }
  bool demb_stored = false;
  if (F.x) {  // a latent_in final layer: its d(emb), the chain's first term
    for (int i = tid; i < p.e * CB_P; i += CB_CONSUMERS) {
      const int c = i / CB_P, pt = i % CB_P;
      if (first + pt >= p.m) continue;
      float v = __ldg(F.x + (size_t)c * p.n_out) * tc_round_bf16(g[pt]);
      if (p.n_out > 1)
        v = fmaf(__ldg(F.x + (size_t)c * p.n_out + 1), tc_round_bf16(g[CB_P + pt]), v);
      p.demb[(size_t)(first + pt) * p.e + c] = v;
    }
    demb_stored = true;
  }
  float acc0[64], acc1[64];
  int groups = H.out_pad / 128;
  if (groups > wg) cb_final_dx(p, acc0, wg, g, ws, first, p0, t4);
  if (groups > wg + 2) cb_final_dx(p, acc1, wg + 2, g, ws, first, p0, t4);
  clk.tick(1);

  int stage = 0;
  for (int k = last - 1; k >= 0; --k) {
    // the epilogue that forms dpre_k from the accumulators
    const CbLayer& D = p.layers[k];
    groups = D.out_pad / 128;
    const float s = D.dropout ? p.scale : 1.f;
    cb_wait(io_full, (last - 1 - k) & 1);
    clk.tick(2);
    if (groups > wg) cb_gate_group(acc0, wg, s, abuf, io, first, p.m, p0, t4);
    if (groups > wg + 2) cb_gate_group(acc1, wg + 2, s, abuf, io, first, p.m, p0, t4);
    tc_fence_proxy_async();  // the A buffer for wgmma, io for the bulk stores
    cb_arrive(io_done);
    const CbSeg& ds = seg[D.scene_bias ? 0 : 1];
    const int da = D.scene_bias ? sa : 0, dbs = D.scene_bias ? sb : 0;
    if (groups > wg) cb_db_group(D, ds, acc0, wg, qh, qt, quarter, da, dbs, lane);
    if (groups > wg + 2) cb_db_group(D, ds, acc1, wg + 2, qh, qt, quarter, da, dbs, lane);
    clk.tick(4);
    cb_bar_consumers();  // dpre_k whole in the A buffer; the quarters' sums in qh, qt
    cb_db_walk(p, D, ds, qh, qt, first, tid);
    clk.tick(5);
    if (D.x) {  // warpgroup 0, over qh and qt once every walk is done with them
      cb_bar_consumers();
      if (wg == 0)
        cb_demb(p, D, abuf, reinterpret_cast<uint8_t*>(qh), !demb_stored, first, wt, p0, t4);
      demb_stored = true;
      clk.tick(6);
    }
    if (k == 0) break;

    // dx = dpre_k W_k^T: depth D.out_pad, outputs layers[k - 1].out_pad
    const int out_groups = p.layers[k - 1].out_pad / 128, steps = D.out_pad / 16;
    if (out_groups > wg + 2)
      cb_product<2>(acc0, acc1, steps, stage, abuf, ring, full, empty, cs, wg, wt);
    else if (out_groups > wg)
      cb_product<1>(acc0, acc1, steps, stage, abuf, ring, full, empty, cs, wg, wt);
    else
      cb_product<0>(acc0, acc1, steps, stage, abuf, ring, full, empty, cs, wg, wt);
    clk.tick(3);
    cb_bar_consumers();  // both warpgroups are done reading dpre_k
  }
  clk.flush(tid == 0);
}

// db of every (layer, scene, 32 features) whose scene spans blocks: the
// partial slots of those blocks, warp w summing blocks w, w + 32, ... of
// them in order, then the warps' sums in warp order.
__global__ void __launch_bounds__(CB_DB_THREADS)
train_bwd_chain_bf16_db_kernel(const CbArgs p) {
  __shared__ float red[32][33];
  int l = 0;
  while (l + 1 < p.n_layers && (int)blockIdx.x >= p.layers[l + 1].items) ++l;
  const CbLayer& L = p.layers[l];
  const int chunks = (L.out_pad + 31) / 32, item = blockIdx.x - L.items;
  const int sc = item / chunks, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int o = (item % chunks) * 32 + lane;
  const int nps = L.scene_bias ? p.nps : p.m;
  const int start = sc * nps, end = min(start + nps, p.m) - 1;
  const int b0 = start / CB_P, b1 = end / CB_P;
  if (b0 == b1) return;  // the chain stored it
  float sum = 0.f;
  if (o < L.out_pad) {
#pragma unroll 4
    for (int b = b0 + warp; b <= b1; b += 32)
      sum += L.part[((size_t)b * 2 + (sc == b * CB_P / nps ? 0 : 1)) * L.out_pad + o];
  }
  red[warp][lane] = sum;
  __syncthreads();
  if (warp == 0 && o < L.out_pad) {
    float t = 0.f;
    for (int w = 0; w < 32; ++w) t += red[w][lane];
    L.db[(size_t)(L.scene_bias ? sc : 0) * L.out_pad + o] = t;
  }
}

// Host: checks the arguments, sets the db kernel's items and the copy
// route, and launches the chain in clusters of CB_CLUSTER then the db
// kernel; with `plan` (CB_PLAN_INTS: shared memory bytes, points a block,
// cluster, grid blocks, blocks with points, ring stages, bulk, db blocks)
// launches nothing.  0, -1 for arguments the kernels do not take, or a CUDA
// error.  a.layers[l]: hidden out_pad a multiple of 128 up to CB_MAX_OUT,
// the final one's n_out; the tiles hold each hidden layer l >= 1's
// tile_weights(W_l^T, bf16) from the last down (the caller checks their
// count).
static int launch_chain_bf16(CbArgs a, cudaStream_t stream, int* plan = nullptr) {
  if (a.n_layers < 2 || a.n_layers > CB_MAX_LAYERS || a.n_out < 1 || a.n_out > 2) return -1;
  if (a.e < 1 || a.e > CB_EMB_MAX || a.m <= 0 || a.m % 4 || a.nps <= 0 || a.m % a.nps) return -1;
  if (!a.y || !a.dy || !a.wf || !a.demb || (a.n_layers > 2 && !a.tiles)) return -1;
  bool aligned = a.m % 8 == 0;
  int items = 0;
  for (int l = 0; l < a.n_layers; ++l) {
    CbLayer& L = a.layers[l];
    const bool hidden = l < a.n_layers - 1;
    if (hidden ? (L.out_pad < 128 || L.out_pad % 128 || L.out_pad > CB_MAX_OUT || !L.act)
               : L.out_pad != a.n_out)
      return -1;
    if (!L.dpre16 || !L.db || !L.part) return -1;
    if (L.x && ((uintptr_t)L.x % 16)) return -1;
    if (hidden)
      aligned = aligned && (uintptr_t)L.act % 16 == 0 && (uintptr_t)L.dpre16 % 16 == 0;
    L.items = items;
    items += (L.scene_bias ? a.m / a.nps : 1) * ((L.out_pad + 31) / 32);
  }
  if (a.dx_last && (a.xl_w < 1 || a.xl_w > a.layers[a.n_layers - 2].out_pad)) return -1;
  a.bulk = aligned;
  a.blocks = (a.m + CB_P - 1) / CB_P;
  a.db_items = items;
  const unsigned grid = (unsigned)((a.blocks + CB_CLUSTER - 1) / CB_CLUSTER * CB_CLUSTER);
  if (plan) {
    const int v[CB_PLAN_INTS] = {CB_SMEM, CB_P, CB_CLUSTER, (int)grid, a.blocks, CB_RING, a.bulk,
                                 items};
    for (int i = 0; i < CB_PLAN_INTS; ++i) plan[i] = v[i];
    return 0;
  }
  static bool ready = false;
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        train_bwd_chain_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, CB_SMEM);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CB_CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(CB_THREADS);
  cfg.dynamicSmemBytes = CB_SMEM;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  void* args[] = {&a};
  cudaError_t err = cudaLaunchKernelExC(&cfg, (const void*)train_bwd_chain_bf16_kernel, args);
  if (err != cudaSuccess) return (int)err;
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  train_bwd_chain_bf16_db_kernel<<<items, CB_DB_THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}
