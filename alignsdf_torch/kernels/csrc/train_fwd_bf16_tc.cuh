// K2's bf16 train forward on Hopper (train_fwd_bf16_kernel).
//
// Replaces alignsdf_tpu/ops/decoder_train_kernel.py:_fused_scene_fwd (:472,
// its pallas_call :517) with cdtype bfloat16, whose kernel _fwd_kernel_scene
// (:420-470; the casts :483-485) computes per point (row r of M, scene r /
// nps), for hidden layer l
//   acc_l = a_{l-1} W_l (if W) + emb X_l (if X) + b_l[scene] or b_l
//           (bf16 operands, float32 sums, the biases float32),
//   a_l   = round_bf16(gate(relu(acc_l))),
// gate = gate_hash(seed, l, r, lane) < thresh ? 1 / keep : 0 on dropout
// layers, each a_l stored as the residual (out_pad, M) bf16 that the
// backward reads (chain_bf16_tc.cuh, wgrad_bf16_tc.cuh), and the final rows
// y = tanh(a_last W_last + b_last), plus, where latent_in names the final
// layer, emb X_last and the scene's bias row.  The values are
// train_decode_reference's with st.dtype bfloat16, the plain version.
//
// What bounds it: bytes and operations alike.  At the flagship's widths
// (512 -> 256 -> 512 -> 512 -> 1 on 6 embedding columns) over 64 scenes x
// 2000 points and two trunks, the residuals written are 0.92 GB (1,792
// bf16 values a point a trunk), 0.27 ms at 3.35 TB/s, and the products 0.27
// TFLOP, 0.27 ms at bf16's dense rate: it nears either bound only if the
// products, the epilogue and the stores all run at once.  As measured
// (PERF.md) it does not: the epilogue on the CUDA cores and the multicast
// ring's round trips each take about half of its time.
//
// The design, by what held train_fwd_tc.cuh's bf16 route back (1-5):
//  (1) A from shared memory, in bf16.  A block owns 64 points.  Their
//    activations live in bf16 buffers laid out as wgmma's shared-memory A
//    operand, MN-major with the 128-byte swizzle: row o (feature o) holds
//    the 64 points' values in 128 bytes, its 16-byte chunk c at c ^ (o %
//    8), 8 rows a 1 KB atom; a k step of 16 features is a descriptor 2 KB
//    further on.  That is the residual's own layout (feature-major), so
//    the same rows leave by TMA (5).  Two buffers (2 x 64 KB at 512 rows):
//    layer l's epilogue writes a_l into buffer l % 2 while products still
//    read a_{l-1} from the other.  The embedding's terms run on the tensor
//    cores too: the block's embedding rows (e rounded up to 16, bf16) sit
//    in a third such operand, and a layer with X runs (e + 15) / 16 more k
//    steps after W's against X's bf16 tiles (the pack's fwd_x), so layer 0
//    is a product of one k step and no epilogue sums a column.
//  (2) A producer and a pipeline.  Two consumer warpgroups each run their
//    own sequence of (layer, output group) items; each has its own ring
//    of FB_SLOTS 4 KB slots (one k step's 128-output tile), filled by its
//    own producer thread (warp 8 for warpgroup 0, warp 9 for 1) with full
//    and empty mbarriers.  A consumer keeps the next k step issued before it
//    waits for the one before (wgmma.wait_group 1) and releases its slot;
//    no warpgroup-wide barrier a k step.  setmaxnreg gives the producer
//    warpgroup's registers to the consumers.
//  (3) Each weight tile serves 128 points a read from L2.  Blocks run in
//    clusters of FB_CLUSTER = 2; each tile is cut in FB_CLUSTER pieces,
//    each block loads one and multicasts it to the cluster (1-D bulk
//    copies, .multicast::cluster), and a slot is refilled once the owning
//    warpgroup of every block of the cluster has released it.  Tile bytes
//    read from L2: 1.08 MB a flagship trunk per cluster (X's tiles
//    included), 2.16 GB a step, against 4.2 GB one block of 64 at a time.
//    Clusters of 4 would halve that (each tile for 256 points) but run
//    slower: a slot comes back only when the slowest block of the cluster
//    has released it, and that round trip, not L2's rate, sets the pace of
//    the k steps (tools/time_train_fwd.py --bf16 --probes times a copy
//    built with -DFB_CLUSTER=4).  The rings (2 x 10 slots, 80 KB a block)
//    hold 10 k steps a warpgroup in flight, all the shared memory the
//    buffers leave.
//  (4) The epilogue runs under the products.  Warpgroup w takes output
//    groups w and w + 2 of each layer, one group at a time: 64
//    accumulators for the product running, 64 for the group whose product
//    it has just finished.  That group's epilogue (each point's scene
//    bias, ReLU, the gate, the bf16 rounding, the write into the buffer)
//    runs in 4 slices of 16 values, one after each of the first 4 runs of
//    4 k steps of the next product, while the tensor cores run them.  A
//    slice's 16 chains interleave and its loads are issued ahead (the next
//    slice's bias a slice early; the lines prefetched into L1 when the
//    group's product starts); one copy of its code serves every slice (the
//    accumulators shift 16 places after each), where 16 unrolled copies of
//    a 4-value slice thrashed the instruction cache.  A group's rows are
//    published by a "ready" mbarrier of (buffer, group); a product waits,
//    before its k steps over a group's 128 features, only for that group,
//    not for a block-wide barrier.  A slice pass may run under the next
//    product when that product reads the other buffer (the same layer's
//    other group) or reaches the group's features only after its 16th k
//    step (group 2 or 3 of the layer before); otherwise (layer 0's groups,
//    the last group of a 256-wide layer, the last layer's last group) it
//    runs on its own.
//  (5) The residuals leave asynchronously.  Warps 10-11 wait for each
//    (layer, group)'s ready barrier and store its 128 rows with one TMA
//    tensor store from the buffer (the 2-D tensor map of the residual, 64
//    points x 128 rows, 128-byte swizzle, undoes the layout; points past M
//    are clipped), then wait for the store's reads and signal the group's
//    "drained" barrier, which the epilogue two layers on waits for before
//    it writes those rows again.  Rows a tensor map cannot describe (M %
//    8 != 0, or a residual not 16-byte aligned) are copied by those 64
//    threads, 8 bytes at a time.
//  The final rows (n_out <= 2) are folded into the last hidden layer's
//  epilogue: each thread's partial dot products over the 32 units it
//  holds of a group (exact products of bf16 values), summed across the
//  quad by shuffles into a small shared array, then the groups' sums in
//  group order, the latent_in final layer's terms, the bias and tanh.
//
// Accuracy: each unit's float32 sum runs over k in ascending order in one
// accumulator chain (the wgmma k steps in order: W's rows, then the
// embedding's columns); the gate hashes the unit the accumulator holds
// (row first + p, lane o); the rounding to bf16 follows the gate, as JAX's.
//
// Shared memory (bytes, from a 1 KB-aligned base): the two A buffers 2 x
// 65,536; the two rings 2 x 10 x 4,096 = 81,920; the embedding's rows 64 x
// 128 = 8,192; the final rows' group sums 4 x 2 x 64 x 4 = 2,048; 56
// mbarriers 448; 1,024 of alignment: 224,704 of 232,448.  Registers: a
// consumer thread holds 2 x 64 accumulators (setmaxnreg 232; ptxas: no
// spills); the producer warpgroup 40.
//
// FW_PROBE (0 in the package's build; tools/time_train_fwd.py --bf16
// --probes builds copies): 32 clocks the phases: thread 0 of warpgroup 0
// adds each phase's cycles (set-up, the products with their ring waits,
// the epilogue slices, waits for a group to be ready, waits for rows to
// drain, the final rows), warp 8's producer its waits for a free slot and
// the store thread its waits for the stores' reads, into fb_cycles.  The
// other bits leave parts out, to time the rest apart (their results are
// wrong): 1 the products' wgmma, 2 the gate, 8 the slices' loads (the
// bias, the final weights), 64 the slices' writes into the buffer, 128
// the slices.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "chain_bf16_tc.cuh"  // the cluster's loads and releases, cb_wait
#include "train_common.cuh"   // gate_mix
#include "wgrad_bf16_tc.cuh"  // the cluster's helpers, the tensor map encoder

#ifndef FW_PROBE
#define FW_PROBE 0
#endif

#define FB_P 64             // points a block: wgmma's M
#define FB_THREADS 384      // consumer warpgroups 0 and 1, then the producer warpgroup
#define FB_MAX_OUT 512      // hidden widths: up to four output groups of 128
#define FB_MAX_HIDDEN 9
#define FB_EMB_MAX 64
#define FB_TILE 4096        // bytes of a 128-output x 16-k bf16 tile
#define FB_SLOTS 10         // a warpgroup's ring, in tiles
#ifndef FB_CLUSTER
#define FB_CLUSTER 2        // blocks a cluster (4 builds the tool's comparison copy)
#endif
#define FB_BUF 65536        // an A buffer: 512 rows x 128 bytes
#define FB_PLAN_INTS 7
#define FB_OFF_RING (2 * FB_BUF)
#define FB_OFF_EMB (FB_OFF_RING + 2 * FB_SLOTS * FB_TILE)  // the embedding's rows, as an A operand
#define FB_OFF_FIN (FB_OFF_EMB + FB_EMB_MAX * 128)
#define FB_OFF_BAR (FB_OFF_FIN + 4 * 2 * FB_P * 4)
#define FB_BARS (4 * FB_SLOTS + 16)  // full and empty of each ring, ready and drained
#define FB_SMEM (FB_OFF_BAR + 8 * FB_BARS + 1024)

// set-up, products, epilogue slices, ready waits, drain waits, final rows,
// then the producer's slot waits and the store thread's read waits
#define FB_PHASES 6
#if FW_PROBE & 32
__device__ unsigned long long fb_cycles[FB_PHASES + 2];
extern "C" int fb_read_cycles(unsigned long long* out) {
  const cudaError_t err = cudaMemcpyFromSymbol(out, fb_cycles, sizeof(fb_cycles));
  const unsigned long long zero[FB_PHASES + 2] = {};
  return err != cudaSuccess ? (int)err : (int)cudaMemcpyToSymbol(fb_cycles, zero, sizeof(zero));
}
#endif
struct FbClock {
  long long last, acc[FB_PHASES + 2];
  __device__ __forceinline__ FbClock() {
    if (FW_PROBE & 32) {
      last = clock64();
      for (int i = 0; i < FB_PHASES + 2; ++i) acc[i] = 0;
    }
  }
  __device__ __forceinline__ void tick(int ph) {
    if (FW_PROBE & 32) {
      const long long now = clock64();
      acc[ph] += now - last;
      last = now;
    }
  }
  __device__ __forceinline__ void skip() {  // the cycles since the last tick count nowhere
    if (FW_PROBE & 32) last = clock64();
  }
  // adds phases [lo, hi) into fb_cycles
  __device__ __forceinline__ void flush(bool on, int lo = 0, int hi = FB_PHASES) const {
#if FW_PROBE & 32
    if (on)
      for (int i = lo; i < hi; ++i)
        if (acc[i]) atomicAdd(&fb_cycles[i], (unsigned long long)acc[i]);
#endif
  }
};

struct FbLayer {
  const float* x;        // (e, out_pad) bf16 values, or null
  const float* b;        // (n_scenes, out_pad) with scene_bias, else (out_pad)
  __nv_bfloat16* act;    // the residual (out_pad, M)
  int in_pad, out_pad, scene_bias, dropout;
  int tile0;             // the layer's first W tile in `tiles` (layers >= 1)
  int xtile0, x_steps;   // its first X tile in `xtiles` and X's k steps (0: no X)
  int phase;             // bits g: the parity of (buffer l % 2, group g)'s phase for this
                         // layer; bits 4 + g: an earlier layer wrote those rows
};

struct FbArgs {
  int hidden, n_out, e, m, nps, bulk;
  unsigned seed, thresh;
  float scale;           // 1 / keep
  const float* emb;      // (e, M), bf16 values
  float* y;              // (n_out, M)
  const float* tiles;    // the hidden layers' tile_weights(W, bf16), layer by layer
  const float* xtiles;   // ... tile_weights(X, bf16) (e rounded up to 16 rows), of layers with X
  const float* wf;       // the final layer's w (in_pad, n_out), bf16 values
  const float* fb;       // its bias: (n_scenes, n_out) with f_scene_bias, else (n_out)
  const float* fx;       // its X (e, n_out) where latent_in names it, else null
  int f_scene_bias;
  FbLayer layers[FB_MAX_HIDDEN];
};

struct FbMaps {  // the residuals' tensor maps (bulk)
  CUtensorMap act[FB_MAX_HIDDEN];
};

// d[64] += A (64 points x 16 k, MN-major with the 128-byte swizzle at da) x
// B^T (128 x 16, K-major without swizzle at db); d as wb_wgmma<128>'s.
__device__ __forceinline__ void fb_wgmma(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
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
      : "l"(da), "l"(db), "r"(1));
}

// Descriptor of an MN-major A operand with the 128-byte swizzle at shared
// address `addr` (1 KB-aligned): 64 points of a feature in a 128-byte row,
// the 8-feature atoms 1 KB apart (the stride along K).  The offset between
// atoms along M is not read for M = 64 (one atom); it holds the same 1 KB.
__device__ __forceinline__ uint64_t fb_desc_a(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16)
         | ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// Byte offset of (feature o, point pt) in an A buffer.
__device__ __forceinline__ uint32_t fb_off(int o, int pt) {
  return (uint32_t)(o * 128 + ((((pt >> 3) ^ o) & 7) << 4) + (pt & 7) * 2);
}


// gate_hash(seed, layer, row, lane) = gate_mix(fb_key(seed, layer, row) ^
// lane * 0x85EBCA6B): the row's and the layer's terms, once a group.
__device__ __forceinline__ unsigned fb_key(unsigned seed, unsigned layer, unsigned row) {
  return seed ^ (row * 0x9E3779B1u) ^ (layer * 0xC2B2AE35u);
}

// One group's epilogue as its slices read it: this thread's units o0 + 8 i
// (+ 1), i < 16, at its points p0 and p0 + 8.
struct FbEpi {
  const float* b0;      // the bias row of p0's scene at unit o0
  const float* b1;      // ... of p0 + 8's
  const float* wf;      // the final layer's w (in_pad, n_out) at row o0 (last hidden layer), or null
  uint8_t* buf;         // the A buffer the layer writes
  unsigned k0, k1;      // the gate keys of the two rows
  int o0;
  bool gate;
  float2 nb[8];         // the next slice's bias
};

__device__ __forceinline__ FbEpi fb_epi(const FbArgs& p, const uint8_t* sm, int l, int g,
                                        int first, int p0, int t4, int sa, int sb) {
  const FbLayer& L = p.layers[l];
  FbEpi E;
  E.o0 = 128 * g + 2 * t4;
  E.b0 = L.b + (L.scene_bias ? (size_t)sa * L.out_pad : 0) + E.o0;
  E.b1 = L.b + (L.scene_bias ? (size_t)sb * L.out_pad : 0) + E.o0;
  E.wf = l == p.hidden - 1 ? p.wf + (size_t)E.o0 * p.n_out : nullptr;
  E.buf = const_cast<uint8_t*>(sm) + (l & 1) * FB_BUF;
  E.k0 = fb_key(p.seed, (unsigned)l, (unsigned)(first + p0));
  E.k1 = fb_key(p.seed, (unsigned)l, (unsigned)(first + p0 + 8));
  E.gate = L.dropout;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    E.nb[2 * k] = __ldg(reinterpret_cast<const float2*>(E.b0 + 8 * k));
    E.nb[2 * k + 1] = __ldg(reinterpret_cast<const float2*>(E.b1 + 8 * k));
  }
  return E;
}

__device__ __forceinline__ void fb_put(uint8_t* buf, int o, int pt, float v) {
  if (FW_PROBE & 64) return;
  *reinterpret_cast<uint16_t*>(buf + fb_off(o, pt)) = (uint16_t)(__float_as_uint(v) >> 16);
}

// Slice q of a group's epilogue: its units o0 + 8 i (+ 1), i = 4 q .. 4 q +
// 3, at points p0 and p0 + 8, whose accumulators sit at acc[0 .. 15]
// (acc[4 k + 2 r + c]: i = 4 q + k, point p0 + 8 r, unit + c; the
// embedding's terms already in them): + the bias, ReLU, the gate, rounded
// to bf16, into the buffer; on the last hidden layer their terms of the
// final rows into
// fs (row r, point p0 + 8 q at fs[2 r + q], i ascending).  Then the next
// slice's accumulators move to acc[0 .. 15].  q is a runtime value, so
// every slice runs one copy of this code; its loads are issued before
// their uses and its 16 units' chains interleave.
__device__ __forceinline__ void fb_slice(const FbArgs& p, float (&acc)[64], int q, FbEpi& E,
                                         float (&fs)[4], int p0) {
  if (FW_PROBE & 128) return;
  const int i0 = 4 * q;
  float2 ba[4], bb[4], wa[4], wb[4];  // bias of the units at the two points; final weights
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    ba[k] = E.nb[2 * k];
    bb[k] = E.nb[2 * k + 1];
    wa[k] = wb[k] = make_float2(0.f, 0.f);
    if (FW_PROBE & 8) {
      ba[k] = bb[k] = wa[k];
      continue;
    }
    if (q < 3) {  // the next slice's bias, a slice ahead of its use
      E.nb[2 * k] = __ldg(reinterpret_cast<const float2*>(E.b0 + 8 * (i0 + 4 + k)));
      E.nb[2 * k + 1] = __ldg(reinterpret_cast<const float2*>(E.b1 + 8 * (i0 + 4 + k)));
    }
    if (E.wf) {  // n_out 1: (w[o], w[o + 1]); 2: (w[o][0], w[o][1]) and (w[o + 1][0], w[o + 1][1])
      const float* w = E.wf + (size_t)8 * (i0 + k) * p.n_out;
      wa[k] = __ldg(reinterpret_cast<const float2*>(w));
      if (p.n_out > 1) wb[k] = __ldg(reinterpret_cast<const float2*>(w + 2));
    }
  }
  float v[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) v[j] = acc[j];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[4 * k] = fmaxf(v[4 * k] + ba[k].x, 0.f);
    v[4 * k + 1] = fmaxf(v[4 * k + 1] + ba[k].y, 0.f);
    v[4 * k + 2] = fmaxf(v[4 * k + 2] + bb[k].x, 0.f);
    v[4 * k + 3] = fmaxf(v[4 * k + 3] + bb[k].y, 0.f);
  }
  if (E.gate && !(FW_PROBE & 2)) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const unsigned c0 = (unsigned)(E.o0 + 8 * (i0 + k)) * 0x85EBCA6Bu, c1 = c0 + 0x85EBCA6Bu;
      v[4 * k] = gate_mix(E.k0 ^ c0) < p.thresh ? v[4 * k] * p.scale : 0.f;  // lanes o, o + 1
      v[4 * k + 1] = gate_mix(E.k0 ^ c1) < p.thresh ? v[4 * k + 1] * p.scale : 0.f;
      v[4 * k + 2] = gate_mix(E.k1 ^ c0) < p.thresh ? v[4 * k + 2] * p.scale : 0.f;
      v[4 * k + 3] = gate_mix(E.k1 ^ c1) < p.thresh ? v[4 * k + 3] * p.scale : 0.f;
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int o = E.o0 + 8 * (i0 + k);
#pragma unroll
    for (int u = 0; u < 4; ++u) v[4 * k + u] = tc_round_bf16(v[4 * k + u]);
    fb_put(E.buf, o, p0, v[4 * k]);
    fb_put(E.buf, o + 1, p0, v[4 * k + 1]);
    fb_put(E.buf, o, p0 + 8, v[4 * k + 2]);
    fb_put(E.buf, o + 1, p0 + 8, v[4 * k + 3]);
  }
  if (E.wf) {  // the final rows' terms: exact products, float32 sums, i ascending
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (p.n_out > 1) {
        fs[0] = fmaf(wb[k].x, v[4 * k + 1], fmaf(wa[k].x, v[4 * k], fs[0]));
        fs[1] = fmaf(wb[k].x, v[4 * k + 3], fmaf(wa[k].x, v[4 * k + 2], fs[1]));
        fs[2] = fmaf(wb[k].y, v[4 * k + 1], fmaf(wa[k].y, v[4 * k], fs[2]));
        fs[3] = fmaf(wb[k].y, v[4 * k + 3], fmaf(wa[k].y, v[4 * k + 2], fs[3]));
      } else {
        fs[0] = fmaf(wa[k].y, v[4 * k + 1], fmaf(wa[k].x, v[4 * k], fs[0]));
        fs[1] = fmaf(wa[k].y, v[4 * k + 3], fmaf(wa[k].x, v[4 * k + 2], fs[1]));
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 48; ++j) acc[j] = acc[j + 16];
}

// Into L1, the lines a group's epilogue will read (its 128 units of the
// bias rows of the block's scenes and of the final layer's weights),
// spread over the warpgroup's threads (t): issued when the group's product
// starts, so that its slices, which each read new 32-byte sectors of them,
// find them there rather than in L2.
__device__ __forceinline__ void fb_prefetch(const FbArgs& p, int l, int g, int first, int t) {
  const FbLayer& L = p.layers[l];
  const int s0 = L.scene_bias ? min(first, p.m - 1) / p.nps : 0;
  const int s1 = L.scene_bias ? min(first + FB_P - 1, p.m - 1) / p.nps : 0;
  const int br = s1 - s0 + 1;
  const int lines = 4 * br + (l == p.hidden - 1 ? 4 * p.n_out : 0);  // 128 floats: 4 lines
  for (int k = t; k < lines; k += 128) {
    const int r = k >> 2, q = 32 * (k & 3) + 128 * g;
    const float* a = r < br ? L.b + (size_t)(s0 + r) * L.out_pad + q
                            : p.wf + (size_t)128 * g * p.n_out + 32 * (k - 4 * br);
    asm volatile("prefetch.global.L1 [%0];" :: "l"(a));
  }
}

// Before a group's first slice: where an earlier layer wrote the same rows
// of the buffer, wait until their store has read them.
__device__ __forceinline__ void fb_drain_wait(const FbArgs& p, int l, int g, uint64_t* drained) {
  const int ph = p.layers[l].phase;
  if ((ph >> (4 + g)) & 1) cb_wait(&drained[(l & 1) * 4 + g], ((ph >> g) & 1) ^ 1);
}

// After a group's last slice: its rows are published (ready) to the
// products and the stores; on the last hidden layer its final-row sums,
// over the quad, go to fin.
__device__ __forceinline__ void fb_finish(const FbArgs& p, int l, int g, float (&fs)[4],
                                          float* fin, uint64_t* ready, int p0, int t4) {
  tc_fence_proxy_async();  // the rows for wgmma and the TMA stores
  cb_arrive(&ready[(l & 1) * 4 + g]);
  if (l == p.hidden - 1) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      fs[k] += __shfl_xor_sync(0xffffffffu, fs[k], 1);
      fs[k] += __shfl_xor_sync(0xffffffffu, fs[k], 2);
    }
    if (t4 == 0) {
      for (int r = 0; r < p.n_out; ++r) {
        fin[(g * 2 + r) * FB_P + p0] = fs[2 * r];
        fin[(g * 2 + r) * FB_P + p0 + 8] = fs[2 * r + 1];
      }
    }
  }
}

// A weight producer (one thread) for warpgroup w's ring: every k step's
// tile of every item (layer l, group g = w, w + 2, ...) of that warpgroup
// in its order (W's, then X's), this block's piece multicast to the cluster; then
// the last slots' releases, so that no block of the cluster arrives here
// after this block has left.
__device__ void fb_produce(const FbArgs& p, int w, uint8_t* ring, uint64_t* full,
                           uint64_t* empty, int rank, int cs, FbClock& clk) {
  const uint8_t* tiles = reinterpret_cast<const uint8_t*>(p.tiles);
  const int piece = FB_TILE / cs;
  int s = 0;
  clk.skip();
  const uint8_t* xtiles = reinterpret_cast<const uint8_t*>(p.xtiles);
  for (int l = 0; l < p.hidden; ++l) {
    const FbLayer& L = p.layers[l];
    const int groups = L.out_pad / 128, w_steps = L.in_pad / 16;
    for (int g = w; g < groups; g += 2) {
      for (int st = 0; st < w_steps + L.x_steps; ++st, ++s) {
        const int slot = s % FB_SLOTS;
        if (s >= FB_SLOTS) tc_mbar_wait(&empty[slot], ((s / FB_SLOTS) - 1) & 1);
        clk.tick(FB_PHASES);
        const uint8_t* src =
            st < w_steps ? tiles + ((size_t)L.tile0 + (size_t)st * groups + g) * FB_TILE
                         : xtiles + ((size_t)L.xtile0 + (size_t)(st - w_steps) * groups + g)
                                        * FB_TILE;
        tc_mbar_expect_tx(&full[slot], FB_TILE);
        cb_bulk_load(tc_smem(ring + slot * FB_TILE + rank * piece), src + rank * piece, piece,
                     &full[slot], cs);
      }
    }
  }
  for (int k = s > FB_SLOTS ? s - FB_SLOTS : 0; k < s; ++k)
    tc_mbar_wait(&empty[k % FB_SLOTS], (k / FB_SLOTS) & 1);
  clk.tick(FB_PHASES);
}

// The store threads (t = 0 .. 63, warps 10-11): each (layer, group)'s rows,
// once ready, to the residual: one TMA tensor store by thread 0 (bulk), or
// copied 8 bytes at a time by all 64; then the rows' drained barrier.
__device__ void fb_store(const FbMaps& maps, const FbArgs& p, const uint8_t* sm,
                         uint64_t* ready, uint64_t* drained, int first, int t, FbClock& clk) {
  const int valid = max(0, min(FB_P, p.m - first));  // points of this block
  if (p.bulk && t > 0) return;
  for (int l = 0; l < p.hidden; ++l) {
    const FbLayer& L = p.layers[l];
    const uint8_t* buf = sm + (l & 1) * FB_BUF;
    for (int g = 0; g < L.out_pad / 128; ++g) {
      tc_mbar_wait(&ready[(l & 1) * 4 + g], (L.phase >> g) & 1);
      clk.skip();
      if (p.bulk) {
        if (valid > 0) {
          asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];"
                       :: "l"(reinterpret_cast<uint64_t>(&maps.act[l])),
                          "r"(tc_smem(buf + g * 128 * 128)), "r"(first), "r"(128 * g)
                       : "memory");
          asm volatile("cp.async.bulk.commit_group;" ::: "memory");
          clk.skip();
          asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
          clk.tick(FB_PHASES + 1);
        }
        cb_arrive(&drained[(l & 1) * 4 + g]);
      } else {
        for (int u = t; u < 128 * 16; u += 64) {  // row r, 4 points from 4 q
          const int r = u >> 4, q = u & 15, o = 128 * g + r;
          if (4 * q < valid)
            *reinterpret_cast<uint2*>(L.act + (size_t)o * p.m + first + 4 * q) =
                *reinterpret_cast<const uint2*>(buf + fb_off(o, 4 * q));
        }
        asm volatile("bar.sync 2, 64;" ::: "memory");  // every row is out
        if (t == 0) cb_arrive(&drained[(l & 1) * 4 + g]);
      }
    }
  }
  if (p.bulk) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// Threads 0-255: the consumer warpgroups (products, epilogues, the final
// rows); 256-383: the producer warpgroup (warps 8 and 9: the two rings'
// producers; warps 10-11: the stores).
__global__ void __launch_bounds__(FB_THREADS, 1)
train_fwd_bf16_kernel(const __grid_constant__ FbMaps maps, const FbArgs p) {
  extern __shared__ uint8_t fb_raw[];
  uint8_t* sm = fb_raw + ((1024 - (tc_smem(fb_raw) & 1023)) & 1023);  // the swizzle's 1 KB atoms
  float* fin = reinterpret_cast<float*>(sm + FB_OFF_FIN);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + FB_OFF_BAR);
  uint64_t* ready = bars + 4 * FB_SLOTS;  // [buffer][group]
  uint64_t* drained = ready + 8;          // [buffer][group]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cs = cb_cluster_size(), rank = wb_cluster_rank();
  const int first = blockIdx.x * FB_P;
  FbClock clk;
  if (tid == 0) {
    for (int i = 0; i < 2 * FB_SLOTS; ++i) {
      tc_mbar_init(bars + i, 1);                   // full: the producer's expect_tx
      tc_mbar_init(bars + 2 * FB_SLOTS + i, cs);   // empty: the warpgroup of every block
    }
    for (int i = 0; i < 8; ++i) {
      tc_mbar_init(ready + i, 128);  // the owning warpgroup's threads
      tc_mbar_init(drained + i, 1);  // the store thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  wb_cluster_sync();  // every block's barriers are set before a copy or an arrival reaches them

  if (warp >= 8) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (warp < 10) {
      if (lane == 0) {
        const int w = warp - 8;
        fb_produce(p, w, sm + FB_OFF_RING + w * FB_SLOTS * FB_TILE, bars + w * FB_SLOTS,
                   bars + 2 * FB_SLOTS + w * FB_SLOTS, rank, cs, clk);
        clk.flush(w == 0, FB_PHASES, FB_PHASES + 1);
      }
    } else {
      fb_store(maps, p, sm, ready, drained, first, tid - 320, clk);
      clk.flush(tid == 320, FB_PHASES + 1, FB_PHASES + 2);
    }
    return;
  }

  // the consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  // the warpgroup's index broadcast from lane 0, so that the compiler knows
  // it uniform over each warp (the products' paths branch on it)
  const int wg = __shfl_sync(0xffffffffu, warp >> 2, 0);
  const int wt = tid & 127, t4 = lane & 3;
  const int p0 = 16 * (warp & 3) + (lane >> 2);  // this thread's points: p0, p0 + 8
  // their scenes (points past M take the last one's)
  const int sa = min(first + p0, p.m - 1) / p.nps, sb = min(first + p0 + 8, p.m - 1) / p.nps;
  const uint8_t* ring = sm + FB_OFF_RING + wg * FB_SLOTS * FB_TILE;
  uint64_t* full = bars + wg * FB_SLOTS;
  uint64_t* empty = bars + 2 * FB_SLOTS + wg * FB_SLOTS;
  // the embedding's rows (bf16 values, zeros past e and past M) as the A
  // operand of the X terms' k steps
  const int e16 = (p.e + 15) / 16 * 16;
  uint8_t* emb_a = sm + FB_OFF_EMB;
  for (int i = tid; i < e16 * FB_P; i += 256) {
    const int c = i / FB_P, pt = i % FB_P;
    const float v = c < p.e && first + pt < p.m ? __ldg(p.emb + (size_t)c * p.m + first + pt) : 0.f;
    fb_put(emb_a, c, pt, v);
  }
  tc_fence_proxy_async();
  cb_bar_consumers();
  clk.tick(0);

  float acc[64], prev[64];  // the running product; the group whose epilogue is pending
  int pl = -1, pg = 0;      // that group's layer (-1: none) and index
  int s = 0;                // ring slots taken
  // the items (layer l, group g = wg, wg + 2, ...) in order, then one past
  // the last layer that only flushes the pending epilogue
  for (int l = 0; l <= p.hidden; ++l) {
    const int groups = l < p.hidden ? p.layers[l].out_pad / 128 : wg + 1;
    for (int g = wg; g < groups; g += 2) {
      const int w_steps = l < p.hidden ? p.layers[l].in_pad / 16 : 0;
      const int steps = l < p.hidden ? w_steps + p.layers[l].x_steps : 0;
      // the pending epilogue runs under this product where the product
      // reads none of its rows before its 16th k step; else on its own
      const bool under = pl >= 0 && steps >= 16 && (pl == l || (pl == l - 1 && pg >= 2));
      if (pl >= 0 && !under) {
        fb_drain_wait(p, pl, pg, drained);
        clk.tick(4);
        FbEpi E = fb_epi(p, sm, pl, pg, first, p0, t4, sa, sb);
        float fs[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 1
        for (int q = 0; q < 4; ++q) fb_slice(p, prev, q, E, fs, p0);
        fb_finish(p, pl, pg, fs, fin, ready, p0, t4);
        clk.tick(2);
        pl = -1;
      }
      if (l == p.hidden) break;
      FbEpi E;
      float fs[4] = {0.f, 0.f, 0.f, 0.f};
      if (under) {
        fb_drain_wait(p, pl, pg, drained);
        clk.tick(4);
        E = fb_epi(p, sm, pl, pg, first, p0, t4, sa, sb);
      }
      fb_prefetch(p, l, g, first, wt);  // for this group's epilogue, after the product
      // k steps: W's over the previous layer's rows, then X's over the embedding's
      const uint32_t a_in = tc_smem(sm + ((l - 1) & 1) * FB_BUF);
      const uint32_t a_emb = tc_smem(emb_a) - (uint32_t)w_steps * 2048;
      const int in_phase = l > 0 ? p.layers[l - 1].phase : 0;
      uint64_t* in_ready = ready + ((l - 1) & 1) * 4;
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      for (int st0 = 0; st0 < steps; st0 += 4) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int st = st0 + u;
          if (st < steps) {
            if (st < w_steps && (st & 7) == 0) {  // the first k step over a group of the input
              cb_wait(&in_ready[st >> 3], (in_phase >> (st >> 3)) & 1);
              clk.tick(3);
            }
            const int slot = s % FB_SLOTS;
            cb_wait(&full[slot], (s / FB_SLOTS) & 1);
            tc_wgmma_fence();
            if (!(FW_PROBE & 1))
              fb_wgmma(acc, fb_desc_a((st < w_steps ? a_in : a_emb) + st * 2048),
                       tc_desc(reinterpret_cast<const float*>(ring + slot * FB_TILE)));
            tc_wgmma_commit();
            if (st > 0) {
              cb_wgmma_wait1();  // the step before is done: its slot is free
              cb_release(&empty[(s - 1) % FB_SLOTS], cs, wt);
            }
            ++s;
            clk.tick(1);
            if (u == 3 && under && st < 16) {  // a quarter of the pending epilogue
              fb_slice(p, prev, st >> 2, E, fs, p0);
              if (st == 15) fb_finish(p, pl, pg, fs, fin, ready, p0, t4);
              clk.tick(2);
            }
          }
        }
      }
      tc_wgmma_wait();
      tc_fence_acc(acc);
      cb_release(&empty[(s - 1) % FB_SLOTS], cs, wt);
      clk.tick(1);
#pragma unroll
      for (int i = 0; i < 64; ++i) prev[i] = acc[i];
      pl = l;
      pg = g;
    }
  }

  // the final rows: the groups' sums in group order, the latent_in final
  // layer's terms, the bias, tanh
  cb_bar_consumers();
  if (tid < p.n_out * FB_P) {
    const int r = tid / FB_P, pt = tid % FB_P;
    const int groups = p.layers[p.hidden - 1].out_pad / 128;
    float v = 0.f;
    for (int g = 0; g < groups; ++g) v += fin[(g * 2 + r) * FB_P + pt];
    if (first + pt < p.m) {
      for (int c = 0; p.fx && c < p.e; ++c)
        v = fmaf(__ldg(p.fx + (size_t)c * p.n_out + r), __ldg(p.emb + (size_t)c * p.m + first + pt),
                 v);
      const float bias = p.f_scene_bias
                             ? __ldg(p.fb + (size_t)((first + pt) / p.nps) * p.n_out + r)
                             : __ldg(p.fb + r);
      p.y[(size_t)r * p.m + first + pt] = tanhf(v + bias);
    }
  }
  clk.tick(5);
  clk.flush(tid == 0);
}

// Host: checks the arguments, sets each layer's tile offset and barrier
// phases, the copy route and the residuals' tensor maps, and launches the
// kernel in clusters of FB_CLUSTER; with `plan` (FB_PLAN_INTS: shared
// memory bytes, points a block, cluster, grid blocks, blocks with points,
// ring slots a warpgroup, bulk) launches nothing.  0, -1 for arguments the
// kernel does not take, a WB_ERR_* code or a CUDA error.  a.layers[l]:
// hidden out_pad a multiple of 128 up to FB_MAX_OUT, layer 0 without W
// (in_pad 0) and with X, each later one reading the one before; the tiles
// hold each hidden layer l >= 1's tile_weights(W_l, bf16) in layer order
// (the caller checks their count).
static int launch_fwd_bf16(FbArgs a, cudaStream_t stream, int* plan = nullptr) {
  if (a.hidden < 1 || a.hidden > FB_MAX_HIDDEN || a.n_out < 1 || a.n_out > 2) return -1;
  if (a.e < 1 || a.e > FB_EMB_MAX || a.m <= 0 || a.m % 4 || a.nps <= 0 || a.m % a.nps) return -1;
  if (!a.emb || !a.y || !a.wf || !a.fb || (a.hidden > 1 && !a.tiles)) return -1;
  if (!a.xtiles) return -1;  // layer 0's X at least
  bool aligned = a.m % 8 == 0;
  int tiles = 0, xtiles = 0, prev = 0;
  for (int l = 0; l < a.hidden; ++l) {
    FbLayer& L = a.layers[l];
    if (L.out_pad < 128 || L.out_pad % 128 || L.out_pad > FB_MAX_OUT || !L.act || !L.b) return -1;
    if (l == 0 ? (L.in_pad != 0 || !L.x) : L.in_pad != prev) return -1;
    if ((L.x && (uintptr_t)L.x % 8) || (uintptr_t)L.b % 8 || (uintptr_t)L.act % 8) return -1;
    aligned = aligned && (uintptr_t)L.act % 16 == 0;
    L.tile0 = tiles;
    if (l > 0) tiles += L.in_pad / 16 * (L.out_pad / 128);
    L.xtile0 = xtiles;
    L.x_steps = L.x ? (a.e + 15) / 16 : 0;
    xtiles += L.x_steps * (L.out_pad / 128);
    // the phases of (buffer l % 2, group g): one a layer of that buffer with that group
    L.phase = 0;
    for (int g = 0; g < L.out_pad / 128; ++g) {
      int k = 0;
      for (int j = l % 2; j < l; j += 2) k += a.layers[j].out_pad / 128 > g;
      L.phase |= (k & 1) << g | (k > 0) << (4 + g);
    }
    prev = L.out_pad;
  }
  if ((uintptr_t)a.wf % 8) return -1;
  a.bulk = aligned;
  const int blocks = (a.m + FB_P - 1) / FB_P;
  const unsigned grid = (unsigned)((blocks + FB_CLUSTER - 1) / FB_CLUSTER * FB_CLUSTER);
  if (plan) {
    const int v[FB_PLAN_INTS] = {FB_SMEM, FB_P, FB_CLUSTER, (int)grid, blocks, FB_SLOTS, a.bulk};
    memcpy(plan, v, sizeof v);
    return 0;
  }
  FbMaps maps;
  memset(&maps, 0, sizeof maps);
  for (int l = 0; a.bulk && l < a.hidden; ++l) {
    const int rc = wb_map(&maps.act[l], a.layers[l].act, a.layers[l].out_pad, a.m, 128);
    if (rc) return rc;
  }
  static bool ready = false;
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        train_fwd_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, FB_SMEM);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = FB_CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(FB_THREADS);
  cfg.dynamicSmemBytes = FB_SMEM;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  void* args[] = {&maps, &a};
  const cudaError_t err = cudaLaunchKernelExC(&cfg, (const void*)train_fwd_bf16_kernel, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
