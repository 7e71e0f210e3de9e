// The bf16 grid trunk on Hopper: K1's grid decoder (grid_bf16_kernel in
// grid_decoder.cu) and K6's generic decoder (generic_bf16_kernel in
// generic_decoder.cu) on bf16 plans, one body (gb_body) instantiated without
// and with per-point input rows.  K3's bf16 plans are to move here next, on
// the same input rows (its sampled latent for K6's x0).
//
// K1 replaces alignsdf_tpu/ops/decoder_kernel.py:make_fused_grid_kernel_t
// (:496, its pallas_call :673) with dtype bfloat16 (make_fused_grid_decode_fn
// :693), and its points-major sibling make_fused_grid_kernel (:381) at 2 + C
// rows.  For a run of m linear grid indices from `base` (z fastest) each
// point's xyz comes from the int32 index arithmetic (:633-638: p // n^2 % n,
// p // n % n, p % n, times the voxel, plus the origin); then per hidden layer
// a = bf16(relu(b + a_prev W + X xyz)) (bf16 products summed in float32; the
// bias and the xyz terms float32 on bf16-rounded weights; layer 0 has no
// product, its input folded on the host); then rows 0-1 = tanh(the trunks'
// final rows summed + fin_xyz xyz + bias) and rows 2 .. = the class logits
// (the first trunk's), without tanh.  grid_decode_reference on the same plan
// is the plain version.
//
// K6 replaces decoder_kernel.py:make_fused_decoder (:139, its pallas_call
// :210) with dtype bfloat16 (make_pallas_decode_fn :1438): each trunk reads a
// per-point input row x0 (the materialized [latent, embedding] row, bf16, any
// row stride); layer 0 is a = bf16(relu(b + x0 W_in)), a latent_in layer a =
// bf16(relu(b + a_prev W + x0 W_in)), no xyz terms, and a latent_in final
// layer (fin_lat) adds x0 W_in to the final rows (the class rows' W_in is
// zero).  generic_decode_reference is its plain version.
//
// What bounds them: operations.  K1's flagship trunk (512 -> 250 -> 512 ->
// 512 -> 1, hidden padded to 128) costs ~0.52 M multiply-adds a point, 4.38
// TFLOP a 128^3 pass of both trunks: 4.42 ms at the card's dense bf16 989.4
// TFLOP/s.  K6's at --point_size 63 (x0 319 wide, 512 -> 193 -> [193 + 319]
// -> 512 -> 512 -> 1) costs 786,944 (806,912 with its widths padded to 16):
// 6.60 TFLOP, 6.67 ms.  The weights stream from L2: each tile read serves the
// points of a cluster (below).  As measured on K1 (PERF.md,
// tools/time_grid_kernels.py --bf16 --probes) the products alone take ~1.2x
// the bound; the ring's round trip and the epilogues on the CUDA cores more
// than double it.
//
// The design:
//  (a) 128 points a block, 64 a consumer warpgroup: warpgroup w owns its
//    64 points and all of a layer's outputs for them, and both warpgroups
//    read each weight tile from the same ring slot.  A layer's outputs run
//    in halves of up to GB_HALF = 256, the last half first, each written in
//    place over the layer's input; a half of W outputs is one wgmma a k step
//    (m64nWk16, W / 2 accumulators; K1's W is 256 or 128, K6's any multiple
//    of 16: it pads its widths to 16, so --point_size 63's 193 outputs are
//    one m64n208k16, where 256 would cost 23% more).  Where the rows a layer
//    reads (its activation, then its staged input rows) end at or below 256,
//    the last half's rows lie past them and are written at once; where they
//    reach further (512 -> 512, and K6's layer 0 and latent_in layer) that
//    half goes to the warpgroup's 32 KB of scratch in device memory (L2),
//    each thread's packed results in coalesced 16-byte stores, and each
//    thread reads its own back into the rows once the first half's products
//    are past the input (a bulk copy back would need a proxy fence after the
//    stores).  Holding it in registers, 64 more a thread, spilled: ptxas
//    allocates a 384-thread block's code at most 168 registers a thread,
//    setmaxnreg or not.
//  (b) A from shared memory in bf16.  A warpgroup's activations are one 64
//    KB operand: K-major with the 128-byte swizzle, point p's 64 features
//    of a block of 64 in one 128-byte row (chain_bf16_tc.cuh's dpre
//    layout), 8 such blocks, 512 rows; a k step is a descriptor 32 bytes on.
//    The epilogue writes it with stmatrix (four 8 x 8 bf16 matrices an
//    instruction, the accumulators' own fragments), without bank conflicts.
//  (c) Input rows as k steps of their own (K6).  A layer that reads x0 runs
//    its activation's k steps against the half's W tiles, then x0's against
//    its W_in tiles, one accumulation.  gb_fill writes x0's first columns,
//    bf16, into the rows above the layer's activation in the same layout
//    (each warp a point at a time, its lanes along the row: a row's aligned
//    words loaded at once, any row stride and alignment, the rows two on
//    prefetched into L1 and the next tile's into L2; one swizzled 128-byte
//    line a store), between warpgroup-local barriers: for layer 0 over rows
//    the trunk before's final rows read, for a later layer (and fin_lat)
//    right after the layer before's last epilogue, over rows that layer has
//    finished reading.  Measured on an H100 (PERF.md): a fill that waited
//    for each load before the next took 0.31 of warpgroup 0's cycles, and a
//    latent_in layer's fill spread under its first half's activation k steps
//    ran 3.3 ms a pass slower than this (its state in the product loop
//    spilled).  The buffer holds 512 rows; the x0 steps that do not
//    fit above the activation run as wgmma with A from registers, each
//    thread's fragment (4 registers: 8 bf16 of its two points) loaded from
//    device memory, their lines prefetched into L1 by the fill.  That is the
//    answer to --point_size 63's layer 2: a_1 (208 rows) and x0 (320) are
//    528 rows, and both halves of its 512 outputs read every k step, so no
//    row is dead before the layer's last product: 19 of x0's 20 steps read
//    the buffer, one reads registers (in each half; the step waits for its
//    product before its registers are reused).  Restaging rows per half
//    would put a warpgroup barrier, a fence and a drained product pipeline
//    twice in each half; an overflow region needs shared memory the ring
//    would have to give up (1,856 bytes are left).  The same path takes any
//    width: rows wider than the buffer (layer 0 at 512 + 63) and a
//    fin_lat's x0 above a 512-row last activation run their last steps, or
//    all of them, from registers.
//  (d) A producer and a pipeline.  One thread of the third warpgroup
//    streams every item of the plan through a ring of GB_SLOTS 8 KB slots
//    with full and empty mbarriers: a half's k-step tiles (W's, then W_in's;
//    up to 256 x 16 bf16, K-major core matrices, the plan's own layout), its
//    epilogue block (the bias, and K1's bf16-rounded xyz weights, float32),
//    the final rows' tiles (then fin_lat's), in the order the consumers read
//    them; setmaxnreg gives the producer warpgroup's registers to the
//    consumers.  A consumer keeps one product in flight (wgmma.wait_group 1)
//    and releases each slot once past it.  Blocks run in clusters of
//    GB_CLUSTER = 2: each block loads half of every item and multicasts it,
//    so each read from L2 serves 256 points, and a slot is refilled once
//    both warpgroups of every block released it.
//  (e) No ping-pong.  The epilogues (bias, xyz terms, ReLU, rounding, the
//    write) run on the CUDA cores, and the two warpgroups run theirs as
//    they come, with no order between them.  A pair of named barriers that
//    put each warpgroup's epilogue work under the other's products was
//    measured on an H100 at ~4 ms a 128^3 pass slower on K1 (PERF.md): both
//    warpgroups read every slot, so the lag it keeps between them takes
//    ring slots from the leader's prefetch, and an epilogue run outlasts
//    the ring's 12 k steps.
//  (f) The final rows as one more product: fin (bf16) over the last
//    activation (and fin_lat over x0) on wgmma.m64nNFk16, NF = 8 ceil(rows
//    / 8) to a power of two (<= 128; the second trunk 8), several k steps an
//    item; a short epilogue adds fin_xyz's terms (K1), sums the SDF rows
//    over the trunks in registers, writes the class rows with their bias and
//    rows 0-1 with bias and tanh.
//  (g) Persistent blocks.  One cluster an SM pair, as many as fit; cluster c
//    walks the launch's tiles of GB_CLUSTER x 128 points c, c + clusters,
//    ... (its blocks one 128 each), the ring running on across tiles, points
//    past m clamped (K6: their rows read as row m - 1) and not written.
//
// Accuracy: the plain versions' roundings (products of bf16 values exact,
// float32 sums in the tensor cores' order).
//
// Shared memory (bytes, from a 1 KB-aligned base): the two warpgroups'
// activations 2 x 65,536 (K6's staged input rows among them); the ring 12 x
// 8,192 = 98,304; 24 mbarriers 192; 1,024 of alignment: 230,592 of 232,448.
// Registers: a consumer holds 128 accumulators (ptxas's 168 a thread); the
// producer warpgroup gives its registers up (setmaxnreg 40).  Scratch:
// GB_SCRATCH (32 KB) a warpgroup of the grid, the wrapper's.
//
// GB_PROBE (0 in the package's build; tools/time_grid_kernels.py --bf16
// --probes builds copies): 32 clocks the phases: thread 0 of warpgroup 0
// adds each phase's cycles (products with their ring waits and register
// steps, epilogues' arithmetic and writes, final rows, set-up, the
// epilogues' waits for their item, their barriers and scratch reloads, the
// input-row fills with their barriers) and the producer its waits for a
// free slot, into gb_cycles.  The other bits leave parts out (their results
// are wrong): 1 the products' wgmma, 2 the epilogues' arithmetic and writes
// (but one, which keeps the products), 8 the ring (no loads, no waits for a
// slot or its release), 16 the input-row fills.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "chain_bf16_tc.cuh"  // the cluster's loads and releases, cb_wait, cb_wgmma_wait1
#include "wgrad_bf16_tc.cuh"  // wb_cluster_rank, wb_cluster_sync, WB_ERR_CLUSTER

#ifndef GB_PROBE
#define GB_PROBE 0
#endif
#ifndef GB_CLUSTER
#define GB_CLUSTER 2        // blocks a cluster (the tool's probes build 1 and 4)
#endif

#define GB_P 128            // points a block
#define GB_WP 64            // points a consumer warpgroup: wgmma's M
#define GB_THREADS 384      // consumer warpgroups 0 and 1, then the producer's
#define GB_HALF 256         // outputs a product: wgmma's N
#define GB_MAX_OUT 512      // also the rows of a warpgroup's activations
#define GB_MAX_TRUNKS 2
#define GB_MAX_HIDDEN 8
#define GB_MAX_ROWS 128     // 2 SDF rows + 126 classes
#define GB_BUF 65536        // a warpgroup's activations: 512 features x 64 points, bf16
#define GB_SLOT 8192        // bytes of a ring slot: a 256 x 16 bf16 tile
#define GB_SLOTS 12
#define GB_OFF_RING (2 * GB_BUF)
#define GB_OFF_BAR (GB_OFF_RING + GB_SLOTS * GB_SLOT)
#define GB_SMEM (GB_OFF_BAR + 8 * 2 * GB_SLOTS + 1024)
#define GB_SCRATCH 32768    // a warpgroup's scratch: half of a layer's outputs
#define GB_PLAN_INTS 7

// products, epilogues, final rows, set-up, epilogue item waits, epilogue
// barriers and reloads, input-row fills; then the producer's slot waits
#define GB_PHASES 7
#if GB_PROBE & 32
__device__ unsigned long long gb_cycles[GB_PHASES + 1];
extern "C" int gb_read_cycles(unsigned long long* out) {
  const cudaError_t err = cudaMemcpyFromSymbol(out, gb_cycles, sizeof(gb_cycles));
  const unsigned long long zero[GB_PHASES + 1] = {};
  return err != cudaSuccess ? (int)err : (int)cudaMemcpyToSymbol(gb_cycles, zero, sizeof(zero));
}
#endif
struct GbClock {
  long long last, acc[GB_PHASES + 1];
  __device__ __forceinline__ GbClock() {
    if (GB_PROBE & 32) {
      last = clock64();
      for (int i = 0; i < GB_PHASES + 1; ++i) acc[i] = 0;
    }
  }
  __device__ __forceinline__ void tick(int ph) {
    if (GB_PROBE & 32) {
      const long long now = clock64();
      acc[ph] += now - last;
      last = now;
    }
  }
  __device__ __forceinline__ void flush(bool on, int lo, int hi) const {
#if GB_PROBE & 32
    if (on)
      for (int i = lo; i < hi; ++i)
        if (acc[i]) atomicAdd(&gb_cycles[i], (unsigned long long)acc[i]);
#endif
  }
};

// lat: the layer reads the input rows (K6)
struct GbLayer { int in_pad, out_pad, has_x, lat; };
// stream: the float offset of the trunk's items (its layer 0's first item);
// rows: the output rows it writes (n_rows for the first trunk, the SDF rows
// for the second); nf: its final rows' product width; fin_lat: its final
// rows read the input rows too (K6)
struct GbTrunk {
  int n_hidden, stream, fin_xyz, last_pad, rows, nf, fin_lat;
  GbLayer layers[GB_MAX_HIDDEN];
};
// lat_pad: K6's input rows padded to 16 (0 for K1)
struct GbPlan {
  int n_trunks, fin_b, n_rows, n, base, m, ctiles, lat_pad;
  GbTrunk trunks[GB_MAX_TRUNKS];
};
// K6's input rows: per trunk bf16 rows of `in` columns, row stride ld
struct GbRows {
  const __nv_bfloat16* x[GB_MAX_TRUNKS];
  long long ld[GB_MAX_TRUNKS];
  int in[GB_MAX_TRUNKS];
};

// The plan's items, in stream order: per layer and half (outputs 256 h ..,
// the last half first), the half's k-step tiles (W's, layers >= 1; then
// W_in's, a layer that reads the input rows), then its epilogue block; then
// the final rows' tiles (then fin_lat's), gb_fin_steps of them an item.
__host__ __device__ inline int gb_width(int out_pad, int h) {
  return out_pad - GB_HALF * h < GB_HALF ? out_pad - GB_HALF * h : GB_HALF;
}
__host__ __device__ inline int gb_epi_floats(int width, int has_x) {
  return width * (has_x ? 4 : 1);  // the bias, then X's x, y and z rows
}
__host__ __device__ inline int gb_fin_steps(int nf) { return GB_SLOT / (nf * 32); }
__host__ __device__ inline int gb_fin_width(int rows) {
  int nf = 8;
  while (nf < rows) nf *= 2;
  return nf;
}
// k steps of the input rows a layer (or the final rows) reads
__host__ __device__ inline int gb_lat_steps(int lat, int lat_pad) { return lat ? lat_pad / 16 : 0; }
// the input rows staged above an activation of in_pad rows: what the buffer holds
__host__ __device__ inline int gb_staged(int in_pad, int lat_pad) {
  return lat_pad < GB_MAX_OUT - in_pad ? lat_pad : GB_MAX_OUT - in_pad;
}

// ---- wgmma ----------------------------------------------------------------

// d[0 .. N / 2) (+)= A (64 x 16: K-major with the 128-byte swizzle at
// descriptor da, or this thread's fragment a in registers) x B^T (N x 16,
// K-major core matrices at descriptor db); scale_d 0: d = A B^T.  N: 8, or a
// multiple of 16 up to 256.  d[4i + r]: point 16 warp + lane/4 (+ 8 for r >=
// 2), output 8i + 2 (lane%4) (+ 1 for odd r).  A fragment (registers): a[0] =
// (point 16 warp + lane/4, k 2 (lane%4) and + 1), a[1] the point + 8, a[2]
// and a[3] the same at k + 8, the lower k in each register's low half.
// GB_Lk: the operand list of k accumulators; GB_Fk: their constraints.
#define GB_L4 "%0, %1, %2, %3"
#define GB_F4 "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
#define GB_L8 GB_L4 ", %4, %5, %6, %7"
#define GB_F8 GB_F4, "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
#define GB_L16 GB_L8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define GB_F16 \
  GB_F8, "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
  "+f"(d[14]), "+f"(d[15])
#define GB_L24 GB_L16 ", %16, %17, %18, %19, %20, %21, %22, %23"
#define GB_F24 \
  GB_F16, "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), \
  "+f"(d[22]), "+f"(d[23])
#define GB_L32 GB_L24 ", %24, %25, %26, %27, %28, %29, %30, %31"
#define GB_F32 \
  GB_F24, "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
  "+f"(d[30]), "+f"(d[31])
#define GB_L40 GB_L32 ", %32, %33, %34, %35, %36, %37, %38, %39"
#define GB_F40 \
  GB_F32, "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), \
  "+f"(d[38]), "+f"(d[39])
#define GB_L48 GB_L40 ", %40, %41, %42, %43, %44, %45, %46, %47"
#define GB_F48 \
  GB_F40, "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), \
  "+f"(d[46]), "+f"(d[47])
#define GB_L56 GB_L48 ", %48, %49, %50, %51, %52, %53, %54, %55"
#define GB_F56 \
  GB_F48, "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), \
  "+f"(d[54]), "+f"(d[55])
#define GB_L64 GB_L56 ", %56, %57, %58, %59, %60, %61, %62, %63"
#define GB_F64 \
  GB_F56, "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), \
  "+f"(d[62]), "+f"(d[63])
#define GB_L72 GB_L64 ", %64, %65, %66, %67, %68, %69, %70, %71"
#define GB_F72 \
  GB_F64, "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), \
  "+f"(d[70]), "+f"(d[71])
#define GB_L80 GB_L72 ", %72, %73, %74, %75, %76, %77, %78, %79"
#define GB_F80 \
  GB_F72, "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), \
  "+f"(d[78]), "+f"(d[79])
#define GB_L88 GB_L80 ", %80, %81, %82, %83, %84, %85, %86, %87"
#define GB_F88 \
  GB_F80, "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), \
  "+f"(d[86]), "+f"(d[87])
#define GB_L96 GB_L88 ", %88, %89, %90, %91, %92, %93, %94, %95"
#define GB_F96 \
  GB_F88, "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), \
  "+f"(d[94]), "+f"(d[95])
#define GB_L104 GB_L96 ", %96, %97, %98, %99, %100, %101, %102, %103"
#define GB_F104 \
  GB_F96, "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), \
  "+f"(d[102]), "+f"(d[103])
#define GB_L112 GB_L104 ", %104, %105, %106, %107, %108, %109, %110, %111"
#define GB_F112 \
  GB_F104, "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), \
  "+f"(d[109]), "+f"(d[110]), "+f"(d[111])
#define GB_L120 GB_L112 ", %112, %113, %114, %115, %116, %117, %118, %119"
#define GB_F120 \
  GB_F112, "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), \
  "+f"(d[117]), "+f"(d[118]), "+f"(d[119])
#define GB_L128 GB_L120 ", %120, %121, %122, %123, %124, %125, %126, %127"
#define GB_F128 \
  GB_F120, "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), \
  "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
// N, the accumulators' operand list and constraints, then the operand
// numbers of A's descriptor (or A's four registers), B's descriptor and scale_d
#define GB_MMA_SS(N, LIST, OPS, A, B, P)                                                  \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #P ", 0;\n"                          \
               "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" LIST         \
               "}, %" #A ", %" #B ", p, 1, 1, 0, 0;\n}\n"                                \
               : OPS : "l"(da), "l"(db), "r"(scale_d))
#define GB_MMA_RS(N, LIST, OPS, A0, A1, A2, A3, B, P)                                     \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #P ", 0;\n"                          \
               "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" LIST         \
               "}, {%" #A0 ", %" #A1 ", %" #A2 ", %" #A3 "}, %" #B ", p, 1, 1, 0;\n}\n"  \
               : OPS : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))
#define GB_MMA(N, K, A1, A2, A3, A4, A5)                                         \
  if constexpr (N == N_) {                                                       \
    if constexpr (kReg)                                                          \
      GB_MMA_RS(N, GB_L##K, GB_F##K, K, A1, A2, A3, A4, A5);                     \
    else                                                                         \
      GB_MMA_SS(N, GB_L##K, GB_F##K, K, A1, A2);                                 \
  }

template <int N_, bool kReg>
__device__ __forceinline__ void gb_wgmma(float (&d)[128], uint64_t da, const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  static_assert(N_ == 8 || (N_ % 16 == 0 && N_ >= 16 && N_ <= 256), "wgmma's N");
  GB_MMA(8, 4, 5, 6, 7, 8, 9)
  GB_MMA(16, 8, 9, 10, 11, 12, 13)
  GB_MMA(32, 16, 17, 18, 19, 20, 21)
  GB_MMA(48, 24, 25, 26, 27, 28, 29)
  GB_MMA(64, 32, 33, 34, 35, 36, 37)
  GB_MMA(80, 40, 41, 42, 43, 44, 45)
  GB_MMA(96, 48, 49, 50, 51, 52, 53)
  GB_MMA(112, 56, 57, 58, 59, 60, 61)
  GB_MMA(128, 64, 65, 66, 67, 68, 69)
  GB_MMA(144, 72, 73, 74, 75, 76, 77)
  GB_MMA(160, 80, 81, 82, 83, 84, 85)
  GB_MMA(176, 88, 89, 90, 91, 92, 93)
  GB_MMA(192, 96, 97, 98, 99, 100, 101)
  GB_MMA(208, 104, 105, 106, 107, 108, 109)
  GB_MMA(224, 112, 113, 114, 115, 116, 117)
  GB_MMA(240, 120, 121, 122, 123, 124, 125)
  GB_MMA(256, 128, 129, 130, 131, 132, 133)
}

__device__ __forceinline__ uint64_t gb_desc_a(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32)
         | ((uint64_t)1 << 62);
}
__device__ __forceinline__ uint64_t gb_desc_b(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16)
         | ((uint64_t)(256 >> 4) << 32);
}

__device__ __forceinline__ void gb_fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// a register fragment held until its product is done
__device__ __forceinline__ void gb_keep(uint32_t (&a)[4]) {
  asm volatile("" : "+r"(a[0]), "+r"(a[1]), "+r"(a[2]), "+r"(a[3]) :: "memory");
}

__device__ __forceinline__ void gb_bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(n) : "memory");
}

// (lo, hi) rounded to bf16 (to nearest, ties to even), lo in the low half
__device__ __forceinline__ uint32_t gb_pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Four 8 x 8 bf16 matrices from this thread's fragments (a: matrix 0, ...)
// to the rows whose addresses lanes 8j .. 8j + 7 give for matrix j.
__device__ __forceinline__ void gb_stmatrix4(uint32_t addr, uint32_t a, uint32_t b, uint32_t c,
                                             uint32_t d) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};"
               :: "r"(addr), "r"(a), "r"(b), "r"(c), "r"(d) : "memory");
}

// ---- K6's input rows ------------------------------------------------------

// Columns c and c + 1 of a bf16 row as a pair (c in the low half), zeros
// from column `in` on; one 4-byte load where the pair is aligned, else two.
__device__ __forceinline__ uint32_t gb_pair(const __nv_bfloat16* row, int c, int in) {
  const unsigned short* r = reinterpret_cast<const unsigned short*>(row) + c;
  if (c + 1 < in) {
    if (!(reinterpret_cast<uintptr_t>(r) & 3)) return __ldg(reinterpret_cast<const unsigned*>(r));
    return (uint32_t)__ldg(r) | ((uint32_t)__ldg(r + 1) << 16);
  }
  return c < in ? (uint32_t)__ldg(r) : 0u;
}

// Trunk t's row of point q (past m the last row)
__device__ __forceinline__ const __nv_bfloat16* gb_row(const GbRows& x, int t, int q, int m) {
  return x.x[t] + (long long)min(q, m - 1) * x.ld[t];
}

// A register step's fragment of this thread's points q and q + 8: columns c
// .. (c = the step's first + 2 (lane % 4))
__device__ __forceinline__ void gb_frag(uint32_t (&a)[4], const GbRows& x, int t, int q, int m,
                                        int c) {
  const __nv_bfloat16* r0 = gb_row(x, t, q, m);
  const __nv_bfloat16* r1 = gb_row(x, t, q + 8, m);
  a[0] = gb_pair(r0, c, x.in[t]);
  a[1] = gb_pair(r1, c, x.in[t]);
  a[2] = gb_pair(r0, c + 8, x.in[t]);
  a[3] = gb_pair(r1, c + 8, x.in[t]);
}

// The lines of a row's first `count` elements into L1 (lane k the k-th
// 64 elements', and its last element's).
__device__ __forceinline__ void gb_prefetch_row(const __nv_bfloat16* row, int count, int lane) {
  if (64 * lane < count) asm volatile("prefetch.global.L1 [%0];" :: "l"(row + 64 * lane));
  if (lane == 31 && count > 0) asm volatile("prefetch.global.L1 [%0];" :: "l"(row + count - 1));
}

// Trunk t's input columns 0 .. count - 1 (count <= 512) of the warpgroup's
// 64 points (rows first .., past m the last row) into its activation rows
// r0 .. r0 + count - 1 at buf; zeros past the trunk's width.  Warp wq takes
// points wq, wq + 4, ..., a row at a time: each lane loads its aligned
// 4-byte words of the row's blocks of 64 columns at once (up to 9 loads in
// flight, the row's lines prefetched into L1 two rows ahead), then stores a
// column pair a block; a row that starts 2 bytes past a word takes each
// pair's high half from the next lane's word.  Then this thread's columns
// past count (the register steps') prefetched into L1.
__device__ __forceinline__ void gb_fill(const GbRows& x, int t, int first, int q, int m, int count,
                                        int lat_pad, uint8_t* buf, int r0, int wq, int lane) {
  if (GB_PROBE & 16) return;
  const int in = x.in[t], lim = min(in, count), blocks = (count + 63) >> 6;
  for (int k = 0; k < 2; ++k) gb_prefetch_row(gb_row(x, t, first + wq + 4 * k, m), lim, lane);
  for (int pt = wq; pt < GB_WP; pt += 4) {
    if (pt + 8 < GB_WP) gb_prefetch_row(gb_row(x, t, first + pt + 8, m), lim, lane);
    const __nv_bfloat16* row = gb_row(x, t, first + pt, m);
    const int odd = (int)((reinterpret_cast<uintptr_t>(row) >> 1) & 1);
    // word 32 j + lane holds columns 64 j + 2 lane - odd and + 1
    const unsigned* words = reinterpret_cast<const unsigned*>(row - odd);
    uint32_t w[GB_MAX_OUT / 64 + 1];
#pragma unroll
    for (int j = 0; j <= GB_MAX_OUT / 64; ++j) {
      const bool need = (j < blocks || (j == blocks && odd && lane == 0))
                        && 64 * j + 2 * lane - odd < lim;
      w[j] = need ? __ldg(words + 32 * j + lane) : 0u;
    }
    uint8_t* line = buf + pt * 128;
#pragma unroll
    for (int j = 0; j < GB_MAX_OUT / 64; ++j) {
      if (j < blocks) {
        // the word after this lane's: the next lane's, lane 0's of the next block for lane 31
        const uint32_t next =
            __shfl_sync(0xffffffffu, lane == 0 ? w[j + 1] : w[j], (lane + 1) & 31);
        const int c = 64 * j + 2 * lane, r = r0 + c;
        uint32_t v = odd ? __byte_perm(w[j], next, 0x5432) : w[j];
        if (c + 1 >= in) v &= c < in ? 0xFFFFu : 0u;
        if (c < count)
          *reinterpret_cast<uint32_t*>(line + (r >> 6) * 8192 + (((((r & 63) >> 3) ^ pt) & 7) << 4)
                                       + (r & 7) * 2) = v;
      }
    }
  }
  const int end = min(lat_pad, in);
  for (int k = 0; k < 2 && count < end; ++k) {
    const __nv_bfloat16* row = gb_row(x, t, q + 8 * k, m);
    for (int c = count; c < end; c += 64) asm volatile("prefetch.global.L1 [%0];" :: "l"(row + c));
    asm volatile("prefetch.global.L1 [%0];" :: "l"(row + end - 1));
  }
}

// The warpgroup's rows of a later tile (from row first) into L2, for its
// fills: per trunk, each row's lines of its first min(in, lat_pad) columns.
__device__ __forceinline__ void gb_prefetch_tile(const GbRows& x, int n_trunks, int first, int m,
                                                 int lat_pad, int wt) {
  if (first >= m) return;
  for (int t = 0; t < n_trunks; ++t) {
    const int cols = min(x.in[t], lat_pad), lines = (cols + 63) / 64 + 1;
    for (int i = wt; i < GB_WP * lines; i += 128) {
      const int pt = i / lines, k = i - pt * lines;
      const __nv_bfloat16* row = x.x[t] + (long long)min(first + pt, m - 1) * x.ld[t];
      asm volatile("prefetch.global.L2 [%0];" :: "l"(row + min(64 * k, cols - 1)));
    }
  }
}

// ---- the producer -----------------------------------------------------------

// The producer (one thread): bytes from src into the ring's next slot, this
// block's piece multicast to the cluster, once every consumer of the cluster
// has released the slot's previous item.
__device__ __forceinline__ void gb_put(const uint8_t* src, int bytes, uint8_t* ring, uint64_t* full,
                                       uint64_t* empty, int& s, int rank, int cs, GbClock& clk) {
  const int slot = s % GB_SLOTS;
  if (s >= GB_SLOTS) cb_wait(&empty[slot], ((s / GB_SLOTS) - 1) & 1);
  clk.tick(GB_PHASES);
  const int piece = bytes / cs;
  tc_mbar_expect_tx(&full[slot], bytes);
  cb_bulk_load(tc_smem(ring + slot * GB_SLOT + rank * piece), src + rank * piece, piece,
               &full[slot], cs);
  ++s;
}

// Every item of every tile, in the consumers' order; then the last slots'
// releases, so that no block of the cluster arrives here after this block
// has left.
__device__ __forceinline__ void gb_produce(const float* __restrict__ prm, const GbPlan& p,
                                           uint8_t* ring, uint64_t* full, uint64_t* empty,
                                           int rank, int cs, int iters, GbClock& clk) {
  int s = 0;
  for (int it = 0; it < iters; ++it) {
    for (int t = 0; t < p.n_trunks; ++t) {
      const GbTrunk& T = p.trunks[t];
      const uint8_t* src = reinterpret_cast<const uint8_t*>(prm + T.stream);
      for (int l = 0; l < T.n_hidden; ++l) {
        const GbLayer& L = T.layers[l];
        const int steps = L.in_pad / 16 + gb_lat_steps(L.lat, p.lat_pad);
        for (int h = (L.out_pad - 1) / GB_HALF; h >= 0; --h) {  // the last half first
          const int width = gb_width(L.out_pad, h);
          for (int st = 0; st < steps; ++st, src += width * 32)
            gb_put(src, width * 32, ring, full, empty, s, rank, cs, clk);
          const int epi = 4 * gb_epi_floats(width, L.has_x);
          gb_put(src, epi, ring, full, empty, s, rank, cs, clk);
          src += epi;
        }
      }
      const int steps = T.last_pad / 16 + gb_lat_steps(T.fin_lat, p.lat_pad);
      const int fk = gb_fin_steps(T.nf);
      for (int st = 0; st < steps; st += fk) {
        const int bytes = min(fk, steps - st) * T.nf * 32;
        gb_put(src, bytes, ring, full, empty, s, rank, cs, clk);
        src += bytes;
      }
    }
  }
  for (int k = s > GB_SLOTS ? s - GB_SLOTS : 0; k < s; ++k)
    cb_wait(&empty[k % GB_SLOTS], (k / GB_SLOTS) & 1);
  clk.tick(GB_PHASES);
}

// ---- the consumers --------------------------------------------------------

// A half's product of W outputs: `steps` k steps, the first `sm` over the
// warpgroup's rows at a_s (16 st ..), each issued before the one before is
// waited for and its slot released; the rest (K6's input columns c_reg + 16
// (st - sm) .. of trunk t's rows of points q, q + 8) from device memory, each
// waited for at once, its fragment's registers held till then.
template <int W, bool kRows>
__device__ __forceinline__ void gb_product(float (&acc)[128], int steps, int sm, uint32_t a_s,
                                           uint32_t ring_s, uint64_t* full, uint64_t* empty,
                                           int& s, int cs, int wt, const GbRows& x, int t, int q,
                                           int m, int c_reg) {
  uint32_t a[4];
  int st = 0;
  for (; st < sm; ++st, ++s) {
    const int slot = s % GB_SLOTS;
    if (!(GB_PROBE & 8)) cb_wait(&full[slot], (s / GB_SLOTS) & 1);
    tc_wgmma_fence();
    if (!(GB_PROBE & 1))
      gb_wgmma<W, false>(acc, gb_desc_a(a_s + (st >> 2) * 8192 + (st & 3) * 32), a,
                         gb_desc_b(ring_s + slot * GB_SLOT), st > 0);
    tc_wgmma_commit();
    if (st > 0) {
      cb_wgmma_wait1();  // the step before is done: its slot is free
      if (!(GB_PROBE & 8)) cb_release(&empty[(s - 1) % GB_SLOTS], cs, wt);
    }
  }
  tc_wgmma_wait();
  gb_fence_acc(acc);
  if (st > 0 && !(GB_PROBE & 8)) cb_release(&empty[(s - 1) % GB_SLOTS], cs, wt);
  if constexpr (kRows) {
    for (; st < steps; ++st, ++s) {
      const int slot = s % GB_SLOTS;
      gb_frag(a, x, t, q, m, c_reg + 16 * (st - sm));
      if (!(GB_PROBE & 8)) cb_wait(&full[slot], (s / GB_SLOTS) & 1);
      tc_wgmma_fence();
      if (!(GB_PROBE & 1))
        gb_wgmma<W, true>(acc, 0, a, gb_desc_b(ring_s + slot * GB_SLOT), st > 0);
      tc_wgmma_commit();
      tc_wgmma_wait();
      gb_keep(a);
      gb_fence_acc(acc);
      if (!(GB_PROBE & 8)) cb_release(&empty[slot], cs, wt);
    }
  }
}

// gb_product at a half's width: K1's halves are 256 or 128 wide, K6's any
// multiple of 16 up to 256.
#define GB_PRODUCT_ARGS acc, steps, sm, a_s, ring_s, full, empty, s, cs, wt, x, t, q, m, c_reg
#define GB_PRODUCT_CASE(k) \
  case k:                  \
    gb_product<16 * k, true>(GB_PRODUCT_ARGS); \
    break;
template <bool kRows>
__device__ __forceinline__ void gb_half_product(int width, float (&acc)[128], int steps, int sm,
                                                uint32_t a_s, uint32_t ring_s, uint64_t* full,
                                                uint64_t* empty, int& s, int cs, int wt,
                                                const GbRows& x, int t, int q, int m, int c_reg) {
  if constexpr (!kRows) {
    if (width == GB_HALF)
      gb_product<GB_HALF, false>(GB_PRODUCT_ARGS);
    else
      gb_product<128, false>(GB_PRODUCT_ARGS);
  } else {
    switch (width >> 4) {
      GB_PRODUCT_CASE(1) GB_PRODUCT_CASE(2) GB_PRODUCT_CASE(3) GB_PRODUCT_CASE(4)
      GB_PRODUCT_CASE(5) GB_PRODUCT_CASE(6) GB_PRODUCT_CASE(7) GB_PRODUCT_CASE(8)
      GB_PRODUCT_CASE(9) GB_PRODUCT_CASE(10) GB_PRODUCT_CASE(11) GB_PRODUCT_CASE(12)
      GB_PRODUCT_CASE(13) GB_PRODUCT_CASE(14) GB_PRODUCT_CASE(15)
      default: gb_product<GB_HALF, true>(GB_PRODUCT_ARGS); break;
    }
  }
}

// The final rows' product, NF outputs, gb_fin_steps(NF) k steps an item:
// the steps as gb_product's (the first sm from the rows, the rest K6's
// fin_lat steps from registers, an item of those waited for at once).
template <int NF, bool kRows>
__device__ __forceinline__ void gb_fin_product(float (&acc)[128], int steps, int sm, uint32_t a_s,
                                               uint32_t ring_s, uint64_t* full, uint64_t* empty,
                                               int& s, int cs, int wt, const GbRows& x, int t,
                                               int q, int m, int c_reg) {
  constexpr int FK = GB_SLOT / (NF * 32);
  bool held = false;  // the item before holds its slot
  for (int st = 0; st < steps; ++s) {
    const int slot = s % GB_SLOTS;
    if (!(GB_PROBE & 8)) cb_wait(&full[slot], (s / GB_SLOTS) & 1);
    bool done = false;  // a register step waited for every product so far
    for (int j = 0; j < FK && st < steps; ++j, ++st) {
      const bool reg = kRows && st >= sm;
      uint32_t a[4];
      if (kRows && reg) gb_frag(a, x, t, q, m, c_reg + 16 * (st - sm));
      tc_wgmma_fence();
      if (!(GB_PROBE & 1)) {
        const uint32_t b = ring_s + slot * GB_SLOT + j * NF * 32;
        if (kRows && reg)
          gb_wgmma<NF, true>(acc, 0, a, gb_desc_b(b), st > 0);
        else
          gb_wgmma<NF, false>(acc, gb_desc_a(a_s + (st >> 2) * 8192 + (st & 3) * 32), a,
                              gb_desc_b(b), st > 0);
      }
      tc_wgmma_commit();
      if (kRows && reg) {
        tc_wgmma_wait();
        gb_keep(a);
        done = true;
      }
    }
    if (kRows && done) {
      if (held && !(GB_PROBE & 8)) cb_release(&empty[(s - 1) % GB_SLOTS], cs, wt);
      if (!(GB_PROBE & 8)) cb_release(&empty[slot], cs, wt);
      held = false;
    } else {
      if (held) {
        cb_wgmma_wait1();  // the item before is done
        if (!(GB_PROBE & 8)) cb_release(&empty[(s - 1) % GB_SLOTS], cs, wt);
      }
      held = true;
    }
  }
  tc_wgmma_wait();
  gb_fence_acc(acc);
  if (held && !(GB_PROBE & 8)) cb_release(&empty[(s - 1) % GB_SLOTS], cs, wt);
}

// A half's epilogue over its `width` outputs: v = relu(acc (if `prod`) +
// b + X xyz (if has_x)) at this thread's points p0, p0 + 8 (xyz[0..2],
// xyz[3..5]), rounded to bf16 in pairs; written by stmatrix into the half's
// rows at dst (its first feature's block of the activations; rows[q]: this
// lane's row offset for output pairs 8 (2q) .. of a block of 64), or, with
// `scr`, stored as this thread's 16-byte chunks of the warpgroup's scratch
// (chunk c of thread wt at c * 128 + wt: a warp's stores coalesced), which
// gb_reload writes into the rows later.  Unrolled: a copy a block of 64
// outputs that shifts the accumulators ran slower.
__device__ __forceinline__ void gb_epilogue(const float (&acc)[128], bool prod, const float* epi,
                                            int width, bool has_x, const float (&xyz)[6],
                                            uint32_t dst, const uint32_t (&rows)[4], uint4* scr,
                                            int wt, int t4) {
  if (GB_PROBE & 2) {  // one write of two results, so that ptxas keeps the products
    if (prod && !scr)
      gb_stmatrix4(dst + rows[0], __float_as_uint(acc[0]), __float_as_uint(acc[63]), 0u, 0u);
    return;
  }
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    if (8 * i < width) {
      uint32_t r[4];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int j = i + k, o = 8 * j + 2 * t4;
        const float2 b = *reinterpret_cast<const float2*>(epi + o);
        float v0 = b.x, v1 = b.y, v2 = b.x, v3 = b.y;
        if (prod) {
          v0 += acc[4 * j];
          v1 += acc[4 * j + 1];
          v2 += acc[4 * j + 2];
          v3 += acc[4 * j + 3];
        }
        if (has_x) {
          const float2 wx = *reinterpret_cast<const float2*>(epi + width + o);
          const float2 wy = *reinterpret_cast<const float2*>(epi + 2 * width + o);
          const float2 wz = *reinterpret_cast<const float2*>(epi + 3 * width + o);
          v0 += wx.x * xyz[0] + wy.x * xyz[1] + wz.x * xyz[2];
          v1 += wx.y * xyz[0] + wy.y * xyz[1] + wz.y * xyz[2];
          v2 += wx.x * xyz[3] + wy.x * xyz[4] + wz.x * xyz[5];
          v3 += wx.y * xyz[3] + wy.y * xyz[4] + wz.y * xyz[5];
        }
        r[2 * k] = gb_pack(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
        r[2 * k + 1] = gb_pack(fmaxf(v2, 0.f), fmaxf(v3, 0.f));
      }
      if (scr)
        scr[(i >> 1) * 128 + wt] = make_uint4(r[0], r[1], r[2], r[3]);
      else
        gb_stmatrix4(dst + (i >> 3) * 8192 + rows[(i & 7) >> 1], r[0], r[1], r[2], r[3]);
    }
  }
}

// The half of `width` outputs that gb_epilogue stored to this thread's
// scratch, into its rows at dst (the thread reads back only what it wrote).
__device__ __forceinline__ void gb_reload(const uint4* scr, int width, uint32_t dst,
                                          const uint32_t (&rows)[4], int wt) {
  if (GB_PROBE & 2) return;
  uint4 v[16];
#pragma unroll
  for (int i = 0; i < 32; i += 2)
    if (8 * i < width) v[i >> 1] = scr[(i >> 1) * 128 + wt];
#pragma unroll
  for (int i = 0; i < 32; i += 2)
    if (8 * i < width)
      gb_stmatrix4(dst + (i >> 3) * 8192 + rows[(i & 7) >> 1], v[i >> 1].x, v[i >> 1].y,
                   v[i >> 1].z, v[i >> 1].w);
}

// The final rows' epilogue for trunk T: rows 0-1 (and fin_xyz's terms)
// into sdf (this thread's when lane % 4 == 0: [point][row]); the class
// rows, with their bias, to out.
__device__ __forceinline__ void gb_fin_epilogue(const float (&acc)[128],
                                                const float* __restrict__ prm,
                                                const GbPlan& p, const GbTrunk& T,
                                                const float (&xyz)[6], float (&sdf)[4],
                                                float* __restrict__ out, int q0, int t4) {
  if (GB_PROBE & 2) return;
#pragma unroll
  for (int i = 0; i < GB_MAX_ROWS / 8; ++i) {
    if (8 * i < T.nf) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = 8 * i + 2 * t4 + (r & 1), k = r >> 1;
        if (row < T.rows) {
          float v = acc[4 * i + r];
          if (T.fin_xyz >= 0) {
            const float* fx = prm + T.fin_xyz + 3 * row;
            v += __ldg(fx) * xyz[3 * k] + __ldg(fx + 1) * xyz[3 * k + 1]
                 + __ldg(fx + 2) * xyz[3 * k + 2];
          }
          if (i == 0 && t4 == 0) {
            sdf[r] += v;
          } else {
            const int q = q0 + 8 * k;
            if (q < p.m) out[(size_t)row * p.m + q] = v + __ldg(prm + p.fin_b + row);
          }
        }
      }
    }
  }
}

// The kernels' body.  Threads 0-255: the consumer warpgroups; 256-383: the
// producer warpgroup (warp 8's lane 0 produces).  kRows false: K1 (xyz from
// the grid indices, scal = origin and voxel); true: K6 (input rows x).
template <bool kRows>
__device__ __forceinline__ void gb_body(const float* __restrict__ prm, const GbPlan& p,
                                        const float* __restrict__ scal, const GbRows& x,
                                        float* __restrict__ out, uint8_t* __restrict__ scratch) {
  extern __shared__ uint8_t gb_raw[];
  uint8_t* sm = gb_raw + ((1024 - (tc_smem(gb_raw) & 1023)) & 1023);  // the swizzle's 1 KB atoms
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + GB_OFF_BAR);
  uint64_t* empty = full + GB_SLOTS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cs = cb_cluster_size(), rank = wb_cluster_rank();
  const int cid = blockIdx.x / cs, clusters = gridDim.x / cs;
  const int iters = (p.ctiles - cid + clusters - 1) / clusters;
  GbClock clk;
  if (tid == 0) {
    for (int i = 0; i < GB_SLOTS; ++i) {
      tc_mbar_init(&full[i], 1);        // the producer's expect_tx
      tc_mbar_init(&empty[i], 2 * cs);  // both warpgroups of every block
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  wb_cluster_sync();  // every block's barriers are set before a copy or an arrival reaches them

  if (warp >= 8) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (warp == 8 && lane == 0 && !(GB_PROBE & 8)) {
      gb_produce(prm, p, sm + GB_OFF_RING, full, empty, rank, cs, iters, clk);
      clk.flush(true, GB_PHASES, GB_PHASES + 1);
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  // the warpgroup's index broadcast from lane 0: uniform over each warp
  const int wg = __shfl_sync(0xffffffffu, warp >> 2, 0);
  const int wt = tid & 127, t4 = lane & 3;
  const int p0 = 16 * (warp & 3) + (lane >> 2);  // this thread's points: p0, p0 + 8
  uint8_t* buf = sm + wg * GB_BUF;
  const uint32_t a_s = tc_smem(buf), ring_s = tc_smem(sm + GB_OFF_RING);
  const float* ring = reinterpret_cast<const float*>(sm + GB_OFF_RING);
  // this lane's stmatrix rows: point 16 (warp % 4) + 8 (lane / 8 % 2) + lane % 8, the
  // output pair 8 (2q + lane / 16) of a block of 64
  uint32_t rows[4];
  {
    const int pt = 16 * (warp & 3) + 8 * ((lane >> 3) & 1) + (lane & 7), sel = (lane >> 4) & 1;
#pragma unroll
    for (int q = 0; q < 4; ++q) rows[q] = pt * 128 + ((((2 * q + sel) ^ pt) & 7) << 4);
  }
  float ox = 0.f, oy = 0.f, oz = 0.f, voxel = 0.f;
  if constexpr (!kRows) {
    ox = __ldg(scal);
    oy = __ldg(scal + 1);
    oz = __ldg(scal + 2);
    voxel = __ldg(scal + 3);
  }
  const int nsq = p.n * p.n;
  // the scratch of a layer's first streamed half where its rows are still
  // the layer's input (its rows read reach past GB_HALF)
  uint4* scr = reinterpret_cast<uint4*>(scratch + ((size_t)blockIdx.x * 2 + wg) * GB_SCRATCH);
  float acc[128];
  int s = 0;  // ring items taken
  clk.tick(3);
  for (int it = 0; it < iters; ++it) {
    const int first = ((cid + it * clusters) * cs + rank) * GB_P + wg * GB_WP;
    float xyz[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if constexpr (!kRows) {  // the index arithmetic of decoder_kernel.py:633-638, in int32
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int idx = p.base + min(first + p0 + 8 * k, p.m - 1);
        xyz[3 * k] = __fadd_rn(__fmul_rn((float)(idx / nsq % p.n), voxel), ox);
        xyz[3 * k + 1] = __fadd_rn(__fmul_rn((float)(idx / p.n % p.n), voxel), oy);
        xyz[3 * k + 2] = __fadd_rn(__fmul_rn((float)(idx % p.n), voxel), oz);
      }
    }
    float sdf[4] = {0.f, 0.f, 0.f, 0.f};
    if constexpr (kRows)  // the next tile's rows, for its fills
      gb_prefetch_tile(x, p.n_trunks, first + clusters * cs * GB_P, p.m, p.lat_pad, wt);
    clk.tick(3);
    for (int t = 0; t < p.n_trunks; ++t) {
      const GbTrunk& T = p.trunks[t];
      for (int l = 0; l < T.n_hidden; ++l) {
        const GbLayer& L = T.layers[l];
        const int staged = kRows && L.lat ? gb_staged(L.in_pad, p.lat_pad) : 0;
        if (kRows && l == 0) {
          // layer 0's input rows, over rows the trunk (or tile) before's final rows read
          gb_bar_sync(1 + wg, 128);
          clk.tick(5);
          gb_fill(x, t, first, first + p0, p.m, staged, p.lat_pad, buf, 0, warp & 3, lane);
          tc_fence_proxy_async();
          gb_bar_sync(1 + wg, 128);
          clk.tick(6);
        }
        const int halves = (L.out_pad + GB_HALF - 1) / GB_HALF;
        const int steps = L.in_pad / 16 + gb_lat_steps(L.lat, p.lat_pad);
        const int sm_steps = (L.in_pad + staged) / 16;
        const bool spill = halves > 1 && L.in_pad + staged > GB_HALF;
        for (int h = halves - 1; h >= 0; --h) {  // the last half first
          const int width = gb_width(L.out_pad, h);
          if (steps > 0) {
            gb_half_product<kRows>(width, acc, steps, sm_steps, a_s, ring_s, full, empty, s, cs, wt,
                                   x, t, first + p0, p.m, staged + 2 * t4);
            clk.tick(0);
          }
          const int slot = s % GB_SLOTS;
          if (!(GB_PROBE & 8)) cb_wait(&full[slot], (s / GB_SLOTS) & 1);
          clk.tick(4);
          // the last half writes rows the products read (K1's layer 0's first, rows the
          // trunk before's final rows read): every warp's products past them first
          if (h == 0 || (!kRows && l == 0)) gb_bar_sync(1 + wg, 128);
          clk.tick(5);
          gb_epilogue(acc, steps > 0, ring + slot * (GB_SLOT / 4), width, L.has_x, xyz,
                      a_s + h * (GB_HALF / 64) * 8192, rows, spill && h > 0 ? scr : nullptr, wt,
                      t4);
          clk.tick(1);
          if (spill && h == 0)  // the first streamed half back, now that the input is dead
            gb_reload(scr, gb_width(L.out_pad, 1), a_s + (GB_HALF / 64) * 8192, rows, wt);
          if (h == 0) {
            if constexpr (kRows) {
              // the next layer's (or fin_lat's) input rows above this layer's output
              if (l + 1 < T.n_hidden ? T.layers[l + 1].lat : T.fin_lat) {
                clk.tick(5);
                gb_fill(x, t, first, first + p0, p.m, gb_staged(L.out_pad, p.lat_pad), p.lat_pad,
                        buf, L.out_pad, warp & 3, lane);
                clk.tick(6);
              }
            }
            tc_fence_proxy_async();  // the rows, for wgmma
          }
          gb_bar_sync(1 + wg, 128);  // the slot's reads done (and the rows whole)
          clk.tick(5);
          if (!(GB_PROBE & 8)) cb_release(&empty[slot], cs, wt);
          ++s;
          clk.tick(1);
        }
      }
      const int staged = kRows && T.fin_lat ? gb_staged(T.last_pad, p.lat_pad) : 0;
      const int steps = T.last_pad / 16 + gb_lat_steps(kRows && T.fin_lat, p.lat_pad);
      const int sm_steps = (T.last_pad + staged) / 16, c_reg = staged + 2 * t4;
#define GB_FIN(NF) \
  gb_fin_product<NF, kRows>(acc, steps, sm_steps, a_s, ring_s, full, empty, s, cs, wt, x, t, \
                            first + p0, p.m, c_reg)
      switch (T.nf) {
        case 8: GB_FIN(8); break;
        case 16: GB_FIN(16); break;
        case 32: GB_FIN(32); break;
        case 64: GB_FIN(64); break;
        default: GB_FIN(128); break;
      }
#undef GB_FIN
      clk.tick(2);
      gb_fin_epilogue(acc, prm, p, T, xyz, sdf, out, first + p0, t4);
      clk.tick(2);
    }
    if (t4 == 0) {  // rows 0-1: tanh of the trunks' sum and the bias
      const float b0 = __ldg(prm + p.fin_b), b1 = __ldg(prm + p.fin_b + 1);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int q = first + p0 + 8 * k;
        if (q < p.m) {
          out[q] = tanhf(sdf[2 * k] + b0);
          out[(size_t)p.m + q] = tanhf(sdf[2 * k + 1] + b1);
        }
      }
    }
    clk.tick(2);
  }
  clk.flush(wt == 0 && wg == 0, 0, GB_PHASES);
}

// ---- the host -------------------------------------------------------------

// Reads a descriptor into p and says whether the kernel takes it.  K1
// (rows false; ops/grid_plan's bf16 packing, kernels/grid_decoder.py:
// pack_grid_plan_bf16): [n_trunks, fin_b, rows, n_rows, then per trunk
// n_hidden, fin, fin_xyz, last_pad, then per hidden layer w, x, b, in_pad,
// out_pad]; 1-2 trunks of 1-8 hidden layers, widths padded to 128 up to 512,
// layer 0 without a product.  K6 (rows true; kernels/generic_decoder.py:
// pack_generic_plan_bf16): [n_trunks, fin_b, rows, n_rows, lat_pad, then per
// trunk n_hidden, fin, fin_lat, last_pad, then per hidden layer w, x, lat, b,
// in_pad, out_pad]; widths padded to 16 up to 512, lat_pad a multiple of 16,
// no xyz terms, layer 0 on the input rows alone.  Offsets in floats, -1 =
// absent.  Both: each later layer reads the one before, 2-128 rows, and
// every trunk's items one contiguous stream in the kernel's order (w: the W
// tiles of the first streamed half, its last; lat: its W_in tiles, right
// after; b: its epilogue block, x = b + its width; fin: the final rows'
// tiles right after the last layer's, fin_lat right after them).
static bool gb_take_plan(GbPlan& p, const int* desc, int desc_len, bool rows) {
  const int head = rows ? 5 : 4, per = rows ? 6 : 5, unit = rows ? 16 : 128;
  if (desc_len < head) return false;
  p.n_trunks = desc[0];
  p.fin_b = desc[1];
  p.n_rows = desc[3];
  p.lat_pad = rows ? desc[4] : 0;
  if (p.n_trunks < 1 || p.n_trunks > GB_MAX_TRUNKS || p.fin_b < 0) return false;
  if (p.n_rows < 2 || p.n_rows > GB_MAX_ROWS || desc[2] > GB_MAX_OUT) return false;
  if (rows && (p.lat_pad < 16 || p.lat_pad % 16)) return false;
  int pos = head;
  for (int t = 0; t < p.n_trunks; ++t) {
    GbTrunk& T = p.trunks[t];
    if (pos + 4 > desc_len) return false;
    T.n_hidden = desc[pos];
    const int fin = desc[pos + 1], fx = desc[pos + 2];
    T.fin_xyz = rows ? -1 : fx;
    T.fin_lat = rows && fx >= 0;
    T.last_pad = desc[pos + 3];
    pos += 4;
    T.rows = t == 0 ? p.n_rows : 2;
    T.nf = gb_fin_width(T.rows);
    if (T.n_hidden < 1 || T.n_hidden > GB_MAX_HIDDEN || pos + per * T.n_hidden > desc_len)
      return false;
    int cursor = 0, prev = 0;
    for (int l = 0; l < T.n_hidden; ++l, pos += per) {
      const int w = desc[pos], x = desc[pos + 1], lat = rows ? desc[pos + 2] : -1;
      const int b = desc[pos + per - 3];
      GbLayer& L = T.layers[l];
      L.in_pad = desc[pos + per - 2];
      L.out_pad = desc[pos + per - 1];
      L.has_x = x >= 0;
      L.lat = lat >= 0;
      if (L.out_pad < unit || L.out_pad % unit || L.out_pad > GB_MAX_OUT) return false;
      if (rows && (L.has_x || (l == 0 && !L.lat))) return false;
      if (l == 0 ? (w >= 0 || L.in_pad != 0) : (w < 0 || L.in_pad != prev)) return false;
      const int start = w >= 0 ? w : L.lat ? lat : b;
      if (l == 0) cursor = T.stream = start;
      if (start != cursor || cursor < 0 || cursor % 4) return false;
      const int top = (L.out_pad - 1) / GB_HALF;
      for (int h = top; h >= 0; --h) {  // the last half first
        const int width = gb_width(L.out_pad, h);
        cursor += L.in_pad / 16 * width * 8;  // the k steps' tiles: width x 16 bf16 each
        if (h == top && L.lat && lat != cursor) return false;
        cursor += gb_lat_steps(L.lat, p.lat_pad) * width * 8;
        if (h == top && (b != cursor || (L.has_x && x != b + width))) return false;
        cursor += gb_epi_floats(width, L.has_x);
      }
      prev = L.out_pad;
    }
    if (T.last_pad != prev || fin != cursor) return false;
    if (T.fin_lat && fx != fin + T.last_pad / 16 * T.nf * 8) return false;
  }
  return pos == desc_len;
}

// The bytes of the items a tile of points reads: every trunk's stream.
static long long gb_stream_bytes(const GbPlan& p) {
  long long bytes = 0;
  for (int t = 0; t < p.n_trunks; ++t) {
    const GbTrunk& T = p.trunks[t];
    for (int l = 0; l < T.n_hidden; ++l) {
      const GbLayer& L = T.layers[l];
      for (int h = 0; GB_HALF * h < L.out_pad; ++h) {
        const int width = gb_width(L.out_pad, h);
        bytes += (long long)(L.in_pad / 16 + gb_lat_steps(L.lat, p.lat_pad)) * width * 32
                 + 4 * gb_epi_floats(width, L.has_x);
      }
    }
    bytes += (long long)(T.last_pad / 16 + gb_lat_steps(T.fin_lat, p.lat_pad)) * T.nf * 32;
  }
  return bytes;
}

// Launches `kernel` (grid_bf16_kernel or generic_bf16_kernel, whose
// arguments args hold, p among them) over m points in clusters of
// GB_CLUSTER, as many clusters as fit the card at once (`fits`, the caller's
// cache), with `scratch_bytes` of scratch (GB_SCRATCH a warpgroup of the
// grid); with `plan` (GB_PLAN_INTS: shared memory bytes, points a block,
// cluster, grid blocks, ring slots, a tile's stream bytes (low 31 bits, the
// rest)) launches nothing.  0, -1 for arguments the kernel does not take,
// WB_ERR_CLUSTER, or a CUDA error.
static int gb_launch(const void* kernel, int& fits, GbPlan& p, int m, void** args,
                     const uint8_t* scratch, long long scratch_bytes, cudaStream_t stream,
                     int* plan) {
  if (m <= 0) return -1;
  p.m = m;
  p.ctiles = (m + GB_CLUSTER * GB_P - 1) / (GB_CLUSTER * GB_P);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = GB_CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(GB_THREADS);
  cfg.dynamicSmemBytes = GB_SMEM;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (!fits) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           GB_SMEM);
    if (err != cudaSuccess) return (int)err;
    cfg.gridDim = dim3(GB_CLUSTER);
    err = cudaOccupancyMaxActiveClusters(&fits, kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (fits <= 0) return WB_ERR_CLUSTER;
  }
  const int clusters = p.ctiles < fits ? p.ctiles : fits;
  cfg.gridDim = dim3(clusters * GB_CLUSTER);
  if (plan) {
    const long long bytes = gb_stream_bytes(p);
    const int v[GB_PLAN_INTS] = {GB_SMEM, GB_P, GB_CLUSTER, clusters * GB_CLUSTER, GB_SLOTS,
                                 (int)(bytes & 0x7FFFFFFF), (int)(bytes >> 31)};
    memcpy(plan, v, sizeof v);
    return 0;
  }
  if (!scratch || scratch_bytes < (long long)clusters * GB_CLUSTER * 2 * GB_SCRATCH) return -1;
  const cudaError_t err = cudaLaunchKernelExC(&cfg, kernel, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
