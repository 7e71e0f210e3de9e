// K1's bf16 grid decoder on Hopper (grid_bf16_kernel).
//
// Replaces alignsdf_tpu/ops/decoder_kernel.py:make_fused_grid_kernel_t (:496,
// its pallas_call :673) with dtype bfloat16 (make_fused_grid_decode_fn
// :693), and its points-major sibling make_fused_grid_kernel (:381) at 2 +
// C rows.  For a run of m linear grid indices from `base` (z fastest) each
// point's xyz comes from the int32 index arithmetic (:633-638: p // n^2 %
// n, p // n % n, p % n, times the voxel, plus the origin); then per hidden
// layer a = bf16(relu(b + a_prev W + X xyz)) (bf16 products summed in
// float32; the bias and the xyz terms float32 on bf16-rounded weights; layer
// 0 has no product, its input folded on the host); then rows 0-1 =
// tanh(the trunks' final rows summed + fin_xyz xyz + bias) and rows 2 .. =
// the class logits (the first trunk's), without tanh.  grid_decode_reference
// on the same plan is the plain version.
//
// What bounds it: operations.  The flagship's trunk (512 -> 250 -> 512 ->
// 512 -> 1, hidden padded to 128) costs ~0.52 M multiply-adds a point, so a
// 128^3 pass of both trunks is 4.38 TFLOP: 4.42 ms at the card's dense bf16
// 989.4 TFLOP/s.  The weights stream from L2: each tile read serves the
// points of a cluster (below), ~1.08 MB a trunk per 128 points.  As
// measured (PERF.md, tools/time_grid_kernels.py --bf16 --probes) the
// products alone take ~1.2x that bound; the ring's round trip and the
// epilogues on the CUDA cores more than double it.
//
// The design, by what held grid_trunk_tc.cuh's TcBf16 route back:
//  (a) 128 points a block, 64 a consumer warpgroup: warpgroup w owns its
//    64 points and all of a layer's outputs for them, and both warpgroups
//    read each weight tile from the same ring slot.  A layer's outputs run
//    in halves of up to GB_HALF = 256 (wgmma.m64n256k16 a k step, 128
//    accumulators; a half of 128: m64n128k16), the last half first, each
//    written in place over the layer's input.  Where the input is at most
//    256 wide the last half's rows lie past it and are written at once;
//    where it is wider (512 -> 512) that half goes to the warpgroup's 32 KB
//    of scratch in device memory (L2), each thread's packed results in
//    coalesced 16-byte stores, and each thread reads its own back into the
//    rows once the first half's products are past the input (a bulk copy
//    back would need a proxy fence after the stores).  Holding it in
//    registers, 64 more a thread, spilled: ptxas allocates a 384-thread
//    block's code at most 168 registers a thread, setmaxnreg or not.
//  (b) A from shared memory in bf16.  A warpgroup's activations are one 64
//    KB operand: K-major with the 128-byte swizzle, point p's 64 features
//    of a block of 64 in one 128-byte row (chain_bf16_tc.cuh's dpre
//    layout), 8 such blocks; a k step is a descriptor 32 bytes on.  The
//    epilogue writes it with stmatrix (four 8 x 8 bf16 matrices an
//    instruction, the accumulators' own fragments), without bank
//    conflicts.
//  (c) A producer and a pipeline.  One thread of the third warpgroup
//    streams every item of the plan through a ring of GB_SLOTS 8 KB slots
//    with full and empty mbarriers: a half's k-step tiles (256 x 16 bf16,
//    K-major core matrices, the plan's own layout), its epilogue block (the
//    bias and the bf16-rounded xyz weights, float32), the final rows'
//    tiles, in the order the consumers read them; setmaxnreg gives the
//    producer warpgroup's registers to the consumers.  A consumer keeps one
//    product in flight (wgmma.wait_group 1) and releases each slot once past
//    it.  Blocks run in clusters of GB_CLUSTER = 2: each block loads half of
//    every item and multicasts it, so each read from L2 serves 256 points,
//    and a slot is refilled once both warpgroups of every block released it.
//  (d) No ping-pong.  The epilogues (bias, xyz terms, ReLU, rounding, the
//    write) run on the CUDA cores, and the two warpgroups run theirs as
//    they come, with no order between them.  A pair of named barriers that
//    put each warpgroup's epilogue work under the other's products was
//    measured on an H100 at ~4 ms a 128^3 pass slower (PERF.md): both
//    warpgroups read every slot, so the lag it keeps between them takes
//    ring slots from the leader's prefetch, and an epilogue run outlasts
//    the ring's 12 k steps.
//  (e) The final rows as one more product: fin (bf16) over the last
//    activation on wgmma.m64nNFk16, NF = 8 ceil(rows / 8) to a power of two
//    (<= 128; the second trunk 8), several k steps an item; a short
//    epilogue adds fin_xyz's terms, sums the SDF rows over the trunks in
//    registers, writes the class rows with their bias and rows 0-1 with
//    bias and tanh.
//  (f) Persistent blocks.  One cluster an SM pair, as many as fit; cluster c
//    walks the launch's tiles of GB_CLUSTER x 128 points c, c + clusters,
//    ... (its blocks one 128 each), the ring running on across tiles, points
//    past m clamped and not written.
//
// Accuracy: as grid_trunk_tc.cuh's TcBf16 route (the plain version's
// roundings; float32 sums in the tensor cores' order), the final rows' sums
// now on the tensor cores too (exact products of bf16 values).
//
// Shared memory (bytes, from a 1 KB-aligned base): the two warpgroups'
// activations 2 x 65,536; the ring 12 x 8,192 = 98,304; 24 mbarriers 192;
// 1,024 of alignment: 230,592 of 232,448.  Registers: a consumer holds 128
// accumulators (ptxas's 168 a thread); the producer warpgroup gives its
// registers up (setmaxnreg 40).  Scratch: GB_SCRATCH (32 KB) a warpgroup of
// the grid, the wrapper's.
//
// GB_PROBE (0 in the package's build; tools/time_grid_kernels.py --bf16
// --probes builds copies): 32 clocks the phases: thread 0 of warpgroup 0
// adds each phase's cycles (products with their ring waits, epilogues'
// arithmetic and writes, final rows, set-up, the epilogues' waits for their
// item, their barriers and scratch reloads) and the producer its waits for
// a free slot, into gb_cycles.  The other bits leave parts out (their
// results are wrong): 1 the products' wgmma, 2 the epilogues' arithmetic
// and writes (but one, which keeps the products), 8 the ring (no loads, no
// waits for a slot or its release).

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
#define GB_MAX_OUT 512
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
// barriers and reloads; then the producer's slot waits
#define GB_PHASES 6
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

struct GbLayer { int in_pad, out_pad, has_x; };
// stream: the float offset of the trunk's items (its layer 0's first
// epilogue block); rows: the output rows it writes (n_rows for the first
// trunk, the SDF rows for the second); nf: its final rows' product width
struct GbTrunk {
  int n_hidden, stream, fin_xyz, last_pad, rows, nf;
  GbLayer layers[GB_MAX_HIDDEN];
};
struct GbPlan {
  int n_trunks, fin_b, n_rows, n, base, m, ctiles;
  GbTrunk trunks[GB_MAX_TRUNKS];
};

// The plan's items, in stream order: per layer and half (outputs 256 h ..,
// the last half first), the half's k-step tiles (layers >= 1), then its
// epilogue block; then the final rows' tiles, gb_fin_steps of them an item.
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

// d[0 .. N / 2) (+)= A (64 x 16, K-major with the 128-byte swizzle at da)
// x B^T (N x 16, K-major core matrices at db); scale_d 0: d = A B^T.
// d[4i + r]: point 16 warp + lane/4 (+ 8 for r >= 2), output 8i + 2
// (lane%4) (+ 1 for odd r).
template <int N>
__device__ __forceinline__ void gb_wgmma(float (&d)[128], uint64_t da, uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void gb_wgmma<8>(float (&d)[128], uint64_t da,
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void gb_wgmma<16>(float (&d)[128], uint64_t da,
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void gb_wgmma<32>(float (&d)[128], uint64_t da,
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void gb_wgmma<64>(float (&d)[128], uint64_t da,
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void gb_wgmma<128>(float (&d)[128], uint64_t da,
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
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
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void gb_wgmma<256>(float (&d)[128], uint64_t da,
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
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
        for (int h = (L.out_pad - 1) / GB_HALF; h >= 0; --h) {  // the last half first
          const int width = gb_width(L.out_pad, h);
          for (int st = 0; st < L.in_pad / 16; ++st, src += width * 32)
            gb_put(src, width * 32, ring, full, empty, s, rank, cs, clk);
          const int epi = 4 * gb_epi_floats(width, L.has_x);
          gb_put(src, epi, ring, full, empty, s, rank, cs, clk);
          src += epi;
        }
      }
      const int steps = T.last_pad / 16, fk = gb_fin_steps(T.nf);
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

// A half's product: `steps` k steps over the warpgroup's activations at
// a_s, N outputs, each step issued before the one before is waited for and
// its slot released.
template <int N>
__device__ __forceinline__ void gb_product(float (&acc)[128], int steps, uint32_t a_s,
                                           uint32_t ring_s, uint64_t* full, uint64_t* empty,
                                           int& s, int cs, int wt) {
  for (int st = 0; st < steps; ++st, ++s) {
    const int slot = s % GB_SLOTS;
    if (!(GB_PROBE & 8)) cb_wait(&full[slot], (s / GB_SLOTS) & 1);
    tc_wgmma_fence();
    if (!(GB_PROBE & 1))
      gb_wgmma<N>(acc, gb_desc_a(a_s + (st >> 2) * 8192 + (st & 3) * 32),
                  gb_desc_b(ring_s + slot * GB_SLOT), st > 0);
    tc_wgmma_commit();
    if (st > 0) {
      cb_wgmma_wait1();  // the step before is done: its slot is free
      if (!(GB_PROBE & 8)) cb_release(&empty[(s - 1) % GB_SLOTS], cs, wt);
    }
  }
  tc_wgmma_wait();
  gb_fence_acc(acc);
  if (!(GB_PROBE & 8)) cb_release(&empty[(s - 1) % GB_SLOTS], cs, wt);
}

// The final rows' product, NF outputs, gb_fin_steps(NF) k steps an item.
template <int NF>
__device__ __forceinline__ void gb_fin_product(float (&acc)[128], int steps, uint32_t a_s,
                                               uint32_t ring_s, uint64_t* full, uint64_t* empty,
                                               int& s, int cs, int wt) {
  constexpr int FK = GB_SLOT / (NF * 32);
  for (int st = 0, item = 0; st < steps; ++item, ++s) {
    const int slot = s % GB_SLOTS;
    if (!(GB_PROBE & 8)) cb_wait(&full[slot], (s / GB_SLOTS) & 1);
    for (int j = 0; j < FK && st < steps; ++j, ++st) {
      tc_wgmma_fence();
      if (!(GB_PROBE & 1))
        gb_wgmma<NF>(acc, gb_desc_a(a_s + (st >> 2) * 8192 + (st & 3) * 32),
                     gb_desc_b(ring_s + slot * GB_SLOT + j * NF * 32), st > 0);
      tc_wgmma_commit();
    }
    if (item > 0) {
      cb_wgmma_wait1();  // the item before is done
      if (!(GB_PROBE & 8)) cb_release(&empty[(s - 1) % GB_SLOTS], cs, wt);
    }
  }
  tc_wgmma_wait();
  gb_fence_acc(acc);
  if (!(GB_PROBE & 8)) cb_release(&empty[(s - 1) % GB_SLOTS], cs, wt);
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

// Threads 0-255: the consumer warpgroups; 256-383: the producer warpgroup
// (warp 8's lane 0 produces).
__global__ void __launch_bounds__(GB_THREADS, 1)
grid_bf16_kernel(const float* __restrict__ prm, const __grid_constant__ GbPlan p,
                 const float* __restrict__ scal, float* __restrict__ out,
                 uint8_t* __restrict__ scratch) {
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
  const uint32_t a_s = tc_smem(sm + wg * GB_BUF), ring_s = tc_smem(sm + GB_OFF_RING);
  const float* ring = reinterpret_cast<const float*>(sm + GB_OFF_RING);
  // this lane's stmatrix rows: point 16 (warp % 4) + 8 (lane / 8 % 2) + lane % 8, the
  // output pair 8 (2q + lane / 16) of a block of 64
  uint32_t rows[4];
  {
    const int pt = 16 * (warp & 3) + 8 * ((lane >> 3) & 1) + (lane & 7), sel = (lane >> 4) & 1;
#pragma unroll
    for (int q = 0; q < 4; ++q) rows[q] = pt * 128 + ((((2 * q + sel) ^ pt) & 7) << 4);
  }
  const float ox = __ldg(scal), oy = __ldg(scal + 1), oz = __ldg(scal + 2), voxel = __ldg(scal + 3);
  const int nsq = p.n * p.n;
  // the scratch of a layer's first streamed half where its rows are still
  // the layer's input (in_pad > GB_HALF)
  uint4* scr = reinterpret_cast<uint4*>(scratch + ((size_t)blockIdx.x * 2 + wg) * GB_SCRATCH);
  float acc[128];
  int s = 0;  // ring items taken
  clk.tick(3);
  for (int it = 0; it < iters; ++it) {
    const int first = ((cid + it * clusters) * cs + rank) * GB_P + wg * GB_WP;
    float xyz[6];  // the index arithmetic of decoder_kernel.py:633-638, in int32
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int idx = p.base + min(first + p0 + 8 * k, p.m - 1);
      xyz[3 * k] = __fadd_rn(__fmul_rn((float)(idx / nsq % p.n), voxel), ox);
      xyz[3 * k + 1] = __fadd_rn(__fmul_rn((float)(idx / p.n % p.n), voxel), oy);
      xyz[3 * k + 2] = __fadd_rn(__fmul_rn((float)(idx % p.n), voxel), oz);
    }
    float sdf[4] = {0.f, 0.f, 0.f, 0.f};
    clk.tick(3);
    for (int t = 0; t < p.n_trunks; ++t) {
      const GbTrunk& T = p.trunks[t];
      for (int l = 0; l < T.n_hidden; ++l) {
        const GbLayer& L = T.layers[l];
        const int halves = (L.out_pad + GB_HALF - 1) / GB_HALF;
        const bool spill = halves > 1 && L.in_pad > GB_HALF;
        for (int h = halves - 1; h >= 0; --h) {  // the last half first
          const int width = gb_width(L.out_pad, h);
          if (L.in_pad > 0) {
            if (width == GB_HALF)
              gb_product<GB_HALF>(acc, L.in_pad / 16, a_s, ring_s, full, empty, s, cs, wt);
            else
              gb_product<128>(acc, L.in_pad / 16, a_s, ring_s, full, empty, s, cs, wt);
            clk.tick(0);
          }
          const int slot = s % GB_SLOTS;
          if (!(GB_PROBE & 8)) cb_wait(&full[slot], (s / GB_SLOTS) & 1);
          clk.tick(4);
          // the last half writes rows the products read (layer 0's first, rows the
          // trunk before's final rows read): every warp's products past them first
          if (h == 0 || l == 0) gb_bar_sync(1 + wg, 128);
          clk.tick(5);
          gb_epilogue(acc, L.in_pad > 0, ring + slot * (GB_SLOT / 4), width, L.has_x, xyz,
                      a_s + h * (GB_HALF / 64) * 8192, rows, spill && h > 0 ? scr : nullptr, wt,
                      t4);
          clk.tick(1);
          if (spill && h == 0)  // the first streamed half back, now that the input is dead
            gb_reload(scr, gb_width(L.out_pad, 1), a_s + (GB_HALF / 64) * 8192, rows, wt);
          if (h == 0) tc_fence_proxy_async();  // the rows, for wgmma
          gb_bar_sync(1 + wg, 128);  // the slot's reads done (and the rows whole)
          clk.tick(5);
          if (!(GB_PROBE & 8)) cb_release(&empty[slot], cs, wt);
          ++s;
          clk.tick(1);
        }
      }
      const int steps = T.last_pad / 16;
      switch (T.nf) {
        case 8: gb_fin_product<8>(acc, steps, a_s, ring_s, full, empty, s, cs, wt); break;
        case 16: gb_fin_product<16>(acc, steps, a_s, ring_s, full, empty, s, cs, wt); break;
        case 32: gb_fin_product<32>(acc, steps, a_s, ring_s, full, empty, s, cs, wt); break;
        case 64: gb_fin_product<64>(acc, steps, a_s, ring_s, full, empty, s, cs, wt); break;
        default: gb_fin_product<128>(acc, steps, a_s, ring_s, full, empty, s, cs, wt); break;
      }
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

// Host: reads a descriptor ([n_trunks, fin_b, rows, n_rows, then per trunk
// n_hidden, fin, fin_xyz, last_pad, then per hidden layer w, x, b, in_pad,
// out_pad]; offsets in floats, -1 = absent; ops/grid_plan's bf16 packing,
// kernels/grid_decoder.py:pack_grid_plan_bf16) into p and says whether the
// kernel takes it: 1-2 trunks of 1-8 hidden layers, widths padded to 128 up
// to 512, layer 0 without a product, each later layer reading the one
// before, 2-128 rows, and every trunk's items one contiguous stream in the
// kernel's order (w: the tiles of the first streamed half, its last, b: its
// epilogue block, x = b + its width, fin: the final rows' tiles right after
// the last layer's).
static bool gb_take_plan(GbPlan& p, const int* desc, int desc_len) {
  if (desc_len < 4) return false;
  p.n_trunks = desc[0];
  p.fin_b = desc[1];
  p.n_rows = desc[3];
  if (p.n_trunks < 1 || p.n_trunks > GB_MAX_TRUNKS || p.fin_b < 0) return false;
  if (p.n_rows < 2 || p.n_rows > GB_MAX_ROWS || desc[2] > GB_MAX_OUT) return false;
  int pos = 4;
  for (int t = 0; t < p.n_trunks; ++t) {
    GbTrunk& T = p.trunks[t];
    if (pos + 4 > desc_len) return false;
    T.n_hidden = desc[pos];
    const int fin = desc[pos + 1];
    T.fin_xyz = desc[pos + 2];
    T.last_pad = desc[pos + 3];
    pos += 4;
    T.rows = t == 0 ? p.n_rows : 2;
    T.nf = gb_fin_width(T.rows);
    if (T.n_hidden < 1 || T.n_hidden > GB_MAX_HIDDEN || pos + 5 * T.n_hidden > desc_len)
      return false;
    int cursor = 0, prev = 0;
    for (int l = 0; l < T.n_hidden; ++l, pos += 5) {
      const int w = desc[pos], x = desc[pos + 1], b = desc[pos + 2];
      GbLayer& L = T.layers[l];
      L.in_pad = desc[pos + 3];
      L.out_pad = desc[pos + 4];
      L.has_x = x >= 0;
      if (L.out_pad < 128 || L.out_pad % 128 || L.out_pad > GB_MAX_OUT) return false;
      if (l == 0 ? (w >= 0 || L.in_pad != 0) : (w < 0 || L.in_pad != prev)) return false;
      if (l == 0) cursor = T.stream = b;
      if ((l == 0 ? b : w) != cursor || cursor < 0 || cursor % 4) return false;
      const int top = (L.out_pad - 1) / GB_HALF;
      for (int h = top; h >= 0; --h) {  // the last half first
        const int width = gb_width(L.out_pad, h);
        cursor += L.in_pad / 16 * width * 8;  // the k steps' tiles: width x 16 bf16 each
        if (h == top && (b != cursor || (L.has_x && x != b + width))) return false;
        cursor += gb_epi_floats(width, L.has_x);
      }
      prev = L.out_pad;
    }
    if (T.last_pad != prev || fin != cursor) return false;
  }
  return pos == desc_len;
}

// The bytes of the items a tile of points reads: every trunk's stream.
static long long gb_stream_bytes(const GbPlan& p) {
  long long bytes = 0;
  for (int t = 0; t < p.n_trunks; ++t) {
    const GbTrunk& T = p.trunks[t];
    for (int l = 0; l < T.n_hidden; ++l)
      for (int h = 0; GB_HALF * h < T.layers[l].out_pad; ++h) {
        const int width = gb_width(T.layers[l].out_pad, h);
        bytes += (long long)T.layers[l].in_pad / 16 * width * 32
                 + 4 * gb_epi_floats(width, T.layers[l].has_x);
      }
    bytes += (long long)T.last_pad / 16 * T.nf * 32;
  }
  return bytes;
}

// Launches the kernel over indices base .. base + m - 1 of the n^3 grid in
// clusters of GB_CLUSTER, as many clusters as fit the card at once, with
// `scratch_bytes` of scratch (GB_SCRATCH a warpgroup of the grid); with
// `plan` (GB_PLAN_INTS: shared memory bytes, points a block, cluster, grid
// blocks, ring slots, a tile's stream bytes (low 31 bits, the rest))
// launches nothing.  0, -1 for a plan or arguments the kernel does not
// take, WB_ERR_CLUSTER, or a CUDA error.
static int launch_grid_bf16(const float* prm, const int* desc, int desc_len, const float* scal,
                            long long base, int m, int n, float* out, uint8_t* scratch,
                            long long scratch_bytes, cudaStream_t stream, int* plan = nullptr) {
  GbPlan p;
  if (!gb_take_plan(p, desc, desc_len)) return -1;
  if (m <= 0 || n <= 0 || base < 0 || (long long)n * n * n >= (1LL << 31)
      || base + m > (long long)n * n * n)
    return -1;
  p.n = n;
  p.base = (int)base;
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
  static int fits = 0;  // clusters the card runs at once
  if (!fits) {
    cudaError_t err = cudaFuncSetAttribute(grid_bf16_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, GB_SMEM);
    if (err != cudaSuccess) return (int)err;
    cfg.gridDim = dim3(GB_CLUSTER);
    err = cudaOccupancyMaxActiveClusters(&fits, (const void*)grid_bf16_kernel, &cfg);
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
  void* args[] = {(void*)&prm, &p, (void*)&scal, &out, &scratch};
  const cudaError_t err = cudaLaunchKernelExC(&cfg, (const void*)grid_bf16_kernel, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
