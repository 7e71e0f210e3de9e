// The train backwards' weight-gradient reduction in bf16 (K2's, K4's and
// K5's bf16 backwards; JAX's mm_t_lhs, dW += x_bf16^T . dpre.astype(bf16)
// with float32 sums, alignsdf_tpu/ops/decoder_train_kernel.py:609-627):
// C (K, N) float32 += A (K, m) . B (N, m)^T, A and B bf16, feature-major
// with row stride m, C holding zeros or a sum to add to.  The products of
// bf16 values are exact in float32; the tensor cores sum them in float32.
// wgrad_tc.cuh's launch_wgrad dispatches bf16 operands here; its float32
// route (split TF32) is another design.
//
// What bounds it: bytes, nearly as much as operations.  A 512 x 512 layer
// over 128,000 points reads 0.26 GB (0.078 ms at 3.35 TB/s) for 67 GFLOP
// (0.068 ms at 989 TFLOP/s dense bf16); a narrow call (K = 6 or 9, N = 1)
// is bound by reading its wide operand once.
//
// Design:
//  - Tiles.  A block owns a 128 x BN tile of C (BN = 256; 128 where N <=
//    128, 32 where N <= 32) over one chunk of points, in stages of 64
//    points (a 128-byte row of bf16: 4 k steps of 16).  Two consumer
//    warpgroups of 64 rows each run wgmma.m64nBNk16 with both operands read
//    from shared memory by descriptor: 128-byte swizzle, K-major as the
//    operands lie (the points are wgmma's K).  Each waits for its stage's
//    products and releases the slot at once; the other warpgroup's
//    products keep the tensor cores busy meanwhile.  No group is kept in
//    flight: that would return each slot a stage later, and the ring (four
//    48 KB stages) is what bounds the bytes in flight (PERF.md).
//  - Loads: TMA.  2-D tensor maps of A and B (points innermost, boxes of 64
//    points x rows, 128-byte swizzle, zeros past m, K and N) are encoded on
//    the host every call (cuTensorMapEncodeTiled through the runtime's
//    driver entry point: no -lcuda) and passed as __grid_constant__
//    parameters.  One thread of a producer warpgroup (which gives its
//    registers to the consumers by setmaxnreg) runs a ring of RING stages
//    with full and empty mbarriers; no barrier of the whole block in the
//    main loop.  The consumers release a slot to every block of the cluster
//    with a CTA-scope arrive: a cluster-scope release there fenced every
//    stage and made a step's reductions 1.4-1.7x slower (PERF.md).
//  - Clusters.  The blocks of a cluster share one chunk and split ck x cn
//    of C's tiles between them.  Each strip of A (a row of tiles) and of B
//    (a column) is read from L2 once per cluster and multicast to every
//    block that needs it, the blocks of the row or column each loading a
//    piece; a block's empty barriers count the consumers of the whole
//    cluster, and its producer waits for the last stages' releases before
//    it leaves (no block exits while another may still signal it).  L2
//    reads: A tiles_n / cn and B tiles_k / ck times (a 512 x 512 layer's 4 x
//    2 tiles are one cluster of 8: each operand read once).  The cluster is
//    two tiles along N where they pair up, then a power of two along K that
//    divides its tiles (K5's 262-row x0 takes pairs along N).
//  - Chunks.  About one wave of clusters in all
//    (cudaOccupancyMaxActiveClusters), each chunk at most WB_MAX_CHUNK
//    points: a 512 x 512 layer over 128,000 points runs 15 chunks of 8,576
//    (15 clusters of 8 fit an H100 at once).
//    The float32 route's 2,048-point cap bounds split TF32's error, which
//    bf16 does not have; the tensor cores' float32 sums over 8,576 points
//    stay well inside the tests' 1e-6 of |A_k| |B_n| (1.1e-7-1.4e-7 at 512
//    x 512, PERF.md).
//  - Atomics.  A block stages its tile in shared memory (over the ring) and
//    a warp adds a row of it into C at a time, 16-byte atomicAdd where N %
//    4 == 0 and C is aligned: K x N / 4 atomics a chunk.
//  - Launches.  The first reduction after a backward's chain, which wrote
//    its dpre, is launched in the usual way.  Each later one is launched
//    with overlap (programmatic dependent launch): its operands were
//    complete before the first began, so it loads and multiplies while the
//    grid before it drains, and waits for that grid (griddepcontrol.wait)
//    only ahead of its atomics.  A kernel launched after them in the usual
//    way starts once the last is done, and the last once every one before
//    it is.  PERF.md times a step's reductions both ways.
//  - Narrow calls.  A stage holds only the rows that exist (K = 6 or 9: 8
//    or 16 rows of A; N = 1: 8 rows of B), a warpgroup whose 64 rows lie
//    past K issues no product, and N <= 32 takes the n32 kernel, so such a
//    call costs about a read of its wide operand.
//  - Rows TMA cannot describe (a row stride m % 8 != 0, such as m = 4004,
//    or operands not 16-byte aligned) are copied by the producer
//    warpgroup itself, 8 bytes a thread, into the same swizzled stages, in
//    clusters of one block.

#pragma once

#include <cuda.h>  // CUtensorMap and the encoder's types (no driver symbol is linked)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>

#include "wgmma_tf32.cuh"  // tc_smem, tc_desc_sw128, the wgmma fences, the mbarriers

#define WB_BM 128          // rows of C a block: two consumer warpgroups of 64
#define WB_BP 64           // points a stage: a 128-byte row of bf16
#define WB_ROW 128         // bytes of a stage's row: the swizzle's span
#define WB_RING_BYTES (192 * 1024)  // the ring's shared memory
#define WB_THREADS 384     // two consumer warpgroups, then the producer's
#define WB_MAX_CLUSTER 8   // blocks a cluster at most: the portable size
#define WB_MAX_CHUNK 16384
#define WB_ERR_ENCODER -2  // cuTensorMapEncodeTiled not found
#define WB_ERR_ENCODE -3   // a tensor map refused
#define WB_ERR_CLUSTER -4  // no cluster of the launch's shape fits the card

// What a launch computes: the operands, and the launcher's plan.
struct WbArgs {
  const __nv_bfloat16* A;
  const __nv_bfloat16* B;
  float* C;
  int K, N, m, chunk;
  int groups_k, groups;  // the clusters' groups of tiles: along K, in all
  int ck, cn;            // a cluster's tiles: ck along K x cn along N
  int a_rows, b_rows;    // rows of A and of B a stage holds
  int a_piece, b_piece;  // rows of the piece each loading block of a row / column loads
  int tma;               // stages load by TMA, else the producer warpgroup copies them
  int vec_out;           // C takes 16-byte atomics
};

__device__ __forceinline__ int wb_cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return (int)r;
}

__device__ __forceinline__ int wb_cluster_id() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(r));
  return (int)r;
}

__device__ __forceinline__ void wb_cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// Arrives on the mbarrier at bar's offset in block `rank` of the cluster
// (release at the CTA's scope, the default: the consumers' reads it orders
// are wgmma's, complete by then; a cluster-scope release fenced every stage).
__device__ __forceinline__ void wb_arrive_cluster(uint64_t* bar, int rank) {
  asm volatile("{\n.reg .b32 remote;\n"
               "mapa.shared::cluster.u32 remote, %0, %1;\n"
               "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n"
               :: "r"(tc_smem(bar)), "r"(rank) : "memory");
}

__device__ __forceinline__ void wb_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(tc_smem(bar)) : "memory");
}

// The box of `map` at (point x, row y) into shared dst, counted on bar: in
// every block of `mask` (at the same offsets there), or in this one.
__device__ __forceinline__ void wb_tma_load(uint32_t dst, const CUtensorMap* map, uint64_t* bar,
                                            int x, int y, uint16_t mask, bool multicast) {
  if (multicast) {
    asm volatile("cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
                 ".multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;"
                 :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(tc_smem(bar)), "r"(x),
                    "r"(y), "h"(mask) : "memory");
  } else {
    asm volatile("cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
                 " [%0], [%1, {%3, %4}], [%2];"
                 :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(tc_smem(bar)), "r"(x),
                    "r"(y) : "memory");
  }
}

// Rows r0 .. r0 + rows - 1 of X (R rows, row stride m) at points x .. x + 63
// into a stage's tile as TMA lays it (row r's 16-byte column q at q ^ (r %
// 8)), zeros past R or m: 8 bytes a thread of the producer warpgroup (t)
// and step.  m % 4 == 0 and X 8-byte aligned, so a copy is all in or out.
__device__ __forceinline__ void wb_copy_rows(uint8_t* tile, const __nv_bfloat16* __restrict__ X,
                                             int R, int r0, int rows, int x, int m, int t) {
#pragma unroll 4
  for (int u = t; u < rows * 16; u += 128) {
    const int r = u >> 4, q = u & 15, pt = x + 4 * q;
    uint2 v = make_uint2(0u, 0u);
    if (r0 + r < R && pt < m)
      v = __ldg(reinterpret_cast<const uint2*>(X + (size_t)(r0 + r) * m + pt));
    *reinterpret_cast<uint2*>(tile + r * WB_ROW + ((((q >> 1) ^ r) & 7) << 4) + ((q & 1) << 3)) =
        v;
  }
}

template <int R>
__device__ __forceinline__ void wb_fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// Releases a stage's slot in every block of the cluster: threads 0 .. cs - 1
// of the warpgroup (t) arrive, one a block.
__device__ __forceinline__ void wb_release(uint64_t* bar, int cs, int t) {
  if (t < cs) wb_arrive_cluster(bar, t);
}

// d[BN / 2] += A (64 x 16 at da) x B^T (BN x 16 at db), both bf16 K-major in
// shared memory; d[4i + r]: row 16 warp + lane/4 (+ 8 for r >= 2), column
// 8i + 2 (lane%4) (+ 1 for odd r).
template <int BN>
__device__ __forceinline__ void wb_wgmma(float (&d)[BN / 2], uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void wb_wgmma<256>(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wb_wgmma<128>(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
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

template <>
__device__ __forceinline__ void wb_wgmma<32>(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}


// One block of a cluster: its 128 x BN tile of C over its cluster's chunk.
// Threads 0-255 are the consumers (warpgroups 0 and 1: rows 0-63, 64-127 of
// the tile), 256-383 the producer warpgroup.
template <int BN, int RING>
__global__ void __launch_bounds__(WB_THREADS, 1)
wgrad_bf16_tc_kernel(const __grid_constant__ CUtensorMap a_map,
                     const __grid_constant__ CUtensorMap b_map, const WbArgs p) {
  constexpr int A_BYTES = WB_BM * WB_ROW, STAGE = A_BYTES + BN * WB_ROW;
  // the staged tile's row stride in floats: a warp's float2 stores take 2 wavefronts
  constexpr int LD = BN + 8;
  static_assert(WB_BM * LD * 4 <= RING * STAGE, "the staged tile fits over the ring");
  extern __shared__ uint8_t wb_raw[];
  uint8_t* smem = wb_raw + ((1024 - (tc_smem(wb_raw) & 1023)) & 1023);  // the swizzle's 1 KB atoms
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + RING * STAGE);
  uint64_t* empty = full + RING;
  const int cs = p.ck * p.cn, tid = threadIdx.x, warp = tid >> 5;
  const int rank = wb_cluster_rank(), cluster = wb_cluster_id();
  const int group = cluster % p.groups, ik = rank % p.ck, in = rank / p.ck;
  const int k0 = ((group % p.groups_k) * p.ck + ik) * WB_BM;
  const int n0 = ((group / p.groups_k) * p.cn + in) * BN;
  const int p_begin = (cluster / p.groups) * p.chunk, p_end = min(p.m, p_begin + p.chunk);
  const int stages = p_end > p_begin ? (p_end - p_begin + WB_BP - 1) / WB_BP : 0;
  if (tid == 0) {
    for (int i = 0; i < RING; ++i) {
      tc_mbar_init(full + i, 1);
      tc_mbar_init(empty + i, 2 * cs);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  wb_cluster_sync();  // every block's barriers are set before a load or an arrival reaches them
  // a next launch with overlap (programmatic dependent launch) may place its
  // blocks as this grid's blocks leave.  Such a launch reads only operands
  // complete before this grid began; it waits for this grid (and so for
  // every one before it) ahead of its atomics, so a kernel launched after
  // it in the usual way finds them all done
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");

  if (warp >= 8) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (p.tma) {
      if (tid != 256) return;
      const bool a_go = in * p.a_piece < p.a_rows, b_go = ik * p.b_piece < p.b_rows;
      uint32_t a_mask = 0, b_mask = 0;  // the blocks of this block's tile row, and column
      for (int j = 0; j < p.cn; ++j) a_mask |= 1u << (ik + p.ck * j);
      for (int i = 0; i < p.ck; ++i) b_mask |= 1u << (i + p.ck * in);
      const uint32_t base = tc_smem(smem);
      // the last RING turns only wait: the cluster's consumers have released
      // every stage (no more arrivals will reach this block) before it leaves
      for (int s = 0; s < stages + RING; ++s) {
        const int slot = s % RING;
        if (s >= RING) tc_mbar_wait(empty + slot, ((s / RING) - 1) & 1);
        if (s >= stages) continue;
        tc_mbar_expect_tx(full + slot, (p.a_rows + p.b_rows) * WB_ROW);
        const int x = p_begin + s * WB_BP;
        const uint32_t st = base + slot * STAGE;
        if (a_go)
          wb_tma_load(st + in * p.a_piece * WB_ROW, &a_map, full + slot, x, k0 + in * p.a_piece,
                      (uint16_t)a_mask, a_mask != (1u << rank));
        if (b_go)
          wb_tma_load(st + A_BYTES + ik * p.b_piece * WB_ROW, &b_map, full + slot, x,
                      n0 + ik * p.b_piece, (uint16_t)b_mask, b_mask != (1u << rank));
      }
    } else {  // a cluster of one: the warpgroup copies each stage
      const int t = tid - 256;
      for (int s = 0; s < stages; ++s) {
        const int slot = s % RING;
        if (s >= RING) tc_mbar_wait(empty + slot, ((s / RING) - 1) & 1);
        const int x = p_begin + s * WB_BP;
        uint8_t* st = smem + slot * STAGE;
        wb_copy_rows(st, p.A, p.K, k0, p.a_rows, x, p.m, t);
        wb_copy_rows(st + A_BYTES, p.B, p.N, n0, p.b_rows, x, p.m, t);
        tc_fence_proxy_async();
        asm volatile("bar.sync 1, 128;" ::: "memory");  // the producer warpgroup's copies are done
        if (t == 0) wb_arrive(full + slot);
      }
    }
    return;
  }

  // the consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int wg = warp >> 2, lane = tid & 31, t = tid & 127;
  const bool rows_on = k0 + 64 * wg < p.K;  // uniform over the warpgroup
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int s = 0; s < stages; ++s) {
    const int slot = s % RING;
    tc_mbar_wait(full + slot, (s / RING) & 1);
    if (rows_on) {
      const uint8_t* st = smem + slot * STAGE;
      const float* a = reinterpret_cast<const float*>(st + wg * 64 * WB_ROW);
      const float* b = reinterpret_cast<const float*>(st + A_BYTES);
      tc_wgmma_fence();
#pragma unroll
      for (int j = 0; j < WB_BP / 16; ++j)  // k step j: 32 bytes into each row
        wb_wgmma<BN>(acc, tc_desc_sw128(a + 8 * j), tc_desc_sw128(b + 8 * j));
      tc_wgmma_commit();
      tc_wgmma_wait();  // this stage's products are done
      wb_fence_acc(acc);
    }
    wb_release(empty + slot, cs, t);
  }

  // the tile into C: staged over the ring (both warpgroups' products are
  // done and every stage has landed), then a warp a row, along it
  asm volatile("bar.sync 2, 256;" ::: "memory");
  // the grid before this one is done (at once where launched without overlap)
  asm volatile("griddepcontrol.wait;" ::: "memory");
  float* tile = reinterpret_cast<float*>(smem);
  if (rows_on) {
    const int r = 64 * wg + 16 * (warp & 3) + (lane >> 2);
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int c = 8 * i + 2 * (lane & 3);
      *reinterpret_cast<float2*>(tile + r * LD + c) = make_float2(acc[4 * i], acc[4 * i + 1]);
      *reinterpret_cast<float2*>(tile + (r + 8) * LD + c) =
          make_float2(acc[4 * i + 2], acc[4 * i + 3]);
    }
  }
  asm volatile("bar.sync 2, 256;" ::: "memory");
  for (int r = warp; r < WB_BM && k0 + r < p.K; r += 8) {
    float* crow = p.C + (size_t)(k0 + r) * p.N;
    for (int c = 4 * lane; c < BN && n0 + c < p.N; c += 128) {
      const float4 v = *reinterpret_cast<const float4*>(tile + r * LD + c);
      float* dst = crow + n0 + c;
      if (p.vec_out) {
        atomicAdd(reinterpret_cast<float4*>(dst), v);
      } else {
        const int left = p.N - n0 - c;
        atomicAdd(dst, v.x);
        if (left > 1) atomicAdd(dst + 1, v.y);
        if (left > 2) atomicAdd(dst + 2, v.z);
        if (left > 3) atomicAdd(dst + 3, v.w);
      }
    }
  }
}

typedef CUresult (*WbEncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static WbEncodeTiled wb_encoder() {
  static WbEncodeTiled fn = nullptr;
  if (!fn) {
    void* entry = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &entry,
                                                             12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &entry,
                                                    cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<WbEncodeTiled>(entry);
  }
  return fn;
}

// The tensor map of X (rows x m bf16, row stride m, 16-byte aligned, m % 8
// == 0) in boxes of 64 points x box_rows rows, 128-byte swizzle, zeros out
// of bounds.  0, or WB_ERR_ENCODER / WB_ERR_ENCODE.
static int wb_map(CUtensorMap* map, const void* X, int rows, int m, int box_rows) {
  const WbEncodeTiled encode = wb_encoder();
  if (!encode) return WB_ERR_ENCODER;
  const cuuint64_t dims[2] = {(cuuint64_t)m, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)m * 2};
  const cuuint32_t box[2] = {WB_BP, (cuuint32_t)box_rows}, steps[2] = {1, 1};
  const CUresult rc = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(X), dims,
                             strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : WB_ERR_ENCODE;
}

// The launch plan's numbers, in this order, for the smoke's report.
#define WB_PLAN_INTS 12

// Plans and launches one BN's kernel (overlap: see launch_wgrad_bf16); with
// `plan`, fills it (WB_PLAN_INTS: BN, ck, cn, chunk, chunks, tma, a_rows,
// b_rows, a_piece, b_piece, the clusters that fit the card at once,
// vec_out) and launches nothing.
template <int BN>
static int wb_launch(const __nv_bfloat16* A, const __nv_bfloat16* B, float* C, int K, int N,
                     int m, cudaStream_t stream, bool overlap, int* plan) {
  constexpr int RING = WB_RING_BYTES / ((WB_BM + BN) * WB_ROW);  // 4 stages at BN = 256
  constexpr int SMEM = RING * (WB_BM + BN) * WB_ROW + 1024 + 2 * RING * 8;
  const void* kernel = (const void*)wgrad_bf16_tc_kernel<BN, RING>;
  static bool ready = false;
  static int fit[WB_MAX_CLUSTER + 1] = {};  // clusters of each size the card holds at once
  if (!ready) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  WbArgs a = {};
  a.A = A;
  a.B = B;
  a.C = C;
  a.K = K;
  a.N = N;
  a.m = m;
  a.tma = m % 8 == 0 && (uintptr_t)A % 16 == 0 && (uintptr_t)B % 16 == 0;
  a.vec_out = N % 4 == 0 && (uintptr_t)C % 16 == 0;
  const int tiles_k = (K + WB_BM - 1) / WB_BM, tiles_n = (N + BN - 1) / BN;
  // the cluster: two tiles along N where they pair up, then as many along
  // K as divide its tiles, a power of two in all, at most WB_MAX_CLUSTER
  a.cn = a.tma && tiles_n % 2 == 0 && WB_MAX_CLUSTER > 1 ? 2 : 1;
  a.ck = 1;
  for (int d = WB_MAX_CLUSTER / a.cn; a.tma && d > 1; d /= 2)
    if (tiles_k % d == 0) {
      a.ck = d;
      break;
    }
  const int cs = a.ck * a.cn;
  a.groups_k = tiles_k / a.ck;
  a.groups = a.groups_k * (tiles_n / a.cn);
  // the rows that exist where one tile spans them; pieces of whole 8-row
  // swizzle atoms, else one block loads the whole strip
  a.a_rows = tiles_k == 1 ? (K + 7) / 8 * 8 : WB_BM;
  a.b_rows = tiles_n == 1 ? std::min(BN, (N + 7) / 8 * 8) : BN;
  a.a_piece = a.a_rows % (8 * a.cn) == 0 ? a.a_rows / a.cn : a.a_rows;
  a.b_piece = a.b_rows;
  for (int d = a.ck; d > 1; --d)
    if (a.ck % d == 0 && a.b_rows % (8 * d) == 0) {
      a.b_piece = a.b_rows / d;
      break;
    }
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(WB_THREADS);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (!fit[cs]) {
    cfg.gridDim = dim3(cs);
    const cudaError_t err = cudaOccupancyMaxActiveClusters(&fit[cs], kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (fit[cs] < 1) return WB_ERR_CLUSTER;
  }
  // about one wave of clusters; a chunk a whole number of stages, at least
  // 4 and at most WB_MAX_CHUNK points
  int chunks = std::max(fit[cs] / a.groups, (m + WB_MAX_CHUNK - 1) / WB_MAX_CHUNK);
  chunks = std::max(1, std::min(chunks, (m + 4 * WB_BP - 1) / (4 * WB_BP)));
  a.chunk = ((m + chunks - 1) / chunks + WB_BP - 1) / WB_BP * WB_BP;
  chunks = (m + a.chunk - 1) / a.chunk;
  if (plan) {
    const int v[WB_PLAN_INTS] = {BN, a.ck, a.cn, a.chunk, chunks, a.tma, a.a_rows,
                                 a.b_rows, a.a_piece, a.b_piece, fit[cs], a.vec_out};
    memcpy(plan, v, sizeof v);
    return 0;
  }
  CUtensorMap a_map, b_map;
  memset(&a_map, 0, sizeof a_map);
  memset(&b_map, 0, sizeof b_map);
  if (a.tma) {
    int rc = wb_map(&a_map, A, K, m, a.a_piece);
    if (!rc) rc = wb_map(&b_map, B, N, m, a.b_piece);
    if (rc) return rc;
  }
  cfg.gridDim = dim3((unsigned)(cs * a.groups * chunks));
  cfg.numAttrs = overlap ? 2 : 1;
  void* args[] = {&a_map, &b_map, &a};
  const cudaError_t err = cudaLaunchKernelExC(&cfg, kernel, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// C (K, N) += A (K, m) . B (N, m)^T in bf16 (see above).  overlap: the
// launch may start in the tail of the kernel before it on the stream
// (programmatic dependent launch), for a caller whose A and B were complete
// before that kernel began (the backwards: every reduction but the first
// after their chain).  Returns 0, -1 for m % 4 != 0 or operands not 8-byte
// aligned, a WB_ERR_* code, or a CUDA error; with `plan`, fills the plan
// (wb_launch) and launches nothing.
static int launch_wgrad_bf16(const __nv_bfloat16* A, const __nv_bfloat16* B, float* C, int K,
                             int N, int m, cudaStream_t stream, bool overlap = false,
                             int* plan = nullptr) {
  if (K <= 0 || N <= 0 || m <= 0) return 0;
  if (m % 4 || (uintptr_t)A % 8 || (uintptr_t)B % 8) return -1;
  if (N <= 32) return wb_launch<32>(A, B, C, K, N, m, stream, overlap, plan);
  if (N <= 128) return wb_launch<128>(A, B, C, K, N, m, stream, overlap, plan);
  return wb_launch<256>(A, B, C, K, N, m, stream, overlap, plan);
}
