// The train forwards of kernels K2, K4 and K5 on Hopper's tensor cores.
// Per point (row r of M, scene r / nps), for each trunk, hidden layer l
// computes
//   acc_l = a_{l-1} W_l (if W) + lat Lat_l (K4's latent layers; K5's head,
//           x0's leading columns, with X_l[:h] as Lat_l)
//           + emb X_l (if X; K5's tail, x0's other columns)
//           + b_l[scene] (K2's scene-bias layers) or b_l,
//   a_l   = gate(relu(acc_l)),
// gate = gate_hash(seed, layer, r, lane) < thresh ? s : 0 on dropout layers,
// and writes a_l to device memory as the residual (out_pad, M) that the
// backward reads (chain_tc.cuh's gates, wgrad_tc.cuh); the final layer
// gives y = tanh(a_last W_last + b_last), plus, where latent_in names it,
// the re-injected inputs' terms (fw_final's FwIn: K2's embedding and scene
// bias row, K4's latent residual and embedding, K5's x0) on the CUDA cores,
// their weights read through L1 and their rows from L2; no shared memory
// beyond the trunk's.
//
// The design is the grid trunk's (grid_trunk_tc.cuh), for training.  A
// block of TC_THREADS threads owns TC_P = 64 points.  Their activations stay
// in one shared-memory buffer as [feature][point] (tc_swz), updated in
// place layer by layer.  A layer's product reads its input rows as wgmma's
// A, split in registers, and its weights as B: tile_weights(W), or for K4's
// latent layers [W; Lat] as one run of tiles over [activation; latent]
// rows, the latent in the rows right above the activation, as K3 has it
// (K5: [W; X[:h]] over [activation; head], the head loaded from x0).
// The tiles are split and tiled once a step when the trunk is packed, laid
// out as one stream in the order the forward reads them (layer by layer,
// trunk after trunk), and stream through the trunk's ring (tc_fill,
// tc_steps) by bulk copy; nothing else goes through the ring.  Split TF32
// (three products a k step) keeps float32's accuracy
// (tests/test_torch_train_fwd_tc.py emulates the whole forward).
//
// The epilogue runs on the CUDA cores, where the grid trunk adds its xyz
// terms (tc_epilogue): the embedding's e columns (X and the block's
// embedding read through L1), the bias (a 64-point tile straddles scenes,
// 2000 % 64 = 16, so each point reads its own scene's row of b), ReLU and
// the gate, into the buffer.  The gate hashes exactly the units the thread
// holds, rows first + p0 (+ 8) and lanes 128 j + 8 i + 2 t4 (+ 1), with the
// row's and the layer's terms hoisted (fw_key).  Then one coalesced pass
// stores the layer's rows to the residual (a feature row of 64 points is
// 256 contiguous bytes); no barrier follows it, so the stores drain while
// the next layer's products run.  The final rows (1-2) stay float32 dot
// products on the CUDA cores, then tanh.
//
// What bounds it: arithmetic.  K2 at the flagship widths (512 -> 250 ->
// 512 -> 512 -> 1, 6 embedding columns) is 0.525 M multiply-adds a point a
// trunk (0.268 TFLOP a step of two trunks over 128,000 points), split TF32
// 1.63 ms at the tensor cores' dense TF32 rate; K4's 0.787 M (C = 256;
// 0.403 TFLOP), 2.44 ms.  The residuals, 7 KB a point a trunk (1.8 GB a K2
// step), take 0.55 ms at HBM's rate.  The epilogue, the stores, the final
// rows and K4's gather run while the tensor cores idle.
//
// Shared memory: the trunk's (tc_smem_bytes): the ring (TC_SLOTS x 8 KB),
// the buffer rows x 64 x 4 (rows = the widest layer's depth or width, 512
// at the flagship: 128 KB), the final rows' scratch; K4 adds its tap table.
// K5's is the trunk's alone.
// One block an SM.
//
// bf16 (K4 and K5 with TcBf16, the JAX kernels' cdtype bfloat16,
// decoder_train_kernel.py:152-159 and decoder_train_pixel.py:347-362): the
// same kernels templated on the trunk's arithmetic, as the grid trunk is.
// K2's bf16 forward (decoder_train_kernel.py:420-470, :483-485) has moved to
// its own design, train_fwd_bf16_tc.cuh (train_fwd_bf16_kernel); this
// route is K4's and K5's.  A k step of 16 is one
// wgmma.m64n128k16 bf16 product against tile_weights(W, bf16) tiles (4 KB,
// 22 ring slots); the buffer keeps float32 words holding bf16 values, so
// that the A fragment packs them exactly (tc_pack_bf16); the epilogue adds
// the bf16-rounded embedding terms (exact products, float32 sums), the
// float32 bias, ReLU and the gate, then rounds to bf16, after the gate as
// JAX does; the residuals are stored as bf16 (out_pad, M), 3.5 KB a point a
// trunk, half of float32's (K4's latent too, reloaded by fw_load); the final rows' weights hold bf16 values, so
// their products with the bf16 activations are exact and their sums
// float32.  Shared memory at the flagship (rows 512): the ring 22 x 4 KB =
// 88 KB, as float32's 11 x 8 KB, the buffer 128 KB, 22 barriers: 223,664
// bytes.  A bf16 buffer would halve the 128 KB only if the epilogue kept
// float32 nowhere; the products' A loads would then read packed pairs,
// untried.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_trunk_tc.cuh"
#include "train_common.cuh"  // gate_mix

#define FW_BATCH 16  // 16-byte runs a thread has in flight when it loads rows

// FW_PROBE, 0 in the package's build: tools/time_train_fwd.py builds copies
// that leave parts of the forward out, to time the rest apart: 1 the
// products (and the ring), 2 the gate, 4 the residuals' stores, 8 K4's
// gather and K5's head rows' loads; their results are wrong.  32 clocks the
// phases of each block on its thread 0 (FwClock).
#ifndef FW_PROBE
#define FW_PROBE 0
#endif

// The tile stream as the trunk's ring reads it (tc_fill): one run of
// `total` tiles.
__device__ __forceinline__ TcPlan fw_stream(int total) {
  TcPlan plan;
  plan.split = total;
  plan.stream[0] = plan.stream[1] = 0;
  return plan;
}

// Thread 0, before the block's first barrier: the ring's barriers and its
// first Cfg::kSlots tiles.
template <class Cfg = TcF32>
__device__ __forceinline__ void fw_init(const float* tiles, const TcPlan& plan, const TcShared& s,
                                        int total) {
  for (int i = 0; i < Cfg::kSlots; ++i) tc_mbar_init(&s.full[i], 1);
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  if (FW_PROBE & 1) return;
  for (int j = 0; j < Cfg::kSlots; ++j) tc_fill<Cfg>(tiles, plan, s, j, total);
}

// A layer's product: this warpgroup's output groups wg and wg + 2 of
// `groups` over buffer rows [0, depth), from ring tile `slot` on; the
// accumulators are 0 where the warpgroup has no group or the layer no
// product (depth 0).
template <class Cfg = TcF32>
__device__ __forceinline__ void fw_product(float (&acc0)[64], float (&acc1)[64], int depth,
                                           int groups, int slot, const float* __restrict__ tiles,
                                           const TcPlan& plan, const TcShared& s, int total,
                                           int wg, int wt, int p0, int t4) {
  const int mine = (groups > wg) + (groups > wg + 2);
#pragma unroll
  for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0.f;
  if (FW_PROBE & 1) return;
  if (mine == 2) {
    tc_steps<2, Cfg>(acc0, acc1, depth / Cfg::kK, 0, false, groups, slot, tiles, plan, s, total,
                     wg, wt, p0, t4);
  } else if (mine == 1) {
    tc_steps<1, Cfg>(acc0, acc1, depth / Cfg::kK, 0, false, groups, slot, tiles, plan, s, total,
                     wg, wt, p0, t4);
  }
}

// gate_hash(seed, layer, row, lane) = gate_mix(fw_key(seed, layer, row) ^
// lane * 0x85EBCA6B): the row's and the layer's terms, once a layer.
__device__ __forceinline__ unsigned fw_key(unsigned seed, unsigned layer, unsigned row) {
  return seed ^ (row * 0x9E3779B1u) ^ (layer * 0xC2B2AE35u);
}

// Output group j of a hidden layer for this thread's points p0 and p0 + 8
// (its 64 accumulators): + the embedding's e columns (x (e, out_pad) or
// null; emb the block's first column of the (e, M) embedding, `live0` /
// `live1`: the points lie below M), + the bias (b0 the row of p0's scene,
// b1 of p0 + 8's), ReLU and, where `gate`, the dropout gate of the rows'
// keys k0 / k1, then, where `bf16`, rounded to bf16; into buffer rows 128 j
// on.
__device__ __forceinline__ void fw_epilogue(float (&acc)[64], int j, const float* __restrict__ x,
                                            int e, int out_pad, const float* __restrict__ emb,
                                            int m, bool live0, bool live1,
                                            const float* __restrict__ b0,
                                            const float* __restrict__ b1, bool gate, unsigned k0,
                                            unsigned k1, unsigned thresh, float scale, float* buf,
                                            int p0, int t4, bool bf16 = false) {
  const int o0 = j * TC_GROUP + 2 * t4;
  for (int c = 0; x && c < e; ++c) {
    const float ea = live0 ? __ldg(emb + (size_t)c * m + p0) : 0.f;
    const float eb = live1 ? __ldg(emb + (size_t)c * m + p0 + 8) : 0.f;
    const float* xr = x + (size_t)c * out_pad + o0;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float2 w = __ldg(reinterpret_cast<const float2*>(xr + 8 * i));
      acc[4 * i] = fmaf(w.x, ea, acc[4 * i]);
      acc[4 * i + 1] = fmaf(w.y, ea, acc[4 * i + 1]);
      acc[4 * i + 2] = fmaf(w.x, eb, acc[4 * i + 2]);
      acc[4 * i + 3] = fmaf(w.y, eb, acc[4 * i + 3]);
    }
  }
  gate = gate && !(FW_PROBE & 2);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int o = o0 + 8 * i;
    const float2 ba = __ldg(reinterpret_cast<const float2*>(b0 + o));
    const float2 bb = __ldg(reinterpret_cast<const float2*>(b1 + o));
    float v0 = fmaxf(acc[4 * i] + ba.x, 0.f), v1 = fmaxf(acc[4 * i + 1] + ba.y, 0.f);
    float v2 = fmaxf(acc[4 * i + 2] + bb.x, 0.f), v3 = fmaxf(acc[4 * i + 3] + bb.y, 0.f);
    if (gate) {
      const unsigned c0 = (unsigned)o * 0x85EBCA6Bu, c1 = c0 + 0x85EBCA6Bu;  // lanes o, o + 1
      v0 = gate_mix(k0 ^ c0) < thresh ? v0 * scale : 0.f;
      v1 = gate_mix(k0 ^ c1) < thresh ? v1 * scale : 0.f;
      v2 = gate_mix(k1 ^ c0) < thresh ? v2 * scale : 0.f;
      v3 = gate_mix(k1 ^ c1) < thresh ? v3 * scale : 0.f;
    }
    if (bf16) {
      v0 = tc_round_bf16(v0);
      v1 = tc_round_bf16(v1);
      v2 = tc_round_bf16(v2);
      v3 = tc_round_bf16(v3);
    }
    buf[tc_swz(o, p0)] = v0;
    buf[tc_swz(o + 1, p0)] = v1;
    buf[tc_swz(o, p0 + 8)] = v2;
    buf[tc_swz(o + 1, p0 + 8)] = v3;
  }
}

// Buffer rows [0, rows) to dst (rows, M) at this block's points, a thread a
// run of 4 points (16 bytes in float32, 8 in bf16, which the buffer's
// values then hold exactly; a warp two rows): streaming stores (evicted
// from L2 first) where `stream`, else plain ones (K4's latent, which the
// block reads again).
template <class T = float>
__device__ __forceinline__ void fw_store(const float* buf, int rows, T* __restrict__ dst, int m,
                                         int first, bool stream, int tid) {
  if (FW_PROBE & 4) return;
  const int n = rows * (TC_P / 4);
  for (int i = tid; i < n; i += TC_THREADS) {
    const int k = i >> 4, p = (i & 15) << 2;
    if (first + p >= m) continue;
    const float4 v = *reinterpret_cast<const float4*>(buf + tc_swz(k, p));
    if constexpr (sizeof(T) == 2) {
      uint2* d = reinterpret_cast<uint2*>(dst + (size_t)k * m + first + p);
      if (stream) {
        __stcs(d, tc_pack4_bf16(v));
      } else {
        *d = tc_pack4_bf16(v);
      }
    } else {
      float4* d = reinterpret_cast<float4*>(dst + (size_t)k * m + first + p);
      if (stream) {
        __stcs(d, v);
      } else {
        *d = v;
      }
    }
  }
}

// Rows [0, rows) of src (rows, M) at this block's points into buffer rows
// row0 on (0 past M), FW_BATCH runs a thread in flight; read from L2 (K4's
// latent, which the block itself wrote, float32 or bf16; K5's head, which
// it reads twice).
template <class T = float>
__device__ __forceinline__ void fw_load(float* buf, int row0, int rows, const T* src, int m,
                                        int first, int tid) {
  const int n = rows * (TC_P / 4);
  for (int i0 = tid; i0 < n; i0 += FW_BATCH * TC_THREADS) {
    float4 v[FW_BATCH];
#pragma unroll
    for (int u = 0; u < FW_BATCH; ++u) {
      const int i = i0 + u * TC_THREADS, k = i >> 4, p = (i & 15) << 2;
      v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < n && first + p < m) {
        if constexpr (sizeof(T) == 2) {  // 4 bf16 in 8 bytes, as floats (exact)
          const uint2 w = __ldcg(reinterpret_cast<const uint2*>(src + (size_t)k * m + first + p));
          v[u] = make_float4(__uint_as_float(w.x << 16), __uint_as_float(w.x & 0xFFFF0000u),
                             __uint_as_float(w.y << 16), __uint_as_float(w.y & 0xFFFF0000u));
        } else {
          v[u] = __ldcg(reinterpret_cast<const float4*>(src + (size_t)k * m + first + p));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < FW_BATCH; ++u) {
      const int i = i0 + u * TC_THREADS, k = i >> 4, p = (i & 15) << 2;
      if (i < n) *reinterpret_cast<float4*>(buf + tc_swz(row0 + k, p)) = v[u];
    }
  }
}

// One value of a (rows, M) input at L2 (written by this kernel, K4's latent
// residual, or read-only), float32 or bf16 (as a float: exact).
__device__ __forceinline__ float fw_ld(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float fw_ld(const __nv_bfloat16* p) {
  return __uint_as_float((unsigned)__ldcg(reinterpret_cast<const unsigned short*>(p)) << 16);
}

// An input that a latent_in final layer reads beside the last activation:
// w (rows, n_out) on src (rows, M), src at the block's first point (K2's
// and K4's embedding, K4's latent residual, K5's x0); rows 0 = none.
template <class T = float>
struct FwIn {
  const float* w = nullptr;
  const T* src = nullptr;
  int rows = 0;
};

// Half of the rows of `in` (every other one from `half`) for output r at
// the block's point p: sum of w[c][r] src[c][p].  Exact products in bf16
// (both operands hold bf16 values), float32 sums.
template <class T>
__device__ __forceinline__ float fw_final_in(const FwIn<T>& in, int n_out, int r, int half,
                                             int p, int m) {
  float s = 0.f;
  for (int c = half; c < in.rows; c += 2)
    s = fmaf(__ldg(in.w + (size_t)c * n_out + r), fw_ld(in.src + (size_t)c * m + p), s);
  return s;
}

// The final layer on the CUDA cores: y[r][first + p] = tanh(b[r] + sum_k
// wt[r][k] a[k][p] + the inputs' terms) for r < n_out (<= 2), a = buffer
// rows [0, in_pad), wt (n_out, in_pad); a thread takes a row, half of k
// and a point, red (256 floats) meets the halves.  A latent_in final layer
// (JAX's kernels re-inject at any layer: decoder_train_kernel.py:443-451,
// :117-121; decoder_train_pixel.py) adds in0's and in1's terms, each
// thread half of their rows, and with nps > 0 b is a per-scene (B, n_out)
// table (K2's folded latent).  Barriers before and after the write.
template <class T0 = float, class T1 = float>
__device__ __forceinline__ void fw_final(const float* __restrict__ wt, const float* __restrict__ b,
                                         int n_out, int in_pad, const float* buf, float* red,
                                         float* __restrict__ y, int m, int first, int tid,
                                         const FwIn<T0>& in0 = {}, const FwIn<T1>& in1 = {},
                                         int nps = 0) {
  const int r = tid >> 7, half = (tid >> 6) & 1, p = tid & (TC_P - 1);
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  if (r < n_out) {
    const float* f = wt + (size_t)r * in_pad;
    const int len = in_pad >> 1, k0 = half * len;
    for (int k = k0; k < k0 + len; k += 4) {
      const float4 w = __ldg(reinterpret_cast<const float4*>(f + k));
      s0 = fmaf(w.x, buf[tc_swz(k, p)], s0);
      s1 = fmaf(w.y, buf[tc_swz(k + 1, p)], s1);
      s2 = fmaf(w.z, buf[tc_swz(k + 2, p)], s2);
      s3 = fmaf(w.w, buf[tc_swz(k + 3, p)], s3);
    }
    if (first + p < m) {  // the inputs' src start at the block's first point
      s0 += fw_final_in(in0, n_out, r, half, p, m);
      s1 += fw_final_in(in1, n_out, r, half, p, m);
    }
  }
  red[tid] = (s0 + s1) + (s2 + s3);
  __syncthreads();
  if (tid < n_out * TC_P) {
    const int rr = tid / TC_P, pp = tid % TC_P;
    const float v = red[rr * 2 * TC_P + pp] + red[rr * 2 * TC_P + TC_P + pp];
    if (first + pp < m) {
      const float bias = nps > 0 ? __ldg(b + (size_t)((first + pp) / nps) * n_out + rr)
                                 : __ldg(b + rr);
      y[(size_t)rr * m + first + pp] = tanhf(v + bias);
    }
  }
  __syncthreads();
}

// The phases of a block on its thread 0, in clock cycles, where FW_PROBE has
// 32 (tools/time_train_fwd.py): tick(ph) adds the cycles since the last
// tick to phase ph; flush() adds them into fw_cycles.  Nothing otherwise.
#define FW_PHASES 6  // ring set-up, latent / head rows, products, epilogue, stores, final rows
#if FW_PROBE & 32
__device__ unsigned long long fw_cycles[FW_PHASES];
extern "C" int fw_read_cycles(unsigned long long* out) {
  const cudaError_t err = cudaMemcpyFromSymbol(out, fw_cycles, sizeof(fw_cycles));
  const unsigned long long zero[FW_PHASES] = {};
  return err != cudaSuccess ? (int)err : (int)cudaMemcpyToSymbol(fw_cycles, zero, sizeof(zero));
}
#endif
struct FwClock {
  long long last, acc[FW_PHASES];
  __device__ __forceinline__ FwClock() {
    if (FW_PROBE & 32) {
      last = clock64();
      for (int i = 0; i < FW_PHASES; ++i) acc[i] = 0;
    }
  }
  __device__ __forceinline__ void tick(int ph) {
    if (FW_PROBE & 32) {
      const long long now = clock64();
      acc[ph] += now - last;
      last = now;
    }
  }
  __device__ __forceinline__ void flush(int tid) const {
#if FW_PROBE & 32
    if (tid == 0)
      for (int i = 0; i < FW_PHASES; ++i) atomicAdd(&fw_cycles[i], (unsigned long long)acc[i]);
#endif
  }
};

// Host: the tiles of a forward layer of product depth `depth` (its
// activation rows, then K4's latent rows) and out_pad outputs, or -1 where
// the forward does not take it: out_pad a multiple of TC_GROUP up to
// TC_MAX_OUT, depth a multiple of the k step up to TC_MAX_OUT (the buffer's
// rows).
template <class Cfg = TcF32>
static inline int fw_layer_tiles(int depth, int out_pad) {
  if (out_pad < TC_GROUP || out_pad % TC_GROUP || out_pad > TC_MAX_OUT) return -1;
  if (depth < 0 || depth % Cfg::kK || depth > TC_MAX_OUT) return -1;
  return depth / Cfg::kK * (out_pad / TC_GROUP);
}
