// Scene-factored train decoder (kernel K2) for NVIDIA Hopper (sm_90a):
// forward and backward of one trunk.
//
// Replaces alignsdf_tpu/ops/decoder_train_kernel.py:fused_branch_scene, its
// forward _fwd_kernel_scene (built in _fused_scene_fwd) and its backward
// _bwd_kernel_scene (built in _fused_scene_bwd).  The latent is folded into
// per-scene bias tables outside (ops/train_plan.py), so layer l computes
//   acc = a_{l-1} @ W_l (if W) + emb @ X_l (if X) + b_l[row / nps] or b_l
// then ReLU and the hash dropout gate on hidden layers, tanh on the last.
// The last hidden layer's gated activation is the classifier's x_last: the
// forward already stores it as a residual, so the wrapper returns a view of
// it, and the backward adds its gradient dx_last (M, h) to the final layer's
// input gradient before that layer's gate (_bwd_kernel_scene :637-638).
//
// What bounds it: arithmetic.  At the flagship width (hidden 512 -> 250 ->
// 512 -> 512 -> 1, 6 embedding columns) a trunk costs 0.525 M MAC per point
// forward and twice that backward (dx and dW), against ~7 KB of residuals
// written and read per point.  Forward and backward run split TF32 on
// wgmma (three TF32 products a multiply-add), which keeps float32's
// accuracy: the forward on train_fwd_tc.cuh, the backward's chain on
// chain_tc.cuh and its weight-gradient reduction on wgrad_tc.cuh.
//
// Forward in float32 (train_fwd_tc_kernel, train_fwd_tc.cuh): the grid
// trunk's design for training.  A block of 256 threads owns 64 points;
// their activations stay in one shared-memory buffer as [feature][point];
// each layer's product runs on the tensor cores against tile_weights(W)
// tiles streamed through the trunk's ring; the epilogue on the CUDA cores
// adds the embedding's terms and each point's scene bias, applies ReLU and
// the gate, and a coalesced pass writes the gated activation to device
// memory as the residual, feature-major (out_pad, M).  The bf16 forward is
// its own design (train_fwd_bf16_tc.cuh, below).
//
// The gate is bit for bit the TPU kernel's _dropout_gate: a murmur3-style
// finalizer of (seed, layer, global row, lane) in uint32 arithmetic, kept
// where the hash is below round(keep * 2^32), scaled by float32(1 / keep).
// The backward does not replay it: a stored gated activation is > 0 exactly
// where the unit passed both ReLU and the gate, so the gate is (a > 0) * s.
//
// Backward.  The TPU kernel walks a sequential grid and accumulates dW in
// VMEM; blocks on Hopper run in parallel, so it is split:
//  1. train_bwd_chain_tc_kernel, per 64-point tile (chain_tc.cuh): from dy
//     and y it forms the gradient of every layer's pre-activation (dpre) in
//     shared memory, going back through W^T on the tensor cores (tiles of
//     W^T split and tiled when the trunk is packed) and the recovered gates,
//     writes each dpre to device memory (out_pad, M), and accumulates d(emb)
//     = sum over layers with X of dpre @ X^T.
//  2. wgrad_tc_kernel (wgrad_tc.cuh): dW_l = a_{l-1} . dpre_l^T and dX_l =
//     emb^T-rows . dpre_l^T, reductions over the M points split across
//     blocks, split TF32 on the tensor cores, partial sums added with
//     atomicAdd.
//  3. colsum_kernel: db_l as the sum of dpre_l over each scene's rows (one
//     warp per feature and scene, plain stores) or over all rows (atomics).
// One call of train_decoder_bwd enqueues all of these on one stream.
//
// bf16 (the launchers' int `bf16`; the JAX kernel with cdtype bfloat16,
// decoder_train_kernel.py:420-470, :483-485, :545-640): the pack holds the
// weights, X and the embedding rounded to bf16 (the biases float32); the
// forward rounds each gated activation to bf16 and stores the residuals as
// bf16.  The forward is its own design, train_fwd_bf16_tc.cuh
// (train_fwd_bf16_kernel): the activations in two bf16 buffers read by
// wgmma from shared memory, a producer per consumer warpgroup streaming
// the forward's bf16 tiles (W's, then X's: the pack's fwd and fwd_x)
// multicast to clusters of 2 blocks, each group's epilogue (and the final
// rows) run under the next product, the residuals stored by TMA.  The
// backward's chain is its own design, chain_bf16_tc.cuh
// (train_bwd_chain_bf16_kernel): dpre in a bf16 buffer read by wgmma from
// shared memory, the tiles multicast to a cluster, the gate and the bias
// sums in the epilogue.  It writes each dpre once, rounded to bf16, for the
// reductions (wgrad_tc.cuh's bf16 route, dW from the bf16 residuals, dX from
// the embedding's bf16 copy emb16), and takes db from the unrounded values
// in its registers through per-block partials
// (train_bwd_chain_bf16_db_kernel): no float32 dpre, no colsum.

#include <cuda_runtime.h>
#include <stdint.h>

#include "chain_bf16_tc.cuh"  // the bf16 backward's chain
#include "chain_tc.cuh"      // the backward's reverse chain on the tensor cores
#include "train_common.cuh"  // gate_hash, wgrad / colsum
#include "train_fwd_bf16_tc.cuh"  // the bf16 forward
#include "train_fwd_tc.cuh"  // the float32 forward on the tensor cores

#define EMB_MAX 64     // embedding columns
#define MAX_LAYERS 10
#define MAX_OUT 2

struct Layer {
  const float *w, *wt, *x, *b;  // w (in_pad, out_pad), wt its transpose (final layer), x (e, out_pad)
  float *act, *dpre;            // residual (out_pad, M; bf16 in bf16), pre-activation grad (out_pad, M; float32 only)
  float *dw, *dx, *db;          // gradients (shapes of w, x, b)
  int in_pad, out_pad, scene_bias, dropout;
  __nv_bfloat16* dpre16;        // bf16: dpre rounded, the reductions' operand
};

struct Plan {
  int n_layers, n_out, e, m, nps, n_scenes, max_pad;
  const float* emb;  // (e, M)
  float* y;          // (n_out, M)
  const float* dy;   // (n_out, M)
  float* demb;       // (M, e)
  const float* dx_last;  // (M, xl_w) or null
  int xl_w;
  const float* tiles;    // the backward chain's weight tiles (chain_tc.cuh)
  long long tiles_len;   // their floats
  const float* fwd;      // the forward's weight tiles (train_fwd_tc.cuh)
  long long fwd_len;     // their floats
  const __nv_bfloat16* emb16;  // bf16: the embedding (e, M) as bf16, dX's operand
  float* db_part;        // bf16: the chain's bias partials (chain_bf16_tc.cuh)
  long long db_part_len; // their floats
  const float* fwd_x;    // bf16: the forward's X tiles (train_fwd_bf16_tc.cuh)
  long long fwd_x_len;   // their floats
  Layer layers[MAX_LAYERS];
};

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// Cfg: the trunk's arithmetic (TcF32 or TcBf16); R: the residuals' type
// (float or __nv_bfloat16).
template <class Cfg, class R>
__global__ void __launch_bounds__(TC_THREADS, 1)
train_fwd_tc_kernel(const Plan p, int total, unsigned seed, unsigned thresh, float scale) {
  extern __shared__ __align__(128) float smem[];
  const TcShared s = tc_shared<Cfg>(smem, p.max_pad);
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127, lane = tid & 31, t4 = lane & 3;
  const int p0 = 16 * (wt >> 5) + (lane >> 2);  // this thread's points: p0, p0 + 8
  const int first = blockIdx.x * TC_P;
  const TcPlan plan = fw_stream(total);
  FwClock clk;
  if (tid == 0) fw_init<Cfg>(p.fwd, plan, s, total);
  __syncthreads();
  clk.tick(0);

  // this thread's two rows, their scenes (rows past M take the last one's)
  const int ra = first + p0, rb = ra + 8;
  const int sa = min(ra, p.m - 1) / p.nps, sb = min(rb, p.m - 1) / p.nps;
  float acc0[64], acc1[64];
  int slot = 0;
  for (int l = 0; l < p.n_layers - 1; ++l) {
    const Layer& L = p.layers[l];
    const int groups = L.out_pad / TC_GROUP, depth = L.w ? L.in_pad : 0;
    fw_product<Cfg>(acc0, acc1, depth, groups, slot, p.fwd, plan, s, total, wg, wt, p0, t4);
    slot += depth / Cfg::kK * groups;
    __syncthreads();  // every warp is done reading the layer's input
    clk.tick(2);
    const float* b0 = L.scene_bias ? L.b + (size_t)sa * L.out_pad : L.b;
    const float* b1 = L.scene_bias ? L.b + (size_t)sb * L.out_pad : L.b;
    const unsigned ka = fw_key(seed, (unsigned)l, (unsigned)ra);
    const unsigned kb = fw_key(seed, (unsigned)l, (unsigned)rb);
    if (groups > wg)
      fw_epilogue(acc0, wg, L.x, p.e, L.out_pad, p.emb + first, p.m, ra < p.m, rb < p.m, b0, b1,
                  L.dropout, ka, kb, thresh, scale, s.act, p0, t4, Cfg::kBf16);
    if (groups > wg + 2)
      fw_epilogue(acc1, wg + 2, L.x, p.e, L.out_pad, p.emb + first, p.m, ra < p.m, rb < p.m, b0,
                  b1, L.dropout, ka, kb, thresh, scale, s.act, p0, t4, Cfg::kBf16);
    __syncthreads();
    clk.tick(3);
    fw_store(s.act, L.out_pad, reinterpret_cast<R*>(L.act), p.m, first, true, tid);
    clk.tick(4);
  }
  // the final layer, with the embedding's columns and the scene table where
  // latent_in names it
  const Layer& F = p.layers[p.n_layers - 1];
  fw_final(F.wt, F.b, p.n_out, F.in_pad, s.act, s.red, p.y, p.m, first, tid,
           FwIn<float>{F.x, p.emb + first, F.x ? p.e : 0}, FwIn<float>{},
           F.scene_bias ? p.nps : 0);
  clk.tick(5);
  clk.flush(tid);
}

// ---------------------------------------------------------------------------
// backward 1: the reverse chain per 64-point tile, on the tensor cores
// ---------------------------------------------------------------------------

// Cfg, R: as the forward's.
template <class Cfg, class R>
__global__ void __launch_bounds__(TC_THREADS, 1)
train_bwd_chain_tc_kernel(const Plan p, const float* __restrict__ tiles, int total, float scale) {
  extern __shared__ __align__(128) float smem[];
  const ChShared s = ch_shared<Cfg>(smem);
  float* buf = s.tc.act;
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127, lane = tid & 31, t4 = lane & 3;
  const int p0 = 16 * (wt >> 5) + (lane >> 2);  // this thread's points: p0, p0 + 8
  const int first = blockIdx.x * TC_P;
  const TcPlan plan = ch_stream<Cfg>(total);
  auto act = [&](const Layer& L) { return reinterpret_cast<const R*>(L.act); };
  ChClock clk;
  if (tid == 0) ch_init<Cfg>(tiles, plan, s.tc, total);
  clk.tick(0);

  // the final layer, then its input's gradient (plus dx_last) gated by the
  // last hidden layer's recovered gate
  const int last = p.n_layers - 1;
  const Layer& F = p.layers[last];
  const Layer& H = p.layers[last - 1];
  ch_prefetch(act(H), F.in_pad, p.m, first, tid);
  ch_final(p.y, p.dy, F.dpre, F.w, p.n_out, F.in_pad, p.m, first, s.tc.oacc, s.red, buf, tid,
           F.dpre16);
  bool demb_stored = false;
  if (F.x) {  // a latent_in final layer: its d(emb), the chain's first
    ch_final_in(s.tc.oacc, F.x, p.e, p.n_out, p.demb, p.e, 1, true, p.m, first, tid);
    demb_stored = true;
  }
  if (p.dx_last) {
    __syncthreads();
    ch_add_rows(buf, p.dx_last, p.xl_w, p.m, first, tid);
  }
  __syncthreads();
  clk.tick(1);
  ch_gate(buf, F.in_pad, act(H), H.dropout ? scale : 1.f, H.dpre, p.m, first, tid, H.dpre16);
  __syncthreads();
  clk.tick(2);

  // hidden layer l: dx = dpre_l W_l^T on the tensor cores, gated into
  // dpre_{l-1}; d(emb) from dpre_l where the layer reads the embedding
  float acc0[64], acc1[64];
  int slot = 0;
  for (int l = last - 1; l >= 0; --l) {
    const Layer& L = p.layers[l];
    const int groups = l > 0 ? L.in_pad / TC_GROUP : 0;
    if (groups > 0) {
      ch_prefetch(act(p.layers[l - 1]), L.in_pad, p.m, first, tid);
      ch_product<Cfg>(acc0, acc1, L.out_pad, groups, slot, tiles, plan, s.tc, total, wg, wt, p0,
                      t4);
      slot += L.out_pad / Cfg::kK * groups;
    }
    if (L.x) {
      __syncthreads();
      clk.tick(3);
      ch_demb(buf, L.out_pad, L.x, p.e, p.demb, p.e, 1, !demb_stored, p.m, first,
              s.red, tid);
      demb_stored = true;
      clk.tick(4);
    }
    if (groups == 0) continue;  // layer 0: nothing below it
    __syncthreads();  // every warp is done reading dpre_l
    clk.tick(3);
    ch_store_groups(acc0, acc1, groups, buf, wg, p0, t4);
    __syncthreads();
    clk.tick(5);
    const Layer& P = p.layers[l - 1];
    ch_gate(buf, L.in_pad, act(P), P.dropout ? scale : 1.f, P.dpre, p.m, first, tid, P.dpre16);
    __syncthreads();
    clk.tick(2);
  }
  clk.flush(tid);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// desc (int64): [n_layers, n_out, e, m, nps, n_scenes, emb, y, dy, demb,
// dx_last, xl_w, tiles, tiles_len, fwd, fwd_len, emb16, db_part,
// db_part_len, fwd_x, fwd_x_len, then per layer: w, wt, x, b, act, dpre, dw,
// dx, db, in_pad, out_pad, scene_bias, dropout, dpre16].  Pointers are
// device addresses, 0 = absent; wt only on the final layer; the tiles (the
// backward's) run from the last hidden layer down, each layer l > 0's
// tile_weights(W_l^T) of depth out_pad; the forward's (fwd) in layer order,
// each hidden layer l > 0's tile_weights(W_l) of depth in_pad (float32:
// split TF32 halves; bf16: bf16 tiles); the bf16 forward's fwd_x, in layer
// order, each hidden layer with X its tile_weights(X, bf16) of depth e
// rounded up to 16.  A float32 backward takes dpre; a bf16 one takes
// emb16, dpre16 and db_part (ceil(M / 64) x 2 x the sum of out_pad floats)
// instead.
#define HEAD 21
#define PER_LAYER 14
static int parse(const long long* desc, int len, Plan* p, bool backward, bool bf16) {
  if (len < HEAD) return -1;
  p->n_layers = (int)desc[0];
  p->n_out = (int)desc[1];
  p->e = (int)desc[2];
  p->m = (int)desc[3];
  p->nps = (int)desc[4];
  p->n_scenes = (int)desc[5];
  p->emb = (const float*)desc[6];
  p->y = (float*)desc[7];
  p->dy = (const float*)desc[8];
  p->demb = (float*)desc[9];
  p->dx_last = (const float*)desc[10];
  p->xl_w = (int)desc[11];
  p->tiles = (const float*)desc[12];
  p->tiles_len = desc[13];
  p->fwd = (const float*)desc[14];
  p->fwd_len = desc[15];
  p->emb16 = (const __nv_bfloat16*)desc[16];
  p->db_part = (float*)desc[17];
  p->db_part_len = desc[18];
  p->fwd_x = (const float*)desc[19];
  p->fwd_x_len = desc[20];
  if (p->n_layers < 2 || p->n_layers > MAX_LAYERS || len != HEAD + PER_LAYER * p->n_layers)
    return -1;
  if (p->n_out < 1 || p->n_out > MAX_OUT || p->e < 1 || p->e > EMB_MAX) return -1;
  if (p->m <= 0 || p->m % 4 || p->nps <= 0 || p->m % p->nps || p->m / p->nps != p->n_scenes) return -1;
  if (!p->emb || !p->y || (backward && (!p->dy || !p->demb))) return -1;
  if (backward && bf16 && (!p->emb16 || !p->db_part)) return -1;
  p->max_pad = TC_GROUP;
  for (int l = 0; l < p->n_layers; ++l) {
    const long long* d = desc + HEAD + PER_LAYER * l;
    Layer& L = p->layers[l];
    L.w = (const float*)d[0]; L.wt = (const float*)d[1]; L.x = (const float*)d[2];
    L.b = (const float*)d[3]; L.act = (float*)d[4]; L.dpre = (float*)d[5];
    L.dw = (float*)d[6]; L.dx = (float*)d[7]; L.db = (float*)d[8];
    L.in_pad = (int)d[9]; L.out_pad = (int)d[10]; L.scene_bias = (int)d[11]; L.dropout = (int)d[12];
    L.dpre16 = (__nv_bfloat16*)d[13];
    const bool hidden = l < p->n_layers - 1;
    if (!L.b) return -1;
    if (l == 0 ? (L.w || !L.x || L.in_pad != 0) : (!L.w || L.in_pad != p->layers[l - 1].out_pad)) return -1;
    if (!hidden && !L.wt) return -1;
    if (hidden) {
      if (L.out_pad < TC_GROUP || L.out_pad % TC_GROUP || !L.act) return -1;
      if (L.out_pad > p->max_pad) p->max_pad = L.out_pad;
    } else if (L.out_pad != p->n_out || L.dropout) {  // a latent_in final layer: x, scene_bias
      return -1;
    }
    if (backward && (!L.db || (L.w && !L.dw) || (L.x && !L.dx))) return -1;
    if (backward && (bf16 ? !L.dpre16 : !L.dpre)) return -1;
  }
  if (p->dx_last && (!backward || p->xl_w < 1 || p->xl_w > p->layers[p->n_layers - 1].in_pad))
    return -1;
  return 0;
}

// The forward's tiles: each hidden layer l > 0's, in layer order; -1 where
// a layer is outside the forward (train_fwd_tc.cuh) or the stream's length
// disagrees.
template <class Cfg>
static int fwd_tiles(const Plan& p) {
  int total = 0;
  for (int l = 0; l < p.n_layers - 1; ++l) {
    const Layer& L = p.layers[l];
    const int n = fw_layer_tiles<Cfg>(L.w ? L.in_pad : 0, L.out_pad);
    if (n < 0) return -1;
    total += n;
  }
  if (p.fwd_len != (long long)total * Cfg::kTile || (total > 0 && !p.fwd)) return -1;
  return total;
}

template <class Cfg, class R>
static int launch_fwd(const Plan& p, unsigned seed, unsigned thresh, float scale,
                      cudaStream_t stream) {
  const int total = fwd_tiles<Cfg>(p);
  if (total < 0) return -1;
  const size_t smem = tc_smem_bytes<Cfg>(p.max_pad);  // max_pad <= TC_MAX_OUT (fwd_tiles)
  cudaError_t err = cudaFuncSetAttribute(train_fwd_tc_kernel<Cfg, R>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((p.m + TC_P - 1) / TC_P);
  train_fwd_tc_kernel<Cfg, R><<<blocks, TC_THREADS, smem, stream>>>(p, total, seed, thresh,
                                                                    scale);
  return (int)cudaGetLastError();
}

// The bf16 forward's arguments from a parsed plan, or -1 where a tile
// stream disagrees (launch_fwd_bf16 checks the rest).
static int fwd_bf16_args(const Plan& p, unsigned seed, unsigned thresh, float scale, FbArgs* a) {
  if (fwd_tiles<TcBf16>(p) < 0) return -1;
  long long x_tiles = 0;  // X's tiles: (e rounded up to 16) / 16 k steps x groups a layer
  for (int l = 0; l < p.n_layers - 1; ++l)
    if (p.layers[l].x) x_tiles += (p.e + 15) / 16 * (p.layers[l].out_pad / TC_GROUP);
  if (p.fwd_x_len != x_tiles * TC_TILE || !p.fwd_x) return -1;
  *a = FbArgs{};
  a->xtiles = p.fwd_x;
  a->hidden = p.n_layers - 1;
  a->n_out = p.n_out;
  a->e = p.e;
  a->m = p.m;
  a->nps = p.nps;
  a->seed = seed;
  a->thresh = thresh;
  a->scale = scale;
  a->emb = p.emb;
  a->y = p.y;
  a->tiles = p.fwd;
  const Layer& F = p.layers[p.n_layers - 1];
  a->wf = F.w;
  a->fb = F.b;
  a->fx = F.x;
  a->f_scene_bias = F.scene_bias;
  for (int l = 0; l < a->hidden; ++l) {
    const Layer& L = p.layers[l];
    FbLayer& B = a->layers[l];
    B.x = L.x;
    B.b = L.b;
    B.act = reinterpret_cast<__nv_bfloat16*>(L.act);
    B.in_pad = L.w ? L.in_pad : 0;
    B.out_pad = L.out_pad;
    B.scene_bias = L.scene_bias;
    B.dropout = L.dropout;
  }
  return 0;
}

// bf16: train_fwd_bf16_kernel (train_fwd_bf16_tc.cuh), else split TF32.
extern "C" int train_decoder_fwd(const long long* desc, int len, unsigned seed, unsigned thresh,
                                 float scale, int bf16, void* stream) {
  Plan p;
  if (parse(desc, len, &p, false, bf16)) return -1;
  if (!bf16) return launch_fwd<TcF32, float>(p, seed, thresh, scale, (cudaStream_t)stream);
  FbArgs a;
  if (fwd_bf16_args(p, seed, thresh, scale, &a)) return -1;
  return launch_fwd_bf16(a, (cudaStream_t)stream);
}

// The bf16 forward's launch plan for a forward descriptor (the pointers may
// be any nonzero, 16-byte aligned values) into plan[FB_PLAN_INTS]
// (launch_fwd_bf16's order); launches nothing.
extern "C" int train_decoder_fwd_bf16_plan(const long long* desc, int len, int* plan) {
  Plan p;
  if (parse(desc, len, &p, false, true)) return -1;
  FbArgs a;
  if (fwd_bf16_args(p, 0, 0, 1.f, &a)) return -1;
  return launch_fwd_bf16(a, 0, plan);
}

// The chain's tiles: each hidden layer l > 0's, from the last down; -1
// where a layer is outside the chain (chain_tc.cuh) or the stream's length
// disagrees.
template <class Cfg>
static int chain_tiles(const Plan& p) {
  int total = 0;
  for (int l = p.n_layers - 2; l > 0; --l) {
    const int n = ch_layer_tiles<Cfg>(p.layers[l].out_pad, p.layers[l].in_pad);
    if (n < 0) return -1;
    total += n;
  }
  if (p.layers[0].out_pad > CH_ROWS || p.layers[p.n_layers - 1].in_pad > CH_ROWS) return -1;
  if (p.tiles_len != (long long)total * Cfg::kTile || (total > 0 && !p.tiles)) return -1;
  return total;
}

// The float32 backward: the split-TF32 chain, the reductions, colsum.
static int launch_bwd(const Plan& p, float scale, cudaStream_t s) {
  const int total = chain_tiles<TcF32>(p);
  if (total < 0) return -1;
  const size_t smem = ch_smem_bytes<TcF32>();
  cudaError_t err = cudaFuncSetAttribute(train_bwd_chain_tc_kernel<TcF32, float>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((p.m + TC_P - 1) / TC_P);
  train_bwd_chain_tc_kernel<TcF32, float><<<blocks, TC_THREADS, smem, s>>>(p, p.tiles, total,
                                                                           scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  for (int l = 0; l < p.n_layers; ++l) {
    const Layer& L = p.layers[l];
    int rc = 0;
    if (L.w) rc = launch_wgrad(p.layers[l - 1].act, L.dpre, L.dw, L.in_pad, L.out_pad, p.m, s);
    if (rc) return rc;
    if (L.x) rc = launch_wgrad(p.emb, L.dpre, L.dx, p.e, L.out_pad, p.m, s);
    if (rc) return rc;
    if ((rc = launch_colsum(L.dpre, L.db, L.out_pad, p.m, L.scene_bias ? p.nps : 4096,
                            L.scene_bias, s)))
      return rc;
  }
  return 0;
}

// The bf16 chain's arguments from a parsed plan, or -1 where the tile
// stream or the partials' length disagree.
static int chain_bf16_args(const Plan& p, float scale, CbArgs* a) {
  if (chain_tiles<TcBf16>(p) < 0) return -1;
  *a = CbArgs{};
  a->n_layers = p.n_layers;
  a->n_out = p.n_out;
  a->e = p.e;
  a->m = p.m;
  a->nps = p.nps;
  a->xl_w = p.xl_w;
  a->scale = scale;
  a->y = p.y;
  a->dy = p.dy;
  a->dx_last = p.dx_last;
  a->wf = p.layers[p.n_layers - 1].w;
  a->demb = p.demb;
  a->tiles = p.tiles;
  const long long blocks = (p.m + CB_P - 1) / CB_P;
  long long off = 0;
  for (int l = 0; l < p.n_layers; ++l) {
    const Layer& L = p.layers[l];
    CbLayer& C = a->layers[l];
    C.act = reinterpret_cast<const __nv_bfloat16*>(L.act);
    C.dpre16 = L.dpre16;
    C.x = L.x;
    C.db = L.db;
    C.part = p.db_part + off;
    C.out_pad = L.out_pad;
    C.scene_bias = L.scene_bias;
    C.dropout = L.dropout;
    off += blocks * 2 * L.out_pad;
  }
  return off == p.db_part_len ? 0 : -1;
}

// The bf16 backward: the chain with its db (chain_bf16_tc.cuh), then the
// reductions.  Each reduction after the first overlaps the one before it
// (launch_wgrad_bf16): their operands were complete before it began.  The
// first is launched in the usual way after the db kernel, which the usual
// way too starts once the chain is done; neither reads the partials.
static int launch_bwd_bf16(const Plan& p, float scale, cudaStream_t s) {
  CbArgs a;
  if (chain_bf16_args(p, scale, &a)) return -1;
  int rc = launch_chain_bf16(a, s);
  if (rc) return rc;
  int reductions = 0;
  for (int l = 0; l < p.n_layers; ++l) {
    const Layer& L = p.layers[l];
    if (L.w && (rc = launch_wgrad(reinterpret_cast<const __nv_bfloat16*>(p.layers[l - 1].act),
                                  L.dpre16, L.dw, L.in_pad, L.out_pad, p.m, s, reductions++ > 0)))
      return rc;
    if (L.x && (rc = launch_wgrad(p.emb16, L.dpre16, L.dx, p.e, L.out_pad, p.m, s,
                                  reductions++ > 0)))
      return rc;
  }
  return 0;
}

extern "C" int train_decoder_bwd(const long long* desc, int len, float scale, int bf16,
                                 void* stream) {
  Plan p;
  if (parse(desc, len, &p, true, bf16)) return -1;
  return bf16 ? launch_bwd_bf16(p, scale, (cudaStream_t)stream)
              : launch_bwd(p, scale, (cudaStream_t)stream);
}

// The bf16 chain's launch plan for a backward descriptor (the pointers may
// be any nonzero, 16-byte aligned values) into plan[CB_PLAN_INTS]
// (launch_chain_bf16's order); launches nothing.
extern "C" int train_decoder_chain_bf16_plan(const long long* desc, int len, int* plan) {
  Plan p;
  if (parse(desc, len, &p, true, true)) return -1;
  CbArgs a;
  if (chain_bf16_args(p, 1.f, &a)) return -1;
  return launch_chain_bf16(a, 0, plan);
}
