// Generic train decoder (kernel K5) for NVIDIA Hopper (sm_90a): forward and
// backward of one trunk on materialized input rows.
//
// Replaces alignsdf_tpu/ops/decoder_train_kernel.py:fused_branch, its forward
// _fwd_kernel (built in _fused_branch_fwd) and its backward _bwd_kernel
// (built in _fused_branch_bwd).  Each point brings its own input row x0 =
// [latent, embedding] (M, e), e = 262-319 at full width, so nothing folds
// into scene tables as in K2: layer l computes
//   acc = a_{l-1} @ W_l (if W) + x0 @ X_l (if X) + b_l
// with X_0 layer 0's weight (both halves summed by the plan when 0 is in
// latent_in: they multiply the same row, so the kernel runs one product) and
// X_l a latent_in layer's W_in; then ReLU and the hash dropout gate on hidden
// layers, tanh on the last.  A latent_in final layer (JAX's _fwd_kernel
// :117-121 takes one) reads all of x0 on the CUDA cores: fw_final's input
// over x0's e rows, ch_final_in's d(x0) stored first, the reduction's dX.
// The forward stores each hidden layer's gated activation as the residual,
// the last one being x_last, the classifier's input; the backward recovers
// the gate as (a > 0) * s, adds dx_last before the last hidden gate
// (_bwd_kernel :277-278), and emits d(x0) over the whole input row, so the
// gradient reaches the latent (and, for pixel-aligned rows, the map) and
// the embedding, besides dW, dX and db.
//
// What bounds it: arithmetic.  The flagship trunk with latent_in (0, 2)
// (rows of 262, hidden 512 -> 250 -> [250 + 262] -> 512 -> 512 -> 1) costs
// 786,944 multiply-adds a point forward (0.403 TFLOP a step of two trunks
// over 128,000 points, split TF32 2.44 ms at the tensor cores' dense TF32
// rate) and twice that backward (the chain's d(input) and the reductions'
// dW), against ~9 KB of residuals written and read a point.  That is K4's
// work at its flagship widths, with x0's leading 256 columns where K4's
// latent goes, so K5 runs K4's design.
//
// The head and the tail.  The pack splits x0's columns once at a head width
// h (generic_train_decoder.py:head_width): the head, x0's first h columns
// (the latent at the flagship: h = 256), enters the tensor-core products;
// the tail, the other e - h columns (the embedding: 6 at the flagship, 63
// at --point_size 63), enters on the CUDA cores as K2's and K4's embedding
// does.  A layer with X runs one product over [activation; head] against
// the tiles of [W_l; X_l[:h]] (K4's [W; Lat]); h_pad, h rounded up to the
// tensor cores' 128-column group, is chosen so that in_pad + h_pad <= 512,
// the buffer's rows, at every such layer.  The tail's rows of X stay
// float32.
//
// Forward (generic_train_fwd_tc_kernel, train_fwd_tc.cuh): K4's tensor-core
// forward without the gather.  A block of 256 threads owns 64 points; their
// activations stay in one shared-memory buffer as [feature][point].  Before
// a layer with X the block loads its points' head rows from x0 (e, M) into
// the buffer rows right above the activation rows (layer 0 reads the head
// alone), zeros the head's padding rows, and runs the layer's product
// against its tiles streamed through the trunk's ring; the epilogue adds the
// tail's columns (x0's rows h.. read through L1), the bias, ReLU and the
// gate, and a coalesced pass stores the gated activation to device memory
// as the residual (out_pad, M).  The final rows (1-2) stay float32 dot
// products on the CUDA cores, then tanh.
//
// Backward:
//  1. generic_train_bwd_chain_tc_kernel, per 64-point tile: K4's reverse
//     chain (chain_tc.cuh) without the tap stage.  From dy and y it forms
//     every layer's pre-activation gradient dpre in shared memory, going
//     back through one product a layer on the tensor cores: [W^T | X_head^T]
//     as one run of output groups, [dx | d(head)] (layer 2 at the flagship:
//     256 + 256, four groups; layer 0: d(head) alone, two groups).  The dx
//     rows are gated into dpre_{l-1} and written to device memory; the head
//     rows are added into dx0 (e, M) by plain read-modify-write in a fixed
//     order (the last layer with X first; each 16-byte run by one thread, no
//     atomics), the tail's columns of d(x0) on the CUDA cores (ch_demb).
//  2. wgrad_tc_kernel (wgrad_tc.cuh): dW_l from the residuals and dX_l from
//     x0 (e, M), split TF32 on the tensor cores; colsum_kernel: db_l.
// One call of generic_train_decoder_bwd enqueues all of these on one stream.
//
// bf16 (the launchers' int `bf16`; the JAX kernel with cdtype bfloat16,
// decoder_train_kernel.py:152-159, :95-139, :207-285): K4's bf16 design,
// the same kernels on the trunk's TcBf16 arithmetic, one wgmma.m64n128k16
// bf16 product a k step of 16 against bf16 tiles; the pack holds x0 (the
// head's rows and the tail's), the weights and X rounded to bf16 (the biases
// float32), so the tail's products on the CUDA cores are exact and their
// sums float32, as JAX's bf16 dot; each gated activation is rounded to bf16
// and stored as bf16; the chain writes each dpre twice, float32 (colsum)
// and rounded to bf16 (the reductions: wgrad_tc.cuh's bf16 route, dW from
// the bf16 residuals, dX from x0's bf16 copy x016), and its products and
// the tail's d(x0) take the rounded dpre; d(x0) sums in float32.  With 0 in
// latent_in, JAX multiplies x0 by layer 0's two weights apart, each rounded
// to bf16 (:117-121), so a bf16 pack keeps them apart (`twice`): layer 0's
// product runs over [head; head] rows against [W_0; W_in]'s head tiles,
// depth 2 h_pad (head_width keeps h_pad <= 256 there), and its chain over
// [d(head) | d(head)] output groups, both added into dx0; the tail takes
// the two rounded weights' float32 sum (one rounding of float32's size
// apart from JAX's two products).

#include <cuda_runtime.h>
#include <stdint.h>

#include "chain_tc.cuh"      // the backward's reverse chain on the tensor cores
#include "train_common.cuh"  // gate_mix, wgrad / colsum
#include "train_fwd_tc.cuh"  // the forward on the tensor cores

#define MAX_LAYERS 10
#define MAX_OUT 2

struct Layer {
  const float *w, *wt;     // w (in_pad, out_pad); wt its transpose (final layer, the forward's)
  const float *tail, *b;   // the tail's rows of X (e - h, out_pad) or null; bias (out_pad)
  float *act, *dpre;       // residual (out_pad, M; bf16 in bf16), pre-activation grad (out_pad, M)
  float *dw, *dx, *db;     // gradients: (in_pad, out_pad), (e, out_pad), (out_pad)
  int in_pad, out_pad, has_x, dropout;  // has_x: the layer reads x0 (head and tail)
  __nv_bfloat16* dpre16;   // bf16: dpre rounded, the reductions' operand
};

struct Plan {
  int n_layers, n_out, e, h, h_pad, m;
  const float* x0;       // (e, M)
  float* y;              // (n_out, M)
  const float* dy;       // (n_out, M)
  float* dx0;            // (e, M)
  const float* dx_last;  // (M, xl_w) or null
  int xl_w;
  const float* tiles;    // the backward chain's weight tiles (chain_tc.cuh)
  long long tiles_len;   // their floats
  const float* fwd;      // the forward's weight tiles (train_fwd_tc.cuh)
  long long fwd_len;     // their floats
  int twice;             // layer 0 reads the head twice (bf16 with 0 in latent_in)
  const __nv_bfloat16* x016;  // bf16: x0 (e, M) as bf16, dX's operand
  Layer layers[MAX_LAYERS];
};

// The head copies a layer with X reads: two at layer 0 of a `twice` plan.
__host__ __device__ inline int head_copies(const Plan& p, int l) {
  return p.layers[l].has_x ? (l == 0 && p.twice ? 2 : 1) : 0;
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// Buffer rows [row0, row0 + rows) to zero: the head's padding rows, which the
// tiles weigh 0, but which must hold no NaN for 0 x value to be 0.
__device__ __forceinline__ void fw_zero(float* buf, int row0, int rows, int tid) {
  for (int i = tid; i < rows * (TC_P / 4); i += TC_THREADS)
    *reinterpret_cast<float4*>(buf + tc_swz(row0 + (i >> 4), (i & 15) << 2)) =
        make_float4(0.f, 0.f, 0.f, 0.f);
}

// Cfg: the trunk's arithmetic (TcF32 or TcBf16); R: the residuals' type
// (float or __nv_bfloat16).
template <class Cfg, class R>
__global__ void __launch_bounds__(TC_THREADS, 1)
generic_train_fwd_tc_kernel(const Plan p, int rows, int total, unsigned seed, unsigned thresh,
                            float scale) {
  extern __shared__ __align__(128) float smem[];
  const TcShared s = tc_shared<Cfg>(smem, rows);
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127, lane = tid & 31, t4 = lane & 3;
  const int p0 = 16 * (wt >> 5) + (lane >> 2);  // this thread's points: p0, p0 + 8
  const int first = blockIdx.x * TC_P;
  const TcPlan plan = fw_stream(total);
  FwClock clk;
  if (tid == 0) fw_init<Cfg>(p.fwd, plan, s, total);
  __syncthreads();
  clk.tick(0);

  const int ra = first + p0, rb = ra + 8;
  const float* tail = p.x0 + (size_t)p.h * p.m + first;  // the block's first tail column
  float acc0[64], acc1[64];
  int slot = 0;
  for (int l = 0; l < p.n_layers - 1; ++l) {
    const Layer& L = p.layers[l];
    const int copies = head_copies(p, l);
    const int act_rows = L.w ? L.in_pad : 0, head_rows = copies * p.h_pad;
    if (head_rows > 0) {
      // the head above the activation rows (no warp reads those rows now:
      // the previous layer's store pass reads rows below act_rows), once or
      // twice
      for (int c = 0; c < copies; ++c) {
        const int row0 = act_rows + c * p.h_pad;
        if (!(FW_PROBE & 8)) fw_load(s.act, row0, p.h, p.x0, p.m, first, tid);
        fw_zero(s.act, row0 + p.h, p.h_pad - p.h, tid);
      }
      __syncthreads();
      clk.tick(1);
    }
    const int groups = L.out_pad / TC_GROUP, depth = act_rows + head_rows;
    fw_product<Cfg>(acc0, acc1, depth, groups, slot, p.fwd, plan, s, total, wg, wt, p0, t4);
    slot += depth / Cfg::kK * groups;
    __syncthreads();  // every warp is done reading the layer's input
    clk.tick(2);
    const unsigned ka = fw_key(seed, (unsigned)l, (unsigned)ra);
    const unsigned kb = fw_key(seed, (unsigned)l, (unsigned)rb);
    if (groups > wg)
      fw_epilogue(acc0, wg, L.tail, p.e - p.h, L.out_pad, tail, p.m, ra < p.m, rb < p.m, L.b, L.b,
                  L.dropout, ka, kb, thresh, scale, s.act, p0, t4, Cfg::kBf16);
    if (groups > wg + 2)
      fw_epilogue(acc1, wg + 2, L.tail, p.e - p.h, L.out_pad, tail, p.m, ra < p.m, rb < p.m, L.b,
                  L.b, L.dropout, ka, kb, thresh, scale, s.act, p0, t4, Cfg::kBf16);
    __syncthreads();
    clk.tick(3);
    fw_store(s.act, L.out_pad, reinterpret_cast<R*>(L.act), p.m, first, true, tid);
    clk.tick(4);
  }
  // the final layer, with all of x0's columns where latent_in names it
  const Layer& F = p.layers[p.n_layers - 1];
  fw_final(F.wt, F.b, p.n_out, F.in_pad, s.act, s.red, p.y, p.m, first, tid,
           FwIn<float>{F.tail, p.x0 + first, F.has_x ? p.e : 0});
  clk.tick(5);
  clk.flush(tid);
}

// ---------------------------------------------------------------------------
// backward 1: the reverse chain per 64-point tile, on the tensor cores
// ---------------------------------------------------------------------------

// Cfg, R: as the forward's.
template <class Cfg, class R>
__global__ void __launch_bounds__(TC_THREADS, 1)
generic_train_bwd_chain_tc_kernel(const Plan p, int total, float scale) {
  extern __shared__ __align__(128) float smem[];
  const ChShared s = ch_shared<Cfg>(smem);
  float* buf = s.tc.act;
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127, lane = tid & 31, t4 = lane & 3;
  const int p0 = 16 * (wt >> 5) + (lane >> 2);  // this thread's points: p0, p0 + 8
  const int first = blockIdx.x * TC_P;
  const TcPlan plan = ch_stream<Cfg>(total);
  auto act = [&](const Layer& L) { return reinterpret_cast<const R*>(L.act); };
  ChClock clk;
  if (tid == 0) ch_init<Cfg>(p.tiles, plan, s.tc, total);
  clk.tick(0);

  // the final layer, then its input's gradient (plus dx_last) gated by the
  // last hidden layer's recovered gate
  const int last = p.n_layers - 1;
  const Layer& F = p.layers[last];
  const Layer& H = p.layers[last - 1];
  ch_prefetch(act(H), F.in_pad, p.m, first, tid);
  ch_final(p.y, p.dy, F.dpre, F.w, p.n_out, F.in_pad, p.m, first, s.tc.oacc, s.red, buf, tid,
           F.dpre16);
  bool stored = false;  // dx0 holds a layer's sums: later layers add to them
  if (F.has_x) {  // a latent_in final layer: d(x0) over every column, the first term
    ch_final_in(s.tc.oacc, F.tail, p.e, p.n_out, p.dx0, 1, p.m, true, p.m, first, tid);
    stored = true;
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

  // hidden layer l: one product of dpre_l with [W_l^T | X_l[:h]^T] (layer 0
  // of a `twice` plan: both weights' head columns), the dx rows gated into
  // dpre_{l-1}, the head rows added into dx0; the tail's d(x0) from dpre_l
  // on the CUDA cores
  float* dtail = p.dx0 + (size_t)p.h * p.m;
  float acc0[64], acc1[64];
  int slot = 0;
  for (int l = last - 1; l >= 0; --l) {
    const Layer& L = p.layers[l];
    const int copies = head_copies(p, l);
    const int dx_rows = l > 0 ? L.in_pad : 0, head_rows = copies * p.h_pad;
    const int groups = (dx_rows + head_rows) / TC_GROUP;
    if (dx_rows > 0) ch_prefetch(act(p.layers[l - 1]), dx_rows, p.m, first, tid);
    ch_product<Cfg>(acc0, acc1, L.out_pad, groups, slot, p.tiles, plan, s.tc, total, wg, wt, p0,
                    t4);
    slot += L.out_pad / Cfg::kK * groups;
    if (L.tail) {
      __syncthreads();
      clk.tick(3);
      ch_demb(buf, L.out_pad, L.tail, p.e - p.h, dtail, 1, p.m, !stored, p.m, first, s.red,
              tid);
      clk.tick(4);
    }
    if (groups > 0) {
      __syncthreads();  // every warp is done reading dpre_l
      clk.tick(3);
      ch_store_groups(acc0, acc1, groups, buf, wg, p0, t4);
      __syncthreads();
      clk.tick(5);
      if (dx_rows > 0) {
        const Layer& P = p.layers[l - 1];
        ch_gate(buf, dx_rows, act(P), P.dropout ? scale : 1.f, P.dpre, p.m, first, tid,
                P.dpre16);
      }
      clk.tick(2);
      // each copy's d(head) added by the same threads in the same order
      for (int c = 0; c < copies; ++c)
        ch_accumulate(buf, dx_rows + c * p.h_pad, p.h, p.dx0, !stored && c == 0, p.m, first,
                      tid);
      __syncthreads();
      clk.tick(6);
    }
    stored = stored || L.has_x;
  }
  clk.flush(tid);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// desc (int64): [n_layers, n_out, e, h, h_pad, m, x0, y, dy, dx0, dx_last,
// xl_w, tiles, tiles_len, fwd, fwd_len, twice, x016, then per layer: w, wt,
// tail, b, act, dpre, dw, dx, db, in_pad, out_pad, has_x, dropout, dpre16].
// Pointers are device addresses, 0 = absent; wt only on the final layer;
// tail (e - h, out_pad) where the layer has X and x0 a tail; x016 only in
// bf16 and dpre16 only in a bf16 backward, where they are required.  The
// tiles (the backward's) run from the last hidden layer down, each layer's
// tile_weights([W^T | X[:h]^T]) of depth out_pad (W^T where l > 0, X[:h]^T
// where it has X and h > 0; layer 0 of a `twice` plan: [W_0[:h]^T |
// W_in[:h]^T]); the forward's (fwd) in layer order, each layer's
// tile_weights([W; X[:h]]) of depth in_pad + h_pad (layer 0 twice: [W_0[:h];
// W_in[:h]], 2 h_pad); split TF32 halves in float32, bf16 tiles in bf16.
#define HEAD 18
#define PER_LAYER 14
static int parse(const long long* desc, int len, Plan* p, bool backward, bool bf16) {
  if (len < HEAD) return -1;
  p->n_layers = (int)desc[0];
  p->n_out = (int)desc[1];
  p->e = (int)desc[2];
  p->h = (int)desc[3];
  p->h_pad = (int)desc[4];
  p->m = (int)desc[5];
  p->x0 = (const float*)desc[6];
  p->y = (float*)desc[7];
  p->dy = (const float*)desc[8];
  p->dx0 = (float*)desc[9];
  p->dx_last = (const float*)desc[10];
  p->xl_w = (int)desc[11];
  p->tiles = (const float*)desc[12];
  p->tiles_len = desc[13];
  p->fwd = (const float*)desc[14];
  p->fwd_len = desc[15];
  p->twice = (int)desc[16];
  p->x016 = (const __nv_bfloat16*)desc[17];
  if (bf16 && !p->x016) return -1;
  if (p->n_layers < 2 || p->n_layers > MAX_LAYERS || len != HEAD + PER_LAYER * p->n_layers)
    return -1;
  if (p->n_out < 1 || p->n_out > MAX_OUT || p->e < 1 || p->h < 0 || p->h > p->e) return -1;
  if (p->h_pad != (p->h + TC_GROUP - 1) / TC_GROUP * TC_GROUP) return -1;
  if (p->m <= 0 || p->m % 4) return -1;
  if (!p->x0 || !p->y || (backward && (!p->dy || !p->dx0))) return -1;
  for (int l = 0; l < p->n_layers; ++l) {
    const long long* d = desc + HEAD + PER_LAYER * l;
    Layer& L = p->layers[l];
    L.w = (const float*)d[0]; L.wt = (const float*)d[1]; L.tail = (const float*)d[2];
    L.b = (const float*)d[3]; L.act = (float*)d[4]; L.dpre = (float*)d[5];
    L.dw = (float*)d[6]; L.dx = (float*)d[7]; L.db = (float*)d[8];
    L.in_pad = (int)d[9]; L.out_pad = (int)d[10]; L.has_x = (int)d[11]; L.dropout = (int)d[12];
    L.dpre16 = (__nv_bfloat16*)d[13];
    const bool hidden = l < p->n_layers - 1;
    if (!L.b) return -1;
    if (l == 0 ? (L.w || !L.has_x || L.in_pad != 0)
               : (!L.w || L.in_pad != p->layers[l - 1].out_pad)) return -1;
    if (!hidden && !L.wt) return -1;
    // the tail's rows exactly where a hidden layer reads x0 and x0 has a
    // tail; a latent_in final layer's `tail` is all of X's e rows (its
    // products run on the CUDA cores)
    if (!L.tail != !(L.has_x && (!hidden || p->h < p->e))) return -1;
    if (hidden) {
      if (L.out_pad < TC_GROUP || L.out_pad % TC_GROUP || !L.act) return -1;
    } else if (L.out_pad != p->n_out || L.dropout) {
      return -1;
    }
    if (backward && (!L.dpre || !L.db || (L.w && !L.dw) || (L.has_x && !L.dx))) return -1;
    if (backward && bf16 && !L.dpre16) return -1;
  }
  if (p->dx_last && (!backward || p->xl_w < 1 || p->xl_w > p->layers[p->n_layers - 1].in_pad))
    return -1;
  return 0;
}

// The forward's tiles, in layer order; -1 where a layer is outside the
// forward (train_fwd_tc.cuh) or the stream's length disagrees.  *rows: the
// buffer rows the widest layer needs (its depth or its width).
template <class Cfg>
static int fwd_tiles(const Plan& p, int* rows) {
  int total = 0;
  *rows = TC_GROUP;
  for (int l = 0; l < p.n_layers - 1; ++l) {
    const Layer& L = p.layers[l];
    const int depth = (L.w ? L.in_pad : 0) + head_copies(p, l) * p.h_pad;
    const int n = fw_layer_tiles<Cfg>(depth, L.out_pad);
    if (n < 0) return -1;
    total += n;
    if (depth > *rows) *rows = depth;
    if (L.out_pad > *rows) *rows = L.out_pad;
  }
  if (p.fwd_len != (long long)total * Cfg::kTile || (total > 0 && !p.fwd)) return -1;
  return total;
}

template <class Cfg, class R>
static int launch_fwd(const Plan& p, unsigned seed, unsigned thresh, float scale,
                      cudaStream_t stream) {
  int rows;
  const int total = fwd_tiles<Cfg>(p, &rows);
  if (total < 0) return -1;
  const size_t smem = tc_smem_bytes<Cfg>(rows);  // rows <= TC_MAX_OUT (fwd_tiles)
  cudaError_t err = cudaFuncSetAttribute(generic_train_fwd_tc_kernel<Cfg, R>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((p.m + TC_P - 1) / TC_P);
  generic_train_fwd_tc_kernel<Cfg, R><<<blocks, TC_THREADS, smem, stream>>>(p, rows, total, seed,
                                                                            thresh, scale);
  return (int)cudaGetLastError();
}

// bf16: the TcBf16 kernel with bf16 residuals, else split TF32 with float32.
extern "C" int generic_train_decoder_fwd(const long long* desc, int len, unsigned seed,
                                         unsigned thresh, float scale, int bf16, void* stream) {
  Plan p;
  if (parse(desc, len, &p, false, bf16)) return -1;
  return bf16 ? launch_fwd<TcBf16, __nv_bfloat16>(p, seed, thresh, scale, (cudaStream_t)stream)
              : launch_fwd<TcF32, float>(p, seed, thresh, scale, (cudaStream_t)stream);
}

// The chain's tiles: each hidden layer's, from the last down; -1 where a
// layer is outside the chain (chain_tc.cuh) or the stream's length
// disagrees.
template <class Cfg>
static int chain_tiles(const Plan& p) {
  int total = 0;
  for (int l = p.n_layers - 2; l >= 0; --l) {
    const Layer& L = p.layers[l];
    const int n = ch_layer_tiles<Cfg>(L.out_pad,
                                      (l > 0 ? L.in_pad : 0) + head_copies(p, l) * p.h_pad);
    if (n < 0) return -1;
    total += n;
  }
  if (p.layers[p.n_layers - 1].in_pad > CH_ROWS) return -1;
  if (p.tiles_len != (long long)total * Cfg::kTile || (total > 0 && !p.tiles)) return -1;
  return total;
}

template <class Cfg, class R>
static int launch_bwd(const Plan& p, float scale, cudaStream_t s) {
  const int total = chain_tiles<Cfg>(p);
  if (total < 0) return -1;
  const size_t smem = ch_smem_bytes<Cfg>();
  cudaError_t err = cudaFuncSetAttribute(generic_train_bwd_chain_tc_kernel<Cfg, R>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((p.m + TC_P - 1) / TC_P);
  generic_train_bwd_chain_tc_kernel<Cfg, R><<<blocks, TC_THREADS, smem, s>>>(p, total, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  constexpr bool kBf16 = Cfg::kBf16;
  static_assert(kBf16 == (sizeof(R) == 2), "bf16 arithmetic keeps bf16 residuals");
  // bf16: the bf16 residuals and x0's bf16 copy against the rounded dpre;
  // float32: the float32 ones against dpre
  using B16 = const __nv_bfloat16*;
  // bf16: every reduction after the first overlaps the kernel before it
  // (launch_wgrad_bf16); the first reads the chain's dpre
  int reductions = 0;
  for (int l = 0; l < p.n_layers; ++l) {
    const Layer& L = p.layers[l];
    int rc = 0;
    if (L.w) {
      const float* a = p.layers[l - 1].act;
      rc = kBf16 ? launch_wgrad(reinterpret_cast<B16>(a), L.dpre16, L.dw, L.in_pad, L.out_pad,
                                p.m, s, reductions++ > 0)
                 : launch_wgrad(a, L.dpre, L.dw, L.in_pad, L.out_pad, p.m, s);
      if (rc) return rc;
    }
    if (L.has_x) {
      rc = kBf16 ? launch_wgrad(p.x016, L.dpre16, L.dx, p.e, L.out_pad, p.m, s, reductions++ > 0)
                 : launch_wgrad(p.x0, L.dpre, L.dx, p.e, L.out_pad, p.m, s);
      if (rc) return rc;
    }
    if ((rc = launch_colsum(L.dpre, L.db, L.out_pad, p.m, 4096, 0, s))) return rc;
  }
  return 0;
}

// Every dw / dx and db must hold zeros on entry; dx0 need not.
extern "C" int generic_train_decoder_bwd(const long long* desc, int len, float scale, int bf16,
                                         void* stream) {
  Plan p;
  if (parse(desc, len, &p, true, bf16)) return -1;
  return bf16 ? launch_bwd<TcBf16, __nv_bfloat16>(p, scale, (cudaStream_t)stream)
              : launch_bwd<TcF32, float>(p, scale, (cudaStream_t)stream);
}
