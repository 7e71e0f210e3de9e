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
// layers, tanh on the last (which takes no re-injection).  The forward stores
// each hidden layer's gated activation as the residual, the last one being
// x_last, the classifier's input; the backward recovers the gate as
// (a > 0) * s, adds dx_last before the last hidden gate (_bwd_kernel
// :277-278), and emits d(x0) over the whole input row, so the gradient
// reaches the latent (and, for pixel-aligned rows, the map) and the
// embedding, besides dW, dX and db.
//
// What bounds it: arithmetic.  The flagship trunk with latent_in (0, 2)
// (rows of 262, hidden 512 -> 250 -> 512 -> 512 -> 1) costs 786,944
// multiply-adds per point forward in the summed form and twice that
// backward (d(input) and dW of every product), against ~9 KB of residuals
// written and read per point: the card's float32 FMA rate bounds both
// directions (TF32 stays off so results match the plain version to float32
// rounding); the backward's weight-gradient reduction runs split TF32 on
// wgmma (wgrad_tc.cuh).
//
// Design: K2's former one (train_decoder.cu, before K2's forward and chain
// moved to the tensor cores, train_fwd_tc.cuh and chain_tc.cuh), with the
// input products through the streamed tile product of tile_product.cuh,
// since K2's per-column loop over at most 64 embedding columns would not do
// for 262-319.
//  - Forward: a block of 256 threads owns 32 points and stages their x0 in
//    shared memory as [column][point] (from x0 feature-major (e, M), so the
//    loads coalesce; zero to e_pad, a multiple of 32): 40 KB at 319.
//  - Backward 1, the reverse chain per 32-point tile: K2's former design
//    (K2's and K4's chains now run on chain_tc.cuh), and where a
//    layer has X, d(x0)^T += X_l . dpre_l through the tile product on the
//    transposed X (out_pad, e_tpad), e_tpad a multiple of 256 (the product's
//    output chunk), added into dx0t (e, M) in device memory: each thread
//    adds to the same entries at every such layer, and no other block
//    touches the tile's points.
//  - Backward 2 and 3: the split-K weight reductions on the tensor cores
//    (dW from the residuals, dX from x0^T; wgrad_tc.cuh) and the bias sums
//    of train_common.cuh.

#include <cuda_runtime.h>
#include <stdint.h>

#include "train_common.cuh"  // gate_hash, wgrad / colsum; tile_product.cuh's tile product

#define MAX_LAYERS 10
#define MAX_OUT 2

struct Layer {
  const float *w, *wt, *x, *xt, *b;  // w (in_pad, out_pad), wt its transpose; x (e_pad, out_pad),
                                     // xt (out_pad, e_tpad)
  float *act, *dpre;                 // residual (out_pad, M), pre-activation grad (out_pad, M)
  float *dw, *dx, *db;               // gradients: (in_pad, out_pad), (e, out_pad), (out_pad,)
  int in_pad, out_pad, dropout;
};

struct Plan {
  int n_layers, n_out, e, e_pad, e_tpad, m, max_pad;
  const float* x0;       // (e, M)
  float* y;              // (n_out, M)
  const float* dy;       // (n_out, M)
  float* dx0;            // (e, M), accumulated: holds zeros at launch
  const float* dx_last;  // (M, xl_w) or null
  int xl_w;
  Layer layers[MAX_LAYERS];
};

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(NTHREADS, 1)
generic_train_fwd_kernel(const Plan p, unsigned seed, unsigned thresh, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* act0 = smem;
  float* act1 = act0 + p.max_pad * TILE_P;
  float* ws = act1 + p.max_pad * TILE_P;
  float* x0s = ws + BK * OCHUNK;          // [e_pad][TILE_P]
  float* red = x0s + p.e_pad * TILE_P;    // [8][TILE_P]

  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const int first = blockIdx.x * TILE_P;
  for (int i = tid; i < p.e_pad * TILE_P; i += NTHREADS) {
    const int c = i / TILE_P, q = i % TILE_P;
    x0s[i] = (c < p.e && first + q < p.m) ? __ldg(p.x0 + (size_t)c * p.m + first + q) : 0.f;
  }
  __syncthreads();

  float* cur = act0;
  float* nxt = act1;
  for (int l = 0; l < p.n_layers - 1; ++l) {
    const Layer& L = p.layers[l];
    for (int oc = 0; oc < L.out_pad; oc += OCHUNK) {
      float acc[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      if (L.w) tile_product(acc, L.w, L.out_pad, L.in_pad, cur, ws, oc, tid);
      if (L.x) tile_product(acc, L.x, L.out_pad, p.e_pad, x0s, ws, oc, tid);
      const int row0 = first + tx * 4;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int o = oc + ty * 8 + i;
        const float bias = __ldg(L.b + o);
        float r[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float v = fmaxf(acc[i][j] + bias, 0.f);
          if (L.dropout)
            v = gate_hash(seed, (unsigned)l, (unsigned)(row0 + j), (unsigned)o) < thresh ? v * scale
                                                                                         : 0.f;
          r[j] = v;
        }
        const float4 rv = make_float4(r[0], r[1], r[2], r[3]);
        *reinterpret_cast<float4*>(nxt + o * TILE_P + tx * 4) = rv;
        if (row0 < p.m) *reinterpret_cast<float4*>(L.act + (size_t)o * p.m + row0) = rv;
      }
    }
    __syncthreads();  // `nxt` is complete before the next layer reads it
    float* t = cur; cur = nxt; nxt = t;
  }

  // last layer: y[r][p] = tanh(sum_k wt[r][k] cur[k][p] + b[r]).  Warp w sums
  // row w/4 over k = w%4 (mod 4); lanes are points.
  const Layer& L = p.layers[p.n_layers - 1];
  const int pt = tid & 31, w = tid >> 5, r = w >> 2, part = w & 3;
  if (r < p.n_out) {
    const float* f = L.wt + (size_t)r * L.in_pad;
    float s = 0.f;
    for (int k = part; k < L.in_pad; k += 4) s = fmaf(__ldg(f + k), cur[k * TILE_P + pt], s);
    red[w * TILE_P + pt] = s;
  }
  __syncthreads();
  if (tid < p.n_out * TILE_P) {
    const int rr = tid / TILE_P, pp = tid % TILE_P;
    const float v = red[(rr * 4 + 0) * TILE_P + pp] + red[(rr * 4 + 1) * TILE_P + pp]
                  + red[(rr * 4 + 2) * TILE_P + pp] + red[(rr * 4 + 3) * TILE_P + pp];
    if (first + pp < p.m) p.y[(size_t)rr * p.m + first + pp] = tanhf(v + __ldg(L.b + rr));
  }
}

// ---------------------------------------------------------------------------
// backward 1: the reverse chain per point tile
// ---------------------------------------------------------------------------

// dx0t[c][first + p] += sum_o X[c][o] d[o][p] for the tile, through xt
// (out_pad, e_tpad): the tile product's 256-column chunks of the input row.
__device__ __forceinline__ void add_input_grad(const Plan& p, const Layer& L, const float* d,
                                               float* ws, int first, int tid) {
  const int tx = tid & 7, ty = tid >> 3;
  const int row0 = first + tx * 4;
  for (int oc = 0; oc < p.e_tpad; oc += OCHUNK) {
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    tile_product(acc, L.xt, p.e_tpad, L.out_pad, d, ws, oc, tid);
    if (row0 >= p.m) continue;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = oc + ty * 8 + i;
      if (c >= p.e) continue;
      float4* dst = reinterpret_cast<float4*>(p.dx0 + (size_t)c * p.m + row0);
      float4 v = *dst;
      v.x += acc[i][0]; v.y += acc[i][1]; v.z += acc[i][2]; v.w += acc[i][3];
      *dst = v;
    }
  }
}

__global__ void __launch_bounds__(NTHREADS, 1)
generic_train_bwd_chain_kernel(const Plan p, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* d0 = smem;
  float* d1 = d0 + p.max_pad * TILE_P;
  float* ws = d1 + p.max_pad * TILE_P;
  float* g = ws + BK * OCHUNK;    // [n_out][TILE_P]

  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const int first = blockIdx.x * TILE_P;

  // last layer: dpre = dy * (1 - y^2)
  const int last = p.n_layers - 1;
  const Layer& F = p.layers[last];
  if (tid < p.n_out * TILE_P) {
    const int r = tid / TILE_P, q = tid % TILE_P, row = first + q;
    float v = 0.f;
    if (row < p.m) {
      const float yv = p.y[(size_t)r * p.m + row];
      v = p.dy[(size_t)r * p.m + row] * (1.f - yv * yv);
      F.dpre[(size_t)r * p.m + row] = v;
    }
    g[tid] = v;
  }
  __syncthreads();

  // its input's gradient (plus dx_last), gated by the last hidden layer's
  // recovered gate; without dx_last the product and the gate share one loop
  const Layer& H = p.layers[last - 1];
  const float hs = H.dropout ? scale : 1.f;
  if (p.dx_last) {
    for (int i = tid; i < F.in_pad * TILE_P; i += NTHREADS) {
      const int k = i / TILE_P, q = i % TILE_P;
      float dx = 0.f;
      for (int r = 0; r < p.n_out; ++r) dx = fmaf(__ldg(F.w + (size_t)k * p.n_out + r), g[r * TILE_P + q], dx);
      d0[i] = dx;
    }
    __syncthreads();
    add_transposed(d0, p.dx_last, p.xl_w, p.m, first, tid);
    __syncthreads();
  }
  for (int i = tid; i < F.in_pad * TILE_P; i += NTHREADS) {
    const int k = i / TILE_P, q = i % TILE_P, row = first + q;
    float dx = 0.f;
    if (p.dx_last) {
      dx = d0[i];
    } else {
      for (int r = 0; r < p.n_out; ++r) dx = fmaf(__ldg(F.w + (size_t)k * p.n_out + r), g[r * TILE_P + q], dx);
    }
    float v = 0.f;
    if (row < p.m) {
      v = H.act[(size_t)k * p.m + row] > 0.f ? dx * hs : 0.f;
      H.dpre[(size_t)k * p.m + row] = v;
    }
    d0[i] = v;
  }
  __syncthreads();

  float* cur = d0;
  float* nxt = d1;
  for (int l = last - 1; l >= 0; --l) {
    const Layer& L = p.layers[l];
    if (L.x) add_input_grad(p, L, cur, ws, first, tid);
    if (l == 0) break;
    const Layer& P = p.layers[l - 1];
    const float ps = P.dropout ? scale : 1.f;
    // dx[k][p] = sum_o W[k][o] cur[o][p] through wt (out_pad, in_pad)
    for (int oc = 0; oc < L.in_pad; oc += OCHUNK) {
      float acc[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      tile_product(acc, L.wt, L.in_pad, L.out_pad, cur, ws, oc, tid);
      const int row0 = first + tx * 4;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int k = oc + ty * 8 + i;
        float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
        if (row0 < p.m) a = *reinterpret_cast<const float4*>(P.act + (size_t)k * p.m + row0);
        const float4 rv = make_float4(a.x > 0.f ? acc[i][0] * ps : 0.f,
                                      a.y > 0.f ? acc[i][1] * ps : 0.f,
                                      a.z > 0.f ? acc[i][2] * ps : 0.f,
                                      a.w > 0.f ? acc[i][3] * ps : 0.f);
        *reinterpret_cast<float4*>(nxt + k * TILE_P + tx * 4) = rv;
        if (row0 < p.m) *reinterpret_cast<float4*>(P.dpre + (size_t)k * p.m + row0) = rv;
      }
    }
    __syncthreads();
    float* t = cur; cur = nxt; nxt = t;
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

static size_t fwd_smem_bytes(int max_pad, int e_pad) {
  return sizeof(float) * ((size_t)2 * max_pad * TILE_P + BK * OCHUNK + (size_t)e_pad * TILE_P +
                          8 * TILE_P);
}

static size_t bwd_smem_bytes(int max_pad) {
  return sizeof(float) * ((size_t)2 * max_pad * TILE_P + BK * OCHUNK + MAX_OUT * TILE_P);
}

// desc (int64): [n_layers, n_out, e, e_pad, e_tpad, m, x0, y, dy, dx0,
// dx_last, xl_w, then per layer: w, wt, x, xt, b, act, dpre, dw, dx, db,
// in_pad, out_pad, dropout].  Pointers are device addresses, 0 = absent.
#define HEAD 12
#define PER_LAYER 13
static int parse(const long long* desc, int len, Plan* p, bool backward) {
  if (len < HEAD) return -1;
  p->n_layers = (int)desc[0];
  p->n_out = (int)desc[1];
  p->e = (int)desc[2];
  p->e_pad = (int)desc[3];
  p->e_tpad = (int)desc[4];
  p->m = (int)desc[5];
  p->x0 = (const float*)desc[6];
  p->y = (float*)desc[7];
  p->dy = (const float*)desc[8];
  p->dx0 = (float*)desc[9];
  p->dx_last = (const float*)desc[10];
  p->xl_w = (int)desc[11];
  if (p->n_layers < 2 || p->n_layers > MAX_LAYERS || len != HEAD + PER_LAYER * p->n_layers)
    return -1;
  if (p->n_out < 1 || p->n_out > MAX_OUT || p->e < 1) return -1;
  if (p->e_pad != (p->e + BK - 1) / BK * BK || p->e_tpad != (p->e + OCHUNK - 1) / OCHUNK * OCHUNK)
    return -1;
  if (p->m <= 0 || p->m % 4) return -1;
  if (!p->x0 || !p->y || (backward && (!p->dy || !p->dx0))) return -1;
  p->max_pad = OCHUNK;
  for (int l = 0; l < p->n_layers; ++l) {
    const long long* d = desc + HEAD + PER_LAYER * l;
    Layer& L = p->layers[l];
    L.w = (const float*)d[0]; L.wt = (const float*)d[1]; L.x = (const float*)d[2];
    L.xt = (const float*)d[3]; L.b = (const float*)d[4]; L.act = (float*)d[5];
    L.dpre = (float*)d[6]; L.dw = (float*)d[7]; L.dx = (float*)d[8]; L.db = (float*)d[9];
    L.in_pad = (int)d[10]; L.out_pad = (int)d[11]; L.dropout = (int)d[12];
    const bool hidden = l < p->n_layers - 1;
    if (!L.b) return -1;
    if (l == 0 ? (L.w || !L.x || L.in_pad != 0) : (!L.w || !L.wt || L.in_pad != p->layers[l - 1].out_pad)) return -1;
    if (hidden) {
      if (L.out_pad < OCHUNK || L.out_pad % OCHUNK || !L.act) return -1;
      if (L.out_pad > p->max_pad) p->max_pad = L.out_pad;
    } else if (L.out_pad != p->n_out || L.x || L.dropout) {
      return -1;
    }
    if (backward && (!L.dpre || !L.db || (L.w && !L.dw) || (L.x && (!L.dx || !L.xt)))) return -1;
  }
  if (p->dx_last && (!backward || p->xl_w < 1 || p->xl_w > p->layers[p->n_layers - 1].in_pad))
    return -1;
  return 0;
}

extern "C" int generic_train_decoder_fwd(const long long* desc, int len, unsigned seed,
                                         unsigned thresh, float scale, void* stream) {
  Plan p;
  if (parse(desc, len, &p, false)) return -1;
  const size_t smem = fwd_smem_bytes(p.max_pad, p.e_pad);
  cudaError_t err = cudaFuncSetAttribute(generic_train_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((p.m + TILE_P - 1) / TILE_P);
  generic_train_fwd_kernel<<<blocks, NTHREADS, smem, (cudaStream_t)stream>>>(p, seed, thresh,
                                                                              scale);
  return (int)cudaGetLastError();
}

extern "C" int generic_train_decoder_bwd(const long long* desc, int len, float scale,
                                         void* stream) {
  Plan p;
  if (parse(desc, len, &p, true)) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = bwd_smem_bytes(p.max_pad);
  cudaError_t err = cudaFuncSetAttribute(generic_train_bwd_chain_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((p.m + TILE_P - 1) / TILE_P);
  generic_train_bwd_chain_kernel<<<blocks, NTHREADS, smem, s>>>(p, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  for (int l = 0; l < p.n_layers; ++l) {
    const Layer& L = p.layers[l];
    int rc;
    if (L.w && (rc = launch_wgrad(p.layers[l - 1].act, L.dpre, L.dw, L.in_pad, L.out_pad, p.m, s)))
      return rc;
    if (L.x && (rc = launch_wgrad(p.x0, L.dpre, L.dx, p.e, L.out_pad, p.m, s))) return rc;
    if ((rc = launch_colsum(L.dpre, L.db, L.out_pad, p.m, 4096, 0, s))) return rc;
  }
  return 0;
}
