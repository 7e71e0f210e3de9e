// Generic SDF decoder (kernel K6) for NVIDIA Hopper (sm_90a): both trunks on
// materialized [latent, embedding] rows.
//
// Replaces alignsdf_tpu/ops/decoder_kernel.py:make_fused_decoder (the Pallas
// kernel that make_pallas_decode_fn builds per call).  Contract: for M input
// rows per trunk (x_h (M, in_h), and x_o (M, in_o) unless the decoder is one
// combined trunk), run each trunk's ReLU hidden layers, where layer 0 reads
// the row x0 and a latent_in layer l > 0 computes a_{l-1} @ W_x + x0 @ W_in,
// then its final rows; write out (n_rows, M) float32: row 0 = tanh of the
// hand SDF, row 1 = tanh of the object SDF, rows 2.. = the classifier's
// logits cw x_last + cb on the first trunk's last hidden activation (the
// last layer's input before any re-injection), as _assemble_output packs
// them.  A latent_in final layer adds x0 @ W_in to its rows.  With 0 in
// latent_in the plan has summed both halves of layer 0's weight (they
// multiply the same row), so the kernel runs one product there.
//
// What bounds it: arithmetic.  At the --point_size 63 flagship width (NeRF
// PE, rows of 256 + 63 = 319, hidden 512 -> 193 -> 512 -> 512 -> 1) a trunk
// costs 786,944 multiply-adds per point against 1.3 KB of input row, so the
// card's float32 FMA rate bounds it (TF32 stays off so results match the
// plain version to float32 rounding).  wgmma, TMA and bf16 are later work.
//
// Design: tile_product.cuh's float32 tile product.  A block of 256 threads
// owns 32 rows.  Each trunk first stages its rows' x0 in shared memory as [column][point]
// (zero past the row's width, up to x0_pad = a multiple of 32): 40 KB at 319
// columns.  Layer 0 and the latent_in layers read it there through the
// streamed tile product (their W_in tiles stream from L2 like every weight),
// the activations ping-pong in shared memory, and the final rows (and the
// classifier's) run through final_rows, once on the last activation and,
// for a latent_in final layer, once on x0.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_product.cuh"

#define MAX_TRUNKS 2
#define MAX_HIDDEN 8
#define SDF_ROWS 2    // rows 0-1 take tanh
#define MAX_ROWS 128  // 2 SDF rows + 126 classes

struct Layer { int w, x, b, in_pad, out_pad; };  // offsets into prm; -1 = none
struct Trunk { int n_hidden, fin, fin_x, last_pad; Layer layers[MAX_HIDDEN]; };
struct Plan { int n_trunks, fin_b, max_pad, n_rows, x0_pad; Trunk trunks[MAX_TRUNKS]; };

struct Rows { const float* x; long long ld; int in; };  // row-major, row stride ld

__global__ void __launch_bounds__(NTHREADS, 1)
generic_decoder_kernel(const float* __restrict__ prm, const Plan plan, const Rows xh,
                       const Rows xo, int m, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* act0 = smem;
  float* act1 = act0 + plan.max_pad * TILE_P;
  float* ws = act1 + plan.max_pad * TILE_P;  // weight tile; also the final-row scratch
  float* x0s = ws + BK * OCHUNK;             // [x0_pad][TILE_P]
  float* oacc = x0s + plan.x0_pad * TILE_P;  // [n_rows][TILE_P]

  const int tid = threadIdx.x;
  const int first = blockIdx.x * TILE_P;
  for (int i = tid; i < plan.n_rows * TILE_P; i += NTHREADS) oacc[i] = 0.f;

  for (int t = 0; t < plan.n_trunks; ++t) {
    const Rows r = t == 0 ? xh : xo;
    __syncthreads();  // the previous trunk is done with x0s
    // a warp reads one column of 32 rows: a strided gather, but the tile's
    // 32 rows (~41 KB at 319 columns) stay in L1 across the columns, and
    // the stores hit 32 banks
    for (int i = tid; i < plan.x0_pad * TILE_P; i += NTHREADS) {
      const int c = i / TILE_P, q = i % TILE_P;
      x0s[i] = (c < r.in && first + q < m) ? __ldg(r.x + (size_t)(first + q) * r.ld + c) : 0.f;
    }
    __syncthreads();

    const Trunk& T = plan.trunks[t];
    float* cur = act0;
    float* nxt = act1;
    for (int l = 0; l < T.n_hidden; ++l) {
      const Layer& L = T.layers[l];
      hidden_layer(prm, L.w, -1, L.x, L.b, L.in_pad, L.out_pad, plan.x0_pad, cur, x0s, nxt, ws,
                   nullptr, tid);
      float* tmp = cur; cur = nxt; nxt = tmp;
    }
    // only the first trunk carries class rows (the plan packs them there)
    const int rows = t == 0 ? plan.n_rows : SDF_ROWS;
    final_rows(prm, T.fin, -1, T.last_pad, rows, cur, ws, oacc, nullptr, tid);
    if (T.fin_x >= 0) final_rows(prm, T.fin_x, -1, plan.x0_pad, rows, x0s, ws, oacc, nullptr, tid);
  }

  for (int i = tid; i < plan.n_rows * TILE_P; i += NTHREADS) {
    const int r = i / TILE_P, p = i % TILE_P;
    const float v = oacc[i] + prm[plan.fin_b + r];
    if (first + p < m) out[(size_t)r * m + first + p] = r < SDF_ROWS ? tanhf(v) : v;
  }
}

static size_t smem_bytes(int max_pad, int x0_pad, int n_rows) {
  return sizeof(float) * ((size_t)2 * max_pad * TILE_P + BK * OCHUNK + (size_t)x0_pad * TILE_P +
                          n_rows * TILE_P);
}

// desc: [n_trunks, fin_b, max_pad, n_rows, x0_pad, then per trunk: n_hidden,
// fin, fin_x, last_pad, then per hidden layer: w, x, b, in_pad, out_pad].
// x (x0_pad, out_pad) multiplies the input row; fin_x (n_rows, x0_pad) or -1.
// Returns 0, a cudaError_t from the launch, or -1 for a descriptor or input
// this kernel rejects.
extern "C" int generic_decoder_launch(const float* prm, const int* desc, int desc_len,
                                      const float* x_h, long long ld_h, int in_h,
                                      const float* x_o, long long ld_o, int in_o, int m,
                                      float* out, void* stream) {
  Plan plan;
  int pos = 0;
#define TAKE(v) do { if (pos >= desc_len) return -1; (v) = desc[pos++]; } while (0)
  TAKE(plan.n_trunks);
  TAKE(plan.fin_b);
  TAKE(plan.max_pad);
  TAKE(plan.n_rows);
  TAKE(plan.x0_pad);
  if (plan.n_trunks < 1 || plan.n_trunks > MAX_TRUNKS) return -1;
  if (plan.n_rows < SDF_ROWS || plan.n_rows > MAX_ROWS) return -1;
  if (plan.max_pad < OCHUNK || plan.max_pad % OCHUNK) return -1;
  if (plan.x0_pad < BK || plan.x0_pad % BK) return -1;
  for (int t = 0; t < plan.n_trunks; ++t) {
    Trunk& T = plan.trunks[t];
    TAKE(T.n_hidden);
    TAKE(T.fin);
    TAKE(T.fin_x);
    TAKE(T.last_pad);
    if (T.n_hidden < 1 || T.n_hidden > MAX_HIDDEN) return -1;
    for (int l = 0; l < T.n_hidden; ++l) {
      Layer& L = T.layers[l];
      TAKE(L.w); TAKE(L.x); TAKE(L.b); TAKE(L.in_pad); TAKE(L.out_pad);
      if (L.out_pad % OCHUNK || L.out_pad > plan.max_pad || L.in_pad % BK ||
          L.in_pad > plan.max_pad) return -1;
      if ((L.w >= 0 && (L.w & 3)) || (L.x >= 0 && (L.x & 3))) return -1;  // float4 tiles
      // layer 0 reads only x0; later layers their input, and x0 where latent_in
      if (l == 0 ? (L.w >= 0 || L.x < 0 || L.in_pad != 0)
                 : (L.w < 0 || L.in_pad != T.layers[l - 1].out_pad)) return -1;
    }
    if (T.last_pad != T.layers[T.n_hidden - 1].out_pad) return -1;
  }
#undef TAKE
  if (pos != desc_len || m <= 0) return -1;
  if (!x_h || in_h < 1 || in_h > plan.x0_pad || ld_h < in_h) return -1;
  if (plan.n_trunks == 2 && (!x_o || in_o < 1 || in_o > plan.x0_pad || ld_o < in_o)) return -1;

  const size_t smem = smem_bytes(plan.max_pad, plan.x0_pad, plan.n_rows);
  cudaError_t err = cudaFuncSetAttribute(generic_decoder_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((m + TILE_P - 1) / TILE_P);
  const Rows rh = {x_h, ld_h, in_h};
  const Rows ro = {plan.n_trunks == 2 ? x_o : x_h, plan.n_trunks == 2 ? ld_o : ld_h,
                   plan.n_trunks == 2 ? in_o : in_h};
  generic_decoder_kernel<<<blocks, NTHREADS, smem, (cudaStream_t)stream>>>(prm, plan, rh, ro, m,
                                                                          out);
  return (int)cudaGetLastError();
}
