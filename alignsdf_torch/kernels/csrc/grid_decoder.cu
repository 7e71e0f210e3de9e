// Fused SDF grid decoder (kernel K1) for NVIDIA Hopper (sm_90a).
//
// Replaces alignsdf_tpu/ops/decoder_kernel.py:make_fused_grid_kernel_t (the
// lanes-major Pallas kernel built by make_fused_grid_decode_fn).  Contract:
// for a run of M contiguous linear grid indices starting at `base` (z
// fastest), derive each point's xyz in-kernel, run the latent-folded trunks
// (ReLU hidden layers whose latent / embedding inputs were folded on the host
// into per-layer biases plus 3-row xyz weights), and write the final rows:
// out is (n_rows, M) float32, row 0 = tanh of the hand SDF, row 1 = tanh of
// the object SDF, rows 2 .. n_rows - 1 = the classifier's logits cw a_h + cb
// without tanh (a_h = the hand trunk's last hidden activation, already in
// shared memory).  n_rows is a field of the plan, 2 to 128: it covers both
// TPU kernels, the lanes-major one (<= 6 classes) and the points-major
// make_fused_grid_kernel (decoder_kernel.py:381, <= 126 classes), with one
// layout.
//
// What bounds it: arithmetic.  The flagship trunk (hidden 512 -> 250 -> 512 ->
// 512 -> 1) costs 512*250 + 250*512 + 512*512 + 512 ~= 0.52 M MAC per point,
// so both trunks are ~2.07 MFLOP per point (~8.7 TFLOP for one image at 128^3,
// two passes) against 8 bytes of output per point.  This first design runs
// plain float32 FMAs (no TF32) so the field matches the plain version to f32
// rounding; its ceiling is the card's float32 FMA rate.  wgmma, TMA, bf16
// and persistent blocks are later work.
//
// Design: one block of 256 threads owns a tile of 32 points.  The tile's
// activations stay in shared memory as [feature][point] (two ping-pong
// buffers of max_pad x 32 floats), and the block walks the layers with the
// streamed tile product of tile_product.cuh (both flagship trunks are ~4.2
// MB of weights and sit in the 50 MB L2).  The class rows are extra final
// rows of the hand trunk: 6 classes add 6 x 512 multiply-adds to ~1 M a
// point.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_product.cuh"

#define MAX_TRUNKS 2
#define MAX_HIDDEN 8
#define SDF_ROWS 2    // rows 0-1 take tanh
#define MAX_ROWS 128  // 2 SDF rows + 126 classes

struct Layer { int w, x, b, in_pad, out_pad; };  // offsets into prm; -1 = none
struct Trunk { int n_hidden, fin, fin_xyz, last_pad; Layer layers[MAX_HIDDEN]; };
struct Plan { int n_trunks, fin_b, max_pad, n_rows; Trunk trunks[MAX_TRUNKS]; };

__global__ void __launch_bounds__(NTHREADS, 1)
grid_decoder_kernel(const float* __restrict__ prm, const Plan plan,
                    const float* __restrict__ scal, long long base, int m, int n,
                    float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* act0 = smem;
  float* act1 = act0 + plan.max_pad * TILE_P;
  float* ws = act1 + plan.max_pad * TILE_P;  // weight tile; also the final-row scratch
  float* xyz = ws + BK * OCHUNK;             // [3][TILE_P]
  float* oacc = xyz + 3 * TILE_P;            // [n_rows][TILE_P]

  const int tid = threadIdx.x;
  const long long first = (long long)blockIdx.x * TILE_P;
  if (tid < TILE_P) {
    // the same index arithmetic as the TPU kernel: integer // and %, then
    // * voxel + origin (decoder_kernel.py:633-638)
    const long long idx = base + first + tid;
    const long long nsq = (long long)n * n;
    const float voxel = scal[3];
    xyz[tid] = (float)((idx / nsq) % n) * voxel + scal[0];
    xyz[TILE_P + tid] = (float)((idx / n) % n) * voxel + scal[1];
    xyz[2 * TILE_P + tid] = (float)(idx % n) * voxel + scal[2];
  }
  for (int i = tid; i < plan.n_rows * TILE_P; i += NTHREADS) oacc[i] = 0.f;
  __syncthreads();

  for (int t = 0; t < plan.n_trunks; ++t) {
    const Trunk& T = plan.trunks[t];
    float* cur = act0;
    float* nxt = act1;
    for (int l = 0; l < T.n_hidden; ++l) {
      const Layer& L = T.layers[l];
      hidden_layer(prm, L.w, L.x, -1, L.b, L.in_pad, L.out_pad, 0, cur, nullptr, nxt, ws, xyz,
                   tid);
      float* tmp = cur; cur = nxt; nxt = tmp;
    }
    // only the first trunk carries class rows (the plan packs them there)
    final_rows(prm, T.fin, T.fin_xyz, T.last_pad, t == 0 ? plan.n_rows : SDF_ROWS, cur, ws, oacc,
               xyz, tid);
  }

  for (int i = tid; i < plan.n_rows * TILE_P; i += NTHREADS) {
    const int r = i / TILE_P, p = i % TILE_P;
    const float v = oacc[i] + prm[plan.fin_b + r];
    if (first + p < m) out[(size_t)r * m + first + p] = r < SDF_ROWS ? tanhf(v) : v;
  }
}

static size_t smem_bytes(int max_pad, int n_rows) {
  return sizeof(float) * ((size_t)2 * max_pad * TILE_P + BK * OCHUNK + 3 * TILE_P + n_rows * TILE_P);
}

// desc: [n_trunks, fin_b, max_pad, n_rows, then per trunk: n_hidden, fin,
// fin_xyz, last_pad, then per hidden layer: w, x, b, in_pad, out_pad].
// Returns 0, a cudaError_t from the launch, or -1 for a descriptor this
// kernel rejects.
extern "C" int grid_decoder_launch(const float* prm, const int* desc, int desc_len,
                                   const float* scal, long long base, int m, int n,
                                   float* out, void* stream) {
  Plan plan;
  int pos = 0;
#define TAKE(v) do { if (pos >= desc_len) return -1; (v) = desc[pos++]; } while (0)
  TAKE(plan.n_trunks);
  TAKE(plan.fin_b);
  TAKE(plan.max_pad);
  TAKE(plan.n_rows);
  if (plan.n_trunks < 1 || plan.n_trunks > MAX_TRUNKS) return -1;
  if (plan.n_rows < SDF_ROWS || plan.n_rows > MAX_ROWS) return -1;
  if (plan.max_pad < OCHUNK || plan.max_pad % OCHUNK) return -1;
  for (int t = 0; t < plan.n_trunks; ++t) {
    Trunk& T = plan.trunks[t];
    TAKE(T.n_hidden);
    TAKE(T.fin);
    TAKE(T.fin_xyz);
    TAKE(T.last_pad);
    if (T.n_hidden < 1 || T.n_hidden > MAX_HIDDEN) return -1;
    for (int l = 0; l < T.n_hidden; ++l) {
      Layer& L = T.layers[l];
      TAKE(L.w); TAKE(L.x); TAKE(L.b); TAKE(L.in_pad); TAKE(L.out_pad);
      if (L.out_pad % OCHUNK || L.out_pad > plan.max_pad || L.in_pad % BK ||
          L.in_pad > plan.max_pad) return -1;
      if (L.w >= 0 && (L.w & 3)) return -1;  // weight tiles load as float4
    }
    // layer 0 reads only xyz: its latent / embedding input is folded away
    if (T.layers[0].w >= 0) return -1;
    if (T.last_pad != T.layers[T.n_hidden - 1].out_pad) return -1;
  }
#undef TAKE
  if (pos != desc_len || m <= 0 || n <= 0) return -1;

  const size_t smem = smem_bytes(plan.max_pad, plan.n_rows);
  cudaError_t err = cudaFuncSetAttribute(grid_decoder_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((m + TILE_P - 1) / TILE_P);
  grid_decoder_kernel<<<blocks, NTHREADS, smem, (cudaStream_t)stream>>>(
      prm, plan, scal, base, m, n, out);
  return (int)cudaGetLastError();
}
