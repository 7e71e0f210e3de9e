// Fused pixel-aligned SDF grid decoder (kernel K3) for NVIDIA Hopper (sm_90a).
//
// Replaces alignsdf_tpu/ops/decoder_kernel.py:make_fused_pixel_grid_kernel_t
// (the lanes-major Pallas kernel built by make_fused_pixel_grid_decode_fn).
// Contract: for a run of M contiguous linear grid indices starting at `base`
// (z fastest), derive each point's xyz in-kernel; project it through the
// affine map e = xyz @ A + b, the scale 2 / sdf_scale_factor, the predicted
// hand root and the camera K; a point inside the image (0 <= xi, yi <= size,
// zh != 0) takes as its latent the bicubic sample (Keys, A = -0.75,
// align_corners, zero padding) of the (Hf, Wf, C) feature map at
// (xi (Wf-1)/size, yi (Hf-1)/size), any other point the map's mean; then run
// the trunks (ReLU hidden layers; the embedding is folded on the host into
// biases plus 3-row xyz weights, while the latent stays an input of layer 0
// and of the latent_in layers) and write the final rows: out is (n_rows, M)
// float32, row 0 = tanh of the hand SDF, row 1 = tanh of the object SDF, rows
// 2 .. n_rows - 1 = the classifier's logits cw a_h + cb without tanh (a_h =
// the first trunk's last hidden activation; decoder_kernel.py:1145-1148).
// n_rows is a field of the plan, 2 to 128, as in K1: the TPU kernel stops at
// 6 classes (:1304-1307), this one takes up to 126.
//
// Sampling: the TPU kernel contracts a dense (Hf*Wf x block) Keys weight tile
// on the MXU (and bands it, _band_plan), because gathers are slow there.
// Here the 4 x 4 taps floor(p)-1 .. floor(p)+2 of each point are gathered
// directly with the closed-form Keys weights; a tap off the map contributes
// zero.  The dense tile's other weights are exactly zero, so this is the same
// sum in another order.  There is no band, so nothing can be left out of it.
//
// What bounds it: arithmetic.  The latent differs at every point, so it
// cannot fold into biases as in K1: layer 0 and the latent_in layer each
// carry a real C x 512 product per trunk.  The flagship (C = 256, hidden 512
// -> 250 -> 512 -> 512 -> 1) costs ~0.78 M multiply-adds per trunk and
// point, 3.12 MFLOP per point for both trunks, 6.55 TFLOP per 128^3 pass:
// 97.7 ms at the card's 67 TFLOP/s float32 rate.  The gather is 16 taps x C
// channels (8 kFLOP per point) read from a 4.2 MB table that stays in L2.
// This first design runs plain float32 FMAs (no TF32), as K1 does; wgmma,
// TMA and bf16 are later work.
//
// Design: K1's layout and its streamed tile product (tile_product.cuh).  One
// block of 256 threads owns a tile of 32 points.  Its activations stay in
// shared memory as [feature][point] (two ping-pong buffers of max_pad x 32
// floats), beside a [lat_pad][32] latent tile that the gather stage fills:
// one thread a channel, so the 32 lanes of a warp read 128 contiguous bytes
// of a tap's row.  Layer 0 and the latent_in layers add a second tile
// product, of their latent weights with the latent tile.
//
// The projection runs one rounding per operation (no FMA contraction) in
// the plain version's order, so that the kernel and
// pixel_grid_decode_reference agree bit for bit on which points lie in the
// image.

#include <cuda_runtime.h>
#include <stdint.h>

#include "keys_cubic.cuh"
#include "tile_product.cuh"

#define MAX_TRUNKS 2
#define MAX_HIDDEN 8
#define SDF_ROWS 2    // rows 0-1 take tanh
#define MAX_ROWS 128  // 2 SDF rows + 126 classes

struct Layer { int w, x, lat, b, in_pad, out_pad; };  // offsets into prm; -1 = none
struct Trunk { int n_hidden, fin, fin_xyz, last_pad; Layer layers[MAX_HIDDEN]; };
struct Plan { int n_trunks, fin_b, max_pad, c, lat_pad, hf, wf, n_rows; Trunk trunks[MAX_TRUNKS]; };

// a*x + b*y + c*z, one rounding per operation, left to right.
__device__ __forceinline__ float dot3(float a, float x, float b, float y, float c, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y)), __fmul_rn(c, z));
}

__global__ void __launch_bounds__(NTHREADS, 1)
pixel_grid_decoder_kernel(const float* __restrict__ prm, const Plan plan,
                          const float* __restrict__ table, const float* __restrict__ scal,
                          long long base, int m, int n, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* act0 = smem;
  float* act1 = act0 + plan.max_pad * TILE_P;
  float* lat = act1 + plan.max_pad * TILE_P;   // [lat_pad][TILE_P]
  float* ws = lat + plan.lat_pad * TILE_P;     // weight tile; also the final-row scratch
  float* xyz = ws + BK * OCHUNK;               // [3][TILE_P]
  float* oacc = xyz + 3 * TILE_P;              // [n_rows][TILE_P]
  float* tap_w = oacc + plan.n_rows * TILE_P;  // [TILE_P][8]: 4 row, then 4 column weights
  int* tap_rc = reinterpret_cast<int*>(tap_w + 8 * TILE_P);  // [TILE_P][8]: rows*wf, columns; -1 = off
  int* inside = tap_rc + 8 * TILE_P;           // [TILE_P]

  const int tid = threadIdx.x;
  const long long first = (long long)blockIdx.x * TILE_P;
  const int hf = plan.hf, wf = plan.wf, c = plan.c;
  if (tid < TILE_P) {
    // the same index arithmetic as the TPU kernel (integer // and %), then
    // xyz = ijk * voxel + origin and the projection (decoder_kernel.py:1053-1080)
    const long long idx = base + first + tid;
    const long long nsq = (long long)n * n;
    const float voxel = scal[3];
    const float x = __fadd_rn(__fmul_rn((float)((idx / nsq) % n), voxel), scal[0]);
    const float y = __fadd_rn(__fmul_rn((float)((idx / n) % n), voxel), scal[1]);
    const float z = __fadd_rn(__fmul_rn((float)(idx % n), voxel), scal[2]);
    xyz[tid] = x;
    xyz[TILE_P + tid] = y;
    xyz[2 * TILE_P + tid] = z;
    const float* pr = scal + 4;
    float cam[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float e = __fadd_rn(dot3(pr[j], x, pr[3 + j], y, pr[6 + j], z), pr[9 + j]);
      cam[j] = __fadd_rn(__fmul_rn(e, pr[24]), pr[21 + j]);
    }
    const float xh = dot3(pr[12], cam[0], pr[13], cam[1], pr[14], cam[2]);
    const float yh = dot3(pr[15], cam[0], pr[16], cam[1], pr[17], cam[2]);
    const float zh = dot3(pr[18], cam[0], pr[19], cam[1], pr[20], cam[2]);
    const float inv = __fdiv_rn(1.f, zh);
    const float xi = __fmul_rn(xh, inv), yi = __fmul_rn(yh, inv);
    const float size = pr[27];
    const bool in = xi >= 0.f && xi <= size && yi >= 0.f && yi <= size && zh != 0.f;
    inside[tid] = in;
    if (in) {
      const float xp = __fmul_rn(xi, pr[25]), yp = __fmul_rn(yi, pr[26]);
      const float x0 = floorf(xp), y0 = floorf(yp);
      keys_taps(yp - y0, tap_w + tid * 8);
      keys_taps(xp - x0, tap_w + tid * 8 + 4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = (int)y0 + i - 1, col = (int)x0 + i - 1;
        tap_rc[tid * 8 + i] = (row >= 0 && row < hf) ? row * wf : -1;
        tap_rc[tid * 8 + 4 + i] = (col >= 0 && col < wf) ? col : -1;
      }
    }
  }
  for (int i = tid; i < plan.n_rows * TILE_P; i += NTHREADS) oacc[i] = 0.f;
  __syncthreads();

  // gather: lat[ch][p] = sum of the 16 weighted taps, or the mean row
  const float* mean = table + (size_t)hf * wf * c;
  for (int ch = tid; ch < plan.lat_pad; ch += NTHREADS) {
    for (int p0 = 0; p0 < TILE_P; p0 += 4) {
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = p0 + q;
        float s = 0.f;
        if (ch >= c) {
          s = 0.f;
        } else if (!inside[p]) {
          s = __ldg(mean + ch);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = tap_rc[p * 8 + i];
            if (r < 0) continue;
            const float wy = tap_w[p * 8 + i];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int col = tap_rc[p * 8 + 4 + j];
              if (col < 0) continue;
              s = fmaf(wy * tap_w[p * 8 + 4 + j], __ldg(table + (size_t)(r + col) * c + ch), s);
            }
          }
        }
        v[q] = s;
      }
      *reinterpret_cast<float4*>(lat + ch * TILE_P + p0) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
  __syncthreads();

  for (int t = 0; t < plan.n_trunks; ++t) {
    const Trunk& T = plan.trunks[t];
    float* cur = act0;
    float* nxt = act1;
    for (int l = 0; l < T.n_hidden; ++l) {
      const Layer& L = T.layers[l];
      hidden_layer(prm, L.w, L.x, L.lat, L.b, L.in_pad, L.out_pad, plan.lat_pad, cur, lat, nxt,
                   ws, xyz, tid);
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

static size_t smem_bytes(int max_pad, int lat_pad, int n_rows) {
  return sizeof(float) * ((size_t)(2 * max_pad + lat_pad) * TILE_P + BK * OCHUNK + 3 * TILE_P
                          + (size_t)n_rows * TILE_P + 17 * TILE_P);
}

// desc: [n_trunks, fin_b, max_pad, c, lat_pad, hf, wf, n_rows, then per trunk:
// n_hidden, fin, fin_xyz, last_pad, then per hidden layer: w, x, lat, b,
// in_pad, out_pad].  table: (hf*wf + 1, c), the map's pixels row-major with
// channels contiguous, then its mean.  scal: origin (3), voxel, then the 28
// projection scalars.  Returns 0, a cudaError_t from the launch, or -1 for a
// descriptor this kernel rejects.
extern "C" int pixel_grid_decoder_launch(const float* prm, const int* desc, int desc_len,
                                         const float* table, const float* scal,
                                         long long base, int m, int n, float* out,
                                         void* stream) {
  Plan plan;
  int pos = 0;
#define TAKE(v) do { if (pos >= desc_len) return -1; (v) = desc[pos++]; } while (0)
  TAKE(plan.n_trunks);
  TAKE(plan.fin_b);
  TAKE(plan.max_pad);
  TAKE(plan.c);
  TAKE(plan.lat_pad);
  TAKE(plan.hf);
  TAKE(plan.wf);
  TAKE(plan.n_rows);
  if (plan.n_rows < SDF_ROWS || plan.n_rows > MAX_ROWS) return -1;
  if (plan.n_trunks < 1 || plan.n_trunks > MAX_TRUNKS) return -1;
  if (plan.max_pad < OCHUNK || plan.max_pad % OCHUNK) return -1;
  if (plan.c < 1 || plan.lat_pad < plan.c || plan.lat_pad % BK) return -1;
  if (plan.hf < 1 || plan.wf < 1) return -1;
  for (int t = 0; t < plan.n_trunks; ++t) {
    Trunk& T = plan.trunks[t];
    TAKE(T.n_hidden);
    TAKE(T.fin);
    TAKE(T.fin_xyz);
    TAKE(T.last_pad);
    if (T.n_hidden < 1 || T.n_hidden > MAX_HIDDEN) return -1;
    for (int l = 0; l < T.n_hidden; ++l) {
      Layer& L = T.layers[l];
      TAKE(L.w); TAKE(L.x); TAKE(L.lat); TAKE(L.b); TAKE(L.in_pad); TAKE(L.out_pad);
      if (L.out_pad % OCHUNK || L.out_pad > plan.max_pad || L.in_pad % BK ||
          L.in_pad > plan.max_pad) return -1;
      // weight tiles load as float4
      if ((L.w >= 0 && (L.w & 3)) || (L.lat >= 0 && (L.lat & 3))) return -1;
    }
    // layer 0 reads only the latent and xyz: its embedding input is folded
    if (T.layers[0].w >= 0) return -1;
    if (T.last_pad != T.layers[T.n_hidden - 1].out_pad) return -1;
  }
#undef TAKE
  if (pos != desc_len || m <= 0 || n <= 0) return -1;

  const size_t smem = smem_bytes(plan.max_pad, plan.lat_pad, plan.n_rows);
  cudaError_t err = cudaFuncSetAttribute(pixel_grid_decoder_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((m + TILE_P - 1) / TILE_P);
  pixel_grid_decoder_kernel<<<blocks, NTHREADS, smem, (cudaStream_t)stream>>>(
      prm, plan, table, scal, base, m, n, out);
  return (int)cudaGetLastError();
}
