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
// point, 3.12 MFLOP per point for both trunks, 6.55 TFLOP per 128^3 pass.
// At float32 accuracy on the tensor cores (split TF32: three TF32 products a
// multiply-add) that is ~40 ms at the card's 495 TFLOP/s dense TF32; ~98 ms
// at the CUDA cores' 67 TFLOP/s float32.  The gather is 16 taps x C channels
// (8 kFLOP per point) read from a 4.2 MB table that stays in L2.  The design
// runs at about 2.3x the split-TF32 bound: K1's chain around the products
// and epilogues (grid_trunk_tc.cuh), and the gathers, during which the
// tensor cores idle.
//
// Design: K1's tensor-core trunk (grid_trunk_tc.cuh: split TF32 on wgmma, 64
// points a block, one in-place activation buffer of `rows` x 64 floats,
// weight tiles streamed through an mbarrier ring).  The latent has no tile
// of its own: before layer 0 and before each latent_in layer the block
// gathers it into the activation rows just above the layer's activation input
// (rows 0 .. C-1 for layer 0; rows in_pad .. in_pad + C - 1 for a latent_in
// layer, whose input, the previous layer's output, is only in_pad = 256 of
// the buffer's 512 rows wide at the flagship), and the layer runs one product
// of depth in_pad + lat_pad over [activation; latent] against the packed
// [W; W_lat] tiles.  That costs a second gather per trunk (four a block) and
// keeps the 64 KB a resident latent tile would take for the weight ring.
// The tap table (4 row offsets, 4 columns, 8 weights and a flag a point)
// is built once a block.  The gather runs one thread a channel, so the 32
// lanes of a warp read 128 contiguous bytes of a tap's row.
//
// The projection runs one rounding per operation (no FMA contraction) in
// the plain version's order, so that the kernel and
// pixel_grid_decode_reference agree bit for bit on which points lie in the
// image.
//
// bf16 (a plan packed with dtype bfloat16; decoder_kernel.py:997-998,
// :1091-1122 with dtype=bfloat16): the trunk's bf16 k step (TcBf16); the
// table holds the bf16-rounded map and mean row (float32 words); each tap
// weight ky kx is formed in float32 and rounded to bf16, the 16 products
// with the table are exact and summed in float32, and the sampled latent
// is rounded to bf16 before the trunks.  The mean fallback copies the
// rounded mean row, exactly as JAX's 0/1 selector does.

#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_trunk_tc.cuh"
#include "keys_cubic.cuh"

struct PixelMap { int c, hf, wf; };

// a*x + b*y + c*z, one rounding per operation, left to right.
__device__ __forceinline__ float dot3(float a, float x, float b, float y, float c, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y)), __fmul_rn(c, z));
}

// Latent channels c0 .. c0 + count - 1 into activation rows row0 on: the
// sum of a point's 16 weighted taps, or the mean row outside the image; 0 in
// the padding channels.  Both trunks read the same latent.
template <bool kBf16>
struct LatentFill {
  static constexpr bool kChunks = false;  // the plan's rows hold [activation; latent]
  const float* table;
  const float* tap_w;  // [TC_P][8]: 4 row, then 4 column weights
  const int* tap_rc;   // [TC_P][8]: rows * wf, columns; -1 = off the map
  const int* inside;   // [TC_P]
  float* act;
  PixelMap map;

  __device__ void operator()(int, int row0, int c0, int count, int tid) const {
    const float* mean = table + (size_t)map.hf * map.wf * map.c;
    for (int k = tid; k < count; k += TC_THREADS) {
      const int row = row0 + k, ch = c0 + k;
      for (int p0 = 0; p0 < TC_P; p0 += 4) {
        float v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int p = p0 + q;
          float s = 0.f;
          if (ch >= map.c) {
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
                float w = wy * tap_w[p * 8 + 4 + j];
                if (kBf16) w = tc_round_bf16(w);
                s = fmaf(w, __ldg(table + (size_t)(r + col) * map.c + ch), s);
              }
            }
            if (kBf16) s = tc_round_bf16(s);
          }
          v[q] = s;
        }
        // tc_swz keeps an aligned run of 4 points contiguous
        *reinterpret_cast<float4*>(act + tc_swz(row, p0)) = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  }
};

// The per-point tap table beside the trunk's shared memory: 4 row offsets,
// 4 columns, 8 weights and a flag a point.
#define TAP_BYTES (17 * sizeof(float) * TC_P)

template <class Cfg>
__global__ void __launch_bounds__(TC_THREADS, 1)
pixel_grid_decoder_kernel(const float* __restrict__ prm, const TcPlan plan, const PixelMap map,
                          const float* __restrict__ table, const float* __restrict__ scal,
                          long long base, int m, int n, float* __restrict__ out) {
  extern __shared__ __align__(128) float smem[];
  const TcShared s = tc_shared<Cfg>(smem, plan.rows);
  float* tap_w = reinterpret_cast<float*>(s.full + Cfg::kSlots);  // [TC_P][8]
  int* tap_rc = reinterpret_cast<int*>(tap_w + 8 * TC_P);        // [TC_P][8]
  int* inside = tap_rc + 8 * TC_P;                                // [TC_P]

  const int tid = threadIdx.x;
  const long long first = (long long)blockIdx.x * TC_P;
  const int hf = map.hf, wf = map.wf;
  if (tid == 0) tc_init<Cfg>(prm, plan, s);
  if (tid < TC_P) {
    // the same index arithmetic as the TPU kernel (integer // and %), then
    // xyz = ijk * voxel + origin and the projection (decoder_kernel.py:1053-1080)
    const long long idx = base + first + tid;
    const long long nsq = (long long)n * n;
    const float voxel = scal[3];
    const float x = __fadd_rn(__fmul_rn((float)((idx / nsq) % n), voxel), scal[0]);
    const float y = __fadd_rn(__fmul_rn((float)((idx / n) % n), voxel), scal[1]);
    const float z = __fadd_rn(__fmul_rn((float)(idx % n), voxel), scal[2]);
    s.xyz[tid] = x;
    s.xyz[TC_P + tid] = y;
    s.xyz[2 * TC_P + tid] = z;
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
  if (tid < TC_SDF_ROWS * TC_P) s.oacc[tid] = 0.f;
  __syncthreads();
  const LatentFill<Cfg::kBf16> fill{table, tap_w, tap_rc, inside, s.act, map};
  tc_consume<Cfg>(prm, plan, s, fill, out, first, m, tid);
}

template <class Cfg>
static int pixel_grid_decoder_run(const float* prm, const TcPlan& plan, const PixelMap& map,
                                  const float* table, const float* scal, long long base, int m,
                                  int n, float* out, cudaStream_t stream) {
  const size_t smem = tc_smem_bytes<Cfg>(plan.rows) + TAP_BYTES;
  cudaError_t err = cudaFuncSetAttribute(pixel_grid_decoder_kernel<Cfg>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((m + TC_P - 1) / TC_P);
  pixel_grid_decoder_kernel<Cfg><<<blocks, TC_THREADS, smem, stream>>>(prm, plan, map, table,
                                                                        scal, base, m, n, out);
  return (int)cudaGetLastError();
}

// desc: [n_trunks, fin_b, rows, c, lat_pad, hf, wf, n_rows, fin_lat of
// trunk 0 and of trunk 1, then per trunk: n_hidden, fin, fin_xyz, last_pad,
// then per hidden layer: w, x, lat, b, in_pad, out_pad] (offsets in floats,
// -1 = absent; w and lat = the weight tiles of the layer's activation and
// latent rows, see grid_trunk_tc.cuh; fin_lat = a latent_in final layer's
// (n_rows, lat_pad) latent weights, whose SDF rows read the latent gathered
// a third time over the dead activation rows, as JAX's K3 reads `flat`).
// table: (hf*wf + 1, c), the map's pixels row-major with channels
// contiguous, then its mean.  scal: origin (3), voxel, then the 28
// projection scalars.  bf16: the plan's tiles are bf16 (TcBf16) and the table
// bf16-rounded.  Returns 0, a cudaError_t from the launch, or -1 for a
// descriptor this kernel rejects.
extern "C" int pixel_grid_decoder_launch(const float* prm, const int* desc, int desc_len,
                                         const float* table, const float* scal,
                                         long long base, int m, int n, float* out, int bf16,
                                         void* stream) {
  if (desc_len < 10) return -1;
  TcPlan plan;
  PixelMap map;
  plan.n_trunks = desc[0];
  plan.fin_b = desc[1];
  plan.rows = desc[2];
  map.c = desc[3];
  plan.lat_pad = desc[4];
  map.hf = desc[5];
  map.wf = desc[6];
  plan.n_rows = desc[7];
  if (map.c < 1 || plan.lat_pad < map.c || map.hf < 1 || map.wf < 1) return -1;
  if (m <= 0 || n <= 0) return -1;
  const cudaStream_t st = (cudaStream_t)stream;
  if (bf16 ? !tc_take_plan<TcBf16>(plan, desc, desc_len, 10, true, TAP_BYTES)
           : !tc_take_plan(plan, desc, desc_len, 10, true, TAP_BYTES))
    return -1;
  for (int t = 0; t < plan.n_trunks; ++t) {
    // a latent_in final layer's (n_rows, lat_pad) latent weights, or -1
    TcTrunk& T = plan.trunks[t];
    T.fin_lat = desc[8 + t];
    if (T.fin_lat >= 0 && (T.fin_lat & 3)) return -1;  // loaded as float4
  }
  if (bf16) return pixel_grid_decoder_run<TcBf16>(prm, plan, map, table, scal, base, m, n, out, st);
  return pixel_grid_decoder_run<TcF32>(prm, plan, map, table, scal, base, m, n, out, st);
}
