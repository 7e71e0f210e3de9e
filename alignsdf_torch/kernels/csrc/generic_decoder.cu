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
// them.  A latent_in final layer adds x0 @ W_in to the SDF rows (the class
// rows read no x0).  With 0 in latent_in the plan has summed both halves of
// layer 0's weight (they multiply the same row), so the kernel runs one
// product there.
//
// What bounds it: arithmetic.  At the --point_size 63 flagship width (NeRF
// PE, rows of 256 + 63 = 319, hidden 512 -> 193 -> [193 + 319] -> 512 ->
// 512 -> 1) a trunk costs 786,944 multiply-adds per point against 1.3 KB of
// input row: 6.60 TFLOP a 128^3 pass for both trunks.  At float32 accuracy
// on the tensor cores (split TF32, three TF32 products a multiply-add) that
// is 40.0 ms at the card's 495 TFLOP/s dense TF32; 98.5 ms at the CUDA
// cores' 67 TFLOP/s float32.
//
// Design: the tensor-core trunk of grid_trunk_tc.cuh (split TF32 on wgmma,
// 64 points a block, one in-place activation buffer, weight tiles streamed
// through an mbarrier ring), as K1 and K3 run it.  x0 takes the place of
// K3's sampled latent: the plan packs layer 0 as input-row tiles alone and
// a latent_in layer as [W_x; W_in] tiles, and before either layer X0Fill
// copies the trunk's x0 columns into the activation rows above the layer's
// activation input.  Layer 2 of the flagship reads 256 activation rows
// (193 padded) and 320 x0 rows, which a 544-row buffer cannot hold beside
// the ring, so the trunk stages x0 in two chunks (288 + 32 rows); a wider
// row takes more chunks, so there is no limit on its width.  A latent_in
// final layer (fin_lat) restages x0 over the dead activation rows after the
// final rows and adds its SDF rows.  Each trunk reads its own x0 (the
// twin trunks' column slices of the row, or the combined trunk's row), at
// its own width and row stride; the plan pads the input-row weights to
// lat_pad (a multiple of 8) and the fill writes zeros past a trunk's width.
//
// bf16 (a plan packed with dtype bfloat16; decoder_kernel.py:59-137, :196-199
// with dtype=bfloat16): its own kernel, generic_bf16_kernel on
// grid_trunk_bf16_tc.cuh's body, K1's bf16 design with the input rows as k
// steps of their own (see that header's note (c)), on the plan's own layout
// (kernels/generic_decoder.py:pack_generic_plan_bf16: widths padded to 16,
// lat_pad a multiple of 16, each trunk one stream of the kernel's items).
// The rows enter as bf16 (the wrapper refuses float32 rows on a bf16 plan,
// as JAX's run casts them).  6.60 TFLOP a 128^3 pass at 989.4 TFLOP/s dense
// bf16: 6.67 ms.

#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_trunk_bf16_tc.cuh"
#include "grid_trunk_tc.cuh"

// K6 on a bf16 plan: gb_body with input rows.
__global__ void __launch_bounds__(GB_THREADS, 1)
generic_bf16_kernel(const float* __restrict__ prm, const __grid_constant__ GbPlan p,
                    const __grid_constant__ GbRows x, float* __restrict__ out,
                    uint8_t* __restrict__ scratch) {
  gb_body<true>(prm, p, nullptr, x, out, scratch);
}

// generic_bf16_kernel over m rows (see gb_launch); with `plan` its launch
// plan, nothing launched and the rows unread.  The rows: per trunk (x_o =
// x_h for one trunk) 1 .. lat_pad columns, row stride ld >= the width.
static int launch_generic_bf16(const float* prm, const int* desc, int desc_len, const GbRows& rows,
                               int m, float* out, uint8_t* scratch, long long scratch_bytes,
                               cudaStream_t stream, int* plan = nullptr) {
  GbPlan p;
  if (!gb_take_plan(p, desc, desc_len, true)) return -1;
  for (int t = 0; !plan && t < p.n_trunks; ++t)
    if (!rows.x[t] || rows.in[t] < 1 || rows.in[t] > p.lat_pad || rows.ld[t] < rows.in[t])
      return -1;
  p.n = p.base = 0;
  GbRows x = rows;
  void* args[] = {(void*)&prm, &p, &x, &out, &scratch};
  static int fits = 0;  // clusters the card runs at once
  return gb_launch((const void*)generic_bf16_kernel, fits, p, m, args, scratch, scratch_bytes,
                   stream, plan);
}

// row-major, row stride ld; float32 rows
struct X0Rows { const void* x; long long ld; int in; };

__device__ __forceinline__ float x0_value(const float* src, long long i) { return __ldg(src + i); }

// Trunk t's x0 columns c0 .. c0 + count - 1 of the block's 64 rows into
// activation rows row0 on; zeros past the trunk's width and past row m.  A
// warp stores 8 points x 4 columns an instruction, which tc_swz spreads over
// the 32 banks; from device memory that is 8 rows x 16 bytes, whose
// sectors' other halves the warp reads next.
template <class T>
struct X0Fill {
  static constexpr bool kChunks = true;
  X0Rows xh, xo;
  float* act;
  long long first;
  int m;

  __device__ void operator()(int t, int row0, int c0, int count, int tid) const {
    const X0Rows r = t == 0 ? xh : xo;
    const int lane = tid & 31;
    const int p = (tid >> 5) % (TC_P / 8) * 8 + (lane >> 2);  // warps cover the 64 points
    const int k_first = (tid >> 5) / (TC_P / 8) * 4 + (lane & 3);
    const int k_stride = (TC_THREADS / 32) / (TC_P / 8) * 4;
    const long long row = first + p;
    const T* src = static_cast<const T*>(r.x) + (row < m ? row : 0) * r.ld;
    const int width = row < m ? min(r.in - c0, count) : 0;  // columns this row holds
#pragma unroll 4
    for (int k = k_first; k < count; k += k_stride)
      act[tc_swz(row0 + k, p)] = k < width ? x0_value(src, c0 + k) : 0.f;
  }
};

template <class Cfg, class T>
__global__ void __launch_bounds__(TC_THREADS, 1)
generic_decoder_kernel(const float* __restrict__ prm, const TcPlan plan, const X0Rows xh,
                       const X0Rows xo, int m, float* __restrict__ out) {
  extern __shared__ __align__(128) float smem[];
  const TcShared s = tc_shared<Cfg>(smem, plan.rows);
  const int tid = threadIdx.x;
  const long long first = (long long)blockIdx.x * TC_P;
  if (tid == 0) tc_init<Cfg>(prm, plan, s);
  if (tid < 3 * TC_P) s.xyz[tid] = 0.f;  // read by no term: K6's plans have no xyz weights
  if (tid < TC_SDF_ROWS * TC_P) s.oacc[tid] = 0.f;
  __syncthreads();
  const X0Fill<T> fill{xh, xo, s.act, first, m};
  tc_consume<Cfg>(prm, plan, s, fill, out, first, m, tid);
}

template <class Cfg, class T>
static int generic_decoder_run(const float* prm, const TcPlan& plan, const X0Rows& rh,
                               const X0Rows& ro, int m, float* out, cudaStream_t stream) {
  const size_t smem = tc_smem_bytes<Cfg>(plan.rows);
  cudaError_t err = cudaFuncSetAttribute(generic_decoder_kernel<Cfg, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((m + TC_P - 1) / TC_P);
  generic_decoder_kernel<Cfg, T><<<blocks, TC_THREADS, smem, stream>>>(prm, plan, rh, ro, m,
                                                                        out);
  return (int)cudaGetLastError();
}

// desc: [n_trunks, fin_b, rows, n_rows, lat_pad, then per trunk: n_hidden,
// fin, fin_x, last_pad, then per hidden layer: w, x, lat, b, in_pad,
// out_pad] (offsets in floats, -1 = absent; x is always -1).  float32: w and
// lat = the weight tiles of the layer's activation and input rows, see
// grid_trunk_tc.cuh; fin_x = the final layer's (n_rows, lat_pad) input-row
// weights, or -1; the rows float.  bf16: the bf16 plan's streams, see
// grid_trunk_bf16_tc.cuh's gb_take_plan; the rows __nv_bfloat16; its
// scratch: GB_SCRATCH bytes a warpgroup of the grid, unused in float32.
// Returns 0, a cudaError_t from the launch, or -1 for a descriptor or input
// this kernel rejects (bf16: also WB_ERR_CLUSTER).
extern "C" int generic_decoder_launch(const float* prm, const int* desc, int desc_len,
                                      const void* x_h, long long ld_h, int in_h,
                                      const void* x_o, long long ld_o, int in_o, int m,
                                      float* out, int bf16, void* scratch,
                                      long long scratch_bytes, void* stream) {
  if (desc_len < 5 || m <= 0) return -1;
  const cudaStream_t st = (cudaStream_t)stream;
  if (bf16) {
    GbRows rows = {};
    rows.x[0] = static_cast<const __nv_bfloat16*>(x_h);
    rows.x[1] = static_cast<const __nv_bfloat16*>(desc[0] == 2 ? x_o : x_h);
    rows.ld[0] = ld_h;
    rows.ld[1] = desc[0] == 2 ? ld_o : ld_h;
    rows.in[0] = in_h;
    rows.in[1] = desc[0] == 2 ? in_o : in_h;
    return launch_generic_bf16(prm, desc, desc_len, rows, m, out, (uint8_t*)scratch,
                               scratch_bytes, st);
  }
  TcPlan plan;
  plan.n_trunks = desc[0];
  plan.fin_b = desc[1];
  plan.rows = desc[2];
  plan.n_rows = desc[3];
  plan.lat_pad = desc[4];
  if (plan.lat_pad < TC_K) return -1;
  if (!tc_take_plan(plan, desc, desc_len, 5, true, 0, true)) return -1;
  for (int t = 0; t < plan.n_trunks; ++t) {
    TcTrunk& T = plan.trunks[t];
    // the trunk header's xyz slot holds the final layer's input-row weights
    T.fin_lat = T.fin_xyz;
    T.fin_xyz = -1;
    if (T.fin_lat >= 0 && (T.fin_lat & 3)) return -1;  // loaded as float4
    if (T.layers[0].lat < 0) return -1;                // layer 0 reads x0
    for (int l = 0; l < T.n_hidden; ++l)
      if (T.layers[l].x >= 0) return -1;
  }
  if (!x_h || in_h < 1 || in_h > plan.lat_pad || ld_h < in_h) return -1;
  if (plan.n_trunks == 2 && (!x_o || in_o < 1 || in_o > plan.lat_pad || ld_o < in_o)) return -1;

  const X0Rows rh = {x_h, ld_h, in_h};
  const X0Rows ro = plan.n_trunks == 2 ? X0Rows{x_o, ld_o, in_o} : rh;
  return generic_decoder_run<TcF32, float>(prm, plan, rh, ro, m, out, st);
}

// The bf16 kernel's launch plan for a run of m rows (GB_PLAN_INTS into
// plan, see gb_launch); launches nothing.
extern "C" int generic_decoder_bf16_plan(const int* desc, int desc_len, int m, int* plan) {
  const GbRows none = {};
  return launch_generic_bf16(nullptr, desc, desc_len, none, m, nullptr, nullptr, 0, 0, plan);
}
