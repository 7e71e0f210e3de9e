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
// without tanh (a_h = the hand trunk's last hidden activation).  n_rows is a
// field of the plan, 2 to 128: it covers both TPU kernels, the lanes-major
// one (<= 6 classes) and the points-major make_fused_grid_kernel
// (decoder_kernel.py:381, <= 126 classes), with one layout.
//
// What bounds it: arithmetic.  The flagship trunk (hidden 512 -> 250 -> 512 ->
// 512 -> 1) costs 512*250 + 250*512 + 512*512 + 512 ~= 0.52 M MAC per point,
// so both trunks are ~2.07 MFLOP per point (4.38 TFLOP a 128^3 pass) against
// 8 bytes of output per point.  At float32 accuracy the tensor cores need
// three TF32 products a multiply-add (split TF32): 3 x 4.38 TFLOP over the
// card's 495 TFLOP/s dense TF32 is 26.5 ms a pass; the CUDA cores' float32
// rate (67 TFLOP/s) would need 65.3.  Every block also streams both trunks'
// weights from L2, split into TF32 halves (~8.4 MB per 64 points).  The
// design runs at about twice the split-TF32 bound: the per-k-step chain
// around the products and the epilogues hold it (grid_trunk_tc.cuh).
//
// Design: the tensor-core trunk of grid_trunk_tc.cuh (split TF32 on wgmma,
// 64 points a block, one in-place activation buffer, weight tiles streamed
// by bulk copy through an mbarrier ring; see its note for the shared-memory
// and register budget).  Layer 0 has no product: its input is folded, so it
// is the epilogue alone.  The class rows are extra final rows of the hand
// trunk: 6 classes add 6 x 512 multiply-adds to ~1 M a point.
//
// bf16 (a plan packed with dtype bfloat16; decoder_kernel.py:331, :375,
// :626 with dtype=bfloat16): its own design for Hopper, grid_bf16_kernel on
// grid_trunk_bf16_tc.cuh's body, which K6's bf16 kernel shares (128 points a
// block sharing each weight tile, bf16
// activations read by wgmma from shared memory, a producer feeding a
// multicast ring; the two warpgroups run their epilogues as they come, with
// no order between them: see that header's note (e) for the ping-pong order
// measured and left out), on the plan's own bf16 layout (kernels/grid_decoder.py:
// pack_grid_plan_bf16).  Its bound is one product a multiply-add at the
// card's 989.4 TFLOP/s dense bf16: 4.42 ms a 128^3 pass at the flagship, a
// sixth of split TF32's.

#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_trunk_bf16_tc.cuh"
#include "grid_trunk_tc.cuh"

// K1 on a bf16 plan: gb_body without input rows (grid_trunk_bf16_tc.cuh).
__global__ void __launch_bounds__(GB_THREADS, 1)
grid_bf16_kernel(const float* __restrict__ prm, const __grid_constant__ GbPlan p,
                 const float* __restrict__ scal, float* __restrict__ out,
                 uint8_t* __restrict__ scratch) {
  const GbRows none = {};
  gb_body<false>(prm, p, scal, none, out, scratch);
}

// grid_bf16_kernel over indices base .. base + m - 1 of the n^3 grid (see
// gb_launch; `plan`: its launch plan, nothing launched).
static int launch_grid_bf16(const float* prm, const int* desc, int desc_len, const float* scal,
                            long long base, int m, int n, float* out, uint8_t* scratch,
                            long long scratch_bytes, cudaStream_t stream, int* plan = nullptr) {
  GbPlan p;
  if (!gb_take_plan(p, desc, desc_len, false)) return -1;
  if (m <= 0 || n <= 0 || base < 0 || (long long)n * n * n >= (1LL << 31)
      || base + m > (long long)n * n * n)
    return -1;
  p.n = n;
  p.base = (int)base;
  void* args[] = {(void*)&prm, &p, (void*)&scal, &out, &scratch};
  static int fits = 0;  // clusters the card runs at once
  return gb_launch((const void*)grid_bf16_kernel, fits, p, m, args, scratch, scratch_bytes,
                   stream, plan);
}

template <class Cfg>
__global__ void __launch_bounds__(TC_THREADS, 1)
grid_decoder_kernel(const float* __restrict__ prm, const TcPlan plan,
                    const float* __restrict__ scal, long long base, int m, int n,
                    float* __restrict__ out) {
  extern __shared__ __align__(128) float smem[];
  const TcShared s = tc_shared<Cfg>(smem, plan.rows);
  const int tid = threadIdx.x;
  const long long first = (long long)blockIdx.x * TC_P;
  if (tid == 0) tc_init<Cfg>(prm, plan, s);
  if (tid < TC_P) {
    // the same index arithmetic as the TPU kernel: integer // and %, then
    // * voxel + origin (decoder_kernel.py:633-638)
    const long long idx = base + first + tid;
    const long long nsq = (long long)n * n;
    const float voxel = scal[3];
    s.xyz[tid] = (float)((idx / nsq) % n) * voxel + scal[0];
    s.xyz[TC_P + tid] = (float)((idx / n) % n) * voxel + scal[1];
    s.xyz[2 * TC_P + tid] = (float)(idx % n) * voxel + scal[2];
  }
  if (tid < TC_SDF_ROWS * TC_P) s.oacc[tid] = 0.f;
  __syncthreads();
  tc_consume<Cfg>(prm, plan, s, TcNoFill(), out, first, m, tid);
}

template <class Cfg>
static int grid_decoder_run(const float* prm, const TcPlan& plan, const float* scal,
                            long long base, int m, int n, float* out, cudaStream_t stream) {
  const size_t smem = tc_smem_bytes<Cfg>(plan.rows);
  cudaError_t err = cudaFuncSetAttribute(grid_decoder_kernel<Cfg>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((m + TC_P - 1) / TC_P);
  grid_decoder_kernel<Cfg><<<blocks, TC_THREADS, smem, stream>>>(prm, plan, scal, base, m, n,
                                                                  out);
  return (int)cudaGetLastError();
}

// desc: [n_trunks, fin_b, rows, n_rows, then per trunk: n_hidden, fin,
// fin_xyz, last_pad, then per hidden layer: w, x, b, in_pad, out_pad]
// (offsets in floats, -1 = absent; float32: w = the layer's weight tiles,
// see grid_trunk_tc.cuh; bf16: the bf16 plan's stream, see
// grid_trunk_bf16_tc.cuh's gb_take_plan; its scratch: GB_SCRATCH bytes a
// warpgroup of the grid, unused in float32).  Returns 0, a cudaError_t from
// the launch, or -1 for a descriptor this kernel rejects (bf16: also
// WB_ERR_CLUSTER).
extern "C" int grid_decoder_launch(const float* prm, const int* desc, int desc_len,
                                   const float* scal, long long base, int m, int n,
                                   float* out, int bf16, void* scratch, long long scratch_bytes,
                                   void* stream) {
  if (bf16)
    return launch_grid_bf16(prm, desc, desc_len, scal, base, m, n, out, (uint8_t*)scratch,
                            scratch_bytes, (cudaStream_t)stream);
  if (desc_len < 4) return -1;
  TcPlan plan;
  plan.n_trunks = desc[0];
  plan.fin_b = desc[1];
  plan.rows = desc[2];
  plan.n_rows = desc[3];
  plan.lat_pad = 0;
  if (m <= 0 || n <= 0) return -1;
  if (!tc_take_plan(plan, desc, desc_len, 4, false, 0)) return -1;
  return grid_decoder_run<TcF32>(prm, plan, scal, base, m, n, out, (cudaStream_t)stream);
}

// The bf16 kernel's launch plan for a run of m points (GB_PLAN_INTS into
// plan, see launch_grid_bf16); launches nothing.
extern "C" int grid_decoder_bf16_plan(const int* desc, int desc_len, long long base, int m, int n,
                                      int* plan) {
  return launch_grid_bf16(nullptr, desc, desc_len, nullptr, base, m, n, nullptr, nullptr, 0, 0,
                          plan);
}
