// The train backwards' weight-gradient reduction on its own: C (K, N) += A
// (K, m) . B (N, m)^T, as K2's, K4's and K5's backwards launch it inside
// their calls (float32 operands in split TF32, wgrad_tc.cuh; their bf16
// backwards' bf16 operands, wgrad_bf16_tc.cuh).  For the tests on the card
// and for timing the reduction apart from the chains around it.

#include <cuda_runtime.h>

#include "wgrad_tc.cuh"

// A, B feature-major with row stride m, float32 or (bf16 != 0) bf16; C (K,
// N) float32 row-major, holding zeros or a sum to add to.  bf16 with
// overlap != 0: launched as a backward launches every reduction after its
// first (launch_wgrad_bf16: A and B complete before the kernel before this
// one on the stream began).  Returns 0 or a cudaError_t from the launch
// (bf16: -1 for m % 4 != 0 or operands not 8-byte aligned, or a WB_ERR_*
// code of wgrad_bf16_tc.cuh).
extern "C" int weight_grad_launch(const void* A, const void* B, float* C, int K, int N, int m,
                                  int bf16, int overlap, void* stream) {
  if (bf16)
    return launch_wgrad((const __nv_bfloat16*)A, (const __nv_bfloat16*)B, C, K, N, m,
                        (cudaStream_t)stream, overlap != 0);
  return launch_wgrad((const float*)A, (const float*)B, C, K, N, m, (cudaStream_t)stream);
}

// The bf16 launcher's plan for a (K, N) call over m points on aligned
// operands, into plan[WB_PLAN_INTS] (wb_launch's order); launches nothing.
extern "C" int weight_grad_bf16_plan(int K, int N, int m, int* plan) {
  const __nv_bfloat16* aligned = reinterpret_cast<const __nv_bfloat16*>(256);
  return launch_wgrad_bf16(aligned, aligned, reinterpret_cast<float*>(256), K, N, m, 0, false,
                           plan);
}
