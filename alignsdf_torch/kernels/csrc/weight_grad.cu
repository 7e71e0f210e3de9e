// The train backwards' weight-gradient reduction (wgrad_tc.cuh) on its own:
// C (K, N) += A (K, m) . B (N, m)^T, as K2's, K4's and K5's backwards launch
// it inside their calls (float32 operands in split TF32; K2's bf16 backward
// on bf16 operands).  For the tests on the card and for timing the
// reduction apart from the chains around it.

#include <cuda_runtime.h>

#include "wgrad_tc.cuh"

// A, B feature-major with row stride m, float32 or (bf16 != 0) bf16; C (K,
// N) float32 row-major, holding zeros or a sum to add to.  Returns 0 or a
// cudaError_t from the launch (-1: a bf16 m that is not a multiple of 4).
extern "C" int weight_grad_launch(const void* A, const void* B, float* C, int K, int N, int m,
                                  int bf16, void* stream) {
  if (bf16)
    return launch_wgrad((const __nv_bfloat16*)A, (const __nv_bfloat16*)B, C, K, N, m,
                        (cudaStream_t)stream);
  return launch_wgrad((const float*)A, (const float*)B, C, K, N, m, (cudaStream_t)stream);
}
