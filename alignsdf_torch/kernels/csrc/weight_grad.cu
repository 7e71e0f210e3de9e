// The train backwards' weight-gradient reduction (wgrad_tc.cuh) on its own:
// C (K, N) += A (K, m) . B (N, m)^T, as K2's, K4's and K5's backwards launch
// it inside their calls.  For the tests on the card and for timing the
// reduction apart from the chains around it.

#include <cuda_runtime.h>

#include "wgrad_tc.cuh"

// A, B feature-major with row stride m; C (K, N) row-major, holding zeros
// or a sum to add to.  Returns 0 or a cudaError_t from the launch.
extern "C" int weight_grad_launch(const float* A, const float* B, float* C, int K, int N, int m,
                                  void* stream) {
  return launch_wgrad(A, B, C, K, N, m, (cudaStream_t)stream);
}
