// Kernel K7: the ResNet stem's 3x3 / stride 2 / pad 1 max pool, forward and
// backward, float32 (N, C, H, W) tensors, NCHW-contiguous or channels last.
//
// Replaces alignsdf_tpu/ops/maxpool.py: the pass kernels _run_pass (body
// _fwd_pass_kernel) and _run_bwd_pass (body _bwd_pass_kernel) behind
// maxpool_k3s2p1.  The TPU computes the pool separably, an H pass then a W
// pass, in layouts where every stride-2 selection is a leading-dim pair
// reshape; none of that blocking carries over.  What does carry over is the
// arithmetic, tie routing included:
//
//   y1[oh, w] = max_{r in {2oh-1, 2oh, 2oh+1}} x[r, w]       (H pass)
//   y[oh, ow] = max_{c in {2ow-1, 2ow, 2ow+1}} y1[oh, c]      (W pass)
//   dx[h, w]  = sum_{oh covers h} [x[h, w] == y1[oh, w]]
//                 * sum_{ow covers w} [y1[oh, w] == y[oh, ow]] * dy[oh, ow]
//
// Rows and columns outside the image take no part.  The backward routes dy to
// EVERY tied position of a window, per axis (the TPU kernel's two backward
// passes composed), not to the first maximum as PyTorch's and XLA's
// select-and-scatter do.  Each sum has at most two nonzero terms, so the
// order of the additions does not change a bit.
//
// Bound on the card: bytes.  The forward reads x once and writes y; the
// backward reads x, y and dy and writes dx; 9 and ~12 flops an element are
// far below the H100's rate.  Design: one thread per output (forward) or per
// input element (backward, a gather: no atomics), threads in memory order
// (neighbours on neighbouring columns, or channels in channels last), so
// loads and stores coalesce; the rows a thread reads are shared with its
// neighbours through L1.  The backward recomputes y1 from x (three loads a
// covering row, cached) instead of storing it: storing would add a write of
// half of x in the forward and a read in the backward.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// A layout's addressing of one (n, ch) plane of rows x cols: element (r, col)
// sits at base + r * row + col * col_step.  NCHW-contiguous: base = (n * c +
// ch) * rows * cols, row = cols, col_step = 1.  Channels last (NHWC memory,
// what cuDNN's convolutions give an NHWC image permuted to NCHW, as the
// encoder does): base = n * rows * cols * c + ch, row = cols * c,
// col_step = c.
template <bool kChannelsLast>
struct Plane {
  int64_t base, row, col_step;
  __device__ __forceinline__ Plane(int n, int ch, int c, int rows, int cols) {
    if (kChannelsLast) {
      base = (int64_t)n * rows * cols * c + ch;
      row = (int64_t)cols * c;
      col_step = c;
    } else {
      base = ((int64_t)n * c + ch) * rows * cols;
      row = cols;
      col_step = 1;
    }
  }
  __device__ __forceinline__ int64_t at(int r, int col) const {
    return base + r * row + col * col_step;
  }
};

// Element i in memory order: (n, ch, r, col) of a rows x cols tensor.  The
// index is 32-bit (the entry points refuse larger tensors): 64-bit division
// costs several times as many instructions, and the kernels are short.
template <bool kChannelsLast>
__device__ __forceinline__ void unravel(uint32_t i, int c, int rows, int cols, int* n, int* ch,
                                        int* r, int* col) {
  uint32_t t = i;
  if (kChannelsLast) {
    *ch = (int)(t % (uint32_t)c), t /= (uint32_t)c;
    *col = (int)(t % (uint32_t)cols), t /= (uint32_t)cols;
    *r = (int)(t % (uint32_t)rows), t /= (uint32_t)rows;
  } else {
    *col = (int)(t % (uint32_t)cols), t /= (uint32_t)cols;
    *r = (int)(t % (uint32_t)rows), t /= (uint32_t)rows;
    *ch = (int)(t % (uint32_t)c), t /= (uint32_t)c;
  }
  *n = (int)t;
}

// y1 at output row oh and input column col of one plane of x
template <bool kChannelsLast>
__device__ __forceinline__ float row_pool(const float* __restrict__ x,
                                          const Plane<kChannelsLast>& p, int h, int oh,
                                          int col) {
  const int r = 2 * oh;
  float m = __ldg(x + p.at(r, col));
  if (r > 0) m = fmaxf(m, __ldg(x + p.at(r - 1, col)));
  if (r + 1 < h) m = fmaxf(m, __ldg(x + p.at(r + 1, col)));
  return m;
}

template <bool kChannelsLast>
__global__ void __launch_bounds__(kThreads)
maxpool_fwd_kernel(const float* __restrict__ x, float* __restrict__ y, uint32_t total, int c,
                   int h, int w, int oh_n, int ow_n) {
  const uint32_t i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  int n, ch, oh, ow;
  unravel<kChannelsLast>(i, c, oh_n, ow_n, &n, &ch, &oh, &ow);
  const Plane<kChannelsLast> p(n, ch, c, h, w);
  const int col = 2 * ow;
  float m = row_pool(x, p, h, oh, col);
  if (col > 0) m = fmaxf(m, row_pool(x, p, h, oh, col - 1));
  if (col + 1 < w) m = fmaxf(m, row_pool(x, p, h, oh, col + 1));
  y[i] = m;
}

template <bool kChannelsLast>
__global__ void __launch_bounds__(kThreads)
maxpool_bwd_kernel(const float* __restrict__ x, const float* __restrict__ y,
                   const float* __restrict__ dy, float* __restrict__ dx, uint32_t total, int c,
                   int h, int w, int oh_n, int ow_n) {
  const uint32_t i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  int n, ch, r, col;
  unravel<kChannelsLast>(i, c, h, w, &n, &ch, &r, &col);
  const Plane<kChannelsLast> p(n, ch, c, h, w), po(n, ch, c, oh_n, ow_n);
  const float xv = __ldg(x + i);
  // windows covering row r: oh in [floor(r / 2), floor((r + 1) / 2)], likewise columns
  const int oh_hi = min((r + 1) / 2, oh_n - 1);
  const int ow_lo = col / 2, ow_hi = min((col + 1) / 2, ow_n - 1);
  float acc = 0.f;
  for (int oh = r / 2; oh <= oh_hi; ++oh) {
    const float y1 = row_pool(x, p, h, oh, col);
    if (!(xv == y1)) continue;
    float s = 0.f;
    for (int ow = ow_lo; ow <= ow_hi; ++ow) {
      const int64_t o = po.at(oh, ow);
      if (y1 == __ldg(y + o)) s += __ldg(dy + o);
    }
    acc += s;
  }
  dx[i] = acc;
}

unsigned blocks_for(uint32_t total) { return (total + kThreads - 1) / kThreads; }

// Whether n x c x h x w elements (x's count, the larger of x and y) fit the
// kernels' 32-bit indices, with room for the last block's overhang.
bool fits(int n, int c, int h, int w) {
  return (int64_t)n * c * h * w <= (int64_t)0x7FFFFFFF - kThreads;
}

}  // namespace

extern "C" {

// y (n, c, oh_n, ow_n) from x (n, c, h, w), both NCHW-contiguous or both
// channels_last; oh_n = (h - 1) / 2 + 1, ow_n likewise.  Returns the
// launch's CUDA error code (-1: arguments refused: an empty tensor, or more
// than 2^31 - 257 elements).
int maxpool_fwd(const float* x, float* y, int n, int c, int h, int w, int channels_last,
                void* stream) {
  if (n < 1 || c < 1 || h < 1 || w < 1 || !fits(n, c, h, w)) return -1;
  const int oh_n = (h - 1) / 2 + 1, ow_n = (w - 1) / 2 + 1;
  const uint32_t total = (uint32_t)n * c * oh_n * ow_n;
  cudaStream_t s = (cudaStream_t)stream;
  if (channels_last)
    maxpool_fwd_kernel<true><<<blocks_for(total), kThreads, 0, s>>>(x, y, total, c, h, w, oh_n,
                                                                   ow_n);
  else
    maxpool_fwd_kernel<false><<<blocks_for(total), kThreads, 0, s>>>(x, y, total, c, h, w, oh_n,
                                                                    ow_n);
  return (int)cudaGetLastError();
}

// dx from x, the forward's y and its gradient dy, all in x's layout.
int maxpool_bwd(const float* x, const float* y, const float* dy, float* dx, int n, int c, int h,
                int w, int channels_last, void* stream) {
  if (n < 1 || c < 1 || h < 1 || w < 1 || !fits(n, c, h, w)) return -1;
  const int oh_n = (h - 1) / 2 + 1, ow_n = (w - 1) / 2 + 1;
  const uint32_t total = (uint32_t)n * c * h * w;
  cudaStream_t s = (cudaStream_t)stream;
  if (channels_last)
    maxpool_bwd_kernel<true><<<blocks_for(total), kThreads, 0, s>>>(x, y, dy, dx, total, c, h, w,
                                                                   oh_n, ow_n);
  else
    maxpool_bwd_kernel<false><<<blocks_for(total), kThreads, 0, s>>>(x, y, dy, dx, total, c, h,
                                                                    w, oh_n, ow_n);
  return (int)cudaGetLastError();
}

}  // extern "C"
