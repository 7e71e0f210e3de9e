// Kernel K7: the ResNet stem's 3x3 / stride 2 / pad 1 max pool, forward and
// backward, float32 or bf16 (N, C, H, W) tensors, NCHW-contiguous or
// channels last.
//
// Replaces alignsdf_tpu/ops/maxpool.py: the pass kernels _run_pass (body
// _fwd_pass_kernel) and _run_bwd_pass (body _bwd_pass_kernel) behind
// maxpool_k3s2p1.  The TPU computes the pool separably, an H pass then a W
// pass, in layouts where every stride-2 selection is a leading-dim pair
// reshape; none of that blocking carries over.  What does carry over is the
// arithmetic, tie routing included:
//
//   y1[oh, w]  = max_{r in {2oh-1, 2oh, 2oh+1}} x[r, w]            (H pass)
//   y[oh, ow]  = max_{c in {2ow-1, 2ow, 2ow+1}} y1[oh, c]           (W pass)
//   dy1[oh, w] = sum_{ow covers w} [y1[oh, w] == y[oh, ow]] * dy[oh, ow]
//   dx[h, w]   = sum_{oh covers h} [x[h, w] == y1[oh, w]] * dy1[oh, w]
//
// Rows and columns outside the image take no part.  The backward routes dy to
// EVERY tied position of a window, per axis (the TPU kernel's two backward
// passes composed), not to the first maximum as PyTorch's and XLA's
// select-and-scatter do.  Each sum has at most two nonzero terms, so the
// order of its additions does not change a bit; the backward keeps the
// association above (dy1 first, then the sum over oh), as the plain version
// does, and so equals it bit for bit.
//
// Bound on the card: bytes.  The forward reads x once and writes y; the
// backward reads x, y and dy and writes dx; 9 and ~12 flops an element are
// far below the H100's rate.
//
// Forward: one thread per output, threads in memory order (neighbours on
// neighbouring columns, or channels in channels last), so loads and stores
// coalesce; the rows a thread reads are shared with its neighbours through
// L1.
//
// Backward: row streaming, so that x is read once (a gather: no atomics).  A
// thread owns one column of one image -- in channels last four channels of
// one pixel as a float4 (one channel where C % 4 != 0), in NCHW one column
// of one plane -- and walks down a band of output rows oh0 <= oh < oh1.  At
// each oh it holds x's rows 2oh-1 (kept from the step before), 2oh and
// 2oh+1 in registers, forms y1, loads y and dy at the one or two columns ow
// that cover its column (a warp's neighbours read the same pixels, which L1
// serves), forms dy1, and finishes dx at rows 2oh-1 (the sum of the windows
// oh-1 and oh) and 2oh.  The next window's loads are issued before the
// current window's compares, and no load depends on a compare.  The band
// writes dx rows 2oh0 .. 2oh1-1; finishing row 2oh1-1 takes window oh1, so
// a band re-reads three rows of x (2oh0-1, 2oh1, 2oh1+1) and one of y and
// dy.  The band height sets the parallelism (band_rows_for).  Recomputing
// y1 from x costs no bytes; storing it would add a write of half of x in the
// forward and a read in the backward.
//
// bf16 (the bf16 encoder's stem; JAX's maxpool_k3s2p1 on a bf16 array,
// ops/maxpool.py:71-98): the same kernels on bf16 loads and stores,
// arithmetic in float32.  The forward is exact (a max of bf16 values).  The
// backward rounds as the TPU kernel's two passes write their outputs in x's
// dtype: dy1 (a sum of at most two bf16 cotangents in float32) is rounded to
// bf16, and so is dx (at most two such dy1); the tie routing is float32's.
// A channels-last column of four channels is 8 bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
// The backward's threads to aim for: two loads of 2048 threads on each of
// the H100 SXM's 132 SMs.  Tuned for that card: on one with another SM count
// the result is the same, the band height perhaps no longer the fastest.
constexpr int64_t kWaveThreads = 2 * 132 * 2048;

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

// One element as float32 (exact for bf16), and a float32 to an element
// (rounded to nearest, ties to even, for bf16).
__device__ __forceinline__ float ld1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld1(const __nv_bfloat16* p) { return __bfloat162float(__ldg(p)); }
__device__ __forceinline__ void st1(float* p, float v) { *p = v; }
__device__ __forceinline__ void st1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// y1 at output row oh and input column col of one plane of x
template <bool kChannelsLast, class E>
__device__ __forceinline__ float row_pool(const E* __restrict__ x,
                                          const Plane<kChannelsLast>& p, int h, int oh,
                                          int col) {
  const int r = 2 * oh;
  float m = ld1(x + p.at(r, col));
  if (r > 0) m = fmaxf(m, ld1(x + p.at(r - 1, col)));
  if (r + 1 < h) m = fmaxf(m, ld1(x + p.at(r + 1, col)));
  return m;
}

// E: the element type, float or __nv_bfloat16.
template <bool kChannelsLast, class E>
__global__ void __launch_bounds__(kThreads)
maxpool_fwd_kernel(const E* __restrict__ x, E* __restrict__ y, uint32_t total, int c,
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
  st1(y + i, m);
}

// V consecutive elements E of a column, loaded and stored as one access,
// held as float32 (T): bf16 widened exactly, narrowed to nearest on store.
template <int V, class E>
struct Lanes;

template <class E>
struct Lanes<1, E> {
  using T = float;
  static __device__ __forceinline__ T load(const E* p) { return ld1(p); }
  static __device__ __forceinline__ void store(E* p, T v) { st1(p, v); }
  static __device__ __forceinline__ T fill(float f) { return f; }
  static __device__ __forceinline__ T round(T v) { return round1(v); }
  static __device__ __forceinline__ float round1(float v) {
    return sizeof(E) == 2 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
  }
};

template <>
struct Lanes<4, float> {
  using T = float4;
  static __device__ __forceinline__ T load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void store(float* p, T v) {
    *reinterpret_cast<float4*>(p) = v;
  }
  static __device__ __forceinline__ T fill(float f) { return make_float4(f, f, f, f); }
  static __device__ __forceinline__ T round(T v) { return v; }
};

template <>
struct Lanes<4, __nv_bfloat16> {  // 8 bytes
  using T = float4;
  static __device__ __forceinline__ T load(const __nv_bfloat16* p) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xFFFF0000u),
                       __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xFFFF0000u));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, T v) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
    *reinterpret_cast<uint2*>(p) =
        make_uint2(*reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
  }
  static __device__ __forceinline__ T fill(float f) { return make_float4(f, f, f, f); }
  static __device__ __forceinline__ T round(T v) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
    return make_float4(__low2float(lo), __high2float(lo), __low2float(hi), __high2float(hi));
  }
};

__device__ __forceinline__ float vmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ float4 vmax(float4 a, float4 b) {
  return make_float4(fmaxf(a.x, b.x), fmaxf(a.y, b.y), fmaxf(a.z, b.z), fmaxf(a.w, b.w));
}
__device__ __forceinline__ float vadd(float a, float b) { return a + b; }
__device__ __forceinline__ float4 vadd(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
// [a == b] * g, without a multiply (0 * inf would be NaN)
__device__ __forceinline__ float pick(float a, float b, float g) { return a == b ? g : 0.f; }
__device__ __forceinline__ float4 pick(float4 a, float4 b, float4 g) {
  return make_float4(pick(a.x, b.x, g.x), pick(a.y, b.y, g.y), pick(a.z, b.z, g.z),
                     pick(a.w, b.w, g.w));
}

// What one window oh brings: x's rows 2oh and 2oh+1 (-inf below the image),
// y and dy at the columns ow = lo and hi covering the thread's column (hi ==
// lo where only one covers it).
template <class T>
struct Window {
  T x0, x1, ylo, yhi, glo, ghi;
};

// dx from x, y and dy, one thread per (band, image, lane).  An image is one
// n in channels last (a row holds w * c elements, a column c) and one (n,
// ch) plane in NCHW (cs = 1); a lane is one column and V of its cs
// elements.  E: the element type; for bf16 dy1 is rounded to bf16 before
// it is routed, and dx on its store.
template <int V, class E>
__global__ void __launch_bounds__(kThreads)
maxpool_bwd_rows_kernel(const E* __restrict__ x, const E* __restrict__ y,
                        const E* __restrict__ dy, E* __restrict__ dx, uint32_t total,
                        int lanes, int images, int band_rows, int cs, int h, int w, int oh_n,
                        int ow_n) {
  using L = Lanes<V, E>;
  using T = typename L::T;
  const uint32_t t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;
  const int lane = (int)(t % (uint32_t)lanes);
  const uint32_t rest = t / (uint32_t)lanes;
  const int image = (int)(rest % (uint32_t)images), band = (int)(rest / (uint32_t)images);
  const int groups = cs / V, col = lane / groups, chan = (lane % groups) * V;
  // 32-bit offsets: the entry point refuses tensors of 2^31 - 257 elements or more
  const int xrow = w * cs, yrow = ow_n * cs;
  const int xo = image * h * xrow + col * cs + chan, yo = image * oh_n * yrow + chan;
  const E* xp = x + xo;
  E* dxp = dx + xo;
  const E* yp = y + yo;
  const E* gp = dy + yo;
  const int lo = col / 2, hi = (col & 1) && lo + 1 < ow_n ? lo + 1 : lo;
  const int ylo = lo * cs, yhi = hi * cs;
  const T none = L::fill(-CUDART_INF_F);

  auto fetch = [&](int oh, Window<T>& win) {
    win.x0 = L::load(xp + 2 * oh * xrow);
    win.x1 = 2 * oh + 1 < h ? L::load(xp + (2 * oh + 1) * xrow) : none;
    const int o = oh * yrow;
    win.ylo = L::load(yp + o + ylo);
    win.yhi = L::load(yp + o + yhi);  // lo again where one window covers the column
    win.glo = L::load(gp + o + ylo);
    win.ghi = L::load(gp + o + yhi);
  };

  const int oh0 = band * band_rows, oh1 = min(oh0 + band_rows, oh_n);
  const int last = min(oh1, oh_n - 1);  // window oh1 (when it exists) only finishes row 2oh1-1
  T above = oh0 > 0 ? L::load(xp + (2 * oh0 - 1) * xrow) : none;  // x row 2oh-1
  T pending = L::fill(0.f);  // window oh-1's part of dx row 2oh-1
  Window<T> cur, next;
  fetch(oh0, cur);
  for (int oh = oh0;; ++oh) {
    if (oh < last) fetch(oh + 1, next);
    const T y1 = vmax(vmax(above, cur.x0), cur.x1);
    const T s = pick(y1, cur.ylo, cur.glo);
    const T dy1 = L::round(hi != lo ? vadd(s, pick(y1, cur.yhi, cur.ghi)) : s);
    if (oh > oh0) L::store(dxp + (2 * oh - 1) * xrow, vadd(pending, pick(above, y1, dy1)));
    if (oh == oh1) break;
    L::store(dxp + 2 * oh * xrow, pick(cur.x0, y1, dy1));
    pending = pick(cur.x1, y1, dy1);
    if (oh == last) break;
    above = cur.x1;
    cur = next;
  }
  if (oh1 == oh_n && 2 * oh_n - 1 < h)  // even h: row h-1 lies under the last window alone
    L::store(dxp + (2 * oh_n - 1) * xrow, pending);
}

unsigned blocks_for(uint32_t total) { return (total + kThreads - 1) / kThreads; }

// Whether n x c x h x w elements (x's count, the larger of x and y) fit the
// kernels' 32-bit indices, with room for the last block's overhang.
bool fits(int n, int c, int h, int w) {
  return (int64_t)n * c * h * w <= (int64_t)0x7FFFFFFF - kThreads;
}

// The backward's band height: the fewest bands that give `columns` threads
// a band kWaveThreads threads or more in all, at most one band an output
// row.  Built with -DK7_BAND_ROWS=n, every band is n rows (clipped to oh_n),
// for tools/time_maxpool.py's sweep of band heights.
int band_rows_for(int64_t columns, int oh_n) {
#ifdef K7_BAND_ROWS
  static_assert(K7_BAND_ROWS >= 1, "K7_BAND_ROWS must be at least 1");
  (void)columns;
  return std::min(K7_BAND_ROWS, oh_n);
#else
  const int64_t bands = std::min<int64_t>(oh_n, (kWaveThreads + columns - 1) / columns);
  return (int)((oh_n + bands - 1) / bands);
#endif
}

template <class E>
int launch_fwd(const E* x, E* y, int n, int c, int h, int w, int channels_last,
               cudaStream_t s) {
  const int oh_n = (h - 1) / 2 + 1, ow_n = (w - 1) / 2 + 1;
  const uint32_t total = (uint32_t)n * c * oh_n * ow_n;
  if (channels_last)
    maxpool_fwd_kernel<true, E><<<blocks_for(total), kThreads, 0, s>>>(x, y, total, c, h, w,
                                                                       oh_n, ow_n);
  else
    maxpool_fwd_kernel<false, E><<<blocks_for(total), kThreads, 0, s>>>(x, y, total, c, h, w,
                                                                        oh_n, ow_n);
  return (int)cudaGetLastError();
}

template <class E>
int launch_bwd(const E* x, const E* y, const E* dy, E* dx, int n, int c, int h, int w,
               int channels_last, cudaStream_t s) {
  const int oh_n = (h - 1) / 2 + 1, ow_n = (w - 1) / 2 + 1;
  // four-channel columns where channels last holds the channels in aligned
  // fours (16 bytes in float32, 8 in bf16)
  const bool vec = channels_last && c % 4 == 0 &&
                   ((uintptr_t)x | (uintptr_t)y | (uintptr_t)dy | (uintptr_t)dx) %
                           (4 * sizeof(E)) == 0;
  const int cs = channels_last ? c : 1, lanes = w * (vec ? c / 4 : cs);
  const int images = channels_last ? n : n * c;
  const int64_t columns = (int64_t)lanes * images;
  const int band_rows = band_rows_for(columns, oh_n);
  const int bands = (oh_n + band_rows - 1) / band_rows;
  const uint32_t total = (uint32_t)(columns * bands);  // <= n * c * h * w: fits
  if (vec)
    maxpool_bwd_rows_kernel<4, E><<<blocks_for(total), kThreads, 0, s>>>(
        x, y, dy, dx, total, lanes, images, band_rows, cs, h, w, oh_n, ow_n);
  else
    maxpool_bwd_rows_kernel<1, E><<<blocks_for(total), kThreads, 0, s>>>(
        x, y, dy, dx, total, lanes, images, band_rows, cs, h, w, oh_n, ow_n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// y (n, c, oh_n, ow_n) from x (n, c, h, w), both NCHW-contiguous or both
// channels_last, float32 or (bf16 != 0) bf16; oh_n = (h - 1) / 2 + 1, ow_n
// likewise.  Returns the launch's CUDA error code (-1: arguments refused:
// an empty tensor, or more than 2^31 - 257 elements).
int maxpool_fwd(const void* x, void* y, int n, int c, int h, int w, int channels_last, int bf16,
                void* stream) {
  if (n < 1 || c < 1 || h < 1 || w < 1 || !fits(n, c, h, w)) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? launch_fwd((const __nv_bfloat16*)x, (__nv_bfloat16*)y, n, c, h, w,
                           channels_last, s)
              : launch_fwd((const float*)x, (float*)y, n, c, h, w, channels_last, s);
}

// dx from x, the forward's y and its gradient dy, all in x's layout and
// dtype.  Returns the launch's CUDA error code (-1: arguments refused: an
// empty tensor, or more than 2^31 - 257 elements).
int maxpool_bwd(const void* x, const void* y, const void* dy, void* dx, int n, int c, int h,
                int w, int channels_last, int bf16, void* stream) {
  if (n < 1 || c < 1 || h < 1 || w < 1 || !fits(n, c, h, w)) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? launch_bwd((const __nv_bfloat16*)x, (const __nv_bfloat16*)y,
                           (const __nv_bfloat16*)dy, (__nv_bfloat16*)dx, n, c, h, w,
                           channels_last, s)
              : launch_bwd((const float*)x, (const float*)y, (const float*)dy, (float*)dx, n, c,
                           h, w, channels_last, s);
}

}  // extern "C"
