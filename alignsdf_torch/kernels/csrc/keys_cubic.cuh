// The Keys cubic (A = -0.75, PyTorch's bicubic kernel) of the pixel kernels
// K3 and K4: the 4 tap weights of a sample and the cubic's derivative.

#pragma once

// Keys cubic weights of the taps floor(p)-1 .. floor(p)+2 at fraction t
// (JAX ops/geometry.py:_cubic_weights), one rounding per operation in the
// plain version's order (ops/geometry.py:keys_cubic_taps, no FMA
// contraction), so that the weights equal the plain version's bit for bit
// and a bf16 plan rounds the same tap weights.
__device__ __forceinline__ float keys_near(float s) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(__fmul_rn(1.25f, s), 2.25f), s), s), 1.f);
}
__device__ __forceinline__ float keys_far(float s) {
  return __fmul_rn(
      __fsub_rn(__fmul_rn(__fadd_rn(__fmul_rn(__fsub_rn(s, 5.f), s), 8.f), s), 4.f), -0.75f);
}
__device__ __forceinline__ void keys_taps(float t, float* w) {
  w[0] = keys_far(__fadd_rn(1.f, t));
  w[1] = keys_near(t);
  w[2] = keys_near(__fsub_rn(1.f, t));
  w[3] = keys_far(__fsub_rn(2.f, t));
}

// dK/dt, continuous at |t| = 1 and 2 (JAX ops/decoder_train_pixel.py:
// _keys_cubic_grad).
__device__ __forceinline__ float keys_grad(float t) {
  const float a = -0.75f;
  const float s = fabsf(t);
  const float near = 3.f * (a + 2.f) * s * s - 2.f * (a + 3.f) * s;
  const float far = a * ((3.f * s - 10.f) * s + 8.f);
  const float mag = s <= 1.f ? near : (s < 2.f ? far : 0.f);
  return t > 0.f ? mag : (t < 0.f ? -mag : 0.f);
}
