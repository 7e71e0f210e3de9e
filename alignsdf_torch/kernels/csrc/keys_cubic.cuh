// The Keys cubic (A = -0.75, PyTorch's bicubic kernel) of the pixel kernels
// K3 and K4: the 4 tap weights of a sample and the cubic's derivative.

#pragma once

// Keys cubic weights of the taps floor(p)-1 .. floor(p)+2 at fraction t
// (JAX ops/geometry.py:_cubic_weights).
__device__ __forceinline__ void keys_taps(float t, float* w) {
  const float a = -0.75f;
  const float s0 = 1.f + t, s1 = t, s2 = 1.f - t, s3 = 2.f - t;
  w[0] = (((s0 - 5.f) * s0 + 8.f) * s0 - 4.f) * a;
  w[1] = ((a + 2.f) * s1 - (a + 3.f)) * s1 * s1 + 1.f;
  w[2] = ((a + 2.f) * s2 - (a + 3.f)) * s2 * s2 + 1.f;
  w[3] = (((s3 - 5.f) * s3 + 8.f) * s3 - 4.f) * a;
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
