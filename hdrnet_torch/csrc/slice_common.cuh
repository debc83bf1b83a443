// Per-pixel tap arithmetic shared by the slice kernels (K1 in
// fused_slice_apply.cu; K3 and K4 in slice_apply.cu).
//
// The boundary rule of hdrnet_torch/ops/reference.py (_spatial_taps,
// _depth_taps) and of the reference C++ op
// (ops/bilateral_slice_apply.cc:40-81): two taps at floor(g - 0.5) and +1
// along each axis, tent weights at the *unclamped* tap centres, reads at
// *clamped* indices. Spatially g = (x + 0.5) * grid_extent / extent; in
// depth g = guide * gd with no +0.5, and the tent is smoothed:
// 1 - sqrt(d^2 + 1e-8). IEEE sqrtf and division: build without fast math.

#pragma once

#include <cuda_runtime.h>

namespace hdrnet {

constexpr float kEps = 1e-8f;

__device__ __forceinline__ int clampi(int v, int hi) {
  return min(max(v, 0), hi);
}

__device__ __forceinline__ float clamp01(float v) {
  return fminf(fmaxf(v, 0.0f), 1.0f);
}

// Two taps along one axis: weights w at the unclamped centres, clamped
// indices i.
struct Taps {
  float w[2];
  int i[2];
};

// Spatial taps of pixel x; scale = grid_extent / extent.
__device__ __forceinline__ Taps spatial_taps(int x, float scale,
                                             int grid_extent) {
  const float g = (static_cast<float>(x) + 0.5f) * scale;
  const float f = floorf(g - 0.5f);
  Taps t;
  t.w[0] = fmaxf(1.0f - fabsf(f + 0.5f - g), 0.0f);
  t.w[1] = fmaxf(1.0f - fabsf(f + 1.5f - g), 0.0f);
  t.i[0] = clampi(static_cast<int>(f), grid_extent - 1);
  t.i[1] = clampi(static_cast<int>(f) + 1, grid_extent - 1);
  return t;
}

// Depth taps of a guide value; dw (when not null) receives the weights'
// derivatives with respect to the guide: gd * (d / sqrt(d^2 + eps)) at
// each unclamped tap, 0 where the tent is clipped (sqrt(.) > 1). The
// derivative is steep where the guide sits at a bin centre (d / sqrt(d^2 +
// 1e-8) goes from -1 to 1 over |d| < 1e-4), so there gz is rounded as the
// plain version rounds it, never fused into the subtractions that follow.
__device__ __forceinline__ Taps depth_taps(float guide, int gd,
                                           float* dw = nullptr) {
  const float gz = dw != nullptr ? __fmul_rn(guide, static_cast<float>(gd))
                                 : guide * static_cast<float>(gd);
  const float f = floorf(gz - 0.5f);
  const float d0 = f + 0.5f - gz;
  const float d1 = f + 1.5f - gz;
  const float s0 = sqrtf(d0 * d0 + kEps);
  const float s1 = sqrtf(d1 * d1 + kEps);
  Taps t;
  t.w[0] = fmaxf(1.0f - s0, 0.0f);
  t.w[1] = fmaxf(1.0f - s1, 0.0f);
  t.i[0] = clampi(static_cast<int>(f), gd - 1);
  t.i[1] = clampi(static_cast<int>(f) + 1, gd - 1);
  if (dw != nullptr) {
    const float fgd = static_cast<float>(gd);
    dw[0] = fgd * (s0 > 1.0f ? 0.0f : d0 * (1.0f / s0));
    dw[1] = fgd * (s1 > 1.0f ? 0.0f : d1 * (1.0f / s1));
  }
  return t;
}

}  // namespace hdrnet
