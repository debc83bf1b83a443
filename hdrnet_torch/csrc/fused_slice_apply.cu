// K1: fused curves guide + trilinear bilateral slice + 3x4 affine apply.
// K6: the same with the pointwise NN guide.
//
// K1 replaces hdrnet_tpu/ops/pallas.py: enhance_fused (pallas_call at
// pallas.py:1216) -> _fused_fwd_kernel (pallas.py:635) in curves mode,
// with _curves_guide (489, the literal relu form) and _apply_epilogue
// (610), float32 -> float32 and uint8 -> uint8. K6 replaces the same
// pallas_call in NN mode: _nn_guide (pallas.py:529) inside
// _fused_fwd_kernel (663-668), through pallas.py:1216.
//
// What it computes, per pixel of an NHWC frame (B, H, W, 3):
//   1. load the 3 channels (uint8 is divided by 255, IEEE division);
//   2. the guide, one of two functors (a template argument):
//      curves (K1): g_c = bias_c + sum_j img_j * ccm[j][c]; a 16-knot
//      sum of slope * max(g_c - shift, 0) per channel; mix + bias; clip
//      to [0, 1];
//      NN (K6): h_k = b1_k + sum_j img_j * W1[j][k] for k < gc (batch
//      norm folded into W1 and b1), then
//      sigmoid(b2 + sum_k max(h_k, 0) * w2_k) = 1 / (1 + expf(-x)), with
//      the IEEE expf (no fast math, so never __expf);
//   3. taps at floor(g - 0.5) and +1 along x, y and depth, with
//      gx = (x + .5) * gw / W, gy = (y + .5) * gh / H, gz = guide * gd;
//      tent weights at the unclamped tap centres (the depth tent is
//      smoothed: 1 - sqrt(d^2 + 1e-8)), reads at clamped indices
//      (ops/bilateral_slice_apply.cc:40-81);
//   4. gather 8 corners x 12 coefficients from the packed grid
//      (B, gh, gw, gd, 12) and apply out_i = A_i3 + sum_j A_ij * img_j;
//   5. optionally clip to [0, 1]; optionally requantize to uint8 as
//      trunc(v * 255 + 0.5), with __fmul_rn / __fadd_rn so that nvcc does
//      not contract it into an FMA that rounds a .5 tie the other way.
//
// What bounds it on an H100 (derived from the shapes, not measured): a
// 4K frame has 8.29 M pixels. At float32 it reads 99.5 MB and writes
// 99.5 MB, about 199 MB, or 59 us at 3.35 TB/s; at uint8 about 50 MB, or
// 15 us. The arithmetic is about 4e2 float32 operations a pixel (guide
// about 150, slice and apply about 250), about 3.3 GFLOP a frame, or
// about 50 us at 67 TFLOP/s of non-tensor float32. So float32 sits near
// the memory/compute balance point and uint8 is bound by arithmetic.
// K6 at gc = 16 moves the same bytes; its guide is 16 x (3 FMA + max +
// FMA) plus the sigmoid, about 100 operations (the curves guide about
// 150), so about 3.0 GFLOP a frame, or about 45 us at 67 TFLOP/s: the
// same balance as K1, a little lighter in arithmetic. Its 5 * gc + 1
// parameters are read by every pixel once per use: 81 floats at gc = 16,
// 6.7e8 shared-memory reads a frame.
//
// What the design does about it:
//   * One pass, one thread per pixel: the guide never leaves registers
//     and the frame is read and written once, in NHWC, so the two
//     full-frame transposes of the TPU layout are gone.
//   * The guide parameters (112 for curves, up to 5 * 64 + 1 for NN) are
//     staged in shared memory once per block and read with uniform
//     (broadcast) addresses, so the NN guide's runtime-gc loop costs no
//     bank conflicts and no global loads.
//   * The grid is 16*16*8*12*4 B = 98,304 B per image, above the 48 KB of
//     static shared memory; it is read through L1/L2 with __ldg as three
//     16-byte loads per corner. Neighbouring pixels of a warp share their
//     x and y cells and mostly their depth bins, so the loads are nearly
//     warp-uniform. Staging the grid in dynamic shared memory is left to
//     a later change.
//   * None of the TPU tile planner (cell windows, strips, one-hot
//     contractions) is carried over: a per-pixel gather has no window cap.

#include <cstdint>
#include <cuda_runtime.h>

#include "slice_common.cuh"

namespace {

using hdrnet::clamp01;
using hdrnet::depth_taps;
using hdrnet::spatial_taps;
using hdrnet::Taps;

constexpr int kNIn = 3;
constexpr int kNOut = 3;
constexpr int kNPts = 16;
constexpr int kNC = kNOut * (kNIn + 1);  // 12 packed grid channels
// Packed guide parameters: ccm_ext (4, 3) | shifts (3, 16) | slopes (3, 16)
// | mix (4,), all row-major float32.
constexpr int kCcm = 0;
constexpr int kShifts = kCcm + (kNIn + 1) * kNIn;
constexpr int kSlopes = kShifts + kNIn * kNPts;
constexpr int kMix = kSlopes + kNIn * kNPts;
constexpr int kNParams = kMix + kNIn + 1;  // 112
// NN guide: w1_ext (kNIn + 1, gc) row-major | w2_ext (gc + 1,); gc is a
// runtime value up to kMaxGC (the wrapper's MAX_GUIDE_COMPLEXITY).
constexpr int kMaxGC = 64;
constexpr int kMaxNNParams = (kNIn + 2) * kMaxGC + 1;  // 321

__device__ __forceinline__ float load_unit(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_unit(const uint8_t* p) {
  return __fdiv_rn(static_cast<float>(__ldg(p)), 255.0f);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(uint8_t* p, float v) {
  // Clip is enforced by the wrapper, so v * 255 + 0.5 is in [0.5, 255.5].
  *p = static_cast<uint8_t>(
      static_cast<int>(__fadd_rn(__fmul_rn(v, 255.0f), 0.5f)));
}

// Literal relu form of the curves guide (pallas.py:514-526).
__device__ __forceinline__ float curves_guide(const float* p,
                                              const float img[kNIn]) {
  float acc = 0.0f;
#pragma unroll
  for (int c = 0; c < kNIn; ++c) {
    float g = p[kCcm + kNIn * kNIn + c];
#pragma unroll
    for (int j = 0; j < kNIn; ++j) g += img[j] * p[kCcm + j * kNIn + c];
    float cur = 0.0f;
#pragma unroll
    for (int k = 0; k < kNPts; ++k) {
      cur += p[kSlopes + c * kNPts + k] *
             fmaxf(g - p[kShifts + c * kNPts + k], 0.0f);
    }
    acc += cur * p[kMix + c];
  }
  return clamp01(acc + p[kMix + kNIn]);
}

// The guide functors: Guide::kMaxParams bounds the shared staging,
// n_params() is the packed count, operator() the guide of one pixel.
struct CurvesGuide {
  static constexpr int kMaxParams = kNParams;
  __device__ __forceinline__ int n_params() const { return kNParams; }
  __device__ __forceinline__ float operator()(const float* p,
                                              const float img[kNIn]) const {
    return curves_guide(p, img);
  }
};

// Pointwise MLP guide with the batch norm folded in (pallas.py:529-544):
// the same sums in the same order as the TPU kernel.
struct NNGuide {
  static constexpr int kMaxParams = kMaxNNParams;
  int gc;
  __device__ __forceinline__ int n_params() const {
    return (kNIn + 2) * gc + 1;
  }
  __device__ __forceinline__ float operator()(const float* p,
                                              const float img[kNIn]) const {
    const float* w1 = p;                     // (kNIn + 1, gc)
    const float* w2 = p + (kNIn + 1) * gc;   // (gc + 1,)
    float acc = w2[gc];
    for (int k = 0; k < gc; ++k) {
      float h = w1[kNIn * gc + k];
#pragma unroll
      for (int j = 0; j < kNIn; ++j) h += img[j] * w1[j * gc + k];
      acc += fmaxf(h, 0.0f) * w2[k];
    }
    return 1.0f / (1.0f + expf(-acc));
  }
};

// sliced[k] += w * cell[k] for one grid cell's 12 coefficients.
__device__ __forceinline__ void add_cell(float sliced[kNC], float w,
                                         const float* cell) {
  const float4* c4 = reinterpret_cast<const float4*>(cell);
#pragma unroll
  for (int q = 0; q < kNC / 4; ++q) {
    const float4 v = __ldg(c4 + q);
    sliced[4 * q + 0] += w * v.x;
    sliced[4 * q + 1] += w * v.y;
    sliced[4 * q + 2] += w * v.z;
    sliced[4 * q + 3] += w * v.w;
  }
}

template <typename Guide, typename TIn, typename TOut>
__global__ void __launch_bounds__(256)
    enhance_fused_kernel(const float* __restrict__ grid,
                         const TIn* __restrict__ frame,
                         const float* __restrict__ params, Guide guide_fn,
                         TOut* __restrict__ out, int clip, int b, int h,
                         int w, int gh, int gw, int gd, float sy, float sx) {
  __shared__ float p[Guide::kMaxParams];
  const int n_params = guide_fn.n_params();
  for (int i = threadIdx.x; i < n_params; i += blockDim.x) p[i] = params[i];
  __syncthreads();

  const long long npix = static_cast<long long>(b) * h * w;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long grid_stride = static_cast<long long>(gh) * gw * gd * kNC;
  for (long long pix = static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
       pix < npix; pix += stride) {
    const int x = static_cast<int>(pix % w);
    const long long row = pix / w;
    const int y = static_cast<int>(row % h);
    const long long bb = row / h;

    float img[kNIn];
#pragma unroll
    for (int j = 0; j < kNIn; ++j) img[j] = load_unit(frame + pix * kNIn + j);

    const float guide = guide_fn(p, img);

    // Taps: weights at unclamped centres, clamped reads.
    const Taps ty = spatial_taps(y, sy, gh);
    const Taps tx = spatial_taps(x, sx, gw);
    const Taps tz = depth_taps(guide, gd);

    const float* g = grid + bb * grid_stride;
    float sliced[kNC];
#pragma unroll
    for (int k = 0; k < kNC; ++k) sliced[k] = 0.0f;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float wyx = ty.w[a] * tx.w[c];
        const float* cell =
            g + (static_cast<long long>(ty.i[a]) * gw + tx.i[c]) * gd * kNC;
        add_cell(sliced, wyx * tz.w[0], cell + tz.i[0] * kNC);
        add_cell(sliced, wyx * tz.w[1], cell + tz.i[1] * kNC);
      }
    }

    TOut* o = out + pix * kNOut;
#pragma unroll
    for (int i = 0; i < kNOut; ++i) {
      float acc = sliced[i * (kNIn + 1) + kNIn];  // the affine offset
#pragma unroll
      for (int j = 0; j < kNIn; ++j) acc += sliced[i * (kNIn + 1) + j] * img[j];
      if (clip) acc = clamp01(acc);
      store(o + i, acc);
    }
  }
}

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;

template <typename Guide, typename TIn, typename TOut>
void launch(const float* grid, const void* frame, const float* params,
            Guide guide_fn, void* out, int clip, int b, int h, int w, int gh,
            int gw, int gd, float sy, float sx, cudaStream_t st) {
  const long long npix = static_cast<long long>(b) * h * w;
  long long blocks = (npix + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  enhance_fused_kernel<Guide, TIn, TOut>
      <<<static_cast<int>(blocks), kThreads, 0, st>>>(
          grid, static_cast<const TIn*>(frame), params, guide_fn,
          static_cast<TOut*>(out), clip, b, h, w, gh, gw, gd, sy, sx);
}

// Picks the input and output types; returns cudaGetLastError().
template <typename Guide>
int dispatch(const void* grid, const void* frame, int u8_in,
             const void* params, Guide guide_fn, void* out, int u8_out,
             int clip, int b, int h, int w, int gh, int gw, int gd, float sy,
             float sx, void* stream) {
  if (static_cast<long long>(b) * h * w == 0)
    return static_cast<int>(cudaGetLastError());
  const float* g = static_cast<const float*>(grid);
  const float* p = static_cast<const float*>(params);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (u8_in && u8_out) {
    launch<Guide, uint8_t, uint8_t>(g, frame, p, guide_fn, out, clip, b, h,
                                    w, gh, gw, gd, sy, sx, st);
  } else if (u8_in) {
    launch<Guide, uint8_t, float>(g, frame, p, guide_fn, out, clip, b, h, w,
                                  gh, gw, gd, sy, sx, st);
  } else if (u8_out) {
    launch<Guide, float, uint8_t>(g, frame, p, guide_fn, out, clip, b, h, w,
                                  gh, gw, gd, sy, sx, st);
  } else {
    launch<Guide, float, float>(g, frame, p, guide_fn, out, clip, b, h, w,
                                gh, gw, gd, sy, sx, st);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int hdrnet_enhance_fused(const void* grid, const void* frame,
                                    int u8_in, const void* params, void* out,
                                    int u8_out, int clip, int b, int h, int w,
                                    int gh, int gw, int gd, float sy,
                                    float sx, void* stream) {
  return dispatch(grid, frame, u8_in, params, CurvesGuide{}, out, u8_out,
                  clip, b, h, w, gh, gw, gd, sy, sx, stream);
}

// K6. gc must be in [1, kMaxGC]: the wrapper checks it, and a value
// outside is refused here as cudaErrorInvalidValue without a launch.
extern "C" int hdrnet_enhance_fused_nn(const void* grid, const void* frame,
                                       int u8_in, const void* params, int gc,
                                       void* out, int u8_out, int clip,
                                       int b, int h, int w, int gh, int gw,
                                       int gd, float sy, float sx,
                                       void* stream) {
  if (gc < 1 || gc > kMaxGC) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(grid, frame, u8_in, params, NNGuide{gc}, out, u8_out, clip,
                  b, h, w, gh, gw, gd, sy, sx, stream);
}
