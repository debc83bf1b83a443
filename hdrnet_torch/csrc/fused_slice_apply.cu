// K1: fused curves guide + trilinear bilateral slice + 3x4 affine apply.
// K6: the same with the pointwise NN guide.
// K7: both with a pixel offset and a total extent, for a band of a larger
// frame.
// K3 at the models' 3 -> 3 with an offset: the same kernel with the guide
// loaded, not computed, and no clip (slice_apply_fwd_fixed, called by
// slice_apply.cu's launcher).
//
// K1 replaces hdrnet_tpu/ops/pallas.py: enhance_fused (pallas_call at
// pallas.py:1216) -> _fused_fwd_kernel (pallas.py:635) in curves mode,
// with _curves_guide (489, the literal relu form) and _apply_epilogue
// (610), float32 -> float32 and uint8 -> uint8. K6 replaces the same
// pallas_call in NN mode: _nn_guide (pallas.py:529) inside
// _fused_fwd_kernel (663-668), through pallas.py:1216. K7 replaces the
// offset and true-size arguments of that pallas_call: _make_wy_wx
// (pallas.py:446-462), which weights the taps of a tile at its global
// (y, x) offset with the scales gh / h_total and gw / w_total. Here they
// are four runtime arguments of the launchers: y_off and x_off reach the
// kernel, and h_total and w_total bound them there and set the scales sy
// and sx, which the host computes as gh / h_total and gw / w_total (as it
// computes gh / h for a whole frame), so a band's pixels take the same
// float operations as the same pixels of the whole frame.
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
//      gx = (x + x_off + .5) * gw / w_total, gy = (y + y_off + .5) * gh /
//      h_total, gz = guide * gd (offsets 0 and totals W, H for a whole
//      frame);
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
// about 50 us at 67 TFLOP/s of non-tensor float32. K6 at gc = 16 moves
// the same bytes with about 100 guide operations. But the operations are
// not all FMAs: counted as issued instructions (the curves guide's 16
// knots are a subtract, a max and an FMA each; the slice 96 FMAs and the
// tap arithmetic), a pixel needs about 350, which at 4 schedulers x 132
// SMs x 1.755 GHz x 32 lanes is about 0.1 ms a 4K frame. So the kernel is
// bound by the instructions it issues, and every instruction that is not
// the pixel's own arithmetic (a parameter load, a global corner load, an
// index division) costs time one for one. PR 1's kernel issued about 112
// shared loads of guide parameters, 24 global corner loads and 64-bit
// index arithmetic a pixel besides its own.
//
// What the design does about it:
//   * A block owns a 2D tile of 16 rows x 64 columns of one image, and a
//     thread 4 consecutive pixels of one row. The pixel's float
//     operations are those of the plain version, in its order.
//   * Guide parameters: each is read from shared memory once for the
//     thread's 4 pixels (the curves guide's knots as 16-byte vectors; the
//     NN guide's weights re-laid per hidden unit as one 16-byte vector
//     and one float), so a parameter read costs a quarter of an
//     instruction a pixel.
//   * Corners: the tile's cells (the taps of its first and last rows and
//     columns, about 3 x 3 cells x gd x 12 floats, 3.4 KB at 4K and gd 8)
//     are staged in shared memory once with 16-byte copies, and the 8
//     corners of a pixel are read from there as 3 x 16-byte loads each.
//     The host sizes this window from the scales; where it would exceed
//     a block's shared memory (a large grid over a small frame) the
//     corners are read from the grid in device memory instead, with the
//     same arithmetic.
//   * Frame loads and stores: 48 bytes (f32) or 12 bytes (u8) of a
//     thread's 4 pixels as 16- or 4-byte vectors when the row is a
//     multiple of 4 pixels and the pointers aligned; scalars at the
//     ragged end of a row or band and otherwise. A uint8 channel's IEEE
//     v / 255 is looked up in a table of the 256 quotients, filled by
//     the block with the same division.
//   * 32-bit indices inside an image, from the block's and thread's
//     coordinates: no division or grid-stride loop a pixel. The y taps
//     are computed once a thread (its pixels share a row). An image of
//     2^31 values or more (about 716 MP) is launched in H-bands that
//     stay below it, each at its row offset, with the same result.
//   * Four blocks an SM: the launch bounds hold a thread to 64
//     registers, so that 32 warps an SM hide the latencies of a kernel
//     that is bound by the instructions it issues.
//   * None of the TPU tile planner (cell windows, strips, one-hot
//     contractions) is carried over: the tile is fixed, and its window
//     follows from the scales.

#include <cstdint>
#include <cuda_runtime.h>

#include "launchers.cuh"
#include "slice_common.cuh"
#include "slice_tile.cuh"

namespace {

using hdrnet::add_cell;
using hdrnet::clamp01;
using hdrnet::depth_taps;
using hdrnet::kPix;
using hdrnet::kTileH;
using hdrnet::kTileW;
using hdrnet::spatial_taps;
using hdrnet::store4;
using hdrnet::Taps;
using hdrnet::Window;

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

constexpr int kThreads = hdrnet::kTileThreads;

// A channel in [0, 1]: float as is; uint8 v as v / 255 (IEEE division),
// looked up in a 256-entry table of those quotients that the block fills.
__device__ __forceinline__ float unit(float v, const float*) { return v; }
__device__ __forceinline__ float unit(uint8_t v, const float* u8_unit) {
  return u8_unit[v];
}

// Clip is enforced by the wrapper, so v * 255 + 0.5 is in [0.5, 255.5].
__device__ __forceinline__ uint8_t quant(float v) {
  return static_cast<uint8_t>(
      static_cast<int>(__fadd_rn(__fmul_rn(v, 255.0f), 0.5f)));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(uint8_t* p, float v) { *p = quant(v); }

// The 4 pixels' channels: 3 x 16-byte (f32) or 3 x 4-byte (u8) loads.
__device__ __forceinline__ void load4(const float* src, float img[kPix][kNIn],
                                      const float*) {
  hdrnet::load4(src, img);
}
__device__ __forceinline__ void load4(const uint8_t* src,
                                      float img[kPix][kNIn],
                                      const float* u8_unit) {
  const unsigned* s4 = reinterpret_cast<const unsigned*>(src);
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const unsigned u = __ldg(s4 + q);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = 4 * q + e;
      img[k / 3][k % 3] = unit(static_cast<uint8_t>(u >> (8 * e)), u8_unit);
    }
  }
}

__device__ __forceinline__ void store4(uint8_t* dst,
                                       const float o[kPix][kNOut]) {
  unsigned* d4 = reinterpret_cast<unsigned*>(dst);
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    unsigned u = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = 4 * q + e;
      u |= static_cast<unsigned>(quant(o[k / 3][k % 3])) << (8 * e);
    }
    d4[q] = u;
  }
}

// The guide functors: kSmem floats of staged parameters; stage() copies
// (and may re-lay) the packed vector into them; eval() is the guide of
// a thread's 4 pixels (npx of them in the frame, the first at pixel `pix`
// of the launch; v4: a whole, aligned 4-pixel group), with each pixel's
// operations in the plain version's order and each parameter read once
// for the 4; at(n) is the functor for a launch that starts n pixels
// further into the frame.

// Literal relu form of the curves guide (pallas.py:514-526).
struct CurvesGuide {
  static constexpr int kSmem = kNParams;
  __device__ __forceinline__ void stage(const float* __restrict__ params,
                                        float* p) const {
    for (int i = threadIdx.x; i < kNParams; i += blockDim.x) p[i] = params[i];
  }
  __host__ __device__ CurvesGuide at(long long) const { return *this; }
  __device__ __forceinline__ void eval(const float* p,
                                       const float img[kPix][kNIn],
                                       float out[kPix], long long, int,
                                       bool) const {
    float acc[kPix];
#pragma unroll
    for (int k = 0; k < kPix; ++k) acc[k] = 0.0f;
#pragma unroll
    for (int c = 0; c < kNIn; ++c) {
      float g[kPix], cur[kPix];
      const float bias = p[kCcm + kNIn * kNIn + c];
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        g[k] = bias;
        cur[k] = 0.0f;
      }
#pragma unroll
      for (int j = 0; j < kNIn; ++j) {
        const float m = p[kCcm + j * kNIn + c];
#pragma unroll
        for (int k = 0; k < kPix; ++k) g[k] += img[k][j] * m;
      }
      const float4* sh4 = reinterpret_cast<const float4*>(p + kShifts) + c * 4;
      const float4* sl4 = reinterpret_cast<const float4*>(p + kSlopes) + c * 4;
#pragma unroll
      for (int q = 0; q < kNPts / 4; ++q) {
        const float4 sh = sh4[q], sl = sl4[q];
        const float shv[4] = {sh.x, sh.y, sh.z, sh.w};
        const float slv[4] = {sl.x, sl.y, sl.z, sl.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
#pragma unroll
          for (int k = 0; k < kPix; ++k) {
            cur[k] += slv[e] * fmaxf(g[k] - shv[e], 0.0f);
          }
        }
      }
      const float mix = p[kMix + c];
#pragma unroll
      for (int k = 0; k < kPix; ++k) acc[k] += cur[k] * mix;
    }
    const float mix_bias = p[kMix + kNIn];
#pragma unroll
    for (int k = 0; k < kPix; ++k) out[k] = clamp01(acc[k] + mix_bias);
  }
};

// Pointwise MLP guide with the batch norm folded in (pallas.py:529-544):
// the same sums in the same order as the TPU kernel. Staged per hidden
// unit k: (W1[0][k], W1[1][k], W1[2][k], b1[k]) as one float4, then w2.
struct NNGuide {
  static constexpr int kSmem = 4 * kMaxGC + kMaxGC + 1;
  int gc;
  __device__ __forceinline__ void stage(const float* __restrict__ params,
                                        float* p) const {
    for (int i = threadIdx.x; i < 5 * gc + 1; i += blockDim.x) {
      if (i < 4 * gc) {
        const int k = i / 4, j = i % 4;
        p[i] = params[j * gc + k];  // j = 3: the bias row
      } else {
        p[4 * kMaxGC + i - 4 * gc] = params[i];
      }
    }
  }
  __host__ __device__ NNGuide at(long long) const { return *this; }
  __device__ __forceinline__ void eval(const float* p,
                                       const float img[kPix][kNIn],
                                       float out[kPix], long long, int,
                                       bool) const {
    const float4* w1 = reinterpret_cast<const float4*>(p);
    const float* w2 = p + 4 * kMaxGC;
    float acc[kPix];
#pragma unroll
    for (int k = 0; k < kPix; ++k) acc[k] = w2[gc];
    for (int u = 0; u < gc; ++u) {
      const float4 a = w1[u];
      const float b = w2[u];
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        float h = a.w;
        h += img[k][0] * a.x;
        h += img[k][1] * a.y;
        h += img[k][2] * a.z;
        acc[k] += fmaxf(h, 0.0f) * b;
      }
    }
#pragma unroll
    for (int k = 0; k < kPix; ++k) out[k] = 1.0f / (1.0f + expf(-acc[k]));
  }
};

// K3's guide: loaded from the frame's guide (B, H, W), one 16-byte load
// for a whole 4-pixel group where the guide is aligned (vec), else one
// scalar a pixel. No parameters (one unused float: no zero-length array).
struct LoadedGuide {
  static constexpr int kSmem = 1;
  const float* guide;  // pixel 0 of the launch
  int vec;
  __device__ __forceinline__ void stage(const float*, float*) const {}
  __host__ __device__ LoadedGuide at(long long n) const {
    return LoadedGuide{guide + n, vec};
  }
  __device__ __forceinline__ void eval(const float*, const float[kPix][kNIn],
                                       float out[kPix], long long pix,
                                       int npx, bool v4) const {
    const float* g = guide + pix;
    if (v4 && vec) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(g));
      out[0] = v.x;
      out[1] = v.y;
      out[2] = v.z;
      out[3] = v.w;
    } else {
#pragma unroll
      for (int k = 0; k < kPix; ++k) out[k] = k < npx ? __ldg(g + k) : 0.0f;
    }
  }
};

// Dynamic shared memory: the tile's cell window (ny, nx, gd, 12) when
// kStaged (the launcher's bound fits a block), else none: the corners are
// then read from the image's grid in device memory. A template argument,
// so that each instantiation reads its corners through one address space
// (shared loads, or global ones), never through generic 64-bit loads.
// Four blocks an SM (at most 64 registers a thread): the kernel is bound
// by the instructions it issues, and 32 warps an SM hide their latencies
// better than the 24 that 74 registers a thread would leave.
template <typename Guide, typename TIn, typename TOut, bool kStaged>
__global__ void __launch_bounds__(kThreads, 4)
    enhance_fused_kernel(const float* __restrict__ grid,
                         const TIn* __restrict__ frame,
                         const float* __restrict__ params, Guide guide_fn,
                         TOut* __restrict__ out, int clip, int vec, int h,
                         int w, int gh, int gw, int gd, int y_off, int x_off,
                         float sy, float sx) {
  __shared__ float4 p4[(Guide::kSmem + 3) / 4];
  __shared__ float u8_unit[sizeof(TIn) == 1 ? 256 : 1];
  extern __shared__ float4 win4[];
  float* p = reinterpret_cast<float*>(p4);
  guide_fn.stage(params, p);
  if (sizeof(TIn) == 1) {
    for (int i = threadIdx.x; i < 256; i += kThreads) {
      u8_unit[i] = __fdiv_rn(static_cast<float>(i), 255.0f);
    }
  }

  // The tile and its window of cells.
  const int ty0 = blockIdx.y * kTileH;
  const int tx0 = blockIdx.x * kTileW;
  const int rows = min(kTileH, h - ty0);
  const int cols = min(kTileW, w - tx0);
  const int cell_floats = gd * kNC;
  const Window win = hdrnet::tile_window<kStaged>(
      grid + static_cast<long long>(blockIdx.z) * gh * gw * cell_floats, win4,
      cell_floats, ty0 + y_off, rows, tx0 + x_off, cols, gh, gw, sy, sx);
  __syncthreads();

  const int r = threadIdx.x / (kTileW / kPix);
  const int xq = (threadIdx.x % (kTileW / kPix)) * kPix;
  if (r >= rows || xq >= cols) return;
  const int y = ty0 + r;
  const int x = tx0 + xq;
  const int npx = min(kPix, w - x);
  const long long image = static_cast<long long>(blockIdx.z) * h * w;
  // 32-bit inside an image: the launcher keeps h * w * 3 below 2^31.
  const int at = (y * w + x) * kNIn;
  const TIn* src = frame + image * kNIn + at;
  TOut* dst = out + image * kNOut + at;

  float img[kPix][kNIn];
  if (vec && npx == kPix) {
    load4(src, img, u8_unit);
  } else {
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
#pragma unroll
      for (int j = 0; j < kNIn; ++j) {
        img[k][j] =
            k < npx ? unit(__ldg(src + k * kNIn + j), u8_unit) : 0.0f;
      }
    }
  }

  float guide[kPix];
  guide_fn.eval(p, img, guide, image + y * w + x, npx, vec && npx == kPix);

  // Taps of the global pixel (the launcher bounds y + y_off by h_total
  // and x + x_off by w_total, both ints): weights at unclamped centres,
  // clamped reads, from the window (or the grid).
  const Taps ty = spatial_taps(y + y_off, sy, gh);
  float o[kPix][kNOut];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const Taps tx = spatial_taps(x + k + x_off, sx, gw);
    const Taps tz = depth_taps(guide[k], gd);
    float sliced[kNC];
#pragma unroll
    for (int q = 0; q < kNC; ++q) sliced[q] = 0.0f;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float wyx = ty.w[a] * tx.w[c];
        const float* cell =
            win.p + ((ty.i[a] - win.wy0) * win.nx + (tx.i[c] - win.wx0)) *
                        cell_floats;
        add_cell(sliced, wyx * tz.w[0], cell + tz.i[0] * kNC);
        add_cell(sliced, wyx * tz.w[1], cell + tz.i[1] * kNC);
      }
    }
#pragma unroll
    for (int i = 0; i < kNOut; ++i) {
      float acc = sliced[i * (kNIn + 1) + kNIn];  // the affine offset
#pragma unroll
      for (int j = 0; j < kNIn; ++j) {
        acc += sliced[i * (kNIn + 1) + j] * img[k][j];
      }
      o[k][i] = clip ? clamp01(acc) : acc;
    }
  }

  if (vec && npx == kPix) {
    store4(dst, o);
  } else {
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      if (k < npx) {
#pragma unroll
        for (int i = 0; i < kNOut; ++i) store(dst + k * kNOut + i, o[k][i]);
      }
    }
  }
}

template <typename Guide, typename TIn, typename TOut>
cudaError_t launch(const float* grid, const void* frame, const float* params,
                   Guide guide_fn, void* out, int clip, int b, int h, int w,
                   int gh, int gw, int gd, int y_off, int x_off, float sy,
                   float sx, cudaStream_t st) {
  const long long want = hdrnet::window_bytes(h, w, sy, sx, gh, gw, gd, kNC);
  const int staged = want <= hdrnet::kMaxWindowBytes;
  const int win_bytes = staged ? static_cast<int>(want) : 0;
  auto kernel = staged ? enhance_fused_kernel<Guide, TIn, TOut, true>
                       : enhance_fused_kernel<Guide, TIn, TOut, false>;
  // A block takes 48 KB of shared memory by default, static and dynamic
  // together; the static arrays (staged parameters, the uint8 table) hold
  // at most 2.3 KB. Above that the window needs the attribute, set once to
  // the largest window: it never drops below a launch that a CUDA graph
  // has captured.
  if (win_bytes > 44 * 1024) {
    static const cudaError_t allowed = cudaFuncSetAttribute(
        enhance_fused_kernel<Guide, TIn, TOut, true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, hdrnet::kMaxWindowBytes);
    if (allowed != cudaSuccess) return allowed;
  }
  // Vectors need rows of whole 4-pixel groups and aligned pointers.
  const std::uintptr_t align = sizeof(TIn) == 1 ? 4 : 16;
  const std::uintptr_t align_out = sizeof(TOut) == 1 ? 4 : 16;
  const long long cells = static_cast<long long>(gh) * gw * gd * kNC;
  // A frame too large for one launch goes in H-bands, each at its offset
  // (K7's arguments), so its pixels take the same taps and float
  // operations as in one launch.
  return hdrnet::for_each_band(b, h, w, kNIn, [&](int i, int nb, int y0,
                                                  int nh) {
    const long long px = (static_cast<long long>(i) * h + y0) * w;
    const TIn* src = static_cast<const TIn*>(frame) + px * kNIn;
    TOut* dst = static_cast<TOut*>(out) + px * kNOut;
    const int vec = w % kPix == 0 &&
                    reinterpret_cast<std::uintptr_t>(src) % align == 0 &&
                    reinterpret_cast<std::uintptr_t>(dst) % align_out == 0;
    kernel<<<hdrnet::tile_blocks(w, nh, nb), kThreads, win_bytes, st>>>(
        grid + i * cells, src, params, guide_fn.at(px), dst, clip, vec, nh,
        w, gh, gw, gd, y_off + y0, x_off, sy, sx);
    return cudaGetLastError();
  });
}

// Checks the band, picks the input and output types; returns
// cudaGetLastError(), or cudaErrorInvalidValue without a launch for a band
// outside [0, h_total) x [0, w_total).
template <typename Guide>
int dispatch(const void* grid, const void* frame, int u8_in,
             const void* params, Guide guide_fn, void* out, int u8_out,
             int clip, int b, int h, int w, int gh, int gw, int gd, int y_off,
             int x_off, int h_total, int w_total, float sy, float sx,
             void* stream) {
  if (y_off < 0 || x_off < 0 || h > h_total - y_off || w > w_total - x_off)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(b) * h * w == 0)
    return static_cast<int>(cudaGetLastError());
  const float* g = static_cast<const float*>(grid);
  const float* p = static_cast<const float*>(params);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (u8_in && u8_out) {
    err = launch<Guide, uint8_t, uint8_t>(g, frame, p, guide_fn, out, clip, b,
                                          h, w, gh, gw, gd, y_off, x_off, sy,
                                          sx, st);
  } else if (u8_in) {
    err = launch<Guide, uint8_t, float>(g, frame, p, guide_fn, out, clip, b,
                                        h, w, gh, gw, gd, y_off, x_off, sy,
                                        sx, st);
  } else if (u8_out) {
    err = launch<Guide, float, uint8_t>(g, frame, p, guide_fn, out, clip, b,
                                        h, w, gh, gw, gd, y_off, x_off, sy,
                                        sx, st);
  } else {
    err = launch<Guide, float, float>(g, frame, p, guide_fn, out, clip, b, h,
                                      w, gh, gw, gd, y_off, x_off, sy, sx,
                                      st);
  }
  return static_cast<int>(err);
}

}  // namespace

namespace hdrnet {

// K3 at n_in = n_out = 3 with an offset: slice, apply, no clip, with the
// guide loaded (one launch of K1's kernel; its window, tiles and bands,
// and K7's row offset for a band of a frame).
cudaError_t slice_apply_fwd_fixed(const float* grid, const float* guide,
                                  const float* image, float* out, int b,
                                  int h, int w, int gh, int gw, int gd,
                                  int y_off, float sy, float sx,
                                  cudaStream_t stream) {
  const LoadedGuide loaded{guide, w % kPix == 0 && aligned16(guide)};
  return launch<LoadedGuide, float, float>(grid, image, nullptr, loaded, out,
                                           0, b, h, w, gh, gw, gd, y_off, 0,
                                           sy, sx, stream);
}

}  // namespace hdrnet

// K1 (K7 with nonzero offsets or totals above h, w). sy = gh / h_total
// and sx = gw / w_total, computed by the caller.
extern "C" int hdrnet_enhance_fused(const void* grid, const void* frame,
                                    int u8_in, const void* params, void* out,
                                    int u8_out, int clip, int b, int h, int w,
                                    int gh, int gw, int gd, int y_off,
                                    int x_off, int h_total, int w_total,
                                    float sy, float sx, void* stream) {
  return dispatch(grid, frame, u8_in, params, CurvesGuide{}, out, u8_out,
                  clip, b, h, w, gh, gw, gd, y_off, x_off, h_total, w_total,
                  sy, sx, stream);
}

// K6 (and K7 in NN mode). gc must be in [1, kMaxGC]: the wrapper checks
// it, and a value outside is refused here as cudaErrorInvalidValue without
// a launch.
extern "C" int hdrnet_enhance_fused_nn(const void* grid, const void* frame,
                                       int u8_in, const void* params, int gc,
                                       void* out, int u8_out, int clip,
                                       int b, int h, int w, int gh, int gw,
                                       int gd, int y_off, int x_off,
                                       int h_total, int w_total, float sy,
                                       float sx, void* stream) {
  if (gc < 1 || gc > kMaxGC) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(grid, frame, u8_in, params, NNGuide{gc}, out, u8_out, clip,
                  b, h, w, gh, gw, gd, y_off, x_off, h_total, w_total, sy, sx,
                  stream);
}
