// K3, K4, K5: the bilateral slice-apply with an external guide, and its
// two backward passes, the training path of HDRNetCurves.
//
// Layouts (float32, contiguous): grid (B, gh, gw, gd, C) with
// C = n_out * ni_tot packed row-major (channel i * ni_tot + j; j = n_in is
// the affine offset when has_offset), guide (B, H, W), image (B, H, W,
// n_in), output and its cotangent ct (B, H, W, n_out). n_in = 0 with
// has_offset is the plain slice: ni_tot = 1 and the output is the C sliced
// channels. n_in <= kMaxNIn; n_out and C are runtime values.
//
// K3 slice_apply_fwd: replaces hdrnet_tpu/ops/pallas.py slice_apply_fwd
//   (pallas_call at pallas.py:1097) -> _fwd_kernel (pallas.py:570) with
//   _apply_epilogue (610). One thread per pixel: read the guide, gather
//   8 corners x C from the grid, apply the affine (no clip). Bound (derived
//   from the shapes, not measured): at 2048^2 with n_in = n_out = 3 it
//   reads 4 + 12 + 0 bytes a pixel besides the grid and writes 12, about
//   117 MB, or 35 us at 3.35 TB/s; the 96 grid reads a pixel hit L1/L2
//   (the grid is 98 KB an image), so the load pipe, not DRAM, is the
//   likely limit. The design keeps one pass with no intermediate: the
//   sliced coefficients of one output channel live in registers only.
// K4 slice_apply_pix_bwd: replaces pallas.py slice_apply_pix_bwd
//   (pallas_call at pallas.py:1357) -> _pix_bwd_kernel (pallas.py:694).
//   One thread per pixel, both cotangents from one gather: the slice with
//   the depth weights (for d_input) and with their guide derivatives (for
//   d_guide) share every grid read. About 30% more bytes than K3 (ct in,
//   two outputs) and twice its FMAs; same bound, same design.
// K5 slice_apply_grid_bwd: replaces pallas.py slice_apply_grid_bwd
//   (pallas_call at pallas.py:1315) -> _grid_bwd_kernel (pallas.py:757).
//   A splat of ct_i * in_ext_j over the mirror-padded image into the grid.
//   One block per (b, grid cell y, grid cell x) gathers from the padded
//   pixels whose tent reaches its cell (the gather form of the original
//   CUDA op): ~258 x 258 pixels at 2048^2 on a 16 x 16 grid, so each
//   pixel is read by about 4 blocks, ~470 MB a step, ~0.14 ms at
//   3.35 TB/s; the per-pixel arithmetic (two depth weights, C products)
//   is small beside the reduction, which is the real cost. It is
//   deterministic: no float atomics. Each tile of 256 pixels is first
//   turned into records (lowest depth bin, its two weights, C products)
//   in shared memory; then thread (s, c) owns column c of private
//   accumulator set s and adds the records s, s + nsub, ... in order;
//   finally the nsub sets are summed in a fixed order and written once.
//   The mirror is done in the index, with no padded copies.
//
// None of the TPU tile planner (cell windows, strips, z strategies) is
// carried over: a per-pixel gather has no window cap.

#include <cuda_runtime.h>

#include "slice_common.cuh"

namespace {

using hdrnet::clampi;
using hdrnet::depth_taps;
using hdrnet::kEps;
using hdrnet::spatial_taps;
using hdrnet::Taps;

constexpr int kMaxNIn = 6;
constexpr int kMaxExt = kMaxNIn + 1;
constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;

struct Geometry {
  int b, h, w, gh, gw, gd;
  int n_in, n_out, ni_tot, has_offset;
  float sy, sx;  // gh / h, gw / w
};

// Per-pixel corner table: the 8 corner weights and grid offsets.
struct Corners {
  float w[8];
  float dw[8];  // depth-derivative weights (K4 only)
  long long off[8];
};

__device__ __forceinline__ Corners corners(const Geometry& g, long long bb,
                                           int y, int x, float guide,
                                           bool derivative) {
  const Taps ty = spatial_taps(y, g.sy, g.gh);
  const Taps tx = spatial_taps(x, g.sx, g.gw);
  float dz[2] = {0.0f, 0.0f};
  const Taps tz = depth_taps(guide, g.gd, derivative ? dz : nullptr);
  const int c = g.n_out * g.ni_tot;
  const long long base = bb * g.gh * g.gw * g.gd;
  Corners k;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float wyx = ty.w[a] * tx.w[e];
      const long long cell =
          (base + (static_cast<long long>(ty.i[a]) * g.gw + tx.i[e]) * g.gd);
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        const int n = (a * 2 + e) * 2 + d;
        k.w[n] = wyx * tz.w[d];
        k.dw[n] = wyx * dz[d];
        k.off[n] = (cell + tz.i[d]) * c;
      }
    }
  }
  return k;
}

// in_ext: the n_in image channels, then 1 for the offset.
__device__ __forceinline__ void load_ext(const Geometry& g,
                                         const float* __restrict__ image,
                                         long long pix, float ext[kMaxExt]) {
#pragma unroll
  for (int j = 0; j < kMaxExt; ++j) {
    ext[j] = j < g.n_in ? __ldg(image + pix * g.n_in + j) : 1.0f;
  }
}

__global__ void __launch_bounds__(kThreads)
    slice_apply_fwd_kernel(Geometry g, const float* __restrict__ grid,
                           const float* __restrict__ guide,
                           const float* __restrict__ image,
                           float* __restrict__ out) {
  const long long npix = static_cast<long long>(g.b) * g.h * g.w;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long pix = static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
       pix < npix; pix += stride) {
    const int x = static_cast<int>(pix % g.w);
    const long long row = pix / g.w;
    const int y = static_cast<int>(row % g.h);
    const long long bb = row / g.h;
    const Corners k = corners(g, bb, y, x, __ldg(guide + pix), false);
    float ext[kMaxExt];
    load_ext(g, image, pix, ext);
    for (int i = 0; i < g.n_out; ++i) {
      float s[kMaxExt];
#pragma unroll
      for (int j = 0; j < kMaxExt; ++j) s[j] = 0.0f;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float* cell = grid + k.off[n] + i * g.ni_tot;
#pragma unroll
        for (int j = 0; j < kMaxExt; ++j) {
          if (j < g.ni_tot) s[j] += k.w[n] * __ldg(cell + j);
        }
      }
      // out_i = offset + sum_j A_ij * in_j, in the order of K1. The
      // offset is picked by an unrolled compare, so s stays in registers.
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < kMaxExt; ++j) {
        if (g.has_offset && j == g.n_in) acc = s[j];
      }
#pragma unroll
      for (int j = 0; j < kMaxNIn; ++j) {
        if (j < g.n_in) acc += s[j] * ext[j];
      }
      out[pix * g.n_out + i] = acc;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    slice_apply_pix_bwd_kernel(Geometry g, const float* __restrict__ grid,
                               const float* __restrict__ guide,
                               const float* __restrict__ image,
                               const float* __restrict__ ct,
                               float* __restrict__ d_guide,
                               float* __restrict__ d_image) {
  const long long npix = static_cast<long long>(g.b) * g.h * g.w;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long pix = static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
       pix < npix; pix += stride) {
    const int x = static_cast<int>(pix % g.w);
    const long long row = pix / g.w;
    const int y = static_cast<int>(row % g.h);
    const long long bb = row / g.h;
    const Corners k = corners(g, bb, y, x, __ldg(guide + pix), true);
    float ext[kMaxExt];
    load_ext(g, image, pix, ext);
    float dg = 0.0f;
    float di[kMaxNIn];
#pragma unroll
    for (int j = 0; j < kMaxNIn; ++j) di[j] = 0.0f;
    for (int i = 0; i < g.n_out; ++i) {
      float s[kMaxExt], sdz[kMaxExt];
#pragma unroll
      for (int j = 0; j < kMaxExt; ++j) s[j] = sdz[j] = 0.0f;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float* cell = grid + k.off[n] + i * g.ni_tot;
#pragma unroll
        for (int j = 0; j < kMaxExt; ++j) {
          if (j < g.ni_tot) {
            const float v = __ldg(cell + j);
            s[j] += k.w[n] * v;
            sdz[j] += k.dw[n] * v;
          }
        }
      }
      const float cti = __ldg(ct + pix * g.n_out + i);
      // d_guide += ct_i * sum_j sliced_dz[i, j] * in_ext_j
      float gacc = 0.0f;
#pragma unroll
      for (int j = 0; j < kMaxExt; ++j) {
        if (j < g.ni_tot) gacc += sdz[j] * ext[j];
      }
      dg += gacc * cti;
      // d_in_j += sliced[i, j] * ct_i
#pragma unroll
      for (int j = 0; j < kMaxNIn; ++j) {
        if (j < g.n_in) di[j] += s[j] * cti;
      }
    }
    d_guide[pix] = dg;
    if (d_image != nullptr) {
#pragma unroll
      for (int j = 0; j < kMaxNIn; ++j) {
        if (j < g.n_in) d_image[pix * g.n_in + j] = di[j];
      }
    }
  }
}

// Edge-inclusive mirror of a padded coordinate: -1 -> 0, n -> n - 1.
__device__ __forceinline__ int mirror(int v, int n) {
  return v < 0 ? -1 - v : (v >= n ? 2 * n - 1 - v : v);
}

// Direct tent weight of padded pixel coordinate v against cell a.
__device__ __forceinline__ float cell_weight(int a, int v, float scale) {
  const float gf = (static_cast<float>(v) + 0.5f) * scale;
  return fmaxf(1.0f - fabsf(static_cast<float>(a) + 0.5f - gf), 0.0f);
}

// Smoothed depth tent of cell k with the z-extreme overrides to 1.
__device__ __forceinline__ float depth_weight(int k, float gz, int gd) {
  if ((k == 0 && gz < 0.5f) ||
      (k == gd - 1 && gz > static_cast<float>(gd) - 0.5f)) {
    return 1.0f;
  }
  const float d = (static_cast<float>(k) + 0.5f) - gz;
  return fmaxf(1.0f - sqrtf(d * d + kEps), 0.0f);
}

// Padded rows [lo, hi] whose tent can reach cell a: gf in (a - .5, a + 1.5)
// with one pixel of margin for rounding; weights are evaluated exactly.
__device__ __forceinline__ void footprint(int a, float scale, int n, int pad,
                                          int* lo, int* hi) {
  *lo = max(-pad,
            static_cast<int>(floorf((a - 0.5f) / scale - 0.5f)) - 1);
  *hi = min(n + pad - 1,
            static_cast<int>(ceilf((a + 1.5f) / scale - 0.5f)) + 1);
}

// Dynamic shared memory: records (rec_w: 2 floats, rec_lo: 1 int, rec_f:
// cs floats a pixel), then nsub * gd * C accumulators.
__global__ void __launch_bounds__(kThreads)
    slice_apply_grid_bwd_kernel(Geometry g, int pad_y, int pad_x, int nsub,
                                int cs, const float* __restrict__ guide,
                                const float* __restrict__ image,
                                const float* __restrict__ ct,
                                float* __restrict__ out) {
  extern __shared__ float smem[];
  const int c_n = g.n_out * g.ni_tot;
  float* rec_w = smem;                            // (kThreads, 2)
  int* rec_lo = reinterpret_cast<int*>(rec_w + 2 * kThreads);
  float* rec_f = reinterpret_cast<float*>(rec_lo + kThreads);  // (T, cs)
  float* acc = rec_f + kThreads * cs;             // (nsub, gd, C)

  const int cx = blockIdx.x;
  const int cy = blockIdx.y;
  const long long bb = blockIdx.z;
  const int t = threadIdx.x;
  const int n_acc = nsub * g.gd * c_n;
  for (int i = t; i < n_acc; i += kThreads) acc[i] = 0.0f;

  int y_lo, y_hi, x_lo, x_hi;
  footprint(cy, g.sy, g.h, pad_y, &y_lo, &y_hi);
  footprint(cx, g.sx, g.w, pad_x, &x_lo, &x_hi);
  const int fw = x_hi - x_lo + 1;
  const int n_pix = (y_hi - y_lo + 1) * fw;
  const long long plane = static_cast<long long>(g.h) * g.w;
  const float fgd = static_cast<float>(g.gd);
  // This thread's role in the accumulation phase.
  const int s = t / c_n;
  const int c = t % c_n;
  const bool accumulates = s < nsub;
  float* my_acc = acc + s * g.gd * c_n + c;

  for (int q0 = 0; q0 < n_pix; q0 += kThreads) {
    __syncthreads();  // the previous tile's records are consumed
    // Phase 1: one padded pixel a thread -> one record.
    const int q = q0 + t;
    float wa = 0.0f, wb = 0.0f;
    int lo = 0;
    if (q < n_pix) {
      const int yp = y_lo + q / fw;
      const int xp = x_lo + q % fw;
      const float wyx = cell_weight(cy, yp, g.sy) * cell_weight(cx, xp, g.sx);
      if (wyx > 0.0f) {
        const long long pix =
            bb * plane + static_cast<long long>(mirror(yp, g.h)) * g.w +
            mirror(xp, g.w);
        const float gz = __ldg(guide + pix) * fgd;
        lo = clampi(static_cast<int>(floorf(gz - 0.5f)), g.gd - 1);
        // Only bins lo and lo + 1 can carry weight (the others are past
        // the tent's reach or below/above an override).
        wa = wyx * depth_weight(lo, gz, g.gd);
        wb = lo + 1 < g.gd ? wyx * depth_weight(lo + 1, gz, g.gd) : 0.0f;
        float* f = rec_f + t * cs;
        for (int i = 0; i < g.n_out; ++i) {
          const float cti = __ldg(ct + pix * g.n_out + i);
          for (int j = 0; j < g.n_in; ++j) {
            f[i * g.ni_tot + j] = cti * __ldg(image + pix * g.n_in + j);
          }
          if (g.has_offset) f[i * g.ni_tot + g.n_in] = cti;
        }
      }
    }
    rec_w[2 * t] = wa;
    rec_w[2 * t + 1] = wb;
    rec_lo[t] = lo;
    __syncthreads();
    // Phase 2: thread (s, c) adds records s, s + nsub, ... to its column.
    if (accumulates) {
      for (int p = s; p < kThreads; p += nsub) {
        const float pa = rec_w[2 * p];
        const float pb = rec_w[2 * p + 1];
        if (pa == 0.0f && pb == 0.0f) continue;
        const int plo = rec_lo[p];
        const float f = rec_f[p * cs + c];
        my_acc[plo * c_n] += pa * f;
        if (plo + 1 < g.gd) my_acc[(plo + 1) * c_n] += pb * f;
      }
    }
  }
  __syncthreads();
  // Phase 3: sum the nsub sets in order; one write per grid entry.
  float* o = out + ((bb * g.gh + cy) * g.gw + cx) * g.gd * c_n;
  for (int e = t; e < g.gd * c_n; e += kThreads) {
    float v = 0.0f;
    for (int k = 0; k < nsub; ++k) v += acc[k * g.gd * c_n + e];
    o[e] = v;
  }
}

Geometry make_geometry(int b, int h, int w, int gh, int gw, int gd,
                       int n_in, int n_out, int has_offset, float sy,
                       float sx) {
  return Geometry{b, h, w, gh, gw, gd, n_in, n_out,
                  n_in + (has_offset ? 1 : 0), has_offset, sy, sx};
}

int pixel_blocks(const Geometry& g) {
  const long long npix = static_cast<long long>(g.b) * g.h * g.w;
  long long blocks = (npix + kThreads - 1) / kThreads;
  return static_cast<int>(blocks > kMaxBlocks ? kMaxBlocks : blocks);
}

}  // namespace

// Shapes and kMaxNIn are checked by the Python wrappers
// (hdrnet_torch/ops/slice_apply.py); each launcher returns
// cudaGetLastError().

extern "C" int hdrnet_slice_apply_fwd(const void* grid, const void* guide,
                                      const void* image, void* out, int b,
                                      int h, int w, int gh, int gw, int gd,
                                      int n_in, int n_out, int has_offset,
                                      float sy, float sx, void* stream) {
  const Geometry g =
      make_geometry(b, h, w, gh, gw, gd, n_in, n_out, has_offset, sy, sx);
  if (static_cast<long long>(b) * h * w == 0)
    return static_cast<int>(cudaGetLastError());
  slice_apply_fwd_kernel<<<pixel_blocks(g), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      g, static_cast<const float*>(grid), static_cast<const float*>(guide),
      static_cast<const float*>(image), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hdrnet_slice_apply_pix_bwd(
    const void* grid, const void* guide, const void* image, const void* ct,
    void* d_guide, void* d_image, int b, int h, int w, int gh, int gw,
    int gd, int n_in, int n_out, int has_offset, float sy, float sx,
    void* stream) {
  const Geometry g =
      make_geometry(b, h, w, gh, gw, gd, n_in, n_out, has_offset, sy, sx);
  if (static_cast<long long>(b) * h * w == 0)
    return static_cast<int>(cudaGetLastError());
  slice_apply_pix_bwd_kernel<<<pixel_blocks(g), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      g, static_cast<const float*>(grid), static_cast<const float*>(guide),
      static_cast<const float*>(image), static_cast<const float*>(ct),
      static_cast<float*>(d_guide), static_cast<float*>(d_image));
  return static_cast<int>(cudaGetLastError());
}

// The dynamic shared memory K5 needs for C channels and gd bins, in bytes;
// nsub and the record stride cs are returned for the launch.
extern "C" int hdrnet_slice_apply_grid_bwd_smem(int c_n, int gd, int* nsub,
                                                int* cs) {
  *nsub = kThreads / c_n;
  *cs = c_n | 1;  // odd stride: record writes hit distinct banks
  return static_cast<int>(sizeof(float)) *
         (3 * kThreads + kThreads * *cs + *nsub * gd * c_n);
}

extern "C" int hdrnet_slice_apply_grid_bwd(
    const void* guide, const void* image, const void* ct, void* out, int b,
    int h, int w, int gh, int gw, int gd, int n_in, int n_out,
    int has_offset, float sy, float sx, int pad_y, int pad_x, void* stream) {
  const Geometry g =
      make_geometry(b, h, w, gh, gw, gd, n_in, n_out, has_offset, sy, sx);
  int nsub = 0, cs = 0;
  const int smem = hdrnet_slice_apply_grid_bwd_smem(n_out * g.ni_tot, gd,
                                                    &nsub, &cs);
  cudaError_t err = cudaFuncSetAttribute(
      slice_apply_grid_bwd_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 blocks(gw, gh, b);
  slice_apply_grid_bwd_kernel<<<blocks, kThreads, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      g, pad_y, pad_x, nsub, cs, static_cast<const float*>(guide),
      static_cast<const float*>(image), static_cast<const float*>(ct),
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
