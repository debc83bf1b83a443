// K3, K4, K5: the bilateral slice-apply with an external guide, and its
// two backward passes, the training path of every HDRNet model and of
// fit_grid.
//
// Layouts (float32, contiguous): grid (B, gh, gw, gd, C) with
// C = n_out * ni_tot packed row-major (channel i * ni_tot + j; j = n_in is
// the affine offset when has_offset), guide (B, H, W), image (B, H, W,
// n_in), output and its cotangent ct (B, H, W, n_out). n_in = 0 with
// has_offset is the plain slice: ni_tot = 1 and the output is the C sliced
// channels. n_in, n_out and C are runtime values; the models' 3 -> 3 with
// an offset (C = 12) has kernels of its own.
//
// K3 slice_apply_fwd: replaces hdrnet_tpu/ops/pallas.py slice_apply_fwd
//   (pallas_call at pallas.py:1097) -> _fwd_kernel (pallas.py:570) with
//   _apply_epilogue (610): out_i = sum_j sliced[i, j] in_j + sliced[i,
//   n_in]. What bounds it (derived from the shapes, not measured): at
//   2048^2, 3 -> 3, it must read guide and image and write the output, 28
//   bytes a pixel, 117 MB, 35 us at 3.35 TB/s; its 271 float operations a
//   pixel are 17 us at 67 TFLOP/s. Like K1 it is held back in practice by
//   the instructions it issues: 96 corner FMAs a pixel, its taps, and
//   every load and index operation around them.
//   The design: at 3 -> 3 with an offset K3 is K1's kernel
//   (fused_slice_apply.cu, slice_apply_fwd_fixed) with a guide functor
//   that loads the guide (one 16-byte load for a thread's 4 pixels) and
//   the clip off: K1's tiles, window, vector I/O and bands. Other channel
//   counts run the generic tile kernel below.
// K4 slice_apply_pix_bwd: replaces pallas.py slice_apply_pix_bwd
//   (pallas_call at pallas.py:1357) -> _pix_bwd_kernel (pallas.py:694):
//   d_guide = sum_i ct_i sum_j (d sliced / d z)[i, j] in_ext_j and, when
//   asked for, d_image_j = sum_i sliced[i, j] ct_i. What bounds it
//   (derived): at 2048^2, 3 -> 3, d_guide only (the training path: no
//   model's image takes a gradient) it reads guide, image and ct and
//   writes d_guide, 32 bytes a pixel, 134 MB, 40 us; with d_image 44
//   bytes, 55 us; its float operations (482 a pixel with both) 30 us.
//   Issue-bound in practice, as K3.
//   The design (pix_bwd_fixed_kernel): K1's 16 x 64 tiles, 4 pixels a
//   thread along a row, 32-bit indices inside an image (H-bands past 2^31
//   values); the tile's cells staged in shared memory once and each
//   corner read as 3 16-byte loads (read from the grid in device memory
//   where the window would not fit: a template argument); one float4 of
//   guide and d_guide and 3 of image, ct and d_image a thread where rows
//   are whole 4-pixel groups and pointers aligned; four blocks an SM (64
//   registers). Whether d_image is wanted is a template argument: the
//   d_guide-only kernel sums only the derivative-weighted slice (96 FMAs
//   a pixel, not 192); with d_image both sums share each corner load.
// Other channel counts (n_in != 3, n_out != 3, no offset, or a grid that
//   is not 16-byte aligned): the generic tile kernels, with the same
//   tiles, window and bands, and the window's cells re-laid at a stride
//   of whole float4s (C rounded up to a multiple of 4). A thread's 4
//   pixels are 16 apart along the row, so that a warp's scalar frame
//   loads and stores fall on neighbouring pixels (4 consecutive pixels a
//   thread spread a warp's store of a 12-channel output over 32 cache
//   lines: at n_in = 0, C = 12, 2048^2 that took 1.0552 ms against the
//   per-pixel kernel it replaced at 0.5969, timed in turns on an H100 at
//   700 W by scripts/time_kernels.py; with the pixels 16 apart and 16-byte
//   stores it takes a quarter of that kernel's time).
//   n_in = 0 (the plain slice) sums 4 channels at a time from 16-byte
//   corner loads, and stores them (and reads K4's ct) as 16-byte vectors
//   where C is a multiple of 4 and the pointers aligned; n_in >= 1 sums
//   each sliced coefficient where it is used, from scalar corner loads,
//   in the fixed kernels' order.
// K5 slice_apply_grid_bwd: replaces pallas.py slice_apply_grid_bwd
//   (pallas_call at pallas.py:1315) -> _grid_bwd_kernel (pallas.py:757).
//   A splat of ct_i * in_ext_j over the mirror-padded image into the grid:
//   padded pixel (yp, xp) reads the pixel its mirror maps it to and adds
//   wy(cy) * wx(cx) * wz(k) * f_c to entry (cy, cx, k, c), with direct
//   spatial tents and the smoothed depth tent forced to 1 past the
//   extreme bins. Only two cells a, a + 1 along y (a = floor(gf - .5),
//   gf = (yp + .5) * gh / H) carry weight, the same along x, and only the
//   depth bins lo = clamp(floor(gz - .5)) and lo + 1.
//   What bounds it (derived, not measured): at 2048^2, n_in = n_out = 3,
//   it must read guide, image and ct (117 MB with the grid written), 35 us
//   at 3.35 TB/s; its 96 useful FMAs a padded pixel (4.73 M of them) are
//   15 us of the card's float32 FMA rate. So bytes bound it, and a design
//   that reads each pixel once has to keep the accumulation off the issue
//   critical path.
//   The design (two kernels, deterministic, no float atomics):
//   * Regions. The padded image is cut at the lines between cell centres:
//     region (ry, rx) holds the padded pixels whose two cells along y are
//     ry - 1 and ry (likewise x), so every pixel of a region adds into the
//     same 2 x 2 cells. Each of the (gh + 1) (gw + 1) regions of an image
//     is cut into S row strips, one block a strip, with S chosen on the
//     host from the card's resident-block count: at least two waves of
//     blocks, the last nearly full, at every size (1156 blocks of 256
//     threads at 2048^2 with a 16 x 16 grid, as many at the pyramid's
//     512^2 level; S is capped by the rows a region has). Each padded
//     pixel is read by one block, coalesced along rows: the image once,
//     its mirrored border twice (1.13x at 2048^2).
//   * Records in registers. A block walks its strip in tiles of 256
//     pixels, one a thread: it loads guide, ct and image, computes the 8
//     weights (2 x 2 cells, bins lo and lo + 1) and the C products, and
//     writes them as one record into shared memory at its place in the
//     tile sorted by lo (a counting sort: ranks from warp ballots, bucket
//     starts from a warp scan, so the order is fixed). Then thread (l, c)
//     walks the l-th run of consecutive sorted records for channel c and
//     adds into two register quads, bins lo and lo + 1 of the 4 cells;
//     since lo only grows along the run, a quad is added to the thread's
//     own shared-memory slot only when lo changes (about once per bin the
//     run crosses), not a read-modify-write a record. The other blocks
//     resident on the SM (three at C = 12, gd = 8, bound by registers)
//     overlap their loads with this one's sums.
//   * A fixed order. At the end the L lane slots of each (cell, bin, c)
//     are summed in lane order into the block's partial (4 x gd x C
//     floats) in a scratch tensor the wrapper allocates; a second kernel
//     sums the partials of each grid entry in (dy, dx, strip) order. No
//     sum depends on the order in which blocks run, so two runs give the
//     same bits.
//   The mirror is done in the index, with no padded copies.
//   * A band (rows y_off .. of a frame of h_total rows, a rank's share on
//     a 'spatial' mesh axis) splats its share of the frame's padded
//     rows: its own, and the frame's top or bottom mirror rows when it
//     holds that end. Its regions are the frame's, cut to those rows;
//     only the region rows that they reach are launched (band_regions),
//     and the reduce skips the others. A whole frame is the band at 0 of
//     h rows: all gh + 1 region rows, its sums in the same order.
//
// None of the TPU tile planner (cell windows, strips, z strategies) is
// carried over: K3/K4's windows follow from their tiles' taps, and K5's
// regions from the grid alone.

#include <algorithm>
#include <cmath>
#include <mutex>
#include <vector>

#include <cuda_runtime.h>

#include "launchers.cuh"
#include "slice_common.cuh"
#include "slice_tile.cuh"

namespace {

using hdrnet::aligned16;
using hdrnet::clampi;
using hdrnet::depth_taps;
using hdrnet::kEps;
using hdrnet::kNC3;
using hdrnet::kPix;
using hdrnet::kTileH;
using hdrnet::kTileW;
using hdrnet::spatial_taps;
using hdrnet::Taps;
using hdrnet::Window;

constexpr int kThreads = hdrnet::kTileThreads;

struct Geometry {
  int b, h, w, gh, gw, gd;
  int n_in, n_out, ni_tot, has_offset;
  float sy, sx;  // gh / h_total, gw / w
  // K5's band: rows y_off .. y_off + h - 1 of a frame of h_total rows, and
  // the region rows ry0 .. ry0 + n_ry - 1 that its share of the padded
  // frame can reach (0 .. gh for a whole frame).
  int y_off, h_total, ry0, n_ry;
};

// ---- K4 at 3 -> 3 with an offset ------------------------------------------

// sdz[k] += dw * cell[k] and, with kBoth, s[k] += w * cell[k]: one cell's 12
// coefficients as 3 16-byte loads, shared by both sums.
template <bool kBoth>
__device__ __forceinline__ void add_cell2(float s[kNC3], float sdz[kNC3],
                                          float w, float dw,
                                          const float* cell) {
  const float4* c4 = reinterpret_cast<const float4*>(cell);
#pragma unroll
  for (int q = 0; q < kNC3 / 4; ++q) {
    const float4 v4 = c4[q];
    const float v[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (kBoth) s[4 * q + e] += w * v[e];
      sdz[4 * q + e] += dw * v[e];
    }
  }
}

// Dynamic shared memory: the tile's window (ny, nx, gd, 12) when kStaged,
// else none (corners from the grid). vec: rows of whole 4-pixel groups and
// every frame pointer 16-byte aligned. y_off: the launch's first row in
// the frame (a band's), for the taps.
template <bool kNeedInput, bool kStaged>
__global__ void __launch_bounds__(kThreads, 4)
    pix_bwd_fixed_kernel(const float* __restrict__ grid,
                         const float* __restrict__ guide,
                         const float* __restrict__ image,
                         const float* __restrict__ ct,
                         float* __restrict__ d_guide,
                         float* __restrict__ d_image, int vec, int h, int w,
                         int gh, int gw, int gd, int y_off, float sy,
                         float sx) {
  extern __shared__ float4 win4[];
  const int ty0 = blockIdx.y * kTileH;
  const int tx0 = blockIdx.x * kTileW;
  const int rows = min(kTileH, h - ty0);
  const int cols = min(kTileW, w - tx0);
  const int cell_floats = gd * kNC3;
  const Window win = hdrnet::tile_window<kStaged>(
      grid + static_cast<long long>(blockIdx.z) * gh * gw * cell_floats, win4,
      cell_floats, ty0 + y_off, rows, tx0, cols, gh, gw, sy, sx);
  __syncthreads();

  const int r = threadIdx.x / (kTileW / kPix);
  const int xq = (threadIdx.x % (kTileW / kPix)) * kPix;
  if (r >= rows || xq >= cols) return;
  const int y = ty0 + r;
  const int x = tx0 + xq;
  const int npx = min(kPix, w - x);
  const bool v4 = vec && npx == kPix;
  // 32-bit inside an image: the launcher keeps h * w * 3 below 2^31.
  const long long image_px = static_cast<long long>(blockIdx.z) * h * w;
  const int at = y * w + x;
  const float* g_src = guide + image_px + at;
  const float* in_src = image + (image_px + at) * 3;
  const float* ct_src = ct + (image_px + at) * 3;

  float g[kPix], img[kPix][3], c[kPix][3];
  if (v4) {
    const float4 g4 = __ldg(reinterpret_cast<const float4*>(g_src));
    g[0] = g4.x;
    g[1] = g4.y;
    g[2] = g4.z;
    g[3] = g4.w;
    hdrnet::load4(in_src, img);
    hdrnet::load4(ct_src, c);
  } else {
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      g[k] = k < npx ? __ldg(g_src + k) : 0.0f;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        img[k][j] = k < npx ? __ldg(in_src + k * 3 + j) : 0.0f;
        c[k][j] = k < npx ? __ldg(ct_src + k * 3 + j) : 0.0f;
      }
    }
  }

  // Taps of the global pixel: weights (and their depth derivatives) at
  // unclamped centres, clamped reads, from the window (or the grid).
  const Taps ty = spatial_taps(y + y_off, sy, gh);
  float dg[kPix], di[kPix][3];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const Taps tx = spatial_taps(x + k, sx, gw);
    float dz[2];
    const Taps tz = depth_taps(g[k], gd, dz);
    float s[kNC3], sdz[kNC3];
#pragma unroll
    for (int q = 0; q < kNC3; ++q) s[q] = sdz[q] = 0.0f;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float wyx = ty.w[a] * tx.w[e];
        const float* cell =
            win.p + ((ty.i[a] - win.wy0) * win.nx + (tx.i[e] - win.wx0)) *
                        cell_floats;
#pragma unroll
        for (int d = 0; d < 2; ++d) {
          add_cell2<kNeedInput>(s, sdz, wyx * tz.w[d], wyx * dz[d],
                                cell + tz.i[d] * kNC3);
        }
      }
    }
    // d_guide = sum_i ct_i sum_j sliced_dz[i, j] in_ext_j (in_ext_3 = 1).
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      float gacc = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        gacc += sdz[i * 4 + j] * (j < 3 ? img[k][j] : 1.0f);
      }
      acc += gacc * c[k][i];
    }
    dg[k] = acc;
    if constexpr (kNeedInput) {
      // d_image_j = sum_i sliced[i, j] ct_i
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        float v = 0.0f;
#pragma unroll
        for (int i = 0; i < 3; ++i) v += s[i * 4 + j] * c[k][i];
        di[k][j] = v;
      }
    }
  }

  float* dg_dst = d_guide + image_px + at;
  float* di_dst = kNeedInput ? d_image + (image_px + at) * 3 : nullptr;
  if (v4) {
    *reinterpret_cast<float4*>(dg_dst) = make_float4(dg[0], dg[1], dg[2],
                                                     dg[3]);
    if constexpr (kNeedInput) hdrnet::store4(di_dst, di);
  } else {
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      if (k < npx) {
        dg_dst[k] = dg[k];
        if constexpr (kNeedInput) {
#pragma unroll
          for (int j = 0; j < 3; ++j) di_dst[k * 3 + j] = di[k][j];
        }
      }
    }
  }
}

// ---- K3 and K4 at other channel counts --------------------------------------

// Channel counts of the generic kernels. cs: the staged window's floats a
// cell and bin, c rounded up to whole float4s (the grid's own stride c
// where the corners are read from it).
struct Channels {
  int n_in, n_out, ni_tot, has_offset, c, cs;
};

Channels channels(int n_in, int n_out, int has_offset) {
  const int ni_tot = n_in + (has_offset ? 1 : 0);
  const int c = n_out * ni_tot;
  return Channels{n_in, n_out, ni_tot, has_offset, c, (c + 3) / 4 * 4};
}

// A pixel's 8 corners in the order (y tap, x tap, z tap): weights, their
// depth derivatives (kDerivative, K4) and offsets from the window's base.
struct Corners {
  float w[8];
  float dw[8];
  int off[8];
};

template <bool kDerivative>
__device__ __forceinline__ Corners corners(const Window& win, const Taps& ty,
                                           int x, float sx, int gw,
                                           float guide, int gd, int stride) {
  const Taps tx = spatial_taps(x, sx, gw);
  float dz[2] = {0.0f, 0.0f};
  const Taps tz = depth_taps(guide, gd, kDerivative ? dz : nullptr);
  Corners k;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float wyx = ty.w[a] * tx.w[e];
      const int cell =
          ((ty.i[a] - win.wy0) * win.nx + (tx.i[e] - win.wx0)) * gd;
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        const int n = (a * 2 + e) * 2 + d;
        k.w[n] = wyx * tz.w[d];
        k.dw[n] = wyx * dz[d];
        k.off[n] = (cell + tz.i[d]) * stride;
      }
    }
  }
  return k;
}

// sum_n w[n] * win[off[n] + ch]: one sliced channel, corners in order.
__device__ __forceinline__ float slice_one(const float* win, const float w[8],
                                           const int off[8], int ch) {
  float s = 0.0f;
#pragma unroll
  for (int n = 0; n < 8; ++n) s += w[n] * win[off[n] + ch];
  return s;
}

// Channels q .. q + 3 sliced at once: 16-byte loads from the staged window
// (stride cs), guarded scalar loads from the grid (stride c).
template <bool kStaged>
__device__ __forceinline__ float4 slice_quad(const float* win,
                                             const float w[8],
                                             const int off[8], int q, int c) {
  float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    float4 v;
    if constexpr (kStaged) {
      v = *reinterpret_cast<const float4*>(win + off[n] + q);
    } else {
      const float* s = win + off[n] + q;
      v = make_float4(s[0], q + 1 < c ? s[1] : 0.0f, q + 2 < c ? s[2] : 0.0f,
                      q + 3 < c ? s[3] : 0.0f);
    }
    a.x += w[n] * v.x;
    a.y += w[n] * v.y;
    a.z += w[n] * v.z;
    a.w += w[n] * v.w;
  }
  return a;
}

// The generic kernels' tile: its window (staged re-laid at stride cs, with
// zeros in the padding) and this thread's pixels: row y of the launch,
// columns x + kStride * k for k < npx (0 for none). Synchronizes the
// block.
constexpr int kStride = kTileW / kPix;  // 16 threads a tile row

struct Tile {
  Window win;
  int y, x, npx;
};

template <bool kStaged>
__device__ __forceinline__ Tile generic_tile(const float* grid, float* win,
                                             const Channels& ch, int h, int w,
                                             int gh, int gw, int gd,
                                             int y_off, float sy, float sx) {
  const int ty0 = blockIdx.y * kTileH;
  const int tx0 = blockIdx.x * kTileW;
  const int rows = min(kTileH, h - ty0);
  const int cols = min(kTileW, w - tx0);
  const float* image_grid =
      grid + static_cast<long long>(blockIdx.z) * gh * gw * gd * ch.c;
  Tile t;
  if constexpr (kStaged) {
    const hdrnet::WindowSpan s =
        hdrnet::window_span(ty0 + y_off, rows, tx0, cols, gh, gw, sy, sx);
    const int bins = s.nx * gd;  // cells x bins a window row
    for (int i = threadIdx.x; i < s.ny * bins * ch.cs; i += kThreads) {
      const int e = i / ch.cs, k = i - e * ch.cs;
      const int r = e / bins;
      win[i] = k < ch.c ? __ldg(image_grid +
                                ((s.wy0 + r) * gw + s.wx0) * gd * ch.c +
                                (e - r * bins) * ch.c + k)
                        : 0.0f;
    }
    t.win = Window{win, s.wy0, s.wx0, s.nx};
  } else {
    t.win = Window{image_grid, 0, 0, gw};
  }
  __syncthreads();
  const int r = threadIdx.x / kStride;
  const int lx = threadIdx.x % kStride;
  t.y = ty0 + r;
  t.x = tx0 + lx;
  t.npx = r < rows && lx < cols ? min(kPix, (cols - lx + kStride - 1) /
                                                kStride)
                                : 0;
  return t;
}

// kSlice: n_in = 0 (out channel c is sliced channel c), 4 channels at a
// time (vec: stored as float4s); else each output channel from its row of
// sliced coefficients.
template <bool kSlice, bool kStaged>
__global__ void __launch_bounds__(kThreads, 4)
    slice_apply_fwd_kernel(Channels ch, const float* __restrict__ grid,
                           const float* __restrict__ guide,
                           const float* __restrict__ image,
                           float* __restrict__ out, int vec, int h, int w,
                           int gh, int gw, int gd, int y_off, float sy,
                           float sx) {
  extern __shared__ float4 win4[];
  const Tile t = generic_tile<kStaged>(grid, reinterpret_cast<float*>(win4),
                                       ch, h, w, gh, gw, gd, y_off, sy, sx);
  if (t.npx == 0) return;
  const long long image_px = static_cast<long long>(blockIdx.z) * h * w;
  const float* g_img = guide + image_px;
  const float* in_img = image + image_px * ch.n_in;
  float* out_img = out + image_px * ch.n_out;
  const int stride = kStaged ? ch.cs : ch.c;
  const Taps ty = spatial_taps(t.y + y_off, sy, gh);
  for (int k = 0; k < t.npx; ++k) {
    const int x = t.x + kStride * k;
    const int p = t.y * w + x;  // in the image, 32-bit
    const Corners kc = corners<false>(t.win, ty, x, sx, gw, __ldg(g_img + p),
                                      gd, stride);
    if constexpr (kSlice) {
      for (int q = 0; q < ch.c; q += 4) {
        const float4 a = slice_quad<kStaged>(t.win.p, kc.w, kc.off, q, ch.c);
        float* o = out_img + p * ch.c + q;
        if (vec) {
          *reinterpret_cast<float4*>(o) = a;
        } else {
          const float v[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (q + e < ch.c) o[e] = v[e];
          }
        }
      }
    } else {
      for (int i = 0; i < ch.n_out; ++i) {
        const int row = i * ch.ni_tot;
        float acc = ch.has_offset
                        ? slice_one(t.win.p, kc.w, kc.off, row + ch.n_in)
                        : 0.0f;
        for (int j = 0; j < ch.n_in; ++j) {
          acc += slice_one(t.win.p, kc.w, kc.off, row + j) *
                 __ldg(in_img + p * ch.n_in + j);
        }
        out_img[p * ch.n_out + i] = acc;
      }
    }
  }
}

// d_image null: d_guide only. kSlice as in slice_apply_fwd_kernel (no
// input channels, so no d_image; vec: ct read as float4s).
template <bool kSlice, bool kStaged>
__global__ void __launch_bounds__(kThreads, 4)
    pix_bwd_kernel(Channels ch, const float* __restrict__ grid,
                   const float* __restrict__ guide,
                   const float* __restrict__ image,
                   const float* __restrict__ ct, float* __restrict__ d_guide,
                   float* __restrict__ d_image, int vec, int h, int w, int gh,
                   int gw, int gd, int y_off, float sy, float sx) {
  extern __shared__ float4 win4[];
  const Tile t = generic_tile<kStaged>(grid, reinterpret_cast<float*>(win4),
                                       ch, h, w, gh, gw, gd, y_off, sy, sx);
  if (t.npx == 0) return;
  const long long image_px = static_cast<long long>(blockIdx.z) * h * w;
  const float* in_img = image + image_px * ch.n_in;
  const float* ct_img = ct + image_px * ch.n_out;
  const int stride = kStaged ? ch.cs : ch.c;
  const Taps ty = spatial_taps(t.y + y_off, sy, gh);
  for (int k = 0; k < t.npx; ++k) {
    const int x = t.x + kStride * k;
    const int p = t.y * w + x;  // in the image, 32-bit
    const Corners kc = corners<true>(t.win, ty, x, sx, gw,
                                     __ldg(guide + image_px + p), gd, stride);
    const float* ct_p = ct_img + p * ch.n_out;
    float dg = 0.0f;
    if constexpr (kSlice) {
      for (int q = 0; q < ch.c; q += 4) {
        const float4 a = slice_quad<kStaged>(t.win.p, kc.dw, kc.off, q, ch.c);
        const float v[4] = {a.x, a.y, a.z, a.w};
        float c[4];
        if (vec) {
          const float4 c4 = __ldg(reinterpret_cast<const float4*>(ct_p + q));
          c[0] = c4.x;
          c[1] = c4.y;
          c[2] = c4.z;
          c[3] = c4.w;
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            c[e] = q + e < ch.c ? __ldg(ct_p + q + e) : 0.0f;
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (q + e < ch.c) dg += v[e] * c[e];
        }
      }
    } else {
      const float* in_p = in_img + p * ch.n_in;
      for (int i = 0; i < ch.n_out; ++i) {
        float gacc = 0.0f;
        for (int j = 0; j < ch.ni_tot; ++j) {
          gacc += slice_one(t.win.p, kc.dw, kc.off, i * ch.ni_tot + j) *
                  (j < ch.n_in ? __ldg(in_p + j) : 1.0f);
        }
        dg += gacc * __ldg(ct_p + i);
      }
      if (d_image != nullptr) {
        float* di = d_image + (image_px + p) * ch.n_in;
        for (int j = 0; j < ch.n_in; ++j) {
          float v = 0.0f;
          for (int i = 0; i < ch.n_out; ++i) {
            v += slice_one(t.win.p, kc.w, kc.off, i * ch.ni_tot + j) *
                 __ldg(ct_p + i);
          }
          di[j] = v;
        }
      }
    }
    d_guide[image_px + p] = dg;
  }
}

// Lets a kernel take a window above the default 48 KB of dynamic shared
// memory.
template <typename Kernel>
cudaError_t allow_window(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// ---- K5 ------------------------------------------------------------------

constexpr int kWarps = kThreads / 32;

// Edge-inclusive mirror of a padded coordinate: -1 -> 0, n -> n - 1.
__device__ __forceinline__ int mirror(int v, int n) {
  return v < 0 ? -1 - v : (v >= n ? 2 * n - 1 - v : v);
}

// Grid coordinate of padded pixel v, (v + .5) * scale rounded once (no
// contraction into a later add, so every use sees the same value).
__device__ __forceinline__ float grid_coord(int v, float scale) {
  return __fmul_rn(static_cast<float>(v) + 0.5f, scale);
}

// Lower of the two cells whose tent reaches v: floor(gf - .5). gf - .5 is
// exact for gf >= .25 and keeps its floor below, so a pixel's cells are
// those with nonzero tent weight.
__device__ __forceinline__ int lower_cell(int v, float scale) {
  return static_cast<int>(floorf(grid_coord(v, scale) - 0.5f));
}

// Direct tent weight of cell a at grid coordinate gf.
__device__ __forceinline__ float cell_weight(int a, float gf) {
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

// First padded coordinate v in [-pad, n + pad] whose lower cell is >= a
// (lower_cell does not decrease with v): region a is [first(a),
// first(a + 1)).
__device__ int first_at(int a, float scale, int n, int pad) {
  int v = static_cast<int>(ceilf((static_cast<float>(a) + 0.5f) / scale -
                                 0.5f));
  v = min(max(v, -pad), n + pad);
  while (v > -pad && lower_cell(v - 1, scale) >= a) --v;
  while (v < n + pad && lower_cell(v, scale) < a) ++v;
  return v;
}

struct GridBwdLayout {
  int cs;  // record stride in floats (C | 1: rows on distinct banks)
  int n_floats;
  __host__ __device__ GridBwdLayout(int c_n, int gd)
      : cs(c_n | 1),
        n_floats(kThreads * (cs + 8 + 1 + 4 * gd) + 2 * gd * kWarps + gd +
                 1) {}
};

// Adds quad v (the 4 cells of one bin) into this thread's slots of bin k.
__device__ __forceinline__ void flush(float* slots, int k, const float v[4],
                                      int t) {
#pragma unroll
  for (int q = 0; q < 4; ++q) slots[(k * 4 + q) * kThreads + t] += v[q];
}

// A padded pixel of a tile: where it reads, and what it read. With the
// channel counts fixed (kNI, kNO > 0: the models' 3 -> 3), ct and the
// image are read with the guide, one tile ahead of their use (issued
// before the walk of the previous tile); otherwise (kNI < 0) only the
// guide, and ct and the image when the record is written.
template <int kNI, int kNO>
struct Raw {
  static constexpr int kI = kNI > 0 ? kNI : 1;
  static constexpr int kO = kNO > 0 ? kNO : 1;
  int yp, xp;
  long long pix;
  float guide;
  float ct[kO];
  float img[kI];
};

// One block: strip s of region (ry0 + ry, rx) of image bb, over the padded
// rows of the region that are the band's: its own rows, with the frame's
// top mirror rows when it starts the frame and the bottom ones when it
// ends it (a whole frame takes them all). Dynamic shared
// memory (GridBwdLayout): records rec_f (T, cs) | rec_w (T, 8): weights of
// the 4 cells at bin lo, then at lo + 1 | rec_lo (T) | slots (gd, 4, T) |
// warp counts and bucket starts. The partial out: (4 cells, gd, C).
template <int kNI, int kNO>
__global__ void __launch_bounds__(kThreads)
    grid_bwd_partial_kernel(Geometry g, int pad_y, int pad_x, int strips,
                            const float* __restrict__ guide,
                            const float* __restrict__ image,
                            const float* __restrict__ ct,
                            float* __restrict__ partial) {
  constexpr bool kFixed = kNI > 0;
  extern __shared__ float smem[];
  const int c_n = g.n_out * g.ni_tot;
  const int gd = g.gd;
  const GridBwdLayout lay(c_n, gd);
  float* rec_f = smem;
  float* rec_w = rec_f + kThreads * lay.cs;
  int* rec_lo = reinterpret_cast<int*>(rec_w + kThreads * 8);
  float* slots = reinterpret_cast<float*>(rec_lo + kThreads);
  int* wcount = reinterpret_cast<int*>(slots + 4 * gd * kThreads);
  int* wbase = wcount + gd * kWarps;
  int* n_sorted = wbase + gd * kWarps;

  int blk = blockIdx.x;
  const int s = blk % strips;
  blk /= strips;
  const int rx = blk % (g.gw + 1);
  blk /= g.gw + 1;
  const int ry = g.ry0 + blk % g.n_ry;
  const long long bb = blk / g.n_ry;
  const int ay = ry - 1, ax = rx - 1;  // the region's lower cells
  const int t = threadIdx.x;
  const int warp = t >> 5, lane = t & 31;

  // The band's padded rows [lo, hi) in frame coordinates.
  const int lo = g.y_off == 0 ? -pad_y : g.y_off;
  const int hi = g.y_off + g.h == g.h_total ? g.h_total + pad_y
                                            : g.y_off + g.h;
  const int y0 = max(first_at(ay, g.sy, g.h_total, pad_y), lo);
  const int ny =
      max(min(first_at(ay + 1, g.sy, g.h_total, pad_y), hi) - y0, 0);
  const int x0 = first_at(ax, g.sx, g.w, pad_x);
  const int nx = first_at(ax + 1, g.sx, g.w, pad_x) - x0;
  const int sy0 = y0 + static_cast<int>(static_cast<long long>(ny) * s /
                                        strips);
  const int sy1 = y0 + static_cast<int>(static_cast<long long>(ny) *
                                        (s + 1) / strips);
  const int n_pix = (sy1 - sy0) * max(nx, 0);

  for (int i = t; i < 4 * gd * kThreads; i += kThreads) slots[i] = 0.0f;
  // This thread's role in the walk: channel c of lane l.
  const int n_lanes = kThreads / c_n;
  const int c = t % c_n;
  const int l = t / c_n;
  const long long plane = static_cast<long long>(g.h) * g.w;
  const float fgd = static_cast<float>(gd);

  // Reads pixel q of the strip (nothing past its end).
  auto read = [&](int q, Raw<kNI, kNO>* r) {
    if (q >= n_pix) return;
    r->yp = sy0 + q / nx;
    r->xp = x0 + q % nx;
    r->pix = bb * plane +
             static_cast<long long>(mirror(r->yp, g.h_total) - g.y_off) *
                 g.w +
             mirror(r->xp, g.w);
    r->guide = __ldg(guide + r->pix);
    if constexpr (kFixed) {
#pragma unroll
      for (int i = 0; i < kNO; ++i) r->ct[i] = __ldg(ct + r->pix * kNO + i);
#pragma unroll
      for (int j = 0; j < kNI; ++j) {
        r->img[j] = __ldg(image + r->pix * kNI + j);
      }
    }
  };
  Raw<kNI, kNO> raw;
  read(t, &raw);

  for (int q0 = 0; q0 < n_pix; q0 += kThreads) {
    // Phase 1: one padded pixel a thread -> its record and its key lo.
    const int q = q0 + t;
    int key = gd;  // no record
    float w8[8];
    if (q < n_pix) {
      const float gy = grid_coord(raw.yp, g.sy);
      const float gx = grid_coord(raw.xp, g.sx);
      const float wy[2] = {cell_weight(ay, gy), cell_weight(ay + 1, gy)};
      const float wx[2] = {cell_weight(ax, gx), cell_weight(ax + 1, gx)};
      const float gz = __fmul_rn(raw.guide, fgd);
      key = clampi(static_cast<int>(floorf(gz - 0.5f)), gd - 1);
      // Only bins lo and lo + 1 can carry weight (the others are past
      // the tent's reach or below/above an override).
      const float wz[2] = {
          depth_weight(key, gz, gd),
          key + 1 < gd ? depth_weight(key + 1, gz, gd) : 0.0f};
#pragma unroll
      for (int d = 0; d < 2; ++d) {
#pragma unroll
        for (int cq = 0; cq < 4; ++cq) {
          w8[d * 4 + cq] = (wy[cq >> 1] * wx[cq & 1]) * wz[d];
        }
      }
    }
    // Counting sort by key: ranks within the warp from ballots, bucket
    // starts (keys in order, warps in order within a key) from a scan.
    int rank = 0;
    for (int k = 0; k < gd; ++k) {
      const unsigned m = __ballot_sync(0xffffffffu, key == k);
      if (key == k) rank = __popc(m & ((1u << lane) - 1u));
      if (lane == 0) wcount[k * kWarps + warp] = __popc(m);
    }
    __syncthreads();  // counts written; the previous walk is done
    if (warp == 0) {
      int carry = 0;
      for (int k0 = 0; k0 < gd; k0 += 32) {
        const int k = k0 + lane;
        int total = 0;
        if (k < gd) {
          for (int w = 0; w < kWarps; ++w) total += wcount[k * kWarps + w];
        }
        int incl = total;
        for (int off = 1; off < 32; off <<= 1) {
          const int v = __shfl_up_sync(0xffffffffu, incl, off);
          if (lane >= off) incl += v;
        }
        if (k < gd) {
          int run = carry + incl - total;
          for (int w = 0; w < kWarps; ++w) {
            const int n = wcount[k * kWarps + w];
            wbase[k * kWarps + w] = run;
            run += n;
          }
        }
        carry += __shfl_sync(0xffffffffu, incl, 31);
      }
      if (lane == 0) *n_sorted = carry;
    }
    __syncthreads();
    if (key < gd) {
      const int p = wbase[key * kWarps + warp] + rank;
      rec_lo[p] = key;
      float4* w4 = reinterpret_cast<float4*>(rec_w + p * 8);
      w4[0] = make_float4(w8[0], w8[1], w8[2], w8[3]);
      w4[1] = make_float4(w8[4], w8[5], w8[6], w8[7]);
      float* f = rec_f + p * lay.cs;
      if constexpr (kFixed) {
#pragma unroll
        for (int i = 0; i < kNO; ++i) {
#pragma unroll
          for (int j = 0; j < kNI; ++j) {
            f[i * (kNI + 1) + j] = raw.ct[i] * raw.img[j];
          }
          f[i * (kNI + 1) + kNI] = raw.ct[i];
        }
      } else {
        for (int i = 0; i < g.n_out; ++i) {
          const float cti = __ldg(ct + raw.pix * g.n_out + i);
          for (int j = 0; j < g.n_in; ++j) {
            f[i * g.ni_tot + j] = cti * __ldg(image + raw.pix * g.n_in + j);
          }
          if (g.has_offset) f[i * g.ni_tot + g.n_in] = cti;
        }
      }
    }
    __syncthreads();
    read(q0 + kThreads + t, &raw);  // the next tile's, in flight meanwhile
    // Phase 2: thread (l, c) walks the l-th run of consecutive sorted
    // records, so its lo changes about as often as the run crosses a bin
    // (a strided walk would change it at nearly every record of a tile
    // whose guide spans the bins), with bins cur and cur + 1 of the 4
    // cells in registers; two records a step, their loads issued
    // together.
    if (l < n_lanes) {
      const int n_rec = *n_sorted;
      const int run = (n_rec + n_lanes - 1) / n_lanes;
      const int p_end = min(n_rec, (l + 1) * run);
      float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};   // bin cur
      float an[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // bin cur + 1
      int cur = -1;
      auto add = [&](int lo, float f, float4 wl, float4 wh) {
        if (lo != cur) {
          if (cur >= 0) {
            flush(slots, cur, a, t);
            if (lo == cur + 1) {
#pragma unroll
              for (int r = 0; r < 4; ++r) a[r] = an[r];
            } else {
              flush(slots, cur + 1, an, t);  // cur + 1 < lo <= gd - 1
#pragma unroll
              for (int r = 0; r < 4; ++r) a[r] = 0.0f;
            }
#pragma unroll
            for (int r = 0; r < 4; ++r) an[r] = 0.0f;
          }
          cur = lo;
        }
        a[0] += wl.x * f;
        a[1] += wl.y * f;
        a[2] += wl.z * f;
        a[3] += wl.w * f;
        an[0] += wh.x * f;
        an[1] += wh.y * f;
        an[2] += wh.z * f;
        an[3] += wh.w * f;
      };
      const float4* w4 = reinterpret_cast<const float4*>(rec_w);
      int p = l * run;
      for (; p + 1 < p_end; p += 2) {
        const int p1 = p + 1;
        const int lo0 = rec_lo[p], lo1 = rec_lo[p1];
        const float f0 = rec_f[p * lay.cs + c], f1 = rec_f[p1 * lay.cs + c];
        const float4 wl0 = w4[2 * p], wh0 = w4[2 * p + 1];
        const float4 wl1 = w4[2 * p1], wh1 = w4[2 * p1 + 1];
        add(lo0, f0, wl0, wh0);
        add(lo1, f1, wl1, wh1);
      }
      if (p < p_end) {
        add(rec_lo[p], rec_f[p * lay.cs + c], w4[2 * p], w4[2 * p + 1]);
      }
      if (cur >= 0) {
        flush(slots, cur, a, t);
        if (cur + 1 < gd) flush(slots, cur + 1, an, t);
      }
    }
  }
  __syncthreads();
  // Sum the lanes in order; partial (4 cells, gd, C) of this block.
  float* o = partial + static_cast<long long>(blockIdx.x) * 4 * gd * c_n;
  for (int e = t; e < 4 * gd * c_n; e += kThreads) {
    const int ch = e % c_n;
    const int k = (e / c_n) % gd;
    const int cq = e / (c_n * gd);
    const float* src = slots + (k * 4 + cq) * kThreads + ch;
    float v = 0.0f;
    for (int ln = 0; ln < n_lanes; ++ln) v += src[ln * c_n];
    o[e] = v;
  }
}

// out[bb, cy, cx, k, c]: the partials of the 2 x 2 regions that hold cell
// (cy, cx), each over its strips, in (dy, dx, strip) order; a region row
// outside the band's holds none of its pixels.
__global__ void __launch_bounds__(kThreads)
    grid_bwd_reduce_kernel(Geometry g, int strips,
                           const float* __restrict__ partial,
                           float* __restrict__ out) {
  const int c_n = g.n_out * g.ni_tot;
  const long long n_out = static_cast<long long>(g.b) * g.gh * g.gw * g.gd *
                          c_n;
  const long long e = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (e >= n_out) return;
  const int kc = static_cast<int>(e % (g.gd * c_n));
  long long cell = e / (g.gd * c_n);
  const int cx = static_cast<int>(cell % g.gw);
  cell /= g.gw;
  const int cy = static_cast<int>(cell % g.gh);
  const long long bb = cell / g.gh;
  const long long per_block = 4LL * g.gd * c_n;
  float v = 0.0f;
  for (int dy = 0; dy < 2; ++dy) {
    const int ry = cy + 1 - dy - g.ry0;
    if (ry < 0 || ry >= g.n_ry) continue;
    for (int dx = 0; dx < 2; ++dx) {
      // Region (cy + 1 - dy, cx + 1 - dx) holds cell (cy, cx) as its
      // cell (dy, dx).
      const long long region =
          (bb * g.n_ry + ry) * (g.gw + 1) + (cx + 1 - dx);
      const float* src = partial + region * strips * per_block +
                         (dy * 2 + dx) * g.gd * c_n + kc;
      for (int s = 0; s < strips; ++s) v += __ldg(src + s * per_block);
    }
  }
  out[e] = v;
}

Geometry make_geometry(int b, int h, int w, int gh, int gw, int gd,
                       int n_in, int n_out, int has_offset, float sy,
                       float sx) {
  return Geometry{b,  h,  w,  gh, gw, gd, n_in, n_out,
                  n_in + (has_offset ? 1 : 0), has_offset, sy, sx, 0, h,
                  0,  gh + 1};
}

// The kernels of the models' 3 -> 3 with an offset read the grid as
// float4s.
bool fixed_channels(const void* grid, int n_in, int n_out, int has_offset) {
  return n_in == 3 && n_out == 3 && has_offset && aligned16(grid);
}

cudaError_t pix_bwd_fixed(const float* grid, const float* guide,
                          const float* image, const float* ct,
                          float* d_guide, float* d_image, int b, int h,
                          int w, int gh, int gw, int gd, int y_off, float sy,
                          float sx, cudaStream_t st) {
  const long long want =
      hdrnet::window_bytes(h, w, sy, sx, gh, gw, gd, kNC3);
  const bool staged = want <= hdrnet::kMaxWindowBytes;
  const int win_bytes = staged ? static_cast<int>(want) : 0;
  auto kernel = d_image != nullptr
                    ? (staged ? pix_bwd_fixed_kernel<true, true>
                              : pix_bwd_fixed_kernel<true, false>)
                    : (staged ? pix_bwd_fixed_kernel<false, true>
                              : pix_bwd_fixed_kernel<false, false>);
  const cudaError_t err = allow_window(kernel, win_bytes);
  if (err != cudaSuccess) return err;
  const long long cells = static_cast<long long>(gh) * gw * gd * kNC3;
  return hdrnet::for_each_band(b, h, w, 3, [&](int i, int nb, int y0,
                                               int nh) {
    const long long px = (static_cast<long long>(i) * h + y0) * w;
    const float* g = guide + px;
    const float* in = image + px * 3;
    const float* c = ct + px * 3;
    float* dg = d_guide + px;
    float* di = d_image != nullptr ? d_image + px * 3 : nullptr;
    const int vec = w % kPix == 0 && aligned16(g) && aligned16(in) &&
                    aligned16(c) && aligned16(dg) &&
                    (di == nullptr || aligned16(di));
    kernel<<<hdrnet::tile_blocks(w, nh, nb), kThreads, win_bytes, st>>>(
        grid + i * cells, g, in, c, dg, di, vec, nh, w, gh, gw, gd,
        y_off + y0, sy, sx);
    return cudaGetLastError();
  });
}

// The generic kernels' launches: the staged or the global instantiation
// of `pick(staged)`, over the frame's bands; launch(kernel, image, images,
// y0, rows, window bytes) launches one.
template <typename Pick, typename Launch>
cudaError_t launch_generic(const Channels& ch, int b, int h, int w, int gh,
                           int gw, int gd, float sy, float sx, Pick pick,
                           Launch launch) {
  const long long want = hdrnet::window_bytes(h, w, sy, sx, gh, gw, gd, ch.cs);
  const bool staged = want <= hdrnet::kMaxWindowBytes;
  const int win_bytes = staged ? static_cast<int>(want) : 0;
  auto kernel = pick(staged);
  const cudaError_t err = allow_window(kernel, win_bytes);
  if (err != cudaSuccess) return err;
  const int vals = std::max({1, ch.n_in, ch.n_out});
  return hdrnet::for_each_band(b, h, w, vals, [&](int i, int nb, int y0,
                                                  int nh) {
    return launch(kernel, i, nb, y0, nh, win_bytes);
  });
}

}  // namespace

// Shapes are checked by the Python wrappers (hdrnet_torch/ops/
// slice_apply.py); each launcher returns cudaGetLastError(), or
// cudaErrorInvalidValue without a launch for a row of 2^31 values or a
// band outside the frame.
//
// The band: the h rows are rows y_off .. y_off + h - 1 of a frame of
// h_total rows (a rank's share of a frame split along H; 0 and h for a
// whole frame), and sy = gh / h_total, so each row takes the taps it
// has in the whole frame. K3 and K4 add y_off to the row offset of each
// launch (the fused kernel's K7 argument); K5 splats the band's share of
// the mirror-padded frame.

namespace {

bool band_ok(int h, int y_off, int h_total) {
  return y_off >= 0 && h <= h_total - y_off;
}

}  // namespace

extern "C" int hdrnet_slice_apply_fwd(const void* grid, const void* guide,
                                      const void* image, void* out, int b,
                                      int h, int w, int gh, int gw, int gd,
                                      int n_in, int n_out, int has_offset,
                                      int y_off, int h_total, float sy,
                                      float sx, void* stream) {
  if (!band_ok(h, y_off, h_total))
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(b) * h * w == 0)
    return static_cast<int>(cudaGetLastError());
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* grid_p = static_cast<const float*>(grid);
  const auto* guide_p = static_cast<const float*>(guide);
  const auto* image_p = static_cast<const float*>(image);
  auto* out_p = static_cast<float*>(out);
  if (fixed_channels(grid, n_in, n_out, has_offset)) {
    return static_cast<int>(hdrnet::slice_apply_fwd_fixed(
        grid_p, guide_p, image_p, out_p, b, h, w, gh, gw, gd, y_off, sy, sx,
        st));
  }
  const Channels ch = channels(n_in, n_out, has_offset);
  const long long cells = static_cast<long long>(gh) * gw * gd * ch.c;
  return static_cast<int>(launch_generic(
      ch, b, h, w, gh, gw, gd, sy, sx,
      [&](bool staged) {
        if (n_in == 0) {
          return staged ? slice_apply_fwd_kernel<true, true>
                        : slice_apply_fwd_kernel<true, false>;
        }
        return staged ? slice_apply_fwd_kernel<false, true>
                      : slice_apply_fwd_kernel<false, false>;
      },
      [&](auto kernel, int i, int nb, int y0, int nh, int win_bytes) {
        const long long px = (static_cast<long long>(i) * h + y0) * w;
        float* o = out_p + px * n_out;
        const int vec = ch.c % 4 == 0 && aligned16(o);
        kernel<<<hdrnet::tile_blocks(w, nh, nb), kThreads, win_bytes, st>>>(
            ch, grid_p + i * cells, guide_p + px, image_p + px * n_in, o, vec,
            nh, w, gh, gw, gd, y_off + y0, sy, sx);
        return cudaGetLastError();
      }));
}

extern "C" int hdrnet_slice_apply_pix_bwd(
    const void* grid, const void* guide, const void* image, const void* ct,
    void* d_guide, void* d_image, int b, int h, int w, int gh, int gw,
    int gd, int n_in, int n_out, int has_offset, int y_off, int h_total,
    float sy, float sx, void* stream) {
  if (!band_ok(h, y_off, h_total))
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(b) * h * w == 0)
    return static_cast<int>(cudaGetLastError());
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* grid_p = static_cast<const float*>(grid);
  const auto* guide_p = static_cast<const float*>(guide);
  const auto* image_p = static_cast<const float*>(image);
  const auto* ct_p = static_cast<const float*>(ct);
  auto* dg_p = static_cast<float*>(d_guide);
  auto* di_p = static_cast<float*>(d_image);
  if (fixed_channels(grid, n_in, n_out, has_offset)) {
    return static_cast<int>(pix_bwd_fixed(grid_p, guide_p, image_p, ct_p,
                                          dg_p, di_p, b, h, w, gh, gw, gd,
                                          y_off, sy, sx, st));
  }
  const Channels ch = channels(n_in, n_out, has_offset);
  const long long cells = static_cast<long long>(gh) * gw * gd * ch.c;
  return static_cast<int>(launch_generic(
      ch, b, h, w, gh, gw, gd, sy, sx,
      [&](bool staged) {
        if (n_in == 0) {
          return staged ? pix_bwd_kernel<true, true>
                        : pix_bwd_kernel<true, false>;
        }
        return staged ? pix_bwd_kernel<false, true>
                      : pix_bwd_kernel<false, false>;
      },
      [&](auto kernel, int i, int nb, int y0, int nh, int win_bytes) {
        const long long px = (static_cast<long long>(i) * h + y0) * w;
        const float* c = ct_p + px * n_out;
        const int vec = ch.c % 4 == 0 && aligned16(c);
        kernel<<<hdrnet::tile_blocks(w, nh, nb), kThreads, win_bytes, st>>>(
            ch, grid_p + i * cells, guide_p + px, image_p + px * n_in, c,
            dg_p + px, di_p != nullptr ? di_p + px * n_in : nullptr, vec, nh,
            w, gh, gw, gd, y_off + y0, sy, sx);
        return cudaGetLastError();
      }));
}

namespace {

// The instantiation of K5's partial kernel for these channels: the
// models' 3 -> 3 with an offset has its loads issued a tile ahead. On an
// H100 (700 W) that takes 0.2045 ms at 2048^2 against the generic
// kernel's 0.2421 at the same channels (1024^2: 0.0625 against 0.0705;
// 512^2: 0.0271 against 0.0291), timed in turns by
// scripts/time_kernels.py.
using PartialKernel = void (*)(Geometry, int, int, int, const float*,
                               const float*, const float*, float*);

PartialKernel partial_kernel(int n_in, int n_out, int has_offset) {
  if (n_in == 3 && n_out == 3 && has_offset) {
    return grid_bwd_partial_kernel<3, 3>;
  }
  return grid_bwd_partial_kernel<-1, -1>;
}

// The largest dynamic shared memory each kernel was let take, per device.
struct Prepared {
  int dev;
  PartialKernel kernel;
  int smem;
};
std::mutex prepared_mutex;
std::vector<Prepared> prepared;

// Lets the kernel take `smem` bytes on the current device, with the SM's
// memory split for the most shared memory (more blocks resident). The
// attributes stay set, so they are set only when a size exceeds the
// largest set so far: a train step's launches make no driver call here.
cudaError_t prepare(PartialKernel kernel, int smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(prepared_mutex);
  auto it = std::find_if(prepared.begin(), prepared.end(),
                         [&](const Prepared& p) {
                           return p.dev == dev && p.kernel == kernel;
                         });
  if (it != prepared.end() && it->smem >= smem) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  if (it != prepared.end()) {
    it->smem = smem;
  } else {
    prepared.push_back({dev, kernel, smem});
  }
  return cudaSuccess;
}

}  // namespace

namespace {

// Region row of padded frame row v: 1 + its lower cell, in [0, gh].
int region_row(int v, float sy, int gh) {
  const int a = static_cast<int>(
      std::floor((static_cast<float>(v) + 0.5f) * sy - 0.5f));
  return std::min(std::max(a + 1, 0), gh);
}

// The region rows [ry0, ry0 + n_ry) that the band's padded rows reach,
// one row wider on each side than the host's rounding could miss (a row
// with none of the band's pixels adds zeros); all gh + 1 for a whole
// frame. pad_y is the frame's mirror padding.
void band_regions(int h, int gh, int y_off, int h_total, int pad_y,
                  int* ry0, int* n_ry) {
  const float sy = static_cast<float>(gh) / static_cast<float>(h_total);
  const int lo = y_off == 0 ? -pad_y : y_off;
  const int hi = y_off + h == h_total ? h_total + pad_y : y_off + h;
  const int r0 = std::max(region_row(lo, sy, gh) - 1, 0);
  const int r1 = std::min(region_row(hi - 1, sy, gh) + 1, gh);
  *ry0 = lo == -pad_y ? 0 : r0;
  *n_ry = (hi == h_total + pad_y ? gh : r1) - *ry0 + 1;
}

}  // namespace

// K5's plan for C channels and gd bins over a band of h rows at y_off of
// a frame of h_total rows (0 and h for a whole frame), mirror-padded by
// pad_y: its dynamic shared memory in bytes (returned), and through the
// pointers the strips a region is cut into and the floats of the
// partials' scratch. The strips give at least two waves of resident
// blocks on this card, the last nearly full (about as many blocks at every
// size), capped by the rows of a region. A C above the block's threads is
// refused as 0 bytes; a size above the card's limit is the caller's to
// refuse.
extern "C" int hdrnet_slice_apply_grid_bwd_plan(int b, int h, int gh, int gw,
                                                int gd, int c_n, int y_off,
                                                int h_total, int pad_y,
                                                int* strips,
                                                long long* scratch_floats) {
  *strips = 0;
  *scratch_floats = 0;
  if (c_n < 1 || c_n > kThreads || gd < 1 || !band_ok(h, y_off, h_total))
    return 0;
  const int smem = static_cast<int>(sizeof(float)) *
                   GridBwdLayout(c_n, gd).n_floats;
  // Both instantiations take the same resources; ask for the generic one.
  const PartialKernel kernel = partial_kernel(-1, -1, 0);
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      prepare(kernel, smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                    smem) != cudaSuccess) {
    cudaGetLastError();  // the size is refused; clear the sticky error
    return smem;
  }
  int ry0 = 0, n_ry = 0;
  band_regions(h, gh, y_off, h_total, pad_y, &ry0, &n_ry);
  const long long regions = static_cast<long long>(b) * n_ry * (gw + 1);
  const long long slots =
      static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  // A region's rows in the band: about h_total / gh, at most h.
  const long long max_s = std::max(1, std::min(h_total / gh, h));
  // At least two waves of blocks, and a last wave at least 90% full: the
  // regions of a frame are near one size, so blocks run in whole waves,
  // and a wave a fifth full costs as much as a full one. Else the fullest
  // of the first few candidates.
  const long long s0 =
      std::min(max_s, std::max(1LL, (2 * slots + regions - 1) / regions));
  long long s = s0;
  double best = 0.0;
  for (long long c = s0; c <= std::min(max_s, 4 * s0); ++c) {
    const long long blocks = regions * c;
    const long long waves = (blocks + slots - 1) / slots;
    const double full = static_cast<double>(blocks) / (waves * slots);
    if (full > best + 1e-9) {
      best = full;
      s = c;
    }
    if (full >= 0.9) break;
  }
  *strips = static_cast<int>(s);
  *scratch_floats = regions * s * 4 * gd * c_n;
  return smem;
}

extern "C" int hdrnet_slice_apply_grid_bwd(
    const void* guide, const void* image, const void* ct, void* scratch,
    void* out, int b, int h, int w, int gh, int gw, int gd, int n_in,
    int n_out, int has_offset, int y_off, int h_total, float sy, float sx,
    int pad_y, int pad_x, int strips, void* stream) {
  if (!band_ok(h, y_off, h_total) || h < pad_y)
    return static_cast<int>(cudaErrorInvalidValue);
  Geometry g =
      make_geometry(b, h, w, gh, gw, gd, n_in, n_out, has_offset, sy, sx);
  g.y_off = y_off;
  g.h_total = h_total;
  band_regions(h, gh, y_off, h_total, pad_y, &g.ry0, &g.n_ry);
  const int c_n = n_out * g.ni_tot;
  const int smem = static_cast<int>(sizeof(float)) *
                   GridBwdLayout(c_n, gd).n_floats;
  const PartialKernel kernel = partial_kernel(n_in, n_out, has_offset);
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto st = static_cast<cudaStream_t>(stream);
  const long long blocks = static_cast<long long>(b) * g.n_ry * (gw + 1) *
                           strips;
  auto* part = static_cast<float*>(scratch);
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(
      g, pad_y, pad_x, strips, static_cast<const float*>(guide),
      static_cast<const float*>(image), static_cast<const float*>(ct), part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = static_cast<long long>(b) * gh * gw * gd * c_n;
  grid_bwd_reduce_kernel<<<static_cast<unsigned>((n + kThreads - 1) /
                                                 kThreads),
                           kThreads, 0, st>>>(g, strips, part,
                                              static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
