// K3, K4, K5: the bilateral slice-apply with an external guide, and its
// two backward passes, the training path of HDRNetCurves.
//
// Layouts (float32, contiguous): grid (B, gh, gw, gd, C) with
// C = n_out * ni_tot packed row-major (channel i * ni_tot + j; j = n_in is
// the affine offset when has_offset), guide (B, H, W), image (B, H, W,
// n_in), output and its cotangent ct (B, H, W, n_out). n_in = 0 with
// has_offset is the plain slice: ni_tot = 1 and the output is the C sliced
// channels. n_in, n_out and C are runtime values: K3 and K4 keep the
// image and the sliced row of one output channel in registers for
// n_in <= kFastNIn (the models' 3 channels), and loop over the channels
// with the same sums in the same order above it; K5 takes any C whose
// records fit in a block's shared memory.
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
//
// None of the TPU tile planner (cell windows, strips, z strategies) is
// carried over: K3/K4 are per-pixel gathers with no window cap, and K5's
// regions follow from the grid alone.

#include <algorithm>
#include <mutex>
#include <vector>

#include <cuda_runtime.h>

#include "slice_common.cuh"

namespace {

using hdrnet::clampi;
using hdrnet::depth_taps;
using hdrnet::kEps;
using hdrnet::spatial_taps;
using hdrnet::Taps;

// K3/K4 keep the image and one output channel's sliced row in registers
// up to kFastNIn input channels; above it they loop (same sums, order).
constexpr int kFastNIn = 3;
constexpr int kFastExt = kFastNIn + 1;
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

// sum_n w[n] * grid[off[n] + ch]: one sliced channel, corners in order.
__device__ __forceinline__ float slice_one(const float* __restrict__ grid,
                                           const float w[8],
                                           const long long off[8], int ch) {
  float s = 0.0f;
#pragma unroll
  for (int n = 0; n < 8; ++n) s += w[n] * __ldg(grid + off[n] + ch);
  return s;
}

// in_ext: the n_in image channels, then 1 for the offset.
__device__ __forceinline__ float ext_at(const Geometry& g,
                                        const float* __restrict__ image,
                                        long long pix, int j) {
  return j < g.n_in ? __ldg(image + pix * g.n_in + j) : 1.0f;
}

__device__ __forceinline__ void pixel_coords(const Geometry& g, long long pix,
                                             int* y, int* x, long long* bb) {
  *x = static_cast<int>(pix % g.w);
  const long long row = pix / g.w;
  *y = static_cast<int>(row % g.h);
  *bb = row / g.h;
}

// kExt > 0: n_in + 1 <= kExt, the image and the sums in registers;
// kExt == 0: any n_in, each sliced channel summed where it is used.
template <int kExt>
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
    int y, x;
    long long bb;
    pixel_coords(g, pix, &y, &x, &bb);
    const Corners k = corners(g, bb, y, x, __ldg(guide + pix), false);
    if constexpr (kExt > 0) {
      float ext[kExt];
#pragma unroll
      for (int j = 0; j < kExt; ++j) ext[j] = ext_at(g, image, pix, j);
      for (int i = 0; i < g.n_out; ++i) {
        float s[kExt];
#pragma unroll
        for (int j = 0; j < kExt; ++j) s[j] = 0.0f;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const float* cell = grid + k.off[n] + i * g.ni_tot;
#pragma unroll
          for (int j = 0; j < kExt; ++j) {
            if (j < g.ni_tot) s[j] += k.w[n] * __ldg(cell + j);
          }
        }
        // out_i = offset + sum_j A_ij * in_j, in the order of K1. The
        // offset is picked by an unrolled compare, so s stays in registers.
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < kExt; ++j) {
          if (g.has_offset && j == g.n_in) acc = s[j];
        }
#pragma unroll
        for (int j = 0; j < kExt; ++j) {
          if (j < g.n_in) acc += s[j] * ext[j];
        }
        out[pix * g.n_out + i] = acc;
      }
    } else {
      for (int i = 0; i < g.n_out; ++i) {
        const int row = i * g.ni_tot;
        float acc =
            g.has_offset ? slice_one(grid, k.w, k.off, row + g.n_in) : 0.0f;
        for (int j = 0; j < g.n_in; ++j) {
          acc += slice_one(grid, k.w, k.off, row + j) *
                 __ldg(image + pix * g.n_in + j);
        }
        out[pix * g.n_out + i] = acc;
      }
    }
  }
}

template <int kExt>
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
    int y, x;
    long long bb;
    pixel_coords(g, pix, &y, &x, &bb);
    const Corners k = corners(g, bb, y, x, __ldg(guide + pix), true);
    float dg = 0.0f;
    if constexpr (kExt > 0) {
      float ext[kExt];
#pragma unroll
      for (int j = 0; j < kExt; ++j) ext[j] = ext_at(g, image, pix, j);
      float di[kExt];
#pragma unroll
      for (int j = 0; j < kExt; ++j) di[j] = 0.0f;
      for (int i = 0; i < g.n_out; ++i) {
        float s[kExt], sdz[kExt];
#pragma unroll
        for (int j = 0; j < kExt; ++j) s[j] = sdz[j] = 0.0f;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const float* cell = grid + k.off[n] + i * g.ni_tot;
#pragma unroll
          for (int j = 0; j < kExt; ++j) {
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
        for (int j = 0; j < kExt; ++j) {
          if (j < g.ni_tot) gacc += sdz[j] * ext[j];
        }
        dg += gacc * cti;
        // d_in_j += sliced[i, j] * ct_i
#pragma unroll
        for (int j = 0; j < kExt; ++j) {
          if (j < g.n_in) di[j] += s[j] * cti;
        }
      }
      if (d_image != nullptr) {
#pragma unroll
        for (int j = 0; j < kExt; ++j) {
          if (j < g.n_in) d_image[pix * g.n_in + j] = di[j];
        }
      }
    } else {
      for (int i = 0; i < g.n_out; ++i) {
        const float cti = __ldg(ct + pix * g.n_out + i);
        float gacc = 0.0f;
        for (int j = 0; j < g.ni_tot; ++j) {
          gacc += slice_one(grid, k.dw, k.off, i * g.ni_tot + j) *
                  ext_at(g, image, pix, j);
        }
        dg += gacc * cti;
      }
      if (d_image != nullptr) {
        for (int j = 0; j < g.n_in; ++j) {
          float di = 0.0f;
          for (int i = 0; i < g.n_out; ++i) {
            di += slice_one(grid, k.w, k.off, i * g.ni_tot + j) *
                  __ldg(ct + pix * g.n_out + i);
          }
          d_image[pix * g.n_in + j] = di;
        }
      }
    }
    d_guide[pix] = dg;
  }
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

// One block: strip s of region (ry, rx) of image bb. Dynamic shared
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
  const int ry = blk % (g.gh + 1);
  const long long bb = blk / (g.gh + 1);
  const int ay = ry - 1, ax = rx - 1;  // the region's lower cells
  const int t = threadIdx.x;
  const int warp = t >> 5, lane = t & 31;

  const int y0 = first_at(ay, g.sy, g.h, pad_y);
  const int ny = first_at(ay + 1, g.sy, g.h, pad_y) - y0;
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
    r->pix = bb * plane + static_cast<long long>(mirror(r->yp, g.h)) * g.w +
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
// (cy, cx), each over its strips, in (dy, dx, strip) order.
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
    for (int dx = 0; dx < 2; ++dx) {
      // Region (cy + 1 - dy, cx + 1 - dx) holds cell (cy, cx) as its
      // cell (dy, dx).
      const long long region =
          (bb * (g.gh + 1) + (cy + 1 - dy)) * (g.gw + 1) + (cx + 1 - dx);
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
  return Geometry{b, h, w, gh, gw, gd, n_in, n_out,
                  n_in + (has_offset ? 1 : 0), has_offset, sy, sx};
}

int pixel_blocks(const Geometry& g) {
  const long long npix = static_cast<long long>(g.b) * g.h * g.w;
  long long blocks = (npix + kThreads - 1) / kThreads;
  return static_cast<int>(blocks > kMaxBlocks ? kMaxBlocks : blocks);
}

}  // namespace

// Shapes are checked by the Python wrappers (hdrnet_torch/ops/
// slice_apply.py); each launcher returns cudaGetLastError().

extern "C" int hdrnet_slice_apply_fwd(const void* grid, const void* guide,
                                      const void* image, void* out, int b,
                                      int h, int w, int gh, int gw, int gd,
                                      int n_in, int n_out, int has_offset,
                                      float sy, float sx, void* stream) {
  const Geometry g =
      make_geometry(b, h, w, gh, gw, gd, n_in, n_out, has_offset, sy, sx);
  if (static_cast<long long>(b) * h * w == 0)
    return static_cast<int>(cudaGetLastError());
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* grid_p = static_cast<const float*>(grid);
  const auto* guide_p = static_cast<const float*>(guide);
  const auto* image_p = static_cast<const float*>(image);
  auto* out_p = static_cast<float*>(out);
  if (n_in <= kFastNIn) {
    slice_apply_fwd_kernel<kFastExt><<<pixel_blocks(g), kThreads, 0, st>>>(
        g, grid_p, guide_p, image_p, out_p);
  } else {
    slice_apply_fwd_kernel<0><<<pixel_blocks(g), kThreads, 0, st>>>(
        g, grid_p, guide_p, image_p, out_p);
  }
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
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* grid_p = static_cast<const float*>(grid);
  const auto* guide_p = static_cast<const float*>(guide);
  const auto* image_p = static_cast<const float*>(image);
  const auto* ct_p = static_cast<const float*>(ct);
  auto* dg_p = static_cast<float*>(d_guide);
  auto* di_p = static_cast<float*>(d_image);
  if (n_in <= kFastNIn) {
    slice_apply_pix_bwd_kernel<kFastExt><<<pixel_blocks(g), kThreads, 0,
                                           st>>>(g, grid_p, guide_p, image_p,
                                                 ct_p, dg_p, di_p);
  } else {
    slice_apply_pix_bwd_kernel<0><<<pixel_blocks(g), kThreads, 0, st>>>(
        g, grid_p, guide_p, image_p, ct_p, dg_p, di_p);
  }
  return static_cast<int>(cudaGetLastError());
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

// K5's plan for C channels and gd bins: its dynamic shared memory in
// bytes (returned), and through the pointers the strips a region is cut
// into and the floats of the partials' scratch. The strips give at least
// two waves of resident blocks on this card, the last nearly full (about
// as many blocks at every size), capped by the rows of a region. A C above
// the block's threads is refused as 0 bytes; a size above the card's limit
// is the caller's to refuse.
extern "C" int hdrnet_slice_apply_grid_bwd_plan(int b, int h, int gh, int gw,
                                                int gd, int c_n, int* strips,
                                                long long* scratch_floats) {
  *strips = 0;
  *scratch_floats = 0;
  if (c_n < 1 || c_n > kThreads || gd < 1) return 0;
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
  const long long regions = static_cast<long long>(b) * (gh + 1) * (gw + 1);
  const long long slots =
      static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const long long max_s = h / gh > 1 ? h / gh : 1;
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
    int n_out, int has_offset, float sy, float sx, int pad_y, int pad_x,
    int strips, void* stream) {
  const Geometry g =
      make_geometry(b, h, w, gh, gw, gd, n_in, n_out, has_offset, sy, sx);
  const int c_n = n_out * g.ni_tot;
  const int smem = static_cast<int>(sizeof(float)) *
                   GridBwdLayout(c_n, gd).n_floats;
  const PartialKernel kernel = partial_kernel(n_in, n_out, has_offset);
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto st = static_cast<cudaStream_t>(stream);
  const long long blocks = static_cast<long long>(b) * (gh + 1) * (gw + 1) *
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
