// The pixel tiles shared by the slice kernels: K1/K6/K7 and K3 at the
// models' 3 -> 3 (fused_slice_apply.cu), K4 and K3 at other channel
// counts (slice_apply.cu).
//
// A block owns a tile of kTileH x kTileW pixels of one image (the image in
// blockIdx.z) and a thread kPix consecutive pixels of one row, with 32-bit
// indices inside the image. The cells the tile's taps reach (its window)
// are staged in shared memory once, or read from the grid in device
// memory where the window would not fit a block (a template argument of
// each kernel, so that its corner loads go through one address space). A
// frame whose images hold 2^31 values or more in one of their tensors is
// launched in H-bands that stay below that, each at its row offset, with
// the same taps and float operations as one launch.

#pragma once

#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

#include "slice_common.cuh"

namespace hdrnet {

constexpr int kTileThreads = 256;
constexpr int kPix = 4;                                  // pixels a thread
constexpr int kTileW = 64;                               // pixels a tile row
constexpr int kTileH = kTileThreads * kPix / kTileW;     // 16 rows
constexpr int kNC3 = 12;  // grid channels of the models' 3 -> 3 affine

// The largest window staged: a block's shared memory on sm_90 less the
// kernels' static shared memory.
constexpr int kMaxWindowBytes = 220 * 1024;

// Cells a tile of `tile` pixels can reach along an axis of scale s (grid
// extent over total extent): the taps of its first and last pixels span
// at most ceil((tile - 1) s) + 2 cells; one more for rounding.
inline int window_cells(int tile, int extent, float s, int grid_extent) {
  const int span = tile < extent ? tile : extent;
  const double reach = static_cast<double>(span - 1) * s;
  long long n = static_cast<long long>(reach);
  if (static_cast<double>(n) < reach) ++n;
  n += 3;
  return static_cast<int>(n < grid_extent ? n : grid_extent);
}

// Bytes of the window of a tile, at `cell_stride` floats a cell and bin.
inline long long window_bytes(int h, int w, float sy, float sx, int gh,
                              int gw, int gd, int cell_stride) {
  return static_cast<long long>(window_cells(kTileH, h, sy, gh)) *
         window_cells(kTileW, w, sx, gw) * gd * cell_stride *
         static_cast<long long>(sizeof(float));
}

// The rows one launch may take: a kernel indexes an image's values in 32
// bits, so rows * w * vals (vals: the most values a pixel has in any of
// its tensors) must stay below 2^31, and its tile rows must fit
// gridDim.y. 0 for a row of 2^31 values or more, which no launch takes.
inline int max_launch_rows(int h, int w, int vals) {
  const long long by_index =
      0x7fffffffLL / (static_cast<long long>(w) * vals);
  return static_cast<int>(
      std::min({static_cast<long long>(h), by_index, 65535LL * kTileH}));
}

inline dim3 tile_blocks(int w, int rows, int images) {
  return dim3((w + kTileW - 1) / kTileW, (rows + kTileH - 1) / kTileH,
              images);
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

// Calls run(image, images, y0, rows) for each launch of a (b, h, w) frame:
// one launch for the whole batch where its indices fit, else each image
// in H-bands of max_launch_rows rows. run returns cudaGetLastError().
template <typename Run>
cudaError_t for_each_band(int b, int h, int w, int vals, Run run) {
  const int rows = max_launch_rows(h, w, vals);
  if (rows < 1) return cudaErrorInvalidValue;
  if (rows == h && b <= 65535) return run(0, b, 0, h);
  for (int i = 0; i < b; ++i) {
    for (int y0 = 0; y0 < h; y0 += rows) {
      const cudaError_t err = run(i, 1, y0, std::min(rows, h - y0));
      if (err != cudaSuccess) return err;
    }
  }
  return cudaSuccess;
}

// The cells the taps of a tile at global row gy0 and column gx0 (rows x
// cols pixels) reach: those of its first and last rows and columns (the
// taps grow with the coordinate).
struct WindowSpan {
  int wy0, ny, wx0, nx;
};

__device__ __forceinline__ WindowSpan window_span(int gy0, int rows, int gx0,
                                                  int cols, int gh, int gw,
                                                  float sy, float sx) {
  WindowSpan s;
  s.wy0 = spatial_taps(gy0, sy, gh).i[0];
  s.ny = spatial_taps(gy0 + rows - 1, sy, gh).i[1] - s.wy0 + 1;
  s.wx0 = spatial_taps(gx0, sx, gw).i[0];
  s.nx = spatial_taps(gx0 + cols - 1, sx, gw).i[1] - s.wx0 + 1;
  return s;
}

// The tile's window: cell (cy, cx), bin z at p + ((cy - wy0) * nx + (cx -
// wx0)) * gd * stride + z * stride.
struct Window {
  const float* p;
  int wy0, wx0, nx;
};

// The window of a tile (window_span's arguments). kStaged: copied into
// win4 with 16-byte copies (cell_floats = gd * channels, a multiple of 4,
// and the grid 16-byte aligned); else the image's grid itself, read in
// device memory. The caller synchronizes the block before reading it.
template <bool kStaged>
__device__ __forceinline__ Window tile_window(const float* image_grid,
                                              float4* win4, int cell_floats,
                                              int gy0, int rows, int gx0,
                                              int cols, int gh, int gw,
                                              float sy, float sx) {
  if constexpr (kStaged) {
    const WindowSpan s =
        window_span(gy0, rows, gx0, cols, gh, gw, sy, sx);
    const int row4 = s.nx * cell_floats / 4;  // float4s a window row
    const float4* g4 = reinterpret_cast<const float4*>(
        image_grid + (s.wy0 * gw + s.wx0) * cell_floats);
    const int grid_row4 = gw * cell_floats / 4;
    for (int i = threadIdx.x; i < s.ny * row4; i += kTileThreads) {
      const int r = i / row4;
      win4[i] = __ldg(g4 + r * grid_row4 + (i - r * row4));
    }
    return Window{reinterpret_cast<const float*>(win4), s.wy0, s.wx0, s.nx};
  } else {
    return Window{image_grid, 0, 0, gw};
  }
}

// A thread's 4 pixels of 3 channels (f32): 3 x 16-byte loads and stores.
__device__ __forceinline__ void load4(const float* src,
                                      float v[kPix][3]) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
  float f[12];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const float4 a = __ldg(s4 + q);
    f[4 * q] = a.x;
    f[4 * q + 1] = a.y;
    f[4 * q + 2] = a.z;
    f[4 * q + 3] = a.w;
  }
#pragma unroll
  for (int k = 0; k < 12; ++k) v[k / 3][k % 3] = f[k];
}

__device__ __forceinline__ void store4(float* dst, const float o[kPix][3]) {
  float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const int k = 4 * q;
    d4[q] = make_float4(o[k / 3][k % 3], o[(k + 1) / 3][(k + 1) % 3],
                        o[(k + 2) / 3][(k + 2) % 3],
                        o[(k + 3) / 3][(k + 3) % 3]);
  }
}

// sliced[k] += w * cell[k] for one grid cell's 12 coefficients, as 3
// 16-byte loads.
__device__ __forceinline__ void add_cell(float sliced[kNC3], float w,
                                         const float* cell) {
  const float4* c4 = reinterpret_cast<const float4*>(cell);
#pragma unroll
  for (int q = 0; q < kNC3 / 4; ++q) {
    const float4 v = c4[q];
    sliced[4 * q + 0] += w * v.x;
    sliced[4 * q + 1] += w * v.y;
    sliced[4 * q + 2] += w * v.z;
    sliced[4 * q + 3] += w * v.w;
  }
}

// K3 at n_in = n_out = 3 with an offset, on K1's kernel (defined in
// fused_slice_apply.cu): the grid 16-byte aligned; y_off the rows' offset
// in their frame (K7's). Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a row of 2^31 values.
cudaError_t slice_apply_fwd_fixed(const float* grid, const float* guide,
                                  const float* image, float* out, int b,
                                  int h, int w, int gh, int gw, int gd,
                                  int y_off, float sy, float sx,
                                  cudaStream_t stream);

}  // namespace hdrnet
