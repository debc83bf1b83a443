// K2x: the one-hot preview downsample on the tensor cores.
//
// Replaces scripts/exp_downsample_v2.py: variant -> pallas_call at :102,
// the round-4 experiment's kernels make_v1 (:57, rows read directly) and
// make_v2 (:67, rows selected by a second one-hot product over the slab).
//
// What it computes: K2's function on a channel-first float32 frame,
// out[b, c, oy, ox] = frame[b, c, iy[oy], ix[ox]], with the legacy TF1
// tables iy = floor(oy * H / s), ix = floor(ox * W / s) computed in
// float64 on the host. Each value is split exactly into three bf16 parts
// hi + mid + lo (split3, :40-45); a column is selected by a one-hot bf16
// product with float32 accumulation, one product a part, and the parts are
// added as (hi + mid) + lo (dot3, :48-54). A one-hot product of bf16 values
// is exact, and so is each sum of the parts, so the result equals K2's bit
// for bit. The rows are selected one of two ways (`rows`):
//   0 (v1): the 16 sampled rows of a tile are read directly;
//   1 (v2): the tile's slab, rows iy[first] .. iy[last] of its 16 output
//           rows, is split into parts and multiplied by the one-hot row
//           matrix Py (16 x slab rows); the float32 result of each part is
//           exact bf16, and goes on as the A operand of the column product
//           without leaving the registers.
//
// The products are mma.sync.m16n8k16 bf16 with float32 accumulators (the
// tensor-core counterpart of the MXU dots). One warp computes one 16 x 16
// output tile, so no shared memory and no barrier. The one-hot operands
// are made in registers from iy and ix in the documented fragment layouts
// instead of being read from memory. A warp's column products run over
// the 16-column steps that hold its 16 source columns,
// [ix[ox0], ix[ox0 + 15]], not over the whole width: the TPU kernel's
// dense (W, 256) one-hot block was fixed by its BlockSpec, and the rest of
// it is zeros. The parts are accumulated apart and added with IEEE float32
// adds, so no sum of parts depends on the tensor core's own rounding.
//
// What bounds it on an H100: bytes. At 4K (3 x 2160 x 3840) -> 256, v1
// reads the 768 sampled rows (11.8 MB) and writes 0.79 MB: 3.8 us at
// 3.35 TB/s; v2 reads rows of every slab, ~94% of the frame (~94 MB):
// ~28 us. The products are ~0.3 GFLOP (v1) and ~2.5 GFLOP (v2) of bf16,
// under 3 us at 989 TFLOP/s. (Derived from the shapes, not measured.)
// K2's own kernel reads only the sampled pixels and is the faster
// function; this kernel is the port of the experiment.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "launchers.cuh"

namespace {

constexpr int kTile = 16;           // output rows and columns a warp
constexpr int kWarps = 4;           // column tiles a block
constexpr uint32_t kOneHi = 0x3F800000u;  // bf16 1.0 in the high half
constexpr uint32_t kOneLo = 0x00003F80u;  // bf16 1.0 in the low half

__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// split3: x = hi + mid + lo exactly, each part bf16 (round to nearest even,
// as jnp's and torch's astype).
__device__ __forceinline__ void split3(float x, __nv_bfloat16* p) {
  p[0] = __float2bfloat16_rn(x);
  const float rem = x - __bfloat162float(p[0]);
  p[1] = __float2bfloat16_rn(rem);
  p[2] = __float2bfloat16_rn(rem - __bfloat162float(p[1]));
}

// Two values, each split: part k of (a, b) packed as one b32 register.
__device__ __forceinline__ void split_pair(float a, float b, uint32_t* r) {
  __nv_bfloat16 pa[3], pb[3];
  split3(a, pa);
  split3(b, pb);
  for (int k = 0; k < 3; ++k) r[k] = pack(pa[k], pb[k]);
}

// One-hot pair: element i of the pair is 1.0 where `idx` == `base` + i.
__device__ __forceinline__ uint32_t onehot_pair(int idx, int base) {
  return (idx == base ? kOneLo : 0u) | (idx == base + 1 ? kOneHi : 0u);
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, float32 accumulators.
__device__ __forceinline__ void mma(float* d, const uint32_t* a,
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// plane[row, col], or 0 outside rows [0, row_end) and columns [0, w).
__device__ __forceinline__ float load(const float* plane, int row, int col,
                                      int row_end, int w) {
  return (row >= 0 && row < row_end && col < w)
             ? __ldg(plane + static_cast<long long>(row) * w + col)
             : 0.0f;
}

// Fragment layout of mma.m16n8k16 (PTX ISA), lane = 4 g + t:
//   A (16 x 16): a[0] = (row g, k 2t..2t+1), a[1] = (g + 8, 2t..2t+1),
//                a[2] = (g, 2t+8..2t+9), a[3] = (g + 8, 2t+8..2t+9);
//   B (16 x 8):  b0 = (k 2t..2t+1, col g), b1 = (k 2t+8..2t+9, col g);
//   C (16 x 8):  c[0..1] = (row g, cols 2t..2t+1), c[2..3] = (g + 8, same).
template <int kRows>
__global__ void __launch_bounds__(kWarps * 32)
    downsample_onehot_kernel(const float* __restrict__ frame,
                             const int* __restrict__ iy,
                             const int* __restrict__ ix,
                             float* __restrict__ out, int h, int w, int s) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ox0 = (blockIdx.x * kWarps + warp) * kTile;
  if (ox0 >= s) return;  // whole warp: nothing below synchronizes the block
  const int oy0 = blockIdx.y * kTile;
  const long long plane_id = blockIdx.z;
  const float* plane = frame + plane_id * h * w;

  // The source rows of output rows g and g + 8 (-1 past the preview), the
  // source columns of output columns g and g + 8 (the two n-tiles).
  const int oy_last = min(oy0 + kTile, s) - 1;
  const int ry0 = oy0 + g <= oy_last ? __ldg(iy + oy0 + g) : -1;
  const int ry1 = oy0 + g + 8 <= oy_last ? __ldg(iy + oy0 + g + 8) : -1;
  const int ox_last = min(ox0 + kTile, s) - 1;
  const int cx[2] = {ox0 + g <= ox_last ? __ldg(ix + ox0 + g) : -1,
                     ox0 + g + 8 <= ox_last ? __ldg(ix + ox0 + g + 8) : -1};
  // The slab: rows iy[oy0] .. iy[oy_last] (v2; v1 reads ry0 and ry1).
  const int r_begin = __ldg(iy + oy0);
  const int r_end = __ldg(iy + oy_last) + 1;
  const int c_first = __ldg(ix + ox0) & ~(kTile - 1);
  const int c_last = __ldg(ix + ox_last);

  float acc[3][2][4] = {};  // [part][n-tile][fragment]
  for (int kb = c_first; kb <= c_last; kb += kTile) {
    uint32_t a[3][4];  // the tile's 16 rows x 16 columns, one set a part
    if (kRows == 0) {
      const int c0 = kb + 2 * t, c1 = kb + 2 * t + 8;
      uint32_t r[3];
      split_pair(load(plane, ry0, c0, h, w), load(plane, ry0, c0 + 1, h, w),
                 r);
      for (int k = 0; k < 3; ++k) a[k][0] = r[k];
      split_pair(load(plane, ry1, c0, h, w), load(plane, ry1, c0 + 1, h, w),
                 r);
      for (int k = 0; k < 3; ++k) a[k][1] = r[k];
      split_pair(load(plane, ry0, c1, h, w), load(plane, ry0, c1 + 1, h, w),
                 r);
      for (int k = 0; k < 3; ++k) a[k][2] = r[k];
      split_pair(load(plane, ry1, c1, h, w), load(plane, ry1, c1 + 1, h, w),
                 r);
      for (int k = 0; k < 3; ++k) a[k][3] = r[k];
    } else {
      // rows = Py (16 x slab) @ part (slab x 16 columns), one product a
      // part and a column half q; each sum holds one nonzero term.
      float rows[3][2][4] = {};
      for (int rb = r_begin; rb < r_end; rb += kTile) {
        uint32_t py[4];
        py[0] = onehot_pair(ry0, rb + 2 * t);
        py[1] = onehot_pair(ry1, rb + 2 * t);
        py[2] = onehot_pair(ry0, rb + 2 * t + 8);
        py[3] = onehot_pair(ry1, rb + 2 * t + 8);
        for (int q = 0; q < 2; ++q) {
          const int col = kb + 8 * q + g;
          const int k0 = rb + 2 * t, k1 = rb + 2 * t + 8;
          uint32_t b0[3], b1[3];
          split_pair(load(plane, k0, col, r_end, w),
                     load(plane, k0 + 1, col, r_end, w), b0);
          split_pair(load(plane, k1, col, r_end, w),
                     load(plane, k1 + 1, col, r_end, w), b1);
          for (int k = 0; k < 3; ++k) mma(rows[k][q], py, b0[k], b1[k]);
        }
      }
      // The accumulators of the two column halves are the A fragment of
      // the column product; their values are bf16, so the packing is exact.
      for (int k = 0; k < 3; ++k) {
        a[k][0] = pack(__float2bfloat16_rn(rows[k][0][0]),
                       __float2bfloat16_rn(rows[k][0][1]));
        a[k][1] = pack(__float2bfloat16_rn(rows[k][0][2]),
                       __float2bfloat16_rn(rows[k][0][3]));
        a[k][2] = pack(__float2bfloat16_rn(rows[k][1][0]),
                       __float2bfloat16_rn(rows[k][1][1]));
        a[k][3] = pack(__float2bfloat16_rn(rows[k][1][2]),
                       __float2bfloat16_rn(rows[k][1][3]));
      }
    }
    // The column product: Px (16 source columns x 8 outputs) one-hot.
    for (int j = 0; j < 2; ++j) {
      const uint32_t b0 = onehot_pair(cx[j], kb + 2 * t);
      const uint32_t b1 = onehot_pair(cx[j], kb + 2 * t + 8);
      for (int k = 0; k < 3; ++k) mma(acc[k][j], a[k], b0, b1);
    }
  }

  float* dst = out + plane_id * s * s;
  for (int j = 0; j < 2; ++j) {
    const int col = ox0 + 8 * j + 2 * t;
    for (int half = 0; half < 2; ++half) {
      const int row = oy0 + g + 8 * half;
      if (row >= s) continue;
      for (int e = 0; e < 2; ++e) {
        const int f = 2 * half + e;
        // dot3's order: (hi + mid) + lo, IEEE float32 adds.
        const float v = __fadd_rn(__fadd_rn(acc[0][j][f], acc[1][j][f]),
                                  acc[2][j][f]);
        if (col + e < s) dst[static_cast<long long>(row) * s + col + e] = v;
      }
    }
  }
}

}  // namespace

extern "C" int hdrnet_downsample_onehot(const void* frame, const void* iy,
                                        const void* ix, void* out, int planes,
                                        int h, int w, int s, int rows,
                                        void* stream) {
  if (planes == 0 || s == 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid((s + kTile * kWarps - 1) / (kTile * kWarps),
                  (s + kTile - 1) / kTile, planes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* f = static_cast<const float*>(frame);
  const int* iy_p = static_cast<const int*>(iy);
  const int* ix_p = static_cast<const int*>(ix);
  float* o = static_cast<float*>(out);
  if (rows) {
    downsample_onehot_kernel<1><<<grid, kWarps * 32, 0, st>>>(f, iy_p, ix_p,
                                                             o, h, w, s);
  } else {
    downsample_onehot_kernel<0><<<grid, kWarps * 32, 0, st>>>(f, iy_p, ix_p,
                                                             o, h, w, s);
  }
  return static_cast<int>(cudaGetLastError());
}
