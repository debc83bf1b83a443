// The Gaussian pyramid's level work on the serving route: pyramid_down
// (one level of the pyramid) and pyramid_up_add (one coarse-to-fine step
// of the levels' sum, with the clip and the uint8 requantize of the last).
//
// Replaces no TPU kernel. The JAX package builds the pyramid and sums it
// with jax.image-style resizes and adds, which XLA fuses on the TPU into a
// few passes over each level. The port computed them op by op in ATen
// (two index_selects and three elementwise kernels an axis, the add, the
// clamp and a four-kernel requantize), about 49 launches a 4K frame that
// each read and write a whole level: 1.74 ms a frame on an H100. These two
// kernels compute the same functions in one pass each.
//
// What they compute, bit for bit (ops/levels.py holds the plain versions,
// which are the ATen chain itself):
//   pyramid_down: out = the bilinear resize (align_corners) of the NHWC
//     frame (B, H, W, 3), float32 or uint8 (v / 255, IEEE division, from
//     a table of the 256 quotients as K1 builds it), to (H / 2, W / 2):
//     rows first, r = a + (b - a) * fy, then columns, out = r0 + (r1 -
//     r0) * fx, each a separately rounded subtract, multiply and add
//     (__fsub_rn / __fmul_rn / __fadd_rn, so that nvcc contracts nothing
//     into an FMA), as ops.resize's _Lerp computes them in three kernels.
//   pyramid_up_add: out = the same resize of the coarse sum `current` to
//     the finer level's extent, plus `level` (the finer level's K6 output);
//     then optionally the clip to [0, 1] (NaN passes, as torch.clamp), then
//     optionally trunc(v * 255 + 0.5) into uint8 with K1's __fmul_rn /
//     __fadd_rn.
// The taps (int64 source indices i0, i1 and the float32 weight of each
// output row and column) are ops.resize.linear_tap_tensors' device tables,
// computed in float64 on the host; the kernels never recompute them.
//
// What bounds them on an H100: bytes. Derived at 4K b=1 (3.35 TB/s): u8
// frame -> level 1 reads 24.9 MB and writes 24.9 MB, 14.9 us; level 1 ->
// level 2 24.9 + 6.2 MB, 9.3 us; the coarsest sum onto level 1 reads 6.2 +
// 24.9 MB and writes 24.9 MB, 16.7 us; level 1's sum onto the frame with
// the clip and the requantize reads 24.9 + 99.5 MB and writes 24.9 MB,
// 44.6 us. About 0.086 ms a frame in all. The arithmetic is a dozen float
// operations a channel.
//
// What the design does about it: one thread a pixel of the output (3
// channels), a block a stretch of one output row, the rows of the batch
// in gridDim.y. Each byte of the finer image is read once from device
// memory: a thread's reads of the level (up_add) and its stores are 12 or
// 3 bytes beside its neighbours', so a warp's requests cover whole
// sectors. The coarser image's 2 x 2 taps overlap between neighbouring
// threads and rows (each coarse pixel feeds about 4 output pixels) and
// are read through L1 and L2, which hold the few coarse rows a block's
// rows read. The taps of a thread's column are read once, those of a row
// once a row; the uint8 quotients are looked up in shared memory. Offsets
// of a row are 64-bit, within a row 32-bit (the wrapper keeps W * 3 below
// 2^31).

#include <cstdint>
#include <cuda_runtime.h>

#include "launchers.cuh"

namespace {

constexpr int kC = 3;             // channels
constexpr int kThreads = 256;     // output pixels of a row a block, at most
constexpr int kMaxRowBlocks = 65535;  // gridDim.y

// a + (b - a) * f, three roundings, as ops.resize._Lerp.
__device__ __forceinline__ float lerp(float a, float b, float f) {
  return __fadd_rn(a, __fmul_rn(__fsub_rn(b, a), f));
}

__device__ __forceinline__ float unit(float v, const float*) { return v; }
__device__ __forceinline__ float unit(uint8_t v, const float* u8_unit) {
  return u8_unit[v];
}

// torch.clamp(v, 0, 1): NaN passes.
__device__ __forceinline__ float clip01(float v) {
  return isnan(v) ? v : fminf(fmaxf(v, 0.0f), 1.0f);
}

// trunc(v * 255 + 0.5) to uint8, as torch's (v * 255.0 + 0.5).to(int32)
// .to(uint8) and K1's quant.
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(uint8_t* p, float v) {
  *p = static_cast<uint8_t>(
      static_cast<int>(__fadd_rn(__fmul_rn(v, 255.0f), 0.5f)));
}

struct Taps {
  int i0, i1;
  float f;
};

__device__ __forceinline__ Taps taps(const long long* __restrict__ i0,
                                     const long long* __restrict__ i1,
                                     const float* __restrict__ f, int k) {
  return Taps{static_cast<int>(__ldg(i0 + k)), static_cast<int>(__ldg(i1 + k)),
              __ldg(f + k)};
}

// The bilinear value at one output pixel from source rows ra (tap i0 of
// its row) and rb (tap i1), with its column's taps tx: rows first.
template <typename T>
__device__ __forceinline__ void bilinear(const T* __restrict__ ra,
                                         const T* __restrict__ rb, Taps tx,
                                         float fy, const float* u8_unit,
                                         float out[kC]) {
  const int c0 = tx.i0 * kC;
  const int c1 = tx.i1 * kC;
  T v[4][kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    v[0][c] = __ldg(ra + c0 + c);
    v[1][c] = __ldg(rb + c0 + c);
    v[2][c] = __ldg(ra + c1 + c);
    v[3][c] = __ldg(rb + c1 + c);
  }
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const float r0 = lerp(unit(v[0][c], u8_unit), unit(v[1][c], u8_unit), fy);
    const float r1 = lerp(unit(v[2][c], u8_unit), unit(v[3][c], u8_unit), fy);
    out[c] = lerp(r0, r1, tx.f);
  }
}

struct Tables {
  const long long *iy0, *iy1, *ix0, *ix1;
  const float *fy, *fx;
};

// The bilinear resize of src (B, h_in, w_in, 3) to (B, h_out, w_out, 3);
// rows = B * h_out.
template <typename TIn>
__global__ void __launch_bounds__(kThreads)
    pyramid_down_kernel(const TIn* __restrict__ src, Tables t,
                        float* __restrict__ dst, int h_in, int w_in,
                        int h_out, int w_out, long long rows) {
  __shared__ float u8_unit[sizeof(TIn) == 1 ? 256 : 1];
  if (sizeof(TIn) == 1) {
    for (int i = threadIdx.x; i < 256; i += blockDim.x) {
      u8_unit[i] = __fdiv_rn(static_cast<float>(i), 255.0f);
    }
    __syncthreads();
  }
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= w_out) return;
  const Taps tx = taps(t.ix0, t.ix1, t.fx, x);
  const long long row_in = static_cast<long long>(w_in) * kC;
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    const long long image = r / h_out;
    const Taps ty = taps(t.iy0, t.iy1, t.fy, static_cast<int>(r - image * h_out));
    const TIn* ra = src + (image * h_in + ty.i0) * row_in;
    const TIn* rb = src + (image * h_in + ty.i1) * row_in;
    float v[kC];
    bilinear(ra, rb, tx, ty.f, u8_unit, v);
    float* o = dst + (r * w_out + x) * kC;
#pragma unroll
    for (int c = 0; c < kC; ++c) o[c] = v[c];
  }
}

// The same resize of `coarse` (B, h_in, w_in, 3) to `level`'s (B, h_out,
// w_out, 3), plus `level`; clipped if `clip`; float32 or uint8 out.
template <typename TOut>
__global__ void __launch_bounds__(kThreads)
    pyramid_up_add_kernel(const float* __restrict__ coarse,
                          const float* __restrict__ level, Tables t,
                          TOut* __restrict__ dst, int h_in, int w_in,
                          int h_out, int w_out, long long rows, int clip) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= w_out) return;
  const Taps tx = taps(t.ix0, t.ix1, t.fx, x);
  const long long row_in = static_cast<long long>(w_in) * kC;
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    const long long image = r / h_out;
    const Taps ty = taps(t.iy0, t.iy1, t.fy, static_cast<int>(r - image * h_out));
    const long long at = (r * w_out + x) * kC;
    float fine[kC];
#pragma unroll
    for (int c = 0; c < kC; ++c) fine[c] = __ldg(level + at + c);
    float v[kC];
    bilinear(coarse + (image * h_in + ty.i0) * row_in,
             coarse + (image * h_in + ty.i1) * row_in, tx, ty.f, nullptr, v);
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const float s = __fadd_rn(v[c], fine[c]);
      store(dst + at + c, clip ? clip01(s) : s);
    }
  }
}

// Threads a block and blocks of an output of rows x w_out pixels.
void shape(long long rows, int w_out, dim3* grid, int* threads) {
  *threads = w_out < kThreads ? (w_out + 31) / 32 * 32 : kThreads;
  *grid = dim3((w_out + *threads - 1) / *threads,
               static_cast<unsigned>(rows < kMaxRowBlocks ? rows
                                                          : kMaxRowBlocks));
}

Tables tables(const void* iy0, const void* iy1, const void* fy,
              const void* ix0, const void* ix1, const void* fx) {
  return Tables{static_cast<const long long*>(iy0),
                static_cast<const long long*>(iy1),
                static_cast<const long long*>(ix0),
                static_cast<const long long*>(ix1),
                static_cast<const float*>(fy), static_cast<const float*>(fx)};
}

}  // namespace

// pyramid_down: (b, h_in, w_in, 3) float32 or uint8 (u8_in) -> (b, h_out,
// w_out, 3) float32, with the taps of the h_in -> h_out rows (iy0, iy1,
// fy) and the w_in -> w_out columns (ix0, ix1, fx).
extern "C" int hdrnet_pyramid_down(const void* src, int u8_in,
                                   const void* iy0, const void* iy1,
                                   const void* fy, const void* ix0,
                                   const void* ix1, const void* fx,
                                   void* dst, int b, int h_in, int w_in,
                                   int h_out, int w_out, void* stream) {
  const long long rows = static_cast<long long>(b) * h_out;
  if (rows == 0 || w_out == 0) return static_cast<int>(cudaGetLastError());
  if (h_in < 1 || w_in < 1) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid;
  int threads;
  shape(rows, w_out, &grid, &threads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Tables t = tables(iy0, iy1, fy, ix0, ix1, fx);
  float* out = static_cast<float*>(dst);
  if (u8_in) {
    pyramid_down_kernel<uint8_t><<<grid, threads, 0, st>>>(
        static_cast<const uint8_t*>(src), t, out, h_in, w_in, h_out, w_out,
        rows);
  } else {
    pyramid_down_kernel<float><<<grid, threads, 0, st>>>(
        static_cast<const float*>(src), t, out, h_in, w_in, h_out, w_out,
        rows);
  }
  return static_cast<int>(cudaGetLastError());
}

// pyramid_up_add: coarse (b, h_in, w_in, 3) resized with the taps onto
// level's (b, h_out, w_out, 3), plus level; clipped if `clip`; uint8
// (u8_out, which needs clip) or float32 out.
extern "C" int hdrnet_pyramid_up_add(const void* coarse, const void* level,
                                     const void* iy0, const void* iy1,
                                     const void* fy, const void* ix0,
                                     const void* ix1, const void* fx,
                                     void* dst, int clip, int u8_out, int b,
                                     int h_in, int w_in, int h_out,
                                     int w_out, void* stream) {
  const long long rows = static_cast<long long>(b) * h_out;
  if (rows == 0 || w_out == 0) return static_cast<int>(cudaGetLastError());
  if (h_in < 1 || w_in < 1 || (u8_out && !clip)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dim3 grid;
  int threads;
  shape(rows, w_out, &grid, &threads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Tables t = tables(iy0, iy1, fy, ix0, ix1, fx);
  const float* c = static_cast<const float*>(coarse);
  const float* l = static_cast<const float*>(level);
  if (u8_out) {
    pyramid_up_add_kernel<uint8_t><<<grid, threads, 0, st>>>(
        c, l, t, static_cast<uint8_t*>(dst), h_in, w_in, h_out, w_out, rows,
        clip);
  } else {
    pyramid_up_add_kernel<float><<<grid, threads, 0, st>>>(
        c, l, t, static_cast<float*>(dst), h_in, w_in, h_out, w_out, rows,
        clip);
  }
  return static_cast<int>(cudaGetLastError());
}
