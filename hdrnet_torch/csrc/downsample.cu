// K2: nearest-neighbour preview downsample for the serving path.
//
// Replaces hdrnet_tpu/ops/downsample.py: nearest_lowres_cf -> the slab
// kernel _make_kernel (pallas_call at downsample.py:295), and with it the
// row-DMA variant _make_gather_kernel (downsample.py:177), which computes
// the same function: this kernel is a row and column gather, and its
// batch is a grid dimension (K2g is this kernel at b=4).
//
// What it computes: out[b, c, oy, ox] = frame[b, iy[oy], ix[ox], c] for an
// NHWC frame (float32, or uint8 divided by 255 with IEEE division), with
// the legacy TF1 tables iy = floor(oy * H / s), ix = floor(ox * W / s)
// computed in float64 on the host and passed as int32 arrays (integer or
// float32 division in the kernel can pick another row where H / s is not
// exact). The output is the (B, C, s, s) float32 preview that the
// coefficient CNN consumes.
//
// What bounds it on an H100: DRAM latency, not bandwidth. A 4K frame ->
// 256^2 preview reads 65,536 scattered pixels (at float32 each pixel's
// channels sit in one or two 32-byte sectors: about 2-4 MB of sectors)
// and writes 786 KB: under 2 us of traffic at 3.35 TB/s, while one DRAM
// round trip is about 0.6-1 us. A kernel that waits for its loads one
// after another pays that latency many times over. (Derived from the
// shapes, not measured.)
//
// What the design does about it: one thread per output pixel column ox
// and kRows = 2 output rows, so each thread issues 2 C independent loads
// (6 at C = 3) before its first store, and the whole preview's loads are
// in flight at once: at b=1, s = 256 that is 32,768 threads in 256
// blocks, about two on each of the 132 SMs. (scripts/time_kernels.py on
// an H100, against a tree with 4 rows a thread in 128 blocks: 0.0025
// against 0.0027 ms at 4K f32, 0.0027 against 0.0034 u8: more blocks
// spread the requests over every SM.) A pixel's C channels are loaded back
// to back by its one thread (one sector, one request) and stored to the C
// output planes, where neighbouring threads write neighbouring ox
// (coalesced). iy is read once per output row, ix once per thread; the
// offsets inside a frame are 32-bit (a 64-bit instantiation takes frames
// of 2^31 elements or more), the batch's base 64-bit, and no index is
// divided in 64 bits. The batch is gridDim.y, so b=4 is one launch that
// fills the card.

#include <cstdint>
#include <cuda_runtime.h>

#include "launchers.cuh"

namespace {

constexpr int kRows = 2;       // output rows a thread
constexpr int kThreads = 128;  // output columns a block, at most
constexpr int kChannels = 4;   // channels a thread loads before it stores
constexpr int kMaxBatchBlocks = 65535;  // gridDim.y

__device__ __forceinline__ float to_unit(float v) { return v; }
__device__ __forceinline__ float to_unit(uint8_t v) {
  return __fdiv_rn(static_cast<float>(v), 255.0f);
}

// Index: int where a frame holds fewer than 2^31 elements, else long long.
template <typename T, typename Index>
__global__ void __launch_bounds__(kThreads)
    nearest_lowres_kernel(const T* __restrict__ frame,
                          const int* __restrict__ iy,
                          const int* __restrict__ ix,
                          float* __restrict__ out, int b, int h, int w,
                          int c, int s, int col_blocks) {
  const int group = blockIdx.x / col_blocks;
  const int ox = (blockIdx.x - group * col_blocks) * blockDim.x +
                 threadIdx.x;
  if (ox >= s) return;
  const int oy0 = group * kRows;
  const Index col = static_cast<Index>(__ldg(ix + ox)) * c;
  Index src[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    // A row past the preview loads a valid row and is not stored.
    const int oy = min(oy0 + r, s - 1);
    src[r] = static_cast<Index>(__ldg(iy + oy)) * w * c + col;
  }
  const long long frame_elems = static_cast<long long>(h) * w * c;
  const long long plane = static_cast<long long>(s) * s;
  const long long first = static_cast<long long>(oy0) * s + ox;
  for (int bb = blockIdx.y; bb < b; bb += gridDim.y) {
    const T* f = frame + bb * frame_elems;
    float* o = out + static_cast<long long>(bb) * c * plane + first;
    for (int c0 = 0; c0 < c; c0 += kChannels) {
      T v[kRows][kChannels];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
#pragma unroll
        for (int k = 0; k < kChannels; ++k) {
          v[r][k] = c0 + k < c ? __ldg(f + src[r] + c0 + k) : T(0);
        }
      }
#pragma unroll
      for (int k = 0; k < kChannels; ++k) {
        if (c0 + k >= c) break;
        float* dst = o + (c0 + k) * plane;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (oy0 + r < s) dst[r * s] = to_unit(v[r][k]);
        }
      }
    }
  }
}

template <typename T>
int launch(const void* frame, const int* iy, const int* ix, float* out,
           int b, int h, int w, int c, int s, cudaStream_t st) {
  const int threads = s < kThreads ? (s + 31) / 32 * 32 : kThreads;
  const int col_blocks = (s + threads - 1) / threads;
  const long long blocks =
      static_cast<long long>(col_blocks) * ((s + kRows - 1) / kRows);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks),
                  b < kMaxBatchBlocks ? b : kMaxBatchBlocks);
  const T* f = static_cast<const T*>(frame);
  if (static_cast<long long>(h) * w * c < (1LL << 31)) {
    nearest_lowres_kernel<T, int><<<grid, threads, 0, st>>>(
        f, iy, ix, out, b, h, w, c, s, col_blocks);
  } else {
    nearest_lowres_kernel<T, long long><<<grid, threads, 0, st>>>(
        f, iy, ix, out, b, h, w, c, s, col_blocks);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int hdrnet_nearest_lowres(const void* frame, int is_u8,
                                     const void* iy, const void* ix,
                                     void* out, int b, int h, int w, int c,
                                     int s, void* stream) {
  if (b == 0 || c == 0 || s == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* iy_p = static_cast<const int*>(iy);
  const int* ix_p = static_cast<const int*>(ix);
  float* out_p = static_cast<float*>(out);
  return is_u8 ? launch<uint8_t>(frame, iy_p, ix_p, out_p, b, h, w, c, s, st)
               : launch<float>(frame, iy_p, ix_p, out_p, b, h, w, c, s, st);
}
