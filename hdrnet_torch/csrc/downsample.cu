// K2: nearest-neighbour preview downsample for the serving path.
//
// Replaces hdrnet_tpu/ops/downsample.py: nearest_lowres_cf -> the slab
// kernel _make_kernel (pallas_call at downsample.py:295), and with it the
// row-DMA variant _make_gather_kernel (downsample.py:177), which computes
// the same function: this kernel already is a row gather.
//
// What it computes: out[b, c, oy, ox] = frame[b, iy[oy], ix[ox], c] for an
// NHWC frame (float32, or uint8 divided by 255 with IEEE division), with
// the legacy TF1 tables iy = floor(oy * H / s), ix = floor(ox * W / s)
// computed in float64 on the host and passed as int32 arrays (integer or
// float32 division in the kernel can pick another row where H / s is not
// exact). The output is the (B, 3, s, s) float32 preview that the
// coefficient CNN consumes.
//
// What bounds it on an H100: nothing that scales with the frame. A 4K
// frame -> 256x256 preview writes 3 * 256^2 * 4 B = 786 KB and reads
// 196,608 scattered elements, each from its own 32-byte sector (about
// 6.3 MB of sector traffic at float32, 1.6 MB of distinct rows for
// uint8) -- a few microseconds at 3.35 TB/s; the launch itself is a
// comparable cost. (Derived from the shapes, not measured.)
//
// What the design does about it: it reads only the sampled pixels. The
// TPU slab kernel streamed the whole frame (95 MB at 4K float32) through
// VMEM because Mosaic could not DMA single rows; here one thread per
// output element loads its one source element, and consecutive threads
// write consecutive output columns, so the writes coalesce.

#include <cstdint>
#include <cuda_runtime.h>

#include "launchers.cuh"

namespace {

__device__ __forceinline__ float to_unit(float v) { return v; }
__device__ __forceinline__ float to_unit(uint8_t v) {
  return __fdiv_rn(static_cast<float>(v), 255.0f);
}

template <typename T>
__global__ void nearest_lowres_kernel(const T* __restrict__ frame,
                                      const int* __restrict__ iy,
                                      const int* __restrict__ ix,
                                      float* __restrict__ out, int b, int h,
                                      int w, int c, int s) {
  const long long total = static_cast<long long>(b) * c * s * s;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < total; i += stride) {
    const int ox = static_cast<int>(i % s);
    long long t = i / s;
    const int oy = static_cast<int>(t % s);
    t /= s;
    const int ch = static_cast<int>(t % c);
    const long long bb = t / c;
    const long long src =
        ((bb * h + __ldg(iy + oy)) * w + __ldg(ix + ox)) * c + ch;
    out[i] = to_unit(__ldg(frame + src));
  }
}

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 4096;

}  // namespace

extern "C" int hdrnet_nearest_lowres(const void* frame, int is_u8,
                                     const void* iy, const void* ix,
                                     void* out, int b, int h, int w, int c,
                                     int s, void* stream) {
  const long long total = static_cast<long long>(b) * c * s * s;
  if (total == 0) return static_cast<int>(cudaGetLastError());
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* iy_p = static_cast<const int*>(iy);
  const int* ix_p = static_cast<const int*>(ix);
  float* out_p = static_cast<float*>(out);
  if (is_u8) {
    nearest_lowres_kernel<uint8_t><<<static_cast<int>(blocks), kThreads, 0,
                                     st>>>(
        static_cast<const uint8_t*>(frame), iy_p, ix_p, out_p, b, h, w, c, s);
  } else {
    nearest_lowres_kernel<float><<<static_cast<int>(blocks), kThreads, 0,
                                   st>>>(
        static_cast<const float*>(frame), iy_p, ix_p, out_p, b, h, w, c, s);
  }
  return static_cast<int>(cudaGetLastError());
}
