// K2x: the one-hot preview downsample on the tensor cores.
//
// Replaces scripts/exp_downsample_v2.py: variant -> pallas_call at :102,
// the round-4 experiment's kernels make_v1 (:57, rows read directly) and
// make_v2 (:67, rows selected by a second one-hot product over the slab).
//
// What it computes: K2's function on a channel-first float32 frame,
// out[p, oy, ox] = frame[p, iy[oy], ix[ox]] for each plane p = (b, c),
// with the legacy TF1 tables iy = floor(oy * H / s), ix = floor(ox * W / s)
// computed in float64 on the host. Each value is split exactly into three
// bf16 parts hi + mid + lo (split3, :40-45); a column is selected by a
// one-hot bf16 product with float32 accumulation, one product a part, and
// the parts are added as (hi + mid) + lo with IEEE float32 adds outside
// the tensor core (dot3, :48-54). A product of a bf16 value by 1.0 or 0.0
// is exact, each sum holds one nonzero term, and hi + mid + lo is exact,
// so the result equals K2's bit for bit. The rows are selected one of two
// ways (`rows`):
//   0 (v1): a unit's 64 sampled rows are read directly;
//   1 (v2): a unit's slab, rows iy[oy0] .. iy[oy0 + 7] of its 8 output
//           rows, is split into parts and multiplied by the one-hot row
//           matrix; each part's selected rows are exact bf16 values and go
//           on to the column product through shared memory, never
//           through device memory.
//
// What bounds it on an H100: bytes. At 4K (3 x 2160 x 3840) -> 256, v1
// reads the 768 sampled rows (11.8 MB) and writes 0.79 MB: 3.8 us at
// 3.35 TB/s; v2 reads its slabs, ~89% of the frame (~89 MB): ~27 us. The
// one-hot products as this kernel runs them are ~0.14 GFLOP (v1) and
// ~2.3 GFLOP (v2) of bf16, under 3 us at 989 TFLOP/s; splitting v2's
// 22 M values into parts (a pair at a time, 11 instructions) is ~130 M
// thread instructions, ~5 us of issue spread over the card. (Derived from the shapes, not measured.) K2's own
// kernel reads only the sampled pixels and is the faster function; this
// kernel is the port of the experiment.
//
// What the design does about it: the copies run ahead of the products,
// in few, large operations. The work is cut into units (plane, output
// rows, a range of source columns); each persistent block walks its
// units. A producer warp copies each unit's rows into a ring of
// shared-memory stages, each with a full and an empty mbarrier:
//   v1: the unit's 64 sampled rows x 128 source columns, one 1-D
//       cp.async.bulk of 512 bytes a row (the rows are scattered);
//   v2: the unit's slab x 64 source columns, in stages of up to 64
//       consecutive rows, one 2-D TMA copy (cp.async.bulk.tensor) a stage;
// where rows are not 16-byte aligned, plain loads instead (the route is
// chosen from the shape and pointer before the launch). One consumer
// warpgroup reads a stage into registers, splits it into parts there,
// frees the stage and issues wgmma.mma_async (bf16 -> f32). wgmma reads
// B only from shared memory, so the stage's data is the A operand, from
// registers (where it has to be split anyway), and the one-hot block is
// B, built a product at a time in shared memory, over the 64 source
// columns of a chunk:
//   v1: out (64 output rows x 8 output columns) = rows (64 x the chunk's
//       64 columns) . Px (64 x 8), m64n8k16, two chunks a stage;
//   v2: rows^T (64 source columns x 8 output rows) = slab^T . Py^T (slab
//       rows x 8), m64n8k16, accumulated over the slab's stages; its exact
//       bf16 values are written to shared memory as the B of the column
//       product out^T (64 output-column slots x 8 rows) = Px^T (one-hot,
//       the A, in registers) . rows^T.
// A chunk holds the sources of about 64 s / W output columns (4-5 at 4K);
// the consumers keep the first output column of every chunk in shared
// memory, so a product runs over its chunk's K-steps only and each chunk
// is read once; one that no output samples is not multiplied (v2's
// producer, which searches ix instead of waiting for the table, does not
// copy it either). v2's column product takes its three parts side by
// side as one B (N = 24, a part in each 8 columns): one m64n24k16 a
// K-step, each part still in its own accumulators.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <mutex>
#include <vector>

#include <cuda.h>  // CUtensorMap; the encoder is reached at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "launchers.cuh"

namespace {

constexpr int kConsumers = 128;            // one warpgroup: warps 0-3
constexpr int kThreads = kConsumers + 32;  // and the producer, warp 4
constexpr int kChunk = 64;        // source columns a product: 4 K-steps
constexpr int kSteps = kChunk / 16;
constexpr int kGatherRows = 64;   // v1: output rows a unit (wgmma's M)
constexpr int kMmaRows = 8;       // v2: output rows a unit (wgmma's N)
constexpr int kSlots = 8;         // v1: output columns a product (N)
constexpr int kBBytes = kSteps * 256;  // a one-hot B: 4 K-steps of 16 x 8
constexpr uint32_t kOneHi = 0x3F800000u;  // bf16 1.0 in the high half
constexpr uint32_t kOneLo = 0x00003F80u;  // bf16 1.0 in the low half
// The rest of the dynamic shared memory after the barriers: the chunk
// starts, where `chunks` + 1 of them fit kMaxStarts.
constexpr int kMaxStarts = 4096;

// A stage: kRows rows of kCols source columns at a pitch of kPitch
// floats, kStages of them. v1 reads 8 bytes (row g, columns 2t, 2t + 1):
// 136 = 8 mod 32 puts a half-warp's rows on distinct banks; its 34 KB
// stages leave room for two blocks an SM. v2 reads 4 bytes (rows 2t..,
// column g): 68 = 4 mod 32 puts the warp's four rows 8 banks apart, and
// is the tensor copy's box width (its 4 columns past the chunk unread);
// 17 KB stages, three blocks an SM. Rows stay 16-byte aligned.
template <int kRowsMode>
struct Stage {
  static constexpr int kRows = 64;
  static constexpr int kCols = kRowsMode == 0 ? 128 : 64;
  static constexpr int kPitch = kRowsMode == 0 ? 136 : 68;
  static constexpr int kStages = kRowsMode == 0 ? 3 : 4;
  static constexpr int kBytes = kRows * kPitch * 4;
  // The stages, the one-hot B, v2's three rows^T parts, the barriers.
  static constexpr int kSmem = kStages * kBytes + kBBytes +
                               (kRowsMode ? 3 * kBBytes : 0) +
                               2 * kStages * 8;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Waits for the phase of parity `parity` to complete. A wait that never
// ends (a fault in the pipeline) traps after 2^24 polls, seconds, so the
// launch fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (polls >> 24) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// One row window, global -> shared, completing `bytes` on the barrier.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// A box of the 2-D tensor `map` at column x, row y, global -> shared,
// completing its bytes on the barrier (out-of-bounds values read 0).
__device__ __forceinline__ void tensor_copy(void* dst, const CUtensorMap* map,
                                            int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
      "r"(smem_u32(bar))
      : "memory");
}

// Generic-proxy shared-memory accesses before async-proxy ones (wgmma's
// reads of B, the bulk copy's writes).
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// The consumer warpgroup's own barrier (the producer never joins it).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Ties the registers to this point of the program: accumulators are read
// only after the wait, and A is kept until then.
__device__ __forceinline__ void keep(float* d) {
  asm volatile("" : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])::"memory");
}
__device__ __forceinline__ void keep(uint32_t* a) {
  asm volatile("" : "+r"(a[0]), "+r"(a[1]), "+r"(a[2]), "+r"(a[3])::"memory");
}

// B's descriptor: K-major, no swizzle, 8 x 8 core matrices of 128
// contiguous bytes; a K-step's two halves 128 bytes apart (the leading
// offset), its groups of 8 columns `stride` bytes apart (the stride
// offset; unused where N = 8).
__device__ __forceinline__ uint64_t b_desc(const void* p, int stride = 128) {
  const uint64_t start = (smem_u32(p) & 0x3FFFF) >> 4;
  const uint64_t lead = 128 >> 4;
  return start | (lead << 16) | (static_cast<uint64_t>(stride >> 4) << 32);
}

// d (64 x 8, f32) += a (64 x 16 bf16, registers) . b (16 x 8, shared).
// Per warp w of the warpgroup, lane = 4 g + t (PTX ISA fragment layouts):
//   A rows 16 w + g and + 8: a[0] = (g, k 2t..2t+1), a[1] = (g + 8, same),
//     a[2] = (g, k 2t+8..2t+9), a[3] = (g + 8, same);
//   D: d[0..1] = (16 w + g, columns 2t, 2t + 1), d[2..3] = (+ 8, same).
__device__ __forceinline__ void wgmma_m64n8(float* d, const uint32_t* a,
                                            uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// (a, b) rounded to nearest-even bf16 (as jnp's and torch's astype),
// packed a low, b high: one cvt for the pair.
// d (64 x 24, f32) += a (64 x 16, registers) . b (16 x 24, shared): three
// groups of 8 columns, d[4 i ..] the group i's (the D layout of m64n8).
__device__ __forceinline__ void wgmma_m64n24(float* d, const uint32_t* a,
                                             uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, "
      "{%12, %13, %14, %15}, %16, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ uint32_t bf16x2(float a, float b) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(b), "f"(a));
  return r;
}

// The low and high bf16 of a pair, as float32 (exact).
__device__ __forceinline__ float low_f(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float high_f(uint32_t v) {
  return __uint_as_float(v & 0xFFFF0000u);
}

// split3 of two values, part k of (a, b) packed as r[k][j]: x = hi + mid
// + lo exactly, each part the bf16 of what the parts before it leave
// (split3, :40-45), a pair at a time.
__device__ __forceinline__ void split_pair(float a, float b,
                                           uint32_t (*r)[4], int j) {
  const uint32_t hi = bf16x2(a, b);
  const float ra = a - low_f(hi), rb = b - high_f(hi);
  const uint32_t mid = bf16x2(ra, rb);
  r[0][j] = hi;
  r[1][j] = mid;
  r[2][j] = bf16x2(ra - low_f(mid), rb - high_f(mid));
}

// One-hot pair: element i of the pair is 1.0 where `idx` == `base` + i.
__device__ __forceinline__ uint32_t onehot_pair(int idx, int base) {
  return (idx == base ? kOneLo : 0u) | (idx == base + 1 ? kOneHi : 0u);
}

// Writes the one-hot B (4 K-steps of 16 x 8, K-major core matrices): 1.0
// at (k, n) where k == target(n). Each of the first 64 consumer threads
// writes one 16-byte core-matrix row: step tid / 16, half (tid / 8) % 2,
// column n = tid % 8.
template <typename Target>
__device__ __forceinline__ void build_onehot(unsigned char* b, int tid,
                                             Target target) {
  if (tid >= 64) return;
  const int n = tid & 7;
  const int k0 = (tid >> 3) * 8;  // step * 16 + half * 8
  const int want = target(n);
  uint4 row;
  row.x = onehot_pair(want, k0);
  row.y = onehot_pair(want, k0 + 2);
  row.z = onehot_pair(want, k0 + 4);
  row.w = onehot_pair(want, k0 + 6);
  *reinterpret_cast<uint4*>(b + (tid >> 3) * 128 + n * 16) = row;
}

// The first output column whose source column is at least v (ix is
// non-decreasing, at most w - 1): s where there is none. A search, for
// frames too wide for the block's table of chunk starts.
__device__ __forceinline__ int first_at_least(const int* ix, int s, int w,
                                              int v) {
  if (v <= 0) return 0;
  if (v >= w) return s;
  int o = static_cast<int>(
      ceil(static_cast<double>(v) * s / static_cast<double>(w)));
  o = min(max(o, 0), s);
  while (o > 0 && __ldg(ix + o - 1) >= v) --o;
  while (o < s && __ldg(ix + o) < v) ++o;
  return o;
}

// starts[ch] = the first output column whose source column is at least
// 64 ch, for ch = 0 .. chunks (s past the last source): output ox is the
// first for the chunks ch with ix[ox - 1] < 64 ch <= ix[ox]. Written by
// the consumer warpgroup.
__device__ void fill_starts(int* starts, const int* ix, int s, int chunks) {
  for (int ox = threadIdx.x; ox < s; ox += kConsumers) {
    const int first = ox == 0 ? 0 : (__ldg(ix + ox - 1) >> 6) + 1;
    const int last = __ldg(ix + ox) >> 6;
    for (int ch = first; ch <= last; ++ch) starts[ch] = ox;
  }
  for (int ch = (__ldg(ix + s - 1) >> 6) + 1 + threadIdx.x; ch <= chunks;
       ch += kConsumers) {
    starts[ch] = s;
  }
}

// The warp's lane 0 value: every lane holds the same, and the compiler
// then knows it (the products in code it sees as divergent serialize).
__device__ __forceinline__ int uniform(int v) {
  return __shfl_sync(0xffffffffu, v, 0);
}

// A unit: plane, first output row, source columns [c0, c0 + cols) (one
// stage wide), its rows (v1: the `rows` sampled rows iy[oy0 ..]; v2: the
// slab r0 .. r0 + rows - 1) and, for the consumers, the output columns
// [lo, hi) it holds the sources of. Every field is warp-uniform.
struct Unit {
  int plane, oy0, c0, cols, lo, hi, r0, rows;
};

// The first output column of 64-column chunk ch (ch <= chunks).
__device__ __forceinline__ int chunk_start(const int* starts, const int* ix,
                                           int s, int w, int ch) {
  return uniform(starts ? starts[ch] : first_at_least(ix, s, w, ch * kChunk));
}

template <int kRowsMode>
__device__ __forceinline__ Unit unit_at(int u, int row_tiles, int wide,
                                        const int* iy, int w, int s) {
  constexpr int kTile = kRowsMode == 0 ? kGatherRows : kMmaRows;
  constexpr int kCols = Stage<kRowsMode>::kCols;
  Unit n;
  const int wc = u % wide;
  const int rest = u / wide;
  n.plane = uniform(rest / row_tiles);
  n.oy0 = uniform((rest - n.plane * row_tiles) * kTile);
  n.c0 = wc * kCols;
  n.cols = min(kCols, w - n.c0);
  const int last = min(n.oy0 + kTile, s) - 1;
  if (kRowsMode == 0) {
    n.r0 = 0;
    n.rows = last - n.oy0 + 1;
  } else {
    n.r0 = uniform(__ldg(iy + n.oy0));
    n.rows = uniform(__ldg(iy + last)) - n.r0 + 1;
  }
  n.lo = n.hi = 0;
  return n;
}

// The unit's output columns [lo, hi).
template <int kRowsMode>
__device__ __forceinline__ void unit_bounds(Unit* n, int chunks,
                                            const int* starts, const int* ix,
                                            int w, int s) {
  constexpr int kCols = Stage<kRowsMode>::kCols;
  const int ch = n->c0 / kChunk;
  n->lo = chunk_start(starts, ix, s, w, ch);
  n->hi = chunk_start(starts, ix, s, w, min(ch + kCols / kChunk, chunks));
}

// The kernel. kAsync: rows come by bulk (v1) or tensor (v2) copies, else by
// plain loads. `stage_rows` is v2's slab rows a stage (the tensor box's
// height); v1's stage holds its 64 rows.
template <int kRowsMode, bool kAsync>
__global__ void __launch_bounds__(kThreads)
    downsample_onehot_kernel(const __grid_constant__ CUtensorMap map,
                             const float* __restrict__ frame,
                             const int* __restrict__ iy,
                             const int* __restrict__ ix,
                             float* __restrict__ out, int h, int w, int s,
                             int row_tiles, int wide, int chunks, int units,
                             int stage_rows) {
  using G = Stage<kRowsMode>;
  constexpr int kPitch = G::kPitch;
  extern __shared__ __align__(128) unsigned char smem[];
  float* stages = reinterpret_cast<float*>(smem);
  unsigned char* onehot = smem + G::kStages * G::kBytes;
  unsigned char* rows_t = onehot + kBBytes;  // v2: three parts
  uint64_t* full = reinterpret_cast<uint64_t*>(
      rows_t + (kRowsMode ? 3 * kBBytes : 0));
  uint64_t* empty = full + G::kStages;
  int* starts = chunks + 1 <= kMaxStarts
                    ? reinterpret_cast<int*>(empty + G::kStages)
                    : nullptr;

  if (threadIdx.x == 0) {
    for (int i = 0; i < G::kStages; ++i) {
      mbar_init(full + i, kAsync ? 1 : 32);
      mbar_init(empty + i, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const long long plane_elems = static_cast<long long>(h) * w;
  const int warp = uniform(threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const int step_rows = kRowsMode == 0 ? G::kRows : stage_rows;

  if (warp == kConsumers / 32) {
    // The producer: each stage's rows of the unit's columns. It never
    // waits for the consumers' chunk table: v1 copies every unit; v2 finds
    // a unit's output columns by a search of ix and skips a unit that no
    // output samples (on an H100, each policy was the faster one for its
    // mode at 4K, in CUDA graphs in turns with the other).
    int it = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      Unit n = unit_at<kRowsMode>(u, row_tiles, wide, iy, w, s);
      if (kRowsMode == 1) {
        unit_bounds<kRowsMode>(&n, chunks, nullptr, ix, w, s);
        if (n.lo >= n.hi) continue;
      }
      const float* plane = frame + n.plane * plane_elems + n.c0;
      for (int r = 0; r < n.rows; r += step_rows, ++it) {
        const int st = it % G::kStages;
        const int lap = it / G::kStages;
        if (lap > 0) mbar_wait(empty + st, (lap - 1) & 1);
        float* dst = stages + st * G::kRows * kPitch;
        const int nr = min(step_rows, n.rows - r);
        if (kAsync && kRowsMode == 1) {
          // One box of stage_rows x 68 columns (past the frame: zeros).
          if (lane == 0) {
            mbar_expect(full + st, stage_rows * kPitch * 4);
            tensor_copy(dst, &map, n.c0, n.plane * h + n.r0 + r, full + st);
          }
        } else if (kAsync) {
          if (lane == 0) mbar_expect(full + st, nr * n.cols * 4);
          __syncwarp();
          for (int i = lane; i < nr; i += 32) {
            const int row = __ldg(iy + n.oy0 + i);
            bulk_copy(dst + i * kPitch, plane + static_cast<long long>(row) * w,
                      n.cols * 4, full + st);
          }
        } else {
          for (int e = lane; e < nr * n.cols; e += 32) {
            const int i = e / n.cols;
            const int col = e - i * n.cols;
            const int row = kRowsMode == 0 ? __ldg(iy + n.oy0 + i)
                                           : n.r0 + r + i;
            dst[i * kPitch + col] =
                __ldg(plane + static_cast<long long>(row) * w + col);
          }
          mbar_arrive(full + st);
        }
      }
    }
    return;
  }

  // The consumer warpgroup: the chunk table first, while the first copies
  // are in flight. Every product runs all 4 K-steps: past a ragged chunk's
  // columns A is zero. A chunk no output samples is not multiplied.
  const int tid = threadIdx.x;
  const int g = lane >> 2, t = lane & 3;
  const int j0 = tid & 7;  // the one-hot column this thread writes
  if (starts) {
    fill_starts(starts, ix, s, chunks);
    consumers_sync();
  }
  int it = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    Unit n = unit_at<kRowsMode>(u, row_tiles, wide, iy, w, s);
    unit_bounds<kRowsMode>(&n, chunks, starts, ix, w, s);
    // v2's producer skipped a unit no output samples; v1's copied it, and
    // its chunks are not multiplied below.
    if (kRowsMode == 1 && n.lo >= n.hi) continue;
    float* dst = out + static_cast<long long>(n.plane) * s * s;
    if (kRowsMode == 0) {
      // v1: per chunk of the stage, A = the 64 sampled rows x its 64
      // columns. Each chunk's output columns and first one-hot target,
      // loaded before the wait.
      constexpr int kSub = G::kCols / kChunk;
      int lo[kSub], hi[kSub], target[kSub];
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const int ch = n.c0 / kChunk + j;
        lo[j] = j == 0 ? n.lo : chunk_start(starts, ix, s, w, min(ch, chunks));
        hi[j] = j == kSub - 1 ? n.hi
                              : chunk_start(starts, ix, s, w,
                                            min(ch + 1, chunks));
        target[j] = lo[j] + j0 < hi[j] ? __ldg(ix + lo[j] + j0) - ch * kChunk
                                       : -1;
      }
      const int st = it % G::kStages;
      mbar_wait(full + st, (it / G::kStages) & 1);
      ++it;
      const float* stage = stages + st * G::kRows * kPitch;
      const int ra = 16 * warp + g, rb = ra + 8;
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const int cols = n.cols - j * kChunk;  // the chunk's, if below 64
        uint32_t a[kSteps][3][4];
        if (lo[j] < hi[j]) {
#pragma unroll
          for (int kk = 0; kk < kSteps; ++kk) {
#pragma unroll
            for (int q = 0; q < 2; ++q) {  // columns 2t and 2t + 8
              const int col = kk * 16 + 2 * t + 8 * q;
#pragma unroll
              for (int hr = 0; hr < 2; ++hr) {  // rows ra and rb
                const int row = hr ? rb : ra;
                float2 v = make_float2(0.0f, 0.0f);
                if (row < n.rows && col < cols) {
                  v = *reinterpret_cast<const float2*>(
                      stage + row * kPitch + j * kChunk + col);
                  if (col + 1 >= cols) v.y = 0.0f;
                }
                split_pair(v.x, v.y, a[kk], 2 * q + hr);
              }
            }
          }
        }
        if (j == kSub - 1) {  // the stage is in registers
          fence_async();
          mbar_arrive(empty + st);
        }
        const int c0 = n.c0 + j * kChunk;
        for (int base = lo[j]; base < hi[j]; base += kSlots) {
          if (base != lo[j]) {
            target[j] =
                base + j0 < hi[j] ? __ldg(ix + base + j0) - c0 : -1;
          }
          consumers_sync();  // the last product's reads of B are done
          build_onehot(onehot, tid, [&](int) { return target[j]; });
          fence_async();
          consumers_sync();
          float acc[3][4] = {};
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kSteps; ++kk) {
#pragma unroll
            for (int k = 0; k < 3; ++k) {
              wgmma_m64n8(acc[k], a[kk][k], b_desc(onehot + kk * 256));
            }
          }
          wgmma_commit_wait();
#pragma unroll
          for (int k = 0; k < 3; ++k) keep(acc[k]);
#pragma unroll
          for (int kk = 0; kk < kSteps; ++kk) {
#pragma unroll
            for (int k = 0; k < 3; ++k) keep(a[kk][k]);
          }
#pragma unroll
          for (int f = 0; f < 4; ++f) {
            const int row = f < 2 ? ra : rb;
            const int ox = base + 2 * t + (f & 1);
            if (row < n.rows && ox < hi[j]) {
              // dot3's order: (hi + mid) + lo, IEEE float32 adds.
              dst[static_cast<long long>(n.oy0 + row) * s + ox] =
                  __fadd_rn(__fadd_rn(acc[0][f], acc[1][f]), acc[2][f]);
            }
          }
        }
      }
    } else {
      // v2: rows^T (64 source columns x 8 output rows) = slab^T . Py^T,
      // over the slab's stages; then out^T = Px^T . rows^T. The one-hot
      // targets are loaded before the first wait.
      const int m0 = 16 * warp + g, m1 = m0 + 8;  // source columns
      const int row_src = n.oy0 + j0 < s ? __ldg(iy + n.oy0 + j0) : -1;
      int x0 = n.lo + m0 < n.hi ? __ldg(ix + n.lo + m0) - n.c0 : -1;
      int x1 = n.lo + m1 < n.hi ? __ldg(ix + n.lo + m1) - n.c0 : -1;
      float acc1[3][4] = {};
      for (int r = 0; r < n.rows; r += step_rows) {
        const int st = it % G::kStages;
        mbar_wait(full + st, (it / G::kStages) & 1);
        ++it;
        const float* stage = stages + st * G::kRows * kPitch;
        const int nr = min(step_rows, n.rows - r);
        uint32_t a[kSteps][3][4];
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk) {
#pragma unroll
          for (int q = 0; q < 2; ++q) {  // slab rows 2t.. and 2t + 8..
            const int k0 = kk * 16 + 2 * t + 8 * q;
#pragma unroll
            for (int hm = 0; hm < 2; ++hm) {  // source columns m0 and m1
              const int m = hm ? m1 : m0;
              float v0 = 0.0f, v1 = 0.0f;
              if (m < n.cols) {
                if (k0 < nr) v0 = stage[k0 * kPitch + m];
                if (k0 + 1 < nr) v1 = stage[(k0 + 1) * kPitch + m];
              }
              split_pair(v0, v1, a[kk], 2 * q + hm);
            }
          }
        }
        fence_async();
        mbar_arrive(empty + st);
        consumers_sync();  // the last product's reads of B are done
        build_onehot(onehot, tid, [&](int) {
          return row_src < 0 ? -1 : row_src - (n.r0 + r);
        });
        fence_async();
        consumers_sync();
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk) {
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            wgmma_m64n8(acc1[k], a[kk][k], b_desc(onehot + kk * 256));
          }
        }
        wgmma_commit_wait();
#pragma unroll
        for (int k = 0; k < 3; ++k) keep(acc1[k]);
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk) {
#pragma unroll
          for (int k = 0; k < 3; ++k) keep(a[kk][k]);
        }
      }
      // rows^T as B of the column product, the three parts side by side
      // (N = 24, part k the columns 8 k ..): element (source column m,
      // output row j) of part k in step m / 16 (768 bytes), group k (256),
      // half (m % 16) / 8 (128), core-matrix row j, position m % 8. The
      // values are exact bf16.
      consumers_sync();  // the last unit's column products are done
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        unsigned char* bk = rows_t + warp * 768 + k * 256 + g * 2;
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const int j = 2 * t + (f & 1);
          *reinterpret_cast<__nv_bfloat16*>(bk + (f >> 1) * 128 + j * 16) =
              __float2bfloat16_rn(acc1[k][f]);
        }
      }
      fence_async();
      consumers_sync();
      for (int base = n.lo; base < n.hi; base += 64) {
        // A = Px^T: output-column slots base + m0 and + m1 x source
        // columns, one-hot in registers.
        if (base != n.lo) {
          x0 = base + m0 < n.hi ? __ldg(ix + base + m0) - n.c0 : -1;
          x1 = base + m1 < n.hi ? __ldg(ix + base + m1) - n.c0 : -1;
        }
        uint32_t px[kSteps][4];
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk) {
          const int k0 = kk * 16 + 2 * t;
          px[kk][0] = onehot_pair(x0, k0);
          px[kk][1] = onehot_pair(x1, k0);
          px[kk][2] = onehot_pair(x0, k0 + 8);
          px[kk][3] = onehot_pair(x1, k0 + 8);
        }
        // One product for the three parts, each in its own columns: no
        // sum of parts is taken inside the tensor core.
        float acc2[3][4] = {};
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk) {
          wgmma_m64n24(&acc2[0][0], px[kk],
                       b_desc(rows_t + kk * 768, 256));
        }
        wgmma_commit_wait();
#pragma unroll
        for (int k = 0; k < 3; ++k) keep(acc2[k]);
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk) keep(px[kk]);
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const int ox = base + (f < 2 ? m0 : m1);
          const int oy = n.oy0 + 2 * t + (f & 1);
          if (ox < n.hi && oy < s) {
            dst[static_cast<long long>(oy) * s + ox] =
                __fadd_rn(__fadd_rn(acc2[0][f], acc2[1][f]), acc2[2][f]);
          }
        }
      }
    }
  }
}

using Kernel = void (*)(const CUtensorMap, const float*, const int*,
                        const int*, float*, int, int, int, int, int, int,
                        int, int);

// Resident blocks on the card for each kernel and shared-memory size on
// each device, found once: the attributes are set then, so a launch under
// CUDA graph capture makes no such call.
struct Prepared {
  int dev;
  Kernel kernel;
  int smem;
  int slots;
};
std::mutex prepared_mutex;
std::vector<Prepared> prepared;

cudaError_t slots_for(Kernel kernel, int smem, int max_smem, int* slots) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(prepared_mutex);
  for (const Prepared& p : prepared) {
    if (p.dev == dev && p.kernel == kernel && p.smem == smem) {
      *slots = p.slots;
      return cudaSuccess;
    }
  }
  int sms = 0, per_sm = 0;
  // Any launch's size, and the SM's memory split for the most shared
  // memory (blocks an SM).
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  }
  if (err != cudaSuccess) return err;
  *slots = sms * (per_sm > 0 ? per_sm : 1);
  prepared.push_back({dev, kernel, smem, *slots});
  return cudaSuccess;
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no -lcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

template <int kRowsMode>
int launch(const float* frame, const int* iy, const int* ix, float* out,
           int planes, int h, int w, int s, cudaStream_t st) {
  using G = Stage<kRowsMode>;
  constexpr int kTile = kRowsMode == 0 ? kGatherRows : kMmaRows;
  const int row_tiles = (s + kTile - 1) / kTile;
  const int wide = (w + G::kCols - 1) / G::kCols;
  const int chunks = (w + kChunk - 1) / kChunk;
  const long long units = static_cast<long long>(planes) * row_tiles * wide;
  if (units > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  // Bulk and tensor copies move 16-byte multiples between 16-byte aligned
  // addresses: rows of a multiple of 4 floats from an aligned frame; the
  // tensor's row coordinate is 32-bit.
  const bool async =
      w % 4 == 0 && reinterpret_cast<std::uintptr_t>(frame) % 16 == 0 &&
      (kRowsMode == 0 || static_cast<long long>(planes) * h <= INT_MAX);
  // v2's stage: at most 64 slab rows, and no more than a slab of 8 output
  // rows can span, 7 H / s + 3 (the float64 table may round each end).
  const int stage_rows = static_cast<int>(
      std::min(64LL, 7LL * h / s + 3));
  CUtensorMap map{};
  if (async && kRowsMode == 1) {
    const EncodeTiled encode = encoder();
    if (!encode) return static_cast<int>(cudaErrorNotSupported);
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(w),
                                static_cast<cuuint64_t>(planes) * h};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(w) * 4};
    const cuuint32_t box[2] = {static_cast<cuuint32_t>(G::kPitch),
                               static_cast<cuuint32_t>(stage_rows)};
    const cuuint32_t unit[2] = {1, 1};
    if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
               const_cast<float*>(frame), dims, strides, box, unit,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const Kernel kernel = async ? downsample_onehot_kernel<kRowsMode, true>
                              : downsample_onehot_kernel<kRowsMode, false>;
  const int smem =
      G::kSmem + (chunks + 1 <= kMaxStarts ? 4 * (chunks + 1) : 0);
  int slots = 0;
  const cudaError_t err =
      slots_for(kernel, smem, G::kSmem + 4 * kMaxStarts, &slots);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = static_cast<int>(units < slots ? units : slots);
  kernel<<<blocks, kThreads, smem, st>>>(map, frame, iy, ix, out, h, w, s,
                                         row_tiles, wide, chunks,
                                         static_cast<int>(units), stage_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int hdrnet_downsample_onehot(const void* frame, const void* iy,
                                        const void* ix, void* out, int planes,
                                        int h, int w, int s, int rows,
                                        void* stream) {
  if (planes == 0 || s == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* f = static_cast<const float*>(frame);
  const int* iy_p = static_cast<const int*>(iy);
  const int* ix_p = static_cast<const int*>(ix);
  float* o = static_cast<float*>(out);
  return rows ? launch<1>(f, iy_p, ix_p, o, planes, h, w, s, st)
              : launch<0>(f, iy_p, ix_p, o, planes, h, w, s, st);
}
