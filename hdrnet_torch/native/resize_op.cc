// hdrnet::resize_bilinear in C++, for the native runner (aoti_serve.cc):
// the separable bilinear resize that the pyramid's and the multiscale
// zoo models' exported graphs call, bit for bit the Python op
// (hdrnet_torch/ops/resize.py: _linear_taps, _resize_bilinear and the
// forward of _Lerp), so the runner's pyramid levels are the eager ones.
//
// It has no kernel: the JAX package leaves the resize to XLA
// (hdrnet_tpu/ops/resize.py). The tap tables are computed on the host in
// double, as numpy computes them there (a float or a reassociated scale
// picks another source row at some extents), and the gathers and blends
// are the Python forward's ATen calls in its order: rows (axis ndim - 3)
// first, then columns (ndim - 2), each a + (b - a) * frac with a and b
// from index_select. ATen is device-agnostic, so the op is registered for
// CPU and CUDA tensors alike: libhdrnet_ops.so holds it beside the
// kernel-backed ops, and a library of this source alone (built with the
// CPU wheel, no CUDA toolkit) serves a CPU package in the tests.
//
// The schema is the one torch.library.custom_op infers for the Python op
// (torch.ops.hdrnet.resize_bilinear.default._schema). hdrnet_ops.cc
// defines the namespace (TORCH_LIBRARY); this source adds to it
// (TORCH_LIBRARY_FRAGMENT), so it links beside it or alone. Each call adds
// one to a count that the runner's report shows under hdrnet_op_calls.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <map>
#include <mutex>
#include <tuple>

#include <ATen/ATen.h>
#include <torch/library.h>

namespace {

std::atomic<long long> g_resize_bilinear{0};

// One axis's taps: the int64 source rows i0, i1 and the float32 blend
// weight of each output, on the device.
struct Taps {
  at::Tensor i0, i1, frac;
};

// ops/resize.py's _linear_taps: src = i * ((n_in - 1) / max(n_out - 1, 1))
// with align_corners and n_out > 1, else i * (n_in / n_out) (the scale
// divided first, then multiplied, in double); i0 = floor(src), frac =
// float(src - i0), then i0 and i0 + 1 clipped to [0, n_in - 1]. Cached by
// (n_in, n_out, align_corners, device), as linear_tap_tensors is, so a
// serving loop uploads them once a size.
const Taps& LinearTaps(int64_t n_in, int64_t n_out, bool align_corners,
                       const at::Device& dev) {
  static std::mutex mu;
  static std::map<std::tuple<int64_t, int64_t, bool, int, int>, Taps> cache;
  std::lock_guard<std::mutex> lock(mu);
  auto key = std::make_tuple(n_in, n_out, align_corners,
                             static_cast<int>(dev.type()),
                             static_cast<int>(dev.index()));
  auto it = cache.find(key);
  if (it != cache.end()) return it->second;
  const double scale =
      align_corners && n_out > 1
          ? static_cast<double>(n_in - 1) /
                static_cast<double>(std::max<int64_t>(n_out - 1, 1))
          : static_cast<double>(n_in) / static_cast<double>(n_out);
  const auto int64 = at::TensorOptions().dtype(at::kLong);
  at::Tensor i0 = at::empty({n_out}, int64), i1 = at::empty({n_out}, int64);
  at::Tensor frac = at::empty({n_out}, at::TensorOptions().dtype(at::kFloat));
  int64_t* p0 = i0.data_ptr<int64_t>();
  int64_t* p1 = i1.data_ptr<int64_t>();
  float* pf = frac.data_ptr<float>();
  for (int64_t i = 0; i < n_out; ++i) {
    const double src = static_cast<double>(i) * scale;
    const int64_t lo = static_cast<int64_t>(std::floor(src));
    pf[i] = static_cast<float>(src - static_cast<double>(lo));
    p0[i] = std::min(std::max<int64_t>(lo, 0), n_in - 1);
    p1[i] = std::min(std::max<int64_t>(p0[i] + 1, 0), n_in - 1);
  }
  Taps taps{i0.to(dev), i1.to(dev), frac.to(dev)};
  return cache.emplace(key, std::move(taps)).first->second;
}

// _Lerp.forward: a + (b - a) * frac with a, b the rows of x at i0, i1
// along `dim`.
at::Tensor Lerp(const at::Tensor& x, int64_t dim, const Taps& taps,
                const at::Tensor& frac) {
  at::Tensor a = at::index_select(x, dim, taps.i0);
  at::Tensor b = at::index_select(x, dim, taps.i1);
  return a + (b - a) * frac;
}

at::Tensor ResizeBilinear(const at::Tensor& x, int64_t h, int64_t w,
                          bool align_corners) {
  constexpr const char* kOp = "hdrnet::resize_bilinear";
  TORCH_CHECK(x.dim() >= 3, kOp, ": x must be (..., H, W, C), got ",
              x.sizes());
  TORCH_CHECK(h > 0 && w > 0, kOp, ": the target extent must be positive, "
              "got (", h, ", ", w, ")");
  ++g_resize_bilinear;
  const int64_t n = x.dim();
  // An unchanged size: a copy (an op's output is its own).
  if (x.size(n - 3) == h && x.size(n - 2) == w) return x.clone();
  const Taps& ty = LinearTaps(x.size(n - 3), h, align_corners, x.device());
  const Taps& tx = LinearTaps(x.size(n - 2), w, align_corners, x.device());
  // Broadcast over (..., h, W, C) and (..., H, w, C).
  at::Tensor fy = ty.frac.to(x.scalar_type()).reshape({h, 1, 1});
  at::Tensor fx = tx.frac.to(x.scalar_type()).reshape({w, 1});
  at::Tensor rows = Lerp(x, n - 3, ty, fy);
  return Lerp(rows, n - 2, tx, fx);
}

}  // namespace

TORCH_LIBRARY_FRAGMENT(hdrnet, m) {
  m.def("resize_bilinear(Tensor x, SymInt h, SymInt w, bool align_corners) "
        "-> Tensor");
}

TORCH_LIBRARY_IMPL(hdrnet, CPU, m) {
  m.impl("resize_bilinear", &ResizeBilinear);
}

TORCH_LIBRARY_IMPL(hdrnet, CUDA, m) {
  m.impl("resize_bilinear", &ResizeBilinear);
}

// The op's calls in this process (hdrnet_ops.cc adds them to its report).
extern "C" long long hdrnet_resize_bilinear_calls() {
  return g_resize_bilinear.load();
}

// The report of a library built from this source alone. In
// libhdrnet_ops.so, hdrnet_ops.cc's definition, which adds the kernels'
// launches, takes the place of this weak one.
extern "C" __attribute__((weak)) const char* hdrnet_ops_launch_counts() {
  static thread_local char buf[64];
  std::snprintf(buf, sizeof(buf), "{\"resize_bilinear\": %lld}",
                g_resize_bilinear.load());
  return buf;
}
