// The hdrnet:: ops in C++, for the native runner (aoti_serve.cc): the
// kernel-backed ops that the port's exported serving graphs call, on CUDA
// tensors, through the extern "C" launchers of libhdrnet_kernels.so
// (declared in hdrnet_torch/csrc/launchers.cuh, which the kernels'
// sources include too).
//
//   hdrnet::nearest_lowres   K2, csrc/downsample.cu        (ops/downsample.py)
//   hdrnet::enhance_fused    K1 (curves) and K6 (nn), with K7's band
//                            arguments, csrc/fused_slice_apply.cu
//                                                          (ops/fused.py)
//   hdrnet::slice_apply_fwd  K3, csrc/slice_apply.cu       (ops/slice_apply.py)
//
// The library also holds hdrnet::resize_bilinear (resize_op.cc, no kernel:
// ATen calls on CPU and CUDA tensors), which this source's report counts.
//
// Each schema is the one torch.library.custom_op infers for the Python op
// (torch.ops.hdrnet.<op>.default._schema), since an AOTInductor package
// names its ops by qualified name and the loader looks them up here. The
// checks and the argument packing (grid layout, band, scales, u8 flags)
// are the Python wrappers'. There is no CPU implementation and no
// fallback: an op on a CPU tensor raises. Each launch adds one to its
// kernel's count, which hdrnet_ops_launch_counts() reports.
//
// Never load this library into a Python process: hdrnet_torch.ops defines
// the hdrnet namespace there, and only one TORCH_LIBRARY may define a
// namespace. The runner loads it (--ops_library).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <initializer_list>
#include <map>
#include <mutex>
#include <optional>
#include <string>
#include <tuple>

#include <ATen/ATen.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <torch/library.h>

#include "launchers.cuh"  // hdrnet_torch/csrc

namespace {

// Launches a kernel, never a plain version; in the order the report names
// them.
std::atomic<long long> g_nearest_lowres{0};   // K2
std::atomic<long long> g_fused_curves{0};     // K1
std::atomic<long long> g_fused_nn{0};         // K6
std::atomic<long long> g_slice_apply_fwd{0};  // K3

constexpr int64_t kNIn = 3;
constexpr int64_t kNOut = 3;
constexpr int64_t kNPts = 16;
constexpr int64_t kChannels = kNOut * (kNIn + 1);
constexpr int64_t kCurvesParams =
    (kNIn + 1) * kNIn + 2 * kNIn * kNPts + kNIn + 1;  // 112
constexpr int64_t kMaxGuideComplexity = 64;

void* Stream(const at::Tensor& t) {
  return static_cast<void*>(
      c10::cuda::getCurrentCUDAStream(t.device().index()).stream());
}

void CheckLaunch(int err, const char* launcher) {
  TORCH_CHECK(err == 0, launcher, ": CUDA error ", err, " at launch");
}

// CUDA and contiguous, on one device: the kernels take nothing else.
void CheckOnCard(const char* op, std::initializer_list<at::Tensor> ts) {
  const at::Device dev = ts.begin()->device();
  for (const at::Tensor& t : ts) {
    TORCH_CHECK(t.is_cuda(), op, ": the kernel takes CUDA tensors, got one "
                "on ", t.device(), " (the op library has no CPU version)");
    TORCH_CHECK(t.device() == dev, op, ": tensors on different devices: ",
                dev, ", ", t.device());
    TORCH_CHECK(t.is_contiguous(), op, ": tensors must be contiguous");
  }
}

int Int(int64_t v, const char* what) {
  TORCH_CHECK(v >= 0 && v < (int64_t{1} << 31), what, " ", v,
              " does not fit the kernel's 32-bit argument");
  return static_cast<int>(v);
}

// The nearest table floor(dst * (n_in / n_out)), clipped (ops/resize.py's
// _nearest_indices: the scale and products in double), as int32 on the
// device; cached by (n_in, n_out, device), as nearest_index_tensor is.
at::Tensor NearestIndex(int64_t n_in, int64_t n_out, const at::Device& dev) {
  static std::mutex mu;
  static std::map<std::tuple<int64_t, int64_t, int>, at::Tensor> cache;
  std::lock_guard<std::mutex> lock(mu);
  auto key = std::make_tuple(n_in, n_out, static_cast<int>(dev.index()));
  auto it = cache.find(key);
  if (it != cache.end()) return it->second;
  at::Tensor host = at::empty({n_out}, at::TensorOptions().dtype(at::kInt));
  int32_t* idx = host.data_ptr<int32_t>();
  const double scale = static_cast<double>(n_in) / static_cast<double>(n_out);
  for (int64_t d = 0; d < n_out; ++d) {
    int64_t v = static_cast<int64_t>(std::floor(static_cast<double>(d) *
                                                scale));
    idx[d] = static_cast<int32_t>(std::min(std::max<int64_t>(v, 0),
                                           n_in - 1));
  }
  at::Tensor table = host.to(dev);
  cache.emplace(key, table);
  return table;
}

// ---- hdrnet::nearest_lowres (K2) -------------------------------------------

at::Tensor NearestLowres(const at::Tensor& frame, int64_t s) {
  constexpr const char* kOp = "hdrnet::nearest_lowres";
  TORCH_CHECK(frame.dim() == 4, kOp, ": frame must be (B, H, W, C), got ",
              frame.sizes());
  TORCH_CHECK(frame.scalar_type() == at::kFloat ||
                  frame.scalar_type() == at::kByte,
              kOp, ": frame must be float32 or uint8, got ",
              frame.scalar_type());
  TORCH_CHECK(s > 0, kOp, ": preview size must be positive, got ", s);
  CheckOnCard(kOp, {frame});
  const int64_t b = frame.size(0), h = frame.size(1), w = frame.size(2),
                c = frame.size(3);
  c10::cuda::CUDAGuard guard(frame.device());
  at::Tensor iy = NearestIndex(h, s, frame.device());
  at::Tensor ix = NearestIndex(w, s, frame.device());
  at::Tensor out = at::empty({b, c, s, s}, frame.options().dtype(at::kFloat));
  CheckLaunch(hdrnet_nearest_lowres(
                  frame.data_ptr(), frame.scalar_type() == at::kByte,
                  iy.data_ptr(), ix.data_ptr(), out.data_ptr(),
                  Int(b, "B"), Int(h, "H"), Int(w, "W"), Int(c, "C"),
                  Int(s, "s"), Stream(frame)),
              "hdrnet_nearest_lowres");
  ++g_nearest_lowres;
  return out;
}

// ---- hdrnet::enhance_fused (K1, K6) -----------------------------------------

// gc of a packed NN-guide vector ((n_in + 2) * gc + 1 values).
int64_t NNGuideComplexity(const at::Tensor& params, const char* op) {
  const int64_t n = params.numel();
  const int64_t gc = (n - 1) / (kNIn + 2);
  TORCH_CHECK(n >= 1 && (n - 1) % (kNIn + 2) == 0 && gc >= 1, op,
              ": NN guide params must pack (n_in+2)*gc + 1 values, got ", n);
  TORCH_CHECK(gc <= kMaxGuideComplexity, op, ": guide complexity ", gc,
              " > ", kMaxGuideComplexity, ", the kernel's shared-memory "
              "bound");
  return gc;
}

// The offset and total of one axis of a band; raises unless the band's
// [off, off + local) lies in [0, total).
int64_t BandTotal(const char* op, const char* axis, int64_t off,
                  int64_t local, std::optional<int64_t> total) {
  const int64_t t = total.has_value() ? *total : local;
  TORCH_CHECK(off >= 0 && off <= t - local, op, ": ", axis, " band [", off,
              ", ", off + local, ") outside [0, ", t, ")");
  return t;
}

at::Tensor EnhanceFused(const at::Tensor& grid5, const at::Tensor& frame,
                        const at::Tensor& params, c10::string_view guide_mode,
                        bool clip_output, bool u8_output, int64_t y_offset,
                        int64_t x_offset, std::optional<int64_t> h_total,
                        std::optional<int64_t> w_total) {
  constexpr const char* kOp = "hdrnet::enhance_fused";
  const bool nn = guide_mode == "nn";
  TORCH_CHECK(nn || guide_mode == "curves", kOp,
              ": guide_mode must be 'curves' or 'nn', got '",
              std::string(guide_mode), "'");
  TORCH_CHECK(!u8_output || clip_output, kOp,
              ": u8 output requires clip_output=True");
  TORCH_CHECK(grid5.dim() == 5 && grid5.size(4) == kChannels, kOp,
              ": grid must be (B, gh, gw, gd, ", kChannels, "), got ",
              grid5.sizes());
  TORCH_CHECK(frame.dim() == 4 && frame.size(3) == kNIn, kOp,
              ": frame must be (B, H, W, ", kNIn, "), got ", frame.sizes());
  TORCH_CHECK(grid5.size(0) == frame.size(0), kOp, ": batch mismatch: grid ",
              grid5.size(0), ", frame ", frame.size(0));
  TORCH_CHECK(grid5.scalar_type() == at::kFloat &&
                  params.scalar_type() == at::kFloat,
              kOp, ": grid and params must be float32");
  TORCH_CHECK(frame.scalar_type() == at::kFloat ||
                  frame.scalar_type() == at::kByte,
              kOp, ": frame must be float32 or uint8, got ",
              frame.scalar_type());
  TORCH_CHECK(params.dim() == 1, kOp, ": params must be a packed vector, "
              "got ", params.sizes());
  const int64_t gc = nn ? NNGuideComplexity(params, kOp) : 0;
  TORCH_CHECK(nn || params.numel() == kCurvesParams, kOp,
              ": curves params must be packed (", kCurvesParams, ",), got ",
              params.sizes());
  const int64_t b = frame.size(0), h = frame.size(1), w = frame.size(2);
  const int64_t gh = grid5.size(1), gw = grid5.size(2), gd = grid5.size(3);
  const int64_t ht = BandTotal(kOp, "y", y_offset, h, h_total);
  const int64_t wt = BandTotal(kOp, "x", x_offset, w, w_total);
  CheckOnCard(kOp, {grid5, frame, params});
  TORCH_CHECK(reinterpret_cast<uintptr_t>(grid5.data_ptr()) % 16 == 0, kOp,
              ": grid must be 16-byte aligned (the kernel reads float4)");
  // Larger frames run in H-bands inside the launcher; a row must fit.
  TORCH_CHECK(w * kNIn < (int64_t{1} << 31), kOp, ": a row of ", w,
              " pixels exceeds the kernel's 32-bit index");
  c10::cuda::CUDAGuard guard(frame.device());
  at::Tensor out = at::empty(
      {b, h, w, kNOut},
      frame.options().dtype(u8_output ? at::kByte : at::kFloat));
  // The scales in double rounded to float: the value a whole frame of
  // ht x wt gets (the Python wrapper's, rounded by ctypes).
  const float sy = static_cast<float>(static_cast<double>(gh) / ht);
  const float sx = static_cast<float>(static_cast<double>(gw) / wt);
  const int u8_in = frame.scalar_type() == at::kByte;
  if (nn) {
    CheckLaunch(hdrnet_enhance_fused_nn(
                    grid5.data_ptr(), frame.data_ptr(), u8_in,
                    params.data_ptr(), static_cast<int>(gc), out.data_ptr(),
                    u8_output, clip_output, Int(b, "B"), Int(h, "H"),
                    Int(w, "W"), Int(gh, "gh"), Int(gw, "gw"), Int(gd, "gd"),
                    Int(y_offset, "y_offset"), Int(x_offset, "x_offset"),
                    Int(ht, "h_total"), Int(wt, "w_total"), sy, sx,
                    Stream(frame)),
                "hdrnet_enhance_fused_nn");
    ++g_fused_nn;
  } else {
    CheckLaunch(hdrnet_enhance_fused(
                    grid5.data_ptr(), frame.data_ptr(), u8_in,
                    params.data_ptr(), out.data_ptr(), u8_output, clip_output,
                    Int(b, "B"), Int(h, "H"), Int(w, "W"), Int(gh, "gh"),
                    Int(gw, "gw"), Int(gd, "gd"), Int(y_offset, "y_offset"),
                    Int(x_offset, "x_offset"), Int(ht, "h_total"),
                    Int(wt, "w_total"), sy, sx, Stream(frame)),
                "hdrnet_enhance_fused");
    ++g_fused_curves;
  }
  return out;
}

// ---- hdrnet::slice_apply_fwd (K3) -------------------------------------------

at::Tensor SliceApplyFwd(const at::Tensor& grid5, const at::Tensor& guide,
                         const at::Tensor& image, bool has_offset) {
  constexpr const char* kOp = "hdrnet::slice_apply_fwd";
  TORCH_CHECK(grid5.dim() == 5, kOp, ": grid must be (B, gh, gw, gd, C), "
              "got ", grid5.sizes());
  TORCH_CHECK(guide.dim() == 3 && image.dim() == 4, kOp,
              ": guide must be (B, H, W) and image (B, H, W, n_in), got ",
              guide.sizes(), ", ", image.sizes());
  const int64_t b = guide.size(0), h = guide.size(1), w = guide.size(2);
  const int64_t n_in = image.size(3);
  const int64_t ni_tot = n_in + (has_offset ? 1 : 0);
  TORCH_CHECK(ni_tot != 0 && grid5.size(4) % ni_tot == 0, kOp,
              ": grid channels ", grid5.size(4), " do not split into n_in + "
              "offset = ", ni_tot);
  const int64_t n_out = grid5.size(4) / ni_tot;
  TORCH_CHECK(image.size(0) == b && image.size(1) == h && image.size(2) == w
                  && grid5.size(0) == b,
              kOp, ": batch or size mismatch: grid ", grid5.sizes(),
              ", guide ", guide.sizes(), ", image ", image.sizes());
  for (const at::Tensor& t : {grid5, guide, image})
    TORCH_CHECK(t.scalar_type() == at::kFloat, kOp,
                ": the kernel takes float32 tensors, got ", t.scalar_type());
  CheckOnCard(kOp, {grid5, guide, image});
  const int64_t gh = grid5.size(1), gw = grid5.size(2), gd = grid5.size(3);
  c10::cuda::CUDAGuard guard(guide.device());
  at::Tensor out = at::empty({b, h, w, n_out},
                             guide.options().dtype(at::kFloat));
  // The whole frame: band (0, H), the scales gh / H and gw / W.
  const float sy = static_cast<float>(static_cast<double>(gh) / h);
  const float sx = static_cast<float>(static_cast<double>(gw) / w);
  CheckLaunch(hdrnet_slice_apply_fwd(
                  grid5.data_ptr(), guide.data_ptr(), image.data_ptr(),
                  out.data_ptr(), Int(b, "B"), Int(h, "H"), Int(w, "W"),
                  Int(gh, "gh"), Int(gw, "gw"), Int(gd, "gd"),
                  Int(n_in, "n_in"), Int(n_out, "n_out"), has_offset, 0,
                  Int(h, "H"), sy, sx, Stream(guide)),
              "hdrnet_slice_apply_fwd");
  ++g_slice_apply_fwd;
  return out;
}

}  // namespace

TORCH_LIBRARY(hdrnet, m) {
  m.def("nearest_lowres(Tensor frame, SymInt s) -> Tensor");
  m.def("enhance_fused(Tensor grid5, Tensor frame, Tensor params, "
        "str guide_mode, bool clip_output, bool u8_output, SymInt y_offset, "
        "SymInt x_offset, SymInt? h_total, SymInt? w_total) -> Tensor");
  m.def("slice_apply_fwd(Tensor grid5, Tensor guide, Tensor image, "
        "bool has_offset) -> Tensor");
}

TORCH_LIBRARY_IMPL(hdrnet, CUDA, m) {
  m.impl("nearest_lowres", &NearestLowres);
  m.impl("enhance_fused", &EnhanceFused);
  m.impl("slice_apply_fwd", &SliceApplyFwd);
}

extern "C" long long hdrnet_resize_bilinear_calls();  // resize_op.cc

// The kernels' launches and the resize's calls in this process, as one
// JSON object.
extern "C" const char* hdrnet_ops_launch_counts() {
  static thread_local char buf[256];
  std::snprintf(buf, sizeof(buf),
                "{\"nearest_lowres\": %lld, \"enhance_fused_curves\": %lld, "
                "\"enhance_fused_nn\": %lld, \"slice_apply_fwd\": %lld, "
                "\"resize_bilinear\": %lld}",
                g_nearest_lowres.load(), g_fused_curves.load(),
                g_fused_nn.load(), g_slice_apply_fwd.load(),
                hdrnet_resize_bilinear_calls());
  return buf;
}
