// Native runner of the port's AOTInductor packages: the counterpart of
// hdrnet_tpu/native/pjrt_serve.cc, with no Python in the serving process.
//
// `python -m hdrnet_torch.bin.export ckpt --aoti` compiles each serving
// graph into `<name>.aoti.pt2` beside its `<name>.manifest.json`. This
// binary loads such a package with torch::inductor::AOTIModelPackageLoader
// and runs it. The graphs call the port's kernels as `hdrnet::` ops
// (hdrnet::nearest_lowres, hdrnet::enhance_fused, hdrnet::slice_apply_fwd)
// and the pyramid's levels as hdrnet::resize_bilinear, which the package
// names and the loader looks up in the C++ dispatcher, so a package that
// calls them needs libhdrnet_ops.so (hdrnet_ops.cc and resize_op.cc)
// loaded first: --ops_library, the counterpart of pjrt_serve's --plugin.
//
// Usage:
//   aoti_serve <package.aoti.pt2>
//       [--manifest <name>.manifest.json]   default: beside the package
//       [--ops_library libhdrnet_ops.so]
//       [--dim H=1080 --dim W=1920]         binds the manifest's dynamic
//                                           dimensions (serve_any_fn)
//       [--inputs in0.bin,in1.bin]          raw little-endian, dense, with
//                                           the manifest's shapes and dtypes
//                                           (float32 or uint8)
//       [--output out.bin]                  first output, raw
//       [--burn 3] [--iters 20]
//       [--report report.json]
//
// A manifest dimension is a number or the name of a torch.export.Dim
// whose range the manifest records under "dims" ({"H": {"min": 8, "max":
// 16384}}). Every name in a shape must be bound by --dim to a value in its
// range, and every --dim must bind a name the manifest records. One run
// serves one shape: two sizes are two runs of one package. The package
// also checks its inputs against its own guards at run time
// (AOTI_RUNTIME_CHECK_INPUTS is set), and a failed guard exits 1 with the
// guard's message.
//
// It applies the manifest's "precision" record (TF32 off for cuDNN and
// cuBLAS: a graph does not carry torch's switches) before the first run,
// runs the package on the device its "aoti" record names (a CUDA package
// without a visible card is an error), and prints one JSON object with
// pjrt_serve's stage keys (init = the op library's load, compile = the
// package's load, upload, forward per iteration, readback), the shapes it
// served and hdrnet_op_calls, the op library's kernel launches and resize
// calls in this process. Every failure exits 1 with a message naming its
// cause.

#include <dlfcn.h>

#include <algorithm>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <fstream>
#include <map>
#include <memory>
#include <sstream>
#include <string>
#include <vector>

#include <ATen/ATen.h>
#include <ATen/Context.h>
#include <c10/util/Exception.h>
#include <torch/csrc/inductor/aoti_package/model_package_loader.h>
#include <torch/cuda.h>

namespace {

double NowMs() {
  return std::chrono::duration<double, std::milli>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

[[noreturn]] void Die(const std::string& msg) {
  std::fprintf(stderr, "aoti_serve: FATAL: %s\n", msg.c_str());
  std::exit(1);
}

std::string ReadFile(const std::string& path, const std::string& what) {
  std::ifstream f(path, std::ios::binary);
  if (!f) Die("cannot read " + what + " " + path);
  std::ostringstream ss;
  ss << f.rdbuf();
  return ss.str();
}

// ---------------------------------------------------------------------
// The manifest: bin/export.py writes a fixed schema
// ({"inputs": [{"shape": [..], "dtype": ".."}], "outputs": [..],
//   "dims": {"H": {"min": .., "max": ..}}, "precision": {..},
//   "aoti": {"package": .., "device": ..}}); this scanner reads that
// schema, not general JSON.
// ---------------------------------------------------------------------

std::string Shape(const std::vector<int64_t>& dims) {
  std::string s = "[";
  for (size_t i = 0; i < dims.size(); ++i)
    s += (i ? ", " : "") + std::to_string(dims[i]);
  return s + "]";
}

struct TensorSpec {
  std::vector<int64_t> dims;
  std::vector<std::string> names;  // a dynamic dimension's name, else ""
  at::ScalarType dtype = at::kFloat;
  int64_t NumElements() const {
    int64_t n = 1;
    for (int64_t d : dims) n *= d;
    return n;
  }
  int64_t NumBytes() const {
    return NumElements() * static_cast<int64_t>(at::elementSize(dtype));
  }
  std::string Describe() const {
    return Shape(dims) + " " + (dtype == at::kByte ? "uint8" : "float32");
  }
};

struct DimRange {
  int64_t min, max;
};

size_t FindKey(const std::string& json, const std::string& key,
               size_t from = 0) {
  return json.find("\"" + key + "\"", from);
}

// The index of the bracket that closes the one at `open`.
size_t Closing(const std::string& json, size_t open) {
  const char o = json[open], c = o == '[' ? ']' : '}';
  int depth = 0;
  for (size_t i = open; i < json.size(); ++i) {
    if (json[i] == o) depth++;
    if (json[i] == c && --depth == 0) return i;
  }
  return std::string::npos;
}

bool IsCount(const std::string& s) {
  return !s.empty() && s.find_first_not_of("0123456789") == std::string::npos;
}

// A decimal count that fits int64 (at most 18 digits); else exits 1 naming
// `what`.
int64_t Count(const std::string& s, const std::string& what) {
  if (!IsCount(s) || s.size() > 18) Die(what + ": " + s + " is not a count");
  return std::stoll(s);
}

// The string value of "key" at or after `from`.
std::string StringValue(const std::string& json, const std::string& key,
                        size_t from, const std::string& where) {
  size_t at = FindKey(json, key, from);
  if (at == std::string::npos) Die(where + " has no \"" + key + "\"");
  size_t open = json.find('"', json.find(':', at) + 1);
  size_t close = json.find('"', open + 1);
  return json.substr(open + 1, close - open - 1);
}

// The boolean value of "key" at or after `from`.
bool BoolValue(const std::string& json, const std::string& key, size_t from,
               const std::string& where) {
  size_t at = FindKey(json, key, from);
  if (at == std::string::npos) Die(where + " has no \"" + key + "\"");
  size_t v = json.find_first_not_of(" \t\r\n", json.find(':', at) + 1);
  if (json.compare(v, 4, "true") == 0) return true;
  if (json.compare(v, 5, "false") == 0) return false;
  Die(where + ": \"" + key + "\" is not true or false");
}

// The count value of "key" in json[from, to).
int64_t CountValue(const std::string& json, const std::string& key,
                   size_t from, size_t to, const std::string& where) {
  size_t at = FindKey(json, key, from);
  if (at == std::string::npos || at > to)
    Die(where + " has no \"" + key + "\"");
  size_t v = json.find_first_not_of(" \t\r\n", json.find(':', at) + 1);
  size_t end = json.find_first_of(",} \t\r\n", v);
  return Count(json.substr(v, end - v), where + ": \"" + key + "\"");
}

// {name: range} of the "dims" record; empty where there is none.
std::map<std::string, DimRange> ParseDims(const std::string& json,
                                          const std::string& where) {
  std::map<std::string, DimRange> out;
  size_t at = FindKey(json, "dims");
  if (at == std::string::npos) return out;
  size_t open = json.find('{', at);
  size_t end = Closing(json, open);
  size_t pos = open + 1;
  while (true) {
    size_t q = json.find('"', pos);
    if (q == std::string::npos || q > end) break;
    size_t q2 = json.find('"', q + 1);
    std::string name = json.substr(q + 1, q2 - q - 1);
    size_t close = json.find('}', q2);
    const std::string what = where + " dims." + name;
    out[name] = {CountValue(json, "min", q2, close, what),
                 CountValue(json, "max", q2, close, what)};
    pos = close + 1;
  }
  return out;
}

std::vector<TensorSpec> ParseSpecs(const std::string& json,
                                   const std::string& key,
                                   const std::string& where) {
  size_t at = FindKey(json, key);
  if (at == std::string::npos) Die(where + " has no \"" + key + "\"");
  size_t open = json.find('[', at);
  // The section ends at the matching ']' of the outer array.
  size_t end = Closing(json, open);
  std::vector<TensorSpec> specs;
  size_t pos = open;
  while (true) {
    size_t shape_at = FindKey(json, "shape", pos);
    if (shape_at == std::string::npos || shape_at > end) break;
    size_t s_open = json.find('[', shape_at);
    size_t s_close = json.find(']', s_open);
    TensorSpec spec;
    std::stringstream ss(json.substr(s_open + 1, s_close - s_open - 1));
    std::string tok;
    while (std::getline(ss, tok, ',')) {
      size_t first = tok.find_first_not_of(" \t\r\n");
      size_t last = tok.find_last_not_of(" \t\r\n");
      tok = first == std::string::npos ? "" : tok.substr(first,
                                                         last - first + 1);
      if (tok.size() > 2 && tok.front() == '"' && tok.back() == '"') {
        spec.dims.push_back(-1);  // bound by BindDims
        spec.names.push_back(tok.substr(1, tok.size() - 2));
      } else if (IsCount(tok)) {
        spec.dims.push_back(Count(tok, where + ": " + key + " dimension"));
        spec.names.emplace_back();
      } else {
        Die(where + ": " + key + " dimension " + tok +
            " is neither a number nor a dimension's name");
      }
    }
    std::string dtype = StringValue(json, "dtype", s_close, where);
    if (dtype == "float32") {
      spec.dtype = at::kFloat;
    } else if (dtype == "uint8") {
      spec.dtype = at::kByte;
    } else {
      Die(where + ": " + key + " dtype " + dtype +
          " not served (float32 or uint8)");
    }
    specs.push_back(spec);
    pos = s_close;
  }
  if (specs.empty()) Die(where + ": no tensor specs under \"" + key + "\"");
  return specs;
}

// Checks every --dim against the manifest's "dims" (a name it records, a
// value in its range), then gives every named dimension of `specs` its
// bound value; a name without a binding exits 1 naming it.
void BindDims(std::vector<TensorSpec>* specs, const std::string& key,
              const std::map<std::string, int64_t>& bound,
              const std::map<std::string, DimRange>& ranges,
              const std::string& where) {
  for (const auto& [name, value] : bound) {
    auto r = ranges.find(name);
    if (r == ranges.end()) {
      std::string known;
      for (const auto& kv : ranges) known += (known.empty() ? "" : ", ") +
                                             kv.first;
      Die("--dim " + name + "=" + std::to_string(value) + ": " + where +
          " records no dynamic dimension " + name + " (it records: " +
          (known.empty() ? "none" : known) + ")");
    }
    if (value < r->second.min || value > r->second.max)
      Die("--dim " + name + "=" + std::to_string(value) + ": outside the "
          "range [" + std::to_string(r->second.min) + ", " +
          std::to_string(r->second.max) + "] that " + where +
          " records for " + name);
  }
  for (TensorSpec& spec : *specs) {
    for (size_t i = 0; i < spec.dims.size(); ++i) {
      const std::string& name = spec.names[i];
      if (name.empty()) continue;
      if (!ranges.count(name))
        Die(where + ": " + key + " dimension " + name + " is not a number "
            "and the manifest records no range for it under \"dims\"");
      auto b = bound.find(name);
      if (b == bound.end())
        Die(where + ": " + key + " dimension " + name + " is dynamic; bind "
            "it with --dim " + name + "=VALUE (range [" +
            std::to_string(ranges.at(name).min) + ", " +
            std::to_string(ranges.at(name).max) + "])");
      spec.dims[i] = b->second;
    }
  }
}

std::string Trim(std::string s) {
  while (!s.empty() && (s.back() == '\n' || s.back() == ' ')) s.pop_back();
  return s;
}

// A load failure's message; a missing op names what to pass.
std::string LoadFailure(const std::string& package, const std::string& msg) {
  const std::string marker = "Could not find schema for ";
  size_t at = msg.find(marker);
  if (at != std::string::npos) {
    size_t start = at + marker.size();
    size_t stop = msg.find_first_of(". \n", start);
    std::string op = msg.substr(start, stop - start);
    return "loading " + package + ": the package calls the op " + op +
           ", which no loaded library registers (pass --ops_library "
           "libhdrnet_ops.so for the hdrnet:: ops)";
  }
  return "loading " + package + ": " + Trim(msg);
}

}  // namespace

int main(int argc, char** argv) {
  std::string package_path, manifest_path, ops_path, output_path,
      report_path;
  std::vector<std::string> input_paths;
  std::map<std::string, int64_t> bound_dims;
  int burn = 3, iters = 20;

  for (int i = 1; i < argc; ++i) {
    std::string a = argv[i];
    auto next = [&]() -> std::string {
      if (i + 1 >= argc) Die("missing value for " + a);
      return argv[++i];
    };
    auto count = [&]() -> int {
      std::string v = next();
      if (v.empty() || v.find_first_not_of("0123456789") != std::string::npos)
        Die(a + " expects a count, got " + v);
      return std::stoi(v);
    };
    if (a == "--manifest") manifest_path = next();
    else if (a == "--ops_library") ops_path = next();
    else if (a == "--output") output_path = next();
    else if (a == "--report") report_path = next();
    else if (a == "--burn") burn = count();
    else if (a == "--iters") iters = count();
    else if (a == "--dim") {
      const std::string v = next();
      const size_t eq = v.find('=');
      if (eq == std::string::npos || eq == 0)
        Die("--dim expects NAME=VALUE, got " + v);
      const std::string name = v.substr(0, eq);
      if (bound_dims.count(name)) Die("--dim " + name + " given twice");
      bound_dims[name] = Count(v.substr(eq + 1), "--dim " + name);
    } else if (a == "--inputs") {
      std::stringstream ss(next());
      std::string tok;
      while (std::getline(ss, tok, ',')) input_paths.push_back(tok);
    } else if (a.rfind("--", 0) == 0) {
      Die("unknown flag " + a);
    } else if (!package_path.empty()) {
      Die("more than one package: " + package_path + ", " + a);
    } else {
      package_path = a;
    }
  }
  if (package_path.empty())
    Die("usage: aoti_serve <package.aoti.pt2> [--manifest m.json] "
        "[--ops_library libhdrnet_ops.so] [--dim NAME=VALUE ...] "
        "[--inputs a.bin,b.bin] "
        "[--output out.bin] [--burn N] [--iters N] [--report r.json]");
  if (iters < 1) Die("--iters must be at least 1");
  if (!std::ifstream(package_path, std::ios::binary))
    Die("cannot read package " + package_path);
  if (manifest_path.empty()) {
    // <name>.aoti.pt2 -> <name>.manifest.json
    const std::string ext = ".aoti.pt2";
    manifest_path = package_path;
    if (manifest_path.size() > ext.size() &&
        manifest_path.compare(manifest_path.size() - ext.size(), ext.size(),
                              ext) == 0)
      manifest_path.resize(manifest_path.size() - ext.size());
    manifest_path += ".manifest.json";
  }

  const std::string manifest = ReadFile(manifest_path, "manifest");
  const std::string where = "manifest " + manifest_path;
  std::vector<TensorSpec> in_specs = ParseSpecs(manifest, "inputs", where);
  std::vector<TensorSpec> out_specs = ParseSpecs(manifest, "outputs", where);
  const std::map<std::string, DimRange> ranges = ParseDims(manifest, where);
  BindDims(&in_specs, "inputs", bound_dims, ranges, where);
  BindDims(&out_specs, "outputs", bound_dims, ranges, where);
  size_t precision = FindKey(manifest, "precision");
  if (precision == std::string::npos)
    Die(where + " records no precision");
  const bool cudnn_tf32 =
      BoolValue(manifest, "cudnn_allow_tf32", precision, where);
  const bool matmul_tf32 =
      BoolValue(manifest, "matmul_allow_tf32", precision, where);
  size_t aoti = FindKey(manifest, "aoti");
  if (aoti == std::string::npos)
    Die(where + " records no AOTInductor package (\"aoti\"); export with "
                "--aoti");
  const std::string device_name =
      StringValue(manifest, "device", aoti, where);
  if (device_name != "cuda" && device_name != "cpu")
    Die(where + ": device " + device_name + " not served (cuda or cpu)");
  const bool on_card = device_name == "cuda";
  if (on_card && !torch::cuda::is_available())
    Die("the package runs on CUDA and no CUDA device is visible");
  if (!input_paths.empty() && input_paths.size() != in_specs.size())
    Die("--inputs names " + std::to_string(input_paths.size()) +
        " files, the manifest " + std::to_string(in_specs.size()) +
        " inputs");

  // ---- the op library ----------------------------------------------------
  double t0 = NowMs();
  const char* (*op_calls)() = nullptr;
  if (!ops_path.empty()) {
    void* dl = dlopen(ops_path.c_str(), RTLD_NOW | RTLD_GLOBAL);
    if (!dl) Die(std::string("dlopen ") + ops_path + ": " + dlerror());
    op_calls = reinterpret_cast<const char* (*)()>(
        dlsym(dl, "hdrnet_ops_launch_counts"));
    if (!op_calls)
      Die(ops_path + " has no hdrnet_ops_launch_counts (not the hdrnet op "
                     "library)");
  }
  // The package checks its inputs against its guards (sizes, ranges,
  // strides, device) on every run.
  setenv("AOTI_RUNTIME_CHECK_INPUTS", "1", 1);
  // The graph's cuDNN convolutions and cuBLAS products read these at run
  // time; the package was compiled under the same switches.
  at::globalContext().setAllowTF32CuDNN(cudnn_tf32);
  at::globalContext().setAllowTF32CuBLAS(matmul_tf32);
  double t_init = NowMs();

  // ---- the package ---------------------------------------------------------
  std::unique_ptr<torch::inductor::AOTIModelPackageLoader> loader;
  try {
    loader = std::make_unique<torch::inductor::AOTIModelPackageLoader>(
        package_path);
  } catch (const c10::Error& e) {
    Die(LoadFailure(package_path, e.what_without_backtrace()));
  } catch (const std::exception& e) {
    Die(LoadFailure(package_path, e.what()));
  }
  double t_compile = NowMs();
  std::fprintf(stderr, "package %s loaded in %.1f ms (%s)\n",
               package_path.c_str(), t_compile - t_init,
               device_name.c_str());

  // ---- inputs --------------------------------------------------------------
  const at::Device device(on_card ? at::kCUDA : at::kCPU);
  auto sync = [&]() {
    if (on_card) torch::cuda::synchronize();
  };
  std::vector<at::Tensor> host_inputs;
  for (size_t i = 0; i < in_specs.size(); ++i) {
    at::Tensor t = at::empty(in_specs[i].dims,
                             at::TensorOptions().dtype(in_specs[i].dtype));
    const int64_t n = in_specs[i].NumElements();
    if (!input_paths.empty()) {
      std::ifstream f(input_paths[i], std::ios::binary);
      if (!f) Die("cannot read input " + input_paths[i]);
      f.read(static_cast<char*>(t.data_ptr()), in_specs[i].NumBytes());
      if (f.gcount() != static_cast<std::streamsize>(in_specs[i].NumBytes()))
        Die("input file " + input_paths[i] + " holds fewer than the " +
            std::to_string(in_specs[i].NumBytes()) + " bytes of " +
            in_specs[i].Describe());
    } else if (in_specs[i].dtype == at::kByte) {
      // A synthetic photo-like uint8 frame (pjrt_serve's).
      uint8_t* b = t.data_ptr<uint8_t>();
      for (int64_t j = 0; j < n; ++j)
        b[j] = static_cast<uint8_t>(127.5f + 127.5f *
                                                 std::sin(j * 7.61e-5f) *
                                                 std::cos(j * 1.13e-3f));
    } else {
      float* fb = t.data_ptr<float>();
      for (int64_t j = 0; j < n; ++j)
        fb[j] = 0.5f + 0.5f * std::sin(j * 7.61e-5f) * std::cos(j * 1.13e-3f);
    }
    host_inputs.push_back(t);
  }
  std::vector<at::Tensor> inputs;
  for (const at::Tensor& t : host_inputs) inputs.push_back(t.to(device));
  sync();
  double t_upload = NowMs();

  // ---- forward -------------------------------------------------------------
  std::vector<at::Tensor> outputs;
  auto run_once = [&]() {
    try {
      outputs = loader->run(inputs);
    } catch (const c10::Error& e) {
      Die("running " + package_path + ": " +
          Trim(e.what_without_backtrace()));
    } catch (const std::exception& e) {
      Die("running " + package_path + ": " + Trim(e.what()));
    }
  };
  for (int i = 0; i < burn; ++i) run_once();
  sync();
  double t_fwd = NowMs();
  for (int i = 0; i < iters; ++i) run_once();
  sync();
  const double forward_ms = (NowMs() - t_fwd) / iters;

  // ---- readback ------------------------------------------------------------
  if (outputs.size() != out_specs.size())
    Die("the package returned " + std::to_string(outputs.size()) +
        " outputs, the manifest names " + std::to_string(out_specs.size()));
  double t_fetch = NowMs();
  at::Tensor host_out = outputs[0].to(at::kCPU).contiguous();
  const double readback_ms = NowMs() - t_fetch;
  TensorSpec got{host_out.sizes().vec(), {}, host_out.scalar_type()};
  if (got.dims != out_specs[0].dims || got.dtype != out_specs[0].dtype)
    Die("output 0 is " + got.Describe() + ", the manifest says " +
        out_specs[0].Describe());

  at::Tensor values = host_out.to(at::kDouble);
  const double out_mean = values.mean().item<double>();
  const double out_min = values.min().item<double>();
  const double out_max = values.max().item<double>();
  if (!output_path.empty()) {
    std::ofstream f(output_path, std::ios::binary);
    if (!f) Die("cannot write output " + output_path);
    f.write(static_cast<const char*>(host_out.data_ptr()), got.NumBytes());
  }

  const std::string calls = op_calls ? op_calls() : "{}";
  std::string shapes = "{\"inputs\": [";
  for (size_t i = 0; i < in_specs.size(); ++i)
    shapes += (i ? ", " : "") + Shape(in_specs[i].dims);
  shapes += "], \"output\": " + Shape(got.dims) + "}";
  std::string report(1024 + calls.size() + shapes.size(), '\0');
  int len = std::snprintf(
      report.data(), report.size(),
      "{\"init_ms\": %.3f, \"compile_ms\": %.3f, \"upload_ms\": %.3f, "
      "\"forward_ms_per_iter\": %.4f, \"readback_ms\": %.3f, "
      "\"fps\": %.2f, \"iters\": %d, \"burn\": %d, \"out_mean\": %.6f, "
      "\"out_min\": %.6f, \"out_max\": %.6f, \"device\": \"%s\", "
      "\"shapes\": %s, \"hdrnet_op_calls\": %s}",
      t_init - t0, t_compile - t_init, t_upload - t_compile, forward_ms,
      readback_ms, forward_ms > 0 ? 1000.0 / forward_ms : 0.0, iters, burn,
      out_mean, out_min, out_max, device_name.c_str(), shapes.c_str(),
      calls.c_str());
  report.resize(len);
  std::printf("%s\n", report.c_str());
  if (!report_path.empty()) {
    std::ofstream f(report_path);
    if (!f) Die("cannot write report " + report_path);
    f << report << "\n";
  }
  return 0;
}
