"""Builds the CUDA kernels in ``hdrnet_torch/csrc`` and loads them.

Each ``csrc/*.cu`` is compiled for ``sm_90a`` by its own ``nvcc``, all
started together, and one more call links the objects into a shared
library with a plain C interface, loaded with ``ctypes``. The build
happens at first use, into ``build/hdrnet_torch/<hash>/`` at the root of
the checkout, keyed by a hash of the sources (``*.cu`` and ``*.cuh``) and
flags, so a fresh checkout builds once and an edited source rebuilds.
``compile_parallel`` and ``install`` are the build steps that
``hdrnet_torch.native`` shares for its ``g++`` builds.

The op wrappers reach the library through one seam: ``on_card`` picks the
kernel or the plain twin from the tensors' device, and ``launch`` calls a
launcher on the current stream, raises on its error and counts it in
``launches``.

No ``--use_fast_math``: the kernels rely on IEEE division (u8 / 255),
IEEE ``sqrt`` (the smoothed depth tent) and the accurate ``expf`` (the NN
guide's sigmoid) to match the plain versions.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_ROOT = Path(__file__).resolve().parents[2] / 'build' / 'hdrnet_torch'
LIB_NAME = 'libhdrnet_kernels.so'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# The extern "C" launchers of csrc/launchers.cuh; each returns its
# cudaGetLastError().
_SIGNATURES = {
    # frame, u8, iy, ix, out, b, h, w, c, s, stream
    'hdrnet_nearest_lowres': (_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # frame_cf, iy, ix, out, planes, h, w, s, rows (0 gather, 1 mma), stream
    'hdrnet_downsample_onehot': (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # grid, frame, u8_in, params, out, u8_out, clip, b, h, w, gh, gw, gd,
    # y_off, x_off, h_total, w_total, sy, sx, stream
    'hdrnet_enhance_fused': (_P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I,
                             _I, _I, _I, _I, _I, _I, _F, _F, _P),
    # grid, frame, u8_in, params, gc, out, u8_out, clip, b, h, w, gh, gw,
    # gd, y_off, x_off, h_total, w_total, sy, sx, stream
    'hdrnet_enhance_fused_nn': (_P, _P, _I, _P, _I, _P, _I, _I, _I, _I, _I,
                                _I, _I, _I, _I, _I, _I, _I, _F, _F, _P),
    # grid, guide, image, out, b, h, w, gh, gw, gd, n_in, n_out,
    # has_offset, y_off, h_total, sy, sx, stream
    'hdrnet_slice_apply_fwd': (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                               _I, _I, _I, _I, _F, _F, _P),
    # grid, guide, image, ct, d_guide, d_image, b, h, w, gh, gw, gd, n_in,
    # n_out, has_offset, y_off, h_total, sy, sx, stream
    'hdrnet_slice_apply_pix_bwd': (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                   _I, _I, _I, _I, _I, _I, _I, _F, _F, _P),
    # guide, image, ct, scratch, out, b, h, w, gh, gw, gd, n_in, n_out,
    # has_offset, y_off, h_total, sy, sx, pad_y, pad_x, strips, stream
    'hdrnet_slice_apply_grid_bwd': (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                    _I, _I, _I, _I, _I, _I, _F, _F, _I, _I,
                                    _I, _P),
    # b, h, gh, gw, gd, channels, y_off, h_total, pad_y, &strips, &scratch
    # floats -> dynamic shared bytes
    'hdrnet_slice_apply_grid_bwd_plan': (_I, _I, _I, _I, _I, _I, _I, _I, _I,
                                         ctypes.POINTER(_I),
                                         ctypes.POINTER(ctypes.c_longlong)),
    # src, u8_in, iy0, iy1, fy, ix0, ix1, fx, dst, b, h_in, w_in, h_out,
    # w_out, stream
    'hdrnet_pyramid_down': (_P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                            _I, _I, _P),
    # coarse, level, iy0, iy1, fy, ix0, ix1, fx, dst, clip, u8_out, b,
    # h_in, w_in, h_out, w_out, stream
    'hdrnet_pyramid_up_add': (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                              _I, _I, _I, _I, _P),
}


@dataclasses.dataclass(frozen=True)
class KernelLibrary:
  lib: ctypes.CDLL
  path: Path
  log: str         # nvcc's output, with -Xptxas -v resource usage
  seconds: float   # build time; 0.0 when the library was already built


def find_nvcc():
  """nvcc from CUDA_HOME, then PATH, then /usr/local/cuda/bin."""
  cuda_home = os.environ.get('CUDA_HOME')
  if cuda_home and (Path(cuda_home) / 'bin' / 'nvcc').is_file():
    return str(Path(cuda_home) / 'bin' / 'nvcc')
  on_path = shutil.which('nvcc')
  if on_path:
    return on_path
  default = Path('/usr/local/cuda/bin/nvcc')
  if default.is_file():
    return str(default)
  raise RuntimeError('nvcc not found: set CUDA_HOME or put nvcc on PATH')


def _sources(csrc=CSRC):
  srcs = sorted(Path(csrc).glob('*.cu'))
  if not srcs:
    raise RuntimeError(f'no CUDA sources under {csrc}')
  return srcs


def _source_hash(csrc=CSRC):
  h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
  for path in sorted(Path(csrc).glob('*.cu*')):
    h.update(path.name.encode())
    h.update(path.read_bytes())
  return h.hexdigest()[:16]


def _run(cmd):
  t0 = time.perf_counter()
  proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                        text=True, check=False)
  return proc, time.perf_counter() - t0


def compile_parallel(cmds, compiler):
  """Runs the compiler commands `cmds` (each names its output after
  ``-o``), all started together, and waits for every one. Returns [(log, seconds)] in their order, each log the
  command and its output; raises with the logs if any failed."""
  with ThreadPoolExecutor(max_workers=len(cmds)) as pool:
    runs = list(pool.map(_run, cmds))
  logs = [' '.join(cmd) + '\n' + proc.stdout
          for cmd, (proc, _) in zip(cmds, runs)]
  failed = [cmd[cmd.index('-o') + 1] for cmd, (proc, _) in zip(cmds, runs)
            if proc.returncode]
  if failed:
    raise RuntimeError(f'{compiler} failed to build {failed}:\n' +
                       '\n'.join(logs))
  return [(log, seconds) for log, (_, seconds) in zip(logs, runs)]


def temporary(path):
  """Where a build writes `path` before ``install`` moves it there."""
  return path.with_name(f'{path.name}.{os.getpid()}.tmp')


def install(path, log):
  """Writes `log` to build.log beside `path` and moves ``temporary(path)``
  to `path` (atomic: readers never see a partial file)."""
  (path.parent / 'build.log').write_text(log)
  os.replace(temporary(path), path)


def _build(out_dir, srcs):
  """One nvcc per source, all at once, then one link. Returns the
  compilers' output (ptxas resource usage included) and the seconds."""
  nvcc = find_nvcc()
  out_dir.mkdir(parents=True, exist_ok=True)
  t0 = time.perf_counter()
  objs = [out_dir / f'{src.stem}.{os.getpid()}.o' for src in srcs]
  logs = compile_parallel([[nvcc, *NVCC_FLAGS, '-o', str(obj), '-c', str(src)]
                           for src, obj in zip(srcs, objs)], 'nvcc')
  path = out_dir / LIB_NAME
  logs += compile_parallel([[nvcc, '-shared', '-o', str(temporary(path)),
                             *map(str, objs)]], 'nvcc (link)')
  seconds = time.perf_counter() - t0
  for obj in objs:
    obj.unlink()
  log = '\n'.join(log for log, _ in logs)
  install(path, log)
  return log, seconds


def load_library(csrc, build_root):
  """Builds the sources of `csrc` (if needed) into `build_root`/<hash>/
  and returns the loaded KernelLibrary, its launchers given their
  argument types. Another tree's sources with the same launchers (a
  baseline checkout, to time against) load this way beside this tree's."""
  srcs = _sources(csrc)
  out_dir = Path(build_root) / _source_hash(csrc)
  path = out_dir / LIB_NAME
  if path.is_file():
    log, seconds = (out_dir / 'build.log').read_text(), 0.0
  else:
    log, seconds = _build(out_dir, srcs)
  lib = ctypes.CDLL(str(path))
  for name, argtypes in _SIGNATURES.items():
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
  return KernelLibrary(lib, path, log, seconds)


@functools.lru_cache(maxsize=None)
def library():
  """Builds this tree's kernels if needed and returns the loaded
  KernelLibrary."""
  return load_library(CSRC, BUILD_ROOT)


def check(err, name):
  """Raises if a launcher returned a CUDA error code."""
  if err:
    raise RuntimeError(f'{name}: CUDA error {err} at launch')


# Kernel launches by the wrappers (never by the plain twins), keyed by
# launcher name, plus two counts that are not launchers: 'enhance_fused_band'
# (K7, a K1 or K6 launch with a band offset or a total extent) and
# 'slice_apply_pix_bwd_image' (a K4 launch that also gives the image's
# cotangent). A CUDA graph's replay adds the launches it captured.
launches = collections.Counter()


def on_card(name, *tensors):
  """False for CPU tensors (the wrapper runs its plain twin); True for
  contiguous CUDA tensors on one device; raises otherwise."""
  device = tensors[0].device
  for t in tensors[1:]:
    if t.device != device:
      raise ValueError(f'{name}: tensors on different devices: '
                       f'{sorted({str(t.device) for t in tensors})}')
  if device.type == 'cpu':
    return False
  if device.type != 'cuda':
    raise ValueError(f'{name}: unsupported device {device}')
  for t in tensors:
    if not t.is_contiguous():
      raise ValueError(f'{name}: tensors must be contiguous')
  return True


@functools.lru_cache(maxsize=None)
def _launcher(name):
  return getattr(library().lib, name)


def launch(name, device, *args):
  """Calls launcher `name` of ``_SIGNATURES`` with `args` and the current
  stream of `device` (made the current device if it is not), raises on
  its error and counts it."""
  if device.index == torch.cuda.current_device():
    err = _launcher(name)(*args, torch.cuda.current_stream().cuda_stream)
  else:  # the launcher runs on the current device: make it `device`
    with torch.cuda.device(device):
      err = _launcher(name)(*args,
                            torch.cuda.current_stream(device).cuda_stream)
  check(err, name)
  launches[name] += 1
