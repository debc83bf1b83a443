"""Builds the CUDA kernels in ``hdrnet_torch/csrc`` and loads them.

One ``nvcc`` call compiles every ``csrc/*.cu`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``. The
build happens at first use, into ``build/hdrnet_torch/<hash>/`` at the
root of the checkout, keyed by a hash of the sources and flags, so a
fresh checkout builds once and an edited source rebuilds.

No ``--use_fast_math``: the kernels rely on IEEE division (u8 / 255) and
IEEE ``sqrt`` (the smoothed depth tent) to match the plain versions.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_ROOT = Path(__file__).resolve().parents[2] / 'build' / 'hdrnet_torch'
LIB_NAME = 'libhdrnet_kernels.so'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# extern "C" launchers in csrc/*.cu; each returns its cudaGetLastError().
_SIGNATURES = {
    # frame, u8, iy, ix, out, b, h, w, c, s, stream
    'hdrnet_nearest_lowres': (_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # grid, frame, u8_in, params, out, u8_out, clip, b, h, w, gh, gw, gd,
    # sy, sx, stream
    'hdrnet_enhance_fused': (_P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I,
                             _I, _I, _F, _F, _P),
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


def _sources():
  srcs = sorted(CSRC.glob('*.cu'))
  if not srcs:
    raise RuntimeError(f'no CUDA sources under {CSRC}')
  return srcs


def _source_hash():
  h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
  for path in sorted(CSRC.glob('*.cu*')):
    h.update(path.name.encode())
    h.update(path.read_bytes())
  return h.hexdigest()[:16]


def _build(out_dir, srcs):
  nvcc = find_nvcc()
  out_dir.mkdir(parents=True, exist_ok=True)
  tmp = out_dir / f'{LIB_NAME}.{os.getpid()}.tmp'
  cmd = [nvcc, *NVCC_FLAGS, '-o', str(tmp), *map(str, srcs)]
  t0 = time.perf_counter()
  proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
  seconds = time.perf_counter() - t0
  log = ' '.join(cmd) + '\n' + proc.stdout + proc.stderr
  if proc.returncode:
    raise RuntimeError(f'nvcc failed ({proc.returncode}):\n{log}')
  (out_dir / 'build.log').write_text(log)
  os.replace(tmp, out_dir / LIB_NAME)  # atomic: readers never see a partial
  return log, seconds


@functools.lru_cache(maxsize=None)
def library():
  """Builds the kernels if needed and returns the loaded KernelLibrary."""
  srcs = _sources()
  out_dir = BUILD_ROOT / _source_hash()
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


def check(err, name):
  """Raises if a launcher returned a CUDA error code."""
  if err:
    raise RuntimeError(f'{name}: CUDA error {err} at launch')
