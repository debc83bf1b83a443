"""Builds the CUDA kernels in ``hdrnet_torch/csrc`` and loads them.

Each ``csrc/*.cu`` is compiled for ``sm_90a`` by its own ``nvcc``, all
started together, and one more call links the objects into a shared
library with a plain C interface, loaded with ``ctypes``. The build
happens at first use, into ``build/hdrnet_torch/<hash>/`` at the root of
the checkout, keyed by a hash of the sources (``*.cu`` and ``*.cuh``) and
flags, so a fresh checkout builds once and an edited source rebuilds.

No ``--use_fast_math``: the kernels rely on IEEE division (u8 / 255),
IEEE ``sqrt`` (the smoothed depth tent) and the accurate ``expf`` (the NN
guide's sigmoid) to match the plain versions.
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
              '-O3', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

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
    # grid, frame, u8_in, params, gc, out, u8_out, clip, b, h, w, gh, gw,
    # gd, sy, sx, stream
    'hdrnet_enhance_fused_nn': (_P, _P, _I, _P, _I, _P, _I, _I, _I, _I, _I,
                                _I, _I, _I, _F, _F, _P),
    # grid, guide, image, out, b, h, w, gh, gw, gd, n_in, n_out,
    # has_offset, sy, sx, stream
    'hdrnet_slice_apply_fwd': (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                               _I, _I, _F, _F, _P),
    # grid, guide, image, ct, d_guide, d_image, b, h, w, gh, gw, gd, n_in,
    # n_out, has_offset, sy, sx, stream
    'hdrnet_slice_apply_pix_bwd': (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                   _I, _I, _I, _I, _I, _F, _F, _P),
    # guide, image, ct, out, b, h, w, gh, gw, gd, n_in, n_out, has_offset,
    # sy, sx, pad_y, pad_x, stream
    'hdrnet_slice_apply_grid_bwd': (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                    _I, _I, _I, _F, _F, _I, _I, _P),
    # channels, gd, &nsub, &record stride -> dynamic shared bytes
    'hdrnet_slice_apply_grid_bwd_smem': (_I, _I, ctypes.POINTER(_I),
                                         ctypes.POINTER(_I)),
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
  """One nvcc per source, all at once, then one link. Returns the
  compilers' output (ptxas resource usage included) and the seconds."""
  nvcc = find_nvcc()
  out_dir.mkdir(parents=True, exist_ok=True)
  tag = os.getpid()
  t0 = time.perf_counter()
  objs, procs, log = [], [], []
  for src in srcs:
    obj = out_dir / f'{src.stem}.{tag}.o'
    cmd = [nvcc, *NVCC_FLAGS, '-c', '-o', str(obj), str(src)]
    procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True)))
    objs.append(obj)
  failed = False
  for cmd, proc in procs:
    out, _ = proc.communicate()
    log.append(' '.join(cmd) + '\n' + out)
    failed |= proc.returncode != 0
  if failed:
    raise RuntimeError('nvcc failed:\n' + '\n'.join(log))
  tmp = out_dir / f'{LIB_NAME}.{tag}.tmp'
  cmd = [nvcc, '-shared', '-o', str(tmp), *map(str, objs)]
  proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
  log.append(' '.join(cmd) + '\n' + proc.stdout + proc.stderr)
  log = '\n'.join(log)
  if proc.returncode:
    raise RuntimeError(f'nvcc link failed ({proc.returncode}):\n{log}')
  seconds = time.perf_counter() - t0
  for obj in objs:
    obj.unlink()
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
