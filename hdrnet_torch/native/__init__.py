"""The native serving stack (counterpart of ``hdrnet_tpu/native/``): a C++
runner of the port's AOTInductor packages and the ``hdrnet::`` op
library it loads, built at first use.

  * ``aoti_serve`` (``aoti_serve.cc``): loads a ``<name>.aoti.pt2`` that
    ``bin/export.py --aoti`` wrote, runs it with no Python in the
    process and reports the stages as ``hdrnet_tpu/native/pjrt_serve.cc``
    does. Built by ``g++`` against libtorch alone (the wheel's headers and
    ``torch/lib``), so it builds on a CPU wheel too.
  * ``libhdrnet_ops.so`` (``hdrnet_ops.cc`` and ``resize_op.cc``):
    ``hdrnet::nearest_lowres``, ``hdrnet::enhance_fused`` and
    ``hdrnet::slice_apply_fwd`` on CUDA tensors, through the ``extern
    "C"`` launchers of ``libhdrnet_kernels.so`` (``ops._build.library()``,
    built first), and ``hdrnet::resize_bilinear`` (no kernel: ATen calls,
    CPU and CUDA); it needs the CUDA toolkit's headers.
  * ``libhdrnet_resize.so`` (``resize_op.cc`` alone): the resize op
    without the kernels, built by ``g++`` against libtorch alone like the
    runner, so the tests serve a CPU package that calls it.

Each is built into ``build/hdrnet_torch/native/<hash>/`` at the root of
the checkout, keyed by a hash of its sources (the op library's with
``csrc/launchers.cuh``), the flags and the torch version, their ``g++``
started together (``ops._build.compile_parallel``), with the include and
library paths of ``torch.utils.cpp_extension``, torch's C++ ABI and an
rpath to ``torch/lib``. A failed build raises.

Never load ``libhdrnet_ops.so`` or ``libhdrnet_resize.so`` into a Python
process that imports ``hdrnet_torch.ops``: that module defines the
``hdrnet`` namespace's ops there, and an op may be defined once. The
runner loads one of them (``--ops_library``).

  python -c 'from hdrnet_torch import native; print(native.build())'
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import shutil
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
BUILD_ROOT = Path(__file__).resolve().parents[2] / 'build' / 'hdrnet_torch' / \
    'native'
RUNNER, OPS_LIBRARY = 'aoti_serve', 'libhdrnet_ops.so'
RESIZE_LIBRARY = 'libhdrnet_resize.so'
CXX_FLAGS = ('-std=c++17', '-O2', '-fPIC', '-Wno-c++20-extensions')


@dataclasses.dataclass(frozen=True)
class Binary:
  path: Path
  seconds: float   # build time; 0.0 when it was already built


def _torch_flags():
  """Compile and link flags for libtorch: headers and ``torch/lib`` of
  ``torch.utils.cpp_extension``, torch's C++ ABI, an rpath to
  ``torch/lib``; the library dir."""
  from torch.utils import cpp_extension
  lib = cpp_extension.library_paths()[0]
  abi = int(torch._C._GLIBCXX_USE_CXX11_ABI)
  cflags = [*CXX_FLAGS, f'-D_GLIBCXX_USE_CXX11_ABI={abi}',
            *(f'-I{d}' for d in cpp_extension.include_paths())]
  return cflags, [f'-L{lib}', f'-Wl,-rpath,{lib}'], Path(lib)


def _torch_libs(cuda):
  """libtorch's libraries to link; with `cuda`, its CUDA ones, which a
  CUDA package's loader needs (linked even where nothing refers to them
  by name)."""
  libs = ['torch', 'torch_cpu', 'c10']
  if cuda:
    libs += ['torch_cuda', 'c10_cuda']
  return ['-Wl,--no-as-needed', *(f'-l{n}' for n in libs),
          '-Wl,--as-needed']


def _cuda_include():
  """The CUDA toolkit's headers, beside the nvcc the kernels build with."""
  from hdrnet_torch.ops import _build
  return Path(_build.find_nvcc()).resolve().parent.parent / 'include'


def _targets(names):
  """{name: (sources, files that key the build, output file, flags
  without the output)}."""
  from hdrnet_torch.ops import _build
  cflags, lflags, lib_dir = _torch_flags()
  resize = HERE / 'resize_op.cc'
  out = {}
  if RUNNER in names:
    has_cuda = (lib_dir / 'libtorch_cuda.so').is_file()
    source = HERE / 'aoti_serve.cc'
    out[RUNNER] = ((source,), (source,), RUNNER,
                   [*cflags, *lflags, *_torch_libs(has_cuda), '-ldl'])
  if RESIZE_LIBRARY in names:
    out[RESIZE_LIBRARY] = ((resize,), (resize,), RESIZE_LIBRARY,
                           [*cflags, '-shared', *lflags,
                            *_torch_libs(False)])
  if OPS_LIBRARY in names:
    kernels = _build.library().path
    sources = (HERE / 'hdrnet_ops.cc', resize)
    out[OPS_LIBRARY] = (
        sources, (*sources, _build.CSRC / 'launchers.cuh'), OPS_LIBRARY,
        [*cflags, f'-I{_cuda_include()}', f'-I{_build.CSRC}', '-shared',
         *lflags, *_torch_libs(True), f'-L{kernels.parent}',
         f'-l:{kernels.name}', f'-Wl,-rpath,{kernels.parent}'])
  return out


def _key(files, flags):
  h = hashlib.sha256(' '.join(flags).encode())
  for path in files:
    h.update(path.read_bytes())
  h.update(torch.__version__.encode())
  return h.hexdigest()[:16]


def cxx():
  """The g++ on PATH, which builds the runner, the op library and (through
  ``bin/export.py --aoti``) AOTInductor's package code, whose wrapper
  Inductor builds with OpenMP; raises where there is none."""
  path = shutil.which('g++')
  if path is None:
    raise RuntimeError('g++ not found on PATH: the native runner, its op '
                       'library and AOTInductor packages build with it')
  return path


def _build(names):
  """Builds the named binaries that are not built yet, their compilers
  started together (``ops._build.compile_parallel``); {name: Binary}."""
  from hdrnet_torch.ops import _build
  compiler = cxx()
  done, pending = {}, {}
  for name, (sources, files, filename, flags) in _targets(names).items():
    path = BUILD_ROOT / _key(files, flags) / filename
    if path.is_file():
      done[name] = Binary(path, 0.0)
      continue
    path.parent.mkdir(parents=True, exist_ok=True)
    pending[name] = (path, [compiler, *map(str, sources), '-o',
                            str(_build.temporary(path)), *flags])
  if pending:
    built = _build.compile_parallel([cmd for _, cmd in pending.values()],
                                    'g++')
    for (name, (path, _)), (log, seconds) in zip(pending.items(), built):
      _build.install(path, log)
      done[name] = Binary(path, seconds)
  return done


@functools.lru_cache(maxsize=None)
def runner():
  """The built ``aoti_serve`` binary (a Binary)."""
  return _build((RUNNER,))[RUNNER]


@functools.lru_cache(maxsize=None)
def ops_library():
  """The built ``libhdrnet_ops.so`` (a Binary; needs the CUDA toolkit and
  builds the kernels first). Never load it into this process."""
  return _build((OPS_LIBRARY,))[OPS_LIBRARY]


def build(names=(RUNNER, OPS_LIBRARY)):
  """The named binaries (the runner and the op library by default), their
  compilers started together: {name: Binary}."""
  return _build(names)


def serve_command(package, dims=None, **flags):
  """The runner's command line for `package` with the op library, then
  ``--dim NAME=VALUE`` for each of `dims` (a package's dynamic
  dimensions) and ``--name value`` for each flag (a list joined by
  commas)."""
  cmd = [str(runner().path), str(package), '--ops_library',
         str(ops_library().path)]
  for name, value in (dims or {}).items():
    cmd += ['--dim', f'{name}={value}']
  for name, value in flags.items():
    if isinstance(value, (list, tuple)):
      value = ','.join(map(str, value))
    cmd += [f'--{name}', str(value)]
  return cmd
