"""``hdrnet::resize_bilinear`` in C++ (``hdrnet_torch/native/resize_op.cc``)
and the native runner's dynamic dimensions, on the CPU.

The resize library is built from that source alone with ``g++`` against
the CPU wheel (``libhdrnet_resize.so``, beside the runner). Loaded into a
subprocess that never imports ``hdrnet_torch.ops`` (an op is defined once
a process), its op is held bit for bit to the port's Python
``_resize_bilinear`` over a sweep of extents: down and up, both
``align_corners`` values, odd extents, the identity, and the extents at
which a float32 or a reassociated scale picks another source row (found
with numpy, listed below and checked to differ). Then one small module
that builds a 3-level bilinear pyramid and sums it back coarse to fine
(``models.hdrnet.gaussian_pyramid`` and ``upsample_add``: four resizes,
two of them to ``H // 2``, ``W // 2``) is exported with H and W as
``Dim``s through ``bin/export.py``'s ``export_function(..., aoti=True)``
and served by ``aoti_serve --dim`` at two sizes against eager; a size
outside the manifest's range, an unbound name, an unknown name, a
package's own guard and a missing op library each exit 1 naming it.
"""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from hdrnet_torch import native
from hdrnet_torch.bin import export
from hdrnet_torch.config import ModelConfig
from hdrnet_torch.inference import Enhancer
from hdrnet_torch.models.hdrnet import gaussian_pyramid, upsample_add
from hdrnet_torch.ops.resize import _resize_bilinear

# ((H, W) in, (h, w) out, align_corners). 101 -> 50 is an odd extent
# that floors; 723 -> 361 -> 180 is the pyramid's at 723x1085.
SWEEP = [((101, 77), (50, 38), True), ((101, 77), (50, 38), False),
         ((40, 24), (101, 77), True), ((40, 24), (101, 77), False),
         ((723, 5), (361, 5), True), ((361, 4), (180, 3), True),
         ((180, 3), (361, 4), True), ((361, 6), (723, 6), True),
         ((64, 48), (64, 48), True), ((64, 48), (64, 48), False),
         ((9, 7), (1, 1), True), ((1, 1), (5, 6), False)]
# Extents at which i * (n_in - 1) / (n_out - 1) (reassociated) or a
# float32 scale gives another source row than the double scale of
# _linear_taps: (n_in, n_out, align_corners).
TAP_TRAPS = [(27, 24, True), (60, 30, True), (100, 50, True),
             (97, 48, True), (54, 27, True), (144, 141, False),
             (90, 87, False)]
SWEEP += [((n, 3), (m, 3), ac) for n, m, ac in TAP_TRAPS]
SWEEP += [((3, n), (3, m), ac) for n, m, ac in TAP_TRAPS]

TINY = dict(net_input_size=32, spatial_bin=8, luma_bins=4)
SIZES = [(33, 50), (24, 41)]

_LOAD_AND_RESIZE = '''
import sys
import numpy as np
import torch
torch.ops.load_library(sys.argv[1])
assert not any(m.startswith('hdrnet_torch') for m in sys.modules)
cases = np.load(sys.argv[2], allow_pickle=False)
out = {}
for key in cases.files:
  h, w, ac = (int(v) for v in key.split('_')[1:])
  out[key] = torch.ops.hdrnet.resize_bilinear(
      torch.from_numpy(cases[key]), h, w, bool(ac)).numpy()
np.savez(sys.argv[3], **out)
print(torch.ops.hdrnet.resize_bilinear.default._schema)
'''


def _src_rows(n_in, n_out, align_corners, form):
  """Source rows floor(src) of one axis: `form` 'double' as _linear_taps,
  'reassociated' as i * (n_in - 1) / (n_out - 1), 'float32' with the
  scale and the products in float32."""
  i = np.arange(n_out)
  num, den = (n_in - 1, n_out - 1) if align_corners and n_out > 1 else (
      n_in, n_out)
  if form == 'double':
    src = i * (num / den)
  elif form == 'reassociated':
    src = i * num / den
  else:
    src = i.astype(np.float32) * np.float32(num / den)
  return np.floor(src).astype(np.int64)


@pytest.mark.parametrize('n_in, n_out, align_corners', TAP_TRAPS)
def test_sweep_holds_extents_where_the_scale_form_moves_a_row(
    n_in, n_out, align_corners):
  want = _src_rows(n_in, n_out, align_corners, 'double')
  assert any((_src_rows(n_in, n_out, align_corners, form) != want).any()
             for form in ('reassociated', 'float32'))


@pytest.fixture(scope='module')
def binaries():
  """{name: path} of the runner and the CPU resize library, their g++
  started together."""
  built = native.build((native.RUNNER, native.RESIZE_LIBRARY))
  return {name: str(b.path) for name, b in built.items()}


def _run(cmd):
  return subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                        check=False)


def test_cpp_resize_is_the_python_op_bit_for_bit(binaries, tmp_path):
  rng = np.random.RandomState(7)
  cases = {}
  for i, ((h, w), (ho, wo), ac) in enumerate(SWEEP):
    dtype = np.float64 if i == 0 else np.float32
    cases[f'c{i}_{ho}_{wo}_{int(ac)}'] = rng.rand(2, h, w, 3).astype(dtype)
  np.savez(tmp_path / 'in.npz', **cases)
  r = _run([sys.executable, '-c', _LOAD_AND_RESIZE,
            binaries[native.RESIZE_LIBRARY], str(tmp_path / 'in.npz'),
            str(tmp_path / 'out.npz')])
  assert r.returncode == 0, r.stderr
  assert r.stdout.strip() == str(
      torch.ops.hdrnet.resize_bilinear.default._schema)
  got = np.load(tmp_path / 'out.npz')
  for key, x in cases.items():
    h, w, ac = (int(v) for v in key.split('_')[1:])
    want = _resize_bilinear(torch.from_numpy(x), (h, w), bool(ac)).numpy()
    assert got[key].dtype == want.dtype and got[key].shape == want.shape
    np.testing.assert_array_equal(got[key], want, err_msg=key)


def _pyramid_sum(x):
  """A 3-level pyramid of `x` summed back coarse to fine: the pyramid
  model's resizes without its kernels."""
  levels = gaussian_pyramid(x, 3)
  current = levels[-1]
  for level in levels[-2::-1]:
    current = upsample_add(current, level)
  return current


@pytest.fixture(scope='module')
def package(tmp_path_factory):
  """(directory, ExportedProgram): `_pyramid_sum` exported with H and W
  dynamic by export_function with aoti=True, compiled for the CPU."""
  d = tmp_path_factory.mktemp('resize_aoti')
  enh = Enhancer(ModelConfig(**TINY), device='cpu')
  side = dict(min=export.MIN_SIDE, max=export.MAX_SIDE)
  dynamic = ({1: torch.export.Dim('H', **side),
              2: torch.export.Dim('W', **side)},)
  program = export.export_function(enh, 'pyramid_sum', _pyramid_sum,
                                   (torch.rand(1, 24, 40, 3),), dynamic,
                                   str(d), aoti=True)
  return d, program


def _serve(binaries, d, dims, *extra, ops_library=True):
  cmd = [binaries[native.RUNNER], str(d / 'pyramid_sum.aoti.pt2'), '--burn',
         '1', '--iters', '2', *extra]
  if ops_library:
    cmd += ['--ops_library', binaries[native.RESIZE_LIBRARY]]
  for name, value in dims.items():
    cmd += ['--dim', f'{name}={value}']
  return _run(cmd)


def test_manifest_names_the_dims_and_their_range(package):
  d, program = package
  manifest = json.loads((d / 'pyramid_sum.manifest.json').read_text())
  assert manifest['inputs'] == [{'shape': [1, 'H', 'W', 3],
                                 'dtype': 'float32'}]
  assert manifest['outputs'] == manifest['inputs']
  side = {'min': export.MIN_SIDE, 'max': export.MAX_SIDE}
  assert manifest['dims'] == {'H': side, 'W': side}
  assert manifest['aoti'] == {'package': 'pyramid_sum.aoti.pt2',
                              'device': 'cpu'}
  assert export.hdrnet_ops(program) == ['hdrnet.resize_bilinear.default']


@pytest.mark.parametrize('hw', SIZES)
def test_runner_serves_two_sizes_of_one_package(binaries, package, hw):
  d, program = package
  x = np.random.RandomState(hw[0]).rand(1, *hw, 3).astype(np.float32)
  tag = f'{hw[0]}x{hw[1]}'
  x.tofile(d / f'x{tag}.bin')
  r = _serve(binaries, d, {'H': hw[0], 'W': hw[1]}, '--inputs',
             str(d / f'x{tag}.bin'), '--output', str(d / f'y{tag}.bin'))
  assert r.returncode == 0, r.stderr
  report = json.loads(r.stdout.strip())
  assert report['shapes'] == {'inputs': [[1, *hw, 3]], 'output': [1, *hw, 3]}
  resizes = sum(n.target == torch.ops.hdrnet.resize_bilinear.default
                for n in program.graph.nodes)
  assert resizes == 4
  assert report['hdrnet_op_calls'] == {'resize_bilinear': resizes * 3}
  got = np.fromfile(d / f'y{tag}.bin', np.float32).reshape(1, *hw, 3)
  want = _pyramid_sum(torch.from_numpy(x)).numpy()
  np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize('dims, named', [
    ({'H': export.MIN_SIDE - 1, 'W': 40}, 'H=7: outside the range [8, '),
    ({'H': 24, 'W': export.MAX_SIDE + 1}, 'W=16385: outside the range'),
    ({'W': 40}, 'dimension H is dynamic; bind it with --dim H=VALUE'),
    ({'H': 24, 'W': 40, 'Z': 5}, 'records no dynamic dimension Z'),
    ({'H': 'x', 'W': 40}, '--dim H: x is not a count'),
])
def test_runner_refuses_bad_bindings(binaries, package, dims, named):
  d, _ = package
  r = _serve(binaries, d, dims)
  assert r.returncode == 1
  assert named in r.stderr, r.stderr


def test_package_guard_failure_exits_naming_it(binaries, package, tmp_path):
  """A manifest that records a wider range than the package was compiled
  for lets H=4 through the runner's check; the package's own guard then
  refuses it, and the runner exits 1 with the guard's message."""
  d, _ = package
  manifest = json.loads((d / 'pyramid_sum.manifest.json').read_text())
  manifest['dims']['H']['min'] = 1
  wide = tmp_path / 'wide.manifest.json'
  wide.write_text(json.dumps(manifest))
  r = _serve(binaries, d, {'H': 4, 'W': 40}, '--manifest', str(wide))
  assert r.returncode == 1
  assert 'running' in r.stderr and 'dim value is too small' in r.stderr, \
      r.stderr


def test_package_without_the_op_library_names_the_resize(binaries, package):
  d, _ = package
  r = _serve(binaries, d, {'H': 24, 'W': 40}, ops_library=False)
  assert r.returncode == 1
  assert 'calls the op hdrnet::resize_bilinear' in r.stderr, r.stderr
  assert '--ops_library' in r.stderr
