"""The native runner of AOTInductor packages (``hdrnet_torch/native``,
the counterpart of ``hdrnet_tpu/native/pjrt_serve.cc``) on the CPU.

The runner is built once for the module with ``g++`` against the CPU
wheel's libtorch. The deployment path end to end: a tiny
``HDRNetCurves`` trained a step by ``hdrnet_tpu`` and saved with orbax
(``tests/jax_checkpoints.py``), converted by
``scripts/convert_jax_checkpoint.py``, and two of its graphs exported by
``bin/export.py``'s ``export_function`` with ``aoti=True`` (what
``--aoti`` does for each graph) and compiled for the CPU (20-45 s each):
``coefficients_fn``, which calls no ``hdrnet::`` op, is served by the
runner and its grid held at 1e-5 to the JAX model's coefficients on the
same low-res input and to the port's eager grid; ``stream_fn`` calls
``hdrnet::`` ops, which only the op library registers in C++ (its kernel
ops on CUDA only, so not built here), and the runner must refuse it
naming the op. Then ``pjrt_serve``'s error cases (usage, an unknown flag,
a missing package or manifest), a CUDA package without a card, the
pyramid's ``serve_fn`` and ``serve_any_fn`` packaged by ``--aoti`` (the
runner naming the first op it lacks), and the op library's schemas
against the Python ops'. The resize op in C++ and dynamic dimensions are
``tests/test_torch_native_resize.py``'s; the runner on a CUDA package is
``tests/test_torch_cuda.py``'s.
"""

import json
import re
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hdrnet_tpu import config as jax_config
from hdrnet_tpu.inference import Enhancer as JaxEnhancer

import hdrnet_torch.ops  # noqa: F401  (registers the hdrnet:: ops)
from hdrnet_torch import native
from hdrnet_torch.bin import export
from hdrnet_torch.config import Config, ModelConfig, TrainConfig
from hdrnet_torch.inference import Enhancer, full_float32
from hdrnet_torch.models import make_model
from hdrnet_torch.training import loop, step
from hdrnet_torch.training.checkpoint import Checkpointer

import jax_checkpoints

SMALL = dict(net_input_size=32, spatial_bin=8, luma_bins=4,
             guide_complexity=4)
FULLRES = (24, 40)
REPORT_KEYS = {'init_ms', 'compile_ms', 'upload_ms', 'forward_ms_per_iter',
               'readback_ms', 'fps', 'iters', 'burn', 'out_mean', 'out_min',
               'out_max', 'device', 'shapes', 'hdrnet_op_calls'}


def _checkpoint(directory, model_name='HDRNetCurves', seed=3):
  cfg = Config(model=ModelConfig(model_name=model_name, **SMALL),
               train=TrainConfig())
  model = make_model(cfg.model, generator=torch.Generator().manual_seed(seed))
  cfg.save(str(directory))
  Checkpointer(str(directory)).save(0, step.create_state(
      model, loop.make_optimizer(model, cfg.train)))
  return Enhancer.from_checkpoint(str(directory), device='cpu')


@pytest.fixture(scope='module')
def runner():
  return str(native.runner().path)


@pytest.fixture(scope='module')
def packages(tmp_path_factory):
  """(directory, JAX checkpoint directory, Enhancer): a tiny HDRNetCurves
  trained one step by hdrnet_tpu and saved with orbax, converted by
  scripts/convert_jax_checkpoint.py; its coefficients_fn and stream_fn
  exported and compiled for the CPU by export_function, as
  ``export.main(..., '--aoti')`` does for each graph."""
  root = tmp_path_factory.mktemp('aoti')
  jax_dir, d = root / 'jax', root / 'port'
  size = [2 * SMALL['net_input_size']] * 2
  jax_checkpoints.write(jax_dir, jax_config.Config(
      model=jax_config.ModelConfig(model_name='HDRNetCurves',
                                   output_resolution=size, **SMALL),
      train=jax_config.TrainConfig(learning_rate=1e-3),
      data=jax_config.DataConfig(output_resolution=size,
                                 net_input_size=SMALL['net_input_size'])),
                        steps=1, keep=(1,))
  jax_checkpoints.converter().main([str(jax_dir), str(d)])
  enh = Enhancer.from_checkpoint(str(d), device='cpu')
  fns = export.serving_functions(enh, FULLRES)
  for name in ('coefficients_fn', 'stream_fn'):
    fn, example, dynamic = fns[name]
    export.export_function(enh, name, fn, example, dynamic, str(d),
                           aoti=True)
  return d, jax_dir, enh


def _jax_coefficients(jax_dir, lowres):
  """The JAX model's packed grid for `lowres`, in the deployment layout
  (c, gd, gh, gw), as hdrnet_tpu/bin/export.py's coefficients_fn."""
  jenh = JaxEnhancer(str(jax_dir))
  low = jnp.asarray(lowres)
  _, inter = jenh.model.apply(jenh.variables, low, low,
                              mutable=['intermediates'])
  grid = np.asarray(inter['intermediates']['bilateral_coefficients'][0])
  b, gh, gw, gd, no, ni = grid.shape
  return grid.reshape(b, gh, gw, gd, no * ni)[0].transpose(3, 2, 0, 1)


def _run(cmd):
  return subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                        check=False)


def test_runner_serves_cpu_coefficients_package(runner, packages):
  """The grid the runner serves from a converted JAX checkpoint is the
  JAX model's, and the port's eager grid, within 1e-5."""
  d, jax_dir, enh = packages
  manifest = json.loads((d / 'coefficients_fn.manifest.json').read_text())
  assert manifest['aoti'] == {'package': 'coefficients_fn.aoti.pt2',
                              'device': 'cpu'}
  lowres = np.random.RandomState(5).rand(1, 32, 32, 3).astype(np.float32)
  lowres.tofile(d / 'low.bin')
  r = _run([runner, str(d / 'coefficients_fn.aoti.pt2'), '--inputs',
            str(d / 'low.bin'), '--output', str(d / 'grid.bin'), '--burn',
            '1', '--iters', '2', '--report', str(d / 'report.json')])
  assert r.returncode == 0, r.stderr
  with torch.no_grad(), full_float32():
    want = export.coefficients_function(enh)(torch.from_numpy(lowres))
  got = np.fromfile(d / 'grid.bin', np.float32).reshape(want.shape)
  np.testing.assert_allclose(got, _jax_coefficients(jax_dir, lowres),
                             rtol=0, atol=1e-5)
  np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=1e-5)

  report = json.loads(r.stdout.strip())
  assert set(report) == REPORT_KEYS
  assert json.loads((d / 'report.json').read_text()) == report
  assert report['iters'] == 2 and report['burn'] == 1
  assert report['device'] == 'cpu' and report['hdrnet_op_calls'] == {}
  assert report['shapes'] == {'inputs': [[1, 32, 32, 3]],
                              'output': list(want.shape)}
  np.testing.assert_allclose(
      [report['out_mean'], report['out_min'], report['out_max']],
      [got.mean(), got.min(), got.max()], rtol=1e-5, atol=1e-6)
  assert min(report[k] for k in REPORT_KEYS
             if k.endswith('_ms') or k.endswith('_iter')) >= 0


def test_runner_synthesizes_missing_inputs(runner, packages):
  """Without --inputs the runner serves pjrt_serve's synthetic frame."""
  d, _, _ = packages
  r = _run([runner, str(d / 'coefficients_fn.aoti.pt2'), '--burn', '0',
            '--iters', '1'])
  assert r.returncode == 0, r.stderr
  report = json.loads(r.stdout.strip())
  assert np.isfinite([report['out_mean'], report['out_min'],
                      report['out_max']]).all()


def test_unregistered_op_is_named(runner, packages):
  """stream_fn calls hdrnet:: ops, registered in C++ by the op library
  alone: without --ops_library the load fails and names the op."""
  d, _, _ = packages
  calls = export.hdrnet_ops(torch.export.load(str(d / 'stream_fn.pt2')))
  assert 'hdrnet.nearest_lowres.default' in calls
  r = _run([runner, str(d / 'stream_fn.aoti.pt2')])
  assert r.returncode == 1
  op = re.search(r'calls the op (hdrnet::\w+)', r.stderr)
  assert op, r.stderr
  assert f'{op.group(1).replace("::", ".")}.default' in calls
  assert '--ops_library' in r.stderr


def test_usage_error(runner):
  r = _run([runner])
  assert r.returncode == 1
  assert 'usage' in r.stderr


def test_unknown_flag(runner):
  r = _run([runner, 'x.aoti.pt2', '--frobnicate'])
  assert r.returncode == 1
  assert 'unknown flag --frobnicate' in r.stderr


def test_missing_package(runner, tmp_path):
  r = _run([runner, str(tmp_path / 'absent.aoti.pt2')])
  assert r.returncode == 1
  assert 'cannot read package' in r.stderr and 'absent.aoti.pt2' in r.stderr


def test_missing_manifest(runner, tmp_path):
  package = tmp_path / 'm.aoti.pt2'
  package.write_bytes(b'\0')
  r = _run([runner, str(package)])
  assert r.returncode == 1
  assert 'cannot read manifest' in r.stderr
  assert str(tmp_path / 'm.manifest.json') in r.stderr


def test_manifest_without_a_package_or_a_card(runner, tmp_path):
  """A manifest with no "aoti" record is refused; a CUDA package without
  a visible card too, before anything loads."""
  package = tmp_path / 'm.aoti.pt2'
  package.write_bytes(b'\0')
  manifest = {'name': 'm',
              'inputs': [{'shape': [1, 4, 4, 3], 'dtype': 'float32'}],
              'outputs': [{'shape': [1, 4, 4, 3], 'dtype': 'float32'}],
              'precision': export.PRECISION}
  (tmp_path / 'm.manifest.json').write_text(json.dumps(manifest))
  r = _run([runner, str(package)])
  assert r.returncode == 1 and 'records no AOTInductor package' in r.stderr
  manifest['aoti'] = {'package': package.name, 'device': 'cuda'}
  (tmp_path / 'm.manifest.json').write_text(json.dumps(manifest, indent=2))
  r = _run([runner, str(package)])
  assert r.returncode == 1
  if torch.cuda.is_available():
    assert 'loading' in r.stderr
  else:
    assert 'no CUDA device is visible' in r.stderr


def test_aoti_leaves_out_dynamic_and_resize_graphs(runner, tmp_path):
  """serve_any_fn (dynamic H and W) and a graph calling
  hdrnet::resize_bilinear (the pyramid's) are packaged too: each manifest
  records its package (serve_any_fn's also its dims and their range),
  and the runner, given no op library, refuses each package naming
  hdrnet::resize_bilinear, the first hdrnet:: op the graph calls."""
  enh = _checkpoint(tmp_path, 'HDRNetGaussianPyrNN')
  fns = export.serving_functions(enh, FULLRES)
  side = {'min': export.MIN_SIDE, 'max': export.MAX_SIDE}
  for name, dims in (('serve_fn', None), ('serve_any_fn', {'H': side,
                                                          'W': side})):
    fn, example, dynamic = fns[name]
    program = export.export_function(enh, name, fn, example, dynamic,
                                     str(tmp_path), aoti=True)
    assert 'hdrnet.resize_bilinear.default' in export.hdrnet_ops(program)
    manifest = json.loads((tmp_path / f'{name}.manifest.json').read_text())
    assert manifest['aoti'] == {'package': f'{name}.aoti.pt2',
                                'device': 'cpu'}
    assert manifest.get('dims') == dims
    assert (tmp_path / f'{name}.aoti.pt2').is_file()
    r = _run([runner, str(tmp_path / f'{name}.aoti.pt2'), '--dim', 'H=24',
              '--dim', 'W=40'] if dims else
             [runner, str(tmp_path / f'{name}.aoti.pt2')])
    assert r.returncode == 1
    assert 'calls the op hdrnet::resize_bilinear' in r.stderr, r.stderr


def _cc_schemas():
  """{op: schema} of the m.def(...) strings in the op library's sources,
  hdrnet_ops.cc and resize_op.cc (adjacent string literals joined)."""
  source = ''.join((native.HERE / name).read_text()
                   for name in ('hdrnet_ops.cc', 'resize_op.cc'))
  out = {}
  for call in re.findall(r'm\.def\(((?:\s*"[^"]*")+)\s*\)', source):
    schema = ''.join(re.findall(r'"([^"]*)"', call))
    out[schema.split('(')[0]] = f'hdrnet::{schema}'
  return out


@pytest.mark.parametrize('op', ['nearest_lowres', 'enhance_fused',
                                'slice_apply_fwd', 'resize_bilinear'])
def test_op_library_schemas_are_the_python_ops(op):
  assert _cc_schemas()[op] == str(getattr(torch.ops.hdrnet, op).default
                                  ._schema)


def test_op_library_registers_the_kernel_backed_ops():
  """The op library defines every hdrnet:: op that AOTInductor packages
  may call: the kernel-backed ops and the bilinear resize (no kernel)."""
  assert sorted(_cc_schemas()) == ['enhance_fused', 'nearest_lowres',
                                   'resize_bilinear', 'slice_apply_fwd']
