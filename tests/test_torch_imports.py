"""hdrnet_torch never imports JAX, nor anything of ``hdrnet_tpu``.

The machine with the card has no JAX, so the port must import, serve
(all three HDRNet models, and a checkpoint of the JAX package converted
by ``scripts/convert_jax_checkpoint.py``, which it also restores), run ``bin/run.py``'s per-image function,
train, build, serve and train a feature model, a baseline and a style
model of the zoo, run the tools (``bin/export.py``, ``bin/fit_grid.py``,
``bin/viz_activations.py``, the triage scripts ``scripts/guide_stats.py``
and ``scripts/diagnose_pyramid.py``), build a local-Laplacian set and train
on it from device memory, train on a mesh through ``bin/train.py``
under torchrun's environment, and train the pyramid on a 'spatial' axis
(two ranks, halos exchanged) without it: no module under ``hdrnet_torch/`` (nor
``chip_smoke.py``) may import jax, flax, optax, or any ``hdrnet_tpu``
module, even one that does not import JAX: the port keeps its own copy
of what it needs (config, data pipeline, flag mapping).
"""

import ast
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = REPO / 'hdrnet_torch'
FORBIDDEN_ROOTS = ('jax', 'jaxlib', 'flax', 'optax', 'hdrnet_tpu')
ALLOWED_HDRNET_TPU = ()


def _imported_modules(path):
  tree = ast.parse(path.read_text(), filename=str(path))
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      for alias in node.names:
        yield alias.name
    elif isinstance(node, ast.ImportFrom) and node.level == 0:
      if node.module == 'hdrnet_tpu':  # from hdrnet_tpu import x
        for alias in node.names:
          yield f'hdrnet_tpu.{alias.name}'
      else:
        yield node.module


def test_no_jax_imports_in_package():
  files = sorted(PACKAGE.rglob('*.py')) + [REPO / 'chip_smoke.py']
  assert len(files) >= 10, files
  bad = []
  for path in files:
    for mod in _imported_modules(path):
      if (mod.split('.')[0] in FORBIDDEN_ROOTS
          and mod not in ALLOWED_HDRNET_TPU):
        bad.append(f'{path.relative_to(REPO)}: {mod}')
  assert not bad, bad


_REFUSE_JAX = f'''
import sys

class RefuseJax:
  def find_spec(self, name, path=None, target=None):
    if name.split('.')[0] in {FORBIDDEN_ROOTS!r}:
      raise ImportError('import of ' + name + ' refused')
    return None

sys.meta_path.insert(0, RefuseJax())
'''

# One rank of a spatial mesh run: bin/train.py's main (its arguments
# after the script's), with JAX refused.
_MESH_RANK = _REFUSE_JAX + f'''
from hdrnet_torch.bin import train
state = train.main(sys.argv[1:])
assert state.step == 1, state.step
loaded = sorted(m for m in sys.modules
                if m.split('.')[0] in {FORBIDDEN_ROOTS!r})
assert not loaded, loaded
'''

_BLOCKED_RUN = _REFUSE_JAX + f'''

import importlib, pkgutil
import hdrnet_torch
for mod in pkgutil.walk_packages(hdrnet_torch.__path__, 'hdrnet_torch.'):
  importlib.import_module(mod.name)

import numpy as np
import torch
from hdrnet_torch.bin.run import enhance_image
from hdrnet_torch.config import ModelConfig
from hdrnet_torch.inference import Enhancer

cfg = ModelConfig(net_input_size=64, spatial_bin=8, luma_bins=4)
enh = Enhancer(cfg, device='cpu')
out = enh.process(torch.rand(1, 40, 48, 3))
assert out.shape == (1, 40, 48, 3), out.shape
for name in ('HDRNetPointwiseNNGuide', 'HDRNetGaussianPyrNN'):
  nn_cfg = ModelConfig(model_name=name, net_input_size=64, spatial_bin=8,
                       luma_bins=4, guide_complexity=4)
  out = Enhancer(nn_cfg, device='cpu').process(torch.rand(1, 41, 47, 3))
  assert out.shape == (1, 41, 47, 3), (name, out.shape)
out, _ = enhance_image(enh, np.random.rand(37, 53, 3).astype(np.float32))
assert out.shape == (1, 37, 53, 3), out.shape
# A checkpoint that the JAX package trained, converted by
# scripts/convert_jax_checkpoint.py (argv[1]): served and restored.
from hdrnet_torch.config import Config, TrainConfig
from hdrnet_torch.models import make_model
from hdrnet_torch.training import loop, step
from hdrnet_torch.training.checkpoint import Checkpointer
converted = sys.argv[1]
out = Enhancer.from_checkpoint(converted, device='cpu').process(
    torch.rand(1, 40, 48, 3))
assert out.shape == (1, 40, 48, 3), out.shape
ccfg = Config.load(converted)
cmodel = make_model(ccfg.model)
cstate = step.create_state(cmodel, loop.make_optimizer(cmodel, ccfg.train))
assert Checkpointer(converted).restore(cstate).step == 3, cstate.step
print('served without jax')

model = make_model(cfg, generator=torch.Generator().manual_seed(0))
state = step.create_state(model, loop.make_optimizer(model, TrainConfig()))
batch = {{'lowres_input': torch.randint(0, 256, (2, 64, 64, 3),
                                        dtype=torch.uint8),
          'image_input': torch.randint(0, 256, (2, 40, 48, 3),
                                       dtype=torch.uint8),
          'image_output': torch.randint(0, 256, (2, 40, 48, 3),
                                        dtype=torch.uint8)}}
state, m = step.make_train_step(guide_reg=0.5)(state, batch)
assert state.step == 1 and torch.isfinite(m['loss']), m
loaded = sorted(m for m in sys.modules
                if m.split('.')[0] in {FORBIDDEN_ROOTS!r})
assert not loaded, loaded
print('trained without jax')

# A feature model, a baseline and a style model: built, served by the
# composite route, one train step each.
for name, n_in in (('HDRNetFeaturesPyrNN3', 3), ('UNet', 3),
                   ('StyleTransferNN', 6)):
  zcfg = ModelConfig(model_name=name, n_in=n_in, net_input_size=64,
                     spatial_bin=8, luma_bins=4, guide_complexity=4,
                     depth=3, width=8)
  zenh = Enhancer(zcfg, device='cpu')
  out = zenh.process(torch.rand(1, 33, 41, n_in))
  assert not zenh.fused and out.shape == (1, 33, 41, 3), (name, out.shape)
  zmodel = make_model(zcfg, generator=torch.Generator().manual_seed(1))
  zstate = step.create_state(zmodel,
                             loop.make_optimizer(zmodel, TrainConfig()))
  zbatch = {{'lowres_input': torch.randint(0, 256, (2, 64, 64, n_in),
                                           dtype=torch.uint8),
            'image_input': torch.randint(0, 256, (2, 32, 40, n_in),
                                         dtype=torch.uint8),
            'image_output': torch.randint(0, 256, (2, 32, 40, 3),
                                          dtype=torch.uint8)}}
  zstate, zm = step.make_train_step()(zstate, zbatch)
  assert zstate.step == 1 and torch.isfinite(zm['loss']), (name, zm)
loaded = sorted(m for m in sys.modules
                if m.split('.')[0] in {FORBIDDEN_ROOTS!r})
assert not loaded, loaded
print('zoo without jax')

import os, shutil, tempfile
from hdrnet_torch.bin import export, fit_grid, viz_activations
from hdrnet_torch.data import images
work = tempfile.mkdtemp()
try:
  Config(model=cfg).save(work)
  Checkpointer(work).save(state.step, state)
  programs = export.main([work, '--fullres', '40', '48', '--device', 'cpu'])
  assert len(programs) == 5 and os.path.isfile(
      os.path.join(work, 'guide_ccm_f32_3x4.bin')), sorted(programs)
  out = export.load_artifact(os.path.join(work, 'serve_any_fn.pt2'))(
      torch.rand(1, 64, 64, 3), torch.rand(1, 30, 50, 3))
  assert out.shape == (1, 30, 50, 3), out.shape
  rng = np.random.RandomState(0)
  psnr, fitted = fit_grid.fit_pair(rng.rand(24, 32, 3), rng.rand(24, 32, 3),
                                   gh=4, gw=4, gd=4, steps=2, guide='curves',
                                   device='cpu')
  assert np.isfinite(psnr) and fitted['grid'].shape == (1, 4, 4, 4, 3, 4)
  images.imwrite(os.path.join(work, 'im.png'), rng.rand(40, 48, 3))
  acts = viz_activations.main([work, os.path.join(work, 'im.png'),
                               os.path.join(work, 'viz'), '--device', 'cpu'])
  assert acts and os.path.isfile(os.path.join(work, 'viz', 'splat_conv1.png'))
finally:
  shutil.rmtree(work, ignore_errors=True)
loaded = sorted(m for m in sys.modules
                if m.split('.')[0] in {FORBIDDEN_ROOTS!r})
assert not loaded, loaded
print('tools without jax')

# The quality-triage tools on a pyramid checkpoint of the port.
from hdrnet_torch.config import DataConfig
from hdrnet_torch.scripts import diagnose_pyramid, guide_stats
work = tempfile.mkdtemp()
try:
  data = os.path.join(work, 'set')
  for side in ('input', 'output'):
    images.imwrite(os.path.join(data, side, 'a.png'), rng.rand(72, 80, 3))
  with open(os.path.join(data, 'filelist.txt'), 'w') as f:
    f.write('a.png')
  pcfg = Config(model=ModelConfig(model_name='HDRNetGaussianPyrNN',
                                  net_input_size=32, spatial_bin=8,
                                  luma_bins=4, guide_complexity=4),
                data=DataConfig(output_resolution=[64, 64],
                                net_input_size=32))
  pmodel = make_model(pcfg.model, generator=torch.Generator().manual_seed(2))
  pcfg.save(work)
  Checkpointer(work).save(0, step.create_state(
      pmodel, loop.make_optimizer(pmodel, pcfg.train)))
  stats = guide_stats.main([work, data, '--device', 'cpu'])
  assert stats['n_images'] == 1 and len(stats['guides']) == 3, stats
  diag = diagnose_pyramid.main([work, data, '--device', 'cpu'])
  assert len(diag['summary']['levels']) == 3, diag
finally:
  shutil.rmtree(work, ignore_errors=True)
loaded = sorted(m for m in sys.modules
                if m.split('.')[0] in {FORBIDDEN_ROOTS!r})
assert not loaded, loaded
print('triage without jax')

# The quality workload's data: a tiny local-Laplacian set built, then
# trained on from device memory (the device route on the CPU).
from hdrnet_torch.bin import train
from hdrnet_torch.scripts import make_ll_dataset
work = tempfile.mkdtemp()
try:
  make_ll_dataset.main([work, '--n_train', '2', '--n_test', '1', '--size',
                        '64', '--device', 'cpu'])
  state = train.main([os.path.join(work, 'ckpt'),
                      os.path.join(work, 'train'), '--batch_size', '2',
                      '--output_resolution', '64', '64', '--net_input_size',
                      '32', '--spatial_bin', '8', '--luma_bins', '4',
                      '--fliplr', '--rotate', '--device_normalize',
                      '--device_data', '--max_steps', '2', '--device',
                      'cpu'])
  assert (state.step, state.data_route) == (2, 'device'), state.data_route
finally:
  shutil.rmtree(work, ignore_errors=True)
loaded = sorted(m for m in sys.modules
                if m.split('.')[0] in {FORBIDDEN_ROOTS!r})
assert not loaded, loaded
print('device data without jax')

# A mesh run: bin/train.py under torchrun's environment (a world of one
# gloo rank) joins the process group and trains on a (1, 1) mesh.
import socket
import torch.distributed as dist
with socket.socket() as sock:
  sock.bind(('localhost', 0))
  port = sock.getsockname()[1]
os.environ.update(RANK='0', LOCAL_RANK='0', WORLD_SIZE='1',
                  MASTER_ADDR='localhost', MASTER_PORT=str(port))
work = tempfile.mkdtemp()
try:
  images.imwrite(os.path.join(work, 'input', 'a.png'), rng.rand(80, 96, 3))
  images.imwrite(os.path.join(work, 'output', 'a.png'), rng.rand(80, 96, 3))
  with open(os.path.join(work, 'filelist.txt'), 'w') as f:
    f.write('a.png')
  state = train.main([os.path.join(work, 'ckpt'), work, '--batch_size', '2',
                      '--output_resolution', '64', '64', '--net_input_size',
                      '32', '--spatial_bin', '8', '--luma_bins', '4',
                      '--mesh_shape', '1', '1', '--max_steps', '2',
                      '--device', 'cpu'])
  assert dist.is_initialized() and state.step == 2, state.step
  dist.destroy_process_group()
finally:
  shutil.rmtree(work, ignore_errors=True)
loaded = sorted(m for m in sys.modules
                if m.split('.')[0] in {FORBIDDEN_ROOTS!r})
assert not loaded, loaded
print('mesh training without jax')

# The pyramid on a spatial axis: two gloo ranks at (1, 2), each a process
# with JAX refused, one step of bin/train.py with its levels' halos
# exchanged.
import subprocess
with socket.socket() as sock:
  sock.bind(('localhost', 0))
  port = sock.getsockname()[1]
work = tempfile.mkdtemp()
try:
  images.imwrite(os.path.join(work, 'input', 'a.png'), rng.rand(80, 96, 3))
  images.imwrite(os.path.join(work, 'output', 'a.png'), rng.rand(80, 96, 3))
  with open(os.path.join(work, 'filelist.txt'), 'w') as f:
    f.write('a.png')
  argv = [os.path.join(work, 'ckpt'), work, '--batch_size', '2',
          '--output_resolution', '64', '64', '--net_input_size', '32',
          '--spatial_bin', '8', '--luma_bins', '4', '--model_name',
          'HDRNetGaussianPyrNN', '--guide_complexity', '4', '--mesh_shape',
          '1', '2', '--max_steps', '1', '--device', 'cpu']
  ranks = [subprocess.Popen(
      [sys.executable, '-c', {_MESH_RANK!r}, *argv],
      env=dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE='2',
               MASTER_PORT=str(port)), stdout=subprocess.PIPE,
      stderr=subprocess.STDOUT, text=True) for r in range(2)]
  outs = [p.communicate(timeout=240)[0] for p in ranks]
  assert all(p.returncode == 0 for p in ranks), outs
finally:
  shutil.rmtree(work, ignore_errors=True)
print('spatial mesh training without jax')
'''


@pytest.fixture()
def converted_checkpoint(tmp_path):
  """A checkpoint of the JAX package's training (HDRNetCurves, tiny
  widths, 3 steps), converted by scripts/convert_jax_checkpoint.py in this
  process, where JAX may be imported."""
  import jax_checkpoints
  from hdrnet_tpu.config import Config, DataConfig, ModelConfig
  cfg = Config(model=ModelConfig(net_input_size=32, spatial_bin=8,
                                 luma_bins=4),
               data=DataConfig(output_resolution=[64, 64],
                               net_input_size=32))
  jax_checkpoints.write(tmp_path / 'jax', cfg)
  jax_checkpoints.converter().main([str(tmp_path / 'jax'),
                                    str(tmp_path / 'port')])
  return str(tmp_path / 'port')


def test_package_serves_with_jax_refused(converted_checkpoint):
  proc = subprocess.run([sys.executable, '-c', _BLOCKED_RUN,
                         converted_checkpoint], cwd=REPO,
                        capture_output=True, text=True, timeout=300,
                        check=False)
  assert proc.returncode == 0, proc.stdout + proc.stderr
  assert 'served without jax' in proc.stdout
  assert 'trained without jax' in proc.stdout
  assert 'zoo without jax' in proc.stdout
  assert 'tools without jax' in proc.stdout
  assert 'triage without jax' in proc.stdout
  assert 'device data without jax' in proc.stdout
  assert 'mesh training without jax' in proc.stdout
  assert 'spatial mesh training without jax' in proc.stdout


def test_entry_points_refuse_a_missing_card():
  """Without CUDA, the entry points raise unless the CPU is asked for;
  they never move to the CPU on their own."""
  import pytest
  import torch
  from hdrnet_torch.config import Config, ModelConfig
  from hdrnet_torch.inference import Enhancer
  from hdrnet_torch.training.loop import train
  if torch.cuda.is_available():
    pytest.skip('CUDA is available here: the refusal cannot show')
  cfg = ModelConfig(net_input_size=64, spatial_bin=8, luma_bins=4)
  with pytest.raises(RuntimeError, match="device='cpu'"):
    Enhancer(cfg)
  with pytest.raises(RuntimeError, match='CUDA is not available'):
    Enhancer(cfg, device='cuda:0')
  with pytest.raises(RuntimeError, match='CUDA is not available'):
    train(Config(model=cfg), 'unused_ckpt', 'unused_data')
  assert Enhancer(cfg, device='cpu').device.type == 'cpu'
