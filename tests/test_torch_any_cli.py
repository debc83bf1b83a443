"""Arbitrary-size serving (``Enhancer.enhance_any``) and the port's
``bin/run.py`` and ``bin/evaluate.py`` on the CPU.

``enhance_any`` serves the exact shape; it is held at 2e-5 to the JAX
Enhancer's ``enhance_any`` in interpret mode: at an odd size, which JAX
serves at its exact shape, and at a size whose resolution bucket the JAX
planner takes, so that JAX pads and runs its true-size K7. The pyramid is
held to the JAX exact-shape path. The CLIs run end to end from a
checkpoint the port's own ``train`` wrote, with ``--device cpu``.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from hdrnet_tpu.inference import Enhancer as JaxEnhancer
from hdrnet_tpu.models import make_model as jax_make_model

from hdrnet_torch.bin import evaluate as evaluate_cli
from hdrnet_torch.bin import run as run_cli
from hdrnet_torch.config import (Config, DataConfig, ModelConfig,
                                 TrainConfig)
from hdrnet_torch.convert import convert_flax_variables
from hdrnet_torch.inference import Enhancer
from hdrnet_torch.ops import downsample
from hdrnet_torch.training.loop import train

TOL = 2e-5


@functools.lru_cache(maxsize=None)
def _pair(name):
  cfg = ModelConfig(model_name=name, net_input_size=64, spatial_bin=8,
                    luma_bins=4, guide_complexity=4)
  model = jax_make_model(cfg)
  init = jax.jit(functools.partial(model.init, train=True))
  variables = init(jax.random.PRNGKey(1), jnp.zeros((1, 64, 64, 3)),
                   jnp.zeros((1, 16, 16, 3)))
  jax_enh = JaxEnhancer(config=cfg, variables=variables, interpret=True)
  port = Enhancer(cfg, convert_flax_variables(variables), device='cpu')
  return jax_enh, port


@pytest.mark.parametrize('name', ['HDRNetCurves', 'HDRNetPointwiseNNGuide'])
@pytest.mark.parametrize('hw', [(37, 53), (300, 270)])
def test_enhance_any_matches_jax(name, hw):
  """(37, 53): below the JAX ladder's feasible buckets, served at its
  exact shape; (300, 270): the JAX 320 x 320 bucket, true-size K7."""
  jax_enh, port = _pair(name)
  rng = np.random.RandomState(3)
  lowres = rng.rand(1, 64, 64, 3).astype(np.float32)
  fullres = rng.rand(1, *hw, 3).astype(np.float32)
  if hw == (300, 270):
    assert jax_enh._bucketable(*hw) is not None
  want = np.asarray(jax_enh.enhance_any(lowres, fullres))
  got = port.enhance_any(lowres, fullres)
  assert got.shape == (1, *hw, 3) and got.device.type == 'cpu'
  np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
  assert torch.equal(port.enhance_any(torch.from_numpy(lowres),
                                      torch.from_numpy(fullres)), got)


def test_enhance_any_pyramid_matches_jax_exact_path():
  jax_enh, port = _pair('HDRNetGaussianPyrNN')
  rng = np.random.RandomState(4)
  lowres = rng.rand(1, 64, 64, 3).astype(np.float32)
  fullres = rng.rand(1, 101, 75, 3).astype(np.float32)
  want = np.asarray(jax_enh(jnp.asarray(lowres), jnp.asarray(fullres),
                            clip=False))
  got = port.enhance_any(lowres, fullres, clip=False)
  assert got.shape == (1, 101, 75, 3)
  np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_enhance_any_refuses_a_tensor_elsewhere():
  port = _pair('HDRNetCurves')[1]
  with pytest.raises(ValueError, match='model on cpu'):
    port.enhance_any(torch.zeros(1, 64, 64, 3, device='meta'),
                     torch.zeros(1, 32, 32, 3, device='meta'))


@pytest.fixture(scope='module')
def checkpoint(tmp_path_factory):
  """Two steps of the port's own training on the brighten-by-1.3x PNGs of
  tests/test_train.py, with its config."""
  root = tmp_path_factory.mktemp('run_cli')
  data = root / 'data'
  rng = np.random.RandomState(0)
  os.makedirs(data / 'input')
  os.makedirs(data / 'output')
  names = []
  for i in range(4):
    im = (rng.rand(80, 96, 3) * 255).astype(np.uint8)
    out = np.clip(im.astype(np.float32) * 1.3, 0, 255).astype(np.uint8)
    Image.fromarray(im).save(data / 'input' / f'im{i}.png')
    Image.fromarray(out).save(data / 'output' / f'im{i}.png')
    names.append(f'im{i}.png')
  (data / 'filelist.txt').write_text('\n'.join(names))
  cfg = Config(
      model=ModelConfig(model_name='HDRNetCurves', net_input_size=32,
                        spatial_bin=8, luma_bins=4,
                        output_resolution=[64, 64]),
      data=DataConfig(batch_size=2, output_resolution=[64, 64],
                      net_input_size=32, data_threads=1),
      train=TrainConfig(learning_rate=3e-3, max_steps=2, log_interval=9999,
                        summary_interval=9999, checkpoint_interval=9999))
  ckpt = root / 'ckpt'
  train(cfg, str(ckpt), str(data), device='cpu')
  return ckpt, data


def test_run_cli_mixed_sizes(checkpoint, tmp_path):
  """A directory of mixed sizes, each served at its own; then
  --lowres_input with --limit (tests/test_train.py's run test)."""
  ckpt, _ = checkpoint
  rng = np.random.RandomState(3)
  photos, lowdir = tmp_path / 'photos', tmp_path / 'low'
  os.makedirs(photos)
  os.makedirs(lowdir)
  for i, (h, w) in enumerate([(70, 90), (90, 70), (80, 80)]):
    im = (rng.rand(h, w, 3) * 255).astype(np.uint8)
    Image.fromarray(im).save(photos / f'p{i}.png')
    low = (rng.rand(32, 32, 3) * 255).astype(np.uint8)
    Image.fromarray(low).save(lowdir / f'p{i}.png')

  out = tmp_path / 'out'
  run_cli.main([str(ckpt), str(photos), str(out), '--device', 'cpu'])
  assert sorted(os.listdir(out)) == ['p0.png', 'p1.png', 'p2.png']
  got = np.asarray(Image.open(out / 'p1.png'))
  assert got.shape == (90, 70, 3)
  # The file is the per-image function's output, quantized.
  enh = Enhancer.from_checkpoint(str(ckpt), device='cpu')
  im = np.asarray(Image.open(photos / 'p1.png')).astype(np.float32) / 255
  want, _ = run_cli.enhance_image(enh, im)
  want = (np.clip(want[0].numpy(), 0, 1) * 255 + 0.5).astype(np.uint8)
  assert np.abs(got.astype(int) - want).max() <= 1

  out2 = tmp_path / 'out2'
  run_cli.main([str(ckpt), str(photos), str(out2), '--lowres_input',
                str(lowdir), '--limit', '1', '--device', 'cpu'])
  assert sorted(os.listdir(out2)) == ['p0.png']


def test_run_cli_debug_writes_the_reference_dumps(checkpoint, tmp_path):
  ckpt, data = checkpoint
  out = tmp_path / 'out'
  run_cli.main([str(ckpt), str(data / 'input' / 'im0.png'), str(out),
                '--debug', '--device', 'cpu'])
  assert sorted(os.listdir(out)) == ['im0.png', 'im0_coeffs.png',
                                     'im0_guide_0.png', 'im0_input.png']
  # The grid tiled (gh * gd, gw * ni * no), as the JAX run writes it.
  assert np.asarray(Image.open(out / 'im0_coeffs.png')).shape == (8 * 4,
                                                                  8 * 4 * 3)


def test_run_function_preview_is_the_nearest_table():
  """With no --lowres_input the preview is cut by K2 (its plain version
  here): the same output as the preview given explicitly."""
  port = _pair('HDRNetCurves')[1]
  im = np.random.RandomState(6).rand(45, 61, 3).astype(np.float32)
  low = downsample.nearest_lowres_plain(torch.from_numpy(im[None]), 64)
  got, inter = run_cli.enhance_image(port, im)
  want, _ = run_cli.enhance_image(port, im, low[0].permute(1, 2, 0).numpy())
  assert inter is None and torch.equal(got, want)
  dbg, inter = run_cli.enhance_image(port, im, debug=True)
  np.testing.assert_allclose(dbg.numpy(), got.numpy(), rtol=0, atol=1e-4)
  # What the Flax model sows at top level: no pyramid levels here.
  assert sorted(inter) == ['bilateral_coefficients', 'guide_map']


def test_evaluate_cli(checkpoint, tmp_path, capsys):
  """Mean PSNR / L2 as JSON; the serving path (the fused kernels' plain
  versions here) agrees with the training graph (tests/test_train.py's
  evaluate test); the bf16 backbone runs and is reported."""
  ckpt, data = checkpoint
  evaluate_cli.main([str(ckpt), str(data), '--limit', '2', '--device',
                     'cpu'])
  result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
  assert result['step'] == 2 and result['n_images'] == 2
  assert np.isfinite(result['mean_psnr_db']) and result['mean_l2'] >= 0.0

  json_out = tmp_path / 'eval.json'
  evaluate_cli.main([str(ckpt), str(data), '--limit', '2', '--serving',
                     '--device', 'cpu', '--json', str(json_out)])
  srv = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
  assert srv['serving'] == {'fused': True, 'coeff_bf16': False}
  assert json.loads(json_out.read_text()) == srv
  np.testing.assert_allclose(srv['mean_psnr_db'], result['mean_psnr_db'],
                             rtol=1e-5)
  evaluate_cli.main([str(ckpt), str(data), '--limit', '2', '--serving',
                     '--coeff_bf16', '--device', 'cpu'])
  bf16 = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
  assert bf16['serving'] == {'fused': True, 'coeff_bf16': True}
  assert abs(bf16['mean_psnr_db'] - srv['mean_psnr_db']) < 0.5
