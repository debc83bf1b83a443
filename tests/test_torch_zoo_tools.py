"""The route an Enhancer takes, the bfloat16 backbone, and the tools
(``bin/run.py``, ``bin/export.py``, ``bin/evaluate.py``) on models of the
extended zoo and the baselines, on the CPU: the fused route for the three
HDRNet classes only, the bf16 backbone against the JAX package's, and the
tools' refusals (ValueError with the reason where the JAX tools fail with
a KeyError) and outputs for composite-route models.
"""

import json
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hdrnet_tpu.inference import Enhancer as JaxEnhancer

from hdrnet_torch.bin import evaluate as evaluate_cli
from hdrnet_torch.bin import export
from hdrnet_torch.bin import run as run_cli
from hdrnet_torch.config import Config, DataConfig, ModelConfig
from hdrnet_torch.convert import convert_flax_variables
from hdrnet_torch.data import images
from hdrnet_torch.inference import Enhancer
from hdrnet_torch.models import make_model
from hdrnet_torch.ops import resize
from hdrnet_torch.training import loop, step
from hdrnet_torch.training.checkpoint import Checkpointer

from zoo_parity import FUSED, ZOO, flax_variables, port_cfg, small_cfg

# The bfloat16 backbone's grid against the JAX package's on the same
# weights and preview, of the grid's max |value|. Both cast the weights,
# statistics and preview to bfloat16 and round each layer's output to
# bfloat16. Measured here (three models, two seeds): 0, the two agree bit
# for bit on the CPU; the order in which a convolution accumulates is
# the library's choice, so the test allows one bfloat16 rounding at the
# grid's scale, 2^-8. Against the float32 grid the bfloat16 one differs
# by 7.3e-3 to 8.9e-3 of the max in the same runs.
BF16_REL = 2.0 ** -8


def test_fused_route_is_taken_for_the_three_classes_only():
  """Every model of the registry at this configuration: fused exactly for
  HDRNetCurves, HDRNetPointwiseNNGuide and HDRNetGaussianPyrNN at 3 -> 3,
  by class, not by subclass (HDRNet3x3NNGuide and StyleTransferCurves are
  HDRNetCurves, StyleTransferNN is an HDRNetPointwiseNNGuide,
  HDRNetGaussianPyr an HDRNetGaussianPyrNN); at 4 input channels none."""
  for name in ZOO + FUSED:
    enh = Enhancer(port_cfg(name), device='cpu')
    assert enh.fused == (name in FUSED), name
  for name in FUSED:
    assert not Enhancer(port_cfg(name, n_in=4), device='cpu').fused


@pytest.mark.parametrize('name', ['HDRNetCurves', 'HDRNetPointwiseNNGuide',
                                  'HDRNetGaussianPyrNN'])
def test_bf16_backbone_matches_jax_bf16_backbone(name):
  """``coeff_bf16``: the grid of the bfloat16 copy of the backbone on a
  bfloat16 preview, cast back to float32, against the JAX Enhancer's
  ``_backbone_grid`` with ``coeff_bf16`` (BF16_REL of the grid's max);
  the bf16 Enhancer serves within a few codes of the float32 one."""
  cfg = port_cfg(name)
  variables = flax_variables(name)
  jax_enh = JaxEnhancer(config=small_cfg(name), variables=variables,
                        coeff_bf16=True)
  state = convert_flax_variables(variables)
  port = Enhancer(cfg, state, device='cpu', coeff_bf16=True)
  f32 = Enhancer(cfg, state, device='cpu')
  assert port.fused and port.coeff_bf16
  rng = np.random.RandomState(6)
  low = rng.rand(2, 64, 64, 3).astype(np.float32)
  want = np.asarray(jax_enh._backbone_grid(jnp.asarray(low)))
  got = port._backbone_grid(torch.from_numpy(low).permute(0, 3, 1, 2))
  assert got.dtype == torch.float32 and got.shape == want.shape
  scale = float(np.abs(want).max())
  np.testing.assert_allclose(got.numpy(), want, rtol=0,
                             atol=BF16_REL * scale)
  assert not torch.equal(got, f32._backbone_grid(
      torch.from_numpy(low).permute(0, 3, 1, 2)))
  frame = torch.from_numpy(rng.rand(1, 40, 56, 3).astype(np.float32))
  diff = (port.process(frame) - f32.process(frame)).abs().max()
  assert 0.0 < float(diff) < 0.05


def test_bf16_on_the_composite_route_warns_and_stays_f32(caplog):
  state = make_model(port_cfg('UNet')).state_dict()
  with caplog.at_level('WARNING', logger='hdrnet_torch.inference'):
    enh = Enhancer(port_cfg('UNet'), state, device='cpu', coeff_bf16=True)
  assert not enh.fused and not enh.coeff_bf16
  assert 'composite' in caplog.text
  frame = torch.rand(1, 24, 40, 3)
  want = Enhancer(port_cfg('UNet'), state, device='cpu').process(frame)
  assert torch.equal(enh.process(frame), want)


def test_enhance_sharded_refuses_a_composite_model():
  enh = Enhancer(port_cfg('HDRNetFeaturesPyrNN'), device='cpu')
  with pytest.raises(ValueError, match='HDRNetFeaturesPyrNN'):
    enh.enhance_sharded(torch.rand(1, 64, 64, 3), torch.rand(1, 32, 40, 3),
                        ['cpu'] * 2)


def _checkpoint(name, directory, seed=0):
  """A seeded checkpoint of `name` at the small configuration, saved as
  ``hdrnet_torch.training`` saves one."""
  cfg = port_cfg(name)
  model = make_model(cfg, torch.Generator().manual_seed(seed))
  config = Config(model=cfg, data=DataConfig(output_resolution=[24, 40],
                                             net_input_size=64))
  config.save(str(directory))
  state = step.create_state(model, loop.make_optimizer(model, config.train))
  Checkpointer(str(directory)).save(3, state)
  return model.eval()


@pytest.mark.parametrize('name', ['UNet', 'HDRNetStack'])
def test_run_debug_refuses_a_model_without_a_top_level_grid(name, tmp_path):
  """``bin/run.py --debug`` writes the grid, which these models do not
  have at top level (the JAX run fails there with a KeyError); without
  --debug they are served."""
  _checkpoint(name, tmp_path / 'ckpt')
  im = tmp_path / 'im.png'
  images.imwrite(str(im), np.random.RandomState(7).rand(30, 44, 3))
  with pytest.raises(ValueError, match=f'--debug.*{name}'):
    run_cli.main([str(tmp_path / 'ckpt'), str(im), str(tmp_path / 'o'),
                  '--debug', '--device', 'cpu'])
  run_cli.main([str(tmp_path / 'ckpt'), str(im), str(tmp_path / 'out'),
                '--device', 'cpu'])
  assert os.listdir(tmp_path / 'out') == ['im.png']


def test_run_debug_writes_a_feature_pyramid(tmp_path):
  """--debug on a zoo model with a grid: the grid, one guide a level."""
  _checkpoint('HDRNetFeaturesPyrNN', tmp_path / 'ckpt')
  im = tmp_path / 'im.png'
  images.imwrite(str(im), np.random.RandomState(8).rand(32, 48, 3))
  run_cli.main([str(tmp_path / 'ckpt'), str(im), str(tmp_path / 'out'),
                '--debug', '--device', 'cpu'])
  assert sorted(os.listdir(tmp_path / 'out')) == [
      'im.png', 'im_coeffs.png', 'im_guide_0.png', 'im_guide_1.png',
      'im_guide_2.png', 'im_input.png']


def test_export_of_composite_models(tmp_path):
  """A composite model gets ``coefficients_fn`` (when it has a top-level
  grid), ``enhance_fn`` and ``stream_fn``, and no ``serve_fn`` or
  ``serve_any_fn`` (as the JAX export, which writes those on the fused
  route only); ``coefficients_fn`` refuses a model without a top-level
  grid, whose export writes the other two. Each reloaded graph gives the
  eager Enhancer's bits."""
  ckpt = tmp_path / 'ckpt'
  model = _checkpoint('HDRNetFullresFeatures', ckpt)
  programs = export.main([str(ckpt), '--fullres', '24', '40',
                          '--device', 'cpu'])
  assert sorted(programs) == ['coefficients_fn', 'enhance_fn', 'stream_fn']
  rng = np.random.RandomState(9)
  low = torch.from_numpy(rng.rand(1, 64, 64, 3).astype(np.float32))
  full = torch.from_numpy(rng.rand(1, 24, 40, 3).astype(np.float32))
  got = export.load_artifact(str(ckpt / 'enhance_fn.pt2'))(low, full)
  with torch.no_grad():
    want = torch.clamp(model(low, full), 0.0, 1.0)
  assert torch.equal(got, want)
  u8 = torch.from_numpy(rng.randint(0, 256, (1, 24, 40, 3)).astype(np.uint8))
  enh = Enhancer.from_checkpoint(str(ckpt), device='cpu')
  got = export.load_artifact(str(ckpt / 'stream_fn.pt2'))(u8)
  assert torch.equal(got, enh.make_stream_fn((1, 24, 40, 3))(u8))

  # UNet's decoder resizes with resize_nearest inside the traced forward:
  # with its index tables not cached yet, the enhance_fn trace must not
  # leave a fake tensor in the cache for the stream_fn trace.
  resize.nearest_index_tensor.cache_clear()
  unet = tmp_path / 'unet'
  _checkpoint('UNet', unet)
  with pytest.raises(ValueError, match='coefficients_fn.*UNet'):
    export.coefficients_function(Enhancer.from_checkpoint(str(unet),
                                                          device='cpu'))
  programs = export.main([str(unet), '--fullres', '24', '40',
                          '--device', 'cpu'])
  assert sorted(programs) == ['enhance_fn', 'stream_fn']


def _dataset(directory, n=2, hw=(24, 40)):
  rng = np.random.RandomState(10)
  names = []
  for d in ('input', 'output'):
    os.makedirs(directory / d)
  for i in range(n):
    name = f'im{i}.png'
    images.imwrite(str(directory / 'input' / name), rng.rand(*hw, 3))
    images.imwrite(str(directory / 'output' / name), rng.rand(*hw, 3))
    names.append(name)
  (directory / 'filelist.txt').write_text('\n'.join(names) + '\n')


@pytest.mark.parametrize('name,fused', [('HDRNetCurves', True),
                                        ('HDRNet3x3NNGuide', False)])
def test_evaluate_serving_coeff_bf16(name, fused, tmp_path, capsys):
  """``bin/evaluate.py --serving --coeff_bf16`` runs and reports the
  route and precision the Enhancer ran: the bf16 backbone on the fused
  route; float32 on the composite route."""
  _checkpoint(name, tmp_path / 'ckpt')
  _dataset(tmp_path / 'data')
  evaluate_cli.main([str(tmp_path / 'ckpt'), str(tmp_path / 'data'),
                     '--serving', '--coeff_bf16', '--device', 'cpu'])
  result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
  assert result['serving'] == {'fused': fused, 'coeff_bf16': fused}
  assert result['n_images'] == 2 and np.isfinite(result['mean_psnr_db'])


# The bfloat16 backbone against float32, served at the default widths
# (256^2 preview, l8/s16/cm1, gc 16), seeded, on 540x960 frames: measured
# here (seeds 0-2, both models) max abs 2.07e-2 to 3.06e-2 and PSNR 47.97
# to 50.25 dB. chip_smoke.py holds its 4K frames to the same limits.
BF16_MAX_ABS = 6e-2
BF16_MIN_PSNR = 44.0


@pytest.mark.parametrize('name', ['HDRNetCurves', 'HDRNetPointwiseNNGuide'])
def test_bf16_serving_error_at_default_widths(name):
  for seed in range(3):
    cfg = ModelConfig(model_name=name)
    f32 = Enhancer(cfg, device='cpu', seed=seed)
    bf16 = Enhancer(cfg, f32.model.state_dict(), device='cpu',
                    coeff_bf16=True)
    x = torch.rand((1, 540, 960, 3),
                   generator=torch.Generator().manual_seed(seed))
    a, b = f32.process(x), bf16.process(x)
    diff = float((a - b).abs().max())
    psnr = 10 * np.log10(1.0 / float(((a - b) ** 2).mean()))
    assert 0.0 < diff <= BF16_MAX_ABS and psnr >= BF16_MIN_PSNR, (seed, diff,
                                                                 psnr)
