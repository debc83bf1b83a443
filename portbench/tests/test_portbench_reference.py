"""The plain reference against the port's plain path at tiny shapes on the
CPU (the program's CPU route runs its kernels' plain versions), and the
reference's independence of the program."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import inputs, models
from portbench.reference import crops, plain

ROOT = Path(__file__).resolve().parents[2]
SMALL = dict(net_input_size=32, spatial_bin=8, luma_bins=4)


def _model(name, seed=5):
  from hdrnet_torch.config import ModelConfig
  from hdrnet_torch.models import make_model
  cfg = ModelConfig(model_name=name, **SMALL)
  model = make_model(cfg)
  shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
  init = {'bn.running_var': {'mean': 1.0, 'std': 0.3, 'positive': True},
          'bn.running_mean': {'std': 0.1},
          'prediction_conv.conv.bias': {'mean': 'identity_finest',
                                        'std': 0.02}}
  sd = inputs.make_state_dict(shapes, init, cfg.luma_bins, seed, 'cpu')
  model.load_state_dict(sd)
  return cfg, model, sd


def test_reference_imports_nothing_of_the_program():
  paths = [*(ROOT / 'portbench' / 'reference').glob('*.py'),
           *(ROOT / 'portbench' / 'models').glob('*.py'),
           ROOT / 'portbench' / 'counts.py']
  for path in paths:
    for node in ast.walk(ast.parse(path.read_text())):
      names = ([a.name for a in node.names] if isinstance(node, ast.Import)
               else [node.module or ''] if isinstance(node, ast.ImportFrom)
               else [])
      for name in names:
        assert name.split('.')[0] not in ('jax', 'jaxlib', 'flax',
                                          'hdrnet_tpu', 'hdrnet_torch'), (
                                              path, name)
  code = ('import sys; import portbench.reference.plain, '
          'portbench.reference.crops, portbench.models.HDRNetCurves, '
          'portbench.models.HDRNetGaussianPyrNN; '
          'print(sorted({m.split(".")[0] for m in sys.modules} & '
          '{"jax", "hdrnet_tpu", "hdrnet_torch", "flax"}))')
  out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, check=True,
                       capture_output=True, text=True).stdout
  assert out.strip() == '[]'


@pytest.mark.parametrize('name', ['HDRNetCurves', 'HDRNetGaussianPyrNN'])
def test_backbone_matches_the_port(name):
  cfg, model, sd = _model(name)
  low = torch.rand(2, 3, 32, 32, generator=torch.Generator().manual_seed(1))
  want = model.coefficients(low)
  got = plain.backbone(sd, low, cfg.luma_bins)
  assert got.shape == want.shape
  torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_curves_guide_and_slice_match_the_port():
  from hdrnet_torch.ops import reference as port_ref
  cfg, model, sd = _model('HDRNetCurves')
  img = torch.rand(1, 9, 13, 3, generator=torch.Generator().manual_seed(2))
  guide = plain.curves_guide(sd, img)
  torch.testing.assert_close(guide, model.guide(img), rtol=0, atol=1e-6)
  grid = plain.backbone(sd, plain.preview(img, 32).permute(0, 3, 1, 2),
                        cfg.luma_bins)
  want = port_ref.bilateral_slice_apply(grid, guide, img)
  torch.testing.assert_close(plain.slice_apply_plain(grid, guide, img), want,
                             rtol=0, atol=1e-6)
  # A band of rows slices as the whole frame's rows.
  band = plain.slice_apply_plain(grid, guide[:, 4:], img[:, 4:], 4, 9)
  torch.testing.assert_close(band, want[:, 4:], rtol=0, atol=1e-6)


def test_vjps_match_the_port():
  from hdrnet_torch.ops import reference as port_ref
  gen = torch.Generator().manual_seed(3)
  grid = torch.randn(1, 4, 4, 4, 3, 4, generator=gen)
  guide = torch.rand(1, 11, 14, generator=gen) * 1.2 - 0.1
  img = torch.rand(1, 11, 14, 3, generator=gen)
  ct = torch.randn(1, 11, 14, 3, generator=gen)
  torch.testing.assert_close(
      plain.grid_vjp(guide, img, ct, grid.shape[1:]),
      port_ref.bilateral_slice_apply_grid_vjp(guide, img, ct, grid.shape[1:]),
      rtol=1e-5, atol=1e-5)
  torch.testing.assert_close(
      plain.guide_vjp(grid, guide, img, ct),
      port_ref.bilateral_slice_apply_guide_vjp(grid, guide, img, ct),
      rtol=1e-5, atol=1e-5)


def test_nn_guide_and_pyramid_match_the_port():
  from hdrnet_torch.models.hdrnet import gaussian_pyramid, upsample_add
  _, model, sd = _model('HDRNetGaussianPyrNN')
  img = torch.rand(1, 16, 20, 3, generator=torch.Generator().manual_seed(4))
  guide = model.guide_level_1
  guide.eval()
  torch.testing.assert_close(
      plain.nn_guide(sd, img, 'guide_level_1.', training=False), guide(img),
      rtol=0, atol=1e-6)
  guide.train()
  torch.testing.assert_close(
      plain.nn_guide(sd, img, 'guide_level_1.', training=True), guide(img),
      rtol=0, atol=1e-6)
  for got, want in zip(plain.pyramid(img, 3), gaussian_pyramid(img, 3)):
    assert torch.equal(got, want)
  small = torch.rand(1, 8, 10, 3)
  assert torch.equal(plain.resize_bilinear(small, (16, 20)) + img,
                     upsample_add(small, img))


def test_preview_matches_k2_plain():
  from hdrnet_torch.ops.downsample import nearest_lowres_plain
  frame = torch.randint(0, 256, (1, 45, 77, 3), dtype=torch.uint8)
  want = nearest_lowres_plain(frame, 16).permute(0, 2, 3, 1)
  assert torch.equal(plain.to_unit(plain.preview(frame, 16)), want)


def test_one_training_step_matches_the_port():
  from hdrnet_torch.config import TrainConfig
  from hdrnet_torch.training.loop import make_optimizer
  from hdrnet_torch.training.step import create_state, make_train_step
  for name in ('HDRNetCurves', 'HDRNetGaussianPyrNN'):
    cfg, model, sd = _model(name)
    gen = torch.Generator().manual_seed(6)
    batch = {'image_input': torch.rand(1, 40, 40, 3, generator=gen),
             'image_output': torch.rand(1, 40, 40, 3, generator=gen)}
    batch['lowres_input'] = plain.preview(batch['image_input'], 32)
    batch['lowres_output'] = batch['lowres_input']
    state = create_state(model, make_optimizer(model, TrainConfig()))
    state, m = make_train_step()(state, dict(batch))
    family = models.load(name)

    def forward(p, lowres, fullres):
      return family.forward_train(p, {'luma_bins': cfg.luma_bins}, lowres,
                                  fullres)
    losses, _, params = plain.train_steps(sd, forward, [batch], 1e-4)
    assert losses[0] == pytest.approx(float(m['loss']), rel=1e-6)
    # Adam's first update is lr * g / (|g| + eps): where |g| is near eps
    # a rounding of g moves it by a share of lr (1e-4), so a tenth of lr.
    for k, p in model.named_parameters():
      torch.testing.assert_close(params[k], p.detach(), rtol=0, atol=1e-5)


def test_tf32_rounding_keeps_ten_mantissa_bits():
  x = torch.tensor([1.0 + 2**-11, 1.0 + 2**-10 + 2**-12, -3.0 - 2**-12])
  got = plain._tf32(x)
  assert got.tolist() == [1.0 + 2**-10, 1.0 + 2**-10, -3.0]


def test_crop_draws_follow_the_device_route():
  from hdrnet_torch.config import DataConfig
  from hdrnet_torch.data.device import DeviceDataset
  ins = torch.zeros(5, 30, 34, 3, dtype=torch.uint8)
  cfg = DataConfig(batch_size=2, output_resolution=[16, 16],
                   net_input_size=8)
  dds = DeviceDataset(None, cfg, 'cpu', arrays=(ins, ins))
  port = dds.param_stream(2**32 - 7, 2)
  mine = crops.draws(2**32 - 7, 5, 14, 18, 2)
  for _ in range(7):
    p = next(port)
    idx, y0, x0 = next(mine)
    assert list(p['idx']) == idx
    assert np.array_equal(p['y0'], y0) and np.array_equal(p['x0'], x0)
