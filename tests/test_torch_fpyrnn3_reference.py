"""HDRNetFeaturesPyrNN3 at its published channel widths (cm 2: 8 learned
features a level, a grid of 9 outputs x 9 inputs, C = 27 a level block;
guide_complexity 16; a 256^2 preview) against the benchmark's plain
reference for it (``portbench/models/HDRNetFeaturesPyrNN3.py``), on the
CPU at small frames with seeded random weights: the forward, every
leaf's first gradient (the towers' through the slice-apply's image
cotangent), the image VJP against the port's reference op, the composite
serving, the family's counts by hand, and the benchmark cell's whole run
at tiny shapes (sound; the TF32 control and a dropped feature cotangent
each failing a limit). The port runs its kernels' plain versions here.
This file imports no JAX.
"""

import json
import time
from pathlib import Path

import pytest
import torch

from hdrnet_torch.config import ModelConfig
from hdrnet_torch.inference import Enhancer
from hdrnet_torch.models import make_model
from hdrnet_torch.ops import reference as port_ref
from hdrnet_torch.ops import slice_apply as sa
from portbench import counts, harness, inputs, models
from portbench.reference import plain

ROOT = Path(__file__).resolve().parents[1]
CELL = 'fpyrnn3-cm2-train-1024-b4'
CONFIG = json.loads(
    (ROOT / 'portbench/configs/hdrnet-fpyrnn3-cm2.json').read_text())
MODEL = CONFIG['model']
FAMILY = models.load('HDRNetFeaturesPyrNN3')
# The cell's run at tiny shapes: the channel widths kept, the preview and
# grid cut.
TINY_MODEL = {'net_input_size': 32, 'spatial_bin': 8, 'luma_bins': 4}
TINY_TRAFFIC = {'crop': 48, 'pair_size': 56, 'pairs': 3, 'warmup_steps': 1,
                'trace_skip': 1, 'trace_steps': 2}
SEED = 2**31 + 977


@pytest.fixture(scope='module')
def net_and_weights():
  net = make_model(ModelConfig(**MODEL))
  shapes = {k: tuple(v.shape) for k, v in net.state_dict().items()}
  sd = inputs.make_state_dict(shapes, CONFIG['init'], MODEL['luma_bins'],
                              SEED, 'cpu')
  net.load_state_dict(sd)
  return net, sd


def _batch(b=2, h=40, w=56, seed=1):
  gen = torch.Generator().manual_seed(seed)
  full = torch.rand(b, h, w, 3, generator=gen)
  target = torch.rand(b, h, w, 3, generator=gen)
  return plain.preview(full, MODEL['net_input_size']), full, target


def test_forward_matches_the_reference(net_and_weights):
  net, sd = net_and_weights
  low, full, _ = _batch()
  net.train()
  want = FAMILY.forward_train(sd, MODEL, low, full)
  got = net(low, full)
  assert got.shape == want.shape == full.shape
  # float32 convolutions and products summed in another order (read
  # 2e-7 against outputs of order 1).
  torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_every_first_gradient_matches_the_reference(net_and_weights):
  net, sd = net_and_weights
  low, full, target = _batch(seed=2)
  net.train()
  net.zero_grad()
  plain.l2_loss(target, net(low, full)).backward()
  leaves = {k: v.clone().requires_grad_(True) for k, v in sd.items()
            if not plain.is_buffer(k)}
  buffers = {k: v for k, v in sd.items() if plain.is_buffer(k)}
  loss = plain.l2_loss(target, FAMILY.forward_train({**leaves, **buffers},
                                                    MODEL, low, full))
  grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
  params = dict(net.named_parameters())
  assert set(params) == set(grads)
  towers = [k for k in grads if k.startswith('features_')]
  assert len(towers) == 3 * 3 * 2  # three levels, three convs, w and b
  for k, want in grads.items():
    got = params[k].grad
    # Relative to the leaf's largest entry: sums in another order (read
    # at most 3e-7); a dropped feature cotangent leaves the towers' at 0.
    scale = float(want.abs().max())
    assert scale > 0, k
    assert float((got - want).abs().max()) <= 1e-5 * scale, k


def test_image_vjp_matches_the_port_reference_op():
  gen = torch.Generator().manual_seed(3)
  grid = torch.randn(2, 4, 4, 8, 3, 9, generator=gen)
  guide = torch.rand(2, 11, 14, generator=gen) * 1.2 - 0.1
  feats = torch.randn(2, 11, 14, 8, generator=gen)
  ct = torch.randn(2, 11, 14, 3, generator=gen)
  want = port_ref.bilateral_slice_apply_input_vjp(grid, guide, ct)
  got = FAMILY.image_vjp(grid, guide, ct)
  assert got.shape == feats.shape
  torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
  # And through autograd of the reference's slice-apply.
  leaf = feats.clone().requires_grad_(True)
  out = FAMILY.slice_apply(grid, guide, leaf)
  torch.testing.assert_close(out, port_ref.bilateral_slice_apply(
      grid, guide, feats), rtol=0, atol=1e-5)
  (d_feats,) = torch.autograd.grad(out, leaf, ct)
  torch.testing.assert_close(d_feats, want, rtol=0, atol=1e-5)


def test_serving_matches_the_composite_route(net_and_weights):
  _, sd = net_and_weights
  enh = Enhancer(ModelConfig(**MODEL), sd, device='cpu')
  assert not enh.fused
  frame = torch.randint(0, 256, (1, 52, 68, 3), dtype=torch.uint8,
                        generator=torch.Generator().manual_seed(4))
  got = enh.process(plain.to_unit(frame))
  # Blocks of 20 rows: the guide and slice of a block are the frame's rows.
  want = FAMILY.serve(sd, MODEL, frame, block_rows=20)
  assert float(want.min()) >= 0 and float(want.max()) <= 1
  assert float(want.std()) > 0.05  # not all clipped
  torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_counts_by_hand():
  # The backbone at 256^2, sb 16, gd 8, cm 2: splat 3->16->32->64->128
  # to 128, 64, 32, 16; global convs 128->128 at 8^2 and 4^2; FCs
  # 2048->512->256->128; local convs 128->128 at 16^2; the 1x1 to
  # 8 x 9 x 9 = 648 channels.
  splat = (128**2 * 9 * 3 * 16 + 64**2 * 9 * 16 * 32 + 32**2 * 9 * 32 * 64
           + 16**2 * 9 * 64 * 128)
  glob = 8**2 * 9 * 128 * 128 + 4**2 * 9 * 128 * 128
  fc = 2048 * 512 + 512 * 256 + 256 * 128
  local = 2 * 16**2 * 9 * 128 * 128
  pred = 16**2 * 128 * 648
  backbone = 2 * (splat + glob + fc + local + pred)
  assert counts.backbone_ops(MODEL) == backbone
  # A step of 4 images of 16^2: three levels 16^2, 8^2, 4^2; a pixel's
  # tower 2 x 9 x (3 x 16 + 16 x 16 + 16 x 8), its NN guide 9 x 16 + 4,
  # K3 at C = 27: 55 + 16 x 27 + 2 x 3 x 8.
  tower = 2 * 9 * (3 * 16 + 16 * 16 + 16 * 8)
  k3 = 55 + 16 * 27 + 2 * 3 * 8
  px = 16 * 16 + 8 * 8 + 4 * 4
  down = 3 * 3 * (8 * 16 + 8 * 8) + 3 * 3 * (4 * 8 + 4 * 4)
  up = (3 * 3 * (16 * 8 + 16 * 16) + 3 * 256 + 3 * 3 * (8 * 4 + 8 * 8)
        + 3 * 64)
  forward = backbone + px * (tower + 148 + k3) + down + up + 9 * 256
  assert counts.train_step_ops(MODEL, 16) == 3 * 4 * forward
  # Slice-apply bounds of the 1024^2 step, bytes or operations per kernel.
  ops = FAMILY.kernel_ops(MODEL)
  assert ops == {'K3': 535, 'K4': 608, 'K5': 489}
  grid = 4 * 16 * 16 * 8 * 27 * 4
  total = 0.0
  for n in (1024, 512, 256):
    px, pad = 4 * n * n, -(-n // 32)
    padded = 4 * (n + 2 * pad) ** 2
    total += max((grid + px * 12 * 4) / 3.35e12, px * 535 / 67e12)
    total += max((grid + px * 21 * 4) / 3.35e12, px * 608 / 67e12)
    total += max((grid + px * 12 * 4) / 3.35e12, padded * 489 / 67e12)
  assert counts.slice_apply_bound_s(MODEL, 1024) == pytest.approx(total)


def test_batch_is_the_traffic_batch():
  bench = json.loads((ROOT / 'BENCHMARK.json').read_text())
  entry = next(w for w in bench['workloads'] if w['name'] == CELL)
  traffic = json.loads(
      (ROOT / 'portbench/traffic' / f"{entry['traffic']}.json").read_text())
  assert FAMILY.BATCH == traffic['batch_size'] == 4
  assert entry['config'] == 'hdrnet-fpyrnn3-cm2'
  assert MODEL['model_name'] == 'HDRNetFeaturesPyrNN3'


def _tiny_run():
  return harness.run_cell(CELL, SEED, 1.0, 0, 'cpu', model=TINY_MODEL,
                          traffic=TINY_TRAFFIC)


def test_cell_run_is_correct():
  _, out, line = _tiny_run()
  assert out.correct, line['checks']
  assert line['failed'] == 0 and line['attempted'] > 0
  assert set(line['metrics']) == {'train_steps_per_s', 'peak_mem_gib',
                                  'setup_s'}


def test_cell_run_without_the_feature_cotangent_fails(monkeypatch):
  """K4 with the features' cotangent zeroed: the towers learn nothing,
  and their first gradients fail ``grad_gap``."""
  whole = sa.slice_apply_pix_bwd

  def dropped(*args, **kwargs):
    d_guide, d_image = whole(*args, **kwargs)
    return d_guide, None if d_image is None else torch.zeros_like(d_image)
  monkeypatch.setattr(sa, 'slice_apply_pix_bwd', dropped)
  _, out, line = _tiny_run()
  assert not out.correct
  checks = line['checks']
  assert checks['grad_gap']['value'] > checks['grad_gap']['limit'], checks


def test_tf32_control_fails_a_limit():
  """The reference in TF32 in the program's place fails one of the cell's
  numbers (its TF32 products emulated here; on the card at the cell's own
  size, PERF.md)."""
  run = harness.make_run(CELL, SEED, 1.0, 0, 'cpu', time.monotonic(),
                         model=TINY_MODEL, traffic=TINY_TRAFFIC)
  got = harness.driver(run).control(run)
  tf32 = {k.split('.', 1)[1]: v for k, v in got.items()
          if k.startswith('tf32.')}
  assert any(v > run.limits[k] for k, v in tf32.items()), (tf32, run.limits)
