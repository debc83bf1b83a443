"""HDRNetStack at its published channel widths (two NN-guide stages,
guide_complexity 16, luma_bins 8, spatial_bin 16, cm 1, a 256^2 preview)
against the benchmark's plain reference for it
(``portbench/models/HDRNetStack.py``), on the CPU at small frames with
seeded random weights: the forward, every leaf's first gradient (stage
0's reached only through stage 1's image, guide and preview), the
composite serving, the family's counts by hand, and the benchmark cell's
whole run at tiny shapes (sound; the TF32 control and a zeroed image
cotangent each failing a limit). The port runs its kernels' plain
versions here. This file imports no JAX.
"""

import json
import time
from pathlib import Path

import pytest
import torch

from hdrnet_torch.config import ModelConfig
from hdrnet_torch.inference import Enhancer
from hdrnet_torch.models import make_model
from hdrnet_torch.ops import slice_apply as sa
from portbench import counts, harness, inputs, models
from portbench.reference import plain

ROOT = Path(__file__).resolve().parents[1]
CELL = 'stack-train-2048'
CONFIG = json.loads((ROOT / 'portbench/configs/hdrnet-stack.json').read_text())
MODEL = CONFIG['model']
FAMILY = models.load('HDRNetStack')
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
  with torch.no_grad():
    got = net(low, full)
  assert got.shape == want.shape == full.shape
  # The identity-affine start passes each stage's input nearly through.
  assert float((want - full).abs().max()) < 1.0
  # float32 convolutions and products summed in another order (read
  # 6e-7 against outputs of order 1).
  torch.testing.assert_close(got, want.detach(), rtol=0, atol=1e-5)


def _reference_grads(sd, low, full, target):
  leaves = {k: v.clone().requires_grad_(True) for k, v in sd.items()
            if not plain.is_buffer(k)}
  buffers = {k: v for k, v in sd.items() if plain.is_buffer(k)}
  loss = plain.l2_loss(target, FAMILY.forward_train({**leaves, **buffers},
                                                    MODEL, low, full))
  return dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))


def test_every_first_gradient_matches_the_reference(net_and_weights,
                                                    monkeypatch):
  net, sd = net_and_weights
  low, full, target = _batch(seed=2)
  net.train()
  net.zero_grad()
  plain.l2_loss(target, net(low, full)).backward()
  grads = _reference_grads(sd, low, full, target)
  params = dict(net.named_parameters())
  assert set(params) == set(grads)
  assert sum(k.startswith('stage0.') for k in grads) == len(grads) // 2
  for k, want in grads.items():
    got = params[k].grad
    # Relative to the leaf's largest entry: sums over every pixel in
    # another order, widest in the guides' batch-norm leaves (read at most
    # 1.7e-5, stage 1's bn bias); a dropped image cotangent moves stage
    # 0's leaves by far more (below).
    scale = float(want.abs().max())
    assert scale > 0, k
    assert float((got - want).abs().max()) <= 1e-4 * scale, k
  # Stage 0 learns through stage 1's image: without the image cotangent
  # (the slice-apply of stage 0's kind in stage 1) its gradients are not
  # these.
  monkeypatch.setattr(models.load('HDRNetFeaturesPyrNN3'), 'slice_apply',
                      plain.slice_apply)
  dropped = _reference_grads(sd, low, full, target)
  gaps = [float((dropped[k] - w).abs().max()) / float(w.abs().max())
          for k, w in grads.items() if k.startswith('stage0.')]
  assert min(gaps) > 1e-2, min(gaps)
  assert all(torch.equal(dropped[k], w) for k, w in grads.items()
             if k.startswith('stage1.'))


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
  # One stage's backbone at 256^2, sb 16, gd 8, cm 1 (as
  # portbench/tests/test_portbench_counts.py counts it): splat
  # 3->8->16->32->64; global convs 64->64 at 8^2 and 4^2; FCs
  # 1024->256->128->64; local convs 64->64 at 16^2; the 1x1 to 96.
  splat = (128**2 * 9 * 3 * 8 + 64**2 * 9 * 8 * 16 + 32**2 * 9 * 16 * 32
           + 16**2 * 9 * 32 * 64)
  glob = 8**2 * 9 * 64 * 64 + 4**2 * 9 * 64 * 64
  fc = 1024 * 256 + 256 * 128 + 128 * 64
  local = 2 * 16**2 * 9 * 64 * 64
  pred = 16**2 * 64 * 96
  backbone = 2 * (splat + glob + fc + local + pred)
  assert counts.backbone_ops(MODEL) == backbone
  # A step of one 16^2 image: two stages of a backbone and (NN guide
  # 9 x 16 + 4, slice-apply 271) a pixel, the loss 9 a pixel; backward
  # twice the forward.
  forward = 2 * (backbone + 256 * (148 + 271)) + 9 * 256
  assert counts.train_step_ops(MODEL, 16) == 3 * forward
  # ~11.2 GFLOP at 2048^2.
  assert counts.train_step_ops(MODEL, 2048) == pytest.approx(11.16e9,
                                                             rel=1e-3)
  # Slice-apply bounds at 2048^2: K3 and K5 a stage; K4 d_guide only in
  # stage 0 (8 floats a pixel), d_guide and d_image in stage 1 (11).
  n = 2048
  px, grid, padded = n * n, 16 * 16 * 8 * 12 * 4, (n + 2 * 64) ** 2
  k3 = max((grid + px * 7 * 4) / 3.35e12, px * 271 / 67e12)
  k4 = max((grid + px * 8 * 4) / 3.35e12, px * 290 / 67e12)
  k4_image = max((grid + px * 11 * 4) / 3.35e12, px * 308 / 67e12)
  k5 = max((grid + px * 7 * 4) / 3.35e12, padded * 234 / 67e12)
  total = 2 * k3 + k4 + k4_image + 2 * k5
  assert counts.slice_apply_bound_s(MODEL, n) == pytest.approx(total)
  assert total == pytest.approx(0.236e-3, rel=2e-3)


def _tiny_run():
  return harness.run_cell(CELL, SEED, 1.0, 0, 'cpu', model=TINY_MODEL,
                          traffic=TINY_TRAFFIC)


def test_cell_run_is_correct():
  _, out, line = _tiny_run()
  assert out.correct, line['checks']
  assert line['failed'] == 0 and line['attempted'] > 0
  assert set(line['metrics']) == {'train_steps_per_s', 'peak_mem_gib',
                                  'setup_s'}


def test_cell_run_without_the_image_cotangent_fails(monkeypatch):
  """K4 with stage 1's image cotangent zeroed (the only K4 of the step
  asked for one): stage 0 learns through stage 1's guide and preview
  alone, and its first gradients fail ``grad_gap``."""
  whole = sa.slice_apply_pix_bwd
  zeroed = []

  def dropped(*args, **kwargs):
    d_guide, d_image = whole(*args, **kwargs)
    if d_image is not None:
      zeroed.append(1)
      d_image = torch.zeros_like(d_image)
    return d_guide, d_image
  monkeypatch.setattr(sa, 'slice_apply_pix_bwd', dropped)
  _, out, line = _tiny_run()
  assert zeroed
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
