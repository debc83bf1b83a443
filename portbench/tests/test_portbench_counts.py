"""The frozen counts against hand counts at one small shape."""

import json
from pathlib import Path

import pytest

from portbench import counts

HERE = Path(__file__).resolve().parents[1]
CURVES = json.loads((HERE / 'configs' / 'hdrnet-curves.json').read_text())[
    'model']
PYR = json.loads((HERE / 'configs' / 'hdrnet-gpyrnn.json').read_text())[
    'model']


def test_bound_is_the_larger_of_bytes_and_operations():
  assert counts.bound_s(3.35e12, 0) == pytest.approx(1.0)
  assert counts.bound_s(0, 67e12) == pytest.approx(1.0)
  assert counts.bound_s(3.35e12, 2 * 67e12) == pytest.approx(2.0)


def test_backbone_ops_by_hand():
  # 256^2 preview, sb 16, gd 8, cm 1: four stride-2 3x3 splat convs
  # 3->8->16->32->64 to 128, 64, 32, 16; global convs 64->64 at 8^2 and
  # 4^2; FCs 1024->256->128->64; local convs 64->64 at 16^2; 1x1 to
  # 8 * 3 * 4 = 96 channels.
  splat = (128**2 * 9 * 3 * 8 + 64**2 * 9 * 8 * 16 + 32**2 * 9 * 16 * 32
           + 16**2 * 9 * 32 * 64)
  glob = 8**2 * 9 * 64 * 64 + 4**2 * 9 * 64 * 64
  fc = 1024 * 256 + 256 * 128 + 128 * 64
  local = 2 * 16**2 * 9 * 64 * 64
  pred = 16**2 * 64 * 96
  assert counts.backbone_ops(CURVES) == 2 * (splat + glob + fc + local + pred)
  # The pyramid's prediction has 3 x 3 outputs: 288 channels.
  assert counts.backbone_ops(PYR) - counts.backbone_ops(CURVES) == (
      2 * 16**2 * 64 * (288 - 96))


def test_serving_frame_by_hand():
  h, w = 8, 12
  px = h * w
  assert counts.serve_frame_ops(CURVES, h, w) == (
      counts.backbone_ops(CURVES) + px * (219 + 271))
  nn = 9 * 16 + 4
  guide_slice = (nn + 271) * (px + px // 4 + px // 16)
  down = 3 * 3 * (4 * 12 + 4 * 6) + 3 * 3 * (2 * 6 + 2 * 3)
  up = (3 * 3 * (8 * 6 + 8 * 12) + 3 * px
        + 3 * 3 * (4 * 3 + 4 * 6) + 3 * px // 4)
  assert counts.serve_frame_ops(PYR, h, w) == (
      counts.backbone_ops(PYR) + guide_slice + down + up + 9 * px)


def test_training_step_is_three_forwards():
  fwd = counts.backbone_ops(CURVES) + 16 * 16 * (219 + 271) + 9 * 256
  assert counts.train_step_ops(CURVES, 16) == 3 * fwd


def test_fused_bound_4k_u8_is_operations():
  # K1 on a 4K uint8 frame: 8,294,400 pixels x 490 operations.
  got = counts.fused_bound_s(CURVES, 2160, 3840)
  assert got == pytest.approx(2160 * 3840 * 490 / 67e12)


def test_slice_apply_bound_by_hand():
  n = 64
  px, grid = n * n, 16 * 16 * 8 * 12 * 4
  padded = (n + 2 * 2) ** 2
  k3 = max((grid + px * 7 * 4) / 3.35e12, px * 271 / 67e12)
  k4 = max((grid + px * 8 * 4) / 3.35e12, px * 290 / 67e12)
  k5 = max((grid + px * 7 * 4) / 3.35e12, padded * 234 / 67e12)
  assert counts.slice_apply_bound_s(CURVES, n) == pytest.approx(k3 + k4 + k5)


def test_a_family_file_sets_or_replaces_the_counts(monkeypatch):
  """A family's constants drive the composition; a function of the same
  name in its file replaces that part of it."""
  import sys
  import types
  from portbench.models import HDRNetCurves
  fam = types.ModuleType('portbench.models.TwoLevels')
  fam.LEVELS, fam.FUSED_U8 = 2, False
  fam.guide_ops = HDRNetCurves.guide_ops
  fam.guide_params = HDRNetCurves.guide_params
  monkeypatch.setitem(sys.modules, 'portbench.models.TwoLevels', fam)
  model = {**CURVES, 'model_name': 'TwoLevels'}
  assert counts.levels(model, 8, 12) == [(8, 12), (4, 6)]
  assert counts.backbone_ops(model) - counts.backbone_ops(CURVES) == (
      2 * 16**2 * 64 * (192 - 96))
  fam.backbone_ops = lambda m: 7
  assert counts.backbone_ops(model) == 7
  assert counts.serve_frame_ops(model, 8, 12) == 7 + (
      (219 + 271) * (96 + 24) + 3 * 3 * (4 * 12 + 4 * 6)
      + 3 * 3 * (8 * 6 + 8 * 12) + 3 * 96 + 9 * 96)
