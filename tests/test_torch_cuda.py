"""The hand-written CUDA kernels vs their plain PyTorch versions.

Marked ``gpu``: they need a CUDA device and skip without one. Run them on
the card with ``python -m pytest -m gpu tests/test_torch_cuda.py``. The
card is looked for inside a fixture, never at import or collection time,
so every pytest-xdist worker collects the same tests.

K2 (preview downsample) must be bit-exact. K1 (fused guide + slice +
apply) must agree to 1e-4 at float32 (another order of float32 sums,
and FMA contraction in the kernel) and, for uint8 output, to 1 code on
fewer than 1% of values.
"""

import numpy as np
import pytest
import torch

from hdrnet_torch.inference import Enhancer, ModelConfig
from hdrnet_torch.ops import downsample, fused

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA device: run on the card with '
                '`python -m pytest -m gpu tests/test_torch_cuda.py`')
  return torch.device('cuda', 0)


def _params(rng):
  ccm_ext = np.vstack([np.eye(3) + 0.2 * rng.randn(3, 3),
                       0.05 * rng.randn(1, 3)])
  shifts = np.tile(np.arange(16) / 16, (3, 1)) + 0.01 * rng.randn(3, 16)
  slopes = np.abs(rng.randn(3, 16)) * 0.3
  slopes[:, 0] = 1.0
  mix = np.vstack([np.full((3, 1), 1 / 3), [[0.02]]])
  return fused.pack_curves_params(
      torch.tensor(ccm_ext), torch.tensor(np.vstack([shifts, slopes])),
      torch.tensor(mix))


def _inputs(seed, b, h, w, dev, u8, gh=16, gw=16, gd=8):
  rng = np.random.RandomState(seed)
  grid = 0.5 * rng.randn(b, gh, gw, gd, 12)
  for i in range(3):
    grid[..., i * 4 + i] += 1.0
  if u8:
    frame = torch.from_numpy(rng.randint(0, 256, (b, h, w, 3)).astype(
        np.uint8))
  else:
    frame = torch.from_numpy(rng.rand(b, h, w, 3).astype(np.float32))
  grid = torch.from_numpy(grid.astype(np.float32))
  return grid.to(dev), frame.to(dev), _params(rng).to(dev)


@pytest.mark.parametrize('u8', [False, True])
@pytest.mark.parametrize('shape', [(2, 101, 61, 16), (1, 1080, 1920, 256),
                                   (2, 257, 383, 64)])
def test_downsample_kernel_bit_exact(cuda, shape, u8):
  b, h, w, s = shape
  rng = np.random.RandomState(0)
  if u8:
    x = torch.from_numpy(rng.randint(0, 256, (b, h, w, 3)).astype(np.uint8))
  else:
    x = torch.from_numpy(rng.rand(b, h, w, 3).astype(np.float32))
  x = x.to(cuda)
  before = downsample.launches
  got = downsample.nearest_lowres(x, s)
  assert downsample.launches == before + 1
  want = downsample.nearest_lowres_plain(x, s)
  torch.cuda.synchronize()
  assert got.shape == (b, 3, s, s) and got.dtype == torch.float32
  assert torch.equal(got, want)


@pytest.mark.parametrize('clip', [False, True])
@pytest.mark.parametrize('shape,grid_shape', [
    ((2, 101, 60), (16, 16, 8)), ((1, 37, 1031), (16, 16, 8)),
    ((1, 270, 481), (32, 32, 16)), ((2, 101, 60), (10, 6, 8))])
def test_fused_kernel_f32(cuda, shape, grid_shape, clip):
  grid, frame, params = _inputs(1, *shape, cuda, u8=False, gh=grid_shape[0],
                                gw=grid_shape[1], gd=grid_shape[2])
  before = fused.launches
  got = fused.enhance_fused(grid, frame, params, clip_output=clip)
  assert fused.launches == before + 1
  want = fused.enhance_fused_plain(grid, frame, params, clip_output=clip)
  torch.cuda.synchronize()
  assert got.shape == frame.shape and got.dtype == torch.float32
  torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize('shape', [(2, 101, 60), (2, 270, 481)])
def test_fused_kernel_u8(cuda, shape):
  grid, frame, params = _inputs(2, *shape, cuda, u8=True)
  got = fused.enhance_fused(grid, frame, params, clip_output=True,
                            u8_output=True)
  want = fused.enhance_fused_plain(grid, frame, params, clip_output=True,
                                   u8_output=True)
  assert got.dtype == torch.uint8
  diff = (got.int() - want.int()).cpu().numpy()
  assert np.abs(diff).max() <= 1
  assert (diff != 0).mean() < 0.01


def test_fused_kernel_identity_grid(cuda):
  """Identity affine: output = input up to the smoothed depth tent's own
  deficit (1 - sqrt(eps) at the bin centre, so at most 1e-4 per unit)."""
  _, frame, params = _inputs(3, 1, 135, 241, cuda, u8=False)
  grid = torch.zeros((1, 16, 16, 8, 12), device=cuda)
  for i in range(3):
    grid[..., i * 4 + i] = 1.0
  got = fused.enhance_fused(grid, frame, params)
  torch.testing.assert_close(got, frame, rtol=0, atol=2e-4)


def test_wrappers_reject_bad_cuda_inputs(cuda):
  grid, frame, params = _inputs(4, 1, 32, 48, cuda, u8=False)
  with pytest.raises(ValueError, match='contiguous'):
    fused.enhance_fused(grid, frame.transpose(1, 2), params)
  with pytest.raises(ValueError, match='devices'):
    fused.enhance_fused(grid, frame.cpu(), params)
  with pytest.raises(ValueError, match='contiguous'):
    downsample.nearest_lowres(frame.transpose(1, 2), 8)


def test_serving_matches_cpu(cuda):
  """The whole serving chain on the card (K2, full-float32 backbone, K1)
  against the same seeded model on the CPU (plain versions). With TF32 on,
  the backbone alone would miss 1e-4."""
  cfg = ModelConfig()
  on_card = Enhancer(cfg, device=cuda, seed=3)
  on_cpu = Enhancer(cfg, device='cpu', seed=3)
  rng = np.random.RandomState(5)
  frame = torch.from_numpy(rng.rand(2, 300, 533, 3).astype(np.float32))
  low = downsample.nearest_lowres_plain(frame, 256)
  torch.testing.assert_close(on_card._backbone_grid(low.to(cuda)).cpu(),
                             on_cpu._backbone_grid(low), rtol=0, atol=1e-4)
  got = on_card.process(frame.to(cuda)).cpu()
  torch.testing.assert_close(got, on_cpu.process(frame), rtol=0, atol=1e-4)
  frames = [(rng.rand(1, 300, 533, 3) * 255).astype(np.uint8)
            for _ in range(3)]
  for a, b in zip(on_card.stream(frames), on_cpu.stream(frames)):
    diff = a.astype(int) - b.astype(int)
    assert np.abs(diff).max() <= 1 and (diff != 0).mean() < 0.01
