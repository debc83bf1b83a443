"""The hand-written CUDA kernels vs their plain PyTorch versions.

Marked ``gpu``: they need a CUDA device and skip without one. Run them on
the card with ``python -m pytest -m gpu tests/test_torch_cuda.py``. The
card is looked for inside a fixture, never at import or collection time,
so every pytest-xdist worker collects the same tests.

K2 (preview downsample) must be bit-exact. K1 and K6 (fused curves or NN
guide + slice + apply) must agree to 1e-4 at float32 (another order of
float32 sums, and FMA contraction in the kernel) and, for uint8 output,
to 1 code on fewer than 1% of values. K3 (slice-apply) and K4's input
cotangent agree to 1e-4; K4's guide cotangent, which carries a factor
gd, to 1e-4 of its largest value; K5's grid cotangent, a sum over
thousands of pixels, to 2e-4 of its largest value (the JAX package's
gate for its own splat kernel), and K5 gives the same bits on every run.
"""

import numpy as np
import pytest
import torch

from hdrnet_torch.inference import Enhancer, ModelConfig
from hdrnet_torch.ops import downsample, fused, slice_apply, slice_ops

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


def _nn_inputs(seed, b, h, w, gc, dev, u8):
  """A backbone-like grid, a frame, and packed NN-guide parameters whose
  guide spreads over (0, 1)."""
  grid, frame, _ = _inputs(seed, b, h, w, dev, u8)
  rng = np.random.RandomState(seed + 100)
  w1_ext = rng.randn(4, gc) * 0.8
  w2_ext = rng.randn(gc + 1) * 0.8
  params = fused.pack_nn_params(torch.tensor(w1_ext), torch.tensor(w2_ext))
  return grid, frame, params.to(dev)


@pytest.mark.parametrize('gc', [4, 16])
@pytest.mark.parametrize('b', [1, 2])
@pytest.mark.parametrize('u8_in,u8_out,clip', [
    (False, False, False), (False, False, True), (True, True, True),
    (True, False, False)])
def test_fused_nn_kernel(cuda, gc, b, u8_in, u8_out, clip):
  """K6: f32 clip off and on, u8 -> u8, u8 -> f32, at 101x60."""
  grid, frame, params = _nn_inputs(5, b, 101, 60, gc, cuda, u8_in)
  counts = (fused.launches, fused.nn_launches)
  got = fused.enhance_fused(grid, frame, params, 'nn', clip_output=clip,
                            u8_output=u8_out)
  assert (fused.launches, fused.nn_launches) == (counts[0], counts[1] + 1)
  want = fused.enhance_fused_plain(grid, frame, params, 'nn',
                                   clip_output=clip, u8_output=u8_out)
  torch.cuda.synchronize()
  assert got.shape == frame.shape and got.dtype == want.dtype
  if u8_out:
    diff = (got.int() - want.int()).cpu().numpy()
    assert np.abs(diff).max() <= 1
    assert (diff != 0).mean() < 0.01
  else:
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def test_fused_nn_kernel_identity_grid(cuda):
  _, frame, params = _nn_inputs(6, 1, 135, 241, 16, cuda, u8=False)
  grid = torch.zeros((1, 16, 16, 8, 12), device=cuda)
  for i in range(3):
    grid[..., i * 4 + i] = 1.0
  got = fused.enhance_fused(grid, frame, params, 'nn')
  torch.testing.assert_close(got, frame, rtol=0, atol=2e-4)


def test_fused_nn_kernel_checks_its_arguments(cuda):
  grid, frame, params = _nn_inputs(7, 1, 32, 48, 16, cuda, u8=False)
  too_wide = torch.zeros(5 * (fused.MAX_GUIDE_COMPLEXITY + 1) + 1,
                         device=cuda)
  with pytest.raises(ValueError, match='complexity'):
    fused.enhance_fused(grid, frame, too_wide, 'nn')
  with pytest.raises(ValueError, match='gc'):
    fused.enhance_fused(grid, frame, params[:-2], 'nn')
  with pytest.raises(ValueError, match='devices'):
    fused.enhance_fused(grid, frame, params.cpu(), 'nn')
  with pytest.raises(ValueError, match='contiguous'):
    fused.enhance_fused(grid, frame.transpose(1, 2), params, 'nn')


def test_resize_bilinear_gradient_is_deterministic(cuda):
  """The pyramid's upsample backward gathers in a fixed order: the same
  bits on every run (index_select's scatter-add would not give them)."""
  from hdrnet_torch.ops import resize
  x = torch.rand((1, 540, 960, 3), device=cuda, requires_grad=True)
  probe = torch.randn((1, 1080, 1920, 3), device=cuda)
  grads = []
  for _ in range(3):
    out = resize.resize_bilinear(x, (1080, 1920), align_corners=True)
    grads.append(torch.autograd.grad((out * probe).sum(), x)[0])
  assert torch.equal(grads[0], grads[1]) and torch.equal(grads[0], grads[2])
  x64 = x.detach().cpu().double().requires_grad_()
  out = resize.resize_bilinear(x64, (1080, 1920), align_corners=True)
  want = torch.autograd.grad((out * probe.cpu().double()).sum(), x64)[0]
  torch.testing.assert_close(grads[0].cpu().double(), want, rtol=0,
                             atol=1e-4)


@pytest.mark.parametrize('name', ['HDRNetPointwiseNNGuide',
                                  'HDRNetGaussianPyrNN'])
def test_nn_serving_matches_cpu(cuda, name):
  """process and stream of the NN-guide models on the card (K2, K6, and
  for the pyramid the torch levels and upsample-add) against the same
  seeded model on the CPU."""
  cfg = ModelConfig(model_name=name)
  on_card = Enhancer(cfg, device=cuda, seed=4)
  on_cpu = Enhancer(cfg, device='cpu', seed=4)
  rng = np.random.RandomState(6)
  frame = torch.from_numpy(rng.rand(2, 301, 533, 3).astype(np.float32))
  counts = (downsample.launches, fused.nn_launches)
  got = on_card.process(frame.to(cuda)).cpu()
  k6 = 3 if name == 'HDRNetGaussianPyrNN' else 1
  assert (downsample.launches, fused.nn_launches) == (counts[0] + 1,
                                                      counts[1] + k6)
  torch.testing.assert_close(got, on_cpu.process(frame), rtol=0, atol=1e-4)
  frames = [(rng.rand(1, 301, 533, 3) * 255).astype(np.uint8)
            for _ in range(2)]
  for a, b in zip(on_card.stream(frames), on_cpu.stream(frames)):
    diff = a.astype(int) - b.astype(int)
    assert np.abs(diff).max() <= 1 and (diff != 0).mean() < 0.01


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


def _train_inputs(seed, b, h, w, n_in, dev, gh=16, gw=16, gd=8, n_out=3):
  """Grid, guide (with exact 0 and 1 and a band outside [0, 1]), image,
  cotangent."""
  rng = np.random.RandomState(seed)
  c = n_out * (n_in + 1)
  grid = rng.randn(b, gh, gw, gd, c).astype(np.float32)
  guide = (rng.rand(b, h, w) * 1.2 - 0.1).astype(np.float32)
  guide[0, :2] = 0.0
  guide[0, 2:4] = 1.0
  image = rng.rand(b, h, w, n_in).astype(np.float32)
  ct = rng.randn(b, h, w, n_out).astype(np.float32)
  return [torch.from_numpy(a).to(dev) for a in (grid, guide, image, ct)]


def _scaled_close(got, want, rel):
  scale = max(1.0, float(want.abs().max()))
  torch.testing.assert_close(got, want, rtol=0, atol=rel * scale)


TRAIN_SHAPES = [(2, 101, 60, 16, 16, 8), (2, 37, 1031, 10, 6, 8),
                (1, 270, 481, 32, 32, 16)]


@pytest.mark.parametrize('n_in', [0, 3])
@pytest.mark.parametrize('shape', TRAIN_SHAPES)
def test_slice_apply_kernels_match_plain(cuda, shape, n_in):
  b, h, w, gh, gw, gd = shape
  n_out = 5 if n_in == 0 else 3
  grid, guide, image, ct = _train_inputs(6, b, h, w, n_in, cuda, gh, gw, gd,
                                         n_out)
  counts = (slice_apply.fwd_launches, slice_apply.pix_bwd_launches,
            slice_apply.grid_bwd_launches)
  out = slice_apply.slice_apply_fwd(grid, guide, image)
  d_guide, d_image = slice_apply.slice_apply_pix_bwd(grid, guide, image, ct)
  d_grid = slice_apply.slice_apply_grid_bwd(grid.shape, guide, image, ct)
  again = slice_apply.slice_apply_grid_bwd(grid.shape, guide, image, ct)
  torch.cuda.synchronize()
  assert (slice_apply.fwd_launches, slice_apply.pix_bwd_launches,
          slice_apply.grid_bwd_launches) == (counts[0] + 1, counts[1] + 1,
                                             counts[2] + 2)
  torch.testing.assert_close(
      out, slice_apply.slice_apply_fwd_plain(grid, guide, image), rtol=0,
      atol=1e-4)
  want_dg, want_di = slice_apply.slice_apply_pix_bwd_plain(grid, guide,
                                                           image, ct)
  _scaled_close(d_guide, want_dg, 1e-4)
  torch.testing.assert_close(d_image, want_di, rtol=0, atol=1e-4)
  _scaled_close(d_grid, slice_apply.slice_apply_grid_bwd_plain(
      grid.shape, guide, image, ct), 2e-4)
  assert torch.equal(d_grid, again)  # deterministic: no float atomics


def test_slice_apply_op_grads_on_card_match_cpu(cuda):
  """The autograd op on the card (K3, K4, K5) against the same op on the
  CPU (the plain versions), for all three inputs and the plain slice."""
  grid, guide, image, ct = _train_inputs(7, 2, 67, 90, 3, 'cpu', 5, 7, 8)
  grid = grid.reshape(2, 5, 7, 8, 3, 4)

  def grads(dev):
    args = [t.to(dev).requires_grad_() for t in (grid, guide, image)]
    out = slice_ops.bilateral_slice_apply(*args)
    g = torch.autograd.grad((out * ct.to(dev)).sum(), args)
    s_args = [t.to(dev).requires_grad_() for t in (grid[..., 0], guide)]
    sl = slice_ops.bilateral_slice(*s_args)
    g += torch.autograd.grad((sl * ct.to(dev)).sum(), s_args)
    return [x.cpu() for x in (out,) + g]

  for got, want in zip(grads(cuda), grads('cpu')):
    _scaled_close(got, want, 2e-4)


def test_slice_apply_wrappers_reject_bad_cuda_inputs(cuda):
  grid, guide, image, ct = _train_inputs(8, 1, 20, 30, 3, cuda)
  with pytest.raises(ValueError, match='contiguous'):
    slice_apply.slice_apply_fwd(grid, guide.transpose(1, 2).contiguous()
                                .transpose(1, 2), image)
  with pytest.raises(TypeError, match='float32'):
    slice_apply.slice_apply_fwd(grid.double(), guide.double(), image.double())
  with pytest.raises(ValueError, match='devices'):
    slice_apply.slice_apply_pix_bwd(grid, guide, image, ct.cpu())


def test_train_step_on_card_matches_cpu(cuda):
  """One Adam step of a small HDRNetCurves (guide_reg on) on the card
  (K3, K4, K5, full-float32 cuDNN) against the same step on the CPU:
  loss to 1e-5 relative, each gradient to 1e-4 of its leaf's max."""
  from hdrnet_torch.config import ModelConfig, TrainConfig
  from hdrnet_torch.models import make_model
  from hdrnet_torch.training import loop, step
  cfg = ModelConfig(net_input_size=64, spatial_bin=8, luma_bins=4)
  tc = TrainConfig(learning_rate=1e-3, guide_lr_scale=0.5)
  rng = np.random.RandomState(9)
  batch = {'lowres_input': rng.randint(0, 256, (2, 64, 64, 3)),
           'image_input': rng.randint(0, 256, (2, 96, 130, 3)),
           'image_output': rng.randint(0, 256, (2, 96, 130, 3))}
  batch = {k: v.astype(np.uint8) for k, v in batch.items()}
  runs = []
  for dev in (cuda, torch.device('cpu')):
    model = make_model(cfg, generator=torch.Generator().manual_seed(4))
    model = model.to(dev)
    state = step.create_state(model, loop.make_optimizer(model, tc))
    counts = slice_apply.fwd_launches
    state, m = step.make_train_step(guide_reg=0.5)(
        state, step.to_device(batch, dev))
    assert slice_apply.fwd_launches == counts + (dev.type == 'cuda')
    runs.append((float(m['loss']),
                 [p.grad.cpu() for p in model.parameters()]))
  (loss_card, g_card), (loss_cpu, g_cpu) = runs
  np.testing.assert_allclose(loss_card, loss_cpu, rtol=1e-5)
  for a, b in zip(g_card, g_cpu):
    torch.testing.assert_close(a, b, rtol=0,
                               atol=1e-4 * float(b.abs().max()))
