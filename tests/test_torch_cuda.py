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


def _frame(dev, shape, u8, seed=0):
  """A seeded (B, H, W, C) frame on the card, f32 or u8."""
  gen = torch.Generator(device=dev).manual_seed(seed)
  if u8:
    return torch.randint(0, 256, shape, generator=gen, device=dev,
                         dtype=torch.uint8)
  return torch.rand(shape, generator=gen, device=dev)


@pytest.mark.parametrize('u8', [False, True])
@pytest.mark.parametrize('shape', [
    (2, 101, 61, 3, 16), (1, 1080, 1920, 3, 256), (2, 257, 383, 3, 64),
    (2, 101, 61, 1, 16), (2, 101, 61, 4, 16),  # C = 1 and C = 4
    (1, 20, 30, 3, 64),  # s > H and s > W: rows and columns repeat
    (1, 135, 241, 3, 64),  # rows of 241 x 3 values: not 16-byte aligned
    (1, 4320, 7680, 3, 256), (4, 2160, 3840, 3, 256)])  # 8K b=1, 4K b=4
def test_downsample_kernel_bit_exact(cuda, shape, u8):
  b, h, w, c, s = shape
  x = _frame(cuda, (b, h, w, c), u8)
  before = downsample.launches
  got = downsample.nearest_lowres(x, s)
  assert downsample.launches == before + 1
  want = downsample.nearest_lowres_plain(x, s)
  torch.cuda.synchronize()
  assert got.shape == (b, c, s, s) and got.dtype == torch.float32
  assert torch.equal(got, want)


def test_downsample_kernel_past_32_bit_index(cuda):
  """A frame of 2^31 values or more takes K2's 64-bit offsets: 24576 x
  32768 x 3 uint8 (2.4 G values a frame) at b=2, bit for bit its plain
  version."""
  x = torch.empty((2, 24576, 32768, 3), dtype=torch.uint8, device=cuda)
  x[0].random_(0, 256, generator=torch.Generator(cuda).manual_seed(3))
  x[1] = x[0].flip(0)
  got = downsample.nearest_lowres(x, 256)
  want = downsample.nearest_lowres_plain(x, 256)
  torch.cuda.synchronize()
  assert torch.equal(got, want)
  assert not torch.equal(got[0], got[1])


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
# K5 cuts the padded frame into regions between cell centres and each
# region into row strips: a 14 x 25 grid over 203 x 317 pixels gives
# regions of 14-15 rows by 12-13 columns, split unevenly.
ODD_STRIPS_SHAPE = (3, 203, 317, 14, 25, 5)
# K3/K4 stage the cells a 16 x 64 tile reaches in shared memory; a
# 128 x 128 x 8 grid over 20 x 70 pixels reaches about 4.5 MB of them, so
# the corners are read from device memory instead (70 columns: a ragged
# 4-pixel group at each row's end).
GLOBAL_WINDOW_SHAPE = (1, 20, 70, 128, 128, 8)


@pytest.mark.parametrize('n_in', [0, 3, 8])
@pytest.mark.parametrize('shape', TRAIN_SHAPES + [ODD_STRIPS_SHAPE,
                                                  GLOBAL_WINDOW_SHAPE])
def test_slice_apply_kernels_match_plain(cuda, shape, n_in):
  """K3, K4 and K5 against their plain versions, with n_in 8 (K3/K4's
  looped path, K5's C = 27) beside 3 and 0; K5 twice gives the same
  bits."""
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


def _unaligned(t):
  """The same values one element into a larger buffer: contiguous, not
  16-byte aligned."""
  buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
  buf[1:] = t.reshape(-1)
  return buf[1:].view(t.shape)


@pytest.mark.parametrize('w', [60, 61, 62, 70])
@pytest.mark.parametrize('n_in', [0, 3])
def test_slice_apply_kernels_vector_and_scalar_paths(cuda, w, n_in):
  """K3 and K4 on 4-pixel groups: widths that are not a multiple of 4
  (scalar loads and stores at each row's end) and inputs that are not
  16-byte aligned (scalar throughout) give the same bits as the aligned
  call and agree with the plain versions; without the input's
  cotangent K4 returns None and the same d_guide bits; a grid that is
  not aligned runs the generic kernels, within the same limits; two runs
  give the same bits."""
  n_out = 12 if n_in == 0 else 3
  grid, guide, image, ct = _train_inputs(9, 2, 37, w, n_in, cuda, 16, 16, 8,
                                         n_out)
  out = slice_apply.slice_apply_fwd(grid, guide, image)
  d_guide, d_image = slice_apply.slice_apply_pix_bwd(grid, guide, image, ct)
  dg_only, none = slice_apply.slice_apply_pix_bwd(grid, guide, image, ct,
                                                  need_input=False)
  assert none is None and torch.equal(dg_only, d_guide)
  assert torch.equal(slice_apply.slice_apply_fwd(grid, guide, image), out)
  again = slice_apply.slice_apply_pix_bwd(grid, guide, image, ct)
  assert torch.equal(again[0], d_guide) and torch.equal(again[1], d_image)
  u_guide, u_image, u_ct = map(_unaligned, (guide, image, ct))
  assert torch.equal(slice_apply.slice_apply_fwd(grid, u_guide, u_image), out)
  u_dg, u_di = slice_apply.slice_apply_pix_bwd(grid, u_guide, u_image, u_ct)
  assert torch.equal(u_dg, d_guide) and torch.equal(u_di, d_image)
  want = slice_apply.slice_apply_fwd_plain(grid, guide, image)
  want_dg, want_di = slice_apply.slice_apply_pix_bwd_plain(grid, guide,
                                                           image, ct)
  u_grid = _unaligned(grid)
  for got, got_dg, got_di in (
      (out, d_guide, d_image),
      (slice_apply.slice_apply_fwd(u_grid, guide, image),
       *slice_apply.slice_apply_pix_bwd(u_grid, guide, image, ct))):
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    _scaled_close(got_dg, want_dg, 1e-4)
    torch.testing.assert_close(got_di, want_di, rtol=0, atol=1e-4)


def test_slice_apply_kernels_past_32_bit_index(cuda):
  """A 24576 x 32768 frame of 3 channels (2.4e9 values an image, f32) runs
  in H-bands inside the launchers, since K3 and K4 index an image in 32
  bits: rows at the frame's start, across the first band's end and at
  its end agree with the plain versions of those rows at their offset
  (about 23 GB for K3, 35 GB for K4 with the input's cotangent)."""
  from hdrnet_torch.ops import reference as ref
  h, w = 24576, 32768
  gen = torch.Generator(device=cuda).manual_seed(15)
  grid = torch.randn((1, 16, 16, 8, 12), generator=gen, device=cuda)
  guide = torch.rand((1, h, w), generator=gen, device=cuda)
  image = torch.rand((1, h, w, 3), generator=gen, device=cuda)
  grid6 = grid.reshape(1, 16, 16, 8, 3, 4)
  edge = (2**31 - 1) // (3 * w)  # the first band's rows
  spans = ((0, 8), (edge - 8, edge + 8), (h - 8, h))
  out = slice_apply.slice_apply_fwd(grid, guide, image)
  for y0, y1 in spans:
    want = ref.bilateral_slice_apply(grid6, guide[:, y0:y1],
                                     image[:, y0:y1], band=(y0, 0, h, w))
    torch.testing.assert_close(out[:, y0:y1], want, rtol=0, atol=1e-4)
  del out
  ct = torch.randn((1, h, w, 3), generator=gen, device=cuda)
  d_guide, d_image = slice_apply.slice_apply_pix_bwd(grid, guide, image, ct)
  for y0, y1 in spans:
    rows = (slice(None), slice(y0, y1))
    band = (y0, 0, h, w)
    _scaled_close(d_guide[rows], ref.bilateral_slice_apply_guide_vjp(
        grid6, guide[rows], image[rows], ct[rows], band=band), 1e-4)
    torch.testing.assert_close(
        d_image[rows], ref.bilateral_slice_apply_input_vjp(
            grid6, guide[rows], ct[rows], band=band), rtol=0, atol=1e-4)


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


@pytest.mark.parametrize('u8', [False, True])
@pytest.mark.parametrize('shape', [(3, 135, 240, 64), (4, 2160, 3840, 256)])
def test_downsample_kernel_gather_cases(cuda, shape, u8):
  """K2g, the JAX row-gather variant (``tests/test_downsample.py``'s
  batched gather case, b=3 135x240 -> 64) and the batched 4K preview:
  K2's kernel, one launch, bit-exact."""
  b, h, w, s = shape
  x = _frame(cuda, (b, h, w, 3), u8, seed=2)
  before = downsample.launches
  got = downsample.nearest_lowres(x, s)
  assert downsample.launches == before + 1
  assert torch.equal(got, downsample.nearest_lowres_plain(x, s))


@pytest.mark.parametrize('mode', ['curves', 'nn'])
@pytest.mark.parametrize('u8', [False, True])
def test_fused_kernel_bands(cuda, mode, u8):
  """K7: H-bands and a column band of an odd-sized frame against the
  plain version with the same offsets (1e-4; u8 1 code on < 1%), and the
  bands concatenated equal to the whole-frame kernel bit for bit."""
  if mode == 'nn':
    grid, frame, params = _nn_inputs(9, 2, 203, 311, 16, cuda, u8)
  else:
    grid, frame, params = _inputs(9, 2, 203, 311, cuda, u8)
  kw = dict(clip_output=True, u8_output=u8)
  whole = fused.enhance_fused(grid, frame, params, mode, **kw)
  counts = fused.band_launches
  bands = []
  for y0, y1 in ((0, 51), (51, 102), (102, 150), (150, 203)):
    band = frame[:, y0:y1].contiguous()
    got = fused.enhance_fused(grid, band, params, mode, y_offset=y0,
                              h_total=203, **kw)
    want = fused.enhance_fused_plain(grid, band, params, mode, y_offset=y0,
                                     h_total=203, **kw)
    if u8:
      diff = (got.int() - want.int()).cpu().numpy()
      assert np.abs(diff).max() <= 1 and (diff != 0).mean() < 0.01
    else:
      torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    bands.append(got)
  assert torch.equal(torch.cat(bands, 1), whole)
  assert fused.band_launches == counts + 4
  tile = frame[:, 40:90, 100:250].contiguous()
  got = fused.enhance_fused(grid, tile, params, mode, y_offset=40,
                            x_offset=100, h_total=203, w_total=311, **kw)
  assert torch.equal(got, whole[:, 40:90, 100:250])
  with pytest.raises(ValueError, match='outside'):
    fused.enhance_fused(grid, tile, params, mode, y_offset=160,
                        h_total=203, **kw)


@pytest.mark.parametrize('name', ['HDRNetCurves', 'HDRNetPointwiseNNGuide',
                                  'HDRNetGaussianPyrNN'])
def test_enhance_sharded_on_card(cuda, name):
  """Four bands on one card: bit-identical to the unsharded path, one K1
  or K6 a band (three levels of four bands for the pyramid), and within
  1e-4 of the same model on the CPU."""
  cfg = ModelConfig(model_name=name)
  on_card = Enhancer(cfg, device=cuda, seed=6)
  on_cpu = Enhancer(cfg, device='cpu', seed=6)
  rng = np.random.RandomState(8)
  frame = rng.rand(1, 544, 600, 3).astype(np.float32)
  low = downsample.nearest_lowres_plain(torch.from_numpy(frame), 256)
  low = low.permute(0, 2, 3, 1).numpy()
  counts = (fused.launches, fused.nn_launches, fused.band_launches)
  got = on_card.enhance_sharded(low, frame, [cuda] * 4)
  torch.cuda.synchronize()
  k = 12 if name == 'HDRNetGaussianPyrNN' else 4
  curves = name == 'HDRNetCurves'
  assert (fused.launches, fused.nn_launches, fused.band_launches) == (
      counts[0] + k * curves, counts[1] + k * (not curves), counts[2] + k)
  assert torch.equal(got, on_card.enhance_any(low, frame))
  torch.testing.assert_close(got.cpu(), on_cpu.enhance_any(low, frame),
                             rtol=0, atol=1e-4)


def test_evaluate_cli_on_card(cuda, tmp_path, capsys):
  """bin/evaluate.py on its default device: a checkpoint of two steps of
  the port's training on the card, evaluated through the training graph
  (K3) and through the serving path (K1); the PSNRs agree to 1e-5."""
  import json
  from PIL import Image
  from hdrnet_torch.bin import evaluate
  from hdrnet_torch.config import Config, DataConfig, TrainConfig
  from hdrnet_torch.training.loop import train
  data = tmp_path / 'data'
  rng = np.random.RandomState(0)
  names = []
  for sub in ('input', 'output'):
    (data / sub).mkdir(parents=True)
  for i in range(3):
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
  ckpt = tmp_path / 'ckpt'
  train(cfg, str(ckpt), str(data))
  results = {}
  for serving in (False, True):
    counts = (slice_apply.fwd_launches, fused.launches)
    evaluate.main([str(ckpt), str(data)] + ['--serving'] * serving)
    results[serving] = json.loads(
        capsys.readouterr().out.strip().splitlines()[-1])
    moved = (slice_apply.fwd_launches - counts[0], fused.launches - counts[1])
    assert moved == ((0, 3) if serving else (3, 0))
  assert results[False]['n_images'] == results[True]['n_images'] == 3
  assert np.isfinite(results[False]['mean_psnr_db'])
  np.testing.assert_allclose(results[True]['mean_psnr_db'],
                             results[False]['mean_psnr_db'], rtol=1e-5)


@pytest.mark.parametrize('rows', ['gather', 'mma'])
@pytest.mark.parametrize('shape,offset', [
    # bulk copies: rows of a multiple of 16 bytes from an aligned frame
    ((1, 2160, 3840, 256), 0), ((4, 2160, 3840, 256), 0),
    ((3, 135, 240, 64), 0), ((2, 101, 60, 32), 0), ((2, 77, 300, 40), 0),
    ((1, 64, 4096, 16), 0),  # W / s = 256: chunks that no output samples
    ((1, 2048, 64, 16), 0),  # H / s = 128: v2's slabs span 15 stages
    ((1, 8, 270000, 16), 0),  # 4219 chunks: past the block's start table
    # plain loads: rows of 7, 61, 301 floats, or a frame 4 bytes off
    ((1, 10, 7, 32), 0), ((2, 101, 61, 32), 0), ((2, 77, 301, 40), 0),
    ((1, 135, 241, 64), 0), ((1, 2160, 3842, 256), 0),
    ((2, 101, 60, 32), 1)])
def test_onehot_downsample_kernel_bit_exact(cuda, shape, offset, rows):
  """K2x in both row modes and both copy routes: bit for bit its plain
  version and K2."""
  b, h, w, s = shape
  gen = torch.Generator(device=cuda).manual_seed(1)
  x = torch.rand(b * 3 * h * w + offset, generator=gen, device=cuda)
  x = x[offset:].view(b, 3, h, w)
  before = downsample.onehot_launches
  got = downsample.nearest_lowres_onehot(x, s, rows)
  assert downsample.onehot_launches == before + 1
  want = downsample.nearest_lowres_onehot_plain(x, s, rows)
  k2 = downsample.nearest_lowres(x.permute(0, 2, 3, 1).contiguous(), s)
  torch.cuda.synchronize()
  assert got.shape == (b, 3, s, s) and got.dtype == torch.float32
  assert torch.equal(got, want)
  assert torch.equal(got, k2)


@pytest.mark.parametrize('kernel', ['K2 f32', 'K2 u8', 'K2x gather',
                                    'K2x mma', 'K2x gather loads',
                                    'K2x mma loads'])
def test_downsample_kernels_replay_in_cuda_graph(cuda, kernel):
  """Each preview kernel captured in a CUDA graph (K2x's launch makes its
  one-time attribute calls before, not under, the capture) and replayed
  on new frame contents: bit for bit the plain version each time."""
  w = 301 if kernel.endswith('loads') else 300
  if kernel.startswith('K2x'):
    rows = kernel.split()[1]
    x = torch.empty((2, 3, 77, w), device=cuda)
    run = lambda: downsample.nearest_lowres_onehot(x, 40, rows)
    plain = lambda: downsample.nearest_lowres_onehot_plain(x, 40, rows)
  else:
    u8 = kernel.endswith('u8')
    x = torch.empty((2, 77, w, 3), device=cuda,
                    dtype=torch.uint8 if u8 else torch.float32)
    run = lambda: downsample.nearest_lowres(x, 40)
    plain = lambda: downsample.nearest_lowres_plain(x, 40)
  gen = torch.Generator(device=cuda).manual_seed(5)

  def refill():
    if x.dtype == torch.uint8:
      x.random_(0, 256, generator=gen)
    else:
      x.uniform_(generator=gen)

  refill()
  run()  # warm-up outside the capture
  torch.cuda.synchronize()
  graph = torch.cuda.CUDAGraph()
  with torch.cuda.graph(graph):
    out = run()
  for _ in range(3):
    refill()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, plain())


def test_onehot_downsample_kernel_checks_its_arguments(cuda):
  x = torch.rand(1, 3, 64, 64, device=cuda)
  with pytest.raises(TypeError):
    downsample.nearest_lowres_onehot(x.to(torch.uint8), 16)
  with pytest.raises(ValueError):
    downsample.nearest_lowres_onehot(x, 16, rows='vpu')
  with pytest.raises(ValueError):
    downsample.nearest_lowres_onehot(x.transpose(2, 3), 16)


def test_registered_ops_run_the_kernels(cuda):
  """The hdrnet:: ops that exported graphs call launch the same kernels
  as the direct wrappers, with the same bits."""
  grid, frame, params = _inputs(2, 1, 101, 61, cuda, False)
  counts = (downsample.launches, fused.launches, slice_apply.fwd_launches)
  want = (downsample.nearest_lowres(frame, 32),
          fused.enhance_fused(grid, frame, params, clip_output=True),
          slice_apply.slice_apply_fwd(grid, frame[..., 0].contiguous(),
                                      frame))
  got = (torch.ops.hdrnet.nearest_lowres(frame, 32),
         torch.ops.hdrnet.enhance_fused(grid, frame, params, 'curves', True,
                                        False, 0, 0, None, None),
         torch.ops.hdrnet.slice_apply_fwd(grid, frame[..., 0].contiguous(),
                                          frame, True))
  torch.cuda.synchronize()
  for g, w in zip(got, want):
    assert torch.equal(g, w)
  assert (downsample.launches, fused.launches,
          slice_apply.fwd_launches) == tuple(c + 2 for c in counts)


@pytest.mark.parametrize('name', ['HDRNetCurves', 'HDRNetGaussianPyrNN'])
def test_export_round_trip_on_card(cuda, name, tmp_path):
  """bin/export.py on the card: each .pt2 reloads, is bit-identical to the
  eager Enhancer and launches the kernels."""
  from hdrnet_torch.bin import export
  from hdrnet_torch.config import Config, TrainConfig
  from hdrnet_torch.training import loop, step
  from hdrnet_torch.training.checkpoint import Checkpointer
  cfg = Config(model=ModelConfig(model_name=name, net_input_size=64,
                                 spatial_bin=8, luma_bins=4,
                                 guide_complexity=4), train=TrainConfig())
  model = Enhancer(cfg.model, device='cpu', seed=3).model
  cfg.save(str(tmp_path))
  Checkpointer(str(tmp_path)).save(0, step.create_state(
      model, loop.make_optimizer(model, cfg.train)))
  export.main([str(tmp_path), '--fullres', '96', '128'])
  enh = Enhancer.from_checkpoint(str(tmp_path), device=cuda)
  rng = np.random.RandomState(4)
  low = torch.from_numpy(rng.rand(1, 64, 64, 3).astype(np.float32)).to(cuda)
  full = torch.from_numpy(rng.rand(1, 96, 128, 3).astype(np.float32)).to(
      cuda)
  full8 = (full * 255).to(torch.uint8)
  for fn_name, args, want in [
      ('serve_fn', (low, full), enh(low, full)),
      ('stream_fn', (full8,), enh.make_stream_fn(full8.shape)(full8)),
      ('serve_any_fn', (low, full[:, :77, :101].contiguous()),
       enh(low, full[:, :77, :101].contiguous()))]:
    fn = export.load_artifact(str(tmp_path / f'{fn_name}.pt2'))
    before = fused.launches + fused.nn_launches
    got = fn(*args)
    torch.cuda.synchronize()
    assert fused.launches + fused.nn_launches > before, fn_name
    assert torch.equal(got, want), fn_name


def test_grid_bwd_plan_sizes_its_scratch(cuda):
  """K5's plan: at least two waves of blocks at every pyramid level (strips
  capped by a region's rows), and a scratch of one partial a block."""
  for n in (2048, 1024, 512, 64):
    guide = torch.zeros((1, n, n), device=cuda)
    strips, floats, smem = slice_apply.grid_bwd_plan((1, 16, 16, 8, 12),
                                                     guide)
    assert 1 <= strips <= max(1, n // 16)
    assert floats == 17 * 17 * strips * 4 * 8 * 12
    assert 0 < smem <= 227 * 1024
  with pytest.raises(ValueError, match='exceed'):
    slice_apply.grid_bwd_plan((1, 4, 4, 8, 300), guide)


@pytest.mark.parametrize('mode', ['curves', 'nn'])
@pytest.mark.parametrize('u8', [False, True])
@pytest.mark.parametrize('w', [61, 62, 63, 64, 67, 130])
def test_fused_kernel_ragged_rows(cuda, mode, u8, w):
  """K1/K6 take 4 pixels a thread on 16 x 64 tiles: widths that are not
  a multiple of 4 (scalar loads and stores) or of 64 (a partial tile),
  and a frame that is not 16-byte aligned, against the plain version."""
  if mode == 'nn':
    grid, frame, params = _nn_inputs(11, 2, 37, w, 16, cuda, u8)
  else:
    grid, frame, params = _inputs(11, 2, 37, w, cuda, u8)
  kw = dict(clip_output=True, u8_output=u8)
  # The same values one element into a larger buffer: not aligned.
  shifted = torch.empty(frame.numel() + 1, dtype=frame.dtype, device=cuda)
  shifted[1:] = frame.reshape(-1)
  unaligned = shifted[1:].view(frame.shape)
  want = fused.enhance_fused_plain(grid, frame, params, mode, **kw)
  got = fused.enhance_fused(grid, frame, params, mode, **kw)
  assert torch.equal(fused.enhance_fused(grid, unaligned, params, mode, **kw),
                     got)
  torch.cuda.synchronize()
  if u8:
    diff = (got.int() - want.int()).cpu().numpy()
    assert np.abs(diff).max() <= 1 and (diff != 0).mean() < 0.01
  else:
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize('mode', ['curves', 'nn'])
def test_fused_kernel_bands_cut_tiles(cuda, mode):
  """K7 at offsets that cut the kernel's 16 x 64 tiles (rows 7, 23, 50,
  columns 5, 70, 131): each band and tile bit for bit the same pixels of
  the whole frame."""
  if mode == 'nn':
    grid, frame, params = _nn_inputs(12, 1, 211, 333, 16, cuda, False)
  else:
    grid, frame, params = _inputs(12, 1, 211, 333, cuda, False)
  whole = fused.enhance_fused(grid, frame, params, mode, clip_output=True)
  for y0, y1, x0, x1 in ((7, 23, 0, 333), (23, 50, 5, 70), (50, 211, 131, 333),
                         (0, 211, 70, 131), (100, 101, 5, 6)):
    tile = frame[:, y0:y1, x0:x1].contiguous()
    got = fused.enhance_fused(grid, tile, params, mode, clip_output=True,
                              y_offset=y0, x_offset=x0, h_total=211,
                              w_total=333)
    assert torch.equal(got, whole[:, y0:y1, x0:x1]), (y0, y1, x0, x1)


def test_fused_kernel_large_grid_small_frame(cuda):
  """A grid whose cells for one tile exceed a block's shared memory (a
  32 x 32 x 16 grid over a 40 x 130 frame) is read from device memory
  instead, with the same result as the plain version; its bands equal
  the whole frame."""
  grid, frame, params = _inputs(13, 1, 40, 130, cuda, False, 32, 32, 16)
  got = fused.enhance_fused(grid, frame, params, clip_output=True)
  want = fused.enhance_fused_plain(grid, frame, params, clip_output=True)
  torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
  band = frame[:, 9:18].contiguous()
  assert torch.equal(fused.enhance_fused(grid, band, params, clip_output=True,
                                         y_offset=9, h_total=40),
                     got[:, 9:18])


def test_fused_kernel_frame_past_32_bit_index(cuda):
  """A uint8 frame of 2^31 values or more (24576 x 32768, 805 MP, 2.4 GB)
  runs in H-bands inside the launcher, since the kernel indexes an image
  in 32 bits: rows at the frame's start, across the first band's end and
  at the frame's end are bit for bit the same rows run as bands of their
  own, and within 1 code of the plain version."""
  h, w = 24576, 32768
  grid, _, params = _inputs(14, 1, 16, 64, cuda, True)
  gen = torch.Generator(device=cuda).manual_seed(14)
  frame = torch.randint(0, 256, (1, h, w, 3), dtype=torch.uint8,
                        device=cuda, generator=gen)
  kw = dict(clip_output=True, u8_output=True)
  whole = fused.enhance_fused(grid, frame, params, **kw)
  edge = (2**31 - 1) // (3 * w)  # the first band's rows
  for y0, y1 in ((0, 8), (edge - 8, edge + 8), (h - 8, h)):
    band = frame[:, y0:y1].contiguous()
    got = fused.enhance_fused(grid, band, params, y_offset=y0, h_total=h,
                              **kw)
    assert torch.equal(whole[:, y0:y1], got), (y0, y1)
    want = fused.enhance_fused_plain(grid, band, params, y_offset=y0,
                                     h_total=h, **kw)
    diff = (got.int() - want.int()).cpu().numpy()
    assert np.abs(diff).max() <= 1 and (diff != 0).mean() < 0.01


def test_export_tf32_outside_load_artifact(cuda, tmp_path, record_property):
  """F2: a reloaded graph run with cuDNN's TF32 on, outside load_artifact
  (which sets the manifest's switches), against the eager Enhancer. The
  test reports which it saw: a difference above 1e-4 (what the manifest's
  record guards against) or a match. load_artifact's run is bit-identical
  whatever the caller's switches."""
  import json
  from hdrnet_torch.bin import export
  from hdrnet_torch.config import Config, TrainConfig
  from hdrnet_torch.training import loop, step
  from hdrnet_torch.training.checkpoint import Checkpointer
  cfg = Config(model=ModelConfig(), train=TrainConfig())
  model = Enhancer(cfg.model, device='cpu', seed=5).model
  cfg.save(str(tmp_path))
  Checkpointer(str(tmp_path)).save(0, step.create_state(
      model, loop.make_optimizer(model, cfg.train)))
  export.main([str(tmp_path), '--fullres', '270', '480'])
  path = str(tmp_path / 'serve_fn.pt2')
  with open(str(tmp_path / 'serve_fn.manifest.json')) as f:
    assert json.load(f)['precision'] == export.PRECISION
  enh = Enhancer.from_checkpoint(str(tmp_path), device=cuda)
  rng = np.random.RandomState(6)
  low = torch.from_numpy(rng.rand(1, 256, 256, 3).astype(np.float32)).to(cuda)
  full = torch.from_numpy(rng.rand(1, 270, 480, 3).astype(np.float32)).to(
      cuda)
  want = enh(low, full)
  saved = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
  try:
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    module = torch.export.load(path).module()
    with torch.no_grad():
      tf32 = module(low, full)
    loaded = export.load_artifact(path)(low, full)
  finally:
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved
  torch.cuda.synchronize()
  assert torch.equal(loaded, want)
  diff = float((tf32 - want).abs().max())
  seen = ('differs by more than 1e-4' if diff > 1e-4
          else 'matches within 1e-4')
  record_property('tf32_max_abs_diff', diff)
  print(f'reloaded serve_fn with cudnn.allow_tf32 on: {seen} '
        f'(max |diff| {diff:.3e})')


@pytest.mark.parametrize('name,cm,n_in', [
    ('HDRNetFullresFeatures', 1, 3),     # K3/K4 at n_in 4, C = 15
    ('StyleTransferNN', 1, 6),           # n_in 6, C = 21 (input grads on)
    ('HDRNetFeaturesPyrNN', 2, 3)])      # n_in 8, C = 27, three levels
def test_zoo_model_backward_on_card_matches_plain(cuda, name, cm, n_in):
  """A zoo model's forward and backward on the card (K3, K4 with the
  input's cotangent, K5) against the same on the plain versions: K4's
  d_image at n_in 4, 6 and 8 reaches the feature towers (or the frame),
  and every gradient, the frame's included, agrees to 1e-4 of its max."""
  from hdrnet_torch.models import make_model
  from hdrnet_torch.inference import full_float32
  cfg = ModelConfig(model_name=name, net_input_size=64, spatial_bin=8,
                    luma_bins=8, channel_multiplier=cm, guide_complexity=8,
                    n_in=n_in)
  rng = np.random.RandomState(11)
  low = torch.from_numpy(rng.rand(2, 64, 64, n_in).astype(np.float32))
  full = torch.from_numpy(rng.rand(2, 130, 98, n_in).astype(np.float32))
  target = torch.from_numpy(rng.rand(2, 130, 98, 3).astype(np.float32))
  model = make_model(cfg, generator=torch.Generator().manual_seed(3))
  runs = []
  for dev, plain in ((cuda, False), (cuda, True)):
    m = model.to(dev).train()
    x = full.to(dev).requires_grad_()
    saved = (slice_apply.slice_apply_fwd, slice_apply.slice_apply_pix_bwd,
             slice_apply.slice_apply_grid_bwd)
    flags = []

    def pix_bwd(*args, need_input=True, **kw):
      flags.append(need_input)
      return saved[1](*args, need_input=need_input, **kw)
    if plain:
      slice_apply.slice_apply_fwd = slice_apply.slice_apply_fwd_plain
      slice_apply.slice_apply_grid_bwd = slice_apply.slice_apply_grid_bwd_plain
      pix_bwd = slice_apply.slice_apply_pix_bwd_plain
    slice_apply.slice_apply_pix_bwd = pix_bwd
    k4 = slice_apply.pix_bwd_launches
    try:
      with full_float32():
        out = m(low.to(dev), x)
        loss = ((out - target.to(dev)) ** 2).mean()
        grads = torch.autograd.grad(loss, [x] + list(m.parameters()))
    finally:
      (slice_apply.slice_apply_fwd, slice_apply.slice_apply_pix_bwd,
       slice_apply.slice_apply_grid_bwd) = saved
    if not plain:
      n = 3 if 'Pyr' in name else 1
      assert slice_apply.pix_bwd_launches == k4 + n and flags == [True] * n
    runs.append([g.cpu() for g in grads])
  for got, want in zip(*runs):
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-4 * float(want.abs().max()))


def test_grid_bwd_plan_at_the_fpyrnn3_cm2_shape(cuda):
  """K5 plans train_fpyrnn3_cm2.sh's finest level (C = 27, gd 8, 16x16
  cells, 1024^2, b=4) within a block's shared memory, and its cotangent
  there agrees with the plain version's to 2e-4 of the max."""
  grid, guide, image, ct = _train_inputs(12, 4, 1024, 1024, 8, cuda)
  assert grid.shape == (4, 16, 16, 8, 27)
  strips, floats, smem = slice_apply.grid_bwd_plan(grid.shape, guide)
  assert strips >= 1 and 0 < smem <= 227 * 1024
  assert floats == 4 * 17 * 17 * strips * 4 * 8 * 27  # a partial a block
  got = slice_apply.slice_apply_grid_bwd(grid.shape, guide, image, ct)
  want = slice_apply.slice_apply_grid_bwd_plain(grid.shape, guide, image,
                                                ct)
  _scaled_close(got, want, 2e-4)


@pytest.mark.parametrize('name', ['HDRNetFeaturesPyrNN3', 'UNet',
                                  'StyleTransferCurves'])
def test_composite_serving_on_card_matches_plain(cuda, name):
  """Enhancer.process of a composite model on the card (K2, and K3 for
  each slice-apply; no K1 or K6) against the same Enhancer on the plain
  chain, to 1e-4."""
  import hdrnet_torch.inference as inference
  n_in = 6 if name.startswith('Style') else 3
  cfg = ModelConfig(model_name=name, n_in=n_in, channel_multiplier=2)
  enh = Enhancer(cfg, device=cuda, seed=4)
  frame = torch.rand((1, 540, 964, n_in), device=cuda)
  k2, k1, k6 = downsample.launches, fused.launches, fused.nn_launches
  got = enh.process(frame)
  torch.cuda.synchronize()
  assert not enh.fused and downsample.launches == k2 + 1
  assert (fused.launches, fused.nn_launches) == (k1, k6)
  saved = slice_apply.slice_apply_fwd, inference.nearest_lowres
  slice_apply.slice_apply_fwd = slice_apply.slice_apply_fwd_plain
  inference.nearest_lowres = downsample.nearest_lowres_plain
  try:
    want = enh.process(frame)
  finally:
    slice_apply.slice_apply_fwd, inference.nearest_lowres = saved
  assert got.shape == (1, 540, 964, 3)
  torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


# --- device-resident data and the dataset generator ---------------------------

@pytest.mark.parametrize('dtype', [np.uint8, np.uint16])
def test_device_augment_on_card_matches_cpu(cuda, dtype):
  """The device augmentation (index gathers; uint16 through an int16
  view, since CUDA has no uint16 indexing) and the step's normalization,
  bit for bit with the CPU for every rotation and flip."""
  from hdrnet_torch.data import device as dd
  from hdrnet_torch.training.loop import augment_batch
  from hdrnet_torch.training.step import normalize_batch
  rng = np.random.RandomState(5)
  hi = np.iinfo(dtype).max + 1
  ins = rng.randint(0, hi, (3, 40, 56, 3)).astype(dtype)
  outs = rng.randint(0, hi, (3, 40, 56, 3)).astype(dtype)
  aug = dd.make_device_augment([32, 32], 16, True)
  tensors = {d: (dd._upload(ins, d), dd._upload(outs, d))
             for d in (cuda, 'cpu')}
  for fl in (0, 1):
    for fu in (0, 1):
      for k in range(4):
        params = {'idx': np.array([2, 0], np.int32),
                  'y0': np.array([2, 8], np.int32),
                  'x0': np.array([24, 3], np.int32),
                  'fliplr': np.array([fl, 1 - fl], np.int32),
                  'flipud': np.array([fu, 1 - fu], np.int32),
                  'rot_k': np.array([k, 3 - k], np.int32)}
        got, want = (normalize_batch(augment_batch(aug, i, o, params))
                     for i, o in tensors.values())
        for key in want:
          assert torch.equal(got[key].cpu(), want[key]), (key, fl, fu, k)


@pytest.mark.parametrize('dtype', [np.uint8, np.uint16])
def test_usm_synth_on_card_matches_cpu(cuda, dtype):
  from hdrnet_torch.data import device as dd
  rng = np.random.RandomState(6)
  raw = rng.randint(0, np.iinfo(dtype).max + 1, (3, 64, 80, 3)).astype(dtype)
  synth = dd.make_usm_synth(4.0, 1.0)
  got, want = (synth(dd._upload(raw, d)).cpu() for d in (cuda, 'cpu'))
  assert got.dtype == want.dtype

  def codes(t):
    return (t.view(torch.int16).int() & 0xFFFF if t.dtype == torch.uint16
            else t.int())
  assert int((codes(got) - codes(want)).abs().max()) <= 1


def test_ll_generator_on_card_matches_cpu(cuda):
  """The local-Laplacian synthesis and operator at 256^2, card vs CPU,
  1e-4 before quantization (chip_smoke.py holds 1024^2). The operator
  sees the same luminance and remap gammas on both
  (``make_ll_dataset.luminance`` and ``_linspace``)."""
  from hdrnet_torch.scripts import make_ll_dataset as ll
  op = dict(sigma=0.35, alpha=0.2, levels=5)
  img = ll.synth_photo(np.random.RandomState(2), 256, cuda)
  img_cpu = ll.synth_photo(np.random.RandomState(2), 256, 'cpu')
  assert float((img.cpu() - img_cpu).abs().max()) <= 1e-4
  tgt = ll.enhance(img, **op).cpu()
  assert float((tgt - ll.enhance(img.cpu(), **op)).abs().max()) <= 1e-4


def test_train_device_data_on_card(cuda, tmp_path):
  """train() with device_data on the card: the device route, one K3, K4
  and K5 a step."""
  from PIL import Image
  from hdrnet_torch.config import Config, DataConfig, TrainConfig
  from hdrnet_torch.training import loop
  rng = np.random.RandomState(0)
  for sub in ('input', 'output'):
    (tmp_path / sub).mkdir()
    for i in range(3):
      Image.fromarray((rng.rand(80, 96, 3) * 255).astype(np.uint8)).save(
          tmp_path / sub / f'im{i}.png')
  (tmp_path / 'filelist.txt').write_text('im0.png\nim1.png\nim2.png\n')
  cfg = Config(
      model=ModelConfig(net_input_size=32, spatial_bin=8, luma_bins=4),
      data=DataConfig(batch_size=2, output_resolution=[64, 64],
                      net_input_size=32, device_data=True, rotate=True,
                      fliplr=True, device_normalize=True),
      train=TrainConfig(max_steps=4))
  before = (slice_apply.fwd_launches, slice_apply.pix_bwd_launches,
            slice_apply.grid_bwd_launches)
  state = loop.train(cfg, str(tmp_path / 'ckpt'), str(tmp_path),
                     device=cuda)
  torch.cuda.synchronize()
  after = (slice_apply.fwd_launches, slice_apply.pix_bwd_launches,
           slice_apply.grid_bwd_launches)
  assert (state.step, state.data_route) == (4, 'device')
  assert [a - b for a, b in zip(after, before)] == [4, 4, 4]
  assert torch.isfinite(state.ema_loss)


@pytest.mark.parametrize('n_in', [3, 0, 8])
@pytest.mark.parametrize('h,n_bands', [(256, 4), (200, 2), (64, 4)])
def test_band_kernels_match_the_whole_frame(cuda, n_in, h, n_bands):
  """K3, K4 and K5 with a band (y_off, h_total): K3's output and K4's
  cotangents are the whole frame's rows bit for bit; K5's shares (its
  own rows of the mirror-padded frame, and the frame's top or bottom
  mirror rows at its ends) sum to the frame's cotangent within 1e-5 of
  its largest value and agree with the plain shares at K5's gate. A
  band's K5 plan is its own, not the plan of a frame of its height."""
  rng = np.random.RandomState(h + n_in)
  b, w, n_out = 2, 72, 3 if n_in else 12
  g5 = torch.from_numpy(rng.randn(b, 16, 16, 8, n_out * (n_in + 1)).astype(
      np.float32)).to(cuda)
  guide = torch.from_numpy(rng.uniform(-0.1, 1.1, (b, h, w)).astype(
      np.float32)).to(cuda)
  image = torch.from_numpy(rng.rand(b, h, w, n_in).astype(np.float32)).to(
      cuda)
  ct = torch.from_numpy(rng.randn(b, h, w, n_out).astype(np.float32)).to(
      cuda)
  out = slice_apply.slice_apply_fwd(g5, guide, image)
  d_guide, d_image = slice_apply.slice_apply_pix_bwd(g5, guide, image, ct)
  d_grid = slice_apply.slice_apply_grid_bwd(g5.shape, guide, image, ct)
  total = torch.zeros_like(d_grid)
  per = h // n_bands
  for i in range(n_bands):
    rows = slice(i * per, (i + 1) * per)
    band = (rows.start, h)
    args = [t[:, rows].contiguous() for t in (guide, image, ct)]
    assert torch.equal(slice_apply.slice_apply_fwd(g5, *args[:2], band=band),
                       out[:, rows])
    dg, di = slice_apply.slice_apply_pix_bwd(g5, *args, band=band)
    assert torch.equal(dg, d_guide[:, rows])
    if n_in:
      assert torch.equal(di, d_image[:, rows])
    share = slice_apply.slice_apply_grid_bwd(g5.shape, *args, band=band)
    want = slice_apply.slice_apply_grid_bwd_plain(g5.shape, *args, band=band)
    scale = max(1.0, float(want.abs().max()))
    assert float((share - want).abs().max()) <= 2e-4 * scale
    assert slice_apply.grid_bwd_plan(g5.shape, args[0], band) != (
        slice_apply.grid_bwd_plan(g5.shape, args[0]))
    total += share
  scale = float(d_grid.abs().max())
  assert float((total - d_grid).abs().max()) <= 1e-5 * scale


NATIVE_OPS = ('nearest_lowres', 'enhance_fused_curves', 'enhance_fused_nn',
              'slice_apply_fwd', 'resize_bilinear')


def _native_package(cuda, name, fn_name, fullres, tmp_path):
  """(Enhancer, ExportedProgram): a seeded tiny `name` checkpoint saved in
  `tmp_path` and its `fn_name` exported there with aoti=True for the
  card."""
  from hdrnet_torch.bin import export
  from hdrnet_torch.config import Config, TrainConfig
  from hdrnet_torch.training import loop, step
  from hdrnet_torch.training.checkpoint import Checkpointer
  cfg = Config(model=ModelConfig(model_name=name, net_input_size=64,
                                 spatial_bin=8, luma_bins=4,
                                 guide_complexity=4), train=TrainConfig())
  model = Enhancer(cfg.model, device='cpu', seed=3).model
  cfg.save(str(tmp_path))
  Checkpointer(str(tmp_path)).save(0, step.create_state(
      model, loop.make_optimizer(model, cfg.train)))
  enh = Enhancer.from_checkpoint(str(tmp_path), device=cuda)
  fn, example, dynamic = export.serving_functions(enh, fullres)[fn_name]
  program = export.export_function(enh, fn_name, fn, example, dynamic,
                                   str(tmp_path), aoti=True)
  return enh, program


def _native_serve(enh, package, hw, tmp_path, seed, dims=None):
  """The runner's report and output for `package` on seeded (lowres,
  fullres) inputs at `hw`, and the eager Enhancer's output on them."""
  import json
  import subprocess
  from hdrnet_torch import native
  rng = np.random.RandomState(seed)
  low = rng.rand(1, 64, 64, 3).astype(np.float32)
  full = rng.rand(1, *hw, 3).astype(np.float32)
  low.tofile(tmp_path / 'low.bin')
  full.tofile(tmp_path / 'full.bin')
  cmd = native.serve_command(
      package, dims=dims, inputs=[tmp_path / 'low.bin', tmp_path / 'full.bin'],
      output=tmp_path / 'out.bin', burn=1, iters=2)
  r = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                     check=False)
  assert r.returncode == 0, r.stderr
  report = json.loads(r.stdout.strip())
  assert report['device'] == 'cuda'
  want = enh(torch.from_numpy(low).to(enh.device),
             torch.from_numpy(full).to(enh.device))
  got = np.fromfile(tmp_path / 'out.bin', np.float32).reshape(want.shape)
  return report, got, want.cpu().numpy()


def _node_count(program, op):
  return sum(str(n.target) == f'hdrnet.{op}.default'
             for n in program.graph.nodes)


@pytest.mark.parametrize('name,mode', [('HDRNetCurves', 'curves'),
                                       ('HDRNetPointwiseNNGuide', 'nn')])
def test_native_runner_serves_cuda_package(cuda, name, mode, tmp_path):
  """The native runner (hdrnet_torch/native) on an AOTInductor serve_fn
  package compiled for the card: the op library launches K1 (or K6) once
  a run, and the output is the eager Enhancer's within 1e-4 (Inductor may
  order the glue around the kernel another way)."""
  enh, _ = _native_package(cuda, name, 'serve_fn', (96, 128), tmp_path)
  report, got, want = _native_serve(enh, tmp_path / 'serve_fn.aoti.pt2',
                                    (96, 128), tmp_path, 4)
  kernel = f'enhance_fused_{mode}'
  assert report['hdrnet_op_calls'] == {k: 3 if k == kernel else 0
                                       for k in NATIVE_OPS}
  np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_native_runner_serves_pyramid(cuda, tmp_path):
  """HDRNetGaussianPyrNN's serve_fn through the runner: its op library
  runs K6 three times and hdrnet::resize_bilinear four times a run (the
  graph's own node counts), within 1e-4 of the eager Enhancer; without
  the op library the runner exits 1 naming the resize."""
  import subprocess
  from hdrnet_torch import native
  enh, program = _native_package(cuda, 'HDRNetGaussianPyrNN', 'serve_fn',
                                 (96, 128), tmp_path)
  package = tmp_path / 'serve_fn.aoti.pt2'
  report, got, want = _native_serve(enh, package, (96, 128), tmp_path, 5)
  per_run = {'enhance_fused_nn': _node_count(program, 'enhance_fused'),
             'resize_bilinear': _node_count(program, 'resize_bilinear')}
  assert per_run == {'enhance_fused_nn': 3, 'resize_bilinear': 4}
  assert report['hdrnet_op_calls'] == {k: 3 * per_run.get(k, 0)
                                       for k in NATIVE_OPS}
  np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
  r = subprocess.run([str(native.runner().path), str(package)],
                     capture_output=True, text=True, timeout=300,
                     check=False)
  assert r.returncode == 1
  assert 'calls the op hdrnet::resize_bilinear' in r.stderr, r.stderr


@pytest.mark.parametrize('name,mode', [('HDRNetCurves', 'curves'),
                                       ('HDRNetGaussianPyrNN', 'nn')])
def test_native_runner_serves_any_size(cuda, name, mode, tmp_path):
  """One serve_any_fn package (H and W dynamic) served at two sizes, odd
  extents included, each within 1e-4 of the eager Enhancer at that size,
  the report naming the shapes it served."""
  enh, program = _native_package(cuda, name, 'serve_any_fn', (96, 128),
                                 tmp_path)
  per_run = {f'enhance_fused_{mode}': _node_count(program, 'enhance_fused'),
             'resize_bilinear': _node_count(program, 'resize_bilinear')}
  for seed, hw in enumerate([(73, 109), (160, 96)]):
    report, got, want = _native_serve(
        enh, tmp_path / 'serve_any_fn.aoti.pt2', hw, tmp_path, seed,
        dims={'H': hw[0], 'W': hw[1]})
    assert report['shapes'] == {'inputs': [[1, 64, 64, 3], [1, *hw, 3]],
                                'output': [1, *hw, 3]}
    assert report['hdrnet_op_calls'] == {k: 3 * per_run.get(k, 0)
                                         for k in NATIVE_OPS}
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
