"""``ops.levels``: the pyramid's level kernels on the serving route.

On the CPU: the plain versions are bit for bit the ATen chain they stand
for (``gaussian_pyramid`` of ``to_unit``; ``upsample_add``, the clamp and
the stream's requantize), at ragged sizes; the wrappers' refusals; the
Enhancer's pyramid routes give the torch route's values and bytes, and
count no launch. Marked ``gpu`` (skipped without a card; on the card
``python -m pytest --noconftest -m gpu tests/test_torch_levels.py``): the
kernels bit for bit their plain versions at 4K and ragged shapes, the 4K
stream byte for byte the torch route with 2 + 2 launches a frame, and
``enhance_any`` on float32 frames. This file imports no JAX.
"""

import numpy as np
import pytest
import torch

from hdrnet_torch.inference import Enhancer, ModelConfig
from hdrnet_torch.models.hdrnet import gaussian_pyramid, upsample_add
from hdrnet_torch.ops import _build, levels
from hdrnet_torch.ops.downsample import nearest_lowres, to_unit
from hdrnet_torch.ops.fused import enhance_fused

SMALL = dict(model_name='HDRNetGaussianPyrNN', net_input_size=32,
             spatial_bin=8, luma_bins=4, guide_complexity=4)
# (B, H, W): odd extents, a first level of odd extents (43 // 2 = 21),
# a batch of two.
SHAPES = [(1, 40, 56), (2, 43, 61), (1, 86, 31)]
ENDS = [(False, False), (True, False), (True, True)]


def _frame(shape, dtype, seed=0):
  rng = np.random.RandomState(seed)
  if dtype == torch.uint8:
    return torch.from_numpy(rng.randint(0, 256, (*shape, 3)).astype(np.uint8))
  return torch.from_numpy(rng.rand(*shape, 3).astype(np.float32))


def _sum_inputs(shape, seed=0):
  """A coarser sum and a finer level's output, spread past [0, 1] so that
  the clip acts."""
  b, h, w = shape
  rng = np.random.RandomState(seed)
  current = rng.uniform(-0.3, 1.3, (b, h // 2, w // 2, 3))
  level = rng.uniform(-0.3, 0.3, (b, h, w, 3))
  return (torch.from_numpy(current.astype(np.float32)),
          torch.from_numpy(level.astype(np.float32)))


def _torch_down(frame):
  return gaussian_pyramid(to_unit(frame), 2)[1]


def _ends(out, clip, u8):
  """The clamp, then the stream's requantize."""
  if clip:
    out = torch.clamp(out, 0.0, 1.0)
  return (out * 255.0 + 0.5).to(torch.int32).to(torch.uint8) if u8 else out


def _torch_up_add(current, level, clip, u8):
  return _ends(upsample_add(current, level), clip, u8)


def _torch_route(enh, low, frame, clip=True, u8=False):
  """The pyramid's forward as the torch route computes it: the frame
  dequantized, ``gaussian_pyramid``, K6 on each level (its plain version
  on the CPU), ``upsample_add``, the clamp, the requantize."""
  grid = enh._backbone_grid(low)
  b, gh, gw, gd, _, ni1 = grid.shape
  pyr = gaussian_pyramid(to_unit(frame), len(enh.guide_params))
  current = None
  for il, (lvl, params) in enumerate(zip(pyr[::-1], enh.guide_params[::-1])):
    sub = grid[..., 3 * il:3 * (il + 1), :].reshape(b, gh, gw, gd, 3 * ni1)
    out = enhance_fused(sub.contiguous(), lvl.contiguous(), params, 'nn')
    current = out if current is None else upsample_add(current, out)
  return _ends(current, clip, u8)


def _launches():
  return (_build.launches['hdrnet_pyramid_down'],
          _build.launches['hdrnet_pyramid_up_add'])


@pytest.mark.parametrize('dtype', [torch.uint8, torch.float32])
@pytest.mark.parametrize('shape', SHAPES)
def test_pyramid_down_plain_is_the_torch_chain(shape, dtype):
  frame = _frame(shape, dtype)
  want = _torch_down(frame)
  assert torch.equal(levels.pyramid_down_plain(frame), want)
  assert torch.equal(levels.pyramid_down(frame), want)
  assert want.shape == (shape[0], shape[1] // 2, shape[2] // 2, 3)


@pytest.mark.parametrize('clip,u8', ENDS)
@pytest.mark.parametrize('shape', SHAPES)
def test_pyramid_up_add_plain_is_the_torch_chain(shape, clip, u8):
  current, level = _sum_inputs(shape)
  want = _torch_up_add(current, level, clip, u8)
  assert want.dtype == (torch.uint8 if u8 else torch.float32)
  assert torch.equal(levels.pyramid_up_add_plain(current, level, clip, u8),
                     want)
  assert torch.equal(levels.pyramid_up_add(current, level, clip, u8), want)


@pytest.mark.parametrize('dtype', [torch.uint8, torch.float32])
def test_gaussian_levels_are_gaussian_pyramid(dtype):
  frame = _frame((2, 43, 61), dtype, seed=1)
  want = gaussian_pyramid(to_unit(frame), 3)
  for down in (levels.pyramid_down, levels.pyramid_down_plain):
    got = levels.gaussian_levels(frame, 3, down)
    assert got[0] is frame and len(got) == 3
    for a, b in zip(got[1:], want[1:]):
      assert torch.equal(a, b)


def test_wrappers_refuse_what_the_kernels_do_not_take():
  frame = _frame((1, 40, 56), torch.float32)
  current, level = _sum_inputs((1, 40, 56))
  with pytest.raises(TypeError):
    levels.pyramid_down(frame.double())
  with pytest.raises(ValueError):
    levels.pyramid_down(frame[..., :2])
  with pytest.raises(ValueError):
    levels.pyramid_down(frame[0])
  with pytest.raises(ValueError):
    levels.pyramid_down(frame.transpose(1, 2))
  with pytest.raises(TypeError):
    levels.pyramid_up_add(current.to(torch.uint8), level)
  with pytest.raises(TypeError):
    levels.pyramid_up_add(current, level.double())
  with pytest.raises(ValueError):
    levels.pyramid_up_add(current[:, :-1].contiguous(), level)
  with pytest.raises(ValueError):
    levels.pyramid_up_add(current, torch.cat([level, level]))
  with pytest.raises(ValueError):
    levels.pyramid_up_add(current.transpose(1, 2).contiguous().transpose(
        1, 2), level)
  with pytest.raises(ValueError):
    levels.pyramid_up_add(current, level, clip_output=False, u8_output=True)


def test_enhancer_pyramid_routes_give_the_torch_routes_values():
  enh = Enhancer(ModelConfig(**SMALL), device='cpu', seed=3)
  u8 = _frame((1, 43, 61), torch.uint8, seed=2)
  f32 = _frame((2, 40, 56), torch.float32, seed=3)
  before = _build.launches.copy()
  got = enh.make_stream_fn(u8.shape)(u8)
  want = _torch_route(enh, nearest_lowres(u8, 32), u8, clip=True, u8=True)
  assert got.dtype == torch.uint8 and torch.equal(got, want)
  low = nearest_lowres(f32, 32)
  assert torch.equal(enh.process(f32), _torch_route(enh, low, f32))
  assert torch.equal(enh(low.permute(0, 2, 3, 1), f32, clip=False),
                     _torch_route(enh, low, f32, clip=False))
  assert torch.equal(
      enh.enhance_any(low.permute(0, 2, 3, 1).numpy(), f32.numpy()),
      _torch_route(enh, low, f32))
  assert _build.launches == before


# On the card.

@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA device: run on the card with '
                '`python -m pytest --noconftest -m gpu '
                'tests/test_torch_levels.py`')
  return torch.device('cuda', 0)


CARD_SHAPES = [(1, 2160, 3840), (1, 2161, 3839), (1, 200, 320), (2, 43, 61),
               (1, 1080, 1920)]


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.uint8, torch.float32])
@pytest.mark.parametrize('shape', CARD_SHAPES)
def test_pyramid_down_kernel_is_plain_bit_for_bit(cuda, shape, dtype):
  frame = _frame(shape, dtype).to(cuda)
  n = _build.launches['hdrnet_pyramid_down']
  got = levels.pyramid_down(frame)
  assert _build.launches['hdrnet_pyramid_down'] == n + 1
  torch.cuda.synchronize()
  assert torch.equal(got, levels.pyramid_down_plain(frame))
  assert torch.equal(got.cpu(), levels.pyramid_down_plain(frame.cpu()))


@pytest.mark.gpu
@pytest.mark.parametrize('clip,u8', ENDS)
@pytest.mark.parametrize('shape', CARD_SHAPES)
def test_pyramid_up_add_kernel_is_plain_bit_for_bit(cuda, shape, clip, u8):
  current, level = (t.to(cuda) for t in _sum_inputs(shape))
  n = _build.launches['hdrnet_pyramid_up_add']
  got = levels.pyramid_up_add(current, level, clip, u8)
  assert _build.launches['hdrnet_pyramid_up_add'] == n + 1
  torch.cuda.synchronize()
  assert torch.equal(got, levels.pyramid_up_add_plain(current, level, clip,
                                                      u8))


@pytest.mark.gpu
def test_pyramid_stream_is_the_torch_route_byte_for_byte(cuda):
  """The 4K stream (the first frame eager, the second captured, the rest
  replayed) byte for byte the torch route on the card, with 2 + 2 level
  launches a frame."""
  enh = Enhancer(ModelConfig(model_name='HDRNetGaussianPyrNN'), device=cuda,
                 seed=4)
  rng = np.random.RandomState(5)
  frames = [rng.randint(0, 256, (1, 2160, 3840, 3)).astype(np.uint8)
            for _ in range(5)]
  before = _launches()
  outs = list(enh.stream(iter(frames)))
  assert _launches() == (before[0] + 2 * 5, before[1] + 2 * 5)
  for f, out in zip(frames, outs):
    x = torch.from_numpy(f).to(cuda)
    want = _torch_route(enh, nearest_lowres(x, 256), x, clip=True, u8=True)
    assert np.array_equal(out, want.cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize('hw', [(2161, 3839), (200, 320)])
def test_enhance_any_float_frames_are_the_torch_route(cuda, hw):
  enh = Enhancer(ModelConfig(model_name='HDRNetGaussianPyrNN'), device=cuda,
                 seed=6)
  frame = _frame((1, *hw), torch.float32, seed=7).to(cuda)
  low = nearest_lowres(frame, 256)
  got = enh.enhance_any(low.permute(0, 2, 3, 1), frame)
  assert torch.equal(got, _torch_route(enh, low, frame))
  assert torch.equal(enh.process(frame), got)
