"""H-bands of the slice-apply's plain versions (K3, K4, K5 on CPU
tensors) and of the differentiable op, against the whole frame and the
JAX package's reference VJP.

A band is rows y_off .. y_off + h - 1 of a frame of h_total rows (a
rank's share on a 'spatial' mesh axis). K3's output and K4's guide and
input cotangents of a band are the whole frame's rows, exactly; K5's grid
cotangent of a band is its share of the whole frame's, and the shares of
2 and 4 bands sum to it within 1e-5 of its largest value (the sums are
taken in another order). The frames are tall enough against the grid
that the mirror padding (half a cell) is at least 2 rows, so the first
and last bands carry mirror rows.
"""

import functools

import numpy as np
import jax
import pytest
import torch

from hdrnet_tpu.ops import reference as jref

from hdrnet_torch.config import ModelConfig
from hdrnet_torch.models import MODELS, make_model
from hdrnet_torch.ops import reference as tref
from hdrnet_torch.ops import slice_apply as sa
from hdrnet_torch.ops.slice_ops import bilateral_slice_apply
from hdrnet_torch.parallel import halo

REL = 1e-5
# (b, h, w, gh, gw, gd): padding ceil(h / 2gh) rows = 3 and 2.
SHAPES = [(2, 48, 40, 8, 8, 4), (1, 64, 24, 16, 4, 8)]


def _inputs(seed, shape, n_in, n_out=3):
  b, h, w, gh, gw, gd = shape
  rng = np.random.RandomState(seed)
  c = n_out * (n_in + 1)
  grid = torch.from_numpy(rng.randn(b, gh, gw, gd, c).astype(np.float32))
  guide = rng.uniform(-0.1, 1.1, (b, h, w)).astype(np.float32)
  guide[:, :2] = 0.0  # the depth overrides at the frame's top rows
  guide[:, -2:] = 1.0
  image = rng.rand(b, h, w, n_in).astype(np.float32)
  ct = rng.randn(b, h, w, n_out).astype(np.float32)
  return grid, torch.from_numpy(guide), torch.from_numpy(image), \
      torch.from_numpy(ct)


def _bands(h, n):
  per = h // n
  return [(slice(i * per, (i + 1) * per), (i * per, h)) for i in range(n)]


def test_shapes_carry_mirror_rows():
  for b, h, w, gh, gw, gd in SHAPES:
    pad_y, _ = tref.pad_amounts(h, w, gh, gw)
    assert pad_y >= 2 and h // 4 >= pad_y


@pytest.mark.parametrize('shape', SHAPES)
@pytest.mark.parametrize('n_in', [3, 0, 8])
@pytest.mark.parametrize('n_bands', [2, 4])
def test_band_fwd_and_pix_bwd_are_the_frames_rows(shape, n_in, n_bands):
  grid, guide, image, ct = _inputs(0, shape, n_in)
  out = sa.slice_apply_fwd(grid, guide, image)
  d_guide, d_image = sa.slice_apply_pix_bwd(grid, guide, image, ct)
  for rows, band in _bands(shape[1], n_bands):
    args = (guide[:, rows].contiguous(), image[:, rows].contiguous())
    got = sa.slice_apply_fwd(grid, *args, band=band)
    assert torch.equal(got, out[:, rows])
    g, i = sa.slice_apply_pix_bwd(grid, *args, ct[:, rows].contiguous(),
                                  band=band)
    assert torch.equal(g, d_guide[:, rows])
    assert torch.equal(i, d_image[:, rows])


@pytest.mark.parametrize('shape', SHAPES)
@pytest.mark.parametrize('n_in', [3, 0, 8])
@pytest.mark.parametrize('n_bands', [2, 4])
def test_band_grid_shares_sum_to_the_frames(shape, n_in, n_bands):
  grid, guide, image, ct = _inputs(1, shape, n_in)
  want = sa.slice_apply_grid_bwd(grid.shape, guide, image, ct)
  got = sum(sa.slice_apply_grid_bwd(
      grid.shape, guide[:, rows].contiguous(), image[:, rows].contiguous(),
      ct[:, rows].contiguous(), band=band)
            for rows, band in _bands(shape[1], n_bands))
  scale = float(want.abs().max())
  np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                             atol=REL * scale)
  b, h, w, gh, gw, gd = shape
  jax_want = jax.vmap(functools.partial(
      jref.bilateral_slice_apply_grid_vjp,
      grid_shape=(gh, gw, gd, 3, n_in + 1)))(
          guide.numpy(), image.numpy(), ct.numpy())
  np.testing.assert_allclose(got.numpy(),
                             np.asarray(jax_want).reshape(grid.shape),
                             rtol=0, atol=REL * scale)


def test_edge_bands_hold_the_mirror_rows():
  """The first band's share holds the top mirror rows: a band of the
  frame's first rows, with and without them, differ; a middle band of
  the same rows at another offset reads no mirror row."""
  shape = SHAPES[0]
  grid, guide, image, ct = _inputs(2, shape, 3)
  rows = slice(0, 12)
  args = (grid.shape, guide[:, rows].contiguous(),
          image[:, rows].contiguous(), ct[:, rows].contiguous())
  first = sa.slice_apply_grid_bwd(*args, band=(0, 48))
  middle = sa.slice_apply_grid_bwd(*args, band=(12, 48))
  whole_small = sa.slice_apply_grid_bwd(*args)  # a 12-row frame of its own
  assert not torch.allclose(first, middle)
  assert not torch.allclose(first, whole_small)


def test_band_shorter_than_the_padding_raises():
  grid, guide, image, ct = _inputs(3, SHAPES[0], 3)
  rows = slice(0, 2)  # padding 3 rows
  with pytest.raises(ValueError, match='mirror padding of 3'):
    sa.slice_apply_grid_bwd(grid.shape, guide[:, rows].contiguous(),
                            image[:, rows].contiguous(),
                            ct[:, rows].contiguous(), band=(0, 48))
  with pytest.raises(ValueError, match='outside a frame'):
    sa.slice_apply_fwd(grid, guide[:, :12].contiguous(),
                       image[:, :12].contiguous(), band=(40, 48))


def test_op_gradients_over_bands_sum_to_the_frames():
  """Autograd through ``bilateral_slice_apply(band=)``: the bands' outputs
  and guide gradients are the frame's rows, and their grid gradients sum
  to the frame's."""
  grid, guide, image, ct = _inputs(4, SHAPES[1], 3)
  g0 = grid.clone().requires_grad_()
  gd0 = guide.clone().requires_grad_()
  out = bilateral_slice_apply(g0, gd0, image)
  (out * ct).sum().backward()
  g1 = grid.clone().requires_grad_()
  guide_grads = []
  for rows, band in _bands(SHAPES[1][1], 4):
    gd = guide[:, rows].clone().requires_grad_()
    o = bilateral_slice_apply(g1, gd, image[:, rows], band=band)
    assert torch.equal(o, out[:, rows])
    (o * ct[:, rows]).sum().backward()
    guide_grads.append(gd.grad)
  assert torch.equal(torch.cat(guide_grads, 1), gd0.grad)
  scale = float(g0.grad.abs().max())
  np.testing.assert_allclose(g1.grad.numpy(), g0.grad.numpy(), rtol=0,
                             atol=REL * scale)


# The models whose full-resolution path is pointwise: a bare (y_off,
# h_total) band serves them.
POINTWISE = ['HDRNetCurves', 'HDRNetPointwiseNNGuide', 'StyleTransferNN',
             'StyleTransferCurves']


def _zoo_cfg(name):
  return ModelConfig(model_name=name, net_input_size=32, spatial_bin=8,
                     luma_bins=4, guide_complexity=4, depth=2, width=4,
                     n_in=6 if name.startswith('StyleTransfer') else 3)


@pytest.mark.parametrize('name', POINTWISE)
def test_model_band_is_the_frames_rows(name):
  cfg = _zoo_cfg(name)
  model = make_model(cfg, generator=torch.Generator().manual_seed(0)).eval()
  rng = np.random.RandomState(5)
  low = torch.from_numpy(rng.rand(2, 32, 32, cfg.n_in).astype(np.float32))
  full = torch.from_numpy(rng.rand(2, 64, 40, cfg.n_in).astype(np.float32))
  with torch.no_grad():
    want = model(low, full)
    for rows, band in _bands(64, 4):
      assert torch.equal(model(low, full[:, rows], band=band),
                         want[:, rows])


@pytest.mark.parametrize('name', sorted(set(MODELS) - set(POINTWISE)))
def test_other_models_need_a_band_on_a_group(name):
  """A model that reads rows of the neighbouring bands (resizes, k x k
  convs, the stack's frame-wide preview) refuses a bare (y_off, h_total)
  band, and a ``halo.Band`` with no process group: only the group can
  supply those rows (``tests/test_torch_mesh_train.py`` trains each on
  one)."""
  cfg = _zoo_cfg(name)
  model = make_model(cfg, generator=torch.Generator().manual_seed(0))
  rng = np.random.RandomState(6)
  low = torch.from_numpy(rng.rand(2, 32, 32, 3).astype(np.float32))
  full = torch.from_numpy(rng.rand(2, 16, 40, 3).astype(np.float32))
  for band in ((16, 64), halo.Band(1, 4, 64)):
    with pytest.raises(ValueError, match='neighbouring H-bands'):
      model(low, full, band=band)
