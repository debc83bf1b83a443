"""The H-band arithmetic of ``hdrnet_torch.parallel.halo`` and the banded
ops, in one process (no process group): each op is given the rows of the
whole input that its arithmetic names, cut from it here, and held to the
whole op's rows.

  * the bands of an extent cut s ways (s in 2, 3, 4, even and uneven);
  * the source rows of a bilinear resize (align_corners or not; the
    extents that caught the C++ resize: 27 -> 24, 90 -> 87, 101 -> 50),
    a nearest resize and a 3x3 SAME conv at stride 1 and 2 and rates 1,
    2, 4: enough (with the rows outside them NaN, the band's outputs are
    still the whole op's, or finite) and no more (a NaN in the first or
    last of them reaches an output);
  * the banded resizes bit for bit the whole resize's rows, the banded
    convs within 1e-6; the transpose: the bands' input cotangents,
    scatter-added at their rows, against the whole op's VJP within 1e-6
    of its largest value (the halo rows' cotangents are added to their
    owners' in another order);
  * a pyramid level's band shorter than its mirror padding raises, naming
    the level.

The exchange itself, across gloo ranks, is tested in
``tests/test_torch_mesh_train.py``.
"""

import numpy as np
import pytest
import torch

from hdrnet_torch.models.layers import ConvBlock, same_padding
from hdrnet_torch.ops import resize
from hdrnet_torch.parallel import halo
from hdrnet_torch.parallel import mesh as pm

REL = 1e-6
# (n_in, n_out): the C++ resize's sweep, the pyramid's halvings (even and
# odd), upsamplings (x2, x4) and a 1080-row frame's third level.
BILINEAR = [(27, 24), (90, 87), (101, 50), (64, 32), (18, 9), (35, 17),
            (32, 64), (16, 64), (9, 36), (540, 270)]
NEAREST = [(27, 24), (101, 50), (64, 32), (9, 18), (36, 72), (18, 72),
           (135, 32)]
# (kernel, stride, rate, n_in)
CONVS = [(3, 1, 1, 24), (3, 1, 2, 27), (3, 1, 4, 32), (3, 2, 1, 24),
         (3, 2, 1, 27), (3, 2, 2, 36), (1, 1, 1, 18)]


def _x(n, w=5, c=2, seed=0, dtype=torch.float32):
  rng = np.random.RandomState(seed)
  return torch.from_numpy(rng.randn(2, n, w, c)).to(dtype)


@pytest.mark.parametrize('n', [8, 9, 18, 27, 270])
@pytest.mark.parametrize('s', [2, 3, 4])
def test_bands_tile_every_extent(n, s):
  bounds = halo.split(n, s)
  assert bounds[0][0] == 0 and bounds[-1][1] == n
  assert all(p[1] == q[0] for p, q in zip(bounds, bounds[1:]))
  sizes = [hi - lo for lo, hi in bounds]
  assert max(sizes) - min(sizes) <= 1 and min(sizes) >= 1
  for j, (lo, hi) in enumerate(bounds):
    band = halo.Band(j, s, n)
    assert (band.lo, band.hi, band.h_total) == (lo, hi, n)
    assert band == (lo, n) and band.at(n // 2) == halo.Band(j, s, n // 2)
  with pytest.raises(ValueError, match='leaves a band empty'):
    halo.split(s - 1, s)


def _nan_outside(x, a, b):
  y = x.clone()
  y[:, :max(a, 0)] = np.nan
  y[:, b:] = np.nan
  return y


def _hold_rows(op, x, rows, want, lo, hi):
  """`op` of x's rows [a, b) (NaN outside) gives want[:, lo:hi]; a NaN in
  row a or row b - 1 reaches an output."""
  a, b = rows
  assert torch.equal(op(_nan_outside(x, a, b)), want[:, lo:hi])
  for edge in (a, b - 1):
    y = x.clone()
    y[:, edge] = np.nan
    assert torch.isnan(op(y)).any(), (rows, edge)


@pytest.mark.parametrize('extents', BILINEAR)
@pytest.mark.parametrize('align', [True, False])
@pytest.mark.parametrize('s', [2, 3, 4])
def test_bilinear_band_is_the_frames_rows(extents, align, s):
  n_in, n_out = extents
  x = _x(n_in)
  size = (n_out, 7)
  want = resize.resize_bilinear(x, size, align)
  x.requires_grad_(True)
  ct = _x(n_out, 7, seed=1)
  (g_want,) = torch.autograd.grad(resize.resize_bilinear(x, size, align),
                                  x, ct)
  g_bands = torch.zeros_like(x)
  for lo, hi in halo.split(n_out, s):
    a, b = resize.bilinear_source_rows(n_in, n_out, align, lo, hi)
    assert 0 <= a < b <= n_in
    with torch.no_grad():
      _hold_rows(lambda y: resize.resize_bilinear_rows(  # noqa: B023
          y[:, a:b], a, n_in, size, align, lo, hi), x.detach(), (a, b),
                 want, lo, hi)
    ext = x.detach()[:, a:b].clone().requires_grad_(True)
    out = resize.resize_bilinear_rows(ext, a, n_in, size, align, lo, hi)
    assert torch.equal(out, want[:, lo:hi])
    (g,) = torch.autograd.grad(out, ext, ct[:, lo:hi])
    g_bands[:, a:b] += g
  np.testing.assert_allclose(g_bands.numpy(), g_want.numpy(), rtol=0,
                             atol=REL * float(g_want.abs().max()))


@pytest.mark.parametrize('extents', NEAREST)
@pytest.mark.parametrize('s', [2, 3, 4])
def test_nearest_band_is_the_frames_rows(extents, s):
  n_in, n_out = extents
  x = _x(n_in, seed=2)
  size = (n_out, 4)
  want = resize.resize_nearest(x, size)
  for lo, hi in halo.split(n_out, s):
    a, b = resize.nearest_source_rows(n_in, n_out, lo, hi)
    assert 0 <= a < b <= n_in
    _hold_rows(lambda y: resize.resize_nearest_rows(  # noqa: B023
        y[:, a:b], a, n_in, size, lo, hi), x, (a, b), want, lo, hi)


@pytest.mark.parametrize('conv', CONVS)
@pytest.mark.parametrize('s', [2, 3, 4])
def test_conv_band_is_the_frames_rows(conv, s):
  """A ConvBlock's conv (XLA's SAME: (0, 1) for stride 2 on an even
  extent; dilated by the rate) on a band's source rows, the frame's zero
  padding only where they leave the frame."""
  k, stride, rate, n_in = conv
  block = ConvBlock(2, 3, k, stride=stride, rate=rate, activation=None,
                    generator=torch.Generator().manual_seed(0))
  with torch.no_grad():
    block.conv.bias.normal_(generator=torch.Generator().manual_seed(1))
  x = _x(n_in, 6, seed=3).permute(0, 3, 1, 2).contiguous()
  n_out = -(-n_in // stride)
  x.requires_grad_(True)
  want = block(x)
  ct = torch.from_numpy(np.random.RandomState(4).randn(*want.shape)).float()
  (g_want,) = torch.autograd.grad(want, x, ct)
  want = want.detach()
  scale = REL * max(1.0, float(want.abs().max()))
  g_bands = torch.zeros_like(x)
  for lo, hi in halo.split(n_out, s):
    a, b = block.source_rows(n_in, lo, hi)
    u, v = max(a, 0), min(b, n_in)
    ext = x.detach()[:, :, u:v].clone().requires_grad_(True)
    out = block.conv_rows(ext, (a, b), n_in)
    assert out.shape[2] == hi - lo
    np.testing.assert_allclose(out.detach().numpy(),
                               want[:, :, lo:hi].numpy(), rtol=0,
                               atol=scale)
    # The whole conv's band rows read rows u .. v - 1, and the first and
    # last of [a, b) where the frame holds them (not the padding).
    with torch.no_grad():
      y = x.detach().clone()
      y[:, :, :u] = np.nan
      y[:, :, v:] = np.nan
      assert torch.isfinite(block(y)[:, :, lo:hi]).all()
      for edge in {a, b - 1} & set(range(n_in)):
        y = x.detach().clone()
        y[:, :, edge] = np.nan
        assert torch.isnan(block(y)[:, :, lo:hi]).any(), (lo, hi, edge)
    (g,) = torch.autograd.grad(out, ext, ct[:, :, lo:hi])
    g_bands[:, :, u:v] += g
  np.testing.assert_allclose(g_bands.numpy(), g_want.numpy(), rtol=0,
                             atol=REL * float(g_want.abs().max()))


@pytest.mark.parametrize('s', [2, 3, 4])
def test_conv_source_rows_arithmetic(s):
  """Output rows [lo, hi) of a k x k conv at stride t, rate r, padded
  pad_lo at the top, read input rows [lo t - pad_lo, (hi - 1) t - pad_lo
  + r (k - 1) + 1); the banded ConvBlock asks for exactly those."""
  for k, stride, rate, n_in in CONVS:
    block = ConvBlock(1, 1, k, stride=stride, rate=rate)
    n_out = -(-n_in // stride)
    top, _ = same_padding(n_in, k, stride, rate)
    for lo, hi in halo.split(n_out, s):
      want = (lo * stride - top, (hi - 1) * stride - top + rate * (k - 1) + 1)
      assert block.source_rows(n_in, lo, hi) == want
      assert halo.conv_source_rows(lo, hi, stride, rate * (k - 1) + 1,
                                   top) == want


def test_level_band_shorter_than_its_mirror_pad_raises():
  """72 rows at s = 4 with a 2-row grid: levels 72, 36, 18; bands of 18,
  9 and 4 or 5 rows; pads 18, 9, 5: level 2 raises, levels 0-1 pass."""
  pm.check_band_rows(72, 4, 2, levels=2)
  with pytest.raises(ValueError, match="pyramid level 2's 18 rows into "
                     'bands of 4, shorter than the grid VJP\'s mirror '
                     'padding of 5 rows'):
    pm.check_band_rows(72, 4, 2, levels=3)
  pm.check_band_rows(72, 4, 2, levels=0)  # no grid: nothing to check
  pm.check_band_rows(72, 1, 2, levels=3)  # no spatial cut


def test_ops_refuse_a_band_without_a_group():
  x = _x(16)
  for band in ((4, 16), halo.Band(1, 4, 16)):
    with pytest.raises(ValueError, match='neighbouring H-bands'):
      halo.resize_bilinear(x[:, 4:8], (8, 5), True, band=band)
    with pytest.raises(ValueError, match='neighbouring H-bands'):
      halo.resize_nearest(x[:, 4:8], (8, 5), band=band)
    with pytest.raises(ValueError, match='neighbouring H-bands'):
      ConvBlock(2, 2, 3)(x[:, 4:8].permute(0, 3, 1, 2), band)
