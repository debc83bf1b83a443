"""Plain-PyTorch oracle for the bilateral slice / slice-apply and VJPs.

The batched counterpart of :mod:`hdrnet_tpu.ops.reference`, with the
boundary rules of the reference C++ op, which differ on purpose between
the passes:

  * forward, guide VJP, input VJP (ops/bilateral_slice_apply.cc:24-82,
    140-259): spatial and depth taps are weighted at their *unclamped*
    positions and gathered at clamped indices;
  * grid VJP (cc:84-138): a splat over the mirror-padded image (numpy's
    'symmetric' pad: the edge pixel repeats), with direct tent weights
    and the depth weight forced to exactly 1 for cell 0 below bin 0 and
    for cell gd-1 above bin gd-1.

So the VJPs are not the derivative of the forward: autograd through
``bilateral_slice_apply`` differs from them near the borders and where
the smoothed depth tent sums to less than 1.

Layouts (channels-last, batched):
  grid:  (b, gh, gw, gd, no, ni_tot)   ni_tot = n_in + 1 if has_offset
  guide: (b, h, w), nominally in [0, 1]
  image: (b, h, w, n_in)
  ct:    (b, h, w, no), the output cotangent
  out:   (b, h, w, no)
"""

from __future__ import annotations

import math

import torch

from hdrnet_torch.numerics import (lerp_weight, mirror_boundary,
                                   smoothed_lerp_weight,
                                   smoothed_lerp_weight_grad)


def _spatial_taps(extent, grid_extent, device, dtype=torch.float32,
                  offset=0, total=None):
  """Per-pixel 2-tap spatial interpolation along one axis.

  ``gf = (x + offset + 0.5) * grid_extent / total`` for the `extent`
  pixels x of a band that starts at `offset` in an axis of `total` pixels
  (by default the whole axis: offset 0, total = extent); taps at
  floor(gf - 0.5) and +1, tent weights at the unclamped tap centers. The
  global pixel index is an exact float, so a band's taps are bit for bit
  those of the same pixels of the whole axis.
  Returns (i0, i1, w0, w1, clamped0, clamped1), each of shape (extent,).
  """
  scale = grid_extent / (extent if total is None else total)
  gf = (torch.arange(offset, offset + extent, dtype=dtype, device=device)
        + 0.5) * scale
  i0 = torch.floor(gf - 0.5).long()
  i1 = i0 + 1
  w0 = lerp_weight(i0.to(dtype) + 0.5, gf)
  w1 = lerp_weight(i1.to(dtype) + 0.5, gf)
  c0 = torch.clamp(i0, 0, grid_extent - 1)
  c1 = torch.clamp(i1, 0, grid_extent - 1)
  return i0, i1, w0, w1, c0, c1


def _depth_taps(guide, grid_depth):
  """Per-pixel 2-tap depth interpolation driven by the guide:
  ``gzf = guide * grid_depth`` (no +0.5, as in the reference), smoothed
  tent weights at the unclamped taps, clamped gather indices."""
  gzf = guide * grid_depth
  z0 = torch.floor(gzf - 0.5).long()
  z1 = z0 + 1
  w0 = smoothed_lerp_weight(z0.to(guide.dtype) + 0.5, gzf)
  w1 = smoothed_lerp_weight(z1.to(guide.dtype) + 0.5, gzf)
  c0 = torch.clamp(z0, 0, grid_depth - 1)
  c1 = torch.clamp(z1, 0, grid_depth - 1)
  return gzf, w0, w1, c0, c1


def _slice_channels(grid, guide, z_w0, z_w1, z_c0, z_c1, band=None):
  """Trilinear slice of every channel at the guide-indexed taps.

  grid: (b, gh, gw, gd, C); guide, z_*: (b, h, w). Returns (b, h, w, C).
  band: None for a whole frame, else (y_offset, x_offset, h_total,
  w_total): the (h, w) pixels are a band of an h_total x w_total frame
  starting at that offset (the plain K7).
  """
  b, gh, gw, _, _ = grid.shape
  _, h, w = guide.shape
  y_off, x_off, h_total, w_total = band or (0, 0, h, w)
  dev, dt = guide.device, guide.dtype
  _, _, wy0, wy1, yc0, yc1 = _spatial_taps(h, gh, dev, dt, y_off, h_total)
  _, _, wx0, wx1, xc0, xc1 = _spatial_taps(w, gw, dev, dt, x_off, w_total)

  bi = torch.arange(b, device=dev)[:, None, None]
  yc0, yc1 = yc0[None, :, None], yc1[None, :, None]
  xc0, xc1 = xc0[None, None, :], xc1[None, None, :]
  wy0, wy1 = wy0[None, :, None, None], wy1[None, :, None, None]
  wx0, wx1 = wx0[None, None, :, None], wx1[None, None, :, None]
  zw0, zw1 = z_w0[..., None], z_w1[..., None]

  def corner(yc, xc, zc):
    return grid[bi, yc, xc, zc]  # (b, h, w, C)

  return (wy0 * wx0 * (zw0 * corner(yc0, xc0, z_c0) +
                       zw1 * corner(yc0, xc0, z_c1)) +
          wy0 * wx1 * (zw0 * corner(yc0, xc1, z_c0) +
                       zw1 * corner(yc0, xc1, z_c1)) +
          wy1 * wx0 * (zw0 * corner(yc1, xc0, z_c0) +
                       zw1 * corner(yc1, xc0, z_c1)) +
          wy1 * wx1 * (zw0 * corner(yc1, xc1, z_c0) +
                       zw1 * corner(yc1, xc1, z_c1)))


def bilateral_slice(grid, guide, band=None):
  """Trilinear slice of a bilateral grid (no affine apply).

  grid: (b, gh, gw, gd, C), guide: (b, h, w) -> (b, h, w, C); `band` as
  in ``_slice_channels``.
  """
  _, z_w0, z_w1, z_c0, z_c1 = _depth_taps(guide, grid.shape[3])
  return _slice_channels(grid, guide, z_w0, z_w1, z_c0, z_c1, band)


def _extend_image(image, has_offset):
  """Appends the affine offset's implicit all-ones channel."""
  if not has_offset:
    return image
  ones = torch.ones(image.shape[:-1] + (1,), dtype=image.dtype,
                    device=image.device)
  return torch.cat([image, ones], dim=-1)


def bilateral_slice_apply(grid, guide, image, has_offset=True, band=None):
  """Slice + per-pixel affine apply (the HDRNet hot op).

  grid (b, gh, gw, gd, no, ni_tot), guide (b, h, w), image (b, h, w, n_in)
  -> (b, h, w, no). Reference: ops/bilateral_slice_apply.cc:24-82.
  band: None, or (y_offset, x_offset, h_total, w_total) for a band of a
  larger frame (``_slice_channels``).
  """
  b, gh, gw, gd, no, ni_tot = grid.shape
  _, h, w = guide.shape
  sliced = bilateral_slice(grid.reshape(b, gh, gw, gd, no * ni_tot), guide,
                           band)
  sliced = sliced.reshape(b, h, w, no, ni_tot)
  image_ext = _extend_image(image, has_offset)
  # An elementwise sum, not einsum: no TF32 matmul path on the card.
  return (sliced * image_ext[..., None, :]).sum(-1)


# ---------------------------------------------------------------------------
# VJPs
# ---------------------------------------------------------------------------


def mirror_pad(extent, grid_extent):
  """The grid VJP's mirror padding of an axis: half a cell."""
  return math.ceil(0.5 * extent / grid_extent)


def pad_amounts(h, w, gh, gw):
  """Mirror padding (rows, cols) that lets a plain splat cover the
  reference's gather-with-mirror-boundary grid gradient."""
  return mirror_pad(h, gh), mirror_pad(w, gw)


def _padded_share(extent, grid_extent, offset, total, axis):
  """A band's share of the mirror-padded axis: the padded frame
  coordinates it splats, and the band's pixel each reads.

  The band is pixels offset .. offset + extent - 1 of an axis of `total`
  pixels, padded by ``pad_amounts`` (half a cell) at each end. It owns its
  own pixels, and the mirror pixels at an end of the frame when it holds
  that end (a whole axis owns them all), so the shares of bands that tile
  the axis partition the padded axis. The mirror pixels read the band's
  own edge pixels, so a band shorter than the padding raises.
  Returns (coords, index), int64 tensors of one length.
  """
  pad = mirror_pad(total, grid_extent)
  if extent < pad:
    raise ValueError(
        f'a band of {extent} pixels along {axis} is shorter than the grid '
        f'VJP\'s mirror padding of {pad} (half a cell of {total} / '
        f'{grid_extent}): cut the frame into fewer bands')
  lo = -pad if offset == 0 else offset
  hi = total + pad if offset + extent == total else offset + extent
  coords = torch.arange(lo, hi)
  return coords, mirror_boundary(coords, total) - offset


def _grid_grad_spatial_weights(coords, grid_extent, total, device, dtype):
  """(len(coords), grid_extent) direct tent weights of every padded pixel
  (at frame coordinate coords) against every grid cell (cc:110-117)."""
  scale = grid_extent / total
  gf = (coords.to(device=device, dtype=dtype) + 0.5) * scale
  cells = torch.arange(grid_extent, dtype=dtype, device=device) + 0.5
  return lerp_weight(cells[None, :], gf[:, None])


def _grid_grad_depth_weights(guide_padded, grid_depth):
  """(..., gd) smoothed tent weights with the z-extreme overrides to 1
  (cc:120-125)."""
  gzf = guide_padded * grid_depth
  dev, dt = gzf.device, gzf.dtype
  cells = torch.arange(grid_depth, dtype=dt, device=dev) + 0.5
  wz = smoothed_lerp_weight(cells, gzf[..., None])
  k = torch.arange(grid_depth, device=dev)
  low = (gzf < 0.5)[..., None] & (k == 0)
  high = (gzf > grid_depth - 0.5)[..., None] & (k == grid_depth - 1)
  return torch.where(low | high, torch.ones_like(wz), wz)


def bilateral_slice_apply_grid_vjp(guide, image, ct, grid_shape,
                                   has_offset=True, band=None):
  """Grid cotangent, independent of the grid's values.

  guide (b, h, w), image (b, h, w, n_in), ct (b, h, w, no);
  grid_shape (gh, gw, gd, no, ni_tot). Returns (b, gh, gw, gd, no, ni_tot):
  the sum over padded pixels of wy * wx * wz[k] * ct[i] * in_ext[j].
  Contracted one depth bin at a time, x then y, so that no (h', w', gd,
  C) array is materialized.

  band: None for a whole frame, else (y_offset, x_offset, h_total,
  w_total) as in ``_slice_channels``: the band's share of the whole
  frame's cotangent (``_padded_share``), the padding that of the whole
  frame. The shares of bands that tile a frame sum to its cotangent.
  """
  gh, gw, gd, no, ni_tot = grid_shape
  b, h, w = guide.shape
  y_off, x_off, h_total, w_total = band or (0, 0, h, w)
  dev, dt = guide.device, guide.dtype
  ys, iy = _padded_share(h, gh, y_off, h_total, 'H')
  xs, ix = _padded_share(w, gw, x_off, w_total, 'W')
  iy, ix = iy.to(dev), ix.to(dev)
  w_y = _grid_grad_spatial_weights(ys, gh, h_total, dev, dt)  # (h', gh)
  w_x = _grid_grad_spatial_weights(xs, gw, w_total, dev, dt)  # (w', gw)

  def sym_pad(x):
    return x.index_select(1, iy).index_select(2, ix)

  w_k = _grid_grad_depth_weights(sym_pad(guide), gd)
  image_ext = _extend_image(image, has_offset)
  f = sym_pad(ct[..., :, None] * image_ext[..., None, :])
  f = f.reshape(f.shape[:3] + (no * ni_tot,))               # (b, h', w', C)
  out = []
  for k in range(gd):
    t = torch.einsum('xb,nyxc->nybc', w_x, w_k[..., k, None] * f)
    out.append(torch.einsum('ya,nybc->nabc', w_y, t))
  return torch.stack(out, dim=3).reshape(b, gh, gw, gd, no, ni_tot)


def bilateral_slice_apply_guide_vjp(grid, guide, image, ct, has_offset=True,
                                    band=None):
  """Guide cotangent (cc:140-206): the slice re-interpolated with the
  depth-weight derivative ``gd * smoothed_lerp_weight_grad`` at the two
  unclamped taps, gathered at clamped indices. Returns (b, h, w); `band`
  as in ``_slice_channels``."""
  b, gh, gw, gd, no, ni_tot = grid.shape
  _, h, w = guide.shape
  gzf = guide * gd
  z0 = torch.floor(gzf - 0.5).long()
  z1 = z0 + 1
  dw0 = gd * smoothed_lerp_weight_grad(z0.to(guide.dtype) + 0.5, gzf)
  dw1 = gd * smoothed_lerp_weight_grad(z1.to(guide.dtype) + 0.5, gzf)
  c0 = torch.clamp(z0, 0, gd - 1)
  c1 = torch.clamp(z1, 0, gd - 1)
  sliced_dz = _slice_channels(grid.reshape(b, gh, gw, gd, no * ni_tot),
                              guide, dw0, dw1, c0, c1, band)
  sliced_dz = sliced_dz.reshape(b, h, w, no, ni_tot)
  image_ext = _extend_image(image, has_offset)
  return ((sliced_dz * image_ext[..., None, :]).sum(-1) * ct).sum(-1)


def bilateral_slice_apply_input_vjp(grid, guide, ct, has_offset=True,
                                    band=None):
  """Input cotangent (cc:208-259): the sliced affine matrix transposed,
  applied to ct. Returns (b, h, w, n_in); `band` as in
  ``_slice_channels``."""
  b, gh, gw, gd, no, ni_tot = grid.shape
  _, h, w = guide.shape
  n_in = ni_tot - 1 if has_offset else ni_tot
  sliced = bilateral_slice(grid.reshape(b, gh, gw, gd, no * ni_tot), guide,
                           band)
  sliced = sliced.reshape(b, h, w, no, ni_tot)
  return (sliced[..., :n_in] * ct[..., :, None]).sum(-2)


def bilateral_slice_grid_vjp(guide, ct, grid_shape):
  """Grid cotangent of the plain slice (ops/bilateral_slice.cc:72-118):
  the apply grid VJP with an all-ones input. grid_shape (gh, gw, gd, C)."""
  gh, gw, gd, c = grid_shape
  empty = ct.new_zeros(ct.shape[:3] + (0,))
  vjp = bilateral_slice_apply_grid_vjp(guide, empty, ct, (gh, gw, gd, c, 1))
  return vjp.reshape(ct.shape[0], gh, gw, gd, c)


def bilateral_slice_guide_vjp(grid, guide, ct):
  """Guide cotangent of the plain slice (ops/bilateral_slice.cc:120-168)."""
  empty = ct.new_zeros(ct.shape[:3] + (0,))
  return bilateral_slice_apply_guide_vjp(grid[..., None], guide, empty, ct)
