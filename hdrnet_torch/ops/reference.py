"""Plain-PyTorch oracle for the bilateral slice / slice-apply forward.

The batched counterpart of the forward half of
:mod:`hdrnet_tpu.ops.reference`, with the same boundary rule as the
reference C++ op (ops/bilateral_slice_apply.cc:24-82): spatial and depth
taps are weighted at their *unclamped* positions and gathered at
clamped indices.

Layouts (channels-last, batched):
  grid:  (b, gh, gw, gd, no, ni_tot)   ni_tot = n_in + 1 if has_offset
  guide: (b, h, w), nominally in [0, 1]
  image: (b, h, w, n_in)
  out:   (b, h, w, no)
"""

from __future__ import annotations

import torch

from hdrnet_torch.numerics import lerp_weight, smoothed_lerp_weight


def _spatial_taps(extent, grid_extent, device, dtype=torch.float32):
  """Per-pixel 2-tap spatial interpolation along one axis.

  ``gf = (x + 0.5) * grid_extent / extent``; taps at floor(gf - 0.5) and
  +1, tent weights at the unclamped tap centers.
  Returns (i0, i1, w0, w1, clamped0, clamped1), each of shape (extent,).
  """
  scale = grid_extent / extent
  gf = (torch.arange(extent, dtype=dtype, device=device) + 0.5) * scale
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


def _slice_channels(grid, guide, z_w0, z_w1, z_c0, z_c1):
  """Trilinear slice of every channel at the guide-indexed taps.

  grid: (b, gh, gw, gd, C); guide, z_*: (b, h, w). Returns (b, h, w, C).
  """
  b, gh, gw, _, _ = grid.shape
  _, h, w = guide.shape
  dev, dt = guide.device, guide.dtype
  _, _, wy0, wy1, yc0, yc1 = _spatial_taps(h, gh, dev, dt)
  _, _, wx0, wx1, xc0, xc1 = _spatial_taps(w, gw, dev, dt)

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


def bilateral_slice(grid, guide):
  """Trilinear slice of a bilateral grid (no affine apply).

  grid: (b, gh, gw, gd, C), guide: (b, h, w) -> (b, h, w, C).
  """
  _, z_w0, z_w1, z_c0, z_c1 = _depth_taps(guide, grid.shape[3])
  return _slice_channels(grid, guide, z_w0, z_w1, z_c0, z_c1)


def _extend_image(image, has_offset):
  """Appends the affine offset's implicit all-ones channel."""
  if not has_offset:
    return image
  ones = torch.ones(image.shape[:-1] + (1,), dtype=image.dtype,
                    device=image.device)
  return torch.cat([image, ones], dim=-1)


def bilateral_slice_apply(grid, guide, image, has_offset=True):
  """Slice + per-pixel affine apply (the HDRNet hot op).

  grid (b, gh, gw, gd, no, ni_tot), guide (b, h, w), image (b, h, w, n_in)
  -> (b, h, w, no). Reference: ops/bilateral_slice_apply.cc:24-82.
  """
  b, gh, gw, gd, no, ni_tot = grid.shape
  _, h, w = guide.shape
  sliced = bilateral_slice(grid.reshape(b, gh, gw, gd, no * ni_tot), guide)
  sliced = sliced.reshape(b, h, w, no, ni_tot)
  image_ext = _extend_image(image, has_offset)
  # An elementwise sum, not einsum: no TF32 matmul path on the card.
  return (sliced * image_ext[..., None, :]).sum(-1)
