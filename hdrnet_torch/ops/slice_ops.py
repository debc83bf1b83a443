"""Public, differentiable bilateral slice / slice-apply ops.

Batched, channels-last, with the API of ``hdrnet_tpu.ops.slice_ops``:

  bilateral_slice(grid, guide)
      grid (b, gh, gw, gd, C), guide (b, h, w) -> (b, h, w, C)
  bilateral_slice_apply(grid, guide, image, has_offset=True)
      grid (b, gh, gw, gd, no, ni_tot) or packed (b, gh, gw, gd, no*ni_tot),
      guide (b, h, w), image (b, h, w, n_in) -> (b, h, w, no)

The packed layout flattens (no, ni_tot) row-major (channel = i*ni_tot + j).

The gradient is the JAX package's custom VJP (the reference C++ op's),
not the derivative of the forward: its grid cotangent is a splat over the
mirror-padded image with the extreme depth weights forced to 1 (see
:mod:`hdrnet_torch.ops.reference`). The device picks the route: on CUDA
tensors the forward is kernel K3 and the backward kernels K4 (guide and
input) and K5 (grid); on CPU tensors their plain versions run
(:mod:`hdrnet_torch.ops.slice_apply`).
"""

from __future__ import annotations

import torch

from hdrnet_torch.ops import slice_apply as sa
from hdrnet_torch.utils.timing import span


class _SliceApply(torch.autograd.Function):
  """Packed-grid slice-apply whose backward is the reference VJP."""

  @staticmethod
  def forward(ctx, grid5, guide, image, has_offset, band):
    ctx.has_offset = has_offset
    ctx.band = band
    ctx.save_for_backward(grid5, guide, image)
    return sa.slice_apply_fwd(grid5, guide, image, has_offset, band)

  @staticmethod
  def backward(ctx, ct):
    grid5, guide, image = ctx.saved_tensors
    need_grid, need_guide, need_image = ctx.needs_input_grad[:3]
    ct = ct.contiguous()
    d_grid = d_guide = d_image = None
    if need_guide or need_image:
      d_guide, d_image = sa.slice_apply_pix_bwd(
          grid5, guide, image, ct, ctx.has_offset, need_input=need_image,
          band=ctx.band)
    if need_grid:
      d_grid = sa.slice_apply_grid_bwd(grid5.shape, guide, image, ct,
                                       ctx.has_offset, ctx.band)
    return d_grid, d_guide, d_image, None, None


def bilateral_slice_apply(grid, guide, image, has_offset=True, band=None):
  """Bilateral slice + per-pixel affine apply. Differentiable.

  Returns (b, h, w, no). band: None for a whole frame, else (y_off,
  h_total): the h rows are rows y_off .. y_off + h - 1 of a frame of
  h_total rows (a rank's H-band on a ``spatial`` mesh axis). The output
  and the guide and input cotangents are the band's rows of the whole
  frame's; the grid cotangent is the band's share of the frame's, so
  the shares of a frame's bands sum to it.
  """
  n_in = image.shape[-1]
  ni_tot = n_in + 1 if has_offset else n_in
  if grid.ndim == 6:
    if grid.shape[-1] != ni_tot:
      raise ValueError(f'grid input channels {grid.shape[-1]} != {ni_tot}')
    grid = grid.reshape(grid.shape[:4] + (-1,))
  elif grid.ndim != 5:
    raise ValueError(f'grid must be rank 5 or 6, got {tuple(grid.shape)}')
  elif not ni_tot or grid.shape[-1] % ni_tot:
    raise ValueError(
        f'packed grid channels {grid.shape[-1]} not divisible by {ni_tot}')
  with span('hdrnet.ops.slice_apply'):
    return _SliceApply.apply(grid.contiguous(), guide.contiguous(),
                             image.contiguous(), bool(has_offset),
                             None if band is None else tuple(band))


def bilateral_slice(grid, guide):
  """Batched trilinear slice: (b, gh, gw, gd, C), (b, h, w) -> (b, h, w, C).

  The slice-apply with a zero-channel input and an offset-only grid, as
  in the JAX package; its gradients are the reference BilateralSlice VJPs
  (ops/bilateral_slice.cc:72-168).
  """
  empty = guide.new_zeros(guide.shape + (0,))
  return bilateral_slice_apply(grid, guide, empty, has_offset=True)
