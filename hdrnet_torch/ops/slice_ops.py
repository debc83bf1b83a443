"""Public bilateral slice / slice-apply ops (forward).

Batched, channels-last, with the API of ``hdrnet_tpu.ops.slice_ops``:

  bilateral_slice(grid, guide)
      grid (b, gh, gw, gd, C), guide (b, h, w) -> (b, h, w, C)
  bilateral_slice_apply(grid, guide, image, has_offset=True)
      grid (b, gh, gw, gd, no, ni_tot) or packed (b, gh, gw, gd, no*ni_tot),
      guide (b, h, w), image (b, h, w, n_in) -> (b, h, w, no)

The packed layout flattens (no, ni_tot) row-major (channel = i*ni_tot + j).

Only the ``reference`` backend exists so far: the plain-torch forward of
:mod:`hdrnet_torch.ops.reference`, which the composite
``HDRNetCurves.forward`` uses. The CUDA slice-apply with an external
guide (kernel K3, the training forward of
``hdrnet_tpu.ops.pallas.slice_apply_fwd``) and its gradients are not
ported yet; serving goes through :mod:`hdrnet_torch.ops.fused` instead.
"""

from __future__ import annotations

import torch

from hdrnet_torch.ops import reference as ref


def _require_cpu(*tensors):
  for t in tensors:
    if t.device.type != 'cpu':
      raise NotImplementedError(
          'bilateral_slice_apply on a CUDA tensor needs kernel K3 (the '
          'slice-apply training forward, hdrnet_tpu/ops/pallas.py '
          'slice_apply_fwd), which is not ported yet; serve with '
          'hdrnet_torch.inference.Enhancer')


def bilateral_slice_apply(grid, guide, image, has_offset=True):
  """Bilateral slice + per-pixel affine apply. Returns (b, h, w, no)."""
  _require_cpu(grid, guide, image)
  if grid.ndim == 5:
    n_in = image.shape[-1]
    ni_tot = n_in + 1 if has_offset else n_in
    if grid.shape[-1] % ni_tot:
      raise ValueError(
          f'packed grid channels {grid.shape[-1]} not divisible by {ni_tot}')
    grid = grid.reshape(grid.shape[:-1] + (grid.shape[-1] // ni_tot, ni_tot))
  elif grid.ndim != 6:
    raise ValueError(f'grid must be rank 5 or 6, got {tuple(grid.shape)}')
  return ref.bilateral_slice_apply(grid, guide, image, has_offset=has_offset)


def bilateral_slice(grid, guide):
  """Batched trilinear slice: (b, gh, gw, gd, C), (b, h, w) -> (b, h, w, C)."""
  _require_cpu(grid, guide)
  return ref.bilateral_slice(grid, guide)
