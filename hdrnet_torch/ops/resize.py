"""Nearest and bilinear resizes with the sampling conventions of
``hdrnet_tpu.ops.resize``.

Nearest: the legacy TF1 table ``src = floor(dst * in / out)``, clipped.
Bilinear: ``src = dst * in / out`` (legacy TF1, ``align_corners=False``)
or ``src = dst * (in - 1) / (out - 1)`` (``align_corners=True``, the
Gaussian pyramid's), blended as ``a + (b - a) * frac``, rows first and
then columns. All tables are computed in float64 on the host:
``F.interpolate`` computes positions in float32 and blends in another
form, so it can pick another source row or round another way. Operates
on (..., H, W, C) tensors; the bilinear resize is differentiable.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _nearest_indices(n_in, n_out):
  scale = n_in / n_out
  idx = np.floor(np.arange(n_out) * scale).astype(np.int64)
  return np.clip(idx, 0, n_in - 1)


@functools.lru_cache(maxsize=64)
def nearest_index_tensor(n_in, n_out, device):
  """The floor table as an int32 tensor on `device`; cached, so a serving
  loop copies it to the card once per frame size. Callers must not
  write to it."""
  return torch.as_tensor(_nearest_indices(n_in, n_out).astype(np.int32),
                         device=device)


def resize_nearest(x, size):
  """Legacy TF1 nearest-neighbor resize on the (-3, -2) axes."""
  h, w = size
  if x.shape[-3] == h and x.shape[-2] == w:
    return x
  iy = nearest_index_tensor(x.shape[-3], h, x.device)
  ix = nearest_index_tensor(x.shape[-2], w, x.device)
  x = torch.index_select(x, x.ndim - 3, iy)
  return torch.index_select(x, x.ndim - 2, ix)


def _linear_taps(n_in, n_out, align_corners):
  if align_corners and n_out > 1:
    src = np.arange(n_out) * ((n_in - 1) / max(n_out - 1, 1))
  else:
    src = np.arange(n_out) * (n_in / n_out)
  i0 = np.floor(src).astype(np.int64)
  frac = (src - i0).astype(np.float32)
  i0 = np.clip(i0, 0, n_in - 1)
  i1 = np.clip(i0 + 1, 0, n_in - 1)
  return i0, i1, frac


def _sources_of(idx, n_in):
  """(n_in, k) table: row j lists, in ascending order, the outputs whose
  tap `idx` reads input j, padded with len(idx) (a zero row appended to
  the cotangent); k is the largest fan-in."""
  n_out = len(idx)
  counts = np.bincount(idx, minlength=n_in)
  table = np.full((n_in, max(int(counts.max()), 1)), n_out, np.int64)
  order = np.argsort(idx, kind='stable')
  starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
  table[idx[order], np.arange(n_out) - starts[idx[order]]] = order
  return table


@functools.lru_cache(maxsize=64)
def linear_tap_tensors(n_in, n_out, align_corners, device):
  """(i0, i1, frac, src0, src1) of one axis on `device`: the int64 source
  indices and float32 blend weight of each output, and for the backward
  the outputs that read each input through i0 and through i1
  (``_sources_of``); cached like ``nearest_index_tensor``. Callers must
  not write to them."""
  i0, i1, frac = _linear_taps(n_in, n_out, align_corners)
  return tuple(torch.as_tensor(a, device=device) for a in
               (i0, i1, frac, _sources_of(i0, n_in), _sources_of(i1, n_in)))


class _Lerp(torch.autograd.Function):
  """a + (b - a) * frac with a, b the rows of x at i0, i1 along `dim`.

  The backward gathers each input's cotangent from the outputs that read
  it, in a fixed order, instead of index_select's scatter-add (atomics
  on the card, so the sums would change from run to run)."""

  @staticmethod
  def forward(ctx, x, dim, taps, frac):
    i0, i1, _, src0, src1 = taps
    ctx.dim, ctx.src, ctx.frac = dim, (src0, src1), frac
    a = torch.index_select(x, dim, i0)
    b = torch.index_select(x, dim, i1)
    return a + (b - a) * frac

  @staticmethod
  def backward(ctx, g):
    dim, frac = ctx.dim, ctx.frac
    g_b = g * frac
    g_a = g - g_b  # d/da of a + (b - a) * frac, as autograd forms it
    pad = g.new_zeros(g.shape[:dim] + (1,) + g.shape[dim + 1:])
    grad = None
    for g_tap, src in zip((g_a, g_b), ctx.src):
      g_tap = torch.cat([g_tap, pad], dim)
      for k in range(src.shape[1]):
        term = torch.index_select(g_tap, dim, src[:, k])
        grad = term if grad is None else grad + term
    return grad, None, None, None


def resize_bilinear(x, size, align_corners=False):
  """Separable bilinear resize on the (-3, -2) axes; its gradient sums in
  a fixed order."""
  h, w = size
  if x.shape[-3] == h and x.shape[-2] == w:
    return x
  ty = linear_tap_tensors(x.shape[-3], h, align_corners, x.device)
  tx = linear_tap_tensors(x.shape[-2], w, align_corners, x.device)
  fy = ty[2].to(x.dtype).reshape(h, 1, 1)  # broadcast over (..., h, W, C)
  fx = tx[2].to(x.dtype).reshape(w, 1)     # broadcast over (..., H, w, C)
  x = _Lerp.apply(x, x.ndim - 3, ty, fy)
  return _Lerp.apply(x, x.ndim - 2, tx, fx)
