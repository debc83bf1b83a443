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

A resize computes output rows lo .. hi - 1 from the input rows a .. that
hold their sources (``resize_*_rows``; ``*_source_rows`` names them, from
the whole extents' tables), bit for bit the whole resize's rows; the
whole resize is the rows [0, h) of the whole input. Mesh training's
'spatial' axis resizes H-bands this way (``parallel.halo``).
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

# The lists of ``holding_tables`` blocks open now, innermost last.
_holders = []


@contextlib.contextmanager
def holding_tables():
  """Inside the block, each table that a ``device_table_cache`` hands out
  is also appended to the list this yields. A CUDA graph's capture keeps
  the tables its launches read: a replay reads them long after the cache
  may have dropped them."""
  _holders.append([])
  try:
    yield _holders[-1]
  finally:
    _holders.pop()


def device_table_cache(maxsize):
  """``functools.lru_cache(maxsize)`` for a function that builds tables on
  a device; each lookup's result is also held by ``holding_tables``."""
  def wrap(build):
    cached = functools.lru_cache(maxsize=maxsize)(build)

    @functools.wraps(build)
    def lookup(*args, **kwargs):
      tables = cached(*args, **kwargs)
      if _holders:
        _holders[-1].append(tables)
      return tables
    lookup.cache_clear = cached.cache_clear
    return lookup
  return wrap


def _nearest_indices(n_in, n_out):
  scale = n_in / n_out
  idx = np.floor(np.arange(n_out) * scale).astype(np.int64)
  return np.clip(idx, 0, n_in - 1)


def _source_rows(tables, lo, hi):
  """[a, b): the input rows that outputs lo .. hi - 1 read, where
  table[y] is an input row that output y reads, for each of `tables`."""
  a = min(int(t[lo:hi].min()) for t in tables)
  return a, max(int(t[lo:hi].max()) for t in tables) + 1


def _nearest_rows(n_in, n_out, a, lo, hi):
  """The floor table's outputs lo .. hi - 1 (None: n_out), as rows from
  input row a: int32."""
  return (_nearest_indices(n_in, n_out)[lo:hi] - a).astype(np.int32)


@device_table_cache(maxsize=64)
def nearest_index_tensor(n_in, n_out, device, a=0, lo=0, hi=None):
  """The floor table (of outputs lo .. hi - 1, as rows from input row a:
  ``_nearest_rows``) as an int32 tensor on `device`; cached, so a serving
  loop copies it to the card once per frame size. Callers must not
  write to it."""
  return torch.as_tensor(_nearest_rows(n_in, n_out, a, lo, hi),
                         device=device)


def _traceable_index(n_in, n_out, device, a=0, lo=0, hi=None):
  """``nearest_index_tensor``; while ``torch.export`` traces, a new tensor
  (the graph's own constant), since one made under tracing is a fake
  tensor that the cache would hand to the next trace."""
  if torch.compiler.is_compiling():
    return torch.as_tensor(_nearest_rows(n_in, n_out, a, lo, hi),
                           device=device)
  return nearest_index_tensor(n_in, n_out, device, a, lo, hi)


def resize_nearest(x, size):
  """Legacy TF1 nearest-neighbor resize on the (-3, -2) axes."""
  h, w = size
  if x.shape[-3] == h and x.shape[-2] == w:
    return x
  return resize_nearest_rows(x, 0, x.shape[-3], size, 0, h)


def nearest_source_rows(n_in, n_out, lo, hi):
  """[a, b): the input rows that output rows lo .. hi - 1 of a nearest
  resize n_in -> n_out read."""
  return _source_rows([_nearest_indices(n_in, n_out)], lo, hi)


def resize_nearest_rows(x, a, n_in, size, lo, hi):
  """Output rows lo .. hi - 1 of the nearest resize of an extent of n_in
  rows to `size`, from x, which holds input rows a .. (at least those
  ``nearest_source_rows`` names)."""
  iy = _traceable_index(n_in, size[0], x.device, a, lo, hi)
  ix = _traceable_index(x.shape[-2], size[1], x.device)
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


@device_table_cache(maxsize=256)
def linear_tap_tensors(n_in, n_out, align_corners, device, a=0, b=None,
                       lo=0, hi=None):
  """(i0, i1, frac, src0, src1) of one axis on `device`, for outputs lo ..
  hi - 1 (None: n_out) read from input rows a .. b - 1 (None: n_in),
  indexed from a: the int64 source indices and float32 blend weight of
  each output, from the whole extents' tables, and for the backward the
  outputs that read each input through i0 and through i1
  (``_sources_of``); cached like ``nearest_index_tensor``. Callers must
  not write to them."""
  i0, i1, frac = _linear_taps(n_in, n_out, align_corners)
  i0, i1, n = i0[lo:hi] - a, i1[lo:hi] - a, (n_in if b is None else b) - a
  return tuple(torch.as_tensor(t, device=device) for t in
               (i0, i1, frac[lo:hi], _sources_of(i0, n), _sources_of(i1, n)))


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
  a fixed order. Under ``torch.export`` the call is recorded as
  ``hdrnet::resize_bilinear`` (forward only), so that an exported graph
  can take a frame of any size: the tap tables are computed when it runs.
  """
  if torch.compiler.is_compiling():
    return torch.ops.hdrnet.resize_bilinear(x, size[0], size[1],
                                            align_corners)
  return _resize_bilinear(x, size, align_corners)


@torch.library.custom_op('hdrnet::resize_bilinear', mutates_args=(),
                         device_types=('cpu', 'cuda'))
def _resize_bilinear_op(x: torch.Tensor, h: int, w: int,
                        align_corners: bool) -> torch.Tensor:
  out = _resize_bilinear(x, (h, w), align_corners)
  return out.clone() if out is x else out  # an op's output is its own


@_resize_bilinear_op.register_fake
def _(x, h, w, align_corners):
  del align_corners
  return x.new_empty((*x.shape[:-3], h, w, x.shape[-1]))


def _resize_bilinear(x, size, align_corners):
  h, w = size
  if x.shape[-3] == h and x.shape[-2] == w:
    return x
  return resize_bilinear_rows(x, 0, x.shape[-3], size, align_corners, 0, h)


def bilinear_source_rows(n_in, n_out, align_corners, lo, hi):
  """[a, b): the input rows that output rows lo .. hi - 1 of a bilinear
  resize n_in -> n_out read (both taps, from the whole extents'
  tables)."""
  return _source_rows(_linear_taps(n_in, n_out, align_corners)[:2], lo, hi)


def resize_bilinear_rows(x, a, n_in, size, align_corners, lo, hi):
  """Output rows lo .. hi - 1 of the bilinear resize of an extent of n_in
  rows to `size`, from x, which holds input rows a .. a + x.shape[-3] - 1
  (at least those ``bilinear_source_rows`` names): bit for bit the whole
  resize's rows."""
  w = size[1]
  ty = linear_tap_tensors(n_in, size[0], align_corners, x.device, a,
                          a + x.shape[-3], lo, hi)
  tx = linear_tap_tensors(x.shape[-2], w, align_corners, x.device)
  fy = ty[2].to(x.dtype).reshape(hi - lo, 1, 1)  # over (..., rows, W, C)
  fx = tx[2].to(x.dtype).reshape(w, 1)           # over (..., H, w, C)
  x = _Lerp.apply(x, x.ndim - 3, ty, fy)
  return _Lerp.apply(x, x.ndim - 2, tx, fx)
