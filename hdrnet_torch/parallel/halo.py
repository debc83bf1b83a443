"""H-bands on the 'spatial' mesh axis, and the rows an op reads across
them (what GSPMD inserts for the JAX package's H-sharded training:
``hdrnet_tpu/parallel/mesh.py``'s spatial shardings, the halos of its
resizes and convolutions).

A frame of h rows is cut along H among the s ranks of a spatial group;
every coarser extent n of the same frame (a pyramid level, a stride-2
output) is cut the same way: rank j holds rows ``j * n // s`` ..
``(j + 1) * n // s - 1`` (``split``). A tensor on a rank holds exactly
its band's rows of its extent, before and after every op: an op that
reads rows of other bands (a resize, a k x k convolution) first
``exchange``s them, computes its band's output rows, and drops them.

  * ``Band``: this rank's band of one extent, with its group; ``at(n)``
    gives the band of another extent.
  * The row arithmetic (no process group): ``conv_source_rows`` (a
    k x k convolution at a stride and a rate; a resize's are
    ``ops.resize``'s ``*_source_rows``, from its float64 tables).
  * ``exchange``: a band's rows plus the rows of other bands it needs,
    differentiable; its backward returns each row's cotangent to the
    rank that owns it, which adds it to its own.
  * ``resize_bilinear`` and ``resize_nearest``: ``ops.resize``'s on a
    band, through ``exchange``: bit for bit the whole frame's rows.
  * ``gather_rows``: rows of the whole frame on every rank of the group
    (a frame-wide nearest downsample), differentiable.

The collectives are ``all_reduce`` sums only (``parallel.collectives``):
each rank writes the rows it owns into the slots of the ranks that need
them, in a zeroed buffer, and the sum over the group fills every slot.
Every rank of a group computes every rank's needs, so every rank enters
every collective, in the same order, or none does (an op whose needs
stay within the bands runs none).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from hdrnet_torch.ops import resize
from hdrnet_torch.parallel.collectives import all_reduce


def split(n, count):
  """[(lo, hi)] of the `count` bands of an extent of n rows; raises
  ValueError where a band would be empty."""
  if n < count:
    raise ValueError(f'an extent of {n} rows cut {count} ways along H '
                     'leaves a band empty: use a smaller spatial degree')
  return [(j * n // count, (j + 1) * n // count) for j in range(count)]


class Band(tuple):
  """Rank `index` of `count`'s rows of an extent of `h_total` rows, on
  the spatial process group `group` (None: the shares alone, with no
  exchange). The tuple is (y_off, h_total), the slice ops' band argument
  (``ops.slice_ops.bilateral_slice_apply(band=)``)."""

  def __new__(cls, index, count, h_total, group=None):
    lo, _ = split(h_total, count)[index]
    band = super().__new__(cls, (lo, h_total))
    band.index, band.count, band.group = index, count, group
    return band

  @property
  def h_total(self):
    return self[1]

  @property
  def lo(self):
    return self[0]

  @property
  def hi(self):
    return self.bounds()[self.index][1]

  @property
  def rows(self):
    return slice(self.lo, self.hi)

  def bounds(self):
    """[(lo, hi)] of every rank of the group, in rank order."""
    return split(self.h_total, self.count)

  def at(self, n):
    """This rank's band of an extent of n rows."""
    return Band(self.index, self.count, n, self.group)

  def __repr__(self):
    return (f'Band(rows {self.lo}..{self.hi - 1} of {self.h_total}, '
            f'{self.index} of {self.count})')


def require_group(band, what):
  """Raises ValueError unless `band` is a ``Band`` on a process group:
  `what` reads rows of other bands, which only the group can supply (a
  bare (y_off, h_total) band serves only the pointwise ops)."""
  if not isinstance(band, Band) or band.group is None:
    raise ValueError(
        f'{what} reads rows of the neighbouring H-bands: its band must be '
        f'a parallel.halo.Band on a spatial process group (Mesh.band), '
        f'not {band!r}')


def conv_source_rows(lo, hi, stride, span, pad_lo):
  """[a, b): the input rows that output rows lo .. hi - 1 of a
  convolution read, its kernel spanning `span` rows (rate * (k - 1) + 1)
  and its input padded by pad_lo rows at the top. Not clipped: rows
  outside the input are its zero padding."""
  a = lo * stride - pad_lo
  return a, (hi - 1) * stride - pad_lo + span


def _halo_ranges(need, own):
  """The rows of `need` ([a, b)) above and below `own` ([lo, hi)): two
  (start, stop) ranges, possibly empty."""
  (a, b), (lo, hi) = need, own
  return (a, max(a, min(b, lo))), (min(b, max(a, hi)), b)


def _owned(rng, own):
  """The rows of `rng` that `own` holds: (start, stop), possibly empty."""
  return max(rng[0], own[0]), min(rng[1], own[1])


class _Exchange(torch.autograd.Function):
  """x (this rank's band's rows along `dim`) -> rows needs[index] of the
  extent, taken from their owners. The buffer holds two slots a rank
  (the rows above its band, those below), each as tall as the tallest
  halo of the group."""

  @staticmethod
  def forward(ctx, x, band, needs, dim):
    bounds = band.bounds()
    halos = [_halo_ranges(n, o) for n, o in zip(needs, bounds)]
    depth = max(q - p for pair in halos for p, q in pair)
    ctx.band, ctx.needs, ctx.dim, ctx.halos, ctx.depth = (
        band, needs, dim, halos, depth)
    own = bounds[band.index]
    (above, below), need = halos[band.index], needs[band.index]
    u, v = _owned(need, own)
    mine = (x.narrow(dim, u - own[0], v - u) if v > u
            else x.narrow(dim, 0, 0))
    if not depth:
      return mine.clone()
    buf = _slots(x, band.count, depth, dim)
    for r, pair in enumerate(halos):
      for side, (p, q) in enumerate(pair):
        s, t = _owned((p, q), own)
        if s < t:
          buf[r, side].narrow(dim, s - p, t - s).copy_(
              x.narrow(dim, s - own[0], t - s))
    dist.all_reduce(buf, group=band.group)
    me = buf[band.index]
    return torch.cat([me[0].narrow(dim, 0, above[1] - above[0]), mine,
                      me[1].narrow(dim, 0, below[1] - below[0])], dim)

  @staticmethod
  def backward(ctx, g):
    band, dim, halos, depth = ctx.band, ctx.dim, ctx.halos, ctx.depth
    own = band.bounds()[band.index]
    (above, below), (a, _) = halos[band.index], ctx.needs[band.index]
    u, v = _owned(ctx.needs[band.index], own)
    shape = list(g.shape)
    shape[dim] = own[1] - own[0]
    ct = g.new_zeros(shape)
    if v > u:
      ct.narrow(dim, u - own[0], v - u).copy_(g.narrow(dim, u - a, v - u))
    if not depth:
      return ct, None, None, None
    buf = _slots(g, band.count, depth, dim)
    for side, (p, q) in enumerate((above, below)):
      if q > p:
        buf[band.index, side].narrow(dim, 0, q - p).copy_(
            g.narrow(dim, p - a, q - p))
    dist.all_reduce(buf, group=band.group)
    # Each halo row's cotangent is added to its owner's, rank by rank.
    for r, pair in enumerate(halos):
      for side, (p, q) in enumerate(pair):
        s, t = _owned((p, q), own)
        if s < t:
          ct.narrow(dim, s - own[0], t - s).add_(
              buf[r, side].narrow(dim, s - p, t - s))
    return ct, None, None, None


def _slots(x, count, depth, dim):
  shape = list(x.shape)
  shape[dim] = depth
  return x.new_zeros([count, 2] + shape)


def exchange(x, band, needs, dim):
  """Rows needs[band.index] = [a, b) of `band`'s extent along `dim`, from
  x, this rank's band's rows: the band's own rows in that range and the
  other bands' rows, taken from their owners. needs: every rank's [a, b)
  in rank order, within the extent; every rank of the group calls it
  with the same needs. Differentiable."""
  require_group(band, 'exchange')
  needs = [(max(int(a), 0), min(int(b), band.h_total)) for a, b in needs]
  return _Exchange.apply(x, band, needs, dim)


def _resize(x, size, band, source_rows, resize_rows):
  """A resize of x, `band`'s rows, to the whole extent `size`: the source
  rows of every rank's output band (``source_rows(lo, hi)``) exchanged,
  then this band's output rows (``resize_rows(x, a, lo, hi)``, x holding
  rows a ..)."""
  h, w = size
  if band.h_total == h and x.shape[-2] == w:
    return x
  out = band.at(h)
  needs = [source_rows(lo, hi) for lo, hi in out.bounds()]
  x = exchange(x, band, needs, x.ndim - 3)
  return resize_rows(x, needs[band.index][0], out.lo, out.hi)


def resize_bilinear(x, size, align_corners=False, band=None):
  """``ops.resize.resize_bilinear`` on the (-3, -2) axes of x, `band`'s
  rows (None: the whole frame); size is the whole output's and the result
  the output band's rows (``band.at(size[0])``)."""
  if band is None:
    return resize.resize_bilinear(x, size, align_corners)
  require_group(band, 'resize_bilinear')
  n_in = band.h_total
  return _resize(
      x, size, band,
      lambda lo, hi: resize.bilinear_source_rows(n_in, size[0],
                                                 align_corners, lo, hi),
      lambda x, a, lo, hi: resize.resize_bilinear_rows(
          x, a, n_in, size, align_corners, lo, hi))


def resize_nearest(x, size, band=None):
  """``ops.resize.resize_nearest`` on a band, as ``resize_bilinear``."""
  if band is None:
    return resize.resize_nearest(x, size)
  require_group(band, 'resize_nearest')
  n_in = band.h_total
  return _resize(
      x, size, band,
      lambda lo, hi: resize.nearest_source_rows(n_in, size[0], lo, hi),
      lambda x, a, lo, hi: resize.resize_nearest_rows(x, a, n_in, size, lo,
                                                      hi))


def gather_rows(x, band, rows, dim):
  """Rows `rows` (indices into `band`'s extent) of the whole frame along
  `dim`, the same on every rank of the group: each rank writes the rows
  it owns into a zeroed tensor, and the sum over the group gathers them.
  In backward each rank takes the group's summed cotangent of its own
  rows."""
  require_group(band, 'gather_rows')
  rows = np.asarray(rows)
  pos = np.nonzero((rows >= band.lo) & (rows < band.hi))[0]
  shape = list(x.shape)
  shape[dim] = len(rows)
  # A rank that owns none of the rows still writes (nothing) through
  # autograd, so that it enters the all-reduce's backward with the others.
  src = torch.as_tensor(rows[pos] - band.lo, device=x.device)
  buf = x.new_zeros(shape).index_copy(
      dim, torch.as_tensor(pos, device=x.device), x.index_select(dim, src))
  return all_reduce(buf, band.group)
