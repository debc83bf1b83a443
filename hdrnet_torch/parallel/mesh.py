"""The ('data', 'spatial') mesh of training processes (counterpart of
``hdrnet_tpu.parallel.mesh``), on ``torch.distributed``.

One process a rank, each with its own copy of the model:
  * 'data': the batch is cut into rows, one share a data coordinate;
  * 'spatial': full-resolution images (``FULLRES_KEYS``) are further cut
    along H, one band a spatial coordinate (``Mesh.band``, a
    ``parallel.halo.Band`` on the spatial group). The guide and the
    slice-apply are pointwise given the grid, so they need no rows of the
    neighbouring bands: they take the band's row offset and the frame's
    height (``ops.slice_ops.bilateral_slice_apply(band=...)``), at every
    pyramid level its own. The resizes and the k x k convolutions of the
    pyramids, the zoo and the baselines read rows of the neighbouring
    bands, which ``parallel.halo`` exchanges (the halos GSPMD inserts in
    JAX). The low-resolution inputs are cut over 'data' only and
    replicated across 'spatial' (each spatial rank computes the same
    grid).

Rank r of a (d, s) mesh sits at (r // s, r % s): 'spatial' last, as in
the JAX mesh. Ranks at or past d * s sit out. The gradients are summed
over the whole mesh (each rank's loss is its share of the global mean),
the batch norms reduce their statistics over 'data' (a coefficient
backbone's, on low-res inputs) or over the whole mesh (a full-resolution
guide's or layer's), and the step's metrics are the global ones, so every
rank holds the same parameters, statistics and metrics after each step.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import torch
import torch.distributed as dist

from hdrnet_torch.models.layers import CenterBatchNorm
from hdrnet_torch.ops.reference import mirror_pad
from hdrnet_torch.parallel import halo
from hdrnet_torch.parallel.collectives import broadcast_

DATA_AXIS = 'data'
SPATIAL_AXIS = 'spatial'

# Batch keys carrying full-resolution images (cut along H over 'spatial').
FULLRES_KEYS = ('image_input', 'image_output')

# A rank past the mesh waits at one barrier for the whole run.
SIT_OUT_TIMEOUT = datetime.timedelta(days=7)

_TORCHRUN_ENV = ('RANK', 'WORLD_SIZE', 'MASTER_ADDR', 'MASTER_PORT')


def _local_card():
  """cuda:{LOCAL_RANK % device_count} (the rank for LOCAL_RANK where
  torchrun did not set it)."""
  local = int(os.environ.get('LOCAL_RANK', os.environ.get('RANK', 0)))
  return torch.device('cuda', local % torch.cuda.device_count())


def rank_device(device='cuda'):
  """This rank's device for `device`: in a process group, a CUDA device
  with no index is the rank's card (``cuda:{LOCAL_RANK %
  device_count}``); any other device, or any device outside a group, is
  returned as it is."""
  device = torch.device(device)
  if (dist.is_initialized() and device.type == 'cuda'
      and device.index is None and torch.cuda.is_available()):
    return _local_card()
  return device


def initialize_distributed(backend=None):
  """Joins the process group from torchrun's environment (RANK,
  WORLD_SIZE, MASTER_ADDR, MASTER_PORT, and LOCAL_RANK for the card).

  backend: NCCL where CUDA is available, gloo on the CPU; 'gloo' may be
  named on CUDA, where it lets several ranks share one card (NCCL refuses
  two ranks on one device). Returns this rank's device
  (``rank_device()``, or the CPU without CUDA). A second call is a no-op.
  Raises, with the reason, outside such an environment or for NCCL
  without CUDA.
  """
  cuda = torch.cuda.is_available()
  if not dist.is_initialized():
    missing = [k for k in _TORCHRUN_ENV if k not in os.environ]
    if missing:
      raise RuntimeError(
          f'initialize_distributed: {", ".join(missing)} not set; start '
          'the ranks with torchrun (python -m torch.distributed.run '
          '--nproc_per_node N ...) or set them')
    backend = backend or ('nccl' if cuda else 'gloo')
    if backend == 'nccl' and not cuda:
      raise RuntimeError('initialize_distributed: NCCL needs CUDA, which is '
                         "not available; use backend='gloo' on the CPU")
    if cuda:
      torch.cuda.set_device(_local_card())
    dist.init_process_group(backend, init_method='env://')
  return _local_card() if cuda else torch.device('cpu')


def world_size():
  return dist.get_world_size() if dist.is_initialized() else 1


@dataclasses.dataclass
class Mesh:
  """This rank's view of a (data, spatial) mesh.

  coords: (data, spatial) coordinates, None for a rank past the mesh.
  data_group: the ranks of this spatial coordinate (one a data
  coordinate); spatial_group: the ranks of this data coordinate; group:
  the whole mesh; control: the whole mesh on gloo, for host decisions;
  world_control: every rank on gloo, for the barrier that the ranks past
  the mesh wait at. Groups of which this rank is not a member are not
  usable here.
  """
  shape: tuple
  rank: int
  coords: tuple
  data_group: object
  spatial_group: object
  group: object
  control: object
  world_control: object

  @property
  def data(self):
    return self.shape[0]

  @property
  def spatial(self):
    return self.shape[1]

  @property
  def size(self):
    return self.shape[0] * self.shape[1]

  @property
  def member(self):
    return self.coords is not None

  @property
  def lead(self):
    """The rank that writes files and decides for the others."""
    return self.rank == 0

  def rows(self, n):
    """This rank's rows of a batch of n: a slice."""
    if n % self.data:
      raise ValueError(f'batch_size {n} not divisible by data-parallel '
                       f'degree {self.data}')
    per = n // self.data
    return slice(self.coords[0] * per, (self.coords[0] + 1) * per)

  def band(self, h):
    """This rank's H-band of a frame of h rows: a ``halo.Band`` on the
    spatial group (a tuple (y_off, h)), or None for the whole frame
    (spatial degree 1)."""
    if self.spatial == 1:
      return None
    if h % self.spatial:
      raise ValueError(f'full-res height {h} not divisible by spatial mesh '
                       f'degree {self.spatial}')
    return halo.Band(self.coords[1], self.spatial, h, self.spatial_group)

  def agree(self, flag):
    """Rank 0's `flag` on every rank of the mesh (a broadcast on the
    control group): what the ranks decide by their own clocks must be
    decided once before any of them enters a collective for it."""
    t = torch.tensor([int(bool(flag))], dtype=torch.int64)
    dist.broadcast(t, src=0, group=self.control)
    return bool(t.item())

  def barrier(self):
    dist.barrier(group=self.control)


def coordinates(rank, mesh_shape):
  """The (data, spatial) coordinates of `rank` on a mesh of `mesh_shape`,
  None for a rank past it."""
  d, s = mesh_shape
  return divmod(rank, s) if rank < d * s else None


def make_mesh(mesh_shape=None):
  """This rank's (data, spatial) Mesh over the process group, None for one
  process with no group (a (1, 1) mesh, whose step runs no collective).

  mesh_shape: (n_data, n_spatial); by default every rank on 'data'. Every
  rank must call it, the ranks past the mesh too (they join its groups'
  creation and its last barrier). Raises for a mesh larger than the world.
  """
  world = world_size()
  d, s = (world, 1) if mesh_shape is None else (int(v) for v in mesh_shape)
  if d < 1 or s < 1:
    raise ValueError(f'mesh_shape {mesh_shape}: degrees must be >= 1')
  if d * s > world:
    raise ValueError(
        f'mesh {d}x{s} needs {d * s} processes; the world has {world} '
        '(start them with torchrun --nproc_per_node, or on one card with '
        "initialize_distributed(backend='gloo') in each)")
  if not dist.is_initialized():
    return None
  rank = dist.get_rank()
  n = d * s
  # Every rank creates every group, in the same order.
  data_groups = [dist.new_group([i * s + j for i in range(d)])
                 for j in range(s)]
  spatial_groups = [dist.new_group([i * s + j for j in range(s)])
                    for i in range(d)]
  group = dist.new_group(list(range(n)))
  control = dist.new_group(list(range(n)), backend='gloo')
  world_control = dist.new_group(list(range(world)), backend='gloo',
                                 timeout=SIT_OUT_TIMEOUT)
  coords = coordinates(rank, (d, s))
  return Mesh(shape=(d, s), rank=rank, coords=coords,
              data_group=data_groups[coords[1]] if coords else None,
              spatial_group=spatial_groups[coords[0]] if coords else None,
              group=group, control=control, world_control=world_control)


def shard_batch(mesh, batch):
  """This rank's share of a global batch dict (numpy arrays or tensors):
  its rows of every key, and of ``FULLRES_KEYS`` also its H-band.
  Returns (share, band), band as in ``Mesh.band``; (batch, None) without a
  mesh."""
  if mesh is None:
    return batch, None
  rows = mesh.rows(len(next(iter(batch.values()))))
  return take_band(mesh, {k: v[rows] for k, v in batch.items()})


def take_band(mesh, batch):
  """The H-band of ``FULLRES_KEYS`` of a batch of this rank's rows:
  (share, band), as ``shard_batch``."""
  if mesh is None:
    return batch, None
  h = {v.shape[1] for k, v in batch.items()
       if k in FULLRES_KEYS and v.ndim >= 3}
  if len(h) > 1:
    raise ValueError(f'full-res keys of different heights: {sorted(h)}')
  if not h:
    return batch, None
  band = mesh.band(h.pop())
  if band is None:
    return batch, None
  return {k: v[:, band.rows] if k in FULLRES_KEYS and v.ndim >= 3 else v
          for k, v in batch.items()}, band


def check_band_rows(h, spatial, grid_rows, levels=1):
  """Raises unless every H-band of a frame of h rows cut `spatial` ways,
  at each of `levels` pyramid levels that slice a grid of `grid_rows` rows
  (h, h // 2, ...; 0 for a model with no grid), is at least as tall as
  that level's grid VJP mirror padding (half a cell), which the first and
  last bands read from their own rows. A halo wider than a neighbouring
  band needs no check: ``halo.exchange`` takes rows from any band."""
  if spatial == 1:
    return
  n = h
  for level in range(levels):
    pad = mirror_pad(n, grid_rows)
    rows = min(hi - lo for lo, hi in halo.split(n, spatial))
    if rows < pad:
      where = (f'pyramid level {level}\'s {n} rows' if level
               else f'{n} rows')
      raise ValueError(
          f'spatial mesh degree {spatial} cuts {where} into bands of '
          f'{rows}, shorter than the grid VJP\'s mirror padding of {pad} '
          f'rows (half a cell of {n} / {grid_rows}); use a smaller spatial '
          'degree')
    n //= 2


def replicate(model, mesh):
  """Readies `model` for mesh training: each batch norm reduces its
  statistics over the group of its ``axis`` (a coefficient backbone's,
  on the low-res inputs cut over 'data' only, over 'data'; any other, on
  full-resolution pixels, over the whole mesh), and rank 0's parameters
  and buffers are copied to every rank. A no-op without a mesh."""
  if mesh is None:
    return model
  groups = {None: mesh.group, DATA_AXIS: mesh.data_group}
  for m in model.modules():
    if isinstance(m, CenterBatchNorm):
      m.process_group = groups[m.axis]
  with torch.no_grad():
    broadcast_(list(model.state_dict().values()), 0, mesh.group)
  return model
