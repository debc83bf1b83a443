"""Train state and train / eval steps (counterpart of
``hdrnet_tpu.training.step``).

Adam on an l2 loss, with the batch-norm running statistics updated by the
forward in training mode (they live in the model's buffers), and
EMA(0.99)-smoothed loss and psnr for display (reference: bin/train.py:
89-125). The JAX steps are pure functions of (state, batch); these update
the state in place and return it, since PyTorch's modules and optimizers
are stateful.

The whole step runs under :func:`full_float32`: cuDNN's forward and
backward convolutions default to TF32 on the card, and the JAX package
trains in full float32.

On a mesh (``hdrnet_torch.parallel.mesh``; ``make_train_step(mesh=)``)
the step takes this rank's share of the batch and its H-band, and is the
one-process step of the global batch: each rank's loss is its part of
the global mean, the gradients are summed over the mesh in one flat
all-reduce after ``backward`` (a sum, not DDP's average: a spatial
band's gradient is a part, not a sample), the batch norms reduce over
their groups, and the metrics and EMAs are the global ones.

With a profiler recording, a step's phases are the spans
``hdrnet.train.forward`` (normalize, learning rates, forward, loss),
``hdrnet.train.backward`` (with the mesh's gradient all-reduce),
``hdrnet.train.optimizer`` and ``hdrnet.train.metrics``.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from hdrnet_torch.inference import full_float32
from hdrnet_torch.parallel.collectives import (all_reduce, all_reduce_grads,
                                               all_reduce_sum_)
from hdrnet_torch.training import metrics
from hdrnet_torch.utils.timing import span


@dataclasses.dataclass
class TrainState:
  step: int
  model: nn.Module
  optimizer: torch.optim.Optimizer
  ema_loss: torch.Tensor  # EMA(0.99) display metrics, 0-dim on the device
  ema_psnr: torch.Tensor
  # lr at optimizer step `count`, before any per-group scale; None holds
  # each group's lr constant.
  schedule: object = None
  # Where train() took its batches from: 'device' (the resident dataset,
  # hdrnet_torch.data.device) or 'host' (the host pipeline); the eval
  # batches' route, None without evaluation; the resident dataset's bytes.
  data_route: str = 'host'
  eval_data_route: str = None
  resident_bytes: int = 0


def create_state(model, optimizer, schedule=None):
  dev = next(model.parameters()).device
  return TrainState(step=0, model=model, optimizer=optimizer,
                    ema_loss=torch.zeros((), device=dev),
                    ema_psnr=torch.zeros((), device=dev), schedule=schedule)


def to_device(batch, device):
  """numpy batch dict -> tensors on `device` in their storage dtype; on a
  CUDA device through pinned memory, with copies that do not block."""
  out = {}
  for k, v in batch.items():
    t = torch.from_numpy(v)
    if torch.device(device).type == 'cuda':
      t = t.pin_memory().to(device, non_blocking=True)
    else:
      t = t.to(device)
    out[k] = t
  return out


def normalize_batch(batch):
  """[0, 1] normalization of storage-dtype batches, on their device: the
  train step multiplies by the float32 reciprocal of the white level, as
  the JAX step does (u8: x * (1/255), u16: x * (1/65535)). Float tensors
  pass through."""
  def norm(x):
    if x.dtype == torch.uint8:
      return x.to(torch.float32) * (1.0 / 255.0)
    if x.dtype == torch.uint16:
      return x.to(torch.float32) * (1.0 / 65535.0)
    return x
  return {k: norm(v) for k, v in batch.items()}


def set_learning_rates(state):
  """The schedule's value at the optimizer's update count, times each
  group's ``lr_scale``: optax evaluates the schedule at the count of
  updates so far, so the first update uses schedule(0)."""
  if state.schedule is None:
    return
  lr = state.schedule(state.step)
  for group in state.optimizer.param_groups:
    group['lr'] = lr * group.get('lr_scale', 1.0)


def guide_range_hinge(guide, target, mesh=None):
  """mean over images of relu(target - std(guide))^2, std with ddof 0
  over each image's pixels. With a mesh, this rank's part of the global
  mean: each image's sums (of g and its pixel count, then of
  (g - mean)^2) are summed over 'spatial' with the autograd all-reduce
  (a pyramid level's bands may hold different counts), and the part is
  the sum of its images' hinges over the global image count times the
  spatial degree (the spatial ranks hold the same images)."""
  g = guide.reshape(guide.shape[0], -1)
  if mesh is None:
    std = g.std(dim=1, correction=0)
    return torch.mean(torch.relu(target - std) ** 2)
  b = g.shape[0]
  sums = all_reduce(torch.cat([g.sum(dim=1), g.new_full((1,), g.shape[1])]),
                    mesh.spatial_group)
  n = sums[b]
  mean = sums[:b] / n
  var = all_reduce(torch.square(g - mean[:, None]).sum(dim=1),
                   mesh.spatial_group) / n
  hinge = torch.relu(target - torch.sqrt(var)) ** 2
  return hinge.sum() / (g.shape[0] * mesh.data * mesh.spatial)


def top_level_guides(model, intermediates):
  """The guide maps a model sows at top level (one, or one a pyramid
  level); raises ValueError, naming the model, for one that sows none
  (the baselines, ``HDRNetGaussianPyr``, ``HDRNetStack``), where the JAX
  step fails with a KeyError."""
  guides = intermediates.get('guide_map')
  if not guides:
    raise ValueError(
        f'guide_reg > 0: {type(model).__name__} has no top-level guide '
        f'map to regularize; train it with guide_reg 0')
  return guides


def make_train_step(ema_decay=0.99, guide_reg=0.0, guide_reg_target=0.2,
                    mesh=None):
  """Returns step(state, batch, band=None) -> (state, metrics dict of 0-dim
  tensors).

  batch: tensors with the keys lowres_input, lowres_output (unused by the
  loss, as in the reference), image_input, image_output; integer dtypes
  are normalized on the device. guide_reg > 0 adds the guide-range hinge
  guide_reg * relu(guide_reg_target - std(guide))^2 to the loss; for a
  model with several guide maps (the pyramid's levels), the mean of the
  maps' hinges, as the JAX step takes it. It reads the guide maps the
  model sows at top level (``top_level_guides``), so a model with none
  raises ValueError.

  mesh: None for one process; else this rank's Mesh, with `batch` its
  share and `band` its H-band (``parallel.mesh.shard_batch``), and the
  model readied by ``parallel.mesh.replicate``. Every rank of the mesh
  must call the step together.
  """

  def step(state, batch, band=None):
    model, opt = state.model, state.optimizer
    kw = {} if band is None else {'band': band}
    with full_float32():
      with span('hdrnet.train.forward'):
        batch = normalize_batch(batch)
        model.train()
        set_learning_rates(state)
        target = batch['image_output']
        if guide_reg > 0.0:
          out, inter = model.forward_with_intermediates(
              batch['lowres_input'], batch['image_input'], **kw)
          guides = top_level_guides(model, inter)
          hinges = [guide_range_hinge(g, guide_reg_target, mesh)
                    for g in guides]
          loss = (metrics.l2_loss(target, out, mesh)
                  + guide_reg * sum(hinges) / len(hinges))
        else:
          out = model(batch['lowres_input'], batch['image_input'], **kw)
          loss = metrics.l2_loss(target, out, mesh)
      with span('hdrnet.train.backward'):
        opt.zero_grad(set_to_none=True)
        loss.backward()
        if mesh is not None:
          all_reduce_grads(model.parameters(), mesh.group)
      with span('hdrnet.train.optimizer'):
        opt.step()
    with span('hdrnet.train.metrics'):
      loss = loss.detach()
      if mesh is not None:
        loss = all_reduce_sum_(loss.clone(), mesh.group)
      p = metrics.psnr(target, out.detach(), mesh)
      if state.step == 0:
        state.ema_loss, state.ema_psnr = loss, p
      else:
        d = ema_decay
        state.ema_loss = d * state.ema_loss + (1 - d) * loss
        state.ema_psnr = d * state.ema_psnr + (1 - d) * p
    state.step += 1
    return state, {'loss': loss, 'psnr': p, 'ema_loss': state.ema_loss,
                   'ema_psnr': state.ema_psnr}

  return step


def make_eval_step():
  """Returns step(state, batch) -> {'loss', 'psnr'}, with BN in eval mode."""

  @torch.no_grad()
  def step(state, batch):
    batch = normalize_batch(batch)
    model = state.model
    model.eval()
    with full_float32():
      out = model(batch['lowres_input'], batch['image_input'])
    target = batch['image_output']
    return {'loss': metrics.l2_loss(target, out),
            'psnr': metrics.psnr(target, out)}

  return step
