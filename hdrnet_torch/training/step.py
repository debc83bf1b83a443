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
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from hdrnet_torch.inference import full_float32
from hdrnet_torch.training import metrics


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


def guide_range_hinge(guide, target):
  """mean over images of relu(target - std(guide))^2, std with ddof 0
  over each image's pixels."""
  std = guide.reshape(guide.shape[0], -1).std(dim=1, correction=0)
  return torch.mean(torch.relu(target - std) ** 2)


def make_train_step(ema_decay=0.99, guide_reg=0.0, guide_reg_target=0.2):
  """Returns step(state, batch) -> (state, metrics dict of 0-dim tensors).

  batch: tensors with the keys lowres_input, lowres_output (unused by the
  loss, as in the reference), image_input, image_output; integer dtypes
  are normalized on the device. guide_reg > 0 adds the guide-range hinge
  guide_reg * relu(guide_reg_target - std(guide))^2 to the loss; for a
  model with several guide maps (the pyramid's levels), the mean of the
  maps' hinges, as the JAX step takes it.
  """

  def step(state, batch):
    batch = normalize_batch(batch)
    model, opt = state.model, state.optimizer
    model.train()
    set_learning_rates(state)
    with full_float32():
      out, guide = model(batch['lowres_input'], batch['image_input'],
                         return_guide=True)
      target = batch['image_output']
      loss = metrics.l2_loss(target, out)
      if guide_reg > 0.0:
        guides = guide if isinstance(guide, (list, tuple)) else [guide]
        hinges = [guide_range_hinge(g, guide_reg_target) for g in guides]
        loss = loss + guide_reg * sum(hinges) / len(hinges)
      opt.zero_grad(set_to_none=True)
      loss.backward()
      opt.step()
    loss = loss.detach()
    p = metrics.psnr(target, out.detach())
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
