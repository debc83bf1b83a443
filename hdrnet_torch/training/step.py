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

On a CUDA device with no mesh, the step's normalize, forward, loss,
backward and Adam are captured as one CUDA graph at the second call with
a batch of the same signature (keys, shapes, dtypes, device, and the
cuDNN flags that chose the captured kernels) and the same model and
optimizer, and replayed by every later such call; the first call, a new
signature, another state, an optimizer that is not capturable, the CPU,
the mesh (collectives in the step) and a failed capture (one warning)
run eagerly. A replay copies the batch into the graph's input buffers;
the metrics and EMAs run eagerly after it.

With a profiler recording, an eager step's phases are the spans
``hdrnet.train.forward`` (normalize, forward, loss),
``hdrnet.train.backward`` (with the mesh's gradient all-reduce) and
``hdrnet.train.optimizer``; a replayed step's are
``hdrnet.train.replay`` (learning rates, the batch's copy-in and the
replay); a capture is ``hdrnet.train.capture``; every step ends in
``hdrnet.train.metrics``.
"""

from __future__ import annotations

import dataclasses
import functools
import logging

import torch
from torch import nn

from hdrnet_torch.inference import full_float32
from hdrnet_torch.ops.graph import CapturedGraph
from hdrnet_torch.parallel.collectives import (all_reduce, all_reduce_grads,
                                               all_reduce_sum_)
from hdrnet_torch.training import metrics
from hdrnet_torch.utils.timing import span

log = logging.getLogger('hdrnet_torch.train')

# The batch keys the step reads: a graph's input buffers.
BATCH_KEYS = ('lowres_input', 'image_input', 'image_output')

# CUDA graphs captured and replayed by make_train_step's steps in this
# process.
graph_captures = 0
graph_replays = 0


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
  updates so far, so the first update uses schedule(0). A capturable
  group keeps it in a 0-dim float32 tensor on its device, written in
  place, so that a captured step reads the value of each replay."""
  if state.schedule is None:
    return
  lr = state.schedule(state.step)
  for group in state.optimizer.param_groups:
    value = lr * group.get('lr_scale', 1.0)
    if not group.get('capturable'):
      group['lr'] = value
    elif isinstance(group['lr'], torch.Tensor):
      group['lr'].fill_(value)
    else:
      # A captured Adam reads its lr from this tensor at every replay.
      group['lr'] = torch.tensor(value, dtype=torch.float32,
                                 device=group['params'][0].device)


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


def _signature(state, batch):
  """What a captured step depends on besides the values in its buffers:
  the model, the optimizer and its state (a restore replaces the state),
  each batch key's shape, dtype and device, and the cuDNN flags that
  chose the captured kernels. None where no graph may run: a CPU batch,
  or an optimizer group that is not capturable."""
  opt = state.optimizer
  xs = [batch[k] for k in BATCH_KEYS]
  if not (all(x.is_cuda for x in xs)
          and all(g.get('capturable') for g in opt.param_groups)):
    return None
  return (state.model, opt, opt.state,
          tuple((tuple(x.shape), x.dtype, x.device) for x in xs),
          torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)


def _same(a, b):
  """Whether two signatures agree: the objects by identity, the rest by
  value."""
  return (a is not None and b is not None
          and all(x is y for x, y in zip(a[:3], b[:3])) and a[3:] == b[3:])


class _StepGraph(CapturedGraph):
  """`run(inputs)`, the step's normalize, forward, loss, backward and Adam
  on a batch of `batch`'s signature, captured as one CUDA graph:
  ``replay(batch)`` copies the batch into ``inputs``, runs the captured
  launches and returns a fresh copy of the loss, and the target and the
  output, which the next replay overwrites."""

  def __init__(self, run, state, batch, key):
    global graph_captures
    self.key = key
    self.inputs = {k: torch.empty(batch[k].shape, dtype=batch[k].dtype,
                                  device=batch[k].device)
                   for k in BATCH_KEYS}
    # The backward captured with no gradient held allocates the
    # gradients in the graph's pool, and each replay writes them anew.
    state.optimizer.zero_grad(set_to_none=True)
    super().__init__(lambda: run(self.inputs), 'hdrnet.train.capture')
    graph_captures += 1

  def replay(self, batch):
    global graph_replays
    for k, x in self.inputs.items():
      x.copy_(batch[k])
    loss, target, out = super().replay()
    graph_replays += 1
    # The caller keeps a step's loss past later replays.
    return loss.clone(), target, out


class _CapturedStep:
  """The one graph of a step function: captured at the second call in a
  row with one signature (the first builds the tables, plans and Adam
  state that a capture must find made), dropped at a call with another;
  a signature whose capture failed runs eagerly."""

  def __init__(self):
    self.graph = None
    self.seen = None  # the signature of the last eager call
    self.failed = None

  def graph_for(self, state, batch, run):
    """The graph to replay for this call, or None to run it eagerly."""
    key = _signature(state, batch)
    if key is None:
      return None
    if self.graph is not None:
      if _same(self.graph.key, key):
        return self.graph
      torch.cuda.synchronize()  # no replay of the dropped graph in flight
      self.graph = None
    if _same(self.failed, key):
      return None
    if not _same(self.seen, key):
      self.seen = key
      return None
    self.seen = None
    set_learning_rates(state)
    try:
      self.graph = _StepGraph(run, state, batch, key)
    except RuntimeError:
      log.warning('make_train_step: capturing the step on %s batches as a '
                  'CUDA graph failed; it runs eagerly', key[3],
                  exc_info=True)
      self.failed = key
    return self.graph


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

  Without a mesh, on a CUDA device with a capturable optimizer
  (``training.loop.make_optimizer``'s there), the step holds one CUDA
  graph of itself (this module's docstring): the returned loss is the
  caller's, but the model's gradients, like the optimizer's state, are
  the graph's tensors, which the next replay overwrites.
  """

  def run(state, batch, band=None):
    """normalize, forward, loss, backward and Adam: what a graph captures.
    Returns the loss, the target and the output, detached."""
    model, opt = state.model, state.optimizer
    kw = {} if band is None else {'band': band}
    with span('hdrnet.train.forward'):
      batch = normalize_batch(batch)
      model.train()
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
    return loss.detach(), target, out.detach()

  captured = _CapturedStep()

  def step(state, batch, band=None):
    with full_float32():
      graph = None
      if mesh is None:
        graph = captured.graph_for(state, batch,
                                   functools.partial(run, state))
      if graph is None:
        set_learning_rates(state)
        loss, target, out = run(state, batch, band)
      else:
        with span('hdrnet.train.replay'):
          set_learning_rates(state)
          loss, target, out = graph.replay(batch)
    with span('hdrnet.train.metrics'):
      if mesh is not None:
        loss = all_reduce_sum_(loss.clone(), mesh.group)
      p = metrics.psnr(target, out, mesh)
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
