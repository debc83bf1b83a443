"""Checkpoints of the port's train state (counterpart of
``hdrnet_tpu.training.checkpoint``, which uses orbax).

One ``torch.save`` file per step, ``ckpt_<step>.pt``, beside the
``config.json`` that ``train`` writes: ``{step, model, optimizer,
ema_loss, ema_psnr}``, the model's state dict holding the batch-norm
statistics. Writes go to a temporary file first and are renamed into
place, so a reader never sees a partial file. The newest ``max_to_keep``
are kept; ``restore`` loads the latest into a state built from the same
config. A checkpoint of the JAX package (orbax) is converted once into
this format by ``scripts/convert_jax_checkpoint.py``, where JAX is
installed; the port then serves and resumes it as its own.

On a mesh (``Checkpointer(..., mesh=)``, every rank holding the same
state) rank 0 writes, every rank restores from the shared directory, and
a barrier on the mesh follows each save; rank 0's clock decides when
``maybe_save`` saves, for every rank.
"""

from __future__ import annotations

import os
import re
import time

import torch

_NAME = re.compile(r'^ckpt_(\d+)\.pt$')


def _steps(directory):
  steps = []
  for name in os.listdir(directory):
    m = _NAME.match(name)
    if m:
      steps.append(int(m.group(1)))
  return sorted(steps)


def checkpoint_path(directory, step):
  return os.path.join(directory, f'ckpt_{int(step)}.pt')


def latest_checkpoint(directory):
  """Path of the newest step file in `directory`, or None."""
  steps = _steps(directory) if os.path.isdir(directory) else []
  return checkpoint_path(directory, steps[-1]) if steps else None


def load(path, device='cpu'):
  """The saved dict, tensors mapped to `device`."""
  return torch.load(path, map_location=device, weights_only=True)


class Checkpointer:

  def __init__(self, directory, max_to_keep=3, mesh=None):
    self.directory = os.path.abspath(directory)
    self.max_to_keep = max_to_keep
    self.mesh = mesh
    os.makedirs(self.directory, exist_ok=True)
    self._last_save = time.time()

  def latest_step(self):
    steps = _steps(self.directory)
    return steps[-1] if steps else None

  def save(self, step, state, sync=True):
    """Writes the state (on a mesh: rank 0 writes, then, with `sync`, every
    rank waits at a barrier; without it, after a failure, no rank
    waits)."""
    if self.mesh is None or self.mesh.lead:
      self._write(step, state)
    if self.mesh is not None and sync:
      self.mesh.barrier()
    self._last_save = time.time()

  def _write(self, step, state):
    payload = {'step': int(step), 'model': state.model.state_dict(),
               'optimizer': state.optimizer.state_dict(),
               'ema_loss': state.ema_loss.detach().cpu(),
               'ema_psnr': state.ema_psnr.detach().cpu()}
    path = checkpoint_path(self.directory, step)
    tmp = f'{path}.{os.getpid()}.tmp'
    torch.save(payload, tmp)
    os.replace(tmp, path)
    for old in _steps(self.directory)[:-self.max_to_keep]:
      os.remove(checkpoint_path(self.directory, old))

  def maybe_save(self, step, state, interval_secs):
    due = time.time() - self._last_save >= interval_secs
    if self.mesh is not None:
      due = self.mesh.agree(due)
    if due:
      self.save(step, state)
    return due

  def restore(self, state):
    """Loads the latest checkpoint into `state` (model, optimizer, step,
    EMAs) on the model's device. Returns the state, or None if there is
    no checkpoint."""
    step = self.latest_step()
    if step is None:
      return None
    dev = next(state.model.parameters()).device
    payload = load(checkpoint_path(self.directory, step), dev)
    state.model.load_state_dict(payload['model'])
    state.optimizer.load_state_dict(payload['optimizer'])
    state.step = int(payload['step'])
    state.ema_loss = payload['ema_loss'].to(dev)
    state.ema_psnr = payload['ema_psnr'].to(dev)
    return state
