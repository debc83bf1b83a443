"""The training loop of the port on one device (counterpart of
``hdrnet_tpu.training.loop``; reference: bin/train.py:46-184).

``train(config, checkpoint_dir, data_dir, ...)`` builds the port's host
input pipeline (``hdrnet_torch.data``; reading image files needs PIL),
the model and Adam on the device (CUDA unless the caller asks for the
CPU; without CUDA it raises); restores the latest
checkpoint if there is one; then steps, with time-interval logging,
``summaries.jsonl`` records in the JAX package's format, checkpoints and
evaluation, and a final save on exit or interrupt.

With ``data.device_data`` the whole dataset is uploaded once and each
step gathers and augments its batch on the device
(``hdrnet_torch.data.device``) for the file, unsharp-mask and
style-transfer pipelines; any other pipeline, or a dataset that does not
qualify, takes the host pipeline with a warning, as in the JAX package.
The returned state's ``data_route`` and ``eval_data_route`` say which
route ran.

Not ported here, and refused rather than replaced: multi-device meshes
(``mesh_shape`` other than None or [1, 1]; ROADMAP M6).
"""

from __future__ import annotations

import collections
import json
import logging
import math
import os
import time

import numpy as np
import torch

from hdrnet_torch.config import Config
from hdrnet_torch.data import (ImageFilesDataPipeline,
                               StyleTransferDataPipeline,
                               UnsharpMaskDataPipeline, make_pipeline)
from hdrnet_torch.inference import resolve_device
from hdrnet_torch.models import make_model
from hdrnet_torch.training.checkpoint import Checkpointer
from hdrnet_torch.training.step import (create_state, make_eval_step,
                                        make_train_step, to_device)

log = logging.getLogger('hdrnet_torch.train')

# Steps the host may run ahead of the device before it waits: fetching
# the loss of step k - RUNAHEAD bounds the queued work and the batches it
# holds.
RUNAHEAD = 32


class SummaryWriter:
  """Scalar summaries as JSONL, one record a line."""

  def __init__(self, directory):
    os.makedirs(directory, exist_ok=True)
    self.path = os.path.join(directory, 'summaries.jsonl')

  def write(self, step, **scalars):
    rec = {'step': int(step), 'time': time.time()}
    rec.update({k: float(v) for k, v in scalars.items()})
    with open(self.path, 'a') as f:
      f.write(json.dumps(rec) + '\n')


def make_schedule(tc):
  """None for a constant lr, else count -> lr with optax's values:
  ``cosine_decay_schedule(lr, decay, alpha=lr_end / lr)`` (holds
  lr_end after `decay`), or with warmup
  ``warmup_cosine_decay_schedule(0, lr, warmup, decay, lr_end)``, whose
  `decay` counts the warmup."""
  if tc.lr_schedule == 'constant':
    return None
  if tc.lr_schedule != 'cosine':
    raise ValueError(f'unknown lr_schedule {tc.lr_schedule!r}')
  decay = tc.lr_decay_steps or tc.max_steps
  if not decay:
    raise ValueError("lr_schedule='cosine' needs lr_decay_steps or "
                     'max_steps')
  peak, end, warmup = tc.learning_rate, tc.lr_end, tc.lr_warmup_steps

  def cosine(count, init, steps):
    alpha = 0.0 if init == 0.0 else end / init
    frac = min(count, steps) / steps
    return init * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * frac)) + alpha)

  if not warmup:
    return lambda count: cosine(count, peak, decay)

  def schedule(count):
    if count < warmup:
      return peak * count / warmup
    return cosine(count - warmup, peak, decay - warmup)
  return schedule


def make_optimizer(model, tc):
  """Adam (b1 0.9, b2 0.999, eps 1e-8: ``optax.adam``'s). With
  ``guide_lr_scale`` != 1 the parameters of every top-level module whose
  name starts with 'guide' form a second group whose lr is scaled, which
  for Adam is ``optax.chain(adam, scale)``."""
  lr0 = tc.learning_rate
  groups = {'guide': [], 'rest': []}
  for name, p in model.named_parameters():
    top = name.split('.')[0]
    scaled = tc.guide_lr_scale != 1.0 and top.startswith('guide')
    groups['guide' if scaled else 'rest'].append(p)
  param_groups = [{'params': groups['rest'], 'lr_scale': 1.0}]
  if groups['guide']:
    param_groups.append({'params': groups['guide'],
                         'lr_scale': tc.guide_lr_scale})
  for g in param_groups:
    g['lr'] = lr0 * g['lr_scale']
  return torch.optim.Adam(param_groups, lr=lr0, betas=(0.9, 0.999),
                          eps=1e-8)


def _eval_config(config):
  cfg = Config.from_json(config.to_json()).data
  cfg.batch_size = 1
  cfg.shuffle = False
  cfg.random_crop = False
  cfg.fliplr = cfg.flipud = cfg.rotate = False
  return cfg


def _try_device_dataset(pipeline, data_cfg, device):
  """(DeviceDataset, augment) when the dataset qualifies for device
  residency (``hdrnet_torch.data.device``), else (None, None) with the
  reason logged as a warning."""
  from hdrnet_torch.data.device import (DeviceDataset, load_pairs,
                                        load_st_dataset, load_usm_dataset,
                                        make_device_augment)
  try:
    if type(pipeline) is ImageFilesDataPipeline:
      dds = DeviceDataset(load_pairs(pipeline), data_cfg, device)
    elif type(pipeline) is UnsharpMaskDataPipeline:
      # Raw inputs resident, the targets synthesized on the device once
      # (the host path blurs every sample every epoch).
      dds = load_usm_dataset(pipeline, data_cfg, device)
    elif type(pipeline) is StyleTransferDataPipeline:
      # Six resident channels: the photo and its resized exemplar.
      dds = load_st_dataset(pipeline, data_cfg, device)
    else:
      log.warning('device_data: %s has no device-resident loader; using '
                  'the host pipeline', type(pipeline).__name__)
      return None, None
    augment = make_device_augment(data_cfg.output_resolution,
                                  data_cfg.net_input_size,
                                  data_cfg.rotate)
    return dds, augment
  except ValueError as e:
    log.warning('device_data unavailable (%s); using the host pipeline',
                e)
    return None, None


def augment_batch(augment, ins, outs, params):
  """Gather (the samples `params['idx']` of the resident arrays) and
  augment one batch on the device."""
  idx = params['idx']
  return augment([ins[int(i)] for i in idx], [outs[int(i)] for i in idx],
                 params)


def _host_batches(pipeline, seed, device):
  """The host pipeline's batches on `device`; closing this generator
  stops the pipeline's worker threads."""
  raw = pipeline.prefetching_batches(seed=seed)
  try:
    for batch in raw:
      yield to_device(batch, device)
  finally:
    raw.close()


def _batch_source(pipeline, data_cfg, device, seed, host_batches):
  """(route, samples, batches, resident bytes): with ``device_data`` and
  a dataset that qualifies, the device route, whose ``batches()`` gathers
  and augments each batch on the device; else the host route,
  ``host_batches``."""
  dds = None
  if data_cfg.device_data:
    dds, augment = _try_device_dataset(pipeline, data_cfg, device)
  if dds is None:
    return 'host', pipeline.nsamples, host_batches, 0

  def batches():
    for p in dds.param_stream(seed, data_cfg.batch_size):
      yield augment_batch(augment, dds.inputs, dds.outputs, p)
  return 'device', dds.nsamples, batches, dds.nbytes


def train(config: Config, checkpoint_dir, data_dir, eval_data_dir=None,
          max_steps=None, device='cuda'):
  """Trains on one device and returns the final TrainState. device: CUDA
  by default (raises without it); ``'cpu'`` runs the plain versions."""
  tc = config.train
  if tc.mesh_shape is not None and list(tc.mesh_shape) != [1, 1]:
    raise NotImplementedError(
        f'mesh_shape {tc.mesh_shape}: multi-GPU training is not ported '
        '(ROADMAP M6); the port trains on one device')
  device = resolve_device(device)
  config.save(checkpoint_dir)

  model = make_model(config.model,
                     generator=torch.Generator().manual_seed(tc.seed))
  model = model.to(device)
  schedule = make_schedule(tc)
  state = create_state(model, make_optimizer(model, tc), schedule)
  ckpt = Checkpointer(checkpoint_dir)
  if ckpt.restore(state) is not None:
    log.info('restored checkpoint at step %d', state.step)

  pipeline = make_pipeline(data_dir, config.data)
  log.info('training on %d samples from %s on %s', pipeline.nsamples,
           data_dir, device)
  state.data_route, _, batches, state.resident_bytes = _batch_source(
      pipeline, config.data, device, tc.seed,
      lambda: _host_batches(pipeline, tc.seed, device))
  batches = batches()
  train_step = make_train_step(guide_reg=tc.guide_reg,
                               guide_reg_target=tc.guide_reg_target)

  eval_step = eval_batches = None
  if eval_data_dir:
    eval_cfg = _eval_config(config)
    eval_pipeline = make_pipeline(eval_data_dir, eval_cfg)
    eval_step = make_eval_step()
    state.eval_data_route, eval_n, eval_batches, _ = _batch_source(
        eval_pipeline, eval_cfg, device, 0,
        lambda: (to_device(raw, device)
                 for raw in eval_pipeline.batches(seed=0)))

  summaries = SummaryWriter(checkpoint_dir)
  last_log = last_summary = last_eval = time.time()
  m = {}
  limit = max_steps if max_steps is not None else tc.max_steps

  def run_eval(step_no):
    it = eval_batches()
    psnrs = [float(eval_step(state, next(it))['psnr'])
             for _ in range(eval_n)]
    p = float(np.mean(psnrs))
    summaries.write(step_no, eval_psnr=p)
    log.info('  Evaluation PSNR = %.1f dB (%d images)', p, len(psnrs))
    return p

  runahead = collections.deque()
  profiler = None
  try:
    for batch in batches:
      if limit is not None and state.step >= limit:
        break
      if tc.profile_dir and state.step == 10 and profiler is None:
        profiler = _start_profiler(device)
      state, m = train_step(state, batch)
      runahead.append(m['loss'])
      if len(runahead) >= RUNAHEAD:
        runahead.popleft().item()
      if profiler is not None and state.step >= 15:
        _stop_profiler(profiler, tc.profile_dir)
        profiler = None

      now = time.time()
      if now - last_log >= tc.log_interval:
        log.info('Step %d | loss = %.4f | psnr = %.1f dB', state.step,
                 float(m['ema_loss']), float(m['ema_psnr']))
        last_log = now
      if now - last_summary >= tc.summary_interval:
        lr = tc.learning_rate if schedule is None else schedule(state.step)
        summaries.write(state.step, loss=m['ema_loss'], psnr=m['ema_psnr'],
                        learning_rate=lr,
                        batch_size=config.data.batch_size)
        last_summary = now
      ckpt.maybe_save(state.step, state, tc.checkpoint_interval)
      if eval_step and now - last_eval >= tc.eval_interval:
        run_eval(state.step)
        last_eval = now
  except KeyboardInterrupt:
    log.info('interrupted')
  finally:
    batches.close()
    if profiler is not None:
      _stop_profiler(profiler, tc.profile_dir)
    log.info('training done at step %d, saving final checkpoint', state.step)
    ckpt.save(state.step, state)
  if m:
    summaries.write(state.step, loss=m['ema_loss'], psnr=m['ema_psnr'])
  return state


def _start_profiler(device):
  acts = [torch.profiler.ProfilerActivity.CPU]
  if device.type == 'cuda':
    acts.append(torch.profiler.ProfilerActivity.CUDA)
  prof = torch.profiler.profile(activities=acts)
  prof.__enter__()
  return prof


def _stop_profiler(prof, profile_dir):
  """Ends the trace of steps 10-15 and writes it as a Chrome trace."""
  if torch.cuda.is_available():
    torch.cuda.synchronize()
  prof.__exit__(None, None, None)
  os.makedirs(profile_dir, exist_ok=True)
  path = os.path.join(profile_dir, 'train_steps_10_15.json')
  prof.export_chrome_trace(path)
  log.info('wrote profiler trace to %s', path)
