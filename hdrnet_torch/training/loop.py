"""The training loop of the port (counterpart of
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

Over several processes (``torch.distributed`` initialized, e.g. by
``parallel.mesh.initialize_distributed`` under torchrun) it trains on a
('data', 'spatial') mesh (``parallel.mesh``), as the JAX loop does on its
device mesh: by default every rank on 'data' at the largest degree that
divides the batch; ``train.mesh_shape`` picks a layout. Every rank builds
the same global batch from the seed (the host pipeline with one worker
thread, whose batches do not depend on thread timing; the device route
augments the rank's rows) and takes its share; the step is the global
batch's. Rank 0 writes the config, the summaries and the checkpoints,
logs, profiles and evaluates; its clock decides when to save, for every
rank. Ranks past the mesh sit out: they wait for the run to end and
return its last checkpoint.
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
import torch.distributed as dist

from hdrnet_torch.config import Config
from hdrnet_torch.data import (ImageFilesDataPipeline,
                               StyleTransferDataPipeline,
                               UnsharpMaskDataPipeline, make_pipeline)
from hdrnet_torch.inference import resolve_device
from hdrnet_torch.models import MODELS, make_model
from hdrnet_torch.parallel import mesh as pm
from hdrnet_torch.training.checkpoint import Checkpointer
from hdrnet_torch.training.step import (create_state, make_eval_step,
                                        make_train_step, to_device)
from hdrnet_torch.utils.timing import span

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
  for Adam is ``optax.chain(adam, scale)``.

  Where every parameter is on a CUDA device it is capturable (its step
  counts on the device, so that ``make_train_step`` can capture it in a
  CUDA graph) and fused: the capturable foreach Adam's bias corrections,
  float32 powers of the count, moved a sensitive leaf's change by 4.6e-4
  of the plain Adam's in three steps, the fused kernel's by the plain
  Adam's own round-off. Elsewhere it is plain. A loaded state dict keeps
  that choice, whichever optimizer saved it."""
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
  on_card = all(p.is_cuda for p in model.parameters())
  opt = torch.optim.Adam(param_groups, lr=lr0, betas=(0.9, 0.999), eps=1e-8,
                         capturable=on_card, fused=on_card or None)
  opt.register_load_state_dict_post_hook(_keep_own_kind)
  return opt


def _keep_own_kind(opt):
  """After ``load_state_dict``, which takes the saved groups' settings:
  the optimizer's own implementation (capturable, fused) whichever
  optimizer saved the state, and what it needs: a capturable group's
  step counts, and its lr where a tensor, as float32 on its parameters'
  device; a plain group's lr a number."""
  capturable = opt.defaults['capturable']
  for group in opt.param_groups:
    for key in ('capturable', 'fused', 'foreach'):
      group[key] = opt.defaults[key]
    lr = group['lr']
    if isinstance(lr, torch.Tensor):
      group['lr'] = (lr.to(group['params'][0].device, torch.float32)
                     if capturable else float(lr))
    for p in group['params'] if capturable else ():
      state = opt.state.get(p)
      if state and 'step' in state:
        state['step'] = torch.as_tensor(state['step'], dtype=torch.float32,
                                        device=p.device)


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
  with span('hdrnet.data.augment'):
    return augment([ins[int(i)] for i in idx], [outs[int(i)] for i in idx],
                   params)


def _host_batches(pipeline, seed, device, mesh=None):
  """The host pipeline's batches (on a mesh, this rank's shares) on
  `device`; closing this generator stops the pipeline's worker
  threads."""
  raw = pipeline.prefetching_batches(seed=seed)
  try:
    for batch in raw:
      yield to_device(pm.shard_batch(mesh, batch)[0], device)
  finally:
    raw.close()


def _batch_source(pipeline, data_cfg, device, seed, host_batches,
                  mesh=None):
  """(route, samples, batches, resident bytes): with ``device_data`` and
  a dataset that qualifies, the device route, whose ``batches()`` gathers
  and augments each batch (on a mesh, this rank's rows, then its H-band)
  on the device; else the host route, ``host_batches``."""
  dds = None
  if data_cfg.device_data:
    dds, augment = _try_device_dataset(pipeline, data_cfg, device)
  if dds is None:
    return 'host', pipeline.nsamples, host_batches, 0

  def batches():
    for p in dds.param_stream(seed, data_cfg.batch_size):
      if mesh is not None:
        rows = mesh.rows(data_cfg.batch_size)
        p = {k: v[rows] for k, v in p.items()}
      yield pm.take_band(mesh, augment_batch(augment, dds.inputs,
                                             dds.outputs, p))[0]
  return 'device', dds.nsamples, batches, dds.nbytes


def _make_mesh(config):
  """This rank's Mesh for ``train.mesh_shape`` (None for one process with
  no process group); raises, as the JAX loop does, where the layout does
  not fit the world, the batch or the frame, and where a band of a level
  at which the model slices its grid is shorter than the level's mirror
  padding (``pm.check_band_rows``): on every rank, before any step."""
  tc, world = config.train, pm.world_size()
  if tc.mesh_shape:
    mesh_shape = tuple(int(v) for v in tc.mesh_shape)
  else:
    # Default: pure DP with the largest degree that divides the batch.
    dp = world
    while config.data.batch_size % dp:
      dp -= 1
    mesh_shape = (dp, 1)
  mesh = pm.make_mesh(mesh_shape)
  d, s = mesh_shape
  if config.data.batch_size % d:
    raise ValueError(f'batch_size {config.data.batch_size} not divisible '
                     f'by data-parallel degree {d}')
  if s > 1:
    h = config.data.output_resolution[0]
    if h % s:
      raise ValueError(f'full-res height {h} not divisible by spatial mesh '
                       f'degree {s}')
    cls = MODELS.get(config.model.model_name)
    levels = getattr(cls, 'slice_levels', getattr(cls, 'n_scales', 1))
    pm.check_band_rows(h, s, config.model.spatial_bin, levels)
  return mesh


def _sit_out(config, checkpoint_dir, mesh, device):
  """A rank past the mesh: waits for the mesh's run to end, then returns
  its last checkpoint as a state on `device`."""
  log.info('rank %d sits out of the %dx%d mesh', mesh.rank, *mesh.shape)
  dist.barrier(group=mesh.world_control)
  tc = config.train
  model = make_model(config.model,
                     generator=torch.Generator().manual_seed(tc.seed))
  model = model.to(device)
  state = create_state(model, make_optimizer(model, tc), make_schedule(tc))
  Checkpointer(checkpoint_dir).restore(state)
  return state


def train(config: Config, checkpoint_dir, data_dir, eval_data_dir=None,
          max_steps=None, device='cuda'):
  """Trains and returns the final TrainState. device: CUDA by default
  (raises without it; on a mesh, this rank's card, ``pm.rank_device``);
  ``'cpu'`` runs the plain versions. Every rank of the process group
  calls it with the same arguments."""
  tc = config.train
  device = resolve_device(pm.rank_device(device))
  mesh = _make_mesh(config)
  if mesh is not None and not mesh.member:
    return _sit_out(config, checkpoint_dir, mesh, device)
  lead = mesh is None or mesh.lead
  if lead:
    config.save(checkpoint_dir)

  model = make_model(config.model,
                     generator=torch.Generator().manual_seed(tc.seed))
  model = model.to(device)
  schedule = make_schedule(tc)
  state = create_state(model, make_optimizer(model, tc), schedule)
  ckpt = Checkpointer(checkpoint_dir, mesh=mesh)
  if ckpt.restore(state) is not None:
    log.info('restored checkpoint at step %d', state.step)
  pm.replicate(model, mesh)

  data_cfg = config.data
  if mesh is not None and data_cfg.data_threads != 1:
    # One worker: the batches then follow from the seed alone, the same
    # on every rank (several workers' order depends on thread timing).
    data_cfg = Config.from_json(config.to_json()).data
    data_cfg.data_threads = 1
  pipeline = make_pipeline(data_dir, data_cfg)
  log.info('training on %d samples from %s on %s%s', pipeline.nsamples,
           data_dir, device, '' if mesh is None else
           f', rank {mesh.rank} at {mesh.coords} of a mesh '
           f'{dict(zip((pm.DATA_AXIS, pm.SPATIAL_AXIS), mesh.shape))} over '
           f'{dist.get_backend()}')
  state.data_route, _, batches, state.resident_bytes = _batch_source(
      pipeline, data_cfg, device, tc.seed,
      lambda: _host_batches(pipeline, tc.seed, device, mesh), mesh)
  batches = batches()
  band = None if mesh is None else mesh.band(data_cfg.output_resolution[0])
  train_step = make_train_step(guide_reg=tc.guide_reg,
                               guide_reg_target=tc.guide_reg_target,
                               mesh=mesh)

  eval_step = eval_batches = None
  if eval_data_dir and lead:
    eval_cfg = _eval_config(config)
    eval_pipeline = make_pipeline(eval_data_dir, eval_cfg)
    eval_step = make_eval_step()
    state.eval_data_route, eval_n, eval_batches, _ = _batch_source(
        eval_pipeline, eval_cfg, device, 0,
        lambda: (to_device(raw, device)
                 for raw in eval_pipeline.batches(seed=0)))

  summaries = SummaryWriter(checkpoint_dir) if lead else None
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
  if lead and tc.profile_dir and state.step > 10:
    log.warning('profile_dir: the trace covers steps 10-15 and this run '
                'starts at step %d; no trace is written', state.step)
  # Whether every rank ended the loop normally, and so reaches the final
  # save's barrier; after a failure no rank waits for the others.
  ended = False
  try:
    for batch in batches:
      if limit is not None and state.step >= limit:
        break
      if lead and tc.profile_dir and state.step == 10 and profiler is None:
        profiler = _start_profiler(device)
      state, m = train_step(state, batch, band)
      runahead.append(m['loss'])
      if len(runahead) >= RUNAHEAD:
        runahead.popleft().item()
      if profiler is not None and state.step >= 15:
        _stop_profiler(profiler, tc.profile_dir)
        profiler = None

      # Rank 0's own business (no collective inside), by its clock; the
      # save, whose barrier every rank joins, is agreed in maybe_save.
      now = time.time()
      if lead and now - last_log >= tc.log_interval:
        log.info('Step %d | loss = %.4f | psnr = %.1f dB', state.step,
                 float(m['ema_loss']), float(m['ema_psnr']))
        last_log = now
      if lead and now - last_summary >= tc.summary_interval:
        lr = tc.learning_rate if schedule is None else schedule(state.step)
        summaries.write(state.step, loss=m['ema_loss'], psnr=m['ema_psnr'],
                        learning_rate=lr,
                        batch_size=config.data.batch_size)
        last_summary = now
      ckpt.maybe_save(state.step, state, tc.checkpoint_interval)
      if eval_step and now - last_eval >= tc.eval_interval:
        run_eval(state.step)
        last_eval = now
    ended = True
  except KeyboardInterrupt:
    log.info('interrupted')
  finally:
    batches.close()
    if profiler is not None:
      _stop_profiler(profiler, tc.profile_dir)
    log.info('training done at step %d, saving final checkpoint', state.step)
    ckpt.save(state.step, state, sync=ended)
  if m and lead:
    summaries.write(state.step, loss=m['ema_loss'], psnr=m['ema_psnr'])
  if mesh is not None and ended:
    dist.barrier(group=mesh.world_control)  # the ranks that sit out
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
