"""Training steps at a fixed crop through the device-resident data route.

Set-up builds one train state (the model from the seed's weights, Adam,
``create_state``), uploads seeded uint8 pairs as a ``DeviceDataset`` and
drives the state through its first ``checked_steps`` steps with the
window's own call and feed (``param_stream`` draws, ``augment_batch``,
``make_train_step``'s step), keeping their batches, losses, Adam's first
moment after step 1 and the parameters after the last; then
``warmup_steps`` more. The window runs the same loop on the same state,
fetching the loss of step k - RUNAHEAD as ``training.loop.train`` does,
and ends on a device synchronization. Once it has closed, the reference
repeats the checked steps from the same weights and raw pairs.

Traffic parameters: crop, batch_size, pairs, pair_size, learning_rate,
checked_steps, warmup_steps, trace_skip, trace_steps.
"""

from __future__ import annotations

import collections
import time

import torch
from torch.profiler import record_function

from portbench import checks, counts, inputs, trace
from portbench.reference import crops, plain

from hdrnet_torch.config import DataConfig, ModelConfig, TrainConfig
from hdrnet_torch.data.device import DeviceDataset, make_device_augment
from hdrnet_torch.models import make_model
from hdrnet_torch.training.loop import (RUNAHEAD, augment_batch,
                                        make_optimizer, make_schedule)
from hdrnet_torch.training.step import create_state, make_train_step

BATCH_KEYS = ('lowres_input', 'image_input', 'image_output')


def draw_seed(seed):
  return inputs.sub_seed(seed, 'draws') % 2**32


def setup(run):
  tr = run.traffic
  pairs = inputs.train_pairs(run.seed, tr['pairs'], tr['pair_size'],
                             run.device)
  run.inputs_ready()
  run.phase('pairs')
  net = make_model(ModelConfig(**run.model))
  sd = inputs.weights(run, net)
  run.phase('weights')
  net.load_state_dict(sd)
  net.to(run.device)
  tc = TrainConfig(learning_rate=tr['learning_rate'])
  state = create_state(net, make_optimizer(net, tc), make_schedule(tc))
  run.phase('the train state')
  crop = tr['crop']
  data_cfg = DataConfig(batch_size=tr['batch_size'],
                        output_resolution=[crop, crop],
                        net_input_size=run.model['net_input_size'])
  dds = DeviceDataset(None, data_cfg, run.device, arrays=pairs)
  augment = make_device_augment(data_cfg.output_resolution,
                                data_cfg.net_input_size, data_cfg.rotate)
  draws = dds.param_stream(draw_seed(run.seed), data_cfg.batch_size)
  run.phase('resident pairs')

  def feed():
    with record_function('train.feed'):
      return augment_batch(augment, dds.inputs, dds.outputs, next(draws))
  return sd, state, pairs, feed


def checked_steps(state, feed, step, n):
  """Runs n steps; returns what the reference is compared with."""
  net, opt = state.model, state.optimizer
  p0 = {k: p.detach().clone() for k, p in net.named_parameters()}
  prog = {'batches': [], 'losses': []}
  beta1 = opt.param_groups[0]['betas'][0]
  for t in range(n):
    batch = feed()
    prog['batches'].append({k: batch[k].clone() for k in BATCH_KEYS})
    state, m = step(state, batch)
    prog['losses'].append(float(m['loss']))
    if t == 0:  # a step that left Adam's state empty read as no gradient
      prog['grads1'] = {
          k: opt.state[p].get('exp_avg', torch.zeros_like(p)).detach()
          / (1 - beta1) for k, p in net.named_parameters()}
  prog['change'] = {k: p.detach() - p0[k] for k, p in net.named_parameters()}
  return prog


def run(run):
  tr = run.traffic
  sd, state, pairs, feed = setup(run)
  step = make_train_step()
  prog = checked_steps(state, feed, step, tr['checked_steps'])
  run.phase('checked steps')
  for _ in range(tr['warmup_steps']):
    state, _ = step(state, feed())
  run.sync()
  run.phase('warm-up')

  window = trace.Window(run.device) if run.trace else None
  if window is not None:
    window.arm()
  skip, last = tr['trace_skip'], tr['trace_skip'] + tr['trace_steps']
  runahead = collections.deque()
  stamps = []
  n = 0
  error = None
  t0 = run.window_opens()
  try:
    while time.perf_counter() < t0 + run.seconds:
      if window is not None and n == skip:
        window.start()
      state, m = step(state, feed())
      runahead.append(m['loss'])
      if len(runahead) >= RUNAHEAD:
        with record_function('train.runahead_wait'):
          runahead.popleft().item()
      n += 1
      stamps.append(time.perf_counter())
      if window is not None and n == last and window.running:
        window.stop(last - skip)
    run.sync()
  except Exception as e:  # a failed step: counted, reported, not correct
    error = repr(e)
  t1 = time.perf_counter()
  run.print_rates(stamps, t0)
  if window is not None and window.running:
    window.stop(n - skip)
  summary = window.summary if window is not None else None
  mem = run.window_closes()
  e2e = {'train_steps_per_s': n / (t1 - t0), 'peak_mem_gib': mem / 2**30}
  if summary is not None:
    summary.work = {
        'flops': counts.train_step_ops(run.model, tr['crop']),
        'slice_apply_bound_s': counts.slice_apply_bound_s(run.model,
                                                          tr['crop'])}
  del state, step, feed, runahead
  run.free()
  ref = reference(run, sd, pairs, 'f32')
  numbers = checks.train_numbers(prog, ref)
  return run.outcome(e2e, numbers, attempted=n, failed=int(error is not None),
                     summary=summary, error=error)


def reference(run, sd, pairs, mode, loss_fn=plain.l2_loss):
  """The reference's checked steps from the same weights and raw pairs:
  its own draws, crops and previews, then its Adam steps."""
  tr = run.traffic
  batches = crops.batches(pairs, draw_seed(run.seed), tr['crop'],
                          run.model['net_input_size'], tr['batch_size'],
                          tr['checked_steps'])
  unit = [{k: v.to(torch.float32) * (1.0 / 255.0) for k, v in b.items()}
          for b in batches]
  def forward(params, lowres, fullres):
    return run.family.forward_train(params, run.model, lowres, fullres)
  with plain.precision(mode):
    losses, grads1, params = plain.train_steps(
        sd, forward, unit, tr['learning_rate'], loss_fn)
  return {'batches': batches, 'losses': losses, 'grads1': grads1,
          'change': {k: params[k] - sd[k] for k in params}}


def half_rows_loss(target, out):
  """A planted fault: the mean over the top half of the rows only."""
  h = target.shape[1] // 2
  return plain.l2_loss(target[:, :h], out[:, :h])


def control(run):
  """Readings of the reference in TF32 put in the program's place, and of
  the planted half-image loss, each against the float32 reference."""
  sd, state, pairs, _ = setup(run)
  del state
  run.free()
  ref = reference(run, sd, pairs, 'f32')
  out = {}
  for name, mode, loss_fn in (('tf32', 'tf32', plain.l2_loss),
                              ('half_loss', 'f32', half_rows_loss)):
    got = checks.train_numbers(reference(run, sd, pairs, mode, loss_fn), ref)
    out.update({f'{name}.{k}': v for k, v in got.items()})
  return out
