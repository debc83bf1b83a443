"""Closed-loop video serving through ``Enhancer.stream``.

One client hands uint8 frames, cycled from a pool made from the seed, to
``Enhancer.stream(frames, depth)`` for the window's length and takes each
result as the generator yields it. A frame's latency runs from the moment
the stream pulls it from the client's iterator to the moment it yields
that frame's result. Every frame pulled in the window is attempted; one
never yielded has failed.

Traffic parameters: height, width, pool, depth, warmup_frames,
compare_frames (results kept, a reservoir sample drawn from the seed, and
compared with the reference once the window has closed), trace_skip and
trace_frames (the traced stretch).
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from portbench import checks, counts, inputs, trace
from portbench.reference import plain

from hdrnet_torch.config import ModelConfig
from hdrnet_torch.inference import Enhancer
from hdrnet_torch.models import make_model


class Reservoir:
  """k results drawn uniformly from all offered, by a seeded generator."""

  def __init__(self, k, seed):
    self.k, self.rng, self.kept = k, np.random.default_rng(seed), {}

  def offer(self, i, item):
    if len(self.kept) < self.k:
      self.kept[i] = item
      return
    j = int(self.rng.integers(0, i + 1))
    if j < self.k:
      del self.kept[sorted(self.kept)[j]]
      self.kept[i] = item


def setup(run):
  tr = run.traffic
  pool = inputs.stream_frames(run.seed, tr['pool'], tr['height'],
                              tr['width'], run.device)
  run.inputs_ready()
  run.phase('frames')
  cfg = ModelConfig(**run.model)
  # The Enhancer builds its own model from the state dict; this one only
  # names the leaves and their shapes.
  sd = inputs.weights(run, make_model(cfg))
  run.phase('weights')
  enh = Enhancer(cfg, sd, device=run.device)
  run.phase('the Enhancer')
  return sd, enh, pool


def run(run):
  tr = run.traffic
  sd, enh, pool = setup(run)
  depth = tr['depth']
  warm = [pool[i % len(pool)] for i in range(tr['warmup_frames'])]
  for _ in enh.stream(iter(warm), depth=depth):
    pass
  run.sync()
  run.phase('warm-up')

  pulled, done = [], []
  t_end = None

  def client():
    i = 0
    while True:
      with record_function('stream.client'):
        now = time.perf_counter()
        if now >= t_end:
          return
        pulled.append(now)
        frame = pool[i % len(pool)]
      yield frame
      i += 1

  sample = Reservoir(tr['compare_frames'], inputs.sub_seed(run.seed, 'sample'))
  window = trace.Window(run.device) if run.trace else None
  if window is not None:
    window.arm()
  t0 = run.window_opens()
  t_end = t0 + run.seconds
  error = None
  skip, last = tr['trace_skip'], tr['trace_skip'] + tr['trace_frames']
  try:
    for j, out in enumerate(enh.stream(client(), depth=depth)):
      done.append(time.perf_counter())
      with record_function('stream.consume'):
        sample.offer(j, out)
        if window is not None and j + 1 == skip:
          window.start()
        elif window is not None and j + 1 == last and window.running:
          window.stop(last - skip)
  except Exception as e:  # a failed frame: counted, reported, not correct
    error = repr(e)
  if window is not None and window.running:
    window.stop(len(done) - skip)
  summary = window.summary if window is not None else None
  mem = run.window_closes()

  run.print_rates(done, t0)
  n_done = sum(t <= t_end for t in done)
  lat = [d - p for p, d in zip(pulled, done)]
  lat += [float('inf')] * (len(pulled) - len(done))
  e2e = {'stream_fps': n_done / run.seconds,
         'frame_p95_ms': float(np.percentile(lat, 95)) * 1e3 if lat else
                         float('inf'),
         'peak_mem_gib': mem / 2**30}
  if summary is not None:
    h, w = tr['height'], tr['width']
    summary.work = {'flops': counts.serve_frame_ops(run.model, h, w),
                    'fused_bound_s': counts.fused_bound_s(run.model, h, w)}

  del enh
  run.free()
  kept = sample.kept
  numbers = {'code_excess': max(
      (frame_excess(run, sd, pool[j % len(pool)], out, 'f32')
       for j, out in kept.items()), default=float('inf'))}
  return run.outcome(e2e, numbers, attempted=len(pulled),
                     failed=len(pulled) - len(done), summary=summary,
                     error=error)


def reference_frame(run, sd, frame, mode):
  with plain.precision(mode):
    return run.family.serve(sd, run.model,
                            torch.from_numpy(frame).to(run.device))


def frame_excess(run, sd, frame, out, mode):
  return checks.code_excess(out, reference_frame(run, sd, frame, mode))


def control(run):
  """The control's readings on `compare_frames` frames of the pool: the
  reference in TF32 put in the program's place, and the program's own
  bfloat16 backbone (``coeff_bf16``), each against the float32
  reference."""
  tr = run.traffic
  sd, enh, pool = setup(run)
  bf16 = Enhancer(ModelConfig(**run.model), sd, device=run.device,
                  coeff_bf16=True)
  frames = pool[:tr['compare_frames']]
  outs = list(bf16.stream(iter(frames), depth=tr['depth']))
  del enh, bf16
  run.free()
  tf32, b16 = [], []
  for frame, out in zip(frames, outs):
    ref = reference_frame(run, sd, frame, 'f32')
    ctrl = plain.quantize(reference_frame(run, sd, frame, 'tf32'))
    tf32.append(checks.code_excess(ctrl.cpu(), ref))
    b16.append(checks.code_excess(out, ref))
  return {'tf32.code_excess': max(tf32), 'bf16.code_excess': max(b16)}
