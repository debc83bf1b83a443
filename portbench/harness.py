"""Runs one cell of ``BENCHMARK.json`` once and prints its result line.

A cell names a configuration (``portbench/configs/<config>.json``: the
``ModelConfig`` fields and the weights' init) and a traffic mix
(``portbench/traffic/<traffic>.json``: its driver, ``portbench/drivers/
<driver>.py``, and the driver's parameters); its correctness limits are in
``portbench/cells/<cell>.json``; each per-layer metric is read from the
traced stretch by ``portbench/layer_metrics/<metric>.py``. Nothing here
names a cell, a configuration or a metric.

The run: set-up (weights, inputs, the program's state, warm-up), the
measured window of ``--seconds``, then, once the window has closed and
the program's state is freed, the comparison with the plain reference.
With ``--trace 1`` a stretch of the window is profiled and the result
holds the per-layer metrics instead of the end-to-end ones.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import gc
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / 'portbench'
BANNED = ('jax', 'jaxlib', 'flax', 'hdrnet_tpu')


def set_caches(root=ROOT):
  """Every compiler cache the program or torch may use, at fixed paths
  inside the checkout (before torch is imported)."""
  cache = root / 'build' / 'portbench'
  for var, sub in (('TRITON_CACHE_DIR', 'triton'),
                   ('TORCHINDUCTOR_CACHE_DIR', 'inductor'),
                   ('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                   ('CUDA_CACHE_PATH', 'nv')):
    os.environ[var] = str(cache / sub)


def load_json(path):
  with open(path) as f:
    return json.load(f)


def cell_metrics(bench, cell):
  """The cell's entry, its end-to-end metrics and its per-layer metrics."""
  entry = next((w for w in bench['workloads'] if w['name'] == cell), None)
  if entry is None:
    raise SystemExit(f'portbench: no workload {cell!r} in BENCHMARK.json')
  e2e = [m for m in bench['end_to_end']
         if cell in m.get('workloads', [cell])]
  names = {m['name'] for m in e2e}
  layer = [m for m in bench['per_layer']
           if (cell in m['workloads'] if 'workloads' in m
               else m['moves'] in names)]
  return entry, e2e, layer


def banned_modules():
  return sorted({m.split('.')[0] for m in sys.modules} & set(BANNED))


@dataclasses.dataclass
class Outcome:
  e2e: dict
  checks: dict
  correct: bool
  attempted: int
  failed: int
  summary: object
  error: str
  setup_s: float
  memory_peak_bytes: int


@dataclasses.dataclass
class Run:
  """One run of a cell: its files, its arguments, its clocks."""
  cell: str
  config: dict
  traffic: dict
  limits: dict
  seed: int
  seconds: float
  trace: bool
  device: object
  t_start: float
  setup_s: float = None
  setup_peak: int = 0

  @property
  def model(self):
    return self.config['model']

  @property
  def family(self):
    """The model family's file (``portbench/models/<model_name>.py``)."""
    from portbench import models
    return models.load(self.model['model_name'])

  @property
  def cuda(self):
    return self.device.type == 'cuda'

  def phase(self, name):
    """Prints how far into set-up a phase ended (an earlier line)."""
    print(f'portbench: set-up {name} at {time.monotonic() - self.t_start:.3f} s',
          flush=True)

  def sync(self):
    import torch
    if self.cuda:
      torch.cuda.synchronize(self.device)

  def inputs_ready(self):
    """The benchmark's own scratch for making its inputs is freed: the
    device memory peak counts from here, so that it holds the program's
    state and inputs, its set-up and the window, and nothing that only
    made them."""
    import torch
    self.sync()
    if self.cuda:
      torch.cuda.reset_peak_memory_stats(self.device)

  def window_opens(self):
    """Ends set-up; the window's start on the perf_counter clock."""
    import torch
    self.sync()
    self.setup_s = time.monotonic() - self.t_start
    if self.cuda:
      self.setup_peak = torch.cuda.max_memory_allocated(self.device)
      torch.cuda.reset_peak_memory_stats(self.device)
    return time.perf_counter()

  def window_closes(self):
    """The device memory peak of the window, in bytes."""
    import torch
    self.sync()
    return torch.cuda.max_memory_allocated(self.device) if self.cuda else 0

  def print_rates(self, stamps, t0, every=5.0):
    """An earlier line: the window's rate in each `every` seconds of it
    (iterations ended at `stamps`), which shows how steady a run is."""
    n = max(int(self.seconds // every), 1)
    bins = [0] * n
    for t in stamps:
      i = int((t - t0) // every)
      if 0 <= i < n:
        bins[i] += 1
    print(f'portbench: rate by {every:g} s of the window: '
          + ' '.join(f'{b / every:.2f}' for b in bins), flush=True)

  def free(self):
    import torch
    gc.collect()
    if self.cuda:
      torch.cuda.empty_cache()

  def outcome(self, e2e, numbers, attempted, failed, summary, error):
    from portbench import checks
    judged, ok = checks.judge(numbers, self.limits)
    peak = max(self.setup_peak, int(e2e.get('peak_mem_gib', 0) * 2**30))
    return Outcome(e2e, judged, ok and failed == 0 and error is None,
                   attempted, failed, summary, error, self.setup_s, peak)


def make_run(cell, seed, seconds, trace, device, t_start, root=ROOT,
             model=None, traffic=None, limits=None):
  """The Run of `cell`; `model`, `traffic` and `limits` override entries
  of its files (for the CPU tests at small shapes)."""
  import torch
  bench = load_json(root / 'BENCHMARK.json')
  entry, _, _ = cell_metrics(bench, cell)
  config = load_json(HERE / 'configs' / f"{entry['config']}.json")
  config['model'] = {**config['model'], **(model or {})}
  traffic_cfg = {**load_json(HERE / 'traffic' / f"{entry['traffic']}.json"),
                 **(traffic or {})}
  cell_limits = {**load_json(HERE / 'cells' / f'{cell}.json')['limits'],
                 **(limits or {})}
  return Run(cell, config, traffic_cfg, cell_limits, int(seed),
             float(seconds), bool(trace), torch.device(device), t_start)


def driver(run):
  return importlib.import_module(f"portbench.drivers.{run.traffic['driver']}")


def read_layer_metric(name, summary):
  spec = importlib.util.spec_from_file_location(
      'portbench_layer_metric', HERE / 'layer_metrics' / f'{name}.py')
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod.read(summary)


def result(run, out, e2e, layer, device_info):
  """The result line's object; `checks` comes last."""
  metrics = {}
  if not run.trace:
    values = {**out.e2e, 'setup_s': out.setup_s}
    for m in e2e:
      metrics[m['name']] = {'value': values[m['name']], 'unit': m['unit']}
  elif out.summary is not None:
    for m in layer:
      v = read_layer_metric(m['name'], out.summary)
      if v is not None:
        metrics[m['name']] = {'value': v, 'unit': m['unit']}
  device = {**device_info, 'memory_peak_bytes': out.memory_peak_bytes}
  line = {'correct': out.correct, 'attempted': out.attempted,
          'failed': out.failed, 'metrics': metrics, 'device': device}
  if run.trace and out.summary is not None:
    device['busy_s'] = out.summary.busy_s
    device['window_s'] = out.summary.window_s
    line['breakdown'] = {'device_ops': out.summary.top_ops(),
                         'idle_gaps': out.summary.idle_gaps()}
  line['checks'] = out.checks
  return line


def run_cell(cell, seed, seconds, trace, device, t_start=None, **overrides):
  """Set-up, window and comparison of one cell on `device`; returns the
  Run, its Outcome and the result line's object, and prints the run's
  earlier lines. The command requires a card; the CPU tests call this
  with ``device='cpu'`` at small shapes."""
  t_start = time.monotonic() if t_start is None else t_start
  run = make_run(cell, seed, seconds, trace, device, t_start, **overrides)
  info = device_info(run)
  run.phase('torch and the device')
  entry, e2e, layer = cell_metrics(load_json(ROOT / 'BENCHMARK.json'), cell)
  print(f'portbench: cell {cell} seed {seed} seconds {seconds} trace {trace}')
  print(f"portbench: config {entry['config']} {json.dumps(run.model)}")
  print(f"portbench: traffic {entry['traffic']} {json.dumps(run.traffic)}")
  print(f'portbench: device {json.dumps(info)}', flush=True)
  drive = driver(run)
  run.phase("the program's modules")
  out = drive.run(run)
  if out.summary is not None:
    names = collections.Counter(a.name for a in out.summary.device)
    for name, n in names.most_common():
      print(f'portbench: traced x{n}: {name[:200]}')
  return run, out, result(run, out, e2e, layer, info)


def device_info(run):
  import torch
  if not run.cuda:
    return {'platform': 'cpu', 'kind': 'cpu', 'count': 1}
  return {'platform': 'gpu', 'kind': torch.cuda.get_device_name(run.device),
          'count': 1, 'power_limit_w': power_limit()}


def power_limit():
  try:
    out = subprocess.run(['nvidia-smi', '--query-gpu=power.limit',
                          '--format=csv,noheader,nounits'],
                         capture_output=True, text=True, timeout=30,
                         check=True).stdout
    return float(out.split()[0])
  except (OSError, subprocess.SubprocessError, ValueError, IndexError):
    return None


def parse(argv):
  p = argparse.ArgumentParser(prog='python -m portbench.run')
  p.add_argument('--workload', required=True)
  p.add_argument('--seed', type=int, required=True)
  p.add_argument('--seconds', type=float, required=True)
  p.add_argument('--trace', type=int, choices=(0, 1), default=0)
  return p.parse_args(argv)


def main(argv, t_start):
  args = parse(argv)
  set_caches()
  import torch
  bench = load_json(ROOT / 'BENCHMARK.json')
  entry, _, _ = cell_metrics(bench, args.workload)
  chips = entry['chips']
  if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    print(f'portbench: {args.workload} needs {chips} CUDA device(s), '
          f'found {n}; no result', file=sys.stderr)
    return 3
  _, out, line = run_cell(args.workload, args.seed, args.seconds, args.trace,
                         'cuda:0', t_start)
  if out.error:
    print(f'portbench: the window failed: {out.error}', file=sys.stderr)
  found = banned_modules()
  if found:
    print(f'portbench: modules loaded that must not be: {found}; no result',
          file=sys.stderr)
    return 4
  for k, v in out.checks.items():
    print(f"check {k}: {v['value']!r} (limit {v['limit']!r})",
          file=sys.stderr)
  print(json.dumps(line), flush=True)
  return 0
