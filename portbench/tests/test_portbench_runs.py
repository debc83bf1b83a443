"""Whole runs of every cell at tiny shapes on the CPU, through the test
entry ``harness.run_cell`` (the command itself requires a card): sound
runs come out correct; runs with the timed path broken underneath, or
with the reference in TF32 in the program's place, do not."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import harness, trace

ROOT = Path(__file__).resolve().parents[2]
SMALL_MODEL = {'net_input_size': 32, 'spatial_bin': 8, 'luma_bins': 4}
SMALL_TRAFFIC = {
    'stream': {'height': 40, 'width': 56, 'pool': 3, 'warmup_frames': 2,
               'compare_frames': 3, 'trace_skip': 2, 'trace_frames': 3},
    'train': {'crop': 48, 'pair_size': 56, 'pairs': 3, 'warmup_steps': 1,
              'trace_skip': 1, 'trace_steps': 2},
}
CELLS = [w['name'] for w in json.loads(
    (ROOT / 'BENCHMARK.json').read_text())['workloads']]
SEED = 2**31 + 977


def small_run(cell, trace_on=0, seed=SEED, seconds=2.0):
  kind = 'stream' if 'stream' in cell else 'train'
  return harness.run_cell(cell, seed, seconds, trace_on, 'cpu',
                          model=SMALL_MODEL, traffic=SMALL_TRAFFIC[kind])


@pytest.mark.parametrize('cell', CELLS)
def test_sound_run_is_correct(cell):
  _, out, line = small_run(cell)
  assert out.correct, line['checks']
  assert line['attempted'] > 0 and line['failed'] == 0
  assert list(line)[-1] == 'checks'
  bench = json.loads((ROOT / 'BENCHMARK.json').read_text())
  _, e2e, _ = harness.cell_metrics(bench, cell)
  assert set(line['metrics']) == {m['name'] for m in e2e}
  assert all(v['value'] > 0 for v in line['metrics'].values()
             if v['unit'] != 'GiB')


@pytest.mark.parametrize('cell', ['curves-stream-4k', 'gpyrnn-train-2048'])
def test_traced_run_is_correct_and_summarized(cell):
  _, out, line = small_run(cell, trace_on=1)
  assert out.correct
  assert out.summary is not None and out.summary.iterations > 0
  assert line['device']['window_s'] > 0
  assert set(line['breakdown']) == {'device_ops', 'idle_gaps'}
  # No device on the CPU: the device readers find nothing to read.
  assert not any('roofline' in k or 'idle' in k for k in line['metrics'])


def test_same_seed_same_inputs_any_seed_size():
  from portbench import inputs
  for seed in (0, 2**31 + 5, 2**40 + 1):
    a = inputs.stream_frames(seed, 2, 8, 12, 'cpu')
    b = inputs.stream_frames(seed, 2, 8, 12, 'cpu')
    assert all((x == y).all() for x, y in zip(a, b))
  c = inputs.stream_frames(1, 2, 8, 12, 'cpu')
  assert not all((x == y).all() for x, y in zip(a, c))


def _alter_frames(monkeypatch):
  from hdrnet_torch.inference import Enhancer
  make = Enhancer.make_stream_fn

  def altered(self, shape):
    fn = make(self, shape)

    def run(x):
      out = fn(x).clone()
      out[:, :2, :2, 0] += 3
      return out
    return run
  monkeypatch.setattr(Enhancer, 'make_stream_fn', altered)


def _state_unchanged(monkeypatch):
  monkeypatch.setattr(torch.optim.Adam, 'step', lambda self, closure=None: None)


def _half_loss(monkeypatch):
  from hdrnet_torch.training import metrics
  whole = metrics.l2_loss

  def half(target, prediction, mesh=None):
    h = target.shape[1] // 2
    return whole(target[:, :h], prediction[:, :h], mesh)
  monkeypatch.setattr(metrics, 'l2_loss', half)


def _alter_batch(monkeypatch):
  from portbench.drivers import train
  gather = train.augment_batch

  def altered(*args):
    batch = gather(*args)
    batch['image_input'] = batch['image_input'].clone()
    batch['image_input'][:, 0, 0] += 1
    return batch
  monkeypatch.setattr(train, 'augment_batch', altered)


FAULTS = [(c, f) for c in CELLS for f in (
    [_alter_frames] if 'stream' in c
    else [_state_unchanged, _half_loss, _alter_batch])]


@pytest.mark.parametrize('cell,fault', FAULTS,
                         ids=[f'{c}-{f.__name__[1:]}' for c, f in FAULTS])
def test_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
  fault(monkeypatch)
  _, out, line = small_run(cell)
  assert not out.correct, line['checks']


# The control at the configurations' own widths on small frames: its
# error comes from the backbone and guides, which keep their widths.
CONTROL_TRAFFIC = {
    'stream': {'height': 144, 'width': 256, 'pool': 2, 'compare_frames': 2},
    'train': {'crop': 256, 'pair_size': 288, 'pairs': 2},
}


@pytest.mark.parametrize('seed', [SEED, 5])
@pytest.mark.parametrize('cell', CELLS)
def test_control_fails_a_limit(cell, seed):
  """The reference in TF32 put in the program's place fails one of the
  cell's numbers (here on the CPU, its TF32 products emulated; on the
  card at the cell's own size, PERF.md)."""
  import time
  kind = 'stream' if 'stream' in cell else 'train'
  run = harness.make_run(cell, seed, 1.0, 0, 'cpu', time.monotonic(),
                         traffic=CONTROL_TRAFFIC[kind])
  got = harness.driver(run).control(run)
  tf32 = {k.split('.', 1)[1]: v for k, v in got.items()
          if k.startswith('tf32.')}
  assert any(v > run.limits[k] for k, v in tf32.items()), (tf32, run.limits)


def test_command_refuses_without_a_card():
  proc = subprocess.run(
      [sys.executable, '-m', 'portbench.run', '--workload', CELLS[0],
       '--seed', str(2**31 + 1), '--seconds', '1', '--trace', '0'],
      cwd=ROOT, capture_output=True, text=True, timeout=300)
  assert proc.returncode != 0
  assert '{' not in proc.stdout
  assert 'needs 1 CUDA device' in proc.stderr


def test_command_refuses_with_only_the_benchmark_files(tmp_path):
  shutil.copy(ROOT / 'BENCHMARK.json', tmp_path)
  shutil.copytree(ROOT / 'portbench', tmp_path / 'portbench',
                  ignore=shutil.ignore_patterns('__pycache__'))
  for argv in (['-m', 'portbench.run', '--workload', CELLS[0], '--seed', '1',
                '--seconds', '1', '--trace', '0'],
               ['-c', 'import portbench.drivers.stream']):
    proc = subprocess.run([sys.executable, *argv], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '{' not in proc.stdout


def test_no_jax_module_after_a_run():
  code = (
      'import sys, json\n'
      'from portbench.tests.test_portbench_runs import small_run\n'
      'small_run("gpyrnn-stream-4k")\n'
      'small_run("gpyrnn-train-2048")\n'
      'from portbench.harness import banned_modules\n'
      'print(json.dumps([banned_modules(), "hdrnet_torch" in sys.modules]))\n')
  proc = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                        capture_output=True, text=True, timeout=600)
  assert proc.returncode == 0, proc.stderr[-2000:]
  assert json.loads(proc.stdout.splitlines()[-1]) == [[], True]


def test_banned_modules_compare_whole_top_level_names(monkeypatch):
  monkeypatch.setitem(sys.modules, 'jaxish', sys)
  monkeypatch.setitem(sys.modules, 'hdrnet_tpu_extra', sys)
  assert harness.banned_modules() == []
  monkeypatch.setitem(sys.modules, 'jax.numpy', sys)
  monkeypatch.setitem(sys.modules, 'hdrnet_tpu', sys)
  assert harness.banned_modules() == ['hdrnet_tpu', 'jax']


def test_trace_summary_and_readers():
  from portbench.harness import read_layer_metric
  A = trace.Activity
  device = [A('void enhance_fused_kernel<hdrnet::CurvesGuide, u8>', 10, 30,
              'kernel'),
            A('Memcpy HtoD (Pinned -> Device)', 25, 40, 'memcpy'),
            A('void pix_bwd_fixed_kernel<true>', 60, 70, 'kernel'),
            A('void grid_bwd_partial_kernel', 70, 80, 'kernel'),
            A('void enhance_fused_kernel<hdrnet::LoadedGuide>', 80, 90,
              'kernel')]
  host = [A('stream.client', 40, 60), A('aten::copy_', 45, 55)]
  s = trace.Summary(0.0, 100.0, 2, device, host,
                    {'flops': 67e6, 'fused_bound_s': 10e-6,
                     'slice_apply_bound_s': 15e-6})
  assert s.busy_intervals() == [[10, 40], [60, 90]]
  assert s.busy_s == pytest.approx(60e-6)
  assert s.window_s == pytest.approx(100e-6)
  gaps = dict(s.idle_gaps())
  assert gaps['aten::copy_'] == pytest.approx(20e-6)
  assert gaps['no host range'] == pytest.approx(20e-6)
  assert read_layer_metric('serve.device_idle_pct', s) == pytest.approx(40.0)
  # 2 frames x 10 us of bound over 20 us of K1.
  assert read_layer_metric('fused_roofline', s) == pytest.approx(100.0)
  # 2 steps x 15 us over K3 + K4 + K5's 30 us.
  assert read_layer_metric('slice_apply_roofline', s) == pytest.approx(100.0)
  assert read_layer_metric('stream.copy_ms_per_frame', s) == pytest.approx(
      0.0075)
  assert read_layer_metric('serve.launches_per_frame', s) == 2.5
  assert read_layer_metric('serve.mfu_pct', s) == pytest.approx(
      100 * 67e6 * 2 / (100e-6 * 67e12))
  empty = trace.Summary(0.0, 100.0, 2, [], host, {})
  assert empty.busy_s == 0 and empty.top_ops() == []
  for name in ('fused_roofline', 'slice_apply_roofline', 'serve.mfu_pct',
               'stream.copy_ms_per_frame', 'serve.device_idle_pct'):
    assert read_layer_metric(name, empty) is None


class _Event:
  def __init__(self, name, device, kind, start, dur):
    self.row = (name, device, kind, start, dur)

  def name(self):
    return self.row[0]

  def device_type(self):
    return self.row[1]

  def activity_type(self):
    return self.row[2]

  def start_ns(self):
    return self.row[3]

  def duration_ns(self):
    return self.row[4]


def test_summarize_keeps_work_on_the_card_only():
  cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
  events = [_Event(trace.MARK, cpu, 'user_annotation', 1000, 9000),
            _Event(trace.MARK, cuda, 'gpu_user_annotation', 1000, 9000),
            _Event('train.feed', cuda, 'gpu_user_annotation', 2000, 1000),
            _Event('k', cuda, 'kernel', 500, 1000),
            _Event('Memcpy HtoD', cuda, 'gpu_memcpy', 3000, 1000),
            _Event('Memset (Device)', cuda, 'gpu_memset', 5000, 500),
            _Event('late', cuda, 'kernel', 20000, 10),
            _Event('aten::add', cpu, 'cpu_op', 2000, 500),
            _Event('backward', cpu, 'cpu_op', 2000, 500)]
  s = trace.summarize(events, 3)
  assert [(a.name, a.kind) for a in s.device] == [
      ('k', 'kernel'), ('Memcpy HtoD', 'memcpy'),
      ('Memset (Device)', 'memset')]
  assert s.device[0].start == 1.0  # clipped to the window
  assert [a.name for a in s.host] == ['aten::add', 'backward']
  assert s.window_s == pytest.approx(9e-6)
