"""The readers of the program's spans (``portbench/spans.py`` and the
``program_span`` metrics): values by hand on a synthetic stretch, spans
clipped at its ends, nothing where the spans are absent, and a traced
CPU run of a stream cell and of the train cell."""

import pytest

from portbench import trace
from portbench.harness import read_layer_metric
from portbench.tests.test_portbench_runs import small_run

A = trace.Activity
STREAM = ('stream.pin_ms_per_frame', 'stream.wait_ms_per_frame',
          'stream.host_allocs_per_frame', 'serve.dispatch_ms_per_frame',
          'serve.idle_in_pin_pct')
TRAIN = ('train.forward_ms_per_step', 'train.backward_ms_per_step',
         'train.optimizer_ms_per_step')


def _summary(device=True):
  """A stretch [100, 300] us of 2 iterations, busy over [120, 160] and
  [200, 220]: idle 20 + 40 + 80 = 140 us."""
  dev = [A('void enhance_fused_kernel', 120, 160, 'kernel'),
         A('Memcpy HtoD (Pinned -> Device)', 200, 220, 'memcpy')]
  host = [
      A('hdrnet.stream.pin', 90, 130),        # clipped to [100, 130]
      A('cudaMallocHost', 95, 96),            # in it, before the stretch
      A('cudaHostAlloc', 105, 110),
      A('hdrnet.stream.pin', 170, 190),
      A('hdrnet.serve.forward', 130, 170),
      A('cudaHostAlloc', 140, 141),           # in no pin or readback
      A('hdrnet.stream.readback', 250, 320),  # clipped to [250, 300]
      A('cudaHostAlloc', 260, 262),
      A('hdrnet.stream.wait', 280, 310),      # clipped to [280, 300]
      A('hdrnet.serve.forward', 310, 330),    # past the stretch
      A('hdrnet.train.forward', 50, 150),     # clipped to [100, 150]
      A('hdrnet.train.backward', 150, 250),
      A('hdrnet.train.optimizer', 250, 400),  # clipped to [250, 300]
  ]
  return trace.Summary(100.0, 300.0, 2, dev if device else [], host, {})


def test_span_readers_by_hand():
  s = _summary()
  want = {
      'stream.pin_ms_per_frame': (30 + 20) * 1e-3 / 2,
      'stream.wait_ms_per_frame': 20 * 1e-3 / 2,
      'stream.host_allocs_per_frame': 2 / 2,
      'serve.dispatch_ms_per_frame': 40 * 1e-3 / 2,
      # Idle [100, 120] and [160, 200] meet the pins for 20 + 20 us.
      'serve.idle_in_pin_pct': 100 * 40 / 140,
      'train.forward_ms_per_step': 50 * 1e-3 / 2,
      'train.backward_ms_per_step': 100 * 1e-3 / 2,
      'train.optimizer_ms_per_step': 50 * 1e-3 / 2,
  }
  for name, value in want.items():
    assert read_layer_metric(name, s) == pytest.approx(value), name


def test_span_readers_find_nothing_without_their_spans():
  s = _summary()
  s.host = []
  for name in STREAM + TRAIN:
    assert read_layer_metric(name, s) is None, name
  # The pins are there, but no device activity: no idle share.
  assert read_layer_metric('serve.idle_in_pin_pct',
                           _summary(device=False)) is None


def test_host_allocs_read_zero_once_warm():
  s = _summary()
  s.host = [h for h in s.host if not h.name.startswith('cuda')]
  assert read_layer_metric('stream.host_allocs_per_frame', s) == 0.0


@pytest.mark.parametrize('cell,present', [
    ('curves-stream-4k', ('serve.dispatch_ms_per_frame',
                          'stream.wait_ms_per_frame')),
    ('gpyrnn-train-2048', TRAIN)])
def test_traced_cpu_run_reports_the_span_metrics(cell, present):
  _, out, line = small_run(cell, trace_on=1)
  assert out.correct
  for name in present:
    assert line['metrics'][name]['value'] > 0, name
  # The copies' spans are the card's only; no device, no idle share.
  for name in ('stream.pin_ms_per_frame', 'stream.host_allocs_per_frame',
               'serve.idle_in_pin_pct'):
    assert name not in line['metrics']
