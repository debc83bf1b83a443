"""``train.graph_replay_pct`` by hand on synthetic stretches: 100 with a
replay span a step, a share where some steps ran eagerly, the spans
clipped at the stretch's ends, and nothing where the program opens no
``hdrnet.train.replay`` span (the program before the train step's
graph)."""

import pytest

from portbench import trace
from portbench.harness import read_layer_metric

A = trace.Activity
NAME = 'train.graph_replay_pct'


def _summary(replays, steps=4):
  """A stretch [0, 400] us of `steps` steps: a feed span a step, then a
  replay span where the step is listed in `replays`, else the eager
  phases."""
  host = []
  for i in range(steps):
    t = 100 * i
    host.append(A('train.feed', t + 2, t + 10))
    if i in replays:
      host.append(A('hdrnet.train.replay', t + 12, t + 18))
    else:
      host += [A('hdrnet.train.forward', t + 12, t + 30),
               A('hdrnet.train.backward', t + 30, t + 60),
               A('hdrnet.train.optimizer', t + 60, t + 70)]
    host.append(A('hdrnet.train.metrics', t + 80, t + 85))
  dev = [A('void slice_apply_fwd_kernel', 30, 40, 'kernel')]
  return trace.Summary(0.0, 400.0, steps, dev, host, {})


@pytest.mark.parametrize('replays,want', [((0, 1, 2, 3), 100.0),
                                          ((1, 2, 3), 75.0),
                                          ((3,), 25.0)])
def test_replay_share_by_hand(replays, want):
  assert read_layer_metric(NAME, _summary(replays)) == pytest.approx(want)


def test_replay_spans_clipped_to_the_stretch():
  """A span that straddles an end counts; one wholly outside does not."""
  s = _summary((0, 1, 2))
  s.host += [A('hdrnet.train.replay', -20, -10),   # before the stretch
             A('hdrnet.train.replay', 395, 405),   # straddles its end
             A('hdrnet.train.replay', 410, 420)]   # after it
  assert read_layer_metric(NAME, s) == pytest.approx(100.0)


def test_no_replay_spans_read_nothing():
  assert read_layer_metric(NAME, _summary(())) is None


def test_replayed_steps_leave_the_phase_metrics_silent():
  """A stretch of replays only opens no eager phase span, so the three
  phase metrics read nothing there."""
  s = _summary((0, 1, 2, 3))
  for name in ('train.forward_ms_per_step', 'train.backward_ms_per_step',
               'train.optimizer_ms_per_step'):
    assert read_layer_metric(name, s) is None
