"""``serve.graph_replay_pct`` by hand on synthetic stretches: 100 with a
replay span a frame, a share where some frames ran eagerly, the spans
clipped at the stretch's ends, and nothing where the program opens no
``hdrnet.serve.replay`` span (the program before the stream's graphs)."""

import pytest

from portbench import trace
from portbench.harness import read_layer_metric

A = trace.Activity
NAME = 'serve.graph_replay_pct'


def _summary(replays, frames=4):
  """A stretch [0, 400] us of `frames` frames, a forward span a frame and
  a replay span inside the forwards listed in `replays`."""
  host = []
  for i in range(frames):
    host.append(A('hdrnet.serve.forward', 100 * i + 10, 100 * i + 20))
    if i in replays:
      host.append(A('hdrnet.serve.replay', 100 * i + 12, 100 * i + 18))
  dev = [A('void enhance_fused_kernel', 30, 40, 'kernel')]
  return trace.Summary(0.0, 400.0, frames, dev, host, {})


@pytest.mark.parametrize('replays,want', [((0, 1, 2, 3), 100.0),
                                          ((1, 2, 3), 75.0),
                                          ((3,), 25.0)])
def test_replay_share_by_hand(replays, want):
  assert read_layer_metric(NAME, _summary(replays)) == pytest.approx(want)


def test_replay_spans_clipped_to_the_stretch():
  """A span that straddles an end counts; one wholly outside does not."""
  s = _summary((0, 1, 2))
  s.host += [A('hdrnet.serve.replay', -20, -10),   # before the stretch
             A('hdrnet.serve.replay', 395, 405),   # straddles its end
             A('hdrnet.serve.replay', 410, 420)]   # after it
  assert read_layer_metric(NAME, s) == pytest.approx(100.0)


def test_no_replay_spans_read_nothing():
  assert read_layer_metric(NAME, _summary(())) is None
