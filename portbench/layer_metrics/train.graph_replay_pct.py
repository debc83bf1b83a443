"""Share of the traced stretch's training steps that were the replay of a
captured CUDA graph: the ``hdrnet.train.replay`` spans in the stretch
over its steps, x 100."""

from portbench import spans


def read(s):
  replays = spans.clipped(s, 'hdrnet.train.replay')
  if not replays:
    return None
  return 100.0 * len(replays) / s.iterations
