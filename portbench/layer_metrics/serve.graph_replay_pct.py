"""Share of the traced stretch's frames whose forward was the replay of a
captured CUDA graph: the ``hdrnet.serve.replay`` spans in the stretch
over its frames, x 100."""

from portbench import spans


def read(s):
  replays = spans.clipped(s, 'hdrnet.serve.replay')
  if not replays:
    return None
  return 100.0 * len(replays) / s.iterations
