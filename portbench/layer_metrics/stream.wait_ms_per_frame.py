"""Host time inside ``hdrnet.stream.wait`` (the wait on the oldest frame
in flight and its hand-over as numpy), a frame of the traced stretch."""

from portbench import spans


def read(s):
  return spans.ms_per_iteration(s, 'hdrnet.stream.wait')
