"""Host time inside ``hdrnet.stream.pin`` (the frame's copy from pageable
into pinned host memory), a frame of the traced stretch."""

from portbench import spans


def read(s):
  return spans.ms_per_iteration(s, 'hdrnet.stream.pin')
