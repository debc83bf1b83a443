"""Host time inside ``hdrnet.train.backward`` (zero_grad and the
backward; on a mesh, the gradients' all-reduce), a step of the traced
stretch."""

from portbench import spans


def read(s):
  return spans.ms_per_iteration(s, 'hdrnet.train.backward')
