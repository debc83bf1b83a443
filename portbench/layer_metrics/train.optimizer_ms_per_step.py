"""Host time inside ``hdrnet.train.optimizer`` (Adam's step), a step of
the traced stretch."""

from portbench import spans


def read(s):
  return spans.ms_per_iteration(s, 'hdrnet.train.optimizer')
