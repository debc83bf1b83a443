"""Host time inside ``hdrnet.model.features`` (the full-resolution
feature towers' forward, three spans a step in the pyramid of features),
a step of the traced stretch."""

from portbench import spans


def read(s):
  return spans.ms_per_iteration(s, 'hdrnet.model.features')
