"""Host time inside ``hdrnet.train.forward`` (the batch's normalization,
the learning rates, the forward and the loss), a step of the traced
stretch."""

from portbench import spans


def read(s):
  return spans.ms_per_iteration(s, 'hdrnet.train.forward')
