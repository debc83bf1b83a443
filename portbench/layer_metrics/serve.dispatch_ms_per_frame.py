"""Host time inside ``hdrnet.serve.forward`` (a frame's preview, backbone,
guide, slice and apply, levels and quantization, dispatched to the
device), a frame of the traced stretch."""

from portbench import spans


def read(s):
  return spans.ms_per_iteration(s, 'hdrnet.serve.forward')
