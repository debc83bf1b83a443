"""Counted operations of a training step (``counts.train_step_ops``,
forward and backward) times the steps of the traced stretch, over its
length times the float32 peak."""


def read(s):
  return s.mfu_pct()
