"""Counted operations of a frame (``counts.serve_frame_ops``) times the
frames of the traced stretch, over its length times the float32 peak."""


def read(s):
  return s.mfu_pct()
