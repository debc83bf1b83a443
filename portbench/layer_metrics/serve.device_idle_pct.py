"""Share of the traced stretch of frames in which nothing (no kernel, no
copy, no set) ran on the card."""


def read(s):
  return s.idle_pct()
