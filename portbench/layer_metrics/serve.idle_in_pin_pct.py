"""Share of the traced stretch's device-idle time during which the host
is inside ``hdrnet.stream.pin``: how much of the card's idleness the
frame's copy into pinned memory holds."""

from portbench import spans


def read(s):
  pin = spans.union(spans.clipped(s, 'hdrnet.stream.pin'))
  idle = spans.idle_intervals(s)
  total = sum(e - b for b, e in idle)
  if not s.device or not pin or total <= 0:
    return None
  return 100.0 * spans.overlap(idle, pin) / total
