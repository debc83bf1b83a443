"""The program's own spans (``hdrnet.*`` ranges) in a traced stretch:
the readers of the per-layer metrics that time a phase of the port or
count what happens inside one. Each works from ``trace.Summary``'s host
ranges, clipped to the stretch, and finds nothing (None) where the
program opens no such span."""

from __future__ import annotations


def clipped(s, name):
  """[start, end] of every host range called `name`, cut to [t0, t1]."""
  return [(max(h.start, s.t0), min(h.end, s.t1)) for h in s.host
          if h.name == name and h.end > s.t0 and h.start < s.t1]


def ms_per_iteration(s, name):
  """The summed length of the `name` spans, in ms an iteration."""
  spans = clipped(s, name)
  if not spans:
    return None
  return sum(e - b for b, e in spans) * 1e-3 / s.iterations


def union(spans):
  """Sorted disjoint [start, end] covering `spans`."""
  out = []
  for b, e in sorted(spans):
    if out and b <= out[-1][1]:
      out[-1][1] = max(out[-1][1], e)
    else:
      out.append([b, e])
  return out


def overlap(a, b):
  """Length of the intersection of two sorted disjoint span lists."""
  total, i, j = 0.0, 0, 0
  while i < len(a) and j < len(b):
    lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
    total += max(hi - lo, 0.0)
    if a[i][1] < b[j][1]:
      i += 1
    else:
      j += 1
  return total


def idle_intervals(s):
  """The stretch's device-idle time: [t0, t1] less the busy intervals."""
  edges = [s.t0] + [x for span in s.busy_intervals() for x in span] + [s.t1]
  return [[b, e] for b, e in zip(edges[::2], edges[1::2]) if e > b]
