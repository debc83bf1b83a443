"""The traced run's profiler window, held in memory and reduced to what
the per-layer readers and the result's ``breakdown`` need.

``Window`` profiles a stretch of whole iterations (frames or steps) of
the measured window with ``torch.profiler`` (host and CUDA activity),
under a ``portbench.window`` range that marks its ends on the trace's
clock. Nothing is written to disk: ``Summary`` keeps the device
activities (kernels, copies, sets) and the host ranges of every thread
(the backward runs on autograd's own), as plain tuples.
"""

from __future__ import annotations

import collections
import dataclasses

import torch
from torch.profiler import ProfilerActivity, profile, record_function

MARK = 'portbench.window'


# The profiler's device activities that are work on the card; its other
# device rows (user ranges projected onto the device's timeline) are not.
DEVICE_KINDS = {'kernel': 'kernel', 'gpu_memcpy': 'memcpy',
                'gpu_memset': 'memset'}


@dataclasses.dataclass
class Activity:
  name: str
  start: float  # us on the trace's clock
  end: float
  kind: str = 'host'  # or kernel, memcpy, memset


@dataclasses.dataclass
class Summary:
  """A traced stretch of `iterations` frames or steps over [t0, t1]."""
  t0: float
  t1: float
  iterations: int
  device: list      # Activity on the device, clipped to [t0, t1]
  host: list        # Activity of the host's ranges, every thread
  work: dict = dataclasses.field(default_factory=dict)

  @property
  def window_s(self):
    return (self.t1 - self.t0) * 1e-6

  def busy_intervals(self):
    """The union of the device activities, as sorted disjoint spans."""
    spans = []
    for a in sorted(self.device, key=lambda a: a.start):
      if spans and a.start <= spans[-1][1]:
        spans[-1][1] = max(spans[-1][1], a.end)
      else:
        spans.append([a.start, a.end])
    return spans

  @property
  def busy_s(self):
    return sum(e - s for s, e in self.busy_intervals()) * 1e-6

  def idle_pct(self):
    """Share of the stretch in which nothing (no kernel, no copy, no set)
    ran on the card."""
    if not self.device or self.window_s <= 0:
      return None
    return 100.0 * (1.0 - self.busy_s / self.window_s)

  def launches_per_iteration(self):
    """Kernels, copies and sets on the card, an iteration of the stretch
    (the stretch holds the device work of exactly its iterations)."""
    if not self.device:
      return None
    return len(self.device) / self.iterations

  def mfu_pct(self):
    """Counted operations of an iteration (``work['flops']``) times the
    iterations, over the stretch's length times the float32 peak."""
    from portbench.counts import F32_OPS_PER_S
    if not self.work.get('flops') or self.window_s <= 0:
      return None
    return (100.0 * self.work['flops'] * self.iterations
            / (self.window_s * F32_OPS_PER_S))

  def matching(self, include):
    """Kernels whose name holds every word of one of `include`'s entries
    (a word or a tuple of words)."""
    def hit(name, entry):
      words = (entry,) if isinstance(entry, str) else entry
      return all(w in name for w in words)
    return [a for a in self.device if a.kind == 'kernel'
            and any(hit(a.name, e) for e in include)]

  def top_ops(self, n=10):
    """[[name, seconds]]: the device activities that took most time."""
    total = collections.Counter()
    for a in self.device:
      total[a.name[:120]] += (a.end - a.start) * 1e-6
    return [[k, v] for k, v in total.most_common(n)]

  def idle_gaps(self, n=10):
    """[[host range, seconds]]: idle device time summed by the innermost
    host range that ran at each gap's middle, the largest first."""
    spans = self.busy_intervals()
    edges = [self.t0] + [x for s in spans for x in s] + [self.t1]
    total = collections.Counter()
    for s, e in zip(edges[::2], edges[1::2]):
      if e <= s:
        continue
      mid = 0.5 * (s + e)
      inner = [h for h in self.host if h.start <= mid <= h.end]
      name = (min(inner, key=lambda h: h.end - h.start).name[:120]
              if inner else 'no host range')
      total[name] += (e - s) * 1e-6
    return [[k, v] for k, v in total.most_common(n)]


class Window:
  """Profiles from ``arm()``, before the measured window opens; the
  stretch runs from ``start()`` to ``stop(iterations)`` and ends on a
  device synchronization. (A profiler started just before a short
  stretch has been seen to record no device activity in it.)"""

  def __init__(self, device):
    acts = [ProfilerActivity.CPU]
    self.cuda = torch.device(device).type == 'cuda'
    if self.cuda:
      acts.append(ProfilerActivity.CUDA)
    self.prof = profile(activities=acts)
    self.mark = None
    self.summary = None

  @property
  def running(self):
    return self.mark is not None

  def arm(self):
    self.prof.start()

  def start(self):
    """Begins after the device has drained, so that the stretch holds the
    device work of its own iterations and nothing earlier."""
    if self.cuda:
      torch.cuda.synchronize()
    self.mark = record_function(MARK)
    self.mark.__enter__()

  def stop(self, iterations):
    """Ends the stretch (once) and keeps its Summary."""
    mark, self.mark = self.mark, None
    if self.cuda:
      torch.cuda.synchronize()
    mark.__exit__(None, None, None)
    self.prof.stop()
    self.summary = summarize(self.prof.profiler.kineto_results.events(),
                             iterations)
    return self.summary


def _activity(e):
  """The event's activity type; where the profiler does not say, a
  device row named after a host range is that range, and the rest is
  told apart by name."""
  get = getattr(e, 'activity_type', None)
  if get is not None:
    return get()
  if e.is_user_annotation():
    return 'user_annotation'
  name = e.name()
  if name.startswith('Memcpy'):
    return 'gpu_memcpy'
  if name.startswith('Memset'):
    return 'gpu_memset'
  return 'kernel?'


def summarize(events, iterations):
  """Summary of kineto events (``name()``, ``device_type()``,
  ``activity_type()`` where the profiler has it, ``start_ns()``,
  ``duration_ns()``)."""
  rows = [(e.name(), e.device_type(), _activity(e), e.start_ns() * 1e-3,
           (e.start_ns() + e.duration_ns()) * 1e-3) for e in events]
  marks = [r for r in rows if r[0] == MARK
           and r[1] != torch.autograd.DeviceType.CUDA]
  if not marks:
    raise RuntimeError('the trace holds no window mark')
  _, _, _, t0, t1 = marks[0]
  ranges = {r[0] for r in rows if r[1] != torch.autograd.DeviceType.CUDA}
  device, host = [], []
  for name, dtype, atype, s, e in rows:
    if e <= t0 or s >= t1:
      continue
    if atype == 'kernel?':
      atype = 'gpu_user_annotation' if name in ranges else 'kernel'
    if dtype == torch.autograd.DeviceType.CUDA:
      if atype in DEVICE_KINDS:
        device.append(Activity(name, max(s, t0), min(e, t1),
                               DEVICE_KINDS[atype]))
    elif name != MARK:
      host.append(Activity(name, s, e))
  return Summary(t0, t1, iterations, device, host)
