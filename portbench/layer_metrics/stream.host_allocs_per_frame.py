"""Pinned host allocations (the CUDA runtime's ``cudaHostAlloc`` and
``cudaMallocHost`` calls) that start inside ``hdrnet.stream.pin`` or
``hdrnet.stream.readback``, a frame of the traced stretch: 0 once the
stream reuses its pinned buffers."""

from portbench import spans

PHASES = ('hdrnet.stream.pin', 'hdrnet.stream.readback')
ALLOCS = ('cudaHostAlloc', 'cudaMallocHost')


def read(s):
  inside = spans.union([x for name in PHASES for x in spans.clipped(s, name)])
  if not inside:
    return None
  calls = [h.start for h in s.host if h.name in ALLOCS]
  n = sum(any(b <= t < e for b, e in inside) for t in calls)
  return n / s.iterations
