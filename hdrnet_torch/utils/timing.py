"""Device time of a call on a CUDA card, with no host gaps between its
launches."""

from __future__ import annotations

import torch


def graph_ms(call, iters=20, replays=5):
  """Device ms of one call: a CUDA graph of `iters` calls, replayed
  `replays` times between two CUDA events."""
  side = torch.cuda.Stream()
  side.wait_stream(torch.cuda.current_stream())
  with torch.cuda.stream(side):
    call()  # warm-up, outside the capture
  torch.cuda.current_stream().wait_stream(side)
  graph = torch.cuda.CUDAGraph()
  # Relaxed: a launcher may set a kernel attribute on its first call at a
  # shape, which global capture mode refuses as unsafe.
  with torch.cuda.graph(graph, capture_error_mode='relaxed'):
    for _ in range(iters):
      call()
  graph.replay()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  torch.cuda.synchronize()
  start.record()
  for _ in range(replays):
    graph.replay()
  end.record()
  end.synchronize()
  return start.elapsed_time(end) / (replays * iters)
