"""Timing of the port: device time of a call on a CUDA card, with no host
gaps between its launches (``graph_ms``), and the named ranges the port
opens at its layer boundaries (``span``), which a profiler lays on one
clock with the device's activities."""

from __future__ import annotations

import contextlib

import torch
from torch.profiler import record_function

_NULL = contextlib.nullcontext()


def span(name):
  """``record_function(name)`` while a profiler is recording, else one
  shared context that does nothing.

  The gate keeps a span's cost with no profiler running to a flag check
  (an ungated ``record_function`` enters a profiler op on every call),
  and keeps profiler ops out of compiled and exported graphs. The ranges
  land in the profiler's own trace, beside the CUDA activities and on
  their clock: ``torch.profiler.profile`` around a call, or
  ``bin/train.py --profile_dir``, shows them with no other switch.
  """
  if not torch.autograd._profiler_enabled() or torch.compiler.is_compiling():
    return _NULL
  return record_function(name)


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
