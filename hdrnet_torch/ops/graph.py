"""One CUDA graph of a function that launches the port's kernels: the
stream's forward (``inference._StreamGraph``) and the train step
(``training.step._StepGraph``) capture and replay through it, so both
count launches, hold tables and treat cuBLAS's workspace alike."""

from __future__ import annotations

import torch

from hdrnet_torch.ops import _build
from hdrnet_torch.ops.resize import holding_tables
from hdrnet_torch.utils.timing import span


class CapturedGraph:
  """``fn()`` captured as one CUDA graph under the span `name`: the
  capture runs nothing, and ``replay()`` runs the captured launches and
  returns ``fn``'s outputs, which the next replay overwrites. ``tables``
  keeps the cached device tables that the launches read. Raises what
  the capture raised (a launch that cannot be captured)."""

  def __init__(self, fn, name):
    self.graph = torch.cuda.CUDAGraph()
    counts = _build.launches.copy()
    # cuBLAS holds a 32 MiB workspace a stream. Dropped before the capture
    # and after it, as torch's own graph trees do: the capture's then lies
    # in the graph's pool, allocated to nothing, and the eager stream's is
    # not held while the graphs run.
    torch._C._cuda_clearCublasWorkspaces()
    try:
      # Relaxed: a launcher may set a kernel attribute on its first call
      # at a shape, which global capture mode refuses as unsafe.
      with (span(name), holding_tables() as self.tables,
            torch.cuda.graph(self.graph, capture_error_mode='relaxed')):
        self.outputs = fn()
    finally:
      torch._C._cuda_clearCublasWorkspaces()
      # A capture launches nothing and a replay launches what it
      # captured: the capture's counts move to its replays.
      self.launches = _build.launches - counts
      _build.launches.subtract(self.launches)

  def replay(self):
    self.graph.replay()
    _build.launches.update(self.launches)
    return self.outputs
