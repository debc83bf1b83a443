"""Nearest resize with the legacy TF1 sampling convention.

``src = floor(dst * in / out)``, clipped, with the table computed in
float64 on the host: ``F.interpolate(mode='nearest')`` uses a float32
scale and can pick a different source row for sizes whose ratio is not
exact. Operates on (..., H, W, C) tensors.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _nearest_indices(n_in, n_out):
  scale = n_in / n_out
  idx = np.floor(np.arange(n_out) * scale).astype(np.int64)
  return np.clip(idx, 0, n_in - 1)


@functools.lru_cache(maxsize=64)
def nearest_index_tensor(n_in, n_out, device):
  """The floor table as an int32 tensor on `device`; cached, so a serving
  loop copies it to the card once per frame size. Callers must not
  write to it."""
  return torch.as_tensor(_nearest_indices(n_in, n_out).astype(np.int32),
                         device=device)


def resize_nearest(x, size):
  """Legacy TF1 nearest-neighbor resize on the (-3, -2) axes."""
  h, w = size
  if x.shape[-3] == h and x.shape[-2] == w:
    return x
  iy = nearest_index_tensor(x.shape[-3], h, x.device)
  ix = nearest_index_tensor(x.shape[-2], w, x.device)
  x = torch.index_select(x, x.ndim - 3, iy)
  return torch.index_select(x, x.ndim - 2, ix)
