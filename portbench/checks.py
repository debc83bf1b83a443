"""The numbers that decide ``correct``: the program's outputs against the
plain reference's, each held to the limit in its cell's file.

Serving: ``code_excess``, the widest gap by which an output code lies
from 255 x the reference's value, less the half code that rounding
itself allows, over every pixel of the compared frames.

Training (the first steps, which the window's own call and feed ran):
``batch_mismatch``, values of the device-augmented batches that differ
from the reference's crop and preview (exact); ``loss_gap``, the largest
relative gap of a step's loss; ``grad_gap``, the worst leaf's gap between
the norms of the first gradient (read from Adam's first moment after one
step); ``change_gap``, the worst leaf's gap between the norms of the
parameters' change over the steps. A leaf's gap is measured against the
reference's norm of that leaf or of the median leaf, whichever is larger;
``change_gap`` leaves out leaves whose reference gradient is under a
thousandth of the median leaf's (they move under Adam by round-off).
"""

from __future__ import annotations

import statistics

import numpy as np
import torch

QUIET_LEAF = 1e-3


def code_excess(codes, ref):
  """codes: uint8 array or tensor; ref: float tensor in [0, 1] of the same
  shape. max |code - 255 ref| - 0.5."""
  codes = torch.as_tensor(np.asarray(codes)).to(ref.device, torch.float32)
  return float((codes - 255.0 * ref).abs().max()) - 0.5


def _leaf_gap(prog, ref, keys):
  norms_r = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in keys}
  floor = statistics.median(norms_r.values())
  worst = 0.0
  for k in keys:
    p = float(torch.linalg.vector_norm(prog[k].double()))
    worst = max(worst, abs(p - norms_r[k]) / max(norms_r[k], floor))
  return worst


def train_numbers(prog, ref):
  """prog / ref: {'batches': [dict of uint8 tensors], 'losses': [...],
  'grads1': {name: tensor}, 'change': {name: tensor}}; the reference's
  'batches' the same keys. Returns the four numbers."""
  mismatch = 0
  for pb, rb in zip(prog['batches'], ref['batches'], strict=True):
    for k, r in rb.items():
      p = pb[k]
      mismatch += r.numel() if p.shape != r.shape else int((p != r).sum())
  losses = [abs(p - r) / abs(r) for p, r in zip(prog['losses'],
                                                ref['losses'], strict=True)]
  keys = sorted(ref['grads1'])
  g_norm = {k: float(torch.linalg.vector_norm(ref['grads1'][k].double()))
            for k in keys}
  quiet = QUIET_LEAF * statistics.median(g_norm.values())
  moved = [k for k in keys if g_norm[k] >= quiet]
  return {'batch_mismatch': float(mismatch),
          'loss_gap': max(losses),
          'grad_gap': _leaf_gap(prog['grads1'], ref['grads1'], keys),
          'change_gap': _leaf_gap(prog['change'], ref['change'], moved)}


def judge(numbers, limits):
  """{name: {'value', 'limit'}} for every number, and whether all hold
  (a NaN holds no limit)."""
  out = {k: {'value': v, 'limit': limits[k]} for k, v in numbers.items()}
  ok = all(v['value'] <= v['limit'] for v in out.values())
  return out, ok
