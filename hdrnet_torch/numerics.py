"""Interpolation numerics shared by every bilateral-grid op (PyTorch).

Elementwise counterparts of :mod:`hdrnet_tpu.numerics`, on tensors.

Conventions (OpenGL-style):
  * integer sample coordinates live at pixel *centers* (k + 0.5),
  * continuous query coordinates live on the pixel *edge* lattice.

``EPS = 1e-8`` is the reference smoothing constant (ops/numerics.h:83, 109).
"""

from __future__ import annotations

import torch

EPS = 1e-8


def lerp_weight(x, xs):
  """Tent weight: 1 at ``x == xs``, 0 once ``|x - xs| >= 1``."""
  return torch.clamp(1.0 - torch.abs(x - xs), min=0.0)


def smoothed_abs(x, eps=EPS):
  """``sqrt(x*x + eps)``: smoothed |x|."""
  return torch.sqrt(x * x + eps)


def smoothed_abs_grad(x, eps=EPS):
  """Smoothed sign(x): ``x / sqrt(x*x + eps)``."""
  return x * torch.reciprocal(torch.sqrt(x * x + eps))


def smoothed_lerp_weight(x, xs, eps=EPS):
  """Tent weight with a smoothed kink, used on the guide (depth) axis:
  ``max(1 - sqrt((x-xs)^2 + eps), 0)``."""
  return torch.clamp(1.0 - smoothed_abs(x - xs, eps), min=0.0)


def smoothed_lerp_weight_grad(x, xs, eps=EPS):
  """d smoothed_lerp_weight(x, xs) / d xs: zero outside the tent support,
  otherwise the smoothed sign of ``x - xs``."""
  dx = x - xs
  abs_dx = smoothed_abs(dx, eps)
  return torch.where(abs_dx > 1.0, torch.zeros_like(dx),
                     smoothed_abs_grad(dx, eps))


def mirror_boundary(x, extent):
  """Edge-inclusive mirror: -1 -> 0, -2 -> 1, extent -> extent-1.
  Valid for ``-extent <= x < 2 * extent``."""
  x = torch.where(x < 0, -x - 1, x)
  return torch.where(x >= extent, 2 * extent - 1 - x, x)
