"""Full-resolution curves guide (counterpart of
``hdrnet_tpu.models.guides.CurveGuide``).

Learned color matrix -> per-channel 16-knot piecewise-linear curve ->
channel mix -> clip to [0, 1]. Parameter names and shapes are the Flax
module's, so converted weights load by name.
"""

from __future__ import annotations

import torch
from torch import nn

from hdrnet_torch.ops.fused import curves_guide, pack_curves_params


class CurveGuide(nn.Module):
  """Guide map (b, h, w) from an NHWC image (b, h, w, n_chans)."""

  def __init__(self, n_chans=3, n_points=16, generator=None):
    super().__init__()
    # Near-identity color matrix: one shared N(0, 1) * 1e-4 perturbation.
    noise = torch.randn((), generator=generator)
    self.ccm = nn.Parameter(torch.eye(n_chans) + 1e-4 * noise)
    self.ccm_bias = nn.Parameter(torch.zeros(n_chans))
    # Knots at linspace [0, 1), slopes an identity ramp (slope 0 = 1).
    shifts = torch.arange(n_points, dtype=torch.float32) / n_points
    self.shifts = nn.Parameter(shifts.repeat(n_chans, 1))
    slopes = torch.zeros(n_chans, n_points)
    slopes[:, 0] = 1.0
    self.slopes = nn.Parameter(slopes)
    self.channel_mixing_w = nn.Parameter(
        torch.full((n_chans, 1), 1.0 / n_chans))
    self.channel_mixing_b = nn.Parameter(torch.zeros(1))

  def _mix(self):
    return torch.cat([self.channel_mixing_w.reshape(-1),
                      self.channel_mixing_b.reshape(-1)])

  def forward(self, x):
    ccm_ext = torch.cat([self.ccm, self.ccm_bias[None, :]])
    return curves_guide(x, ccm_ext, self.shifts, self.slopes, self._mix())

  @torch.no_grad()
  def packed_params(self):
    """The (112,) float32 parameter vector kernel K1 reads."""
    return pack_curves_params(
        torch.cat([self.ccm, self.ccm_bias[None, :]]),
        torch.cat([self.shifts, self.slopes]), self._mix())
