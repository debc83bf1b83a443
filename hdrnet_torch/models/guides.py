"""Full-resolution guides (counterparts of ``hdrnet_tpu.models.guides``).

  * CurveGuide: learned color matrix -> per-channel 16-knot
    piecewise-linear curve -> channel mix -> clip to [0, 1].
  * PointwiseNNGuide: 1x1 conv (center-only BN, ReLU) -> 1x1 conv ->
    sigmoid.

Parameter names and shapes are the Flax modules', so converted weights
load by name. ``guide_mode`` names the fused serving kernel's mode and
``packed_params()`` returns the vector that kernel reads.
"""

from __future__ import annotations

import torch
from torch import nn

from hdrnet_torch.models.layers import BN_EPS, ConvBlock
from hdrnet_torch.ops.fused import (curves_guide, pack_curves_params,
                                    pack_nn_params)


class CurveGuide(nn.Module):
  """Guide map (b, h, w) from an NHWC image (b, h, w, n_chans)."""

  guide_mode = 'curves'

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


class PointwiseNNGuide(nn.Module):
  """Guide map (b, h, w) from an NHWC image (b, h, w, n_chans): a pointwise
  MLP, 1x1 conv to ``guide_complexity`` channels, center-only batch norm
  (always, whatever the model's ``batch_norm``: the reference's quirk),
  ReLU, 1x1 conv to one channel, sigmoid.

  ``conv1`` and ``conv2`` are ConvBlocks for their parameter names and
  init; the forward computes the two 1x1 convs as matrix products on the
  frame's channel axis, with no transpose of the full-resolution frame.
  They run in full float32 under ``full_float32`` (the Flax module uses
  precision 'highest').
  """

  guide_mode = 'nn'

  def __init__(self, n_chans=3, guide_complexity=16, generator=None):
    super().__init__()
    self.conv1 = ConvBlock(n_chans, guide_complexity, 1, batch_norm=True,
                           generator=generator)
    self.conv2 = ConvBlock(guide_complexity, 1, 1, relu=False,
                           generator=generator)

  def forward(self, x):
    n = x.shape[-1]
    w1 = self.conv1.conv.weight.reshape(-1, n)   # (gc, n)
    h = x.reshape(-1, n) @ w1.t()                # (pixels, gc)
    h = torch.relu(self.conv1.bn(h))  # BN over the feature axis 1
    w2 = self.conv2.conv.weight.reshape(1, -1)   # (1, gc)
    g = h @ w2.t() + self.conv2.conv.bias
    return torch.sigmoid(g).reshape(x.shape[:-1])

  @torch.no_grad()
  def packed_params(self):
    """The ((n_chans+2)*gc + 1,) float32 vector kernel K6 reads, with the
    batch norm's running statistics folded into conv1
    (``hdrnet_tpu.inference._nn_guide_params``)."""
    bn = self.conv1.bn
    w1 = self.conv1.conv.weight.reshape(bn.bias.numel(), -1).t()
    scale = 1.0 / torch.sqrt(bn.running_var + BN_EPS)
    w1_ext = torch.cat([w1 * scale, (bn.bias - bn.running_mean * scale)[None]])
    w2_ext = torch.cat([self.conv2.conv.weight.reshape(-1),
                        self.conv2.conv.bias.reshape(-1)])
    return pack_nn_params(w1_ext, w2_ext)
