"""Full-resolution guides (counterparts of ``hdrnet_tpu.models.guides``).

  * CurveGuide: learned color matrix -> per-channel 16-knot
    piecewise-linear curve -> channel mix -> clip to [0, 1].
  * PointwiseNNGuide: 1x1 conv (center-only BN, ReLU) -> 1x1 conv ->
    sigmoid.
  * Guide3x3NN: the same with a 3x3 first conv (``HDRNet3x3NNGuide``).
  * SimpleGuide: one 1x1 conv -> sigmoid (the feature pyramid's simple
    guide).

Parameter names and shapes are the Flax modules', so converted weights
load by name. ``guide_mode`` names the fused serving kernel's mode and
``packed_params()`` returns the vector that kernel reads. Each takes an
H-band of a frame (``band=``; mesh training's 'spatial' axis): the
pointwise guides need no other rows and ignore it; ``Guide3x3NN``'s 3x3
conv exchanges its halo rows (``parallel.halo``).
"""

from __future__ import annotations

import torch
from torch import nn

from hdrnet_torch.models.layers import BN_EPS, ConvBlock
from hdrnet_torch.ops.fused import (curves_guide, pack_curves_params,
                                    pack_nn_params)
from hdrnet_torch.utils.timing import span


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

  def forward(self, x, band=None):
    del band  # pointwise
    with span('hdrnet.model.guide'):
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
    self.conv2 = ConvBlock(guide_complexity, 1, 1, activation=None,
                           generator=generator)

  def forward(self, x, band=None):
    del band  # pointwise
    with span('hdrnet.model.guide'):
      return self.forward_with_intermediates(x)[0]

  def forward_with_intermediates(self, x):
    """The guide map and its layers' outputs, (b, h, w, c) each, under the
    Flax module names (``conv2`` ends in the sigmoid, as the Flax block
    does); ``bin/viz_activations.py`` reads them."""
    n = x.shape[-1]
    w1 = self.conv1.conv.weight.reshape(-1, n)   # (gc, n)
    h = x.reshape(-1, n) @ w1.t()                # (pixels, gc)
    bn = self.conv1.bn(h)  # BN over the feature axis 1
    act = torch.relu(bn)
    w2 = self.conv2.conv.weight.reshape(1, -1)   # (1, gc)
    g = act @ w2.t() + self.conv2.conv.bias
    out = torch.sigmoid(g)
    shape = x.shape[:-1] + (-1,)
    return out.reshape(x.shape[:-1]), {
        'conv1.conv': h.reshape(shape), 'conv1.bn': bn.reshape(shape),
        'conv1': act.reshape(shape), 'conv2.conv': g.reshape(shape),
        'conv2': out.reshape(shape)}

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


class Guide3x3NN(nn.Module):
  """Guide map (b, h, w) from an NHWC image (b, h, w, n_chans) whose first
  conv sees a 3x3 neighborhood: a 3x3 conv (SAME) to ``guide_complexity``
  channels, center-only batch norm (always, as the Flax module's), ReLU,
  a 1x1 conv to one channel, sigmoid. Real convolutions on the NCHW view
  of the frame, in full float32 under ``full_float32`` (the Flax module
  uses precision 'highest'); no serving kernel takes this guide."""

  def __init__(self, n_chans=3, guide_complexity=16, generator=None):
    super().__init__()
    self.conv1 = ConvBlock(n_chans, guide_complexity, 3, batch_norm=True,
                           generator=generator)
    self.conv2 = ConvBlock(guide_complexity, 1, 1, activation='sigmoid',
                           generator=generator)

  def forward(self, x, band=None):
    with span('hdrnet.model.guide'):
      return self.conv2(self.conv1(x.permute(0, 3, 1, 2), band))[:, 0]


class SimpleGuide(nn.Module):
  """Guide map (b, h, w) from an NHWC image: one 1x1 conv with a bias to
  one channel, sigmoid (a real convolution, as in ``Guide3x3NN``)."""

  def __init__(self, n_chans=3, generator=None):
    super().__init__()
    self.conv = ConvBlock(n_chans, 1, 1, activation='sigmoid',
                          generator=generator)

  def forward(self, x, band=None):
    del band  # pointwise
    with span('hdrnet.model.guide'):
      return self.conv(x.permute(0, 3, 1, 2))[:, 0]
