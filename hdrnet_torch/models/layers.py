"""Conv and dense blocks with the reference's layer semantics.

Counterparts of ``hdrnet_tpu.models.layers``: He (variance-scaling,
fan-in, truncated normal) init, zero biases, SAME padding as XLA computes
it, and a *center-only* batch norm (learned shift, no scale, eps 1e-3)
in place of the bias, before the activation. Tensors are NCHW inside.

On an H-band of a frame (mesh training's 'spatial' axis;
``parallel.halo``) a ``ConvBlock`` takes the band's rows and gives its
output band's: the rows of the neighbouring bands that its kernel reads
are exchanged first, and the frame's SAME padding is applied only at the
frame's top and bottom. Its batch norm then sees each output pixel of the
mesh once.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from hdrnet_torch.parallel import halo
from hdrnet_torch.parallel.collectives import all_reduce

BN_EPS = 1e-3  # tf.contrib.layers.batch_norm default
BN_DECAY = 0.999  # Flax BatchNorm momentum: the running stats' decay


def he_normal_(weight, fan_in, generator=None):
  """Flax ``variance_scaling(2.0, 'fan_in', 'truncated_normal')``."""
  std = math.sqrt(2.0 / fan_in) / 0.87962566103423978
  with torch.no_grad():
    return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


def same_padding(size, kernel_size, stride, rate=1):
  """(lo, hi) padding of XLA's SAME for one spatial axis, the kernel
  dilated by `rate` (it spans rate * (k - 1) + 1). A stride-2 3x3 conv on
  an even extent pads (0, 1), where torch's padding=1 pads (1, 1)."""
  out = -(-size // stride)
  span = rate * (kernel_size - 1) + 1
  total = max((out - 1) * stride + span - size, 0)
  return total // 2, total - total // 2


class CenterBatchNorm(nn.Module):
  """Batch norm with a learned shift and no scale (layers.py:48-57).

  Training mode is Flax ``BatchNorm``'s, written out: normalize with the
  batch mean and the *biased* batch variance E[x^2] - E[x]^2 (clipped at
  0), and move the running statistics as
  ``running = 0.999 * running + 0.001 * batch`` for both. Eval mode
  normalizes with the running statistics.

  ``process_group`` (None: this process's batch alone) is set by mesh
  training (``parallel.mesh.replicate``), to the group of the mesh axis
  ``axis`` names (None, the default: the whole mesh, for full-resolution
  pixels; 'data': a coefficient backbone's, on the low-res inputs cut
  over 'data' alone, which sets it): the sums of x and x^2 and the
  count of values a feature are then summed over the group's ranks in one
  all-reduce (differentiably), so that the statistics are those of the
  global batch and the same on every rank; the ranks' shares may differ
  (the H-bands of a pyramid level cut unevenly).
  """

  def __init__(self, features):
    super().__init__()
    self.bias = nn.Parameter(torch.zeros(features))
    self.register_buffer('running_mean', torch.zeros(features))
    self.register_buffer('running_var', torch.ones(features))
    self.process_group = None
    self.axis = None

  def forward(self, x):
    if not self.training:
      return F.batch_norm(x, self.running_mean, self.running_var, None,
                          self.bias, False, 0.0, BN_EPS)
    # Features on axis 1 (NCHW or NC): reduce over every other axis.
    axes = [0] + list(range(2, x.ndim))
    if self.process_group is None:
      mean = x.mean(axes)
      mean_sq = (x * x).mean(axes)
    else:
      c = x.shape[1]
      count = x.new_full((1,), x.numel() // c)
      sums = all_reduce(torch.cat([x.sum(axes), (x * x).sum(axes), count]),
                        self.process_group)
      mean, mean_sq = sums[:c] / sums[-1], sums[c:2 * c] / sums[-1]
    var = torch.clamp(mean_sq - mean * mean, min=0.0)
    with torch.no_grad():
      self.running_mean.mul_(BN_DECAY).add_((1 - BN_DECAY) * mean)
      self.running_var.mul_(BN_DECAY).add_((1 - BN_DECAY) * var)
    shape = (1, -1) + (1,) * (x.ndim - 2)
    y = (x - mean.reshape(shape)) * torch.rsqrt(var + BN_EPS).reshape(shape)
    return y + self.bias.reshape(shape)


_ACTIVATIONS = {'relu': F.relu, 'sigmoid': torch.sigmoid, None: None}


class ConvBlock(nn.Module):
  """Conv2d (SAME, dilated by `rate`) + optional center-only BN + an
  activation: 'relu', 'sigmoid' or None."""

  def __init__(self, in_channels, features, kernel_size=3, stride=1,
               use_bias=True, batch_norm=False, activation='relu', rate=1,
               generator=None):
    super().__init__()
    if kernel_size % 2 == 0:
      raise ValueError('SAME padding here assumes an odd kernel size')
    self.kernel_size = kernel_size
    self.stride = stride
    self.rate = rate
    self.activation = _ACTIVATIONS[activation]
    # SAME at stride 1 with an odd kernel is symmetric, rate * (k - 1) / 2
    # a side, so on a whole frame the conv pads (and a forward hook on it,
    # as ``bin/viz_activations.py`` sets, sees its output); at stride 2 it
    # depends on the extent's parity, and on a band on its ends:
    # ``conv_rows`` pads.
    self.conv = nn.utils.skip_init(
        nn.Conv2d, in_channels, features, kernel_size, stride=stride,
        padding=rate * (kernel_size - 1) // 2 if stride == 1 else 0,
        dilation=rate, bias=use_bias and not batch_norm)
    he_normal_(self.conv.weight, kernel_size * kernel_size * in_channels,
               generator)
    if self.conv.bias is not None:
      nn.init.zeros_(self.conv.bias)
    self.bn = CenterBatchNorm(features) if batch_norm else None

  def forward(self, x, band=None):
    """x: NCHW; band: None, or the ``halo.Band`` of x's rows, and then the
    output is the rows of ``band.at(output height)``."""
    k, s = self.kernel_size, self.stride
    n_in = x.shape[-2]
    rows = self.source_rows(n_in, 0, -(-n_in // s))
    if band is not None and (k, s) != (1, 1):
      halo.require_group(band, 'a k x k convolution')
      n_in = band.h_total
      out = band.at(-(-n_in // s))
      needs = [self.source_rows(n_in, lo, hi) for lo, hi in out.bounds()]
      x = halo.exchange(x, band, needs, 2)
      rows = needs[band.index]
    x = self.conv_rows(x, rows, n_in)
    if self.bn is not None:
      x = self.bn(x)
    return x if self.activation is None else self.activation(x)

  def source_rows(self, n_in, lo, hi):
    """[a, b): the input rows (of an extent of n_in; rows outside it are
    the SAME padding) that output rows lo .. hi - 1 read."""
    k, s, r = self.kernel_size, self.stride, self.rate
    top, _ = same_padding(n_in, k, s, r)
    return halo.conv_source_rows(lo, hi, s, r * (k - 1) + 1, top)

  def conv_rows(self, x, rows, n_in):
    """The convolution (no batch norm, no activation) of the output rows
    whose input rows are `rows` ([a, b), ``source_rows``), from x, which
    holds their rows inside the extent of n_in: the SAME padding's zeros
    only where [a, b) leaves the extent (the whole frame's rows [0, n_out)
    read SAME's padding)."""
    k, s, r = self.kernel_size, self.stride, self.rate
    a, b = rows
    left, right = same_padding(x.shape[-1], k, s, r)
    pads = (left, right, max(-a, 0), max(b - n_in, 0))
    ph, pw = self.conv.padding
    if pads == (pw, pw, ph, ph):  # the conv's own
      return self.conv(x)
    x = F.pad(x, pads)
    if (ph, pw) == (0, 0):
      return self.conv(x)
    return F.conv2d(x, self.conv.weight, self.conv.bias, stride=s,
                    dilation=r)


class DenseBlock(nn.Module):
  """Linear + optional center-only BN + optional ReLU."""

  def __init__(self, in_features, features, use_bias=True, batch_norm=False,
               relu=True, generator=None):
    super().__init__()
    self.relu = relu
    self.fc = nn.utils.skip_init(nn.Linear, in_features, features,
                                 bias=use_bias and not batch_norm)
    he_normal_(self.fc.weight, in_features, generator)
    if self.fc.bias is not None:
      nn.init.zeros_(self.fc.bias)
    self.bn = CenterBatchNorm(features) if batch_norm else None

  def forward(self, x):
    x = self.fc(x)
    if self.bn is not None:
      x = self.bn(x)
    return F.relu(x) if self.relu else x
