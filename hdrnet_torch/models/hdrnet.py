"""The HDRNet models (counterparts of ``hdrnet_tpu.models.hdrnet``):
``CoefficientBackbone``, ``HDRNetCurves``, ``HDRNetPointwiseNNGuide`` and
``HDRNetGaussianPyrNN``.

A low-res coefficient CNN predicts a bilateral grid of affine color
transforms; a pointwise full-res guide indexes the grid; slice-apply
does the full-resolution work. The pyramid model does so on each level
of a bilinear Gaussian pyramid and adds the levels coarse to fine.
Submodule and parameter names follow the Flax modules, so
:mod:`hdrnet_torch.convert` maps weights by name.

Every model takes ``band=``: the full-resolution input is then an H-band
of the frame (mesh training's 'spatial' axis), and the output, the guide
maps and the pyramid levels are the band's rows of the whole frame's
(``parallel.halo``). The pointwise models take a bare (y_off, h_total);
the pyramid's resizes need a ``halo.Band`` on a process group.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from hdrnet_torch.config import ModelConfig
from hdrnet_torch.models.guides import CurveGuide, PointwiseNNGuide
from hdrnet_torch.models.layers import CenterBatchNorm, ConvBlock, DenseBlock
from hdrnet_torch.ops.slice_ops import bilateral_slice_apply
from hdrnet_torch.parallel import halo
from hdrnet_torch.utils.timing import span


class CoefficientBackbone(nn.Module):
  """Splat / global / local / fusion / prediction stack.

  Takes the NCHW preview (b, n_in, s, s) and returns the rank-6 grid
  (b, gh, gw, gd, n_out, n_in_tot).
  """

  def __init__(self, cfg: ModelConfig, n_out, n_in_tot, generator=None):
    super().__init__()
    gd, cm, sb = cfg.luma_bins, cfg.channel_multiplier, cfg.spatial_bin
    bn = cfg.batch_norm
    self.gd, self.n_out, self.n_in_tot = gd, n_out, n_in_tot
    self.n_ds = int(math.log2(cfg.net_input_size / sb))
    kw = dict(generator=generator)

    # Splat: stride-2 3x3 convs down to (sb, sb); no BN on the first.
    ch = cfg.n_in
    for i in range(self.n_ds):
      out = cm * (2 ** i) * gd
      self.add_module(f'splat_conv{i + 1}',
                      ConvBlock(ch, out, 3, stride=2,
                                batch_norm=bn and i > 0, **kw))
      ch = out

    # Global path: 2 stride-2 convs, then 3 FCs (the last linear, no BN).
    self.global_conv1 = ConvBlock(ch, 8 * cm * gd, 3, stride=2,
                                  batch_norm=bn, **kw)
    self.global_conv2 = ConvBlock(8 * cm * gd, 8 * cm * gd, 3, stride=2,
                                  batch_norm=bn, **kw)
    g_side = math.ceil(math.ceil(sb / 2) / 2)  # after two SAME stride-2s
    self.global_fc1 = DenseBlock(8 * cm * gd * g_side * g_side,
                                 32 * cm * gd, batch_norm=bn, **kw)
    self.global_fc2 = DenseBlock(32 * cm * gd, 16 * cm * gd, batch_norm=bn,
                                 **kw)
    self.global_fc3 = DenseBlock(16 * cm * gd, 8 * cm * gd, relu=False, **kw)

    # Local path: conv + linear bias-free conv.
    self.local_conv1 = ConvBlock(ch, 8 * cm * gd, 3, batch_norm=bn, **kw)
    self.local_conv2 = ConvBlock(8 * cm * gd, 8 * cm * gd, 3, use_bias=False,
                                 activation=None, **kw)

    # Prediction: linear 1x1 conv to gd * n_out * n_in_tot channels.
    self.prediction_conv = ConvBlock(8 * cm * gd, gd * n_out * n_in_tot, 1,
                                     activation=None, **kw)
    # The preview is cut over 'data' alone, so on a mesh its batch norms
    # reduce over 'data' (``parallel.mesh.replicate``).
    for m in self.modules():
      if isinstance(m, CenterBatchNorm):
        m.axis = 'data'

  def forward(self, lowres):
    with span('hdrnet.model.backbone'):
      x = lowres
      for i in range(self.n_ds):
        x = getattr(self, f'splat_conv{i + 1}')(x)
      splat = x

      g = self.global_conv2(self.global_conv1(splat))
      # Flatten in NHWC order, (h*W + w)*C + c, as the Flax model does.
      g = g.permute(0, 2, 3, 1).reshape(g.shape[0], -1)
      g = self.global_fc3(self.global_fc2(self.global_fc1(g)))

      l = self.local_conv2(self.local_conv1(splat))
      fused = F.relu(l + g[:, :, None, None])

      # Conv channel (j*n_out + i)*gd + k -> grid entry [..., k, i, j].
      y = self.prediction_conv(fused).permute(0, 2, 3, 1)
      b, gh, gw, _ = y.shape
      y = y.reshape(b, gh, gw, self.n_in_tot, self.n_out, self.gd)
      return y.permute(0, 1, 2, 5, 4, 3).contiguous()


class HDRNetCurves(nn.Module):
  """Main model: coefficient backbone + curves guide + slice-apply.

  ``forward(lowres, fullres)`` takes NHWC tensors, like the Flax model,
  and is differentiable: on the card the slice-apply runs kernel K3 and
  its backward K4 and K5; on the CPU their plain versions
  (:mod:`hdrnet_torch.ops.slice_ops`). ``forward_with_intermediates``
  also gives the guide map, which the guide regularizer reads (the Flax
  model sows it as ``intermediates/guide_map``). Serving goes through
  the fused kernel of ``hdrnet_torch.inference`` instead.
  """

  def __init__(self, cfg: ModelConfig, generator=None):
    super().__init__()
    self.cfg = cfg
    self.n_out = cfg.n_out
    self.n_in_tot = cfg.n_in + 1  # affine offset
    self.coefficients = CoefficientBackbone(cfg, self.n_out, self.n_in_tot,
                                            generator)
    self.guide = self.make_guide(cfg, generator)

  @staticmethod
  def make_guide(cfg, generator):
    return CurveGuide(cfg.n_in, generator=generator)

  def forward(self, lowres, fullres, band=None, return_intermediates=False):
    """The output; with ``return_intermediates`` also
    ``forward_with_intermediates``'s dict (through ``__call__``, so that
    forward hooks see a stage of ``HDRNetStack``)."""
    out, inter = self.forward_with_intermediates(lowres, fullres, band)
    return (out, inter) if return_intermediates else out

  def forward_with_intermediates(self, lowres, fullres, band=None):
    """The forward and what the Flax model sows at top level as
    intermediates: the grid ('bilateral_coefficients') and the guide maps
    ('guide_map', a list); ``bin/run.py --debug`` writes them and the
    guide regularizer reads the guide maps.

    band: None, or (y_off, h_total) when `fullres` holds rows y_off ..
    of a frame of h_total rows (an H-band of mesh training): the output
    and the guide are the band's rows of the whole frame's. A guide that
    reads neighbouring rows (``Guide3x3NN``) needs a ``halo.Band``."""
    grid = self.coefficients(lowres.permute(0, 3, 1, 2))
    guide = self.guide(fullres, band)
    out = bilateral_slice_apply(grid, guide, fullres, has_offset=True,
                                band=band)
    return out, {'bilateral_coefficients': grid, 'guide_map': [guide]}


class HDRNetPointwiseNNGuide(HDRNetCurves):
  """``HDRNetCurves`` with the pointwise NN guide; served by kernel K6."""

  @staticmethod
  def make_guide(cfg, generator):
    return PointwiseNNGuide(cfg.n_in, cfg.guide_complexity,
                            generator=generator)


def level_bands(band, n_scales):
  """The bands of a pyramid's levels, finest first: `band` (None for a
  whole frame) and its band of each halving (h // 2, h // 4, ...)."""
  if band is not None:
    halo.require_group(band, 'a pyramid')
  bands = [band]
  for _ in range(n_scales - 1):
    bands.append(None if band is None else bands[-1].at(
        bands[-1].h_total // 2))
  return bands


def gaussian_pyramid(x, n_scales, band=None):
  """[x, x/2, x/4, ...]: NHWC levels, finest first, each the bilinear
  (align_corners) resize of the one before to (h // 2, w // 2). band: the
  ``halo.Band`` of x's rows, and then each level is its band's rows
  (``level_bands``)."""
  levels = [x]
  with span('hdrnet.model.levels'):
    for lb in level_bands(band, n_scales)[:-1]:
      h = levels[-1].shape[1] if lb is None else lb.h_total
      w = levels[-1].shape[2]
      levels.append(halo.resize_bilinear(levels[-1], (h // 2, w // 2),
                                         align_corners=True, band=lb))
  return levels


def upsample_add(current, level_out, band=None, out_band=None):
  """One coarse-to-fine step: `current` resized bilinearly (align_corners)
  to `level_out`'s extent, plus `level_out`. On bands: `current`'s band
  and `level_out`'s."""
  size = (level_out.shape[1:3] if out_band is None
          else (out_band.h_total, level_out.shape[2]))
  with span('hdrnet.model.levels'):
    return halo.resize_bilinear(current, size, align_corners=True,
                                band=band) + level_out


def level_slice_apply(grid, guide, image, il, band=None):
  """The slice-apply of the il-th coarsest pyramid level: its 3-output
  block of the grid (channels 3 il .. 3 il + 2) sliced by `guide` and
  applied to `image` (the level's rows of `band`, if given). The block is
  a view of the grid: the slice-apply copies it, and its gradient lands
  in the grid's block."""
  return bilateral_slice_apply(grid[..., 3 * il:3 * (il + 1), :], guide,
                               image, has_offset=True, band=band)


def pyramid_slice_apply(grid, guides, images, zeroed=(), bands=None):
  """The pyramid's coarse-to-fine sum: level l (finest first) sliced by
  guides[l] from block il = n - 1 - l of the grid (``level_slice_apply``),
  applied to images[l] and added to the bilinear upsampling of the
  coarser levels' sum. A level whose il is in `zeroed` adds zeros in
  place of its output (the ablation of ``scripts/diagnose_pyramid.py``).
  bands: the levels' bands, finest first (``level_bands``), or None.
  """
  bands = (bands or [None] * len(images))[::-1]
  current = None
  for il, (guide, image) in enumerate(zip(guides[::-1], images[::-1])):
    out = level_slice_apply(grid, guide, image, il, bands[il])
    if il in zeroed:
      out = torch.zeros_like(out)
    current = out if current is None else upsample_add(
        current, out, bands[il - 1], bands[il])
  return current


class HDRNetGaussianPyrNN(nn.Module):
  """Multi-scale variant: a 3-level bilinear Gaussian pyramid of the
  full-res input, one NN guide (``guide_level_{l}``, finest first) and
  one 3-output slice of the grid per level, summed coarse to fine.

  The backbone predicts ``n_out = 3 * n_scales`` outputs; grid output
  block ``il`` (channels 3 il .. 3 il + 2) belongs to the il-th
  *coarsest* level. ``forward(lowres, fullres)`` takes NHWC tensors;
  ``forward_with_intermediates`` also gives the list of level guides,
  finest first (the order the Flax model sows them).
  """

  n_scales = 3

  def __init__(self, cfg: ModelConfig, generator=None):
    super().__init__()
    self.cfg = cfg
    self.n_out = 3 * self.n_scales
    self.n_in_tot = cfg.n_in + 1
    self.coefficients = CoefficientBackbone(cfg, self.n_out, self.n_in_tot,
                                            generator)
    for il in range(self.n_scales):
      self.add_module(f'guide_level_{il}',
                      self.make_level_guide(cfg, generator))

  @staticmethod
  def make_level_guide(cfg, generator):
    return PointwiseNNGuide(cfg.n_in, cfg.guide_complexity,
                            generator=generator)

  def level_guides(self):
    return [getattr(self, f'guide_level_{il}') for il in range(self.n_scales)]

  def forward(self, lowres, fullres, band=None):
    return self.forward_with_intermediates(lowres, fullres, band)[0]

  def forward_with_intermediates(self, lowres, fullres, band=None):
    """As ``HDRNetCurves.forward_with_intermediates``: the level guides
    and the levels finest first (on a band, each level's band rows; the
    resizes need a ``halo.Band``)."""
    grid = self.coefficients(lowres.permute(0, 3, 1, 2))
    levels = gaussian_pyramid(fullres, self.n_scales, band)
    guides = [g(lvl) for g, lvl in zip(self.level_guides(), levels)]
    out = pyramid_slice_apply(grid, guides, levels,
                              bands=level_bands(band, self.n_scales))
    return out, {'bilateral_coefficients': grid, 'guide_map': guides,
                 'multiscale': levels}
