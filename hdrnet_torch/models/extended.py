"""The extended model zoo (counterparts of ``hdrnet_tpu.models.extended``).

  HDRNetGaussianPyr                 the pyramid with a curves guide a level
  HDRNet3x3NNGuide                  NN guide with a 3x3 first conv
  HDRNetStack                       two chained NN-guide stages
  HDRNetFullresFeatures             the affine grid applied to learned
                                    full-resolution features
  HDRNetFullresFeaturesMultiscale   features of a 3-level pyramid, summed
  HDRNetFullresFeaturesWithGuide    the guide computed from the features
  HDRNetFeaturesPyrNN / NN2 / NN3   per-level features and NN guides; the
                                    suffix is the feature tower's depth
  HDRNetFeaturesPyrSimpleGuideNN    per-level simple (1x1 sigmoid) guides
  StyleTransferNN / Curves          the HDRNet models on 6-channel input

All share the coefficient backbone and the slice-apply op (kernel K3
forward, K4 and K5 backward on the card; with learned features as the
input, K4 also gives the features' cotangent). NHWC at the interface.
Submodule names follow the Flax modules, so :mod:`hdrnet_torch.convert`
maps weights by name. ``forward_with_intermediates`` returns what the
Flax model sows at top level: the grid ('bilateral_coefficients'), the
guide maps ('guide_map', finest level first) and the feature towers'
outputs ('fullres_features'); ``HDRNetGaussianPyr`` sows only the grid
and ``HDRNetStack`` nothing at top level (its stages' under
'stage{s}').

Every model takes ``band=`` (an H-band of the frame, mesh training's
'spatial' axis; see ``models.hdrnet``): the style models are pointwise
and take a bare (y_off, h_total); the towers' 3x3 convs, the resizes and
``HDRNetStack``'s frame-wide preview need a ``parallel.halo.Band``.
"""

from __future__ import annotations

from torch import nn

from hdrnet_torch.config import ModelConfig
from hdrnet_torch.models.guides import (CurveGuide, Guide3x3NN,
                                        PointwiseNNGuide, SimpleGuide)
from hdrnet_torch.models.hdrnet import (CoefficientBackbone, HDRNetCurves,
                                        HDRNetGaussianPyrNN,
                                        HDRNetPointwiseNNGuide,
                                        gaussian_pyramid, level_bands,
                                        pyramid_slice_apply)
from hdrnet_torch.models.layers import ConvBlock
from hdrnet_torch.ops.resize import _nearest_indices, resize_nearest
from hdrnet_torch.ops.slice_ops import bilateral_slice_apply
from hdrnet_torch.parallel import halo
from hdrnet_torch.utils.timing import span


class HDRNet3x3NNGuide(HDRNetCurves):
  """``HDRNetCurves`` with the 3x3 NN guide."""

  @staticmethod
  def make_guide(cfg, generator):
    return Guide3x3NN(cfg.n_in, cfg.guide_complexity, generator=generator)


class StyleTransferNN(HDRNetPointwiseNNGuide):
  """6-channel input (image and resized style target) mapped to RGB."""


class StyleTransferCurves(HDRNetCurves):
  """The curves-guide variant of the style transfer model."""


class HDRNetGaussianPyr(HDRNetGaussianPyrNN):
  """``HDRNetGaussianPyrNN`` with a curves guide a level; it sows only
  the grid."""

  @staticmethod
  def make_level_guide(cfg, generator):
    return CurveGuide(cfg.n_in, generator=generator)

  def forward_with_intermediates(self, lowres, fullres, band=None):
    out, inter = super().forward_with_intermediates(lowres, fullres, band)
    return out, {'bilateral_coefficients': inter['bilateral_coefficients']}


class HDRNetStack(nn.Module):
  """Two chained ``HDRNetPointwiseNNGuide`` stages (``stage0``,
  ``stage1``) with their own backbones and guides: stage s + 1 enhances
  stage s's output, its preview the nearest resize of that output (on a
  band, of the whole frame's output: every rank gathers the preview's
  rows from their bands, ``halo.gather_rows``)."""

  n_stages = 2

  def __init__(self, cfg: ModelConfig, generator=None):
    super().__init__()
    self.cfg = cfg
    for s in range(self.n_stages):
      self.add_module(f'stage{s}', HDRNetPointwiseNNGuide(cfg, generator))

  def forward(self, lowres, fullres, band=None):
    return self.forward_with_intermediates(lowres, fullres, band)[0]

  def forward_with_intermediates(self, lowres, fullres, band=None):
    """Spans: ``hdrnet.model.stage`` around each stage's forward and
    ``hdrnet.model.stage_preview`` around each handoff preview (one fewer
    than the stages: the last stage's output feeds no preview)."""
    n = self.cfg.net_input_size
    if band is not None:
      halo.require_group(band, "HDRNetStack's preview of the whole frame")
    inter = {}
    for s in range(self.n_stages):
      if s > 0:
        with span('hdrnet.model.stage_preview'):
          rows = fullres if band is None else halo.gather_rows(
              fullres, band, _nearest_indices(band.h_total, n), 1)
          lowres = resize_nearest(rows, (n, n))
      with span('hdrnet.model.stage'):
        fullres, inter[f'stage{s}'] = getattr(self, f'stage{s}')(
            lowres, fullres, band, return_intermediates=True)
    return fullres, inter


class FeatureExtractor(nn.Module):
  """Full-resolution feature tower on an NHWC image: ``depth - 1`` 3x3
  convs of ``width`` channels with ReLU, then a linear 3x3 conv to
  ``n_features``; NHWC out. In full float32 under ``full_float32``."""

  def __init__(self, n_in, n_features, depth=1, width=16, generator=None):
    super().__init__()
    ch = n_in
    for i in range(depth - 1):
      self.add_module(f'conv{i + 1}', ConvBlock(ch, width, 3,
                                                generator=generator))
      ch = width
    self.add_module(f'conv{depth}', ConvBlock(ch, n_features, 3,
                                              activation=None,
                                              generator=generator))

  def forward(self, x, band=None):
    with span('hdrnet.model.features'):
      x = x.permute(0, 3, 1, 2)
      for conv in self.children():
        x = conv(x, band)
      return x.permute(0, 2, 3, 1)


class HDRNetFullresFeatures(nn.Module):
  """The affine grid applied to ``4 * channel_multiplier`` learned
  full-resolution features (a depth-2 tower) instead of the RGB input;
  the NN guide reads the input, or the features (``…WithGuide``); the
  features come from one tower, or from one a level of a 3-level
  bilinear pyramid, resized back to the frame and summed
  (``…Multiscale``)."""

  feature_depth = 2
  guide_from_features = False
  multiscale_features = False

  def __init__(self, cfg: ModelConfig, generator=None):
    super().__init__()
    self.cfg = cfg
    nf = 4 * cfg.channel_multiplier
    self.n_out, self.n_in_tot = cfg.n_out, nf + 1
    self.coefficients = CoefficientBackbone(cfg, cfg.n_out, nf + 1,
                                            generator)
    towers = ([f'features_{i}' for i in range(3)]
              if self.multiscale_features else ['features'])
    for name in towers:
      self.add_module(name, FeatureExtractor(cfg.n_in, nf,
                                             self.feature_depth,
                                             generator=generator))
    self.guide = PointwiseNNGuide(nf if self.guide_from_features
                                  else cfg.n_in, cfg.guide_complexity,
                                  generator=generator)

  def forward(self, lowres, fullres, band=None):
    return self.forward_with_intermediates(lowres, fullres, band)[0]

  def _features(self, fullres, band):
    if not self.multiscale_features:
      return self.features(fullres, band)
    levels = gaussian_pyramid(fullres, 3, band)
    hw = (fullres.shape[1] if band is None else band.h_total,
          fullres.shape[2])
    total = None
    for i, (lvl, lb) in enumerate(zip(levels, level_bands(band, 3))):
      f = getattr(self, f'features_{i}')(lvl, lb)
      if i:
        f = halo.resize_bilinear(f, hw, align_corners=True, band=lb)
      total = f if total is None else total + f
    return total

  def forward_with_intermediates(self, lowres, fullres, band=None):
    grid = self.coefficients(lowres.permute(0, 3, 1, 2))
    features = self._features(fullres, band)
    guide = self.guide(features if self.guide_from_features else fullres,
                       band)
    out = bilateral_slice_apply(grid, guide, features, has_offset=True,
                                band=band)
    return out, {'bilateral_coefficients': grid,
                 'fullres_features': [features], 'guide_map': [guide]}


class HDRNetFullresFeaturesMultiscale(HDRNetFullresFeatures):
  multiscale_features = True


class HDRNetFullresFeaturesWithGuide(HDRNetFullresFeatures):
  guide_from_features = True


class HDRNetFeaturesPyrNN(nn.Module):
  """The pyramid model sliced onto per-level learned features: on each
  level of a 3-level bilinear pyramid a feature tower
  (``features_{l}``, depth ``feature_depth``) and an NN guide
  (``guide_level_{l}``, or a simple guide), one 3-output block of a grid
  of ``4 * channel_multiplier + 1`` inputs a level, summed coarse to
  fine."""

  n_scales = 3
  feature_depth = 1
  simple_guide = False

  def __init__(self, cfg: ModelConfig, generator=None):
    super().__init__()
    self.cfg = cfg
    nf = 4 * cfg.channel_multiplier
    self.n_out, self.n_in_tot = 3 * self.n_scales, nf + 1
    self.coefficients = CoefficientBackbone(cfg, self.n_out, nf + 1,
                                            generator)
    for il in range(self.n_scales):
      self.add_module(f'features_{il}', FeatureExtractor(
          cfg.n_in, nf, self.feature_depth, generator=generator))
      self.add_module(f'guide_level_{il}', (
          SimpleGuide(cfg.n_in, generator=generator) if self.simple_guide
          else PointwiseNNGuide(cfg.n_in, cfg.guide_complexity,
                                generator=generator)))

  def forward(self, lowres, fullres, band=None):
    return self.forward_with_intermediates(lowres, fullres, band)[0]

  def forward_with_intermediates(self, lowres, fullres, band=None):
    grid = self.coefficients(lowres.permute(0, 3, 1, 2))
    levels = gaussian_pyramid(fullres, self.n_scales, band)
    bands = level_bands(band, self.n_scales)
    feats = [getattr(self, f'features_{il}')(lvl, lb)
             for il, (lvl, lb) in enumerate(zip(levels, bands))]
    guides = [getattr(self, f'guide_level_{il}')(lvl)
              for il, lvl in enumerate(levels)]
    out = pyramid_slice_apply(grid, guides, feats, bands=bands)
    return out, {'bilateral_coefficients': grid, 'fullres_features': feats,
                 'guide_map': guides}


class HDRNetFeaturesPyrNN2(HDRNetFeaturesPyrNN):
  feature_depth = 2


class HDRNetFeaturesPyrNN3(HDRNetFeaturesPyrNN):
  feature_depth = 3


class HDRNetFeaturesPyrSimpleGuideNN(HDRNetFeaturesPyrNN):
  simple_guide = True


EXTENDED_MODELS = {
    'HDRNetGaussianPyr': HDRNetGaussianPyr,
    'HDRNet3x3NNGuide': HDRNet3x3NNGuide,
    'HDRNetStack': HDRNetStack,
    'HDRNetFullresFeatures': HDRNetFullresFeatures,
    'HDRNetFullresFeaturesMultiscale': HDRNetFullresFeaturesMultiscale,
    'HDRNetFullresFeaturesWithGuide': HDRNetFullresFeaturesWithGuide,
    'HDRNetFeaturesPyrNN': HDRNetFeaturesPyrNN,
    'HDRNetFeaturesPyrNN2': HDRNetFeaturesPyrNN2,
    'HDRNetFeaturesPyrNN3': HDRNetFeaturesPyrNN3,
    'HDRNetFeaturesPyrSimpleGuideNN': HDRNetFeaturesPyrSimpleGuideNN,
    'StyleTransferNN': StyleTransferNN,
    'StyleTransferCurves': StyleTransferCurves,
}
