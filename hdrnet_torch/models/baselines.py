"""The baselines of the reference's comparisons (counterparts of
``hdrnet_tpu.models.baselines``): ``UNet`` and ``DilatedConvolutions``.

Both work at full resolution and ignore the preview; they keep the
``(lowres, fullres)`` signature of the HDRNet family so that training
and serving take any model. NHWC at the interface, NCHW inside.
Submodule names follow the Flax modules, so :mod:`hdrnet_torch.convert`
maps weights by name. Neither sows intermediates, so
``forward_with_intermediates`` returns an empty dict. Both take an
H-band of the frame (``band=``, a ``parallel.halo.Band``: mesh
training's 'spatial' axis), each conv and resize exchanging the rows it
reads from the neighbouring bands; neither slices a grid
(``slice_levels = 0``).
"""

from __future__ import annotations

import torch
from torch import nn

from hdrnet_torch.config import ModelConfig
from hdrnet_torch.models.layers import ConvBlock
from hdrnet_torch.parallel import halo


class UNet(nn.Module):
  """Encoder/decoder with skip connections: ``depth // 2`` levels (at
  least one) of a 3x3 conv and a stride-2 3x3 conv (XLA's SAME, asymmetric
  on even extents), a bottleneck, then per level a nearest upsampling to
  the skip's extent (the float64 floor table of ``resize_nearest``), the
  concatenation ``[x, skip]`` and a 3x3 conv; a linear 1x1 conv to
  ``n_out``. Widths ``width * 2**level``; BN follows ``batch_norm``."""

  slice_levels = 0

  def __init__(self, cfg: ModelConfig, generator=None):
    super().__init__()
    self.cfg = cfg
    self.n_levels = max(1, cfg.depth // 2)
    kw = dict(batch_norm=cfg.batch_norm, generator=generator)
    ch = cfg.n_in
    for i in range(self.n_levels):
      width = cfg.width * 2 ** i
      self.add_module(f'enc{i}_a', ConvBlock(ch, width, 3, **kw))
      self.add_module(f'enc{i}_down', ConvBlock(width, width, 3, stride=2,
                                                **kw))
      ch = width
    self.bottleneck = ConvBlock(ch, cfg.width * 2 ** self.n_levels, 3, **kw)
    ch = cfg.width * 2 ** self.n_levels
    for i in reversed(range(self.n_levels)):
      width = cfg.width * 2 ** i
      self.add_module(f'dec{i}', ConvBlock(ch + width, width, 3, **kw))
      ch = width
    self.out = ConvBlock(ch, cfg.n_out, 1, activation=None,
                         generator=generator)

  def forward(self, lowres, fullres, band=None):
    del lowres
    x = fullres.permute(0, 3, 1, 2)
    skips, bands = [], [band]
    for i in range(self.n_levels):
      x = getattr(self, f'enc{i}_a')(x, band)
      skips.append(x)
      x = getattr(self, f'enc{i}_down')(x, band)
      if band is not None:
        band = band.at(-(-band.h_total // 2))
      bands.append(band)
    x = self.bottleneck(x, band)
    for i in reversed(range(self.n_levels)):
      skip = skips[i]
      size = (skip.shape[2] if bands[i] is None else bands[i].h_total,
              skip.shape[3])
      x = halo.resize_nearest(x.permute(0, 2, 3, 1), size,
                              band=bands[i + 1]).permute(0, 3, 1, 2)
      x = getattr(self, f'dec{i}')(torch.cat([x, skip], dim=1), bands[i])
    return self.out(x).permute(0, 2, 3, 1)

  def forward_with_intermediates(self, lowres, fullres, band=None):
    return self(lowres, fullres, band), {}


class DilatedConvolutions(nn.Module):
  """``depth`` 3x3 convs of ``width`` channels, the dilation doubling a
  layer (1, 2, 4, ...; XLA's SAME pads rate * (k - 1) in all), then a
  linear 1x1 conv to ``n_out``. BN follows ``batch_norm``."""

  slice_levels = 0

  def __init__(self, cfg: ModelConfig, generator=None):
    super().__init__()
    self.cfg = cfg
    ch = cfg.n_in
    for i in range(cfg.depth):
      self.add_module(f'dilated{i}', ConvBlock(
          ch, cfg.width, 3, rate=2 ** i, batch_norm=cfg.batch_norm,
          generator=generator))
      ch = cfg.width
    self.out = ConvBlock(ch, cfg.n_out, 1, activation=None,
                         generator=generator)

  def forward(self, lowres, fullres, band=None):
    del lowres
    x = fullres.permute(0, 3, 1, 2)
    for i in range(self.cfg.depth):
      x = getattr(self, f'dilated{i}')(x, band)
    return self.out(x).permute(0, 2, 3, 1)

  def forward_with_intermediates(self, lowres, fullres, band=None):
    return self(lowres, fullres, band), {}
