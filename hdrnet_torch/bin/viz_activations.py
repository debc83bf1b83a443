#!/usr/bin/env python
"""Visualize conv weights and activations (counterpart of
``hdrnet_tpu.bin.viz_activations``; reference: bin/viz_activations.py:63-111).

Runs one image through the model, captures every module's output with
forward hooks under the names the Flax model's ``capture_intermediates``
gives them, tiles channels into PNG mosaics, and tiles the first-layer
conv kernels.

  python -m hdrnet_torch.bin.viz_activations ckpt/ image.png out_dir/
      [--device cpu]
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np
import torch

from hdrnet_torch.models.extended import FeatureExtractor
from hdrnet_torch.models.guides import PointwiseNNGuide
from hdrnet_torch.models.hdrnet import HDRNetPointwiseNNGuide
from hdrnet_torch.models.layers import CenterBatchNorm, ConvBlock

log = logging.getLogger('hdrnet_torch.viz')


def tile_channels(act):
  """(h, w, c) -> mosaic of c normalized panels."""
  h, w, c = act.shape
  cols = int(np.ceil(np.sqrt(c)))
  rows = int(np.ceil(c / cols))
  canvas = np.zeros((rows * h, cols * w), np.float32)
  for i in range(c):
    r, col = divmod(i, cols)
    panel = act[:, :, i]
    lo, hi = float(panel.min()), float(panel.max())
    if hi > lo:
      panel = (panel - lo) / (hi - lo)
    canvas[r * h:(r + 1) * h, col * w:(col + 1) * w] = panel
  return canvas


def _flax_name(module_name):
  """The name of a module's output in the Flax intermediates, flattened
  as the JAX tool writes it: the port's submodules carry the Flax names
  (``hdrnet_torch.convert``), '.' becomes '_', the call is 'out' and the
  first (only) call '[0]'."""
  return module_name.replace('.', '_') + '_out_[0]'


@torch.no_grad()
def capture_activations(model, lowres, fullres):
  """{Flax intermediate name: (1, h, w, c) numpy array} of every rank-4
  module output of `model` on NHWC (lowres, fullres), and the feature
  maps the model sows ('multiscale_[i]', the pyramid's levels;
  'fullres_features_[i]', the feature towers'), in full float32. `model`
  is in eval mode, as the Flax model runs with ``train=False``.

  The convs, batch norms and conv blocks compute NCHW; the feature
  towers and the stack's stages take and give NHWC tensors."""
  from hdrnet_torch.inference import full_float32
  if model.training:
    raise ValueError('capture_activations takes a model in eval mode')
  captured = {}
  hooks = []

  def keep(name, nchw):
    def hook(module, args, out):
      del module, args
      if isinstance(out, tuple):  # a stage's (output, intermediates)
        out = out[0]
      if out.ndim == 4:
        act = out.permute(0, 2, 3, 1) if nchw else out
        captured[_flax_name(name)] = act.cpu().numpy()
    return hook

  def keep_guide(name):
    # The pointwise guide's forward computes its 1x1 convs as matrix
    # products and calls no submodule a hook could see: its layers come
    # from its own forward_with_intermediates, on the same input, and its
    # guide map must be the one the model used.
    def hook(module, args, out):
      guide, layers = module.forward_with_intermediates(args[0])
      if not torch.equal(guide, out):
        raise AssertionError(f'{name}: the layers are not of this forward')
      for sub, act in layers.items():
        captured[_flax_name(f'{name}.{sub}')] = act.cpu().numpy()
    return hook

  for name, module in model.named_modules():
    if not name:
      continue
    if isinstance(module, PointwiseNNGuide):
      hooks.append(module.register_forward_hook(keep_guide(name)))
    elif isinstance(module, (ConvBlock, CenterBatchNorm, torch.nn.Conv2d)):
      hooks.append(module.register_forward_hook(keep(name, nchw=True)))
    elif isinstance(module, (FeatureExtractor, HDRNetPointwiseNNGuide)):
      hooks.append(module.register_forward_hook(keep(name, nchw=False)))
  try:
    with full_float32():
      _, inter = model.forward_with_intermediates(lowres, fullres)
  finally:
    for h in hooks:
      h.remove()
  for key in ('multiscale', 'fullres_features'):
    for i, act in enumerate(inter.get(key, [])):
      captured[f'{key}_[{i}]'] = act.cpu().numpy()
  return captured


def main(argv=None):
  logging.basicConfig(level=logging.INFO)
  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument('checkpoint_dir')
  parser.add_argument('input_image')
  parser.add_argument('output_dir')
  parser.add_argument('--device', default='cuda',
                      help="torch device ('cpu' for the plain versions of "
                           'the kernels)')
  args = parser.parse_args(argv)

  from hdrnet_torch.data import hostops, images
  from hdrnet_torch.inference import Enhancer

  enh = Enhancer.from_checkpoint(args.checkpoint_dir, device=args.device)
  s = enh.model_cfg.net_input_size
  im = images.imread_float(args.input_image)
  lowres = enh.on_device(hostops.resize_nearest(im, (s, s))[None])
  fullres = enh.on_device(im[None])

  os.makedirs(args.output_dir, exist_ok=True)
  acts = capture_activations(enh.model, lowres, fullres)
  for name, act in acts.items():
    images.imwrite(os.path.join(args.output_dir, f'{name}.png'),
                   tile_channels(act[0]))
  log.info('wrote %d activation mosaics', len(acts))

  # First splat conv kernels, one panel per (cin, cout) pair, HWIO as the
  # Flax kernel.
  state = enh.model.state_dict()
  key = 'coefficients.splat_conv1.conv.weight'
  if key in state:
    k = state[key].permute(2, 3, 1, 0).cpu().numpy()
    kh, kw, cin, cout = k.shape
    images.imwrite(os.path.join(args.output_dir, 'splat_conv1.png'),
                   tile_channels(k.reshape(kh, kw, cin * cout)))
    log.info('wrote splat_conv1.png')
  return acts


if __name__ == '__main__':
  main()
