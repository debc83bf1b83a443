#!/usr/bin/env python
"""Batch inference from a checkpoint of the port (counterpart of
``hdrnet_tpu.bin.run``; reference: bin/run.py:61-216).

Input may be a directory of images, a filelist.txt (resolved against its
sibling input/ dir), or a single image. The model architecture is
rebuilt from the config.json saved next to the checkpoint. Every image is
served at its own size (``Enhancer.enhance_any``); the preview is cut
from it on the device by kernel K2, or read from ``--lowres_input``.

  python -m hdrnet_torch.bin.run ckpt/ photos/ out/ [--debug] [--limit N]
      [--device cuda]
"""

from __future__ import annotations

import argparse
import logging
import os
import re

import numpy as np
import torch

from hdrnet_torch.data import hostops, images
from hdrnet_torch.inference import Enhancer, full_float32
from hdrnet_torch.models import require_top_level_grid
from hdrnet_torch.ops.downsample import nearest_lowres
from hdrnet_torch.training.checkpoint import latest_checkpoint

log = logging.getLogger('hdrnet_torch.run')

_IMG_RE = re.compile(r'.*\.(png|jpeg|jpg|tif|tiff)$', re.IGNORECASE)


def get_input_list(path):
  """Directory / filelist.txt / single image (bin/run.py:42-58)."""
  if os.path.isdir(path):
    names = sorted(os.listdir(path))
    return [os.path.join(path, n) for n in names if _IMG_RE.match(n)]
  if path.endswith('.txt'):
    dirname = os.path.dirname(path)
    with open(path) as f:
      names = [l.strip() for l in f if l.strip()]
    return [os.path.join(dirname, 'input', n) for n in names]
  if _IMG_RE.match(path):
    return [path]
  raise ValueError(f'cannot interpret input path {path}')


def _normalize01(arr):
  m = float(np.abs(arr).max()) or 1.0
  return np.clip((arr + m) / (2 * m), 0, 1)


@torch.no_grad()
def enhance_image(enh, image, lowres=None, debug=False):
  """The per-image work of ``main``: image (H, W, 3) float32 in [0, 1], a
  numpy array or a tensor on the Enhancer's device; lowres (s, s, 3) the
  same, or None to cut the preview from the image with K2 on the device
  (the legacy nearest table, bit-exact to the JAX package's host resize).

  Returns (the clipped (1, H, W, 3) output on the device, the model's
  intermediates or None). With ``debug`` the output comes from the
  model's forward, which also gives the grid, guides and pyramid levels
  (ValueError for a model with no top-level grid); otherwise from
  ``Enhancer.enhance_any``.
  """
  frame = enh.on_device(image[None])
  if lowres is None:
    low = nearest_lowres(frame, enh.model_cfg.net_input_size)
    low = low.permute(0, 2, 3, 1)
  else:
    low = enh.on_device(lowres[None])
  if not debug:
    return enh.enhance_any(low, frame), None
  require_top_level_grid(enh.model, '--debug writes the grid')
  with full_float32():
    out, inter = enh.model.forward_with_intermediates(low, frame)
  return torch.clamp(out, 0.0, 1.0), inter


def _write_debug(out_dir, fname, im, inter):
  """The reference's debug dumps (bin/run.py:100-106): input, the grid
  tiled (gh * gd, gw * ni * no), guides, pyramid levels."""
  images.imwrite(os.path.join(out_dir, fname + '_input.png'), im)
  grid = inter['bilateral_coefficients'][0].cpu().numpy()
  gh, gw, gd, no, ni = grid.shape
  tiled = grid.transpose(0, 2, 1, 4, 3).reshape(gh * gd, gw * ni * no)
  images.imwrite(os.path.join(out_dir, fname + '_coeffs.png'),
                 _normalize01(tiled))
  for i, g in enumerate(inter.get('guide_map', [])):
    images.imwrite(os.path.join(out_dir, f'{fname}_guide_{i}.png'),
                   _normalize01(g[0].cpu().numpy()))
  for i, lvl in enumerate(inter.get('multiscale', [])):
    images.imwrite(os.path.join(out_dir, f'{fname}_ms_{i}.png'),
                   np.clip(lvl[0].cpu().numpy(), 0, 1))


def main(argv=None):
  logging.basicConfig(
      format='%(asctime)s [%(process)d] %(levelname)s %(filename)s:'
             '%(lineno)s | %(message)s', level=logging.INFO)
  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument('checkpoint_dir')
  parser.add_argument('input', help='image dir / filelist.txt / image')
  parser.add_argument('output', help='output directory')
  parser.add_argument('--limit', type=int, default=None)
  parser.add_argument('--hdrp', action='store_true',
                      help='16-bit linear HDR+ input handling')
  parser.add_argument('--debug', action='store_true',
                      help='dump coefficient/guide visualizations')
  parser.add_argument('--lowres_input', default=None,
                      help='directory of precomputed lowres inputs '
                           '(matched by basename) instead of nearest-'
                           'downsampling')
  parser.add_argument('--device', default='cuda',
                      help="torch device ('cpu' for the plain versions of "
                           'the kernels)')
  args = parser.parse_args(argv)

  inputs = get_input_list(args.input)
  if args.limit:
    inputs = inputs[:args.limit]
  if not inputs:
    log.error('no inputs found under %s', args.input)
    return
  path = latest_checkpoint(args.checkpoint_dir)
  if path is None:
    log.error('no checkpoint found in %s', args.checkpoint_dir)
    return
  enh = Enhancer.from_checkpoint(args.checkpoint_dir, device=args.device)
  log.info('restored %s on %s', path, enh.device)
  net_size = enh.model_cfg.net_input_size

  os.makedirs(args.output, exist_ok=True)
  for idx, in_path in enumerate(inputs):
    log.info('processing %s (%d/%d)', in_path, idx + 1, len(inputs))
    im = images.imread(in_path)
    white = 65535.0 if im.dtype == np.uint16 else 255.0
    if args.hdrp and im.dtype == np.uint16:
      log.info('HDR+ 16-bit input, white level %s', white)
    im = hostops.to_float(im, white)
    fname = os.path.splitext(os.path.basename(in_path))[0]
    lowres = None
    if args.lowres_input:
      low_path = os.path.join(args.lowres_input, os.path.basename(in_path))
      # Normalized by the lowres file's own bit depth (an 8-bit preview
      # of a 16-bit HDR+ frame is the typical pairing).
      lowres = images.imread_float(low_path)
      if lowres.shape[:2] != (net_size, net_size):
        raise ValueError(
            f'{low_path}: lowres input is {lowres.shape[:2]}, model '
            f'expects {(net_size, net_size)}')
    out, inter = enhance_image(enh, im, lowres, debug=args.debug)
    images.imwrite(os.path.join(args.output, fname + '.png'),
                   out[0].cpu().numpy())
    if args.debug:
      _write_debug(args.output, fname, im, inter)


if __name__ == '__main__':
  main()
