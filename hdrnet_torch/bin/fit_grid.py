#!/usr/bin/env python
"""Per-image bilateral-grid ORACLE fit: the representability upper bound
(counterpart of ``hdrnet_tpu.bin.fit_grid``).

Directly optimizes one bilateral grid (and optionally the curve guide)
against a single (input, target) pair with Adam through the slice-apply
op -- no coefficient network involved. The resulting PSNR is the ceiling
any HDRNet-class predictor can reach on that image with the same grid
geometry, which separates "the operator is not representable by sliced
local affine transforms" from "the network failed to predict them" when
judging a training run. On the card each step runs kernel K3 forward and
K4/K5 backward (``hdrnet_torch.ops.slice_ops``); on the CPU their plain
versions.

  python -m hdrnet_torch.bin.fit_grid data/test --limit 4
  python -m hdrnet_torch.bin.fit_grid data/test --guide curves --json r.json
      [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import logging
import os

import numpy as np
import torch

from hdrnet_torch.inference import full_float32, resolve_device
from hdrnet_torch.models.guides import CurveGuide
from hdrnet_torch.ops.slice_ops import bilateral_slice_apply

log = logging.getLogger('hdrnet_torch.fit_grid')

_LUMA = (0.299, 0.587, 0.114)


def psnr_of(mse):
  return -10.0 * float(np.log10(max(float(mse), 1e-12)))


def fit_problem(inp, tgt, *, gh=16, gw=16, gd=8, guide='luma',
                guide_params=None, device='cuda'):
  """The fit's parameters and loss on `device`: (grid (1, gh, gw, gd, 3, 4)
  at the identity, the curves guide module or None, loss_fn() -> the MSE
  of the sliced output against `tgt`).

  inp/tgt: float32 (H, W, 3) in [0, 1], numpy arrays or tensors.
  guide_params: the curves guide's initial parameters by name (``ccm``,
    ``ccm_bias``, ``shifts``, ``slopes``, ``channel_mixing_w``,
    ``channel_mixing_b``), e.g. the Flax ``CurveGuide``'s init; by
    default the port's ``CurveGuide`` init from seed 0.
  """
  device = resolve_device(device)
  inp = torch.as_tensor(inp, dtype=torch.float32, device=device)
  tgt = torch.as_tensor(tgt, dtype=torch.float32, device=device)
  grid = torch.zeros((1, gh, gw, gd, 3, 4), device=device)
  for i in range(3):
    grid[..., i, i] = 1.0
  grid = torch.nn.Parameter(grid)
  gmod = None
  if guide == 'curves':
    gmod = CurveGuide(generator=torch.Generator().manual_seed(0))
    if guide_params is not None:
      gmod.load_state_dict({k: torch.tensor(np.asarray(v, np.float32))
                            for k, v in guide_params.items()})
    gmod = gmod.to(device)
    guide_of = lambda: gmod(inp[None])[0]
  elif guide == 'luma':
    luma = inp @ torch.tensor(_LUMA, dtype=torch.float32, device=device)
    guide_of = lambda: luma
  else:
    raise ValueError(f"guide must be 'luma' or 'curves', got {guide!r}")

  def loss_fn():
    out = bilateral_slice_apply(grid, guide_of()[None], inp[None])
    return torch.mean((out[0] - tgt) ** 2)
  return grid, gmod, loss_fn


def fit_pair(inp, tgt, *, gh=16, gw=16, gd=8, steps=400, lr=3e-3,
             guide='luma', guide_params=None, device='cuda'):
  """Fits (grid[, curve-guide params]) to one pair (``fit_problem``'s
  arguments); returns (psnr, {'grid': (1, gh, gw, gd, 3, 4)[, 'guide':
  {name: tensor}]}). Adam with optax's defaults (betas 0.9, 0.999, eps
  1e-8).
  """
  grid, gmod, loss_fn = fit_problem(inp, tgt, gh=gh, gw=gw, gd=gd,
                                    guide=guide, guide_params=guide_params,
                                    device=device)
  params = [grid] + ([] if gmod is None else list(gmod.parameters()))
  opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
  with full_float32():
    for _ in range(steps):
      opt.zero_grad(set_to_none=True)
      loss_fn().backward()
      opt.step()
    with torch.no_grad():
      mse = loss_fn()
  fitted = {'grid': grid.detach()}
  if gmod is not None:
    fitted['guide'] = {k: v.detach() for k, v in gmod.state_dict().items()}
  return psnr_of(mse), fitted


def main(argv=None):
  logging.basicConfig(
      format='%(asctime)s [%(process)d] %(levelname)s %(filename)s:'
             '%(lineno)s | %(message)s', level=logging.INFO)
  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument('data_dir', help='dataset (filelist.txt layout)')
  parser.add_argument('--limit', type=int, default=4)
  parser.add_argument('--steps', type=int, default=400)
  parser.add_argument('--lr', type=float, default=3e-3)
  parser.add_argument('--luma_bins', type=int, default=8)
  parser.add_argument('--spatial_bin', type=int, default=16,
                      help='grid cells per axis (gh = gw = spatial_bin)')
  parser.add_argument('--guide', choices=['luma', 'curves'],
                      default='luma')
  parser.add_argument('--json', dest='json_out', default=None)
  parser.add_argument('--device', default='cuda',
                      help="torch device ('cpu' for the plain versions of "
                           'the kernels)')
  args = parser.parse_args(argv)

  from hdrnet_torch.data import images

  with open(os.path.join(args.data_dir, 'filelist.txt')) as f:
    names = [l.strip() for l in f if l.strip()][:args.limit]

  results = []
  for name in names:
    inp = images.imread_float(os.path.join(args.data_dir, 'input', name))
    tgt = images.imread_float(os.path.join(args.data_dir, 'output', name))
    identity = psnr_of(((inp - tgt) ** 2).mean())
    psnr, _ = fit_pair(inp, tgt, gh=args.spatial_bin, gw=args.spatial_bin,
                       gd=args.luma_bins, steps=args.steps, lr=args.lr,
                       guide=args.guide, device=args.device)
    log.info('%s: identity=%.2f dB  oracle=%.2f dB', name, identity, psnr)
    results.append({'name': name, 'identity_psnr': identity,
                    'oracle_psnr': psnr})

  summary = {
      'n_images': len(results),
      'mean_identity_psnr': float(np.mean([r['identity_psnr']
                                           for r in results])),
      'mean_oracle_psnr': float(np.mean([r['oracle_psnr']
                                         for r in results])),
      'images': results,
  }
  log.info('mean identity = %.2f dB | mean oracle upper bound = %.2f dB',
           summary['mean_identity_psnr'], summary['mean_oracle_psnr'])
  print(json.dumps(summary))
  if args.json_out:
    with open(args.json_out, 'w') as f:
      json.dump(summary, f, indent=2)
  return summary


if __name__ == '__main__':
  main()
