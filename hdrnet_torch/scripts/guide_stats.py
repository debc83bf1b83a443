#!/usr/bin/env python
"""Guide dynamic-range statistics for any checkpoint of the port (quality
triage; counterpart of ``scripts/guide_stats.py``).

The guide is the z-coordinate into the bilateral grid: a guide that
only spans k of `luma_bins` bins throws away (luma_bins - k) of the
grid's luma adaptivity. This tool quantifies that collapse for any
model family with a guide map, from the guide maps of the model's
``forward_with_intermediates`` on held-out images (the pipeline's eval
settings: batch 1, file order, no crop, flips or rotation). The report
has the JAX script's fields and rounding.

  python -m hdrnet_torch.scripts.guide_stats output/ll2048_l8s16_g05 \\
      data_ll2048/test --limit 6 --json results/guide_stats.json
      [--device cuda]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from hdrnet_torch.bin.evaluate import eval_pipeline, make_forward, restore
from hdrnet_torch.inference import full_float32, resolve_device
from hdrnet_torch.training.step import normalize_batch, to_device


def guide_maps(model, batch, device):
  """The guide maps (numpy, float32) of `model`'s forward on one host
  batch, in the order the model gives them (the pyramid's finest first);
  ValueError for a model with none."""
  batch = normalize_batch(to_device(batch, device))
  with torch.no_grad(), full_float32():
    _, inter = model.forward_with_intermediates(batch['lowres_input'],
                                                batch['image_input'])
  if 'guide_map' not in inter:
    raise ValueError(f'{type(model).__name__} has no guide map')
  return [g.cpu().numpy() for g in inter['guide_map']]


def main(argv=None):
  p = argparse.ArgumentParser(description=__doc__)
  p.add_argument('checkpoint_dir')
  p.add_argument('data_dir')
  p.add_argument('--limit', type=int, default=6)
  p.add_argument('--json', dest='json_out', default=None)
  p.add_argument('--device', default='cuda',
                 help="torch device ('cpu' for the plain versions of the "
                      'kernels)')
  args = p.parse_args(argv)
  device = resolve_device(args.device)

  config, payload = restore(args.checkpoint_dir)
  model = make_forward(config.model, payload['model'], device, serving=False)
  luma_bins = config.model.luma_bins
  pipeline = eval_pipeline(config, args.data_dir)

  n = min(pipeline.nsamples, args.limit)
  it = pipeline.batches(seed=0)
  acc = None
  for _ in range(n):
    gs = guide_maps(model, next(it), device)
    if acc is None:
      acc = [[] for _ in gs]
    for j, g in enumerate(gs):
      acc[j].append(g.ravel())

  report = {'checkpoint': args.checkpoint_dir, 'step': int(payload['step']),
            'luma_bins': luma_bins, 'model': config.model.model_name,
            'n_images': n, 'guides': []}
  for j, chunks in enumerate(acc):
    g = np.concatenate(chunks)
    p01, p99 = np.percentile(g, [1, 99])
    # Occupancy: fraction of luma bins that receive >=1% of pixels.
    hist, _ = np.histogram(g, bins=luma_bins, range=(0.0, 1.0))
    occ = int((hist / hist.sum() >= 0.01).sum())
    report['guides'].append({
        'p01': round(float(p01), 4), 'p99': round(float(p99), 4),
        'std': round(float(g.std()), 4),
        'bins_occupied': occ,
        'effective_range_bins': round(float((p99 - p01) * luma_bins), 2),
    })
    print(f'guide[{j}]: p01-p99 [{p01:.3f}, {p99:.3f}] std {g.std():.3f} '
          f'-> {occ}/{luma_bins} bins occupied '
          f'({(p99 - p01) * luma_bins:.1f} bins of range)', flush=True)
  if args.json_out:
    with open(args.json_out, 'w') as f:
      json.dump(report, f, indent=2)
  return report


if __name__ == '__main__':
  main()
