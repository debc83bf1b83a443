#!/usr/bin/env python
"""Why does HDRNetGaussianPyrNN trail the plain model? (quality triage;
counterpart of ``scripts/diagnose_pyramid.py``)

Loads a pyramid checkpoint of the port and, per held-out image (the
pipeline's eval settings):
  * takes the model's intermediates (grid, pyramid levels, per-level
    guide maps) from ``forward_with_intermediates``;
  * reports per-level guide dynamic range;
  * recomputes each level's slice-apply output
    (``models.hdrnet.level_slice_apply``: K3 on the card) and its RMS
    contribution to the final image;
  * ablation PSNR: reconstructs with each level's output zeroed
    (``models.hdrnet.pyramid_slice_apply``, the model's own coarse-to-fine
    sum with the bilinear upsampling) -- which level actually carries the
    enhancement? The reconstruction with every level kept is checked
    against the model's output to 1e-5.

It prints the summary and writes the summary and the per-image records
as JSON, with the JAX script's fields.

  python -m hdrnet_torch.scripts.diagnose_pyramid output/ll_gpyrnn_cos \\
      data_ll/test --limit 6 --json results/pyramid_diagnosis.json
      [--device cuda]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from hdrnet_torch.bin.evaluate import eval_pipeline, make_forward, restore
from hdrnet_torch.inference import full_float32, resolve_device
from hdrnet_torch.models.hdrnet import level_slice_apply, pyramid_slice_apply
from hdrnet_torch.training import metrics
from hdrnet_torch.training.step import normalize_batch, to_device

N_SCALES = 3


def diagnose(model, batch, device):
  """One image's record: its PSNR and, for each level coarsest first, the
  guide's percentiles and spread, the level output's RMS and the PSNR
  without it."""
  batch = normalize_batch(to_device(batch, device))
  target = batch['image_output']
  with torch.no_grad(), full_float32():
    out, inter = model.forward_with_intermediates(batch['lowres_input'],
                                                  batch['image_input'])
    grid = inter['bilateral_coefficients']
    levels, guides = inter['multiscale'], inter['guide_map']
    full = pyramid_slice_apply(grid, guides, levels)
    np.testing.assert_allclose(full.cpu().numpy(), out.cpu().numpy(),
                               atol=1e-5)
    rec = {'psnr': float(metrics.psnr(target, out)), 'levels': []}
    # il counts levels coarsest first, as the grid's output blocks do.
    for il, (guide, level) in enumerate(zip(guides[::-1], levels[::-1])):
      g = guide.cpu().numpy()
      o = level_slice_apply(grid, guide, level, il).cpu().numpy()
      ablated = pyramid_slice_apply(grid, guides, levels, zeroed=(il,))
      rec['levels'].append({
          'scale_divisor': 2 ** (N_SCALES - 1 - il),
          'guide_p01': float(np.percentile(g, 1)),
          'guide_p99': float(np.percentile(g, 99)),
          'guide_std': float(g.std()),
          'out_rms': float(np.sqrt((o ** 2).mean())),
          'psnr_without': float(metrics.psnr(target, ablated)),
      })
  return rec


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
  if config.model.model_name != 'HDRNetGaussianPyrNN':
    raise ValueError(f'{config.model.model_name}: diagnose_pyramid reads '
                     'an HDRNetGaussianPyrNN checkpoint')
  model = make_forward(config.model, payload['model'], device, serving=False)
  pipeline = eval_pipeline(config, args.data_dir)

  per_image = []
  n = min(pipeline.nsamples, args.limit)
  it = pipeline.batches(seed=0)
  for i in range(n):
    rec = diagnose(model, next(it), device)
    per_image.append(rec)
    base = rec['psnr']
    print(f'[{i+1}/{n}] psnr={base:.2f} ' + ' '.join(
        f"L/{r['scale_divisor']}: g=[{r['guide_p01']:.2f},"
        f"{r['guide_p99']:.2f}] rms={r['out_rms']:.3f} "
        f"-drop={base - r['psnr_without']:+.2f}dB"
        for r in rec['levels']), flush=True)

  summary = {
      'checkpoint': args.checkpoint_dir,
      'step': int(payload['step']),
      'mean_psnr': float(np.mean([r['psnr'] for r in per_image])),
      'levels': [],
  }
  for il in range(N_SCALES):
    rows = [r['levels'][il] for r in per_image]
    summary['levels'].append({
        'scale_divisor': rows[0]['scale_divisor'],
        'guide_p01': float(np.mean([r['guide_p01'] for r in rows])),
        'guide_p99': float(np.mean([r['guide_p99'] for r in rows])),
        'guide_std': float(np.mean([r['guide_std'] for r in rows])),
        'out_rms': float(np.mean([r['out_rms'] for r in rows])),
        'mean_psnr_drop_without': float(np.mean(
            [r['psnr'] for r in per_image]) - np.mean(
            [r['psnr_without'] for r in rows])),
    })
  print(json.dumps(summary, indent=2))
  result = {'summary': summary, 'per_image': per_image}
  if args.json_out:
    with open(args.json_out, 'w') as f:
      json.dump(result, f, indent=2)
  return result


if __name__ == '__main__':
  main()
