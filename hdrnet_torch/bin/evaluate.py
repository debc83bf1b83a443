#!/usr/bin/env python
"""Standalone evaluation: mean PSNR / L2 of a checkpoint of the port on a
dataset (counterpart of ``hdrnet_tpu.bin.evaluate``).

The reference only evaluates inside the training loop
(bin/train.py:160-174, and due to a bug it actually measured training
batches); this is the correct standalone equivalent. Without
``--serving`` the model's forward (the training graph: K3 on the card)
computes the output; with it the serving path (``Enhancer``: K1 or K6 on
the fused route, the model's forward and a clip on the composite route;
``--coeff_bf16`` runs the fused route's backbone in bfloat16).
``make_forward`` and ``evaluate_batch`` are the per-batch work, callable
on in-memory batches; ``main`` reads the checkpoint and the files.

  python -m hdrnet_torch.bin.evaluate ckpt/ data/ [--limit N] [--serving
      [--coeff_bf16]] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import logging

import numpy as np
import torch

from hdrnet_torch.config import Config
from hdrnet_torch.data import make_pipeline
from hdrnet_torch.inference import Enhancer, full_float32, resolve_device
from hdrnet_torch.models import make_model
from hdrnet_torch.training import metrics
from hdrnet_torch.training.checkpoint import latest_checkpoint, load
from hdrnet_torch.training.step import normalize_batch, to_device

log = logging.getLogger('hdrnet_torch.evaluate')


def restore(checkpoint_dir):
  """(Config, payload) of the latest checkpoint in `checkpoint_dir`;
  FileNotFoundError where there is none."""
  config = Config.load(checkpoint_dir)
  path = latest_checkpoint(checkpoint_dir)
  if path is None:
    raise FileNotFoundError(f'no checkpoint in {checkpoint_dir}')
  return config, load(path)


def eval_pipeline(config, data_dir):
  """The pipeline of `config`'s data on `data_dir` as evaluation reads it:
  batch 1, in file order, no crop, flips or rotation."""
  eval_cfg = Config.from_json(config.to_json()).data
  eval_cfg.batch_size = 1
  eval_cfg.shuffle = False
  eval_cfg.random_crop = False
  eval_cfg.fliplr = eval_cfg.flipud = eval_cfg.rotate = False
  return make_pipeline(data_dir, eval_cfg)


def make_forward(model_cfg, state_dict, device, serving, coeff_bf16=False):
  """The function evaluated, (lowres, fullres) -> output: the serving
  path (``Enhancer``, unclipped; with `coeff_bf16` its bfloat16
  backbone) or the model's forward (the training graph), with the
  weights of `state_dict` on `device`. The serving function carries the
  Enhancer as ``.enhancer``."""
  if serving:
    enh = Enhancer(model_cfg, state_dict, device=device,
                   coeff_bf16=coeff_bf16)

    def fwd(low, full):
      return enh(low, full, clip=False)
    fwd.enhancer = enh
    return fwd
  model = make_model(model_cfg)
  model.load_state_dict(state_dict)
  return model.to(device).eval()


def evaluate_batch(fwd, batch, device):
  """(PSNR in dB, L2 loss) of `fwd` on one host batch as the pipeline
  gives it. Raw-dtype batches (a checkpoint trained with
  --device_normalize persists that pipeline setting) are normalized on
  the device."""
  batch = normalize_batch(to_device(batch, device))
  with torch.no_grad(), full_float32():
    out = fwd(batch['lowres_input'], batch['image_input'])
  return (float(metrics.psnr(batch['image_output'], out)),
          float(metrics.l2_loss(batch['image_output'], out)))


def main(argv=None):
  logging.basicConfig(
      format='%(asctime)s [%(process)d] %(levelname)s %(filename)s:'
             '%(lineno)s | %(message)s', level=logging.INFO)
  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument('checkpoint_dir')
  parser.add_argument('data_dir', help='dataset (filelist.txt layout)')
  parser.add_argument('--limit', type=int, default=None)
  parser.add_argument('--json', dest='json_out', default=None,
                      help='write results to this JSON file')
  parser.add_argument('--serving', action='store_true',
                      help='evaluate through the serving path (the fused '
                           'kernels) instead of the training graph')
  parser.add_argument('--coeff_bf16', action='store_true',
                      help='with --serving: bfloat16 coefficient backbone '
                           '(the fused route only)')
  parser.add_argument('--device', default='cuda',
                      help="torch device ('cpu' for the plain versions of "
                           'the kernels)')
  args = parser.parse_args(argv)
  device = resolve_device(args.device)

  config, payload = restore(args.checkpoint_dir)
  pipeline = eval_pipeline(config, args.data_dir)

  fwd = make_forward(config.model, payload['model'], device, args.serving,
                     args.coeff_bf16)
  if args.serving:
    log.info('serving-path eval on %s (fused route: %s, coeff_bf16: %s)',
             device, fwd.enhancer.fused, fwd.enhancer.coeff_bf16)

  n = min(pipeline.nsamples, args.limit or pipeline.nsamples)
  it = pipeline.batches(seed=0)
  psnrs, losses = [], []
  for i in range(n):
    psnr, l2 = evaluate_batch(fwd, next(it), device)
    psnrs.append(psnr)
    losses.append(l2)
    log.info('[%d/%d] psnr=%.2f dB  l2=%.5f', i + 1, n, psnrs[-1],
             losses[-1])

  result = {'step': int(payload['step']), 'n_images': n,
            'mean_psnr_db': float(np.mean(psnrs)),
            'mean_l2': float(np.mean(losses))}
  if args.serving:
    result['serving'] = {'fused': fwd.enhancer.fused,
                         'coeff_bf16': fwd.enhancer.coeff_bf16}
  log.info('step %d | mean PSNR = %.2f dB | mean L2 = %.5f over %d images',
           result['step'], result['mean_psnr_db'], result['mean_l2'], n)
  print(json.dumps(result))
  if args.json_out:
    with open(args.json_out, 'w') as f:
      json.dump(result, f, indent=2)
  return result


if __name__ == '__main__':
  main()
