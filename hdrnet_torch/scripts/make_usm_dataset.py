#!/usr/bin/env python
"""Materialize an unsharp-mask test set from existing input images
(counterpart of ``scripts/make_usm_dataset.py``).

The usm workload synthesizes its target on the fly during training
(``UnsharpMaskDataPipeline``); the held-out artifacts (identity PSNR,
the per-image oracle of ``bin/fit_grid``) need a materialized
``filelist.txt + input/ + output/`` tree. The targets are written with
the pipeline's own arithmetic (``hdrnet_torch.data.hostops.gaussian_blur``,
the same clip, ``images.imwrite``'s round-half-up), so evaluating on the
fly and on the files agree. It prints each image's identity PSNR and
their mean.

  python -m hdrnet_torch.scripts.make_usm_dataset data_ll/test \\
      data_usm/test --blur_sigma 4.0 --sharpen 1.0
"""

from __future__ import annotations

import argparse
import os
import shutil

import numpy as np

from hdrnet_torch.data import hostops, images


def main(argv=None):
  p = argparse.ArgumentParser(description=__doc__)
  p.add_argument('src', help='source dir (filelist.txt + input/)')
  p.add_argument('out')
  p.add_argument('--blur_sigma', type=float, default=4.0)
  p.add_argument('--sharpen', type=float, default=1.0)
  args = p.parse_args(argv)

  with open(os.path.join(args.src, 'filelist.txt')) as f:
    names = [l.strip() for l in f if l.strip()]
  os.makedirs(os.path.join(args.out, 'input'), exist_ok=True)
  os.makedirs(os.path.join(args.out, 'output'), exist_ok=True)
  psnrs = []
  for n in names:
    src = os.path.join(args.src, 'input', n)
    inp = images.imread_float(src)
    blurred = hostops.gaussian_blur(inp, args.blur_sigma)
    target = np.clip(inp + args.sharpen * (inp - blurred), 0.0, 1.0)
    shutil.copyfile(src, os.path.join(args.out, 'input', n))
    images.imwrite(os.path.join(args.out, 'output', n), target)
    mse = float(np.mean((inp - target) ** 2))
    psnrs.append(-10.0 * np.log10(max(mse, 1e-12)))
    print(f'{n}: identity {psnrs[-1]:.2f} dB', flush=True)
  with open(os.path.join(args.out, 'filelist.txt'), 'w') as f:
    f.write('\n'.join(names) + '\n')
  mean = float(np.mean(psnrs))
  print(f'mean identity PSNR {mean:.2f} dB over {len(names)}')
  return mean


if __name__ == '__main__':
  main()
