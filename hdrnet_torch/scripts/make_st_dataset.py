#!/usr/bin/env python
"""Synthesize a style-transfer dataset from an existing ll-style tree
(counterpart of ``scripts/make_st_dataset.py``; file layout only).

``StyleTransferDataPipeline`` trains on (input x style exemplar) cross
products. This builds that layout from a filelist dataset with two
styles, so the 6-channel conditioning matters (the net must read the
exemplar channels to know which operator to apply):

  style_ll : exemplar = a local-Laplacian OUTPUT frame; target = the
             dataset's output/ (the ll operator)
  style_id : exemplar = the same scene's INPUT frame; target = the input
             itself (the identity operator)

Layout written (symlinks into the source tree):
  dst/filelist.txt  dst/targets.txt
  dst/input/<fname>           -> src/input/<fname>
  dst/input/style_ll.png      (copy of an output exemplar)
  dst/input/style_id.png      (copy of the matching input exemplar)
  dst/output/style_ll/<fname> -> src/output/<fname>
  dst/output/style_id/<fname> -> src/input/<fname>

``--exemplar_src`` names the tree the exemplars are copied from, so the
test split can reuse the train split's (the conditioning image must be
the same at train and eval time).

  python -m hdrnet_torch.scripts.make_st_dataset SRC DST [--exemplar NAME]
      [--exemplar_src DIR]
"""

from __future__ import annotations

import argparse
import os
import shutil


def main(argv=None):
  p = argparse.ArgumentParser(description=__doc__)
  p.add_argument('src')
  p.add_argument('dst')
  p.add_argument('--exemplar', default=None,
                 help='filename (from the exemplar_src filelist) used '
                      'as the style exemplar; default = first entry')
  p.add_argument('--exemplar_src', default=None,
                 help='tree to copy exemplars from (default: src)')
  args = p.parse_args(argv)

  src = os.path.abspath(args.src)
  dst = os.path.abspath(args.dst)
  esrc = os.path.abspath(args.exemplar_src or args.src)

  with open(os.path.join(src, 'filelist.txt')) as f:
    names = [l.strip() for l in f if l.strip()]
  with open(os.path.join(esrc, 'filelist.txt')) as f:
    enames = [l.strip() for l in f if l.strip()]
  exemplar = args.exemplar or enames[0]

  os.makedirs(os.path.join(dst, 'input'), exist_ok=True)
  for t in ('style_ll', 'style_id'):
    os.makedirs(os.path.join(dst, 'output', t), exist_ok=True)

  def link(target, linkpath):
    if os.path.lexists(linkpath):
      os.remove(linkpath)
    os.symlink(target, linkpath)

  for n in names:
    link(os.path.join(src, 'input', n), os.path.join(dst, 'input', n))
    link(os.path.join(src, 'output', n),
         os.path.join(dst, 'output', 'style_ll', n))
    link(os.path.join(src, 'input', n),
         os.path.join(dst, 'output', 'style_id', n))

  shutil.copyfile(os.path.join(esrc, 'output', exemplar),
                  os.path.join(dst, 'input', 'style_ll.png'))
  shutil.copyfile(os.path.join(esrc, 'input', exemplar),
                  os.path.join(dst, 'input', 'style_id.png'))

  with open(os.path.join(dst, 'filelist.txt'), 'w') as f:
    f.write('\n'.join(names) + '\n')
  with open(os.path.join(dst, 'targets.txt'), 'w') as f:
    f.write('style_ll\nstyle_id\n')
  print(f'wrote {dst}: {len(names)} frames x 2 styles '
        f'(exemplar {exemplar} from {esrc})')


if __name__ == '__main__':
  main()
