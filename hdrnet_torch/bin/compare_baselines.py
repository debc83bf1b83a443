#!/usr/bin/env python
"""Quality/runtime comparison figure + table (the port's own copy of
``hdrnet_tpu.bin.compare_baselines``).

Reference: scripts/extra_figures/compare_to_unet.py — plots PSNR vs
runtime for HDRNet configs against U-Net / dilated-conv baselines and
the Local Laplacian reference filter (383.584 ms @ 4MP on CPU).

Reads eval PSNRs from checkpoint summaries.jsonl files and runtimes
from bench JSON files (bench.py output); also accepts manual rows.

  python -m hdrnet_torch.bin.compare_baselines out.png \\
      --run std:ckpt/std:bench_std.json --run unet:ckpt/unet:bench_u.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys

# Published reference quality numbers (compare_to_unet.py:19-54), for
# context lines on the plot.
REFERENCE_RESULTS = {
    'HDRNetCurves l8/s16 (reference)': 31.8,
    'HDRNetCurves l16/s32 (reference, best)': 32.7,
    'U-Net d11/w64 (reference, best)': 35.7,
    'Dilated d3/w64 (reference, best)': 24.5,
}
LOCAL_LAPLACIAN_CPU_MS = 383.584  # @4MP (compare_to_unet.py:57)


def load_eval_psnr(ckpt_dir):
  path = os.path.join(ckpt_dir, 'summaries.jsonl')
  best = None
  with open(path) as f:
    for line in f:
      rec = json.loads(line)
      p = rec.get('eval_psnr', rec.get('psnr'))
      if p is not None:
        best = p if best is None else max(best, p)
  return best


def load_runtime_ms(bench_json):
  with open(bench_json) as f:
    rec = json.loads(f.read().strip().splitlines()[-1])
  return rec['detail']['stage_ms']['end_to_end_4k']


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument('output', help='output .png figure')
  parser.add_argument('--run', action='append', default=[],
                      help='label:checkpoint_dir[:bench.json]')
  parser.add_argument('--point', action='append', default=[],
                      help='manual label:psnr_db:runtime_ms')
  args = parser.parse_args(argv)

  rows = []
  for spec in args.run:
    parts = spec.split(':')
    label, ckpt = parts[0], parts[1]
    psnr = load_eval_psnr(ckpt)
    ms = load_runtime_ms(parts[2]) if len(parts) > 2 else None
    rows.append((label, psnr, ms))
  for spec in args.point:
    label, p, ms = spec.split(':')
    rows.append((label, float(p), float(ms)))

  print(f'{"model":40s} {"PSNR (dB)":>10s} {"ms/frame":>12s}')
  for label, p, ms in rows:
    print(f'{label:40s} {p if p is not None else float("nan"):10.2f} '
          f'{ms if ms is not None else float("nan"):12.3f}')
  for label, p in REFERENCE_RESULTS.items():
    print(f'{label:40s} {p:10.2f} {"-":>12s}')

  try:
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
  except ImportError:
    print('matplotlib unavailable; table only', file=sys.stderr)
    return
  fig, ax = plt.subplots(figsize=(7, 5))
  for label, p, ms in rows:
    if p is None or ms is None:
      continue
    ax.semilogx([ms], [p], 'o', label=label)
  ax.axvline(LOCAL_LAPLACIAN_CPU_MS, ls='--', c='gray',
             label='Local Laplacian (CPU, reference)')
  for label, p in REFERENCE_RESULTS.items():
    ax.axhline(p, ls=':', lw=0.6, c='lightgray')
    ax.text(ax.get_xlim()[0], p, label, fontsize=6, va='bottom')
  ax.set_xlabel('runtime per frame (ms, log)')
  ax.set_ylabel('PSNR (dB)')
  ax.legend(fontsize=7)
  fig.tight_layout()
  fig.savefig(args.output, dpi=150)
  print(f'wrote {args.output}')


if __name__ == '__main__':
  main()
