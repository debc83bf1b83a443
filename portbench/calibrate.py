"""Readings from which a cell's correctness limits are set (not run by
the benchmark's own runs).

    python -m portbench.calibrate --workload <cell> --seeds 1,2,...
        [--control-seeds 1,2,3] [--seconds 2] [--out file.jsonl]

In one process, on the card: for each of ``--seeds`` a run of the cell
with a short window (the program's sound readings: the lower reading of
each number is their largest), then for each of ``--control-seeds`` the
driver's controls at the cell's own size (the reference in TF32 in the
program's place, and the planted faults). Prints one JSON line a
reading.
"""

import argparse
import json
import sys
import time


def main(argv=None):
  p = argparse.ArgumentParser(prog='python -m portbench.calibrate')
  p.add_argument('--workload', required=True)
  p.add_argument('--seeds', default='')
  p.add_argument('--control-seeds', default='')
  p.add_argument('--seconds', type=float, default=2.0)
  p.add_argument('--out')
  args = p.parse_args(argv)
  from portbench import harness
  harness.set_caches()
  import torch
  if not torch.cuda.is_available():
    print('portbench.calibrate: no CUDA device', file=sys.stderr)
    return 3
  sink = open(args.out, 'a') if args.out else None
  try:
    def emit(rec):
      line = json.dumps(rec)
      print(line, flush=True)
      if sink:
        sink.write(line + '\n')
        sink.flush()
    for seed in [int(s) for s in args.seeds.split(',') if s]:
      t = time.monotonic()
      run, out, line = harness.run_cell(args.workload, seed, args.seconds, 0,
                                        'cuda:0')
      emit({'cell': args.workload, 'seed': seed, 'kind': 'sound',
            'correct': out.correct, 'error': out.error,
            'numbers': {k: v['value'] for k, v in out.checks.items()},
            'metrics': {k: v['value'] for k, v in line['metrics'].items()},
            'seconds': time.monotonic() - t})
    for seed in [int(s) for s in args.control_seeds.split(',') if s]:
      t = time.monotonic()
      run = harness.make_run(args.workload, seed, args.seconds, 0, 'cuda:0',
                             time.monotonic())
      emit({'cell': args.workload, 'seed': seed, 'kind': 'control',
            'numbers': harness.driver(run).control(run),
            'seconds': time.monotonic() - t})
  finally:
    if sink:
      sink.close()
  return 0


if __name__ == '__main__':
  sys.exit(main())
