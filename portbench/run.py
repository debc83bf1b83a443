"""The benchmark's command: one cell, one run, one result line.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Run from the root of a checkout, on a machine with the cell's CUDA
devices; without them it exits non-zero and prints no result. The last
line of standard output is the result's JSON object.
"""

import time

T_START = time.monotonic()

import sys  # noqa: E402


def main(argv=None):
  from portbench import harness
  return harness.main(sys.argv[1:] if argv is None else argv, T_START)


if __name__ == '__main__':
  sys.exit(main())
