"""Every cell on the card at reduced frame sizes: sound runs correct, the
control (the reference in TF32) failing a limit. Marked ``gpu``; run on
the card with

    python -m pytest -m gpu portbench/tests/test_portbench_gpu.py
"""

import json
import time
from pathlib import Path

import pytest
import torch

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w['name'] for w in json.loads(
    (ROOT / 'BENCHMARK.json').read_text())['workloads']]
REDUCED = {
    'stream': {'height': 540, 'width': 960},
    'train': {'crop': 512, 'pair_size': 576},
}


@pytest.fixture
def card():
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA device')
  return 'cuda:0'


def _traffic(cell):
  return REDUCED['stream' if 'stream' in cell else 'train']


@pytest.mark.gpu
@pytest.mark.parametrize('cell', CELLS)
def test_traced_run_on_the_card(cell, card):
  _, out, line = harness.run_cell(cell, 2**31 + 31, 2.0, 1, card,
                                  traffic=_traffic(cell))
  assert out.correct, line['checks']
  assert line['device']['busy_s'] > 0
  for m in line['metrics'].values():
    if m['unit'] == '%':
      assert 0 < m['value'] < 105
  assert line['metrics'], line


@pytest.mark.gpu
@pytest.mark.parametrize('cell', CELLS)
def test_control_fails_on_the_card(cell, card):
  run = harness.make_run(cell, 2**31 + 32, 1.0, 0, card, time.monotonic(),
                         traffic=_traffic(cell))
  got = harness.driver(run).control(run)
  tf32 = {k.split('.', 1)[1]: v for k, v in got.items()
          if k.startswith('tf32.')}
  assert any(v > run.limits[k] for k, v in tf32.items()), (tf32, run.limits)
