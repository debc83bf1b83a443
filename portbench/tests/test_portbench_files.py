"""BENCHMARK.json and every file it names: the benchmark's contract."""

import ast
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / 'portbench'
BENCH = json.loads((ROOT / 'BENCHMARK.json').read_text())
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
E2E_KEYS = {'name', 'unit', 'better', 'bound', 'source'}
LAYER_KEYS = {'name', 'unit', 'better', 'source', 'layer', 'moves'}


def _cells():
  return [w['name'] for w in BENCH['workloads']]


def test_top_level_keys_and_size():
  assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs',
                        'workloads', 'end_to_end', 'per_layer'}
  assert (ROOT / 'BENCHMARK.json').stat().st_size <= 64 * 1024
  assert BENCH['paths'] == ['portbench']
  assert 1 <= len(BENCH['command']) <= 32
  for word in BENCH['command']:
    assert 1 <= len(word) <= 200 and not word.startswith('/')
    assert '..' not in word


def test_run_seconds_fit_a_full_check_of_24_cells():
  rs = BENCH['run_seconds']
  assert isinstance(rs, int) and 1 <= rs <= 51
  runs = 2 + 14 * 24
  assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_keys():
  names = []
  for m in BENCH['end_to_end']:
    assert set(m) - {'workloads'} == E2E_KEYS
    assert 0.01 <= m['bound'] <= 0.25
    assert m['source'] in ('host_clock', 'device_trace')
    names.append(m['name'])
  for m in BENCH['per_layer']:
    assert set(m) - {'workloads'} == LAYER_KEYS
    assert m['source'] in ('device_trace', 'program_span', 'program_counter',
                           'host_clock')
    assert 1 <= len(m['layer']) <= 200 and '\t' not in m['layer']
    names.append(m['name'])
  for m in BENCH['end_to_end'] + BENCH['per_layer']:
    assert NAME.match(m['name']) and UNIT.match(m['unit'])
    assert m['better'] in ('lower', 'higher')
  assert len(names) == len(set(names))
  assert 'setup_s' in names
  setup = next(m for m in BENCH['end_to_end'] if m['name'] == 'setup_s')
  assert setup['bound'] == 0.25


def test_roofline_and_mfu_names():
  for m in BENCH['per_layer']:
    if 'roofline' in m['name']:
      assert m['name'].endswith('_roofline') and m['unit'] == '%'
  assert {m['moves'] for m in BENCH['per_layer'] if 'mfu' in m['name']} == {
      m['moves'] for m in BENCH['per_layer'] if 'roofline' in m['name']}


def test_workloads_one_chip_unique_and_complete():
  pairs = set()
  for w in BENCH['workloads']:
    assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
    assert w['chips'] == 1
    assert NAME.match(w['name']) and NAME.match(w['traffic'])
    assert 1 <= len(w['why']) <= 200 and '\n' not in w['why']
    assert (w['config'], w['traffic']) not in pairs
    pairs.add((w['config'], w['traffic']))
    assert (HERE / 'traffic' / f"{w['traffic']}.json").is_file()
    limits = json.loads((HERE / 'cells' / f"{w['name']}.json").read_text())
    assert limits['limits']
  assert len(set(_cells())) == len(_cells())


def test_configs():
  used = {w['config'] for w in BENCH['workloads']}
  files = set()
  for c in BENCH['configs']:
    assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
    assert 1 <= len(c['why']) <= 200 and '\n' not in c['why']
    assert NAME.match(c['name']) and c['name'] in used
    assert c['file'].startswith('portbench/configs/')
    assert c['file'] not in files
    files.add(c['file'])
    body = json.loads((ROOT / c['file']).read_text())
    assert body['reduced'] == c['reduced'] == []
    assert body['source'] == c['source']
    assert c['source'].startswith('https://')
  assert used == {c['name'] for c in BENCH['configs']}


def test_every_model_has_its_family_file():
  """The harness finds a model's counts and plain reference by its
  model_name alone: a new family is a new file."""
  from portbench import models
  for c in BENCH['configs']:
    name = json.loads((ROOT / c['file']).read_text())['model']['model_name']
    family = models.load(name)
    for attr in models.REQUIRED:
      assert hasattr(family, attr), (name, attr)


def test_every_cell_reports_enough():
  from portbench.harness import cell_metrics
  for cell in _cells():
    _, e2e, layer = cell_metrics(BENCH, cell)
    names = {m['name'] for m in e2e}
    assert 'setup_s' in names and len(names) >= 2
    assert layer


def test_per_layer_metrics_move_what_their_cells_report():
  from portbench.harness import cell_metrics
  layers = {}
  for m in BENCH['per_layer']:
    assert m['workloads']
    for cell in m['workloads']:
      _, e2e, _ = cell_metrics(BENCH, cell)
      assert m['moves'] in {e['name'] for e in e2e}, (m['name'], cell)
    assert (HERE / 'layer_metrics' / f"{m['name']}.py").is_file()
    layers.setdefault(m['name'], m['layer'])


def test_layer_metric_files_define_read():
  for m in BENCH['per_layer']:
    tree = ast.parse((HERE / 'layer_metrics' / f"{m['name']}.py").read_text())
    assert any(isinstance(n, ast.FunctionDef) and n.name == 'read'
               for n in tree.body), m['name']


@pytest.mark.parametrize('path', sorted(p.relative_to(HERE).as_posix()
                                        for p in HERE.rglob('*')
                                        if p.is_file()
                                        and '__pycache__' not in p.parts))
def test_file_names_use_name_characters(path):
  assert re.match(r'^[A-Za-z0-9_.\-/]+$', path)
