"""The quality-triage tools of the port (``hdrnet_torch/scripts/
guide_stats.py`` and ``diagnose_pyramid.py``) against the JAX scripts
(``scripts/guide_stats.py``, ``scripts/diagnose_pyramid.py``) on the CPU.

Tiny ``HDRNetGaussianPyrNN`` and ``HDRNetCurves`` models are trained three
steps by ``hdrnet_tpu`` and saved with orbax (``tests/jax_checkpoints.py``),
then converted by ``scripts/convert_jax_checkpoint.py``. A data directory
of 8-bit PNG pairs (``filelist.txt``, ``input/``, ``output/``) is read by
both. The JAX scripts run as they are, as subprocesses; the port's with
``--device cpu`` in this process; both write ``--json``. The reports are
compared field by field: integers and names exactly; ``diagnose_pyramid``'s
floats within 1e-5; ``guide_stats``' floats within one rounding step plus
1e-5, since the scripts round them (p01, p99 and std to 4 decimals,
``effective_range_bins`` to 2), and two values within 1e-5 of each other
can round one step apart.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from hdrnet_tpu import config as jax_config

from hdrnet_torch.scripts import diagnose_pyramid, guide_stats

import jax_checkpoints

REPO = pathlib.Path(__file__).resolve().parents[1]
SMALL = dict(net_input_size=32, spatial_bin=8, luma_bins=4,
             guide_complexity=4)
SIZE = [64, 64]
LIMIT = 4
FLOAT_TOL = 1e-5
ROUNDED = {'p01': 4, 'p99': 4, 'std': 4, 'effective_range_bins': 2}


def _image_files(directory):
  """filelist.txt + input/ + output/ with five 8-bit pairs of sizes
  80x96 to 96x88, the targets brightened 1.3x (the layout of
  ``tests/test_torch_config_data.py``'s ``image_files``)."""
  rng = np.random.RandomState(0)
  os.makedirs(directory / 'input')
  os.makedirs(directory / 'output')
  names = []
  for i in range(5):
    h, w = (80 + 4 * i, 96 - 2 * i)
    im = (rng.rand(h, w, 3) * 255).astype(np.uint8)
    out = np.clip(im.astype(np.float32) * 1.3, 0, 255).astype(np.uint8)
    Image.fromarray(im).save(directory / 'input' / f'im{i}.png')
    Image.fromarray(out).save(directory / 'output' / f'im{i}.png')
    names.append(f'im{i}.png')
  (directory / 'filelist.txt').write_text('\n'.join(names))
  return directory


@pytest.fixture(scope='module')
def triage(tmp_path_factory):
  """{model name: (JAX checkpoint dir, port checkpoint dir)} and the data
  directory."""
  root = tmp_path_factory.mktemp('triage')
  ckpts = {}
  for name in ('HDRNetGaussianPyrNN', 'HDRNetCurves'):
    jax_dir, port_dir = root / f'{name}_jax', root / f'{name}_port'
    jax_checkpoints.write(jax_dir, jax_config.Config(
        model=jax_config.ModelConfig(model_name=name, output_resolution=SIZE,
                                     **SMALL),
        train=jax_config.TrainConfig(learning_rate=1e-2),
        data=jax_config.DataConfig(output_resolution=SIZE,
                                   net_input_size=SMALL['net_input_size'])))
    jax_checkpoints.converter().main([str(jax_dir), str(port_dir)])
    ckpts[name] = (jax_dir, port_dir)
  return ckpts, _image_files(root / 'data')


def _reports(script, port_main, ckpts, data, tmp_path):
  """(JAX report, port report) of one tool, each read from its --json."""
  jax_dir, port_dir = ckpts
  want_path, got_path = tmp_path / 'jax.json', tmp_path / 'port.json'
  r = subprocess.run([sys.executable, str(REPO / 'scripts' / script),
                      str(jax_dir), str(data), '--limit', str(LIMIT),
                      '--json', str(want_path)], cwd=REPO,
                     capture_output=True, text=True, timeout=600,
                     check=False)
  assert r.returncode == 0, r.stdout + r.stderr
  port_main([str(port_dir), str(data), '--limit', str(LIMIT), '--json',
             str(got_path), '--device', 'cpu'])
  return (json.loads(want_path.read_text()),
          json.loads(got_path.read_text()))


def _assert_record(got, want, float_tol, where):
  assert sorted(got) == sorted(want), where
  for key, w in want.items():
    g = got[key]
    if isinstance(w, float):
      tol = float_tol(key)
      assert abs(g - w) <= tol, f'{where}.{key}: {g} vs {w} (tol {tol})'
    else:
      assert g == w, f'{where}.{key}: {g} vs {w}'


@pytest.mark.parametrize('name, n_guides', [('HDRNetGaussianPyrNN', 3),
                                            ('HDRNetCurves', 1)])
def test_guide_stats_match_the_jax_script(triage, tmp_path, name, n_guides):
  ckpts, data = triage
  want, got = _reports('guide_stats.py', guide_stats.main, ckpts[name], data,
                       tmp_path)
  assert got['checkpoint'] == str(ckpts[name][1])
  del got['checkpoint'], want['checkpoint']
  assert (got['n_images'], got['step'], got['model']) == (LIMIT, 3, name)
  guides_got, guides_want = got.pop('guides'), want.pop('guides')
  assert got == want
  assert len(guides_got) == len(guides_want) == n_guides
  luma_bins = want['luma_bins']
  for j, (g, w) in enumerate(zip(guides_got, guides_want)):
    _assert_record(
        g, w, lambda key: 10.0 ** -ROUNDED[key] + FLOAT_TOL * (
            luma_bins if key == 'effective_range_bins' else 1),
        f'{name} guide[{j}]')


def test_diagnose_pyramid_matches_the_jax_script(triage, tmp_path):
  ckpts, data = triage
  want, got = _reports('diagnose_pyramid.py', diagnose_pyramid.main,
                       ckpts['HDRNetGaussianPyrNN'], data, tmp_path)
  for report in (want, got):
    del report['summary']['checkpoint']
  assert got['summary']['step'] == 3
  assert [r['scale_divisor'] for r in got['summary']['levels']] == [4, 2, 1]
  levels_got = got['summary'].pop('levels')
  levels_want = want['summary'].pop('levels')
  _assert_record(got['summary'], want['summary'], lambda key: FLOAT_TOL,
                 'summary')
  for il, (g, w) in enumerate(zip(levels_got, levels_want, strict=True)):
    _assert_record(g, w, lambda key: FLOAT_TOL, f'summary.levels[{il}]')
  assert len(got['per_image']) == len(want['per_image']) == LIMIT
  for i, (g, w) in enumerate(zip(got['per_image'], want['per_image'])):
    _assert_record({'psnr': g['psnr']}, {'psnr': w['psnr']},
                   lambda key: FLOAT_TOL, f'per_image[{i}]')
    for il, (gl, wl) in enumerate(zip(g['levels'], w['levels'],
                                      strict=True)):
      _assert_record(gl, wl, lambda key: FLOAT_TOL,
                     f'per_image[{i}].levels[{il}]')


def test_diagnose_pyramid_refuses_another_model(triage):
  ckpts, data = triage
  with pytest.raises(ValueError, match='HDRNetCurves: diagnose_pyramid'):
    diagnose_pyramid.main([str(ckpts['HDRNetCurves'][1]), str(data),
                           '--device', 'cpu'])
