"""The port's dataset generators (``hdrnet_torch.scripts.make_{ll,usm,st}_
dataset``) against the JAX package's scripts on the CPU.

make_ll_dataset holds to the JAX script's jitted path (``make_jax_synth``,
``make_jax_enhance``): the same numpy draws, float32 arithmetic in
another library. The synthesis to 1e-5; the operator to 1e-4, because
its remap ``sigma * (|d| / sigma) ** 0.2`` has an unbounded slope at
d = 0, so a luminance one float32 ulp apart from XLA's near a remap
gamma moves that gamma's coefficient, and the pyramids spread it
(measured here at most 1.663e-05 over these three 64^2 images, the
synthesis 3.16e-06); the PNGs to one code on fewer than 1% of values.
make_usm_dataset writes the JAX script's files and make_st_dataset its
layout.
"""

import functools
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from hdrnet_torch.config import DataConfig
from hdrnet_torch.data import ImageFilesDataPipeline
from hdrnet_torch.scripts import make_ll_dataset as ll
from hdrnet_torch.scripts import make_st_dataset, make_usm_dataset

SCRIPTS = os.path.join(os.path.dirname(__file__), '..', 'scripts')
OP = dict(sigma=0.35, alpha=0.2, levels=5)  # the generators' defaults
SIZE = 64


def _jax_script(name):
  sys.path.insert(0, SCRIPTS)
  try:
    return __import__(name)
  finally:
    sys.path.remove(SCRIPTS)


@pytest.fixture(scope='module')
def jax_ll():
  """The JAX script, its jitted synthesis and operator compiled once at
  SIZE (its main builds them anew for each split; the cache returns the
  same functions)."""
  gen = _jax_script('make_ll_dataset')
  synth = functools.lru_cache()(gen.make_jax_synth)
  enhance = functools.lru_cache()(gen.make_jax_enhance)
  return gen, synth, enhance


def test_synth_and_enhance_match_the_jax_jitted_path(jax_ll):
  _, synth, enhance = jax_ll
  jax_rng, port_rng = np.random.RandomState(3), np.random.RandomState(3)
  for _ in range(3):
    want = synth(SIZE)(jax_rng)
    got = ll.synth_photo(port_rng, SIZE, 'cpu')
    assert got.dtype == torch.float32 and got.shape == (SIZE, SIZE, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(ll.enhance(torch.from_numpy(want), **OP).numpy(),
                               enhance(SIZE, **OP)(want), rtol=0, atol=1e-4)
  assert jax_rng.rand() == port_rng.rand()  # the same draws, in order


def test_main_writes_the_jax_scripts_files(jax_ll, tmp_path, monkeypatch):
  gen, synth, enhance = jax_ll
  monkeypatch.setattr(gen, 'make_jax_synth', synth)
  monkeypatch.setattr(gen, 'make_jax_enhance', enhance)
  argv = ['--n_train', '2', '--n_test', '1', '--size', str(SIZE),
          '--seed', '5']
  gen.main([str(tmp_path / 'jax'), *argv])
  ll.main([str(tmp_path / 'port'), *argv, '--device', 'cpu'])
  for split in ('train', 'test'):
    names = (tmp_path / 'jax' / split / 'filelist.txt').read_text()
    assert (tmp_path / 'port' / split / 'filelist.txt').read_text() == names
    for name in names.split():
      for sub in ('input', 'output'):
        want, got = (np.asarray(Image.open(tmp_path / t / split / sub / name),
                                np.int64) for t in ('jax', 'port'))
        diff = np.abs(got - want)
        assert diff.max() <= 1 and (diff > 0).mean() < 0.01, (
            split, sub, name, diff.max(), (diff > 0).mean())


def test_operator_semantics_and_pipeline(tmp_path):
  """tests/test_data.py's generator checks on the port: a flat image is
  unchanged, detail is boosted, the Laplacian pyramid round-trips, and
  the built set loads through the port's ImageFilesDataPipeline."""
  flat = torch.full((64, 64, 3), 0.5)
  np.testing.assert_allclose(ll.enhance(flat, levels=3).numpy(), flat.numpy(),
                             atol=1e-5)
  img = ll.synth_photo(np.random.RandomState(0), 128, 'cpu')
  tgt = ll.enhance(img, levels=4)
  assert 1e-3 < float((tgt - img).abs().mean()) < 0.2
  y = img[:, :, 0]
  lp = ll.laplacian_pyramid(y, 3)
  rec = ll.gaussian_pyramid(y, 3)[3]
  for l in reversed(range(3)):
    rec = ll.pyr_up(rec, lp[l].shape) + lp[l]
  np.testing.assert_allclose(rec.numpy(), y.numpy(), atol=1e-6)

  ll.main([str(tmp_path), '--n_train', '2', '--n_test', '1', '--size', '64',
           '--device', 'cpu'])
  pipe = ImageFilesDataPipeline(str(tmp_path / 'train'), DataConfig(
      batch_size=2, output_resolution=[48, 48], net_input_size=16,
      shuffle=False, random_crop=False, data_threads=1))
  batch = next(pipe.batches())
  assert batch['image_input'].shape == (2, 48, 48, 3)
  assert 0 < np.abs(batch['image_output'] - batch['image_input']).mean() < 0.2


def _tree(root, n=3, size=(40, 56)):
  os.makedirs(root / 'input')
  os.makedirs(root / 'output')
  rng = np.random.RandomState(4)
  names = [f'im{i}.png' for i in range(n)]
  for name in names:
    for sub in ('input', 'output'):
      Image.fromarray((rng.rand(*size, 3) * 255).astype(np.uint8)).save(
          root / sub / name)
  (root / 'filelist.txt').write_text('\n'.join(names) + '\n')
  return names


def test_make_usm_dataset_writes_the_jax_scripts_files(tmp_path, capsys):
  """Bit for bit (the port's blur is the native library's arithmetic
  but for a rare double rounding, which would show as one code)."""
  names = _tree(tmp_path / 'src')
  argv = ['--blur_sigma', '2.0', '--sharpen', '1.5']
  _jax_script('make_usm_dataset').main([str(tmp_path / 'src'),
                                        str(tmp_path / 'jax'), *argv])
  jax_out = capsys.readouterr().out
  mean = make_usm_dataset.main([str(tmp_path / 'src'), str(tmp_path / 'port'),
                                *argv])
  assert capsys.readouterr().out == jax_out
  assert f'mean identity PSNR {mean:.2f} dB over 3' in jax_out
  for name in ['filelist.txt'] + [f'{s}/{n}' for s in ('input', 'output')
                                  for n in names]:
    want = (tmp_path / 'jax' / name).read_bytes()
    assert (tmp_path / 'port' / name).read_bytes() == want, name


def test_make_st_dataset_writes_the_jax_scripts_layout(tmp_path):
  _tree(tmp_path / 'src')
  _tree(tmp_path / 'ex', n=2)
  argv = ['--exemplar', 'im1.png', '--exemplar_src', str(tmp_path / 'ex')]
  _jax_script('make_st_dataset').main([str(tmp_path / 'src'),
                                       str(tmp_path / 'jax'), *argv])
  make_st_dataset.main([str(tmp_path / 'src'), str(tmp_path / 'port'), *argv])

  def walk(root):
    out = {}
    for d, _, files in os.walk(root):
      for f in files:
        p = os.path.join(d, f)
        rel = os.path.relpath(p, root)
        out[rel] = (('link', os.readlink(p)) if os.path.islink(p)
                    else ('file', open(p, 'rb').read()))
    return out
  want = walk(tmp_path / 'jax')
  assert walk(tmp_path / 'port') == want
  assert want['input/style_ll.png'] == (
      'file', (tmp_path / 'ex' / 'output' / 'im1.png').read_bytes())
  assert want['output/style_id/im0.png'] == (
      'link', str(tmp_path / 'src' / 'input' / 'im0.png'))
  assert want['targets.txt'] == ('file', b'style_ll\nstyle_id\n')
