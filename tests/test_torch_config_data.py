"""The port's own config and host input pipeline against the JAX
package's.

A ``config.json`` written by either package loads in the other field for
field. For the same files, config and seed, the port's pipelines
(``hdrnet_torch.data``, numpy image operations) give the JAX package's
batches (``hdrnet_tpu.data``, which runs its C++ library
``libhdrnet_io.so``): the uint8 and index-permutation paths bit for bit,
the float paths (bilinear resize, Gaussian blur) to 1e-6.
"""

import dataclasses
import os

import numpy as np
import pytest
from PIL import Image

from hdrnet_tpu import config as jax_config
from hdrnet_tpu import native
from hdrnet_tpu.data import make_pipeline as jax_make_pipeline

from hdrnet_torch import config
from hdrnet_torch.data import hostops, make_pipeline

FLOAT_TOL = 1e-6


def _custom(cfg_module):
  return cfg_module.Config(
      model=cfg_module.ModelConfig(model_name='HDRNetGaussianPyrNN',
                                   net_input_size=128, luma_bins=4,
                                   output_resolution=[96, 64],
                                   batch_norm=True, guide_complexity=8),
      data=cfg_module.DataConfig(pipeline='UnsharpMaskDataPipeline',
                                 batch_size=3, blur_sigma=2.5,
                                 input_white_level=32767.0, rotate=True),
      train=cfg_module.TrainConfig(lr_schedule='cosine', lr_decay_steps=10,
                                   mesh_shape=[1, 1], guide_reg=0.1))


@pytest.mark.parametrize('writer,reader', [(config, jax_config),
                                           (jax_config, config)])
@pytest.mark.parametrize('make', ['default', 'custom'])
def test_config_json_loads_in_the_other_package(tmp_path, writer, reader,
                                                make):
  cfg = writer.Config() if make == 'default' else _custom(writer)
  cfg.save(str(tmp_path))
  got = reader.Config.load(str(tmp_path))
  assert type(got) is reader.Config
  assert dataclasses.asdict(got) == dataclasses.asdict(cfg)
  assert got.to_json() == cfg.to_json()


def test_config_dataclasses_match_field_for_field():
  for name in ('Config', 'ModelConfig', 'DataConfig', 'TrainConfig'):
    port, ref = getattr(config, name), getattr(jax_config, name)
    assert ([(f.name, f.type) for f in dataclasses.fields(port)] ==
            [(f.name, f.type) for f in dataclasses.fields(ref)]), name
    assert dataclasses.asdict(port()) == dataclasses.asdict(ref()), name


def test_jax_pipeline_runs_the_native_library():
  assert native.AVAILABLE, 'the comparison needs libhdrnet_io.so'


@pytest.mark.parametrize('dtype', [np.uint8, np.uint16, np.float32])
def test_hostops_match_the_native_library(dtype):
  rng = np.random.RandomState(0)
  if dtype == np.float32:
    img = rng.rand(37, 53, 3).astype(np.float32)
  else:
    img = rng.randint(0, np.iinfo(dtype).max + 1, (37, 53, 3)).astype(dtype)
    for white in (255.0, 32767.0, 65535.0):
      np.testing.assert_array_equal(hostops.to_float(img, white),
                                    native.to_float(img, white))
  for size in [(16, 16), (64, 80), (11, 100), (37, 53)]:
    np.testing.assert_array_equal(hostops.resize_nearest(img, size),
                                  native.resize_nearest(img, size))
  for args in [(3, 5, 20, 30, False, False, 0), (0, 0, 37, 53, True, False, 1),
               (2, 1, 30, 40, True, True, 2), (5, 7, 25, 19, False, True, 3)]:
    np.testing.assert_array_equal(hostops.crop_flip_rot(img, *args),
                                  native.crop_flip_rot(img, *args))
  if dtype == np.float32:
    for size in [(16, 16), (64, 80), (33, 17)]:
      np.testing.assert_allclose(hostops.resize_bilinear(img, size),
                                 native.resize_bilinear(img, size), rtol=0,
                                 atol=FLOAT_TOL)
    for sigma in (0.3, 1.0, 4.0, 12.0):
      np.testing.assert_allclose(hostops.gaussian_blur(img, sigma),
                                 native.gaussian_blur(img, sigma), rtol=0,
                                 atol=FLOAT_TOL)


@pytest.fixture()
def image_files(tmp_path):
  """filelist.txt + input/ + output/ with 8-bit pairs and one 16-bit
  pair (the mixed-depth float path)."""
  rng = np.random.RandomState(0)
  os.makedirs(tmp_path / 'input')
  os.makedirs(tmp_path / 'output')
  names = []
  for i in range(5):
    h, w = (80 + 4 * i, 96 - 2 * i)
    im = (rng.rand(h, w, 3) * 255).astype(np.uint8)
    out = np.clip(im.astype(np.float32) * 1.3, 0, 255).astype(np.uint8)
    Image.fromarray(im).save(tmp_path / 'input' / f'im{i}.png')
    Image.fromarray(out).save(tmp_path / 'output' / f'im{i}.png')
    names.append(f'im{i}.png')
  deep = (rng.rand(84, 90) * 65535).astype(np.uint16)
  Image.fromarray(deep).save(tmp_path / 'input' / 'deep.png')
  Image.fromarray((deep >> 8).astype(np.uint8)).save(
      tmp_path / 'output' / 'deep.png')
  (tmp_path / 'filelist.txt').write_text('\n'.join(names))
  (tmp_path / 'mixed.txt').write_text('\n'.join(names[:2] + ['deep.png']))
  return tmp_path


def _batches(pipeline, n, prefetch):
  it = (pipeline.prefetching_batches(seed=3) if prefetch
        else pipeline.batches(seed=3))
  try:
    return [next(it) for _ in range(n)]
  finally:
    it.close()


def _assert_same_batches(got, want, atol=0.0):
  assert len(got) == len(want)
  for g, w in zip(got, want):
    assert sorted(g) == sorted(w)
    for k in w:
      assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
      if atol:
        np.testing.assert_allclose(g[k], w[k], rtol=0, atol=atol, err_msg=k)
      else:
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize('device_normalize', [False, True])
@pytest.mark.parametrize('prefetch', [False, True])
def test_image_files_pipeline_matches_jax(image_files, device_normalize,
                                          prefetch):
  """Random crops, flips and rotations (index permutations) and the
  nearest preview, on uint8 samples (device_normalize) and on float32
  ones (the white-level division): bit for bit."""
  kw = dict(batch_size=2, output_resolution=[48, 40], net_input_size=16,
            fliplr=True, flipud=True, rotate=True, data_threads=1,
            device_normalize=device_normalize)
  got = _batches(make_pipeline(str(image_files),
                               config.DataConfig(**kw)), 4, prefetch)
  want = _batches(jax_make_pipeline(str(image_files),
                                    jax_config.DataConfig(**kw)), 4, prefetch)
  _assert_same_batches(got, want)
  if device_normalize:
    assert got[0]['image_input'].dtype == np.uint8


def test_mixed_depth_pipeline_matches_jax(image_files):
  """A 16-bit input beside 8-bit ones: the float path, by white level."""
  kw = dict(batch_size=3, output_resolution=[64, 64], net_input_size=32,
            random_crop=False, shuffle=False, device_normalize=True)
  got = _batches(make_pipeline(str(image_files / 'mixed.txt'),
                               config.DataConfig(**kw)), 2, False)
  want = _batches(jax_make_pipeline(str(image_files / 'mixed.txt'),
                                    jax_config.DataConfig(**kw)), 2, False)
  _assert_same_batches(got, want)
  assert got[0]['image_input'].dtype == np.float32


@pytest.mark.parametrize('sigma,sharpen', [(4.0, 1.0), (1.5, 0.5)])
def test_unsharp_mask_pipeline_matches_jax(image_files, sigma, sharpen):
  """The synthetic unsharp-mask target: the Gaussian blur's float path,
  then the quantized target."""
  kw = dict(pipeline='UnsharpMaskDataPipeline', batch_size=2,
            output_resolution=[48, 48], net_input_size=16, data_threads=1,
            blur_sigma=sigma, sharpen=sharpen, fliplr=True)
  got = _batches(make_pipeline(str(image_files),
                               config.DataConfig(**kw)), 3, False)
  want = _batches(jax_make_pipeline(str(image_files),
                                    jax_config.DataConfig(**kw)), 3, False)
  _assert_same_batches(got, want, atol=FLOAT_TOL)
