"""The port's device-resident data (``hdrnet_torch.data.device``) and the
training loop's device route, held to ``hdrnet_tpu.data.device`` and the
JAX loop on the CPU.

The augmentation (crop, flips, rot90, nearest lowres) is an index
permutation, so it is held bit for bit, uint8 and uint16; so is
``param_stream``'s draw for a seed, and the style-transfer loader (the
same decode, resize and requantization). The unsharp targets are float32
sums in another order than XLA's and than the host blur's: held to one
quantum.
"""

import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from hdrnet_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from hdrnet_torch.data import device as dd
from hdrnet_torch.data import pipeline as port_pipeline
from hdrnet_torch.training import loop
from hdrnet_tpu.config import DataConfig as JaxDataConfig
from hdrnet_tpu.data import device as jdd
from hdrnet_tpu.data import pipeline as jax_pipeline
from hdrnet_tpu.training import loop as jax_loop

SMALL = dict(net_input_size=32, spatial_bin=8, luma_bins=4,
             guide_complexity=4)


def _cfg(**kw):
  base = dict(batch_size=2, output_resolution=[32, 32], net_input_size=16,
              shuffle=False, random_crop=False, data_threads=1)
  base.update(kw)
  return DataConfig(**base), JaxDataConfig(**base)


def _write_dataset(root, n=3, size=(48, 64), sixteen=False, seed=0):
  os.makedirs(root / 'input', exist_ok=True)
  os.makedirs(root / 'output', exist_ok=True)
  rng = np.random.RandomState(seed)
  names = []
  for i in range(n):
    names.append(f'im{i}.png')
    for sub in ('input', 'output'):
      arr = rng.rand(*size, 3)
      if sixteen:  # PIL writes 16-bit PNGs as one channel
        Image.fromarray((arr[:, :, 0] * 65535).astype(np.uint16)).save(
            root / sub / names[-1])
      else:
        Image.fromarray((arr * 255).astype(np.uint8)).save(
            root / sub / names[-1])
  (root / 'filelist.txt').write_text('\n'.join(names) + '\n')
  return names


@pytest.mark.parametrize('dtype', [np.uint8, np.uint16])
def test_augment_matches_jax_bit_for_bit(dtype):
  """All four keys, every rot_k with both flips (and another sample with
  the opposite flip and the next rotation), at two crop offsets."""
  rng = np.random.RandomState(1)
  hi = np.iinfo(dtype).max + 1
  ins = rng.randint(0, hi, (3, 50, 50, 3)).astype(dtype)
  outs = rng.randint(0, hi, (3, 50, 50, 3)).astype(dtype)
  jax_aug = jax.jit(jdd.make_device_augment([32, 32], 16, True))
  port_aug = dd.make_device_augment([32, 32], 16, True)
  tin, tout = dd._upload(ins, 'cpu'), dd._upload(outs, 'cpu')
  idx = np.array([2, 0])
  for fl in (0, 1):
    for fu in (0, 1):
      for k in range(4):
        params = {'y0': np.array([3, 18], np.int32),
                  'x0': np.array([11, 0], np.int32),
                  'fliplr': np.array([fl, 1 - fl], np.int32),
                  'flipud': np.array([fu, fu], np.int32),
                  'rot_k': np.array([k, (k + 1) % 4], np.int32)}
        want = jax_aug(jnp.asarray(ins[idx]), jnp.asarray(outs[idx]), params)
        got = port_aug(tin[idx], tout[idx], params)
        assert sorted(got) == sorted(want)
        for key in want:
          w = np.asarray(want[key])
          g = got[key].view(torch.int16).numpy().view(np.uint16) \
              if dtype == np.uint16 else got[key].numpy()
          assert g.dtype == w.dtype, key
          np.testing.assert_array_equal(g, w, err_msg=f'{key} {fl} {fu} {k}')


def test_augment_refuses_rotation_of_a_non_square_crop():
  with pytest.raises(ValueError, match='square'):
    dd.make_device_augment([32, 48], 16, True)
  dd.make_device_augment([32, 48], 16, False)


def test_param_stream_matches_jax(tmp_path):
  """Three epochs of 5 samples in batches of 2 (batches straddle the
  epochs), with shuffle, random crops, both flips and rotation."""
  _write_dataset(tmp_path, n=5, size=(40, 52))
  kw = dict(shuffle=True, random_crop=True, fliplr=True, flipud=True,
            rotate=True)
  pcfg, jcfg = _cfg(**kw)
  port = dd.DeviceDataset(dd.load_pairs(
      port_pipeline.ImageFilesDataPipeline(str(tmp_path), pcfg)), pcfg, 'cpu')
  jax_ds = jdd.DeviceDataset(jdd.load_pairs(
      jax_pipeline.ImageFilesDataPipeline(str(tmp_path), jcfg)), jcfg)
  pit, jit_ = port.param_stream(7, 2), jax_ds.param_stream(7, 2)
  for _ in range(3 * 5 // 2):
    p, j = next(pit), next(jit_)
    assert sorted(p) == sorted(j)
    for k in j:
      assert p[k].dtype == j[k].dtype, k
      np.testing.assert_array_equal(p[k], j[k], err_msg=k)
  np.testing.assert_array_equal(port.inputs.numpy(), np.asarray(jax_ds.inputs))


def _refusal(tmp_path, case):
  """(pairs, cfg kwargs) that each package must refuse."""
  rng = np.random.RandomState(2)

  def u8(*shape):
    return rng.randint(0, 256, shape).astype(np.uint8)
  if case == 'nonuniform':
    return [(u8(40, 40, 3), u8(40, 40, 3)), (u8(30, 40, 3), u8(30, 40, 3))], {}
  if case == 'mixed_dtypes':
    return [(u8(40, 40, 3), rng.randint(0, 65536, (40, 40, 3)).astype(
        np.uint16))], {}
  if case == 'smaller_than_crop':
    return [(u8(30, 40, 3), u8(30, 40, 3))], {}
  return [(u8(40, 40, 3), u8(40, 40, 3))], dict(
      rotate=True, output_resolution=[32, 24])


@pytest.mark.parametrize('case', ['nonuniform', 'mixed_dtypes',
                                  'smaller_than_crop', 'rotation_non_square'])
def test_device_dataset_refusals_match_jax(tmp_path, case):
  pairs, kw = _refusal(tmp_path, case)
  pcfg, jcfg = _cfg(**kw)
  with pytest.raises(ValueError) as want:
    jdd.DeviceDataset(pairs, jcfg)
  with pytest.raises(ValueError) as got:
    dd.DeviceDataset(pairs, pcfg, 'cpu')
  assert str(got.value) == str(want.value)


@pytest.mark.parametrize('dtype', [np.uint8, np.uint16])
def test_usm_synth_matches_jax_and_the_host_pipeline(tmp_path, dtype):
  """Against the JAX device synthesis and the host pipeline's _load
  (quantized as the files are), one quantum at most; the radius-12 blur
  runs past a 10-row image (the symmetric table covers it)."""
  rng = np.random.RandomState(3)
  hi = np.iinfo(dtype).max
  raw = rng.randint(0, hi + 1, (2, 10, 28, 3)).astype(dtype)
  for sigma, sharpen in ((2.0, 1.5), (4.0, 1.0)):
    want = np.asarray(jax.jit(jax.vmap(jdd.make_usm_synth(sigma, sharpen)))(
        jnp.asarray(raw))).astype(np.int64)
    got = dd.make_usm_synth(sigma, sharpen)(dd._upload(raw, 'cpu'))
    assert got.dtype == (torch.uint8 if dtype == np.uint8 else torch.uint16)
    got = got.view(torch.int16).numpy().view(np.uint16) \
        if dtype == np.uint16 else got.numpy()
    assert np.abs(got.astype(np.int64) - want).max() <= 1, (sigma, sharpen)
  if dtype == np.uint8:
    _write_dataset(tmp_path, n=2, size=(40, 56))
    pcfg, _ = _cfg(blur_sigma=2.0, sharpen=1.5)
    pipe = port_pipeline.UnsharpMaskDataPipeline(str(tmp_path), pcfg)
    dds = dd.load_usm_dataset(pipe, pcfg, 'cpu')
    assert dds.outputs.dtype == torch.uint8 and dds.nsamples == 2
    for i, spec in enumerate(pipe.specs):
      _, target = pipe._load(spec, None)
      host = np.floor(target * 255.0 + 0.5).astype(np.int64)
      assert np.abs(dds.outputs[i].numpy().astype(np.int64) - host).max() <= 1


def test_load_st_dataset_matches_jax(tmp_path):
  names = _write_dataset(tmp_path, n=2, size=(40, 56))
  rng = np.random.RandomState(7)
  for t in ('s0', 's1'):
    Image.fromarray((rng.rand(24, 32, 3) * 255).astype(np.uint8)).save(
        tmp_path / 'input' / f'{t}.png')
    os.makedirs(tmp_path / 'output' / t, exist_ok=True)
    for n in names:
      Image.fromarray((rng.rand(40, 56, 3) * 255).astype(np.uint8)).save(
          tmp_path / 'output' / t / n)
  (tmp_path / 'targets.txt').write_text('s0\ns1\n')
  pcfg, jcfg = _cfg(pipeline='StyleTransferDataPipeline')
  port = dd.load_st_dataset(port_pipeline.StyleTransferDataPipeline(
      str(tmp_path), pcfg), pcfg, 'cpu')
  want = jdd.load_st_dataset(jax_pipeline.StyleTransferDataPipeline(
      str(tmp_path), jcfg), jcfg)
  assert tuple(port.inputs.shape) == (4, 40, 56, 6)
  np.testing.assert_array_equal(port.inputs.numpy(), np.asarray(want.inputs))
  np.testing.assert_array_equal(port.outputs.numpy(),
                                np.asarray(want.outputs))


def _train_config(max_steps, **data):
  return Config(
      model=ModelConfig(model_name='HDRNetCurves', **SMALL),
      data=DataConfig(batch_size=2, output_resolution=[64, 64],
                      net_input_size=32, data_threads=1, device_data=True,
                      device_normalize=True, **data),
      train=TrainConfig(learning_rate=3e-3, max_steps=max_steps,
                        log_interval=9999, summary_interval=9999,
                        checkpoint_interval=9999, eval_interval=9999))


@pytest.fixture()
def dataset(tmp_path):
  """The brighten-by-1.3x PNG dataset of tests/test_train.py."""
  rng = np.random.RandomState(0)
  os.makedirs(tmp_path / 'input')
  os.makedirs(tmp_path / 'output')
  names = []
  for i in range(4):
    im = (rng.rand(80, 96, 3) * 255).astype(np.uint8)
    out = np.clip(im.astype(np.float32) * 1.3, 0, 255).astype(np.uint8)
    Image.fromarray(im).save(tmp_path / 'input' / f'im{i}.png')
    Image.fromarray(out).save(tmp_path / 'output' / f'im{i}.png')
    names.append(f'im{i}.png')
  (tmp_path / 'filelist.txt').write_text('\n'.join(names))
  return tmp_path


def test_train_device_route_converges_and_resumes(dataset, tmp_path):
  """tests/test_train.py's device-data gate on the port: the device
  route (train and eval), 30 steps, then a resume to 45 with a lower
  EMA loss."""
  ckpt = str(tmp_path / 'ckpt')
  state = loop.train(_train_config(30, fliplr=True, rotate=True), ckpt,
                     str(dataset), eval_data_dir=str(dataset), device='cpu')
  assert (state.step, state.data_route, state.eval_data_route) == (
      30, 'device', 'device')
  assert state.resident_bytes == 2 * 4 * 80 * 96 * 3
  loss_30 = float(state.ema_loss)
  assert np.isfinite(loss_30)
  state2 = loop.train(_train_config(45, fliplr=True, rotate=True), ckpt,
                      str(dataset), device='cpu')
  assert (state2.step, state2.data_route) == (45, 'device')
  assert float(state2.ema_loss) < loss_30


def test_train_gathers_the_jax_batches(dataset, tmp_path, monkeypatch):
  """The first three batches the port's loop gathers for a seed are the
  JAX loop's (its param_stream, gather and augment), bit for bit."""
  seen = []
  real = loop.augment_batch

  def spy(*args):
    seen.append(real(*args))
    return seen[-1]
  monkeypatch.setattr(loop, 'augment_batch', spy)
  kw = dict(fliplr=True, flipud=True, rotate=True, random_crop=True)
  cfg = _train_config(3, **kw)
  cfg.train.seed = 11
  loop.train(cfg, str(tmp_path / 'ckpt'), str(dataset), device='cpu')
  assert len(seen) >= 3

  _, jcfg = _cfg(batch_size=2, output_resolution=[64, 64],
                 net_input_size=32, device_normalize=True, device_data=True,
                 shuffle=True, **kw)
  jds = jdd.DeviceDataset(jdd.load_pairs(jax_pipeline.ImageFilesDataPipeline(
      str(dataset), jcfg)), jcfg)
  aug = jax.jit(jdd.make_device_augment([64, 64], 32, True))
  params = jds.param_stream(11, 2)
  for got in seen[:3]:
    want = jax_loop.augment_batch(aug, jds.inputs, jds.outputs, next(params))
    for k in want:
      np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                    err_msg=k)


def _hdrp_records(root):
  from hdrnet_torch.data.records import ShardWriter
  rng = np.random.RandomState(2)
  with ShardWriter(str(root)) as w:
    for _ in range(3):
      w.write({
          'image_input': (rng.rand(80, 96, 3) * 32767).astype(np.int16),
          'image_output': (rng.rand(80, 96, 3) * 255).astype(np.uint8)})


@pytest.mark.parametrize('case', ['hdrp', 'nonuniform'])
def test_train_falls_back_to_the_host_route(dataset, tmp_path, caplog,
                                            case):
  """No device loader (HDRp records), or a dataset that does not qualify
  (shapes differ): the host pipeline, with a warning, as in JAX."""
  if case == 'hdrp':
    data = tmp_path / 'rec'
    _hdrp_records(data)
    cfg = _train_config(2, pipeline='HDRpDataPipeline')
    cfg.data.device_normalize = False
    reason = 'HDRpDataPipeline has no device-resident loader'
  else:
    data = dataset
    Image.fromarray(np.zeros((70, 90, 3), np.uint8)).save(
        data / 'input' / 'odd.png')
    Image.fromarray(np.zeros((70, 90, 3), np.uint8)).save(
        data / 'output' / 'odd.png')
    with open(data / 'filelist.txt', 'a') as f:
      f.write('\nodd.png')
    cfg = _train_config(2)
    reason = 'uniform shapes'
  with caplog.at_level(logging.WARNING, logger='hdrnet_torch.train'):
    state = loop.train(cfg, str(tmp_path / 'ckpt'), str(data), device='cpu')
  assert (state.step, state.data_route) == (2, 'host')
  assert any(reason in r.getMessage() and 'host pipeline' in r.getMessage()
             for r in caplog.records), [r.getMessage() for r in caplog.records]
