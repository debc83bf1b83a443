"""The port's ('data', 'spatial') mesh (``hdrnet_torch.parallel.mesh``) in
one process: coordinates, the shares ``shard_batch`` takes, the refusals,
and a world of one, whose mesh step is the step with no process group.

The multi-process runs are in ``tests/test_torch_mesh_train.py``.
"""

import os
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from hdrnet_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from hdrnet_torch.models import make_model
from hdrnet_torch.parallel import mesh as pm
from hdrnet_torch.training import loop, step

SMALL = dict(net_input_size=32, spatial_bin=8, luma_bins=4,
             output_resolution=[64, 64])


def _mesh(shape, rank):
  """A Mesh without process groups: enough for its shares."""
  return pm.Mesh(shape=shape, rank=rank,
                 coords=pm.coordinates(rank, shape), data_group=None,
                 spatial_group=None, group=None, control=None,
                 world_control=None)


def _batch(b=4, h=64, w=48, s=32):
  rng = np.random.RandomState(0)
  return {'image_input': rng.rand(b, h, w, 3).astype(np.float32),
          'image_output': rng.rand(b, h, w, 3).astype(np.float32),
          'lowres_input': rng.rand(b, s, s, 3).astype(np.float32),
          'lowres_output': rng.rand(b, s, s, 3).astype(np.float32)}


def test_mesh_shapes_and_coordinates():
  assert [pm.coordinates(r, (4, 2)) for r in range(9)] == [
      (0, 0), (0, 1), (1, 0), (1, 1), (2, 0), (2, 1), (3, 0), (3, 1), None]
  assert [pm.coordinates(r, (1, 4)) for r in range(4)] == [
      (0, 0), (0, 1), (0, 2), (0, 3)]
  m = _mesh((4, 2), 5)
  assert (m.data, m.spatial, m.size, m.member, m.lead) == (4, 2, 8, True,
                                                           False)
  assert not _mesh((2, 1), 2).member and _mesh((2, 1), 0).lead
  # Without a process group: one process, no mesh.
  assert not dist.is_initialized()
  assert pm.make_mesh() is None and pm.make_mesh((1, 1)) is None


@pytest.mark.parametrize('shape', [(4, 1), (2, 2), (1, 4)])
def test_shard_batch_rows_and_bands(shape):
  batch = _batch()
  d, s = shape
  shares = {}
  for r in range(d * s):
    share, band = pm.shard_batch(_mesh(shape, r), batch)
    i, j = pm.coordinates(r, shape)
    rows = slice(i * 4 // d, (i + 1) * 4 // d)
    ys = slice(j * 64 // s, (j + 1) * 64 // s)
    assert band == (None if s == 1 else (ys.start, 64))
    for k in pm.FULLRES_KEYS:
      np.testing.assert_array_equal(share[k], batch[k][rows, ys])
    for k in ('lowres_input', 'lowres_output'):  # replicated on 'spatial'
      np.testing.assert_array_equal(share[k], batch[k][rows])
    shares[(i, j)] = share
  # The shares tile the batch.
  whole = np.concatenate([np.concatenate(
      [shares[(i, j)]['image_input'] for j in range(s)], 1)
                          for i in range(d)], 0)
  np.testing.assert_array_equal(whole, batch['image_input'])
  tensors = {k: torch.from_numpy(v) for k, v in batch.items()}
  share, _ = pm.shard_batch(_mesh(shape, d * s - 1), tensors)
  assert torch.equal(share['image_output'],
                     tensors['image_output'][-4 // d:, -64 // s:])
  assert pm.shard_batch(None, batch) == (batch, None)


def test_shares_refuse_what_does_not_divide():
  with pytest.raises(ValueError, match='batch_size 5 not divisible by '
                     'data-parallel degree 2'):
    pm.shard_batch(_mesh((2, 1), 0), _batch(b=5))
  with pytest.raises(ValueError, match='height 66 not divisible by spatial '
                     'mesh degree 4'):
    pm.shard_batch(_mesh((1, 4), 0), _batch(h=66))
  pm.check_band_rows(64, 4, 8)  # bands of 16 rows, padding 4
  with pytest.raises(ValueError, match='mirror padding of 32 rows'):
    pm.check_band_rows(64, 4, 1)


def test_mesh_larger_than_the_world_raises(tmp_path):
  with pytest.raises(ValueError, match='needs 4 processes; the world has 1'):
    pm.make_mesh((2, 2))
  cfg = Config(model=ModelConfig(**SMALL),
               data=DataConfig(batch_size=2, output_resolution=[64, 64],
                               net_input_size=32),
               train=TrainConfig(mesh_shape=[2, 1]))
  with pytest.raises(ValueError, match='needs 2 processes'):
    loop.train(cfg, str(tmp_path / 'ckpt'), str(tmp_path), device='cpu')


def test_initialize_distributed_refuses_without_its_environment(
    monkeypatch):
  for k in ('RANK', 'WORLD_SIZE', 'MASTER_ADDR', 'MASTER_PORT'):
    monkeypatch.delenv(k, raising=False)
  with pytest.raises(RuntimeError, match='torchrun'):
    pm.initialize_distributed()
  if torch.cuda.is_available():
    pytest.skip('CUDA is available here: the NCCL refusal cannot show')
  monkeypatch.setenv('RANK', '0')
  monkeypatch.setenv('WORLD_SIZE', '1')
  monkeypatch.setenv('MASTER_ADDR', 'localhost')
  monkeypatch.setenv('MASTER_PORT', '1')
  with pytest.raises(RuntimeError, match='NCCL needs CUDA'):
    pm.initialize_distributed('nccl')
  assert not dist.is_initialized()


@pytest.fixture()
def world_of_one(monkeypatch):
  """A gloo process group of one rank in this process, destroyed after."""
  with socket.socket() as s:
    s.bind(('localhost', 0))
    port = s.getsockname()[1]
  for k, v in dict(RANK='0', LOCAL_RANK='0', WORLD_SIZE='1',
                   MASTER_ADDR='localhost', MASTER_PORT=str(port)).items():
    monkeypatch.setenv(k, v)
  assert pm.initialize_distributed('gloo').type in ('cpu', 'cuda')
  assert pm.initialize_distributed('gloo') is not None  # a no-op
  try:
    yield
  finally:
    dist.destroy_process_group()


@pytest.mark.parametrize('name,bn', [('HDRNetCurves', False),
                                     ('HDRNetPointwiseNNGuide', True)])
def test_world_of_one_step_matches_no_group(world_of_one, name, bn):
  """The mesh path at (1, 1) (every collective over one rank, as under
  torchrun with one process) is the step with no process group."""
  cfg = ModelConfig(model_name=name, batch_norm=bn, guide_complexity=4,
                    **SMALL)
  tc = TrainConfig(learning_rate=1e-4, guide_reg=0.5)
  batch = {k: torch.from_numpy(v) for k, v in _batch(w=64).items()}
  results = []
  for mesh in (None, pm.make_mesh((1, 1))):
    model = make_model(cfg, generator=torch.Generator().manual_seed(2))
    pm.replicate(model, mesh)
    st = step.create_state(model, loop.make_optimizer(model, tc))
    share, band = pm.shard_batch(mesh, batch)
    assert band is None
    st, m = step.make_train_step(guide_reg=tc.guide_reg, mesh=mesh)(
        st, share, band)
    results.append((model.state_dict(), m))
  (want, want_m), (got, got_m) = results
  for k in ('loss', 'psnr', 'ema_loss'):
    np.testing.assert_allclose(float(got_m[k]), float(want_m[k]),
                               rtol=1e-5, atol=1e-6, err_msg=k)
  for k, v in want.items():
    np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-4,
                               atol=1e-5, err_msg=k)
