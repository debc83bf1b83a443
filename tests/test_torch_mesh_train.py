"""Mesh training of the port, over gloo processes on the CPU.

Four ranks (``tests/torch_mesh_worker.py``, started as subprocesses that
join one gloo group on localhost, with JAX refused in each) run every job
once; the tests read what each rank ended with:

  * one train step at (4, 1), (2, 2) and (1, 4), curves (and the guide
    regularizer at (2, 2)), and of the pyramid and UNet with batch norm
    on the 'data' axis (in float64, as below), against the one-process
    port step on the same global batch: loss to 1e-6, parameters to 1e-5
    (the JAX multichip gate's tolerances, ``__graft_entry__.py``), and
    the gradients the step took, summed over the mesh, to ``GRAD_REL`` of
    each leaf's max;
  * one step of each of the other 15 models of the registry on a
    'spatial' axis, (2, 2) or (1, 4), with batch norm, in float64, on
    72-row frames (the pyramids' third level, 18 rows, cut 4, 5, 4, 5),
    against the one-process step at the same tolerances: the halo
    exchanges of the resizes and k x k convs (``parallel.halo``; the
    dilated baseline's 32-row halos reach two bands away), each level's
    band through the slice-apply, the stack's frame-wide preview;
  * the exchange and the frame-wide row gather on their own: the rows,
    bit for bit, and the cotangents summed at their owners;
  * one step of the NN guide and of the pyramid with batch norm at (2, 2)
    against the JAX one-device step (``make_train_step``, the weights
    through the converter), in float64: in float32 a batch norm over a
    handful of samples leaves the two packages ~7e-4 of a leaf's max
    gradient apart even in one process (``test_torch_bn_step_f64.py``);
  * ``train()`` over PNGs at (2, 2) against (4, 1), curves and the
    pyramid (the JAX test's tolerances, ``tests/test_parallel.py``), and a
    checkpoint written at (2, 2) resumed at (4, 1);
  * every rank of every job ends bit-identical to rank 0;
  * the refusals of a layout that does not fit, raised on every rank.

A world of three with a batch of four trains on two ranks, the third
sitting out. Each wait on a worker has its own timeout, so that a hang
fails the test instead of stalling the suite.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
from PIL import Image

from hdrnet_tpu.config import ModelConfig as JaxModelConfig
from hdrnet_tpu.config import TrainConfig as JaxTrainConfig
from hdrnet_tpu.models import make_model as jax_make_model
from hdrnet_tpu.training import step as jax_step
from hdrnet_tpu.training.loop import make_tx

from hdrnet_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from hdrnet_torch.convert import convert_flax_variables
from hdrnet_torch.models import make_model
from hdrnet_torch.training import loop, step

REPO = pathlib.Path(__file__).resolve().parents[1]
WORKER = REPO / 'tests' / 'torch_mesh_worker.py'
TIMEOUT_S = 240
SMALL = dict(net_input_size=32, spatial_bin=8, luma_bins=4,
             output_resolution=[64, 64])
LR = 1e-4
STEP_MESHES = {'curves_4x1': (4, 1), 'curves_2x2': (2, 2),
               'curves_1x4': (1, 4), 'curves_reg_2x2': (2, 2)}
# Models of the zoo on the 'data' axis, batch norm on, in float64 (as the
# NN guide's job, below): (model name, extra config).
DATA_AXIS_MODELS = {
    'pyramid_4x1': ('HDRNetGaussianPyrNN', dict(guide_complexity=4)),
    'unet_4x1': ('UNet', dict(depth=2, width=4)),
}
# Every model but the two of STEP_MESHES on a 'spatial' axis, batch norm
# on, in float64: {model name: (layout, extra config)}. The guide
# regularizer where the levels' bands are uneven, its target 0.5 (above
# any sigmoid guide's std, so that every image's hinge is active); UNet
# at depth 4 (two
# stride-2 levels, 72 -> 36 -> 18 rows); the dilated baseline at depth 6
# (rates 1 .. 32).
GC4 = dict(guide_complexity=4)
SPATIAL_MODELS = {
    'HDRNetGaussianPyrNN': ((1, 4), dict(GC4, guide_reg=0.5)),
    'HDRNetGaussianPyr': ((2, 2), {}),
    'HDRNet3x3NNGuide': ((1, 4), GC4),
    'HDRNetStack': ((2, 2), GC4),
    'HDRNetFullresFeatures': ((1, 4), GC4),
    'HDRNetFullresFeaturesMultiscale': ((1, 4), GC4),
    'HDRNetFullresFeaturesWithGuide': ((2, 2), GC4),
    'HDRNetFeaturesPyrNN': ((1, 4), dict(GC4, guide_reg=0.5)),
    'HDRNetFeaturesPyrNN2': ((2, 2), GC4),
    'HDRNetFeaturesPyrNN3': ((1, 4), dict(GC4, channel_multiplier=2)),
    'HDRNetFeaturesPyrSimpleGuideNN': ((1, 4), {}),
    'StyleTransferNN': ((2, 2), dict(GC4, n_in=6)),
    'StyleTransferCurves': ((1, 4), dict(n_in=6)),
    'UNet': ((1, 4), dict(depth=4, width=4)),
    'DilatedConvolutions': ((1, 4), dict(depth=6, width=4)),
}
SPATIAL_HW = (72, 64)
# A mesh step's gradients (summed over the mesh) against the one-process
# step's, of each leaf's max |g|: measured at most 4.4e-07 (float32, the
# curves jobs) and 1.6e-12 (float64).
GRAD_REL = {torch.float32: 1e-5, torch.float64: 1e-8}
# The exchange and the gather alone at (1, 4): (rows, reach, gathered
# rows); a reach of 9 takes rows of bands two away, 0 runs no exchange.
HALO_CASES = [(18, 1, [0, 2, 5, 7, 10, 12, 15]), (30, 9, [29, 3, 3, 17]),
              (13, 0, [12, 0, 5, 5])]


def _free_port():
  with socket.socket() as s:
    s.bind(('localhost', 0))
    return s.getsockname()[1]


def _launch(work, world, jobs):
  """Runs `jobs` on `world` worker ranks; fails on a timeout or a rank's
  nonzero exit, with the ranks' output."""
  (work / 'jobs.json').write_text(json.dumps(jobs))
  env = dict(os.environ)
  env['PYTHONPATH'] = str(REPO) + os.pathsep + env.get('PYTHONPATH', '')
  port = str(_free_port())
  procs = [subprocess.Popen([sys.executable, str(WORKER), str(r),
                             str(world), port, str(work)], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True) for r in range(world)]
  outs = []
  try:
    for p in procs:
      outs.append(p.communicate(timeout=TIMEOUT_S)[0])
  except subprocess.TimeoutExpired:
    for p in procs:
      p.kill()
    pytest.fail('mesh workers timed out:\n' + '\n'.join(outs))
  for r, (p, out) in enumerate(zip(procs, outs)):
    assert p.returncode == 0, f'rank {r} failed:\n{out}'


def _results(work, name, world):
  return [torch.load(work / f'{name}.rank{r}.pt', weights_only=True)
          for r in range(world)]


def _batch(seed, b=4, s=32, hw=64, dtype=np.float32):
  rng = np.random.RandomState(seed)
  full = rng.rand(b, hw, hw, 3).astype(dtype)
  low = np.ascontiguousarray(full[:, ::hw // s, ::hw // s])
  target = np.clip(full * 1.3, 0.0, 1.0).astype(dtype)
  return {'lowres_input': low, 'lowres_output': low, 'image_input': full,
          'image_output': target}


def _spatial_batch(seed, n_in, b=4, s=32, hw=SPATIAL_HW):
  rng = np.random.RandomState(seed)
  full = rng.rand(b, *hw, n_in)
  low = rng.rand(b, s, s, n_in)
  target = np.clip(full[..., :3] * 1.3, 0.0, 1.0)
  return {'lowres_input': low, 'lowres_output': low[..., :3],
          'image_input': full, 'image_output': target}


def _stash_grads():
  """Passes the gradients on and keeps them as its state."""
  return optax.GradientTransformation(
      lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
      lambda updates, state, params=None: (updates, updates))


def _one_process_step(model_cfg, train_cfg, state_dict, batch):
  """The port's one-process step (no process group) on the global batch,
  in the batch's float type: (state dict, metrics, the gradients the
  optimizer stepped with)."""
  dtype = torch.from_numpy(batch['image_input']).dtype
  model = make_model(model_cfg).to(dtype)
  model.load_state_dict(state_dict)
  st = step.create_state(model, loop.make_optimizer(model, train_cfg))
  st, m = step.make_train_step(
      guide_reg=train_cfg.guide_reg,
      guide_reg_target=train_cfg.guide_reg_target)(
          st, {k: torch.from_numpy(v) for k, v in batch.items()})
  return (model.state_dict(), {k: float(v) for k, v in m.items()},
          {k: p.grad for k, p in model.named_parameters()})


def _jax_bn_step(cfg_kw, batch):
  """The JAX one-device step of a model with batch norm, in float64, from
  a Flax init: (initial variables, params, batch_stats, metrics),
  numpy."""
  cfg = JaxModelConfig(**cfg_kw)
  model = jax_make_model(cfg)
  with jax.enable_x64(True):
    f64 = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda a: jnp.asarray(np.asarray(a, np.float32), jnp.float64), t)
    variables = model.init(jax.random.PRNGKey(3),
                           jnp.asarray(batch['lowres_input'], jnp.float32),
                           jnp.asarray(batch['image_input'], jnp.float32),
                           train=True)
    variables = f64(dict(variables))
    tx = optax.chain(_stash_grads(), make_tx(JaxTrainConfig(
        learning_rate=LR)))
    jstate = jax_step.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables['params'],
        opt_state=tx.init(variables['params']),
        batch_stats=variables['batch_stats'],
        ema_loss=jnp.zeros((), jnp.float64),
        ema_psnr=jnp.zeros((), jnp.float64))
    jstate, jm = jax.jit(jax_step.make_train_step(model, tx))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return (to_np(variables), to_np(jstate.params),
            to_np(jstate.batch_stats), {k: float(v) for k, v in jm.items()})


def _state_dict64(variables):
  """The converter's state dict (float32 values) in float64."""
  return {k: v.double() for k, v in convert_flax_variables(variables).items()}


def _write_pngs(root, n=8):
  rng = np.random.RandomState(0)
  os.makedirs(root / 'input')
  os.makedirs(root / 'output')
  names = []
  for i in range(n):
    im = (rng.rand(80, 96, 3) * 255).astype(np.uint8)
    out = np.clip(im.astype(np.float32) * 1.2, 0, 255).astype(np.uint8)
    Image.fromarray(im).save(root / 'input' / f'im{i}.png')
    Image.fromarray(out).save(root / 'output' / f'im{i}.png')
    names.append(f'im{i}.png')
  (root / 'filelist.txt').write_text('\n'.join(names))


def _train_config(mesh_shape, max_steps, batch_size=4, height=64, **model):
  resolution = [height, 64]
  return Config(
      model=ModelConfig(**{'model_name': 'HDRNetCurves', **SMALL,
                           'output_resolution': resolution, **model}),
      data=DataConfig(batch_size=batch_size, output_resolution=resolution,
                      net_input_size=32, data_threads=1),
      train=TrainConfig(learning_rate=3e-3, max_steps=max_steps,
                        mesh_shape=mesh_shape, log_interval=9999,
                        summary_interval=9999, checkpoint_interval=9999))


def _train_job(name, ckpt, data, cfg):
  return {'kind': 'train', 'name': name, 'ckpt': ckpt, 'data': str(data),
          'config': json.loads(cfg.to_json())}


# Layouts the loop must refuse on every rank of a world of four, each
# with the words its reason must hold.
REFUSALS = {
    'batch': (_train_config([4, 1], 1, batch_size=6), 'not divisible by '
              'data-parallel degree 4'),
    'height': (_train_config([1, 4], 1, height=66),
               'not divisible by spatial mesh degree 4'),
    # A 1x1 grid: half a cell is 32 rows, the bands 16.
    'band': (_train_config([1, 4], 1, spatial_bin=1), 'mirror padding'),
    # 72 rows, a 2-row grid: the pyramid's third level (18 rows) cut in
    # bands of 4 or 5, under its 5-row mirror padding.
    'level': (_train_config([1, 4], 1, height=72, spatial_bin=2,
                            model_name='HDRNetGaussianPyrNN',
                            guide_complexity=4),
              "pyramid level 2's 18 rows into bands of 4"),
}
PYR_TRAIN = dict(model_name='HDRNetGaussianPyrNN', guide_complexity=4)


@pytest.fixture(scope='module')
def world4(tmp_path_factory):
  """Runs every job of a world of four once: (work dir, the one-process
  and JAX references)."""
  work = tmp_path_factory.mktemp('mesh4')
  data = work / 'data'
  _write_pngs(data)
  jobs, refs = [], {}

  batch = _batch(1)
  cfg = ModelConfig(model_name='HDRNetCurves', **SMALL)
  weights = make_model(cfg, generator=torch.Generator().manual_seed(5))
  for name, mesh_shape in STEP_MESHES.items():
    reg = 0.5 if 'reg' in name else 0.0
    tc = TrainConfig(learning_rate=LR, guide_reg=reg)
    torch.save({'state_dict': weights.state_dict(),
                'batch': {k: torch.from_numpy(v) for k, v in batch.items()}},
               work / f'{name}.in.pt')
    jobs.append({'kind': 'step', 'name': name, 'mesh_shape': mesh_shape,
                 'model': dict(model_name='HDRNetCurves', **SMALL),
                 'train': {'learning_rate': LR, 'guide_reg': reg}})
    refs[name] = _one_process_step(cfg, tc, weights.state_dict(), batch)

  batch64 = _batch(3, dtype=np.float64)
  for name, (model_name, extra) in DATA_AXIS_MODELS.items():
    kw = dict(model_name=model_name, batch_norm=True, **extra, **SMALL)
    cfg = ModelConfig(**kw)
    weights = make_model(cfg, generator=torch.Generator().manual_seed(6))
    sd64 = {k: v.double() for k, v in weights.state_dict().items()}
    torch.save({'state_dict': sd64,
                'batch': {k: torch.from_numpy(v) for k, v in
                          batch64.items()}}, work / f'{name}.in.pt')
    jobs.append({'kind': 'step', 'name': name, 'mesh_shape': (4, 1),
                 'model': kw, 'train': {'learning_rate': LR}})
    refs[name] = _one_process_step(cfg, TrainConfig(learning_rate=LR), sd64,
                                   batch64)

  for i, (name, (mesh_shape, extra)) in enumerate(SPATIAL_MODELS.items()):
    extra = dict(extra)
    reg = extra.pop('guide_reg', 0.0)
    train = {'learning_rate': LR, 'guide_reg': reg,
             'guide_reg_target': 0.5}
    kw = dict(SMALL, model_name=name, batch_norm=True,
              output_resolution=list(SPATIAL_HW), **extra)
    cfg = ModelConfig(**kw)
    weights = make_model(cfg, generator=torch.Generator().manual_seed(i))
    sd64 = {k: v.double() for k, v in weights.state_dict().items()}
    batch64 = _spatial_batch(10 + i, cfg.n_in)
    torch.save({'state_dict': sd64,
                'batch': {k: torch.from_numpy(v) for k, v in
                          batch64.items()}}, work / f'{name}.in.pt')
    jobs.append({'kind': 'step', 'name': name, 'mesh_shape': mesh_shape,
                 'model': kw, 'train': train})
    refs[name] = _one_process_step(cfg, TrainConfig(**train), sd64, batch64)

  jobs.append({'kind': 'halo', 'name': 'halo', 'mesh_shape': (1, 4),
               'cases': HALO_CASES})

  for name, model_name in (('nn_bn_2x2', 'HDRNetPointwiseNNGuide'),
                           ('pyr_bn_2x2', 'HDRNetGaussianPyrNN')):
    kw = dict(model_name=model_name, batch_norm=True, guide_complexity=4,
              **SMALL)
    batch64 = _batch(2, dtype=np.float64)
    variables, params, stats, jm = _jax_bn_step(kw, batch64)
    torch.save({'state_dict': _state_dict64(variables),
                'batch': {k: torch.from_numpy(v) for k, v in
                          batch64.items()}}, work / f'{name}.in.pt')
    jobs.append({'kind': 'step', 'name': name, 'mesh_shape': (2, 2),
                 'model': kw, 'train': {'learning_rate': LR}})
    refs[name] = (params, stats, jm)

  jobs += [
      _train_job('train_4x1', 'ckpt_a', data, _train_config([4, 1], 3)),
      _train_job('train_2x2', 'ckpt_b', data, _train_config([2, 2], 3)),
      _train_job('train_pyr_4x1', 'ckpt_pyr_a', data,
                 _train_config([4, 1], 3, **PYR_TRAIN)),
      _train_job('train_pyr_2x2', 'ckpt_pyr_b', data,
                 _train_config([2, 2], 3, **PYR_TRAIN)),
      # Each directory's step-3 checkpoint resumed at (4, 1) to step 5.
      _train_job('resume_a', 'ckpt_a', data, _train_config([4, 1], 5)),
      _train_job('resume_b', 'ckpt_b', data, _train_config([4, 1], 5)),
  ]
  jobs += [{'kind': 'refuse', 'name': f'refuse_{k}',
            'config': json.loads(cfg.to_json()), 'data': str(data),
            'ckpt': f'ckpt_refuse_{k}'} for k, (cfg, _) in REFUSALS.items()]
  _launch(work, 4, jobs)
  return work, refs


def _assert_ranks_identical(results, what):
  want = results[0]['state_dict']
  for r, res in enumerate(results[1:], 1):
    for k, v in res['state_dict'].items():
      assert torch.equal(v, want[k]), f'{what}: rank {r} differs at {k}'


@pytest.mark.parametrize('name', sorted(STEP_MESHES) + sorted(
    DATA_AXIS_MODELS) + sorted(SPATIAL_MODELS))
def test_step_on_mesh_matches_one_process(world4, name):
  work, refs = world4
  want_sd, want_m, want_g = refs[name]
  results = _results(work, name, 4)
  _assert_ranks_identical(results, name)
  got = results[0]
  for k in ('loss', 'psnr', 'ema_loss', 'ema_psnr'):
    np.testing.assert_allclose(got['metrics'][k], want_m[k], rtol=1e-5,
                               atol=1e-6, err_msg=k)
  assert got['metrics']['loss'] == results[-1]['metrics']['loss']
  for k, v in want_sd.items():
    np.testing.assert_allclose(got['state_dict'][k].numpy(), v.numpy(),
                               rtol=1e-4, atol=1e-5, err_msg=k)
  # A first Adam step moves each parameter by about lr * sign(g), so the
  # parameters alone would not see a wrong gradient's magnitude: the
  # gradients it stepped with are held too.
  assert got['grads'].keys() == want_g.keys()
  for k, v in want_g.items():
    rel = GRAD_REL[v.dtype]
    err = float((got['grads'][k] - v).abs().max())
    assert err <= rel * float(v.abs().max()), (k, err, rel)


@pytest.mark.parametrize('name', sorted(STEP_MESHES))
def test_mesh_coordinates_groups_and_bands(world4, name):
  """Rank r of a (d, s) mesh sits at (r // s, r % s); its data group holds
  the ranks of its spatial coordinate, its spatial group those of its
  data coordinate; its band is its quarter, half or all of the rows."""
  work, _ = world4
  d, s = STEP_MESHES[name]
  for r, res in enumerate(_results(work, name, 4)):
    i, j = res['coords']
    assert (i, j) == divmod(r, s)
    assert res['groups'] == [[k * s + j for k in range(d)],
                             [i * s + k for k in range(s)], [0, 1, 2, 3]]
    assert res['band'] == (None if s == 1 else (j * 64 // s, 64))


def _hold_bn_step_to_jax(world4, name, guide_bn):
  """The (2, 2) step `name` against the JAX one-device step: metrics at
  1e-5 / 1e-6, parameters at 1e-4 / 1e-5, running statistics at 1e-5;
  `guide_bn` a guide's batch norm that must be among them."""
  work, refs = world4
  params, stats, jm = refs[name]
  results = _results(work, name, 4)
  _assert_ranks_identical(results, name)
  got = results[0]
  for k in ('loss', 'psnr'):
    np.testing.assert_allclose(got['metrics'][k], jm[k], rtol=1e-5,
                               atol=1e-6, err_msg=k)
  want = convert_flax_variables({'params': params, 'batch_stats': stats})
  assert any('running_mean' in k for k in want)
  # Both guide BN (over the whole mesh) and backbone BN (over 'data').
  assert guide_bn in want
  for k, v in want.items():
    tol = ({'rtol': 0, 'atol': 1e-5} if 'running' in k
           else {'rtol': 1e-4, 'atol': 1e-5})
    np.testing.assert_allclose(got['state_dict'][k].numpy(), v.numpy(),
                               err_msg=k, **tol)


def test_nn_guide_bn_step_on_mesh_matches_jax(world4):
  _hold_bn_step_to_jax(world4, 'nn_bn_2x2', 'guide.conv1.bn.running_var')


def test_pyramid_bn_step_on_mesh_matches_jax(world4):
  """The pyramid's levels' halos exchanged, each level's band through the
  slice-apply, its guides' batch norms over the whole mesh."""
  _hold_bn_step_to_jax(world4, 'pyr_bn_2x2',
                       'guide_level_2.conv1.bn.running_var')


def test_train_on_spatial_mesh_matches_data_mesh(world4):
  work, _ = world4
  dp, sp = _results(work, 'train_4x1', 4), _results(work, 'train_2x2', 4)
  _assert_ranks_identical(dp, 'train_4x1')
  _assert_ranks_identical(sp, 'train_2x2')
  assert dp[0]['step'] == sp[0]['step'] == 3
  for k, v in dp[0]['state_dict'].items():
    np.testing.assert_allclose(sp[0]['state_dict'][k].numpy(), v.numpy(),
                               rtol=1e-3, atol=2e-4, err_msg=k)
  np.testing.assert_allclose(sp[0]['ema_loss'], dp[0]['ema_loss'],
                             rtol=1e-5)
  # Rank 0 alone wrote the directory, and left no partial file.
  assert sorted(os.listdir(work / 'ckpt_b')) == [
      'ckpt_3.pt', 'ckpt_5.pt', 'config.json', 'summaries.jsonl']


def test_pyramid_train_on_spatial_mesh_matches_data_mesh(world4):
  work, _ = world4
  dp = _results(work, 'train_pyr_4x1', 4)
  sp = _results(work, 'train_pyr_2x2', 4)
  _assert_ranks_identical(sp, 'train_pyr_2x2')
  assert dp[0]['step'] == sp[0]['step'] == 3
  for k, v in dp[0]['state_dict'].items():
    np.testing.assert_allclose(sp[0]['state_dict'][k].numpy(), v.numpy(),
                               rtol=1e-3, atol=2e-4, err_msg=k)
  np.testing.assert_allclose(sp[0]['ema_loss'], dp[0]['ema_loss'],
                             rtol=1e-5)


def _halo_frame(n, seed):
  """The worker's seeded frame of a halo case (``halo_frame``)."""
  return torch.from_numpy(np.random.RandomState(seed).randn(2, n, 3))


def _halo_cotangent(shape, rank, seed):
  """The worker's seeded cotangent (``halo_cotangent``)."""
  return torch.from_numpy(np.random.RandomState(1000 * seed + rank).randn(
      *shape))


@pytest.mark.parametrize('case', range(len(HALO_CASES)))
def test_halo_exchange_and_gather_across_ranks(world4, case):
  """Each rank's exchanged rows are the frame's rows bit for bit (from
  bands two away where the reach asks), and its gradient is the sum of
  every rank's cotangents of its own rows; every rank gathers the same
  rows of the frame, and takes the summed cotangents of its own."""
  work, _ = world4
  n, reach, rows = HALO_CASES[case]
  frame = _halo_frame(n, case)
  results = [r['cases'][case] for r in _results(work, 'halo', 4)]
  bounds = [r['band'] for r in results]
  assert bounds == [(j * n // 4, (j + 1) * n // 4) for j in range(4)]
  needs = [(max(lo - reach, 0), min(hi + reach, n)) for lo, hi in bounds]
  grad = torch.zeros_like(frame)
  total = 0
  for q, (a, b) in enumerate(needs):
    grad[:, a:b] += _halo_cotangent((2, b - a, 3), q, case)
    total = total + _halo_cotangent((2, len(rows), 3), q, case + 100)
  gather_grad = torch.zeros_like(frame)
  for p, row in enumerate(rows):
    gather_grad[:, row] += total[:, p]
  for r, (res, (lo, hi), (a, b)) in enumerate(zip(results, bounds, needs)):
    assert torch.equal(res['exchanged'], frame[:, a:b]), r
    assert torch.equal(res['gathered'], frame[:, rows]), r
    np.testing.assert_allclose(res['exchange_grad'].numpy(),
                               grad[:, lo:hi].numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(res['gather_grad'].numpy(),
                               gather_grad[:, lo:hi].numpy(), rtol=0,
                               atol=1e-12)


def test_checkpoint_from_spatial_mesh_resumes_on_data_mesh(world4):
  work, _ = world4
  a, b = _results(work, 'resume_a', 4), _results(work, 'resume_b', 4)
  _assert_ranks_identical(b, 'resume_b')
  assert a[0]['step'] == b[0]['step'] == 5
  for k, v in a[0]['state_dict'].items():
    np.testing.assert_allclose(b[0]['state_dict'][k].numpy(), v.numpy(),
                               rtol=1e-3, atol=2e-4, err_msg=k)
  # Adam's count went on from the checkpoint's 3 steps.
  counts = {int(s['step']) for s in b[0]['optimizer']['state'].values()}
  assert counts == {5}, counts


@pytest.mark.parametrize('what', sorted(REFUSALS))
def test_mesh_refusals_raise_on_every_rank(world4, what):
  work, _ = world4
  words = REFUSALS[what][1]
  for r, res in enumerate(_results(work, f'refuse_{what}', 4)):
    assert res['error'] == 'ValueError', (r, res)
    assert words in res['message'], (r, res)


def test_rank_past_the_mesh_sits_out(tmp_path):
  """World 3, batch 4: the default mesh is (2, 1); rank 2 sits out and
  returns the run's last checkpoint."""
  data = tmp_path / 'data'
  _write_pngs(data, n=4)
  cfg = _train_config(None, 2)
  _launch(tmp_path, 3, [_train_job('sit_out', 'ckpt', data, cfg)])
  results = _results(tmp_path, 'sit_out', 3)
  assert [r['step'] for r in results] == [2, 2, 2]
  _assert_ranks_identical(results, 'sit_out')
  assert results[2]['ema_loss'] == results[0]['ema_loss']
