"""Training with the port vs the JAX package on the CPU.

Flax ``init`` -> ``convert_flax_variables`` -> the port's module, then
the same numpy-seeded batch through the JAX train step and the port's.
Tolerances: loss and psnr 1e-5 relative; each parameter's gradient
1e-4 of that leaf's largest |g| (float32 sums in another order, the
guide's depth coordinate amplifying them about gd-fold); parameters after
one Adam step within 1e-2 * lr where the gradient is not negligible
(Adam's first step moves every such parameter by about lr, so this reads
the step's direction and size, not the rounding of near-zero moments).
Batch-norm statistics 1e-6; the guide's gradients 1e-6, in float64 so
that only the gradient rules at exact ties can differ.
"""

import copy
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
from PIL import Image

from hdrnet_tpu.config import Config, DataConfig, ModelConfig, TrainConfig
from hdrnet_tpu.models import make_model as jax_make_model
from hdrnet_tpu.models.guides import CurveGuide as JaxCurveGuide
from hdrnet_tpu.training import step as jax_step
from hdrnet_tpu.training.loop import _make_schedule, make_tx

from hdrnet_torch.convert import convert_flax_variables
from hdrnet_torch.inference import Enhancer
from hdrnet_torch.models import make_model
from hdrnet_torch.models.guides import CurveGuide
from hdrnet_torch.ops import _build
from hdrnet_torch.ops.downsample import nearest_lowres_plain
from hdrnet_torch.training import loop, step

SMALL = dict(net_input_size=32, spatial_bin=8, luma_bins=4,
             output_resolution=[64, 64])


def _batch(seed, b=2, s=32, hw=64):
  rng = np.random.RandomState(seed)
  full = rng.randint(0, 256, (b, hw, hw, 3)).astype(np.uint8)
  low = full[:, ::hw // s, ::hw // s]
  target = np.clip(full.astype(np.float32) * 1.3, 0, 255).astype(np.uint8)
  return {'lowres_input': np.ascontiguousarray(low),
          'lowres_output': np.ascontiguousarray(target[:, ::hw // s,
                                                       ::hw // s]),
          'image_input': full, 'image_output': target}


def _flax_init(cfg, batch, seed=0):
  low = jnp.asarray(batch['lowres_input'], jnp.float32) / 255
  full = jnp.asarray(batch['image_input'], jnp.float32) / 255
  model = jax_make_model(cfg)
  variables = model.init(jax.random.PRNGKey(seed), low, full, train=True)
  return model, jax.tree_util.tree_map(np.asarray, dict(variables))


def _port_model(cfg, variables):
  port = make_model(cfg)
  port.load_state_dict(convert_flax_variables(variables))
  return port


def test_batch_norm_train_mode_matches_flax():
  """R1: train-mode BN normalizes with the biased batch variance and
  moves the running stats as 0.999 * running + 0.001 * batch."""
  cfg = ModelConfig(batch_norm=True, **SMALL)
  batch = _batch(0)
  model, variables = _flax_init(cfg, batch)
  low = batch['lowres_input'].astype(np.float32) / 255
  full = batch['image_input'].astype(np.float32) / 255
  want, updates = model.apply(variables, jnp.asarray(low), jnp.asarray(full),
                              train=True, mutable=['batch_stats'])
  port = _port_model(cfg, variables).train()
  with torch.no_grad():
    got = port(torch.from_numpy(low), torch.from_numpy(full))
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
  want_stats = convert_flax_variables(
      {'params': {}, 'batch_stats': updates['batch_stats']})
  state = port.state_dict()
  assert want_stats and all(k in state for k in want_stats)
  for k, v in want_stats.items():
    np.testing.assert_allclose(state[k].numpy(), v.numpy(), atol=1e-6,
                               err_msg=k)


@pytest.mark.parametrize('exact_identity', [False, True])
def test_curve_guide_gradients_match_flax_at_ties(exact_identity):
  """R2: black pixels put the first knot's ReLU and the final clip on
  exact ties at 0 (with the seeded init); with an exact identity color
  matrix white pixels put the clip on a tie at 1. JAX's rules: relu' = 0
  at 0, clip' = 0.5 at 0 and 1."""
  rng = np.random.RandomState(7)
  img = rng.rand(2, 9, 11, 3)
  img[0, :3] = 0.0
  img[1, :2] = 1.0
  jax_guide = JaxCurveGuide()
  variables = jax_guide.init(jax.random.PRNGKey(1),
                             jnp.asarray(img, jnp.float32))
  params = jax.tree_util.tree_map(lambda a: np.array(a, np.float64),
                                  dict(variables['params']))
  if exact_identity:
    params['ccm'] = np.eye(3)
  probe = rng.randn(2, 9, 11)

  # In float64, so that only the rules at the ties can differ.
  with jax.enable_x64(True):
    def loss(p, x):
      return jnp.vdot(jax_guide.apply({'params': p}, x), probe)
    want_p, want_x = jax.grad(loss, argnums=(0, 1))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(img))
    want_p = jax.tree_util.tree_map(np.asarray, want_p)
    want_x = np.asarray(want_x)

  port = CurveGuide().double()
  port.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
  x = torch.from_numpy(img).requires_grad_()
  (port(x) * torch.from_numpy(probe)).sum().backward()
  for name, p in port.named_parameters():
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_p[name]),
                               atol=1e-6, err_msg=name)
  np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_x), atol=1e-6)


def _stash_grads():
  """An optax transform that passes the gradients on and keeps them as
  its state, so a JAX step reports the gradients it applied."""
  return optax.GradientTransformation(
      lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
      lambda updates, state, params=None: (updates, updates))


@pytest.mark.parametrize('guide_reg,guide_lr_scale', [
    (0.0, 1.0), (0.5, 1.0), (0.0, 0.1)])
def test_one_train_step_matches_jax(guide_reg, guide_lr_scale):
  lr = 1e-3
  cfg = ModelConfig(model_name='HDRNetCurves', **SMALL)
  tc = TrainConfig(learning_rate=lr, guide_lr_scale=guide_lr_scale)
  batch = _batch(1)
  model, variables = _flax_init(cfg, batch)

  tx = optax.chain(_stash_grads(), make_tx(tc))
  jstate = jax_step.TrainState(
      step=jnp.zeros((), jnp.int32), params=variables['params'],
      opt_state=tx.init(variables['params']), batch_stats={},
      ema_loss=jnp.zeros(()), ema_psnr=jnp.zeros(()))
  jstep = jax.jit(jax_step.make_train_step(model, tx, guide_reg=guide_reg))
  jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
  want_grads = convert_flax_variables({'params': jstate.opt_state[0]})
  want_params = convert_flax_variables({'params': jstate.params})

  port = _port_model(cfg, variables)
  state = step.create_state(port, loop.make_optimizer(port, tc))
  state, m = step.make_train_step(guide_reg=guide_reg)(
      state, step.to_device(batch, 'cpu'))

  for k in ('loss', 'psnr', 'ema_loss', 'ema_psnr'):
    np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                               err_msg=k)
  assert state.step == 1
  for name, p in port.named_parameters():
    g_want = want_grads[name].numpy()
    g_scale = float(np.abs(g_want).max())
    np.testing.assert_allclose(p.grad.numpy(), g_want, rtol=0,
                               atol=1e-4 * g_scale, err_msg=name)
    moved = np.abs(g_want) > 1e-5 * g_scale
    np.testing.assert_allclose(p.detach().numpy()[moved],
                               want_params[name].numpy()[moved], rtol=0,
                               atol=1e-2 * lr, err_msg=name)


@pytest.mark.parametrize('kw', [
    dict(lr_schedule='cosine', lr_decay_steps=20, lr_end=1e-5),
    dict(lr_schedule='cosine', max_steps=25, lr_end=0.0),
    dict(lr_schedule='cosine', lr_decay_steps=24, lr_end=2e-5,
         lr_warmup_steps=6),
])
def test_schedules_match_optax(kw):
  tc = TrainConfig(learning_rate=3e-4, **kw)
  want, got = _make_schedule(tc), loop.make_schedule(tc)
  for count in range(31):
    # optax computes in float32: near the end of a cosine the value is a
    # difference of nearly equal numbers, so compare against the peak.
    np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-6,
                               atol=1e-6 * tc.learning_rate,
                               err_msg=str(count))
  assert loop.make_schedule(TrainConfig()) is None


def test_scheduled_lr_reaches_the_optimizer():
  cfg = ModelConfig(model_name='HDRNetCurves', **SMALL)
  tc = TrainConfig(learning_rate=1e-3, lr_schedule='cosine',
                   lr_decay_steps=4, lr_warmup_steps=2, guide_lr_scale=0.5)
  port = make_model(cfg, generator=torch.Generator().manual_seed(0))
  sched = loop.make_schedule(tc)
  state = step.create_state(port, loop.make_optimizer(port, tc), sched)
  train_step = step.make_train_step()
  batch = step.to_device(_batch(2), 'cpu')
  for count in range(3):
    state, _ = train_step(state, batch)
    groups = state.optimizer.param_groups
    assert [g['lr'] for g in groups] == [sched(count), 0.5 * sched(count)]


def _config(max_steps, eval_interval=3600):
  return Config(
      model=ModelConfig(model_name='HDRNetCurves', **SMALL),
      data=DataConfig(batch_size=2, output_resolution=[64, 64],
                      net_input_size=32, data_threads=1),
      train=TrainConfig(learning_rate=3e-3, max_steps=max_steps,
                        log_interval=9999, summary_interval=9999,
                        checkpoint_interval=9999,
                        eval_interval=eval_interval))


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


def test_train_converges_resumes_and_serves(dataset, tmp_path):
  ckpt = str(tmp_path / 'ckpt')
  before = _build.launches.copy()
  cfg = _config(30, eval_interval=0)
  cfg.train.profile_dir = str(tmp_path / 'trace')
  state = loop.train(cfg, ckpt, str(dataset), eval_data_dir=str(dataset),
                     device='cpu')
  assert state.step == 30
  loss_30 = float(state.ema_loss)
  assert np.isfinite(loss_30)

  state2 = loop.train(_config(45), ckpt, str(dataset), device='cpu')
  assert state2.step == 45
  assert float(state2.ema_loss) < loss_30

  assert Config.load(ckpt).model.spatial_bin == 8
  recs = [json.loads(l) for l in open(os.path.join(ckpt, 'summaries.jsonl'))]
  assert recs[-1]['step'] == 45 and 'loss' in recs[-1]
  assert any('eval_psnr' in r for r in recs)
  assert sorted(os.listdir(ckpt)) == ['ckpt_30.pt', 'ckpt_45.pt',
                                      'config.json', 'summaries.jsonl']
  assert os.listdir(tmp_path / 'trace') == ['train_steps_10_15.json']

  enh = Enhancer.from_checkpoint(ckpt, device='cpu')
  frame = torch.rand(1, 70, 90, 3)
  out = enh.process(frame)
  assert out.shape == frame.shape and torch.isfinite(out).all()
  low = nearest_lowres_plain(frame, 32).permute(0, 2, 3, 1)
  with torch.no_grad():
    want = torch.clamp(state2.model.eval()(low, frame), 0, 1)
  np.testing.assert_allclose(out.numpy(), want.numpy(), atol=1e-4)
  # The CPU path ran no kernel.
  assert _build.launches == before


def test_normalize_batch_matches_jax():
  """uint8 and uint16 batches become x * float32(1 / white level), bit for
  bit as in the JAX step; float batches pass through."""
  rng = np.random.RandomState(4)
  batch = {'a': rng.randint(0, 256, (2, 5, 7, 3)).astype(np.uint8),
           'b': rng.randint(0, 65536, (2, 5, 7, 3)).astype(np.uint16),
           'c': rng.rand(2, 5, 7, 3).astype(np.float32)}
  want = jax_step.normalize_batch({k: jnp.asarray(v) for k, v in
                                   batch.items()})
  got = step.normalize_batch(step.to_device(batch, 'cpu'))
  for k in batch:
    assert got[k].dtype == torch.float32
    np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_train_refuses_what_is_not_ported(dataset, tmp_path):
  """A mesh larger than the world of processes is refused (one process
  here: the multi-process meshes are tests/test_torch_mesh_train.py's);
  the device-resident data path is ported and trains
  (tests/test_torch_device_data.py)."""
  cfg = _config(1)
  cfg.data.device_data = True
  state = loop.train(cfg, str(tmp_path / 'a'), str(dataset), device='cpu')
  assert (state.step, state.data_route) == (1, 'device')
  cfg = _config(1)
  cfg.train.mesh_shape = [2, 1]
  with pytest.raises(ValueError, match='needs 2 processes; the world has 1'):
    loop.train(cfg, str(tmp_path / 'b'), str(dataset), device='cpu')


def test_checkpoint_keeps_three_and_restores(tmp_path):
  from hdrnet_torch.training.checkpoint import Checkpointer
  cfg = ModelConfig(model_name='HDRNetCurves', **SMALL)
  tc = TrainConfig(learning_rate=1e-3)

  def fresh():
    port = make_model(cfg, generator=torch.Generator().manual_seed(5))
    return step.create_state(port, loop.make_optimizer(port, tc))

  state, train_step = fresh(), step.make_train_step()
  batch = step.to_device(_batch(3), 'cpu')
  ck = Checkpointer(tmp_path)
  for _ in range(5):
    state, _ = train_step(state, batch)
    ck.save(state.step, state)
  assert ck.latest_step() == 5
  assert sorted(os.listdir(tmp_path)) == ['ckpt_3.pt', 'ckpt_4.pt',
                                          'ckpt_5.pt']
  restored = ck.restore(fresh())
  assert restored.step == 5
  _, m_a = train_step(state, batch)
  _, m_b = train_step(restored, batch)
  for k in m_a:
    np.testing.assert_allclose(float(m_b[k]), float(m_a[k]), rtol=1e-6)
  for (name, a), b in zip(state.model.named_parameters(),
                          restored.model.parameters()):
    np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(),
                               rtol=0, atol=1e-6, err_msg=name)


def test_cli_builds_the_jax_config():
  from hdrnet_tpu.bin import train as jax_cli
  from hdrnet_torch.bin import train as cli
  for argv in (['ckpt', 'data', '--luma_bins', '16', '--spatial_bin', '32',
                '--batch_norm', '--data_pipeline',
                'StyleTransferDataPipeline', '--mesh_shape', '1', '1'],
               ['ckpt', 'data', '--learning_rate', '1e-4', '--batch_size',
                '1', '--nobatch_norm', '--output_resolution', '2048', '2048',
                '--lr_schedule', 'cosine', '--lr_decay_steps', '1000',
                '--guide_reg', '0.01', '--guide_lr_scale', '0.1'],
               ['ckpt', 'data', '--model_name', 'UNet', '--depth', '7',
                '--width', '16', '--batch_norm']):
    want = jax_cli.config_from_args(jax_cli.build_parser().parse_args(argv))
    got = cli.config_from_args(cli.build_parser().parse_args(argv))
    assert got.to_json() == want.to_json()
  assert got.model.model_name == 'UNet'

  def model_choices(parser):
    return next(a.choices for a in parser._actions if a.dest == 'model_name')
  assert sorted(model_choices(cli.build_parser())) == sorted(
      model_choices(jax_cli.build_parser()))


# --- make_train_step's CUDA graph: what the CPU can check ---------------------
# The graphs themselves run on the card: tests/test_torch_train_graph.py.

def _small_state(tc=None, schedule=None, seed=7):
  port = make_model(ModelConfig(model_name='HDRNetCurves', **SMALL),
                    generator=torch.Generator().manual_seed(seed))
  tc = tc or TrainConfig(learning_rate=1e-3)
  return step.create_state(port, loop.make_optimizer(port, tc), schedule)


def test_make_optimizer_keeps_plain_adam_on_the_cpu():
  """On the CPU Adam is neither capturable nor fused and its lr a number,
  also after loading a state dict that the card's optimizer saved (its
  groups capturable and fused, a scheduled lr in a tensor)."""
  tc = TrainConfig(learning_rate=1e-3, guide_lr_scale=0.5)
  state = _small_state(tc)
  opt = state.optimizer
  assert len(opt.param_groups) == 2
  assert [g['capturable'] for g in opt.param_groups] == [False, False]
  assert [g['fused'] for g in opt.param_groups] == [None, None]
  train_step = step.make_train_step()
  batch = step.to_device(_batch(5), 'cpu')
  state, _ = train_step(state, batch)
  saved = copy.deepcopy(opt.state_dict())
  for g in saved['param_groups']:
    g['capturable'] = g['fused'] = True
    g['lr'] = torch.tensor(g['lr'], dtype=torch.float64)
  other = _small_state(tc)
  other.optimizer.load_state_dict(saved)
  groups = other.optimizer.param_groups
  assert [g['capturable'] for g in groups] == [False, False]
  assert [g['fused'] for g in groups] == [None, None]
  assert [g['lr'] for g in groups] == [1e-3, 5e-4]
  assert all(type(g['lr']) is float for g in groups)
  other.model.load_state_dict(state.model.state_dict())
  _, m_a = train_step(state, batch)
  _, m_b = train_step(other, batch)
  assert float(m_a['loss']) == float(m_b['loss'])
  for a, b in zip(state.model.parameters(), other.model.parameters()):
    assert torch.equal(a, b)


def test_cpu_step_takes_no_graph():
  """The CPU step runs eagerly every call: no capture, no replay, no
  launch, and the phases' values are those of the plain step."""
  state = _small_state()
  train_step = step.make_train_step()
  batch = step.to_device(_batch(6), 'cpu')
  counts = step.graph_captures, step.graph_replays
  before = _build.launches.copy()
  for _ in range(4):
    state, _ = train_step(state, batch)
  assert (step.graph_captures, step.graph_replays) == counts
  assert _build.launches == before
  assert step._signature(state, batch) is None


def test_step_loss_is_not_overwritten_by_the_next():
  """The loss of step k, kept past later steps as ``loop.train`` keeps
  it (RUNAHEAD), still reads its own value."""
  state = _small_state()
  train_step = step.make_train_step()
  kept = []
  for seed in range(4):
    state, m = train_step(state, step.to_device(_batch(10 + seed), 'cpu'))
    kept.append((m['loss'], float(m['loss'])))
  assert len({v for _, v in kept}) == 4
  for t, v in kept:
    assert float(t) == v


class _Replaying:
  """Stands in for ``step._StepGraph`` on the CPU: records what it
  captured, and a replay runs the captured function eagerly on the
  batch; or raises like a failed capture."""
  made = []
  fail = False
  eager = []

  def __init__(self, run, state, batch, key):
    if _Replaying.fail:
      raise RuntimeError('operation not permitted when stream is capturing')
    self.run, self.key = run, key
    _Replaying.made.append(key[3])

  def replay(self, batch):
    loss, target, out = self.run(batch)
    return loss.clone(), target, out


@pytest.fixture
def replaying(monkeypatch):
  """The step's graph logic on CPU batches: `_signature` without its
  device test (None for the models in ``eager``), `_StepGraph` replaced
  by ``_Replaying``."""
  def signature(state, batch):
    if state.model in _Replaying.eager:
      return None
    xs = [batch[k] for k in step.BATCH_KEYS]
    return (state.model, state.optimizer, state.optimizer.state,
            tuple((tuple(x.shape), x.dtype, x.device) for x in xs),
            torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark)
  monkeypatch.setattr(step, '_signature', signature)
  monkeypatch.setattr(step, '_StepGraph', _Replaying)
  monkeypatch.setattr(torch.cuda, 'synchronize', lambda: None)
  _Replaying.made, _Replaying.fail, _Replaying.eager = [], False, []
  return _Replaying


def test_step_captures_at_the_second_call_of_a_signature(replaying):
  """The first call runs eagerly and the second captures; a new batch
  shape drops the graph and captures at its own second call; so do
  another state and a restored optimizer state (a new ``opt.state``)."""
  a, b = (step.to_device(_batch(1, hw=hw), 'cpu') for hw in (64, 32))
  train_step = step.make_train_step()
  state = _small_state()
  captured = []
  for batch in [a, a, a, b, b, a, a, a]:
    state, _ = train_step(state, batch)
    captured.append(len(replaying.made))
  assert captured == [0, 1, 1, 1, 2, 2, 3, 3]
  # made: each capture's (shape, dtype, device) of the batch keys.
  assert [k[1][0] for k in replaying.made] == [(2, 64, 64, 3),
                                               (2, 32, 32, 3),
                                               (2, 64, 64, 3)]
  other = _small_state(seed=8)
  for n in (3, 4, 4):
    other, _ = train_step(other, a)
    assert len(replaying.made) == n
  other.optimizer.load_state_dict(other.optimizer.state_dict())
  for n in (4, 5, 5):
    other, _ = train_step(other, a)
    assert len(replaying.made) == n


def test_failed_capture_runs_eagerly_with_one_warning(replaying, caplog):
  """A capture that raises: one warning, and the signature runs eagerly
  from then on, with the eager step's values."""
  import logging
  replaying.fail = True
  train_step, eager = step.make_train_step(), step.make_train_step()
  state, twin = _small_state(), _small_state()
  replaying.eager.append(twin.model)
  batch = step.to_device(_batch(2), 'cpu')
  with caplog.at_level(logging.WARNING, logger='hdrnet_torch.train'):
    for _ in range(5):
      state, m = train_step(state, batch)
      twin, want = eager(twin, batch)
      assert float(m['loss']) == float(want['loss'])
  assert len([r for r in caplog.records
              if 'CUDA graph' in r.getMessage()]) == 1
