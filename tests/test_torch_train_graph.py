"""``make_train_step``'s CUDA graph on the card.

Marked ``gpu``: skipped without a card (looked for inside a fixture); on
the card ``python -m pytest --noconftest -m gpu
tests/test_torch_train_graph.py``. The graphed steps are held to the same
steps with the graph off (``step._signature`` answering None, so that
every call runs eagerly with the same capturable, fused Adam) under
``cudnn.deterministic``, bit for bit: the pyramid of the frame and the
feature pyramid at cm 2 on small crops, at a constant lr and on a cosine
schedule with a scaled guide group. Also: which calls capture and
replay, a new batch shape, the mesh and a failed capture (eager), and a
checkpoint restored into a new state (its own, or one a CPU optimizer
saved) stepping on. The CPU side of the graph's logic is in
``tests/test_torch_train.py``. This file imports no JAX.
"""

import contextlib
import logging
import math
import socket

import pytest
import torch

from hdrnet_torch.config import ModelConfig, TrainConfig
from hdrnet_torch.models import make_model
from hdrnet_torch.ops import _build
from hdrnet_torch.training import loop, metrics, step
from hdrnet_torch.training.checkpoint import Checkpointer

pytestmark = pytest.mark.gpu

SMALL = dict(net_input_size=64, spatial_bin=8, luma_bins=4,
             guide_complexity=4)
MODELS = {'pyr': dict(model_name='HDRNetGaussianPyrNN', **SMALL),
          'fpyr': dict(model_name='HDRNetFeaturesPyrNN3', channel_multiplier=2,
                       **SMALL)}
CONSTANT = TrainConfig(learning_rate=1e-3)
COSINE = TrainConfig(learning_rate=1e-3, lr_schedule='cosine',
                     lr_decay_steps=6, lr_warmup_steps=2, lr_end=1e-5,
                     guide_lr_scale=0.5)
K3, K4, K5 = ('hdrnet_slice_apply_fwd', 'hdrnet_slice_apply_pix_bwd',
              'hdrnet_slice_apply_grid_bwd')


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA device: run on the card with '
                '`python -m pytest --noconftest -m gpu '
                'tests/test_torch_train_graph.py`')
  return torch.device('cuda', 0)


@pytest.fixture
def deterministic():
  saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
  torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
      True, False)
  try:
    yield
  finally:
    (torch.backends.cudnn.deterministic,
     torch.backends.cudnn.benchmark) = saved


@contextlib.contextmanager
def _graph_off(monkeypatch):
  with monkeypatch.context() as m:
    m.setattr(step, '_signature', lambda state, batch: None)
    yield


def _batches(dev, n, b=2, hw=128, s=64, seed=0):
  """n seeded uint8 batches shaped like the device augment's."""
  gen = torch.Generator(device=dev).manual_seed(seed)
  out = []
  for _ in range(n):
    full = torch.randint(0, 256, (b, hw, hw, 3), generator=gen, device=dev,
                         dtype=torch.uint8)
    target = (full.float() * 1.3).clamp(0, 255).to(torch.uint8)
    low = full[:, ::hw // s, ::hw // s].contiguous()
    out.append({'lowres_input': low, 'image_input': full,
                'image_output': target})
  return out


def _state(cfg, tc, dev, seed=3):
  model = make_model(ModelConfig(**cfg),
                     generator=torch.Generator().manual_seed(seed)).to(dev)
  return step.create_state(model, loop.make_optimizer(model, tc),
                           loop.make_schedule(tc))


def _counts():
  return step.graph_captures, step.graph_replays


def _train(state, train_step, batches):
  """Steps `state` through `batches`; returns the kept loss tensors (read
  only after the last step) and the parameters."""
  losses = []
  for b in batches:
    state, m = train_step(state, b)
    losses.append(m['loss'])
  return ([float(x) for x in losses],
          {k: p.detach().clone() for k, p in state.model.named_parameters()})


def _assert_same(got, want):
  (got_losses, got_params), (want_losses, want_params) = got, want
  assert got_losses == want_losses
  for k, v in want_params.items():
    err = float((got_params[k] - v).abs().max())
    assert torch.equal(got_params[k], v), f'{k}: max diff {err:.3e}'


@pytest.mark.parametrize('tc', [CONSTANT, COSINE], ids=['constant', 'cosine'])
@pytest.mark.parametrize('name', sorted(MODELS))
def test_graphed_steps_are_the_eager_steps(cuda, deterministic, monkeypatch,
                                           name, tc):
  """N steps: the first eager, the second captured and replayed, the
  rest replayed (1 capture, N - 1 replays, since a capture runs nothing
  and its own call replays it), bit for bit the same N steps with the
  graph off, with three K3, K4 and K5 counted a step on both paths; the
  losses kept from every step read their own values after the last."""
  n = 6
  batches = _batches(cuda, n)
  counts, before = _counts(), _build.launches.copy()
  with _graph_off(monkeypatch):
    want = _train(_state(MODELS[name], tc, cuda), step.make_train_step(),
                  batches)
  assert _counts() == counts
  eager = _build.launches - before
  state = _state(MODELS[name], tc, cuda)
  before = _build.launches.copy()
  got = _train(state, step.make_train_step(), batches)
  assert _counts() == (counts[0] + 1, counts[1] + n - 1)
  graphed = _build.launches - before
  assert [graphed[k] for k in (K3, K4, K5)] == [3 * n] * 3
  assert graphed == eager
  _assert_same(got, want)
  assert all(g['capturable'] and g['fused']
             for g in state.optimizer.param_groups)
  if tc.lr_schedule == 'cosine':
    sched = loop.make_schedule(tc)
    for g in state.optimizer.param_groups:
      assert isinstance(g['lr'], torch.Tensor) and g['lr'].is_cuda
      want_lr = torch.tensor(sched(n - 1) * g['lr_scale'],
                             dtype=torch.float32)
      assert float(g['lr']) == float(want_lr)


def test_a_new_batch_shape_recaptures(cuda, deterministic, monkeypatch):
  """Shapes A A A B B A A: A captures at its second call, B drops A's
  graph and captures at its second, and A again at its second; every
  step is the eager one."""
  a, b = _batches(cuda, 5, seed=1), _batches(cuda, 2, hw=96, s=48, seed=2)
  batches = a[:3] + b + a[3:]
  with _graph_off(monkeypatch):
    want = _train(_state(MODELS['pyr'], CONSTANT, cuda),
                  step.make_train_step(), batches)
  counts = _counts()
  got = _train(_state(MODELS['pyr'], CONSTANT, cuda), step.make_train_step(),
               batches)
  # Replays: calls 2, 3 (A), 5 (B) and 7 (A).
  assert _counts() == (counts[0] + 3, counts[1] + 4)
  _assert_same(got, want)


@pytest.fixture
def world_of_one(monkeypatch):
  """A gloo process group of one rank in this process, destroyed after."""
  import torch.distributed as dist
  from hdrnet_torch.parallel import mesh as pm
  with socket.socket() as s:
    s.bind(('localhost', 0))
    port = s.getsockname()[1]
  for k, v in dict(RANK='0', LOCAL_RANK='0', WORLD_SIZE='1',
                   MASTER_ADDR='localhost', MASTER_PORT=str(port)).items():
    monkeypatch.setenv(k, v)
  pm.initialize_distributed('gloo')
  try:
    yield pm.make_mesh((1, 1))
  finally:
    dist.destroy_process_group()


def test_the_mesh_step_runs_eagerly(cuda, deterministic, monkeypatch,
                                    world_of_one):
  """The mesh's step (collectives in it) never captures; at (1, 1) it is
  the step with the graph off, up to the mesh loss's own rounding (a sum
  over the global count, not a mean), as on the CPU
  (``tests/test_torch_parallel.py``)."""
  from hdrnet_torch.parallel import mesh as pm
  batches = _batches(cuda, 4, seed=4)
  with _graph_off(monkeypatch):
    want_losses, want = _train(_state(MODELS['pyr'], CONSTANT, cuda),
                               step.make_train_step(), batches)
  counts = _counts()
  state = _state(MODELS['pyr'], CONSTANT, cuda)
  pm.replicate(state.model, world_of_one)
  got_losses, got = _train(state, step.make_train_step(mesh=world_of_one),
                           batches)
  assert _counts() == counts
  torch.testing.assert_close(torch.tensor(got_losses),
                             torch.tensor(want_losses), rtol=1e-5, atol=1e-6)
  for k, v in want.items():
    torch.testing.assert_close(got[k], v, rtol=1e-4, atol=1e-5, msg=k)


def test_a_failed_capture_runs_eagerly(cuda, deterministic, monkeypatch,
                                       caplog):
  """A loss that reads a value back to the host cannot be captured: one
  warning, no graph, and every step is the eager one."""
  batches = _batches(cuda, 5, seed=5)
  l2 = metrics.l2_loss

  def reading(target, prediction, mesh=None):
    loss = l2(target, prediction, mesh)
    if float(loss) < 0:  # never; the read is the point
      raise AssertionError
    return loss
  monkeypatch.setattr(metrics, 'l2_loss', reading)
  with _graph_off(monkeypatch):
    want = _train(_state(MODELS['pyr'], CONSTANT, cuda),
                  step.make_train_step(), batches)
  counts = _counts()
  with caplog.at_level(logging.WARNING, logger='hdrnet_torch.train'):
    got = _train(_state(MODELS['pyr'], CONSTANT, cuda),
                 step.make_train_step(), batches)
  assert _counts() == counts
  assert len([r for r in caplog.records
              if 'CUDA graph' in r.getMessage()]) == 1
  _assert_same(got, want)


@pytest.mark.parametrize('tc', [CONSTANT, COSINE], ids=['constant', 'cosine'])
def test_a_restored_checkpoint_steps_on(cuda, deterministic, monkeypatch,
                                        tmp_path, tc):
  """Four graphed steps, saved; the checkpoint restored into a new state
  steps on through the same step function (its model is another, so it
  runs eagerly once and captures anew), bit for bit the restored state
  stepped with the graph off; and a checkpoint that a CPU optimizer
  wrote (plain Adam) restores into a capturable one that captures."""
  batches = _batches(cuda, 7, seed=6)
  train_step = step.make_train_step()
  state = _state(MODELS['pyr'], tc, cuda)
  for b in batches[:4]:
    state, _ = train_step(state, b)
  Checkpointer(tmp_path / 'card').save(state.step, state)
  with _graph_off(monkeypatch):
    twin = Checkpointer(tmp_path / 'card').restore(
        _state(MODELS['pyr'], tc, cuda, seed=9))
    want = _train(twin, step.make_train_step(), batches[4:])
  counts = _counts()
  restored = Checkpointer(tmp_path / 'card').restore(
      _state(MODELS['pyr'], tc, cuda, seed=9))
  assert restored.step == 4
  got = _train(restored, train_step, batches[4:])
  assert _counts() == (counts[0] + 1, counts[1] + 2)
  _assert_same(got, want)

  cpu = _state(MODELS['pyr'], tc, 'cpu')
  for b in batches[:2]:
    cpu, _ = step.make_train_step()(cpu, {k: v.cpu() for k, v in b.items()})
  Checkpointer(tmp_path / 'cpu').save(cpu.step, cpu)
  moved = Checkpointer(tmp_path / 'cpu').restore(
      _state(MODELS['pyr'], tc, cuda, seed=9))
  opt = moved.optimizer
  assert all(g['capturable'] and g['fused'] for g in opt.param_groups)
  for p in moved.model.parameters():
    assert opt.state[p]['step'].is_cuda
    assert opt.state[p]['step'].dtype == torch.float32
  counts = _counts()
  got, _ = _train(moved, step.make_train_step(), batches[2:5])
  assert _counts() == (counts[0] + 1, counts[1] + 2)
  assert all(math.isfinite(x) for x in got)


def _span_counts(fn):
  """{name: count} of the hdrnet.train.* ranges `fn` opens on the host."""
  from torch.profiler import ProfilerActivity, profile
  with profile(activities=[ProfilerActivity.CPU]) as prof:
    fn()
  names = [e.name() for e in prof.profiler.kineto_results.events()
           if e.name().startswith('hdrnet.train.')
           and e.device_type() == torch.autograd.DeviceType.CPU]
  return {n: names.count(n) for n in sorted(set(names))}


def test_the_steps_spans(cuda):
  """The eager first step opens the three phases; the second opens the
  capture (inside which the captured phases' spans open once) and a
  replay; a replayed step opens only the replay and the metrics."""
  batches = _batches(cuda, 3, seed=7)
  state = _state(MODELS['pyr'], CONSTANT, cuda)
  train_step = step.make_train_step()
  phases = {'hdrnet.train.forward': 1, 'hdrnet.train.backward': 1,
            'hdrnet.train.optimizer': 1, 'hdrnet.train.metrics': 1}
  got = [_span_counts(lambda b=b: train_step(state, b)) for b in batches]
  assert got == [phases,
                 {**phases, 'hdrnet.train.capture': 1,
                  'hdrnet.train.replay': 1},
                 {'hdrnet.train.metrics': 1, 'hdrnet.train.replay': 1}]
