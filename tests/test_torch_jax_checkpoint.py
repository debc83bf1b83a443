"""Checkpoints trained by ``hdrnet_tpu`` (orbax), converted by
``scripts/convert_jax_checkpoint.py``, served and resumed by
``hdrnet_torch`` on the CPU.

Each checkpoint is written by the JAX package's own training code
(``tests/jax_checkpoints.py``: a few jitted Adam steps of ``make_tx``,
saved by its ``Checkpointer``) at tiny widths, then converted. Serving:
``Enhancer.from_checkpoint(out, device='cpu').process`` against the JAX
``Enhancer(ckpt).process`` on the same seeded frame, 1e-5, for
``HDRNetCurves`` and ``HDRNetPointwiseNNGuide`` with batch norm. Resume:
one port step from the converted checkpoint against one JAX step from
the restored state, at ``tests/test_torch_train.py``'s step tolerances
(loss and psnr 1e-5 relative; each gradient 1e-4 of its leaf's largest
|g|; parameters 1e-2 * lr where the gradient is not negligible), for plain
Adam, ``guide_lr_scale`` 0.5 (the multi_transform state) and the cosine
schedule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hdrnet_tpu.config import Config, DataConfig, ModelConfig, TrainConfig
from hdrnet_tpu.inference import Enhancer as JaxEnhancer
from hdrnet_tpu.models import make_model as jax_make_model
from hdrnet_tpu.training import step as jax_step
from hdrnet_tpu.training.loop import make_tx

from hdrnet_torch.config import Config as PortConfig
from hdrnet_torch.convert import (convert_flax_variables,
                                  convert_optax_adam_state)
from hdrnet_torch.inference import Enhancer
from hdrnet_torch.models import make_model
from hdrnet_torch.training import loop, step
from hdrnet_torch.training.checkpoint import Checkpointer, latest_checkpoint

import jax_checkpoints

SMALL = dict(net_input_size=32, spatial_bin=8, luma_bins=4,
             output_resolution=[64, 64])
LR = 1e-3
VARIANTS = {
    'curves': (ModelConfig(model_name='HDRNetCurves', **SMALL),
               TrainConfig(learning_rate=LR)),
    'nn_bn': (ModelConfig(model_name='HDRNetPointwiseNNGuide',
                          batch_norm=True, guide_complexity=4, **SMALL),
              TrainConfig(learning_rate=LR)),
    'guide_scale': (ModelConfig(model_name='HDRNetCurves', **SMALL),
                    TrainConfig(learning_rate=LR, guide_lr_scale=0.5)),
    'cosine': (ModelConfig(model_name='HDRNetCurves', **SMALL),
               TrainConfig(learning_rate=LR, lr_schedule='cosine',
                           lr_decay_steps=8, lr_end=1e-5,
                           lr_warmup_steps=2)),
}


@pytest.fixture(scope='module')
def checkpoints(tmp_path_factory):
  """{variant: (JAX checkpoint dir, converted dir, last JAX state)}."""
  conv = jax_checkpoints.converter()
  out = {}
  for name, (model_cfg, train_cfg) in VARIANTS.items():
    root = tmp_path_factory.mktemp(name)
    cfg = Config(model=model_cfg, train=train_cfg,
                 data=DataConfig(output_resolution=[64, 64],
                                 net_input_size=32))
    state = jax_checkpoints.write(root / 'jax', cfg)
    conv.main([str(root / 'jax'), str(root / 'port')])
    out[name] = (str(root / 'jax'), str(root / 'port'), state)
  return out


def test_converted_checkpoint_layout(checkpoints):
  jax_dir, port_dir, jstate = checkpoints['guide_scale']
  payload = torch.load(latest_checkpoint(port_dir), weights_only=True)
  assert sorted(payload) == ['ema_loss', 'ema_psnr', 'model', 'optimizer',
                             'step']
  assert payload['step'] == 3
  np.testing.assert_allclose(float(payload['ema_loss']),
                             float(jstate.ema_loss), rtol=1e-7)
  assert PortConfig.load(port_dir).train.guide_lr_scale == 0.5
  groups = payload['optimizer']['param_groups']
  assert [g['lr_scale'] for g in groups] == [1.0, 0.5]
  steps = {float(s['step']) for s in payload['optimizer']['state'].values()}
  assert steps == {3.0}


@pytest.mark.parametrize('name', ['curves', 'nn_bn'])
def test_converted_checkpoint_serves_as_jax(checkpoints, name):
  jax_dir, port_dir, _ = checkpoints[name]
  frame = np.random.RandomState(4).rand(1, 40, 56, 3).astype(np.float32)
  want = np.asarray(JaxEnhancer(jax_dir).process(jnp.asarray(frame)))
  port = Enhancer.from_checkpoint(port_dir, device='cpu')
  got = port.process(torch.from_numpy(frame))
  assert port.fused and got.shape == frame.shape
  np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_chosen_step_converts(checkpoints, tmp_path):
  jax_dir, port_dir, _ = checkpoints['nn_bn']
  path = jax_checkpoints.converter().main([jax_dir, str(tmp_path), '--step',
                                           '2'])
  assert path.endswith('ckpt_2.pt')
  two = torch.load(path, weights_only=True)
  three = torch.load(latest_checkpoint(port_dir), weights_only=True)
  assert two['step'] == 2
  moved = [k for k in two['model']
           if not torch.equal(two['model'][k], three['model'][k])]
  assert any('running_mean' in k for k in moved), moved
  with pytest.raises(FileNotFoundError, match='no step 7'):
    jax_checkpoints.converter().main([jax_dir, str(tmp_path), '--step', '7'])


def _stash_grads():
  """An optax transform that passes the gradients on and keeps them as
  its state, so a JAX step reports the gradients it applied."""
  return optax.GradientTransformation(
      lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
      lambda updates, state, params=None: (updates, updates))


@pytest.mark.parametrize('name', ['curves', 'guide_scale', 'cosine'])
def test_resumed_step_matches_jax(checkpoints, name):
  """The converted checkpoint restored by the port's Checkpointer (as
  ``train`` resumes) takes one step; the JAX package's restored state
  takes one on the same batch."""
  jax_dir, port_dir, _ = checkpoints[name]
  model_cfg, tc = VARIANTS[name]
  conv = jax_checkpoints.converter()
  step_no, restored = conv.restore_jax_state(jax_dir)
  tx = optax.chain(_stash_grads(), make_tx(tc))
  jstate = restored.replace(opt_state=(
      jax.tree_util.tree_map(np.zeros_like, restored.params),
      restored.opt_state))
  jstep = jax.jit(jax_step.make_train_step(jax_make_model(model_cfg), tx))
  batch = jax_checkpoints.batch(7)
  jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
  want_grads = convert_flax_variables({'params': jstate.opt_state[0]})
  want_params = convert_flax_variables({'params': jstate.params})

  cfg = PortConfig.load(port_dir)
  port = make_model(cfg.model)
  schedule = loop.make_schedule(cfg.train)
  state = step.create_state(port, loop.make_optimizer(port, cfg.train),
                            schedule)
  assert Checkpointer(port_dir).restore(state) is state
  assert state.step == step_no == 3
  lr = LR if schedule is None else schedule(state.step)
  state, m = step.make_train_step()(state, step.to_device(batch, 'cpu'))

  for k in ('loss', 'psnr', 'ema_loss', 'ema_psnr'):
    np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                               err_msg=k)
  assert state.step == int(jstate.step) == 4
  for pname, p in port.named_parameters():
    g_want = want_grads[pname].numpy()
    g_scale = float(np.abs(g_want).max())
    np.testing.assert_allclose(p.grad.numpy(), g_want, rtol=0,
                               atol=1e-4 * g_scale, err_msg=pname)
    moved = np.abs(g_want) > 1e-5 * g_scale
    np.testing.assert_allclose(p.detach().numpy()[moved],
                               want_params[pname].numpy()[moved], rtol=0,
                               atol=1e-2 * lr, err_msg=pname)


def test_adam_state_is_matched_by_name(checkpoints):
  """A parameter with no moments, or moments of no parameter, or a
  parameter outside its optax partition's param group, is refused."""
  jax_dir, _, _ = checkpoints['guide_scale']
  conv = jax_checkpoints.converter()
  step_no, restored = conv.restore_jax_state(jax_dir)
  cfg = PortConfig.load(jax_dir)
  port = make_model(cfg.model)
  opt = loop.make_optimizer(port, cfg.train)
  sd = convert_optax_adam_state(restored.opt_state, port, opt, step=step_no)
  opt.load_state_dict(sd)
  with pytest.raises(ValueError, match='are not the step 2'):
    convert_optax_adam_state(restored.opt_state, port, opt, step=2)
  # Scale 1: one param group, so the 'guide' partition has none of its own.
  flat = loop.make_optimizer(port, TrainConfig(learning_rate=LR))
  with pytest.raises(ValueError, match="partition 'guide'"):
    convert_optax_adam_state(restored.opt_state, port, flat)
  rest = restored.opt_state.inner_states['rest']
  with pytest.raises(ValueError, match='no Adam moments for guide'):
    convert_optax_adam_state(rest, port, opt)
  # Another architecture: its batch norms' shifts have no moments.
  other = make_model(PortConfig.load(checkpoints['nn_bn'][1]).model)
  with pytest.raises(ValueError, match=r'no Adam moments for \S+\.bn\.'):
    convert_optax_adam_state(restored.opt_state, other,
                             loop.make_optimizer(other, cfg.train))
