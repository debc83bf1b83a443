"""HDRNetPointwiseNNGuide and HDRNetGaussianPyrNN of hdrnet_torch vs the
Flax models on the CPU: forward, weight conversion and one training step.

Flax ``init`` -> ``convert_flax_variables`` -> the port's module (strict
``load_state_dict``), fed the same numpy-seeded inputs. Tolerances are
those of ``tests/test_torch_model.py`` and ``tests/test_torch_train.py``:
forward 1e-4 (the guide's depth coordinate amplifies a grid or guide
difference about gd-fold); loss and psnr 1e-5 relative; each parameter's
gradient 1e-4 of that leaf's largest |g|; parameters after one Adam step
within 1e-2 * lr where the gradient is not negligible; batch-norm
statistics 1e-6.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from hdrnet_tpu.config import ModelConfig, TrainConfig
from hdrnet_tpu.models import make_model as jax_make_model
from hdrnet_tpu.training import step as jax_step
from hdrnet_tpu.training.loop import make_tx

from hdrnet_torch.convert import convert_flax_variables
from hdrnet_torch.models import make_model
from hdrnet_torch.training import loop, step

NN, PYR = 'HDRNetPointwiseNNGuide', 'HDRNetGaussianPyrNN'


def _cfg(name, batch_norm=False, gc=4):
  return ModelConfig(model_name=name, net_input_size=64, spatial_bin=8,
                     luma_bins=4, guide_complexity=gc, batch_norm=batch_norm)


def _perturb_bn(variables, rng):
  """Random BN shifts and running stats (the guides' always-present BN
  included), so BN and its fold are exercised."""
  def perturb(path, x):
    names = [getattr(p, 'key', '') for p in path]
    if 'bn' not in names:
      return x
    if names[-1] == 'var':
      return rng.uniform(0.5, 2.0, x.shape).astype(np.float32)
    return (0.1 * rng.randn(*x.shape)).astype(np.float32)
  return jax.tree_util.tree_map_with_path(perturb, variables)


@functools.lru_cache(maxsize=None)
def _init(name, batch_norm=False, gc=4, seed=0):
  """Flax variables as numpy arrays (jitted init: eager init of these
  models takes several seconds)."""
  cfg = _cfg(name, batch_norm, gc)
  init = jax.jit(functools.partial(jax_make_model(cfg).init, train=True))
  s = cfg.net_input_size
  variables = init(jax.random.PRNGKey(seed), jnp.zeros((1, s, s, 3)),
                   jnp.zeros((1, 16, 16, 3)))
  return jax.tree_util.tree_map(np.array, dict(variables))


def _flax_and_port(cfg, full_hw, seed=0):
  rng = np.random.RandomState(seed)
  lowres = rng.rand(1, 64, 64, 3).astype(np.float32)
  fullres = rng.rand(1, *full_hw, 3).astype(np.float32)
  jax_model = jax_make_model(cfg)
  variables = _perturb_bn(_init(cfg.model_name, cfg.batch_norm,
                                cfg.guide_complexity, seed), rng)
  port = make_model(cfg)
  port.load_state_dict(convert_flax_variables(variables))  # strict
  return jax_model, variables, port.eval(), lowres, fullres


# (model, batch_norm, guide_complexity): the configurations under test.
CASES = [(NN, False, 16), (NN, True, 4), (PYR, False, 4), (PYR, True, 16)]


@pytest.mark.parametrize('name,batch_norm,gc,full_hw', [
    case + (hw,) for case, hw in zip(CASES, [(96, 128), (101, 60), (101, 60),
                                             (96, 128)])])
def test_forward_matches_flax(name, batch_norm, gc, full_hw):
  """Eval-mode forward, and the guide maps the Flax model sows (for the
  pyramid one a level, finest first: 101x60 -> 50x30 -> 25x15)."""
  cfg = _cfg(name, batch_norm, gc)
  jax_model, variables, port, lowres, fullres = _flax_and_port(cfg, full_hw)
  apply = jax.jit(functools.partial(jax_model.apply,
                                    mutable=['intermediates']))
  want, inter = apply(variables, jnp.asarray(lowres), jnp.asarray(fullres))
  with torch.no_grad():
    got, guides = port(torch.from_numpy(lowres), torch.from_numpy(fullres),
                       return_guide=True)
  assert got.shape == (1, *full_hw, 3)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
  want_guides = inter['intermediates']['guide_map']
  if name == NN:
    guides = [guides]
  assert len(guides) == len(want_guides)
  for g, wg in zip(guides, want_guides):
    assert g.shape == wg.shape
    np.testing.assert_allclose(g.numpy(), np.asarray(wg), atol=1e-5)


@pytest.mark.parametrize('name,batch_norm,gc', CASES)
def test_convert_fills_every_parameter_and_buffer(name, batch_norm, gc):
  """The converted tree names exactly the port's state: 1x1 HWIO kernels
  -> OIHW, guide_level_{l}.*, the guides' BN statistics (present
  whatever batch_norm says)."""
  state = convert_flax_variables(_init(name, batch_norm, gc))
  want = make_model(_cfg(name, batch_norm, gc)).state_dict()
  assert sorted(state) == sorted(want)
  for k, v in want.items():
    assert state[k].shape == v.shape, k
  guides = ['guide'] if name == NN else [f'guide_level_{l}' for l in range(3)]
  for g in guides:
    assert state[f'{g}.conv1.conv.weight'].shape == (gc, 3, 1, 1)
    assert f'{g}.conv1.bn.running_var' in state
    assert state[f'{g}.conv2.conv.bias'].shape == (1,)


def test_guide_levels_are_in_the_scaled_group():
  port = make_model(_cfg(PYR), generator=torch.Generator().manual_seed(0))
  opt = loop.make_optimizer(port, TrainConfig(learning_rate=1e-3,
                                              guide_lr_scale=0.1))
  rest, guides = opt.param_groups
  want = {id(p) for n, p in port.named_parameters()
          if n.startswith('guide_level_')}
  assert len(want) == 3 * 4  # conv1 weight, BN shift, conv2 weight, bias
  assert {id(p) for p in guides['params']} == want
  assert guides['lr'] == pytest.approx(1e-4) and rest['lr'] == 1e-3


def _batch(seed, b=2, hw=64):
  rng = np.random.RandomState(seed)
  full = rng.randint(0, 256, (b, hw, hw, 3)).astype(np.uint8)
  low = full[:, ::hw // 64 or 1, ::hw // 64 or 1]
  target = np.clip(full.astype(np.float32) * 1.3, 0, 255).astype(np.uint8)
  return {'lowres_input': np.ascontiguousarray(low),
          'lowres_output': np.ascontiguousarray(low),
          'image_input': full, 'image_output': target}


def _stash_grads():
  """An optax transform that passes the gradients on and keeps them as
  its state, so a JAX step reports the gradients it applied."""
  return optax.GradientTransformation(
      lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
      lambda updates, state, params=None: (updates, updates))


@pytest.mark.parametrize('name,gc,guide_reg,guide_lr_scale', [
    (NN, 16, 0.0, 1.0), (PYR, 4, 0.5, 0.1)])
def test_one_train_step_matches_jax(name, gc, guide_reg, guide_lr_scale):
  """One Adam step: the loss (with the guide-range hinge averaged over
  the pyramid's three guide maps), every parameter's gradient
  (jax.value_and_grad inside the JAX step), the updated parameters, and
  the guides' BN statistics, which move in training whatever
  ``batch_norm`` says. (``batch_norm`` is off: with it on, the backbone's
  BN over a batch of two is ill-conditioned for every HDRNet model alike;
  in float64 the port and JAX agree, in float32 only to ~7e-4 of a
  leaf's max, the port being the nearer to the float64 gradients.)"""
  lr = 1e-3
  cfg = _cfg(name, gc=gc)
  tc = TrainConfig(learning_rate=lr, guide_lr_scale=guide_lr_scale)
  batch = _batch(1)
  model = jax_make_model(cfg)
  variables = _init(name, gc=gc)

  tx = optax.chain(_stash_grads(), make_tx(tc))
  jstate = jax_step.TrainState(
      step=jnp.zeros((), jnp.int32), params=variables['params'],
      opt_state=tx.init(variables['params']),
      batch_stats=variables.get('batch_stats', {}),
      ema_loss=jnp.zeros(()), ema_psnr=jnp.zeros(()))
  jstep = jax.jit(jax_step.make_train_step(model, tx, guide_reg=guide_reg))
  jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
  want_grads = convert_flax_variables({'params': jstate.opt_state[0]})
  want = convert_flax_variables({'params': jstate.params,
                                 'batch_stats': jstate.batch_stats})

  port = make_model(cfg)
  port.load_state_dict(convert_flax_variables(variables))
  state = step.create_state(port, loop.make_optimizer(port, tc))
  state, m = step.make_train_step(guide_reg=guide_reg)(
      state, step.to_device(batch, 'cpu'))

  for k in ('loss', 'psnr', 'ema_loss', 'ema_psnr'):
    np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                               err_msg=k)
  for name_, p in port.named_parameters():
    g_want = want_grads[name_].numpy()
    g_scale = float(np.abs(g_want).max())
    np.testing.assert_allclose(p.grad.numpy(), g_want, rtol=0,
                               atol=1e-4 * g_scale, err_msg=name_)
    moved = np.abs(g_want) > 1e-5 * g_scale
    np.testing.assert_allclose(p.detach().numpy()[moved],
                               want[name_].numpy()[moved], rtol=0,
                               atol=1e-2 * lr, err_msg=name_)
  buffers = dict(port.named_buffers())
  assert len(buffers) == 2 * (1 if name == NN else 3)
  for name_, buf in buffers.items():
    np.testing.assert_allclose(buf.numpy(), want[name_].numpy(), atol=1e-6,
                               err_msg=name_)
