"""Shared set-up of the zoo parity tests (``tests/test_torch_zoo_*.py``):
the 14 models the port added to the three HDRNet models, their small
configuration (``tests/test_models.py``'s: 64^2 preview, s8/l4, gc 4,
baselines depth 3 width 8, 6 input channels for the style models), the
Flax variables of each (the tree of the Flax init, filled from the
port's seeded initialization; batch-norm statistics and shifts perturbed
so that BN is exercised), the port's module loaded from them strictly,
and one training step of the port held to the JAX step
(``check_one_train_step``).
"""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import optax
import torch

from hdrnet_tpu.config import ModelConfig, TrainConfig
from hdrnet_tpu.models import make_model as jax_make_model
from hdrnet_tpu.training import step as jax_step
from hdrnet_tpu.training.loop import make_tx

from hdrnet_torch import config as port_config
from hdrnet_torch.convert import convert_flax_variables
from hdrnet_torch.models import make_model
from hdrnet_torch.training import loop, step

ZOO = ('UNet', 'DilatedConvolutions', 'HDRNetGaussianPyr',
       'HDRNet3x3NNGuide', 'HDRNetStack', 'HDRNetFullresFeatures',
       'HDRNetFullresFeaturesMultiscale', 'HDRNetFullresFeaturesWithGuide',
       'HDRNetFeaturesPyrNN', 'HDRNetFeaturesPyrNN2', 'HDRNetFeaturesPyrNN3',
       'HDRNetFeaturesPyrSimpleGuideNN', 'StyleTransferNN',
       'StyleTransferCurves')
FUSED = ('HDRNetCurves', 'HDRNetPointwiseNNGuide', 'HDRNetGaussianPyrNN')


def small_cfg(name, batch_norm=False, **kw):
  if name.startswith('StyleTransfer'):
    kw.setdefault('n_in', 6)
  return ModelConfig(model_name=name, net_input_size=64, spatial_bin=8,
                     luma_bins=4, guide_complexity=4, depth=3, width=8,
                     batch_norm=batch_norm, **kw)


def port_cfg(name, batch_norm=False, **kw):
  """``small_cfg`` as the port's own ModelConfig."""
  return port_config.ModelConfig(
      **dataclasses.asdict(small_cfg(name, batch_norm, **kw)))


def _perturb_bn(variables, rng):
  def perturb(path, x):
    names = [getattr(p, 'key', '') for p in path]
    if 'bn' not in names:
      return x
    if names[-1] == 'var':
      return rng.uniform(0.5, 2.0, x.shape).astype(np.float32)
    return (0.1 * rng.randn(*x.shape)).astype(np.float32)
  return jax.tree_util.tree_map_with_path(perturb, variables)


def _from_port(shapes, state, prefix=''):
  """The Flax tree of `shapes` (``jax.eval_shape`` of ``init``) filled
  from a port ``state_dict``: the inverse of ``convert_flax_variables``'s
  layout changes (OIHW -> HWIO, (out, in) -> (in, out), running stats
  -> mean / var)."""
  out = {}
  for name, leaf in shapes.items():
    if isinstance(leaf, dict):
      out[name] = _from_port(leaf, state, f'{prefix}{name}.')
      continue
    key = {'kernel': 'weight', 'mean': 'running_mean',
           'var': 'running_var'}.get(name, name)
    value = state[prefix + key].numpy()
    if name == 'kernel':
      value = value.transpose(2, 3, 1, 0) if value.ndim == 4 else value.T
    assert value.shape == leaf.shape, (prefix + name, value.shape)
    out[name] = np.ascontiguousarray(value, dtype=np.float32)
  return out


@functools.lru_cache(maxsize=None)
def _init(name, batch_norm, seed):
  """Flax variables without compiling the Flax ``init``: its tree of
  names and shapes from ``jax.eval_shape``, filled with the port's
  seeded initialization (the same initializers; compiling the Flax init
  of a feature pyramid takes seconds)."""
  cfg = small_cfg(name, batch_norm)
  init = functools.partial(jax_make_model(cfg).init, train=True)
  s, c = cfg.net_input_size, cfg.n_in
  shapes = jax.eval_shape(init, jax.random.PRNGKey(seed),
                          jnp.zeros((1, s, s, c)), jnp.zeros((1, 16, 16, c)))
  state = make_model(cfg, torch.Generator().manual_seed(seed)).state_dict()
  return {col: _from_port(tree, state) for col, tree in shapes.items()}


def flax_variables(name, batch_norm=False, seed=0, perturb=True):
  """Flax variables of `name` as numpy arrays; with `perturb`, random BN
  shifts and running statistics (the guides' BN, present whatever
  ``batch_norm`` says, included)."""
  variables = _init(name, batch_norm, seed)
  if perturb:
    variables = _perturb_bn(variables, np.random.RandomState(seed + 100))
  return variables


def port_model(name, variables, batch_norm=False, **kw):
  """The port's model of `name`, strict-loaded from Flax `variables`."""
  model = make_model(small_cfg(name, batch_norm, **kw))
  model.load_state_dict(convert_flax_variables(variables))
  return model


def inputs(cfg, b=2, hw=(41, 53), seed=0):
  """Seeded numpy (lowres, fullres) in [0, 1)."""
  rng = np.random.RandomState(seed)
  s, c = cfg.net_input_size, cfg.n_in
  return (rng.rand(b, s, s, c).astype(np.float32),
          rng.rand(b, *hw, c).astype(np.float32))


def compare_intermediates(got, want, atol, path=''):
  """The port's intermediates dict against the Flax top-level sows: the
  same keys; a sown tuple against a tensor (the grid) or a list; a
  submodule's dict recursively."""
  assert sorted(got) == sorted(want), (path, sorted(got), sorted(want))
  for key, w in want.items():
    g = got[key]
    if isinstance(w, dict):
      compare_intermediates(g, w, atol, f'{path}{key}.')
      continue
    g = [g] if isinstance(g, torch.Tensor) else list(g)
    assert len(g) == len(w), f'{path}{key}'
    for a, b in zip(g, w):
      assert tuple(a.shape) == tuple(b.shape), f'{path}{key}'
      np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                 rtol=0, atol=atol, err_msg=f'{path}{key}')


# --- one training step against the JAX step --------------------------------

LR = 1e-3
GRAD_REL = 1e-4
# HDRNetStack's first-stage guide: its gradient passes through the whole
# second stage (that stage's guide with batch norm in training mode, its
# backbone on the resized output, the slice-apply's input cotangent), so
# float32 rounding grows there: the port's own, against its float64 run
# of the same step, is 6.3e-5 of the leaf's max, and the two packages
# differ by up to 1.9e-4 over three seeded batches. Held to 4e-4; every
# other leaf of every model to GRAD_REL.
STACK_STAGE0_GUIDE_REL = 4e-4


def train_batch(cfg, seed, b=2, hw=(40, 56)):
  """A seeded uint8 batch: random frames and previews of n_in channels,
  the target clip(1.3 x) of the first three."""
  rng = np.random.RandomState(seed)
  s, c = cfg.net_input_size, cfg.n_in
  full = rng.randint(0, 256, (b, *hw, c)).astype(np.uint8)
  target = np.clip(full[..., :3].astype(np.float32) * 1.3, 0,
                   255).astype(np.uint8)
  low = rng.randint(0, 256, (b, s, s, c)).astype(np.uint8)
  return {'lowres_input': low, 'lowres_output': low[..., :3].copy(),
          'image_input': full, 'image_output': target}


def _stash_grads():
  """Passes the gradients on and keeps them as its state."""
  return optax.GradientTransformation(
      lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
      lambda updates, state, params=None: (updates, updates))


def check_one_train_step(name, guide_reg, guide_lr_scale):
  """One Adam step of the port against the JAX step (the tolerances in
  ``tests/test_torch_zoo_train.py``'s docstring)."""
  cfg = small_cfg(name)
  tc = TrainConfig(learning_rate=LR, guide_lr_scale=guide_lr_scale)
  batch = train_batch(cfg, 1)
  variables = flax_variables(name, perturb=False)

  tx = optax.chain(_stash_grads(), make_tx(tc))
  jstate = jax_step.TrainState(
      step=jnp.zeros((), jnp.int32), params=variables['params'],
      opt_state=tx.init(variables['params']),
      batch_stats=variables.get('batch_stats', {}),
      ema_loss=jnp.zeros(()), ema_psnr=jnp.zeros(()))
  jstep = jax.jit(jax_step.make_train_step(jax_make_model(cfg), tx,
                                           guide_reg=guide_reg))
  jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
  want_grads = convert_flax_variables({'params': jstate.opt_state[0]})
  want = convert_flax_variables({'params': jstate.params,
                                 'batch_stats': jstate.batch_stats})

  port = port_model(name, variables)
  state = step.create_state(port, loop.make_optimizer(port, tc))
  state, m = step.make_train_step(guide_reg=guide_reg)(
      state, step.to_device(batch, 'cpu'))

  # psnr also to 1e-5 dB: at init some models' outputs are far off
  # (psnr ~0.01 dB), where 1e-5 relative is below float32's resolution of
  # the loss it is the log of.
  for k in ('loss', 'psnr', 'ema_loss', 'ema_psnr'):
    np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                               atol=1e-5 if 'psnr' in k else 0.0, err_msg=k)
  params = dict(port.named_parameters())
  assert sorted(params) == sorted(want_grads)
  for key, p in params.items():
    g_want = want_grads[key].numpy()
    g_scale = float(np.abs(g_want).max())
    assert p.grad is not None, key
    rel = (STACK_STAGE0_GUIDE_REL if key.startswith('stage0.guide.')
           else GRAD_REL)
    np.testing.assert_allclose(p.grad.numpy(), g_want, rtol=0,
                               atol=rel * g_scale, err_msg=key)
    moved = np.abs(g_want) > 1e-5 * g_scale
    np.testing.assert_allclose(p.detach().numpy()[moved],
                               want[key].numpy()[moved], rtol=0,
                               atol=1e-2 * LR, err_msg=key)
  for key, buf in port.named_buffers():
    np.testing.assert_allclose(buf.numpy(), want[key].numpy(), atol=1e-6,
                               err_msg=key)
