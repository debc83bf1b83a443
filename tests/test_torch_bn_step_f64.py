"""One training step with the backbone's batch norm on, the port vs the
JAX package, both in float64 on the CPU.

With ``batch_norm=True`` the backbone normalizes over a batch of two,
which is ill-conditioned for every HDRNet model alike: in float32 the two
packages agree only to ~7e-4 of a leaf's max gradient (the float32 tests
in ``tests/test_torch_train.py`` and ``tests/test_torch_nn_models.py``
run with it off). In float64 the rounding is ~1e-16, so any difference
above 1e-10 of a leaf's max is a difference of the computation itself.
JAX runs under ``jax.enable_x64(True)`` as a context (the
``jax.experimental.enable_x64()`` of older JAX), so the
other tests of the worker stay in float32.

Held to 1e-10 of each leaf's max: every gradient, every parameter after
one Adam step (but entries whose gradient is zero up to rounding, see
the test), the BN running statistics; the loss to 1e-12 relative.
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

REL = 1e-10


def _batch(seed, b=2, s=32, hw=64):
  """A float64 batch in [0, 1] (float batches pass through both
  packages' normalization)."""
  rng = np.random.RandomState(seed)
  full = rng.rand(b, hw, hw, 3)
  low = np.ascontiguousarray(full[:, ::hw // s, ::hw // s])
  target = np.clip(full * 1.3, 0.0, 1.0)
  return {'lowres_input': low, 'lowres_output': low, 'image_input': full,
          'image_output': target}


def _stash_grads():
  """Passes the gradients on and keeps them as its state."""
  return optax.GradientTransformation(
      lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
      lambda updates, state, params=None: (updates, updates))


def _f64(tree):
  """float64 leaves with float32 values: ``convert_flax_variables`` stores
  float32, so both packages start from the same numbers."""
  return jax.tree_util.tree_map(
      lambda x: np.asarray(x, np.float32).astype(np.float64), tree)


def _convert64(variables):
  """``convert_flax_variables`` in float64. The converter stores float32
  and only moves entries (transposes, renames), so each leaf is split
  into float32 parts hi + lo, converted, and summed back in float64:
  within ~2^-48 of the leaf, far below REL."""
  hi = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), variables)
  lo = jax.tree_util.tree_map(
      lambda x, h: np.asarray(np.asarray(x, np.float64) - h, np.float32),
      variables, hi)
  hi, lo = convert_flax_variables(hi), convert_flax_variables(lo)
  return {k: hi[k].double() + lo[k].double() for k in hi}


def _close(got, want, name):
  got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
  scale = max(float(np.abs(want).max()), 1e-300)
  np.testing.assert_allclose(got, want, rtol=0, atol=REL * scale,
                             err_msg=name)


@pytest.mark.parametrize('name,gc', [('HDRNetCurves', 16),
                                     ('HDRNetPointwiseNNGuide', 4)])
def test_bn_train_step_matches_jax_in_float64(name, gc):
  lr = 1e-3
  cfg = ModelConfig(model_name=name, net_input_size=32, spatial_bin=8,
                    luma_bins=4, guide_complexity=gc, batch_norm=True,
                    output_resolution=[64, 64])
  tc = TrainConfig(learning_rate=lr)
  batch = _batch(3)
  with jax.enable_x64(True):
    model = jax_make_model(cfg)
    init = jax.jit(functools.partial(model.init, train=True))
    variables = _f64(dict(init(jax.random.PRNGKey(0),
                               jnp.asarray(batch['lowres_input']),
                               jnp.asarray(batch['image_input']))))
    tx = optax.chain(_stash_grads(), make_tx(tc))
    jstate = jax_step.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables['params'],
        opt_state=tx.init(variables['params']),
        batch_stats=variables['batch_stats'],
        ema_loss=jnp.zeros((), jnp.float64),
        ema_psnr=jnp.zeros((), jnp.float64))
    jstep = jax.jit(jax_step.make_train_step(model, tx))
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    jstate, jm = jax.tree_util.tree_map(np.asarray, (jstate, jm))
  assert jm['loss'].dtype == np.float64
  want_grads = _convert64({'params': jstate.opt_state[0]})
  want = _convert64({'params': jstate.params,
                     'batch_stats': jstate.batch_stats})

  port = make_model(cfg)
  port.load_state_dict(convert_flax_variables(variables))
  port = port.double()
  state = step.create_state(port, loop.make_optimizer(port, tc))
  state, m = step.make_train_step()(state, step.to_device(batch, 'cpu'))

  assert m['loss'].dtype == torch.float64
  np.testing.assert_allclose(float(m['loss']), float(jm['loss']), rtol=1e-12)
  n_bn = 0
  init = _convert64({'params': variables['params']})
  for name_, p in port.named_parameters():
    assert p.dtype == torch.float64, name_
    g_want = want_grads[name_].numpy()
    _close(p.grad.numpy(), g_want, f'grad {name_}')
    # A gradient that is zero but for float64 rounding (a BN shift whose
    # effect the next BN removes) gets an Adam step of lr * g / (|g| +
    # eps) set by that rounding: each package must leave such an entry
    # within 1e-6 * lr of where it was, the others are held at REL.
    zero = np.abs(g_want) <= 1e-12 * np.abs(g_want).max()
    got, exp = p.detach().numpy(), want[name_].numpy()
    _close(got[~zero], exp[~zero], f'param {name_}')
    start = init[name_].numpy()[zero]
    for moved in (got[zero], exp[zero]):
      np.testing.assert_array_less(np.abs(moved - start), 1e-6 * lr)
  for name_, buf in port.named_buffers():
    if 'running' in name_:
      n_bn += name_.startswith('coefficients.')
      _close(buf.numpy(), want[name_].numpy(), name_)
  assert n_bn > 0  # the backbone's BN is on and its statistics moved
