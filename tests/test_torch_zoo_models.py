"""The extended zoo and the baselines of hdrnet_torch vs the Flax models on
the CPU: the registry, the forward and what each model sows, weight
conversion with batch norm on and off, dilated SAME convolutions, and
``bin/viz_activations.py``'s names.

The Flax variables (``tests/zoo_parity.py``) -> ``convert_flax_variables``
-> the port's module (strict ``load_state_dict``), fed the same
numpy-seeded inputs, at ``tests/test_models.py``'s small configuration. Forward 1e-4 (the
guide's depth coordinate amplifies a grid or guide difference about
gd-fold), as ``tests/test_torch_nn_models.py``.
"""

import functools

import numpy as np
import flax.linen as fnn
import jax
import jax.numpy as jnp
import pytest
import torch

from hdrnet_tpu.models import MODELS as JAX_MODELS
from hdrnet_tpu.models import make_model as jax_make_model

from hdrnet_torch.bin import viz_activations
from hdrnet_torch.convert import convert_flax_variables
from hdrnet_torch.models import MODELS, make_model
from hdrnet_torch.models.layers import ConvBlock

from zoo_parity import (ZOO, compare_intermediates, flax_variables, inputs,
                        port_model, small_cfg)

# The models with an NN guide, whose first conv has BN whatever
# batch_norm says (the reference's quirk).
NN_GUIDED = ('HDRNet3x3NNGuide', 'HDRNetStack', 'HDRNetFullresFeatures',
             'HDRNetFullresFeaturesMultiscale',
             'HDRNetFullresFeaturesWithGuide', 'HDRNetFeaturesPyrNN',
             'HDRNetFeaturesPyrNN2', 'HDRNetFeaturesPyrNN3',
             'StyleTransferNN')


def test_registry_has_the_jax_models():
  assert sorted(MODELS) == sorted(JAX_MODELS)
  assert len(MODELS) == 17
  assert sorted(set(MODELS) - set(ZOO)) == sorted(
      ['HDRNetCurves', 'HDRNetPointwiseNNGuide', 'HDRNetGaussianPyrNN'])


@pytest.mark.parametrize('name', ZOO)
def test_forward_and_intermediates_match_flax(name):
  """Eval-mode forward at 41x53 b=2 (odd extents: the pyramids' levels
  floor, 41x53 -> 20x26 -> 10x13), and every value the Flax model sows
  at top level: the grid, the guide maps, the feature towers' outputs
  (for the stack, each stage's under 'stage{s}'; the baselines sow
  nothing)."""
  cfg = small_cfg(name)
  variables = flax_variables(name)
  port = port_model(name, variables).eval()
  low, full = inputs(cfg)
  apply = jax.jit(functools.partial(jax_make_model(cfg).apply,
                                    mutable=['intermediates']))
  want, inter = apply(variables, jnp.asarray(low), jnp.asarray(full))
  with torch.no_grad():
    got, got_inter = port.forward_with_intermediates(
        torch.from_numpy(low), torch.from_numpy(full))
  assert got.shape == (2, 41, 53, 3)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                             atol=1e-4)
  compare_intermediates(got_inter, inter.get('intermediates', {}), 1e-4)


@pytest.mark.parametrize('batch_norm', [False, True])
@pytest.mark.parametrize('name', ZOO)
def test_convert_fills_every_parameter_and_buffer(name, batch_norm):
  """The Flax init's tree (names and shapes), converted, names exactly the
  port's state, shape for shape, with batch norm on and off (the NN
  guides' BN whatever it says)."""
  state = convert_flax_variables(flax_variables(name, batch_norm,
                                                perturb=False))
  want = make_model(small_cfg(name, batch_norm)).state_dict()
  assert sorted(state) == sorted(want)
  for k, v in want.items():
    assert state[k].shape == v.shape, k
  has_bn = any('.bn.' in k for k in want)
  assert has_bn == (batch_norm or name in NN_GUIDED)


def test_converted_names_of_the_new_modules():
  """A few names the converter maps with no new rule."""
  state = convert_flax_variables(flax_variables('HDRNetStack'))
  assert state['stage0.coefficients.prediction_conv.conv.weight'].ndim == 4
  state = convert_flax_variables(flax_variables('HDRNetFeaturesPyrNN2'))
  assert state['features_1.conv2.conv.weight'].shape == (4, 16, 3, 3)
  state = convert_flax_variables(
      flax_variables('HDRNetFeaturesPyrSimpleGuideNN'))
  assert state['guide_level_2.conv.conv.weight'].shape == (1, 3, 1, 1)
  state = convert_flax_variables(flax_variables('HDRNet3x3NNGuide'))
  assert state['guide.conv1.conv.weight'].shape == (4, 3, 3, 3)
  assert 'guide.conv1.bn.running_var' in state


class _FlaxConv(fnn.Module):
  features: int
  stride: int
  rate: int

  @fnn.compact
  def __call__(self, x):
    return fnn.Conv(self.features, (3, 3), strides=(self.stride,) * 2,
                    kernel_dilation=(self.rate,) * 2, padding='SAME',
                    precision='highest', name='conv')(x)


@pytest.mark.parametrize('stride', [1, 2])
@pytest.mark.parametrize('rate', [1, 2, 4, 16])
@pytest.mark.parametrize('hw', [(37, 20), (40, 23)])
def test_conv_block_dilated_same_matches_flax(hw, rate, stride):
  """ConvBlock(rate=r) pads as XLA's SAME: rate * (k - 1) in all, split
  low/high by the extent's parity at stride 2; odd and even extents, a
  rate whose span (33) exceeds the extent."""
  rng = np.random.RandomState(rate * 10 + stride)
  x = rng.rand(2, *hw, 3).astype(np.float32)
  flax_conv = _FlaxConv(5, stride, rate)
  params = flax_conv.init(jax.random.PRNGKey(rate), jnp.asarray(x))
  want = np.asarray(flax_conv.apply(params, jnp.asarray(x)))
  block = ConvBlock(3, 5, 3, stride=stride, rate=rate, activation=None)
  block.load_state_dict(convert_flax_variables(params))
  with torch.no_grad():
    got = block(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
  assert got.shape == want.shape
  np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize('name', ['UNet', 'DilatedConvolutions',
                                  'HDRNet3x3NNGuide', 'HDRNetStack',
                                  'HDRNetFullresFeaturesMultiscale',
                                  'HDRNetFeaturesPyrSimpleGuideNN'])
def test_capture_activations_match_flax(name):
  """``bin/viz_activations.py`` captures every rank-4 output under the
  names of Flax's ``capture_intermediates``: the real convs of the 3x3
  and simple guides, the feature towers, the stages, the dilated convs,
  and the sown feature maps; values within 1e-4 of each tensor's max."""
  cfg = small_cfg(name, batch_norm=name == 'UNet')
  variables = flax_variables(name, cfg.batch_norm)
  low, full = inputs(cfg, b=1, hw=(24, 34), seed=3)
  _, captured = jax_make_model(cfg).apply(
      variables, jnp.asarray(low), jnp.asarray(full),
      mutable=['intermediates'],
      capture_intermediates=lambda mdl, _: mdl.name is not None)
  want = {}
  for path, act in jax.tree_util.tree_flatten_with_path(
      captured['intermediates'])[0]:
    # (A stage's make_guide output, a Flax module, has no ndim.)
    if getattr(act, 'ndim', 0) == 4:
      key = '_'.join(getattr(k, 'key', str(k)) for k in path)
      want[key.replace('__call__', 'out').strip('_')] = np.asarray(act)
  port = port_model(name, variables, cfg.batch_norm).eval()
  got = viz_activations.capture_activations(
      port, torch.from_numpy(low), torch.from_numpy(full))
  assert sorted(got) == sorted(want)
  for key, act in want.items():
    scale = max(float(np.abs(act).max()), 1e-30)
    np.testing.assert_allclose(got[key], act, rtol=0, atol=1e-4 * scale,
                               err_msg=key)
