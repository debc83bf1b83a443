"""hdrnet_torch model vs the Flax model on the CPU.

Flax ``model.init`` -> ``convert_flax_variables`` -> the port's module,
fed the same numpy-seeded inputs. The backbone grid alone must agree to
1e-5 and the composite forward to 1e-4 (the guide's depth coordinate
amplifies a grid or guide difference about gd-fold).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hdrnet_tpu.config import ModelConfig
from hdrnet_tpu.inference import _curves_guide_params
from hdrnet_tpu.models import make_model as jax_make_model
from hdrnet_tpu.models.hdrnet import CoefficientBackbone as JaxBackbone

from hdrnet_torch.convert import convert_flax_variables
from hdrnet_torch.models import make_model
from hdrnet_torch.ops.fused import pack_curves_params

SMALL = dict(net_input_size=64, spatial_bin=8, luma_bins=4)


def _perturb_bn(variables, rng):
  """Random BN shifts and running stats, so BN is actually exercised."""
  def perturb(path, x):
    names = [getattr(p, 'key', '') for p in path]
    if 'bn' not in names:
      return x
    x = np.asarray(x)
    if names[-1] == 'var':
      return rng.uniform(0.5, 2.0, x.shape).astype(np.float32)
    return (0.1 * rng.randn(*x.shape)).astype(np.float32)
  return jax.tree_util.tree_map_with_path(perturb, variables)


def _flax_and_port(cfg, low_hw, full_hw, seed=0):
  rng = np.random.RandomState(seed)
  lowres = rng.rand(1, *low_hw, 3).astype(np.float32)
  fullres = rng.rand(1, *full_hw, 3).astype(np.float32)
  jax_model = jax_make_model(cfg)
  variables = jax_model.init(jax.random.PRNGKey(seed), jnp.asarray(lowres),
                             jnp.asarray(fullres), train=True)
  variables = jax.tree_util.tree_map(np.asarray, dict(variables))
  if cfg.batch_norm:
    variables = _perturb_bn(variables, rng)
  port = make_model(cfg)
  port.load_state_dict(convert_flax_variables(variables))
  port.eval()
  return jax_model, variables, port, lowres, fullres


@pytest.mark.parametrize('batch_norm', [False, True])
def test_forward_matches_flax(batch_norm):
  cfg = ModelConfig(batch_norm=batch_norm, **SMALL)
  jax_model, variables, port, lowres, fullres = _flax_and_port(
      cfg, (64, 64), (96, 128))
  want = jax_model.apply(variables, jnp.asarray(lowres),
                         jnp.asarray(fullres))
  with torch.no_grad():
    got = port(torch.from_numpy(lowres), torch.from_numpy(fullres))
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize('batch_norm', [False, True])
def test_backbone_grid_matches_flax(batch_norm):
  cfg = ModelConfig(batch_norm=batch_norm, **SMALL)
  _, variables, port, lowres, _ = _flax_and_port(cfg, (64, 64), (32, 32),
                                                 seed=1)
  bb_vars = {'params': variables['params']['coefficients']}
  if batch_norm:
    bb_vars['batch_stats'] = variables['batch_stats']['coefficients']
  want = JaxBackbone(cfg, 3, 4).apply(bb_vars, jnp.asarray(lowres))
  with torch.no_grad():
    got = port.coefficients(torch.from_numpy(lowres).permute(0, 3, 1, 2))
  assert got.shape == want.shape == (1, 8, 8, 4, 3, 4)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_default_config_forward_matches_flax():
  """Full default widths (256^2 preview, l8/s16, 4x4 global map)."""
  cfg = ModelConfig()
  jax_model, variables, port, lowres, fullres = _flax_and_port(
      cfg, (256, 256), (128, 192), seed=2)
  want = jax_model.apply(variables, jnp.asarray(lowres),
                         jnp.asarray(fullres))
  with torch.no_grad():
    got = port(torch.from_numpy(lowres), torch.from_numpy(fullres))
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize('size,stride', [(8, 2), (9, 2), (7, 1)])
def test_conv_block_same_padding_matches_flax(size, stride):
  """XLA's SAME: (0, 1) for a stride-2 3x3 conv on an even extent, (1, 1)
  on an odd one and at stride 1."""
  from hdrnet_tpu.models.layers import ConvBlock as JaxConvBlock
  from hdrnet_torch.models.layers import ConvBlock
  x = np.random.RandomState(4).rand(2, size, size + 1, 3).astype(np.float32)
  block = JaxConvBlock(5, 3, stride=stride)
  variables = block.init(jax.random.PRNGKey(4), jnp.asarray(x))
  variables = jax.tree_util.tree_map(np.array, dict(variables))
  variables['params']['conv']['bias'] = np.linspace(-1, 1, 5, dtype=np.float32)
  want = block.apply(variables, jnp.asarray(x))
  port = ConvBlock(3, 5, 3, stride=stride)
  port.load_state_dict(convert_flax_variables(variables))
  with torch.no_grad():
    got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
  assert got.shape == want.shape
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_packed_guide_params_match_jax_packing():
  cfg = ModelConfig(**SMALL)
  _, variables, port, _, _ = _flax_and_port(cfg, (64, 64), (16, 16))
  want = _curves_guide_params(variables['params']['guide'], 3)
  np.testing.assert_array_equal(port.guide.packed_params().numpy(),
                                pack_curves_params(*map(np.array, want)))


def test_seeded_init_is_reproducible_and_near_identity():
  cfg = ModelConfig(**SMALL)
  a = make_model(cfg, generator=torch.Generator().manual_seed(3))
  b = make_model(cfg, generator=torch.Generator().manual_seed(3))
  for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
    torch.testing.assert_close(pa, pb, rtol=0, atol=0, msg=name)
  ccm = a.guide.ccm.detach()
  assert torch.allclose(ccm, torch.eye(3), atol=1e-3)
  noise = ccm - torch.eye(3)  # one shared perturbation
  torch.testing.assert_close(noise, noise[0, 1].expand(3, 3), rtol=0,
                             atol=1e-7)
  assert float(noise[0, 1]) != 0.0
  w = a.coefficients.splat_conv1.conv.weight.detach()
  std = (2.0 / (3 * 3 * 3)) ** 0.5 / 0.87962566103423978
  assert float(w.abs().max()) <= 2 * std


def test_convert_rejects_mismatched_tree():
  cfg = ModelConfig(batch_norm=True, **SMALL)
  _, variables, _, _, _ = _flax_and_port(cfg, (64, 64), (16, 16))
  port = make_model(ModelConfig(**SMALL))  # built without BN
  with pytest.raises(RuntimeError):
    port.load_state_dict(convert_flax_variables(variables))
