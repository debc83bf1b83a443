"""hdrnet_torch's Enhancer for HDRNetPointwiseNNGuide and
HDRNetGaussianPyrNN vs the JAX Enhancer on the CPU.

The JAX Enhancer runs its Pallas kernels in interpret mode; the port's
runs the plain versions of its kernels (the tensors lie on the CPU): K2
and K6 for the NN-guide model; K2, the bilinear pyramid and one K6 a
level for the pyramid. Both fold the guides' batch norm into conv1, whose
statistics are perturbed here so that the fold is exercised. ``__call__``
and ``process`` must agree to 1e-4; the uint8 stream to 1 code on fewer
than 1% of values, in order; the pyramid also to 2e-5 against the Flax
model's ``apply`` plus clip (``tests/test_inference.py``'s gate for the
JAX package's own fused pyramid).
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hdrnet_tpu.config import Config, ModelConfig, TrainConfig
from hdrnet_tpu.inference import Enhancer as JaxEnhancer
from hdrnet_tpu.models import make_model as jax_make_model

from hdrnet_torch.convert import convert_flax_variables
from hdrnet_torch.inference import Enhancer
from hdrnet_torch.ops import downsample, fused
from hdrnet_torch.training import loop, step
from hdrnet_torch.training.checkpoint import Checkpointer

NN, PYR = 'HDRNetPointwiseNNGuide', 'HDRNetGaussianPyrNN'
HW = (96, 128)


def _cfg(name):
  return ModelConfig(model_name=name, net_input_size=64, spatial_bin=8,
                     luma_bins=4, guide_complexity=4)


def _perturbed_variables(cfg, seed=0):
  """Flax variables (jitted init) with random BN shifts and statistics."""
  rng = np.random.RandomState(seed)
  model = jax_make_model(cfg)
  init = jax.jit(functools.partial(model.init, train=True))
  variables = init(jax.random.PRNGKey(seed), jnp.zeros((1, 64, 64, 3)),
                   jnp.zeros((1, 16, 16, 3)))

  def perturb(path, x):
    x = np.array(x)
    names = [getattr(p, 'key', '') for p in path]
    if 'bn' not in names:
      return x
    if names[-1] == 'var':
      return rng.uniform(0.5, 2.0, x.shape).astype(np.float32)
    return (0.1 * rng.randn(*x.shape)).astype(np.float32)
  return model, jax.tree_util.tree_map_with_path(perturb, dict(variables))


_ENHANCERS = {}


def _enhancers(name):
  """(Flax model, variables, JAX Enhancer, port Enhancer), built once per
  model for this module."""
  if name not in _ENHANCERS:
    cfg = _cfg(name)
    model, variables = _perturbed_variables(cfg)
    jax_enh = JaxEnhancer(config=cfg, variables=variables, interpret=True)
    port = Enhancer(cfg, convert_flax_variables(variables), device='cpu')
    _ENHANCERS[name] = (model, variables, jax_enh, port)
  return _ENHANCERS[name]


@pytest.mark.parametrize('name', [NN, PYR])
def test_call_with_preview_matches_jax(name):
  _, _, jax_enh, port = _enhancers(name)
  rng = np.random.RandomState(2)
  lowres = rng.rand(1, 64, 64, 3).astype(np.float32)
  fullres = rng.rand(1, *HW, 3).astype(np.float32)
  want = np.asarray(jax_enh(jnp.asarray(lowres), jnp.asarray(fullres),
                            clip=False))
  got = port(torch.from_numpy(lowres), torch.from_numpy(fullres), clip=False)
  assert got.shape == (1, *HW, 3)
  np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


@pytest.mark.parametrize('name', [NN, PYR])
def test_process_matches_jax(name):
  _, _, jax_enh, port = _enhancers(name)
  frame = np.random.RandomState(1).rand(1, *HW, 3).astype(np.float32)
  want = np.asarray(jax_enh.process(jnp.asarray(frame)))
  got = port.process(torch.from_numpy(frame))
  assert got.shape == (1, *HW, 3) and got.dtype == torch.float32
  np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
  assert got.min() >= 0 and got.max() <= 1


@pytest.mark.parametrize('clip', [False, True])
def test_pyramid_matches_model_apply(clip):
  """Levels summed before one clip: clip=False is the raw sum."""
  model, variables, _, port = _enhancers(PYR)
  rng = np.random.RandomState(3)
  lowres = rng.rand(1, 64, 64, 3).astype(np.float32)
  fullres = (1.4 * rng.rand(1, 101, 60, 3) - 0.2).astype(np.float32)
  want = jax.jit(model.apply)(variables, jnp.asarray(lowres),
                              jnp.asarray(fullres))
  if clip:
    want = jnp.clip(want, 0.0, 1.0)
  else:
    assert float(jnp.max(want)) > 1 or float(jnp.min(want)) < 0
  got = port(torch.from_numpy(lowres), torch.from_numpy(fullres), clip=clip)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize('name', [NN, PYR])
def test_stream_matches_jax_and_keeps_order(name):
  _, _, jax_enh, port = _enhancers(name)
  rng = np.random.RandomState(4)
  frames = [(rng.rand(1, *HW, 3) * 255).astype(np.uint8) for _ in range(3)]
  for i, f in enumerate(frames):  # tag each frame: order mistakes show
    f[0, :8, :8, :] = i * 80
  outs = list(port.stream(iter(frames), depth=2))
  assert len(outs) == 3
  fn = jax_enh.make_stream_fn((1, *HW, 3))
  for f, got in zip(frames, outs):
    assert got.dtype == np.uint8 and got.shape == f.shape
    want = np.asarray(fn(jnp.asarray(f)))
    diff = got.astype(int) - want.astype(int)
    assert np.abs(diff).max() <= 1
    assert (diff != 0).mean() < 0.01


@pytest.mark.parametrize('name', [NN, PYR])
def test_cpu_serving_launches_no_kernel(name):
  port = _enhancers(name)[3]
  counts = (fused.launches, fused.nn_launches, downsample.launches)
  port.process(torch.rand(2, 40, 56, 3))
  list(port.stream([(np.random.rand(1, 40, 56, 3) * 255).astype(np.uint8)]))
  assert (fused.launches, fused.nn_launches, downsample.launches) == counts


@pytest.mark.parametrize('name', ['HDRNetCurves', NN, PYR])
def test_from_checkpoint_serves_every_model(name, tmp_path):
  """A trained step of each model, saved by the port's Checkpointer and
  served by ``Enhancer.from_checkpoint`` as the model itself serves."""
  cfg = Config(model=_cfg(name), train=TrainConfig(learning_rate=1e-3))
  port = Enhancer(cfg.model, seed=5).model
  state = step.create_state(port, loop.make_optimizer(port, cfg.train))
  rng = np.random.RandomState(6)
  batch = {'lowres_input': rng.randint(0, 256, (2, 64, 64, 3)),
           'image_input': rng.randint(0, 256, (2, 48, 40, 3)),
           'image_output': rng.randint(0, 256, (2, 48, 40, 3))}
  batch = {k: v.astype(np.uint8) for k, v in batch.items()}
  state, _ = step.make_train_step()(state, step.to_device(batch, 'cpu'))
  cfg.save(str(tmp_path))
  Checkpointer(str(tmp_path)).save(state.step, state)

  enh = Enhancer.from_checkpoint(str(tmp_path))
  assert type(enh.model) is type(port)
  frame = torch.rand(1, 70, 90, 3)
  low = downsample.nearest_lowres_plain(frame, 64).permute(0, 2, 3, 1)
  with torch.no_grad():
    want = torch.clamp(state.model.eval()(low, frame), 0, 1)
  np.testing.assert_allclose(enh.process(frame).numpy(), want.numpy(),
                             atol=1e-4)
