"""hdrnet_torch Enhancer vs the JAX Enhancer on the CPU.

The JAX Enhancer runs its Pallas kernels in interpret mode; the port's
runs the plain versions of its kernels (the tensors lie on the CPU).
``process`` must agree to 1e-4; the uint8 stream to 1 code on fewer
than 1% of values, in order.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hdrnet_tpu.config import ModelConfig
from hdrnet_tpu.inference import Enhancer as JaxEnhancer
from hdrnet_tpu.models import make_model as jax_make_model

from hdrnet_torch.convert import convert_flax_variables
from hdrnet_torch.inference import Enhancer
from hdrnet_torch.ops import _build, downsample


@pytest.fixture(scope='module')
def enhancers():
  cfg = ModelConfig(net_input_size=64, spatial_bin=8, luma_bins=4)
  rng = np.random.RandomState(0)
  lowres = jnp.asarray(rng.rand(1, 64, 64, 3), jnp.float32)
  fullres = jnp.asarray(rng.rand(1, 96, 128, 3), jnp.float32)
  variables = jax_make_model(cfg).init(jax.random.PRNGKey(0), lowres,
                                       fullres, train=True)
  variables = jax.tree_util.tree_map(np.array, dict(variables))
  jax_enh = JaxEnhancer(config=cfg, variables=variables, interpret=True)
  port = Enhancer(cfg, convert_flax_variables(variables), device='cpu')
  return jax_enh, port


def test_process_matches_jax(enhancers):
  jax_enh, port = enhancers
  frame = np.random.RandomState(1).rand(1, 96, 128, 3).astype(np.float32)
  want = np.asarray(jax_enh.process(jnp.asarray(frame)))
  got = port.process(torch.from_numpy(frame))
  assert got.shape == (1, 96, 128, 3) and got.dtype == torch.float32
  np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
  assert got.min() >= 0 and got.max() <= 1


def test_call_with_preview_matches_jax(enhancers):
  jax_enh, port = enhancers
  rng = np.random.RandomState(2)
  lowres = rng.rand(1, 64, 64, 3).astype(np.float32)
  fullres = rng.rand(1, 96, 128, 3).astype(np.float32)
  want = np.asarray(jax_enh(jnp.asarray(lowres), jnp.asarray(fullres),
                            clip=False))
  got = port(torch.from_numpy(lowres), torch.from_numpy(fullres), clip=False)
  np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_stream_matches_jax_and_keeps_order(enhancers):
  jax_enh, port = enhancers
  rng = np.random.RandomState(3)
  frames = [(rng.rand(1, 96, 128, 3) * 255).astype(np.uint8)
            for _ in range(5)]
  for i, f in enumerate(frames):  # tag each frame: order mistakes show
    f[0, :8, :8, :] = i * 50
  outs = list(port.stream(iter(frames), depth=2))
  assert len(outs) == 5
  fn = jax_enh.make_stream_fn((1, 96, 128, 3))
  for f, got in zip(frames, outs):
    assert got.dtype == np.uint8 and got.shape == f.shape
    want = np.asarray(fn(jnp.asarray(f)))
    diff = got.astype(int) - want.astype(int)
    assert np.abs(diff).max() <= 1
    assert (diff != 0).mean() < 0.01


def test_stream_fn_checks_its_input(enhancers):
  _, port = enhancers
  fn = port.make_stream_fn((1, 96, 128, 3))
  with pytest.raises(ValueError, match='uint8'):
    fn(torch.zeros((1, 96, 128, 3)))
  with pytest.raises(TypeError, match='uint8'):
    list(port.stream([np.zeros((1, 8, 8, 3), np.float32)]))


def test_cpu_serving_launches_no_kernel(enhancers):
  _, port = enhancers
  before = _build.launches.copy()
  frame = torch.rand(2, 40, 56, 3)
  port.process(frame)
  list(port.stream([(np.random.rand(1, 40, 56, 3) * 255).astype(np.uint8)]))
  assert _build.launches == before


def test_enhancer_serves_only_curves():
  """The fused route is taken for the three HDRNet classes only; every
  other model, such as the UNet baseline (refused before the port had
  it), is served by the composite route: K2's preview, the model's
  forward, the clip."""
  from hdrnet_torch.config import ModelConfig as PortModelConfig
  from hdrnet_torch.models import MODELS
  small = dict(net_input_size=64, spatial_bin=8, luma_bins=4,
               guide_complexity=4, depth=3, width=8)
  fused_names = {'HDRNetCurves', 'HDRNetPointwiseNNGuide',
                 'HDRNetGaussianPyrNN'}
  for name in MODELS:
    n_in = 6 if name.startswith('StyleTransfer') else 3
    enh = Enhancer(PortModelConfig(model_name=name, n_in=n_in, **small),
                   device='cpu')
    assert enh.fused == (name in fused_names), name
  unet = Enhancer(PortModelConfig(model_name='UNet', **small), device='cpu')
  frame = torch.rand(1, 40, 56, 3)
  before = _build.launches.copy()
  got = unet.process(frame)
  with torch.no_grad():
    want = torch.clamp(unet.model(
        downsample.nearest_lowres_plain(frame, 64).permute(0, 2, 3, 1),
        frame), 0.0, 1.0)
  assert torch.equal(got, want) and _build.launches == before
