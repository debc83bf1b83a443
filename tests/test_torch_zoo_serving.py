"""Serving the extended zoo and the baselines on the CPU: the port's
Enhancer against the JAX Enhancer on every new model (the route choice,
the bfloat16 backbone and the tools are in
``tests/test_torch_zoo_tools.py``).

Off the TPU the JAX Enhancer serves every model by its composite route
(``model.apply`` and a clip, ``hdrnet_tpu/inference.py``'s
``_fusable``); so does the port's for every model but the three of the
fused route. ``process`` and ``__call__`` are held to 1e-4, the uint8
stream to 1 code on fewer than 1% of values, in order, as in
``tests/test_torch_inference.py``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hdrnet_tpu.inference import Enhancer as JaxEnhancer
from hdrnet_tpu.ops.resize import resize_nearest as jax_resize_nearest

from hdrnet_torch.convert import convert_flax_variables
from hdrnet_torch.inference import Enhancer

from zoo_parity import ZOO, flax_variables, port_cfg, small_cfg


def _u8_check(got, want):
  diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
  assert diff.max() <= 1 and (diff != 0).mean() < 0.01, (diff.max(),
                                                         (diff != 0).mean())


def _enhancers(name):
  cfg = port_cfg(name)
  variables = flax_variables(name)
  jax_enh = JaxEnhancer(config=small_cfg(name), variables=variables)
  port = Enhancer(cfg, convert_flax_variables(variables), device='cpu')
  return cfg, jax_enh, port


@pytest.mark.parametrize('name', ZOO)
def test_composite_serving_matches_jax(name):
  """``process`` and ``__call__`` (f32) and ``stream`` (u8, two frames
  in order) against the JAX Enhancer's composite route; the port takes
  its composite route too. ``__call__`` is held to the JAX ``process``
  with the same nearest preview, which is what that ``process`` runs."""
  cfg, jax_enh, port = _enhancers(name)
  assert not jax_enh.use_fused and not port.fused
  rng = np.random.RandomState(5)
  c = cfg.n_in
  frame = rng.rand(1, 41, 53, c).astype(np.float32)
  want = np.asarray(jax_enh.process(jnp.asarray(frame)))
  got = port.process(torch.from_numpy(frame))
  assert got.shape == (1, 41, 53, 3)
  np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
  low = np.array(jax_resize_nearest(jnp.asarray(frame), (64, 64)))
  got = port(torch.from_numpy(low), torch.from_numpy(frame))
  np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
  assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0

  frames = [rng.randint(0, 256, (1, 41, 53, c)).astype(np.uint8)
            for _ in range(2)]
  frames[1][0, :8, :8] = 200  # a tagged frame: an order mistake shows
  wants = list(jax_enh.stream(frames))
  gots = list(port.stream(frames))
  assert len(gots) == 2
  for g, w in zip(gots, wants):
    assert g.dtype == np.uint8 and g.shape == (1, 41, 53, 3)
    _u8_check(g, w)
