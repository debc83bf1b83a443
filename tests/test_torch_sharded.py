"""K7 (the fused kernel's band offset and total extent) and H-band
serving (``Enhancer.enhance_sharded``) of the port against the JAX
package on the CPU.

The plain K7 is held to the JAX fused kernel run in interpret mode with
the same offsets (``y_offset``, ``x_offset``, ``h_total``, ``w_total``)
at 2e-5, the JAX package's own tolerance for its sharded path
(``tests/test_parallel.py``); its bands concatenated must be the whole
frame's output bit for bit. ``enhance_sharded`` over four CPU "devices"
is held to the Flax model's ``apply`` at 2e-5 and must be bit-identical
to the port's unsharded ``__call__``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hdrnet_tpu.models import make_model as jax_make_model
from hdrnet_tpu.ops import pallas as pk

from hdrnet_torch.config import ModelConfig
from hdrnet_torch.convert import convert_flax_variables
from hdrnet_torch.inference import Enhancer
from hdrnet_torch.ops import _build, fused

TOL = 2e-5
MODELS = ['HDRNetCurves', 'HDRNetPointwiseNNGuide', 'HDRNetGaussianPyrNN']


def _guide_params(mode, rng, gc=6):
  """The JAX kernel's parameter tuple and the port's packed vector."""
  if mode == 'curves':
    ccm_ext = np.vstack([np.eye(3) + 0.2 * rng.randn(3, 3),
                         0.05 * rng.randn(1, 3)])
    shifts = np.tile(np.arange(16) / 16, (3, 1)) + 0.01 * rng.randn(3, 16)
    slopes = np.abs(rng.randn(3, 16)) * 0.3
    slopes[:, 0] = 1.0
    mix = np.vstack([np.full((3, 1), 1 / 3), [[0.02]]])
    jax_params = (ccm_ext, np.vstack([shifts, slopes]), mix)
    pack = fused.pack_curves_params
  else:
    jax_params = (0.8 * rng.randn(4, gc), 0.8 * rng.randn(gc + 1, 1))
    pack = fused.pack_nn_params
  jax_params = tuple(np.asarray(p, np.float32) for p in jax_params)
  return jax_params, pack(*jax_params)


def _inputs(seed, b, h_total, w_total, gh=8, gw=8, gd=4):
  rng = np.random.RandomState(seed)
  grid5 = 0.5 * rng.randn(b, gh, gw, gd, 12)
  for i in range(3):
    grid5[..., i * 4 + i] += 1.0
  frame = rng.rand(b, h_total, w_total, 3)
  return rng, grid5.astype(np.float32), frame.astype(np.float32)


def _jax_band(grid5, band, gparams, mode, **kw):
  out_cf = pk.enhance_fused(jnp.asarray(grid5),
                            jnp.asarray(band.transpose(0, 3, 1, 2)), gparams,
                            mode, 3, 3, True, interpret=True, **kw)
  return np.asarray(out_cf).transpose(0, 2, 3, 1)


@pytest.mark.parametrize('mode', ['curves', 'nn'])
def test_plain_k7_y_band_matches_jax(mode):
  """The third of four H-bands of a 64 x 96 frame."""
  rng, grid5, frame = _inputs(1, 1, 64, 96)
  gparams, packed = _guide_params(mode, rng)
  y0, h_local = 32, 16
  band = frame[:, y0:y0 + h_local]
  want = _jax_band(grid5, band, gparams, mode, y_offset=y0, h_total=64,
                   w_total=96)
  got = fused.enhance_fused(torch.from_numpy(grid5),
                            torch.from_numpy(np.ascontiguousarray(band)),
                            packed, mode, y_offset=y0, h_total=64)
  np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


@pytest.mark.parametrize('mode', ['curves', 'nn'])
def test_plain_k7_x_band_matches_jax(mode):
  """A column band: columns 128..255 of a 256-wide frame (a width the
  JAX sharded planner takes), rows 8..23 of 48."""
  rng, grid5, frame = _inputs(2, 1, 48, 256)
  gparams, packed = _guide_params(mode, rng)
  band = np.ascontiguousarray(frame[:, 8:24, 128:256])
  want = _jax_band(grid5, band, gparams, mode, y_offset=8, x_offset=128,
                   h_total=48, w_total=256)
  got = fused.enhance_fused(torch.from_numpy(grid5), torch.from_numpy(band),
                            packed, mode, y_offset=8, x_offset=128,
                            h_total=48, w_total=256)
  np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


@pytest.mark.parametrize('mode', ['curves', 'nn'])
@pytest.mark.parametrize('u8', [False, True])
def test_plain_k7_bands_are_the_whole_frame_bit_for_bit(mode, u8):
  """Four H-bands of two frames, and a 3 x 2 tiling, of an odd-sized
  frame: concatenated, the whole frame's output, bit for bit."""
  rng, grid5, frame = _inputs(3, 2, 60, 77)
  _, packed = _guide_params(mode, rng)
  grid = torch.from_numpy(grid5)
  x = torch.from_numpy(frame)
  kw = dict(clip_output=True)
  if u8:
    x = (x * 255).to(torch.uint8)
    kw['u8_output'] = True
  whole = fused.enhance_fused(grid, x, packed, mode, **kw)
  bands = [fused.enhance_fused(grid, x[:, y:y + 15].contiguous(), packed,
                               mode, y_offset=y, h_total=60, **kw)
           for y in range(0, 60, 15)]
  assert torch.equal(torch.cat(bands, 1), whole)
  rows = []
  for y in range(0, 60, 20):
    cols = [fused.enhance_fused(grid, x[:, y:y + 20, c:c + w].contiguous(),
                                packed, mode, y_offset=y, x_offset=c,
                                h_total=60, w_total=77, **kw)
            for c, w in ((0, 40), (40, 37))]
    rows.append(torch.cat(cols, 2))
  assert torch.equal(torch.cat(rows, 1), whole)


def test_k7_refuses_a_band_outside_the_frame():
  rng, grid5, frame = _inputs(4, 1, 16, 24)
  _, packed = _guide_params('curves', rng)
  grid, x = torch.from_numpy(grid5), torch.from_numpy(frame)
  for kw in (dict(y_offset=-1, h_total=32), dict(y_offset=17, h_total=32),
             dict(x_offset=4, w_total=24), dict(h_total=15)):
    with pytest.raises(ValueError, match='outside'):
      fused.enhance_fused(grid, x, packed, **kw)
  before = _build.launches.copy()
  fused.enhance_fused(grid, x, packed, y_offset=16, h_total=32)
  assert _build.launches == before  # the CPU: plain


def _cfg(name):
  return ModelConfig(model_name=name, net_input_size=64, spatial_bin=8,
                     luma_bins=4, guide_complexity=4)


@functools.lru_cache(maxsize=None)
def _models(name):
  """Flax model, its variables (BN statistics perturbed) and the port's
  Enhancer on the CPU with the converted weights."""
  cfg = _cfg(name)
  model = jax_make_model(cfg)
  init = jax.jit(functools.partial(model.init, train=True))
  variables = init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                   jnp.zeros((1, 16, 16, 3)))
  rng = np.random.RandomState(7)

  def perturb(path, x):
    x = np.array(x)
    names = [getattr(p, 'key', '') for p in path]
    if 'bn' not in names:
      return x
    if names[-1] == 'var':
      return rng.uniform(0.5, 2.0, x.shape).astype(np.float32)
    return (0.1 * rng.randn(*x.shape)).astype(np.float32)
  variables = jax.tree_util.tree_map_with_path(perturb, dict(variables))
  port = Enhancer(cfg, convert_flax_variables(variables), device='cpu')
  return model, variables, port


@pytest.mark.parametrize('name', MODELS)
def test_enhance_sharded_matches_flax_and_unsharded(name):
  model, variables, port = _models(name)
  rng = np.random.RandomState(5)
  lowres = rng.rand(1, 64, 64, 3).astype(np.float32)
  fullres = (1.2 * rng.rand(1, 128, 100, 3) - 0.1).astype(np.float32)
  want = np.asarray(jax.jit(model.apply)(variables, jnp.asarray(lowres),
                                         jnp.asarray(fullres)))
  got = port.enhance_sharded(lowres, fullres, ['cpu'] * 4, clip=False)
  assert got.shape == (1, 128, 100, 3) and got.device.type == 'cpu'
  np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
  whole = port.enhance_any(lowres, fullres, clip=False)
  assert torch.equal(got, whole)
  clipped = port.enhance_sharded(torch.from_numpy(lowres),
                                 torch.from_numpy(fullres), ['cpu'] * 2)
  assert torch.equal(clipped, port(torch.from_numpy(lowres),
                                   torch.from_numpy(fullres)))


@pytest.mark.parametrize('name', MODELS)
def test_enhance_sharded_checks_its_arguments(name):
  port = _models(name)[2]
  lowres = np.zeros((1, 64, 64, 3), np.float32)
  with pytest.raises(ValueError, match='divisible'):
    port.enhance_sharded(lowres, np.zeros((1, 4 * 4 + 2, 40, 3), np.float32),
                         ['cpu'] * 4)
  with pytest.raises(ValueError, match='all CUDA devices or all cpu'):
    port.enhance_sharded(lowres, np.zeros((1, 32, 40, 3), np.float32),
                         ['cpu', 'cuda:0'])
  with pytest.raises(ValueError, match='all CUDA devices or all cpu'):
    port.enhance_sharded(lowres, np.zeros((1, 32, 40, 3), np.float32), [])
