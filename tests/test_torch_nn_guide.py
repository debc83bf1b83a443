"""The NN guide, kernel K6's plain version and the bilinear resize of
hdrnet_torch vs the JAX package on the CPU.

The same numpy-seeded inputs go through ``hdrnet_tpu`` (the Flax guide,
its Pallas fused kernel in NN mode in interpret mode, its resize) and
through the port's plain versions, which are what the port's wrappers run
on a CPU tensor. Tolerances: 1e-5 for the guide and the fused op in
float32 (the JAX package's own kernel gate; the serving guide folds the
batch norm into conv1, the Flax module does not, and the two differ in
float32 rounding only), 1e-6 for the resize (the same taps and blend in
another summation order), and for uint8 output at most 1 code on fewer
than 1% of values.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hdrnet_tpu.inference import _nn_guide_params
from hdrnet_tpu.models.guides import PointwiseNNGuide as JaxNNGuide
from hdrnet_tpu.ops import pallas as pk
from hdrnet_tpu.ops.resize import resize_bilinear as jax_resize_bilinear

from hdrnet_torch.convert import convert_flax_variables
from hdrnet_torch.models.guides import PointwiseNNGuide
from hdrnet_torch.ops import _build, fused, resize

ATOL = 1e-5


def _t(x):
  return torch.from_numpy(np.array(x))


def _flax_guide(gc, seed, conv2_bias=0.0):
  """Flax PointwiseNNGuide variables with non-trivial BN statistics and
  shift, and a conv2 bias (a large one saturates the sigmoid)."""
  rng = np.random.RandomState(seed)
  module = JaxNNGuide(gc)
  variables = module.init(jax.random.PRNGKey(seed),
                          jnp.zeros((1, 4, 4, 3), jnp.float32))
  variables = jax.tree_util.tree_map(np.array, dict(variables))
  bn = variables['params']['conv1']['bn']
  bn['bias'] = (0.2 * rng.randn(gc)).astype(np.float32)
  stats = variables['batch_stats']['conv1']['bn']
  stats['mean'] = (0.3 * rng.randn(gc)).astype(np.float32)
  stats['var'] = rng.uniform(0.2, 2.0, gc).astype(np.float32)
  variables['params']['conv2']['conv']['bias'] = np.full(
      (1,), conv2_bias, np.float32)
  return module, variables


def _port_guide(gc, variables):
  guide = PointwiseNNGuide(3, gc)
  guide.load_state_dict(convert_flax_variables(variables))
  return guide.eval()


@pytest.mark.parametrize('gc', [4, 16])
def test_nn_guide_matches_flax(gc):
  """The plain guide from the folded serving parameters, and the module's
  own forward (BN unfolded, eval mode), against the Flax module."""
  module, variables = _flax_guide(gc, seed=gc)
  img = np.random.RandomState(1).rand(2, 23, 37, 3).astype(np.float32)
  want = np.asarray(module.apply(variables, jnp.asarray(img)))
  port = _port_guide(gc, variables)
  w1_ext, w2_ext = _nn_guide_params(variables['params'],
                                    variables['batch_stats'], 3)
  plain = fused.nn_guide(_t(img), _t(w1_ext), _t(w2_ext).reshape(-1))
  np.testing.assert_allclose(plain.numpy(), want, atol=ATOL)
  with torch.no_grad():
    got = port(_t(img))
  assert got.shape == (2, 23, 37)
  np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_packed_nn_params_match_jax_fold():
  _, variables = _flax_guide(16, seed=3)
  want = _nn_guide_params(variables['params'], variables['batch_stats'], 3)
  got = _port_guide(16, variables).packed_params()
  assert got.shape == (5 * 16 + 1,) and got.dtype == torch.float32
  np.testing.assert_allclose(
      got.numpy(), fused.pack_nn_params(*map(np.array, want)).numpy(),
      rtol=1e-6, atol=1e-7)


def _nn_inputs(seed, b, h, w, gc, u8=False, conv2_bias=0.0):
  rng = np.random.RandomState(seed)
  grid5 = (0.5 * rng.randn(b, 8, 8, 4, 12)).astype(np.float32)
  for i in range(3):  # near-identity affine, so clipping is not total
    grid5[..., i * 4 + i] += 1.0
  if u8:
    frame = rng.randint(0, 256, (b, h, w, 3)).astype(np.uint8)
  else:
    frame = rng.rand(b, h, w, 3).astype(np.float32)
  _, variables = _flax_guide(gc, seed, conv2_bias)
  gparams = _nn_guide_params(variables['params'], variables['batch_stats'],
                             3)
  return grid5, frame, tuple(np.array(p) for p in gparams)


def _jax_enhance_nn(grid5, frame, gparams, **kw):
  out_cf = pk.enhance_fused(jnp.asarray(grid5),
                            jnp.asarray(frame.transpose(0, 3, 1, 2)),
                            gparams, 'nn', 3, 3, True, interpret=True, **kw)
  return np.asarray(out_cf).transpose(0, 2, 3, 1)


@pytest.mark.parametrize('gc,clip,conv2_bias', [
    (4, False, 0.0), (16, True, 0.0), (4, False, 12.0), (16, False, -12.0)])
def test_enhance_fused_nn_plain_matches_jax_f32(gc, clip, conv2_bias):
  """Clip off and on; a strongly biased conv2 saturates the sigmoid and
  puts the depth taps at the grid's extremes."""
  grid5, frame, gparams = _nn_inputs(gc, 2, 32, 136, gc,
                                     conv2_bias=conv2_bias)
  want = _jax_enhance_nn(grid5, frame, gparams, clip_output=clip)
  got = fused.enhance_fused(_t(grid5), _t(frame),
                            fused.pack_nn_params(*gparams), 'nn',
                            clip_output=clip)
  assert got.dtype == torch.float32 and got.shape == frame.shape
  np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
  if clip:
    assert got.min() >= 0 and got.max() <= 1
  if conv2_bias:
    guide = fused.nn_guide(_t(frame), _t(gparams[0]), _t(gparams[1]))
    assert float((guide - float(conv2_bias > 0)).abs().max()) < 1e-3


def test_enhance_fused_nn_plain_matches_jax_u8():
  grid5, frame, gparams = _nn_inputs(5, 1, 64, 136, 16, u8=True)
  want = _jax_enhance_nn(grid5, frame, gparams, clip_output=True,
                         u8_output=True)
  got = fused.enhance_fused(_t(grid5), _t(frame),
                            fused.pack_nn_params(*gparams), 'nn',
                            clip_output=True, u8_output=True)
  assert got.dtype == torch.uint8 and want.dtype == np.uint8
  diff = got.numpy().astype(int) - want.astype(int)
  assert np.abs(diff).max() <= 1
  assert (diff != 0).mean() < 0.01


def test_enhance_fused_nn_checks_its_parameters():
  grid5, frame, gparams = _nn_inputs(6, 1, 12, 16, 4)
  params = fused.pack_nn_params(*gparams)
  grid5, frame = _t(grid5), _t(frame)
  with pytest.raises(ValueError, match='guide_mode'):
    fused.enhance_fused(grid5, frame, params, 'linear')
  with pytest.raises(ValueError, match='gc'):  # 21 - 1 is not 5 * gc
    fused.enhance_fused(grid5, frame, params[:-1], 'nn')
  big = torch.zeros(5 * (fused.MAX_GUIDE_COMPLEXITY + 1) + 1)
  with pytest.raises(ValueError, match='complexity'):
    fused.enhance_fused(grid5, frame, big, 'nn')
  with pytest.raises(ValueError, match='curves'):  # an NN vector as curves
    fused.enhance_fused(grid5, frame, params, 'curves')
  with pytest.raises(ValueError, match='w2_ext'):
    fused.pack_nn_params(gparams[0], gparams[1][:-1])


def test_cpu_nn_wrapper_does_not_launch():
  grid5, frame, gparams = _nn_inputs(7, 1, 20, 24, 4)
  before = _build.launches.copy()
  fused.enhance_fused(_t(grid5), _t(frame), fused.pack_nn_params(*gparams),
                      'nn')
  assert _build.launches == before


@pytest.mark.parametrize('align_corners', [False, True])
@pytest.mark.parametrize('size,out', [((37, 53), (16, 24)),
                                      ((101, 60), (50, 30)),
                                      ((24, 32), (48, 64)),
                                      ((7, 9), (1, 1))])
def test_resize_bilinear_matches_jax(size, out, align_corners):
  """Down (101 -> 50 floors an odd extent, as the pyramid does), up (the
  coarse-to-fine upsample), and to a single pixel."""
  x = np.random.RandomState(9).rand(2, *size, 3).astype(np.float32)
  want = jax_resize_bilinear(jnp.asarray(x), out, align_corners=align_corners)
  got = resize.resize_bilinear(_t(x), out, align_corners=align_corners)
  assert got.shape == (2, *out, 3)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize('size,out,align_corners', [
    ((21, 30), (10, 15), True), ((10, 15), (21, 31), True),
    ((24, 32), (48, 64), False)])
def test_resize_bilinear_gradient_matches_jax(size, out, align_corners):
  """The fixed-order gather backward (several outputs read each input
  when upsampling) against JAX's scatter-add."""
  x = np.random.RandomState(10).rand(1, *size, 3).astype(np.float32)
  probe = np.random.RandomState(11).randn(1, *out, 3).astype(np.float32)
  want = jax.grad(lambda v: jnp.vdot(jax_resize_bilinear(
      v, out, align_corners=align_corners), probe))(jnp.asarray(x))
  xt = _t(x).requires_grad_()
  (resize.resize_bilinear(xt, out, align_corners=align_corners)
   * _t(probe)).sum().backward()
  np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), atol=1e-6)
