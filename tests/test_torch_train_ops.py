"""The port's slice-apply gradients vs the JAX package on the CPU.

The same numpy-seeded inputs go through ``hdrnet_tpu`` (its reference
VJPs under ``jax.vmap``, its Pallas kernels in interpret mode, ``jax.grad``
through its custom VJP) and through the port's plain versions, which are
what the port's wrappers run on CPU tensors.

Tolerances: 1e-5 of max(1, the largest value) for the grid, guide and
input cotangents (the JAX package's VJP gate, scaled): the grid
cotangent sums hundreds of splats to values near 17, in an order that
depends on the host's vector width, and the guide cotangent carries a
factor gd and reaches a few hundred on these inputs. The
plain kernels are held to JAX's interpret-mode kernels at the JAX
package's own kernel gates (2e-4 of the largest value for the grid
cotangent, 1e-4 otherwise). The finite-difference checks are float64 with
the JAX package's tolerances (tests/test_reference_ops.py): the grid VJP
is the reference op's mirror-pad approximation and the guide VJP is
eps-smoothed, so neither is an elementwise derivative of the forward.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hdrnet_tpu.ops import bilateral_slice as jax_slice
from hdrnet_tpu.ops import bilateral_slice_apply as jax_slice_apply
from hdrnet_tpu.ops import pallas as pk
from hdrnet_tpu.ops import reference as jref

from hdrnet_torch.ops import reference as tref
from hdrnet_torch.ops import slice_apply as sa
from hdrnet_torch.ops import slice_ops

ATOL = 1e-5


def _t(x):
  return torch.from_numpy(np.asarray(x))


def _close_scaled(got, want, rel):
  want = np.asarray(want)
  scale = max(1.0, float(np.abs(want).max()))
  np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=rel * scale)


def _inputs(seed, b, gh, gw, gd, no, ni, h, w, lo=-0.1, hi=1.1):
  """Grid, guide in [lo, hi] with rows pinned at exactly 0 and 1, image,
  cotangent."""
  rng = np.random.RandomState(seed)
  grid = rng.randn(b, gh, gw, gd, no, ni + 1).astype(np.float32)
  guide = (lo + (hi - lo) * rng.rand(b, h, w)).astype(np.float32)
  guide[0, :2] = 0.0
  guide[0, 2:4] = 1.0
  image = rng.rand(b, h, w, ni).astype(np.float32)
  ct = rng.randn(b, h, w, no).astype(np.float32)
  return grid, guide, image, ct


VJP_CASES = [
    # (b, gh, gw, gd, no, ni, h, w): the JAX package's kernel-gate
    # geometries, an odd frame against a 10x6 grid, and n_in = 0.
    (1, 4, 4, 8, 3, 3, 64, 130),
    (2, 3, 5, 4, 3, 3, 37, 129),
    (1, 16, 16, 8, 3, 3, 130, 257),
    (1, 32, 32, 16, 3, 3, 140, 160),
    (2, 10, 6, 8, 3, 3, 101, 60),
    (2, 4, 4, 8, 6, 0, 48, 130),
]


@pytest.mark.parametrize('case', VJP_CASES)
def test_apply_vjps_match_jax_reference(case):
  b, gh, gw, gd, no, ni, h, w = case
  grid, guide, image, ct = _inputs(0, *case)
  want_grid = jax.vmap(functools.partial(
      jref.bilateral_slice_apply_grid_vjp,
      grid_shape=grid.shape[1:]))(guide, image, ct)
  want_guide = jax.vmap(jref.bilateral_slice_apply_guide_vjp)(
      grid, guide, image, ct)
  got_grid = tref.bilateral_slice_apply_grid_vjp(
      _t(guide), _t(image), _t(ct), grid.shape[1:])
  got_guide = tref.bilateral_slice_apply_guide_vjp(
      _t(grid), _t(guide), _t(image), _t(ct))
  # float32 sums of ~500 splats at magnitude ~17, in a host-dependent order.
  _close_scaled(got_grid.numpy(), want_grid, ATOL)
  _close_scaled(got_guide.numpy(), want_guide, ATOL)
  if ni:
    want_in = jax.vmap(jref.bilateral_slice_apply_input_vjp)(grid, guide, ct)
    got_in = tref.bilateral_slice_apply_input_vjp(_t(grid), _t(guide), _t(ct))
    _close_scaled(got_in.numpy(), want_in, ATOL)


def test_slice_vjps_match_jax_reference():
  rng = np.random.RandomState(1)
  b, gh, gw, gd, c, h, w = 2, 4, 5, 6, 7, 41, 66
  grid = rng.randn(b, gh, gw, gd, c).astype(np.float32)
  guide = (rng.rand(b, h, w) * 1.2 - 0.1).astype(np.float32)
  guide[1, 3:5] = 0.0
  ct = rng.randn(b, h, w, c).astype(np.float32)
  want_grid = jax.vmap(functools.partial(
      jref.bilateral_slice_grid_vjp, grid_shape=(gh, gw, gd, c)))(guide, ct)
  want_guide = jax.vmap(jref.bilateral_slice_guide_vjp)(grid, guide, ct)
  got_grid = tref.bilateral_slice_grid_vjp(_t(guide), _t(ct), (gh, gw, gd, c))
  got_guide = tref.bilateral_slice_guide_vjp(_t(grid), _t(guide), _t(ct))
  # float32 sums of many splats, in an order that depends on the host.
  _close_scaled(got_grid.numpy(), want_grid, ATOL)
  _close_scaled(got_guide.numpy(), want_guide, ATOL)


def _cf(x):
  return jnp.transpose(jnp.asarray(x), (0, 3, 1, 2))


@pytest.mark.parametrize('n_in', [3, 0, 8])
def test_plain_kernels_match_jax_interpret(n_in):
  """K3, K4 and K5's plain versions against the JAX Pallas kernels in
  interpret mode (channel-first there, channels-last here)."""
  b, gh, gw, gd, no, h, w = 2, 4, 4, 8, 3, 40, 130
  grid, guide, image, ct = _inputs(2, b, gh, gw, gd, no, n_in, h, w,
                                   lo=0.0, hi=1.0)
  grid5 = grid.reshape(b, gh, gw, gd, -1)
  want = pk.slice_apply_fwd(jnp.asarray(grid5), jnp.asarray(guide),
                            _cf(image), no, n_in, True, interpret=True)
  got = sa.slice_apply_fwd_plain(_t(grid5), _t(guide), _t(image))
  np.testing.assert_allclose(got.numpy(), np.transpose(want, (0, 2, 3, 1)),
                             atol=1e-4)

  want_dg, want_di = pk.slice_apply_pix_bwd(
      jnp.asarray(grid5), jnp.asarray(guide), _cf(image), _cf(ct), no, n_in,
      True, interpret=True)
  got_dg, got_di = sa.slice_apply_pix_bwd_plain(_t(grid5), _t(guide),
                                                _t(image), _t(ct))
  _close_scaled(got_dg.numpy(), want_dg, 1e-4)
  if n_in:
    np.testing.assert_allclose(got_di.numpy(),
                               np.transpose(want_di, (0, 2, 3, 1)), atol=1e-4)

  want_grid = pk.slice_apply_grid_bwd((gh, gw, gd), jnp.asarray(guide),
                                      _cf(image), _cf(ct), no, n_in, True,
                                      interpret=True)
  got_grid = sa.slice_apply_grid_bwd_plain(grid5.shape, _t(guide), _t(image),
                                           _t(ct))
  _close_scaled(got_grid.numpy(), want_grid, 2e-4)


# A 128 x 128 x 8 grid over a 20 x 70 frame: the cells a 16 x 64 tile
# reaches exceed a block's shared memory, so the CUDA K3/K4 read their
# corners from device memory; 70 columns end in a ragged 4-pixel group.
GLOBAL_WINDOW_CASE = (1, 128, 128, 8, 3, 20, 70)


@pytest.mark.parametrize('n_in', [3, 0, 8])
def test_plain_kernels_match_jax_at_global_window(n_in):
  """Plain K3 and K4 against the JAX package at the shape whose window
  the CUDA kernels read from device memory. The JAX Pallas kernels refuse
  it (no tile plan fits VMEM), so the JAX side is its reference: the
  forward and the guide and input VJPs under ``jax.vmap``."""
  b, gh, gw, gd, no, h, w = GLOBAL_WINDOW_CASE
  assert not pk.feasible(h, w, gh, gw)
  grid, guide, image, ct = _inputs(4, b, gh, gw, gd, no, n_in, h, w)
  grid5 = grid.reshape(b, gh, gw, gd, -1)
  want = jax.vmap(jref.bilateral_slice_apply)(grid, guide, image)
  got = sa.slice_apply_fwd_plain(_t(grid5), _t(guide), _t(image))
  np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
  got_dg, got_di = sa.slice_apply_pix_bwd_plain(_t(grid5), _t(guide),
                                                _t(image), _t(ct))
  want_dg = jax.vmap(jref.bilateral_slice_apply_guide_vjp)(grid, guide,
                                                           image, ct)
  _close_scaled(got_dg.numpy(), want_dg, 1e-4)
  if n_in:
    want_di = jax.vmap(jref.bilateral_slice_apply_input_vjp)(grid, guide, ct)
    np.testing.assert_allclose(got_di.numpy(), want_di, rtol=0, atol=1e-4)


def test_plain_vjps_take_a_band():
  """The guide and input VJPs of a band (its rows at their offset in the
  whole frame's taps) are bit for bit those rows of the whole frame's:
  what the GPU tests hold the banded kernels to."""
  b, gh, gw, gd, no, ni, h, w = 2, 5, 7, 8, 3, 3, 45, 61
  grid, guide, image, ct = map(_t, _inputs(5, b, gh, gw, gd, no, ni, h, w))
  whole_dg = tref.bilateral_slice_apply_guide_vjp(grid, guide, image, ct)
  whole_di = tref.bilateral_slice_apply_input_vjp(grid, guide, ct)
  for y0, y1 in ((0, 7), (7, 30), (30, 45)):
    rows = slice(None), slice(y0, y1)
    band = (y0, 0, h, w)
    dg = tref.bilateral_slice_apply_guide_vjp(
        grid, guide[rows], image[rows], ct[rows], band=band)
    di = tref.bilateral_slice_apply_input_vjp(grid, guide[rows], ct[rows],
                                              band=band)
    assert torch.equal(dg, whole_dg[rows]), (y0, y1)
    assert torch.equal(di, whole_di[rows]), (y0, y1)


def _jax_grads(grid, guide, image, probe):
  def loss(grid, guide, image):
    out = jax_slice_apply(grid, guide, image, backend='reference')
    return jnp.vdot(out, probe)
  return jax.grad(loss, argnums=(0, 1, 2))(
      *map(jnp.asarray, (grid, guide, image)))


def _port_grads(grid, guide, image, probe):
  args = [_t(a).requires_grad_() for a in (grid, guide, image)]
  out = slice_ops.bilateral_slice_apply(*args)
  return torch.autograd.grad((out * _t(probe)).sum(), args)


@pytest.mark.parametrize('case', [
    (1, 3, 4, 5, 3, 3, 15, 12),
    (1, 4, 4, 4, 3, 3, 7, 9),
    (1, 16, 16, 8, 3, 3, 130, 257),
    (2, 10, 6, 8, 3, 3, 101, 60),
])
def test_op_gradients_match_jax_custom_vjp(case):
  """autograd through the port's op against jax.grad through JAX's, with
  guides in [-0.1, 1.1]: the port's backward is the custom VJP (the
  mirror-padded splat, the extreme depth weights forced to 1), not the
  derivative of its clamped, smoothed forward. The last row holds guides
  a float32 step inside bin 0 and bin gd-1's outer halves, where the
  forward's smoothed tent sums to 1 - 1e-4 and the VJP's weight is 1."""
  grid, guide, image, probe = _inputs(3, *case)
  gd = case[3]
  guide[:, -1, 0::2] = np.nextafter(np.float32(0.5 / gd), np.float32(0))
  guide[:, -1, 1::2] = np.nextafter(np.float32((gd - 0.5) / gd),
                                    np.float32(1))
  want = _jax_grads(grid, guide, image, probe)
  got = _port_grads(grid, guide, image, probe)
  np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=ATOL)
  _close_scaled(got[1].numpy(), want[1], ATOL)
  np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=ATOL)


def test_slice_op_gradients_match_jax():
  rng = np.random.RandomState(4)
  grid = rng.randn(1, 3, 4, 6, 5).astype(np.float32)
  guide = (rng.rand(1, 22, 17) * 1.2 - 0.1).astype(np.float32)
  probe = rng.randn(1, 22, 17, 5).astype(np.float32)

  def loss(grid, guide):
    return jnp.vdot(jax_slice(grid, guide, backend='reference'), probe)
  want = jax.grad(loss, argnums=(0, 1))(jnp.asarray(grid), jnp.asarray(guide))
  args = [_t(a).requires_grad_() for a in (grid, guide)]
  out = slice_ops.bilateral_slice(*args)
  got = torch.autograd.grad((out * _t(probe)).sum(), args)
  np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=ATOL)
  _close_scaled(got[1].numpy(), want[1], ATOL)


# --- finite differences (float64) -------------------------------------------


def _kink_safe_guide(rng, shape, gd, margin=0.1):
  """Guide whose gzf = guide * gd stays `margin` away from the
  half-integer tent kinks (tests/test_reference_ops.py)."""
  cell = rng.randint(0, gd, size=shape)
  frac = 0.5 + margin + rng.rand(*shape) * (0.5 - 2 * margin)
  return (cell + frac - 0.5) / gd


def _fd_check(f, args, wrt, tol, delta=1e-3, seed=0):
  """Directional derivative of vdot(f(args), probe) along a random v:
  autograd against central differences, in float64."""
  rng = np.random.RandomState(seed)
  args = [torch.from_numpy(np.asarray(a, np.float64)) for a in args]
  probe = torch.from_numpy(rng.randn(*f(*args).shape))
  v = torch.from_numpy(rng.randn(*args[wrt].shape))

  def scalar_f(x):
    new = list(args)
    new[wrt] = x
    return (f(*new) * probe).sum()

  x = args[wrt].clone().requires_grad_()
  (g,) = torch.autograd.grad(scalar_f(x), [x])
  got = float((g * v).sum())
  with torch.no_grad():
    want = float(scalar_f(args[wrt] + delta * v) -
                 scalar_f(args[wrt] - delta * v)) / (2 * delta)
  np.testing.assert_allclose(got, want, rtol=tol, atol=tol * (abs(want) + 1))


@pytest.fixture(scope='module')
def apply_args():
  rng = np.random.RandomState(42)
  b, gh, gw, gd, no, ni = 1, 3, 4, 5, 3, 3
  h, w = 15, 12
  grid = rng.randn(b, gh, gw, gd, no, ni + 1)
  guide = _kink_safe_guide(rng, (b, h, w), gd)
  image = rng.rand(b, h, w, ni)
  return grid, guide, image


@pytest.mark.parametrize('wrt,tol', [(0, 3e-4), (1, 1e-2), (2, 3e-4)])
def test_apply_grads_finite_differences(apply_args, wrt, tol):
  _fd_check(slice_ops.bilateral_slice_apply, apply_args, wrt, tol)


@pytest.mark.parametrize('wrt,tol,delta', [(0, 3e-3, 1e-3), (1, 1e-2, 1e-4)])
def test_slice_grads_finite_differences(wrt, tol, delta):
  rng = np.random.RandomState(11)
  grid = rng.randn(1, 3, 4, 6, 4)
  guide = _kink_safe_guide(rng, (1, 14, 10), gd=6)
  _fd_check(slice_ops.bilateral_slice, [grid, guide], wrt, tol, delta=delta)


def test_grid_vjp_z_extremes_take_all_the_mass():
  """A guide pinned at 0 or 1 sends the whole cotangent to depth cell 0
  or gd-1 with weight exactly 1: mass h*w, nothing elsewhere."""
  gh, gw, gd, h, w = 2, 2, 4, 8, 8
  ct = torch.ones((1, h, w, 1))
  image = torch.zeros((1, h, w, 0))
  for gval, cell in [(0.0, 0), (1.0, gd - 1)]:
    guide = torch.full((1, h, w), gval)
    vjp = tref.bilateral_slice_apply_grid_vjp(guide, image, ct,
                                              (gh, gw, gd, 1, 1))
    mass = vjp.sum(dim=(0, 1, 2, 4, 5)).numpy()
    others = [k for k in range(gd) if k != cell]
    np.testing.assert_allclose(mass[others], 0.0, atol=1e-6)
    np.testing.assert_allclose(mass[cell], h * w, rtol=1e-5)
