"""hdrnet_torch ops vs the JAX package on the CPU.

The same numpy-seeded inputs go through ``hdrnet_tpu`` (its reference
ops, and its Pallas kernels in interpret mode) and through the port's
plain versions, which are what the port's wrappers run on a CPU tensor.
Tolerances: 1e-5 for the float32 ops (the JAX package's own kernel
gate), bit-exact for the float32 downsample, and for uint8 output at
most 1 code on fewer than 1% of values (a value exactly on a rounding
boundary may go either way under another summation order).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hdrnet_tpu import numerics as jnum
from hdrnet_tpu.ops import bilateral_slice as jax_slice
from hdrnet_tpu.ops import bilateral_slice_apply as jax_slice_apply
from hdrnet_tpu.ops import pallas as pk
from hdrnet_tpu.ops.downsample import nearest_lowres_cf
from hdrnet_tpu.ops.resize import _nearest_indices as jax_nearest_indices
from hdrnet_tpu.ops.resize import resize_nearest as jax_resize_nearest

from hdrnet_torch import numerics as tnum
from hdrnet_torch.ops import downsample, fused, resize, slice_ops

ATOL = 1e-5


def _t(x):
  return torch.from_numpy(np.asarray(x))


def _np(x):
  return np.asarray(x)


@pytest.mark.parametrize('name', ['lerp_weight', 'smoothed_lerp_weight',
                                  'smoothed_lerp_weight_grad',
                                  'smoothed_abs', 'smoothed_abs_grad'])
def test_numerics_match_jax(name):
  rng = np.random.RandomState(0)
  x = (rng.rand(4096).astype(np.float32) * 4 - 2)
  xs = (rng.rand(4096).astype(np.float32) * 4 - 2)
  x[:16] = xs[:16]  # the smoothed kink at dx = 0
  args = (x,) if name.startswith('smoothed_abs') else (x, xs)
  want = getattr(jnum, name)(*map(jnp.asarray, args))
  got = getattr(tnum, name)(*map(_t, args))
  np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL)
  assert tnum.EPS == jnum.EPS


def test_mirror_boundary_matches_jax():
  x = np.arange(-7, 14, dtype=np.int32)
  want = jnum.mirror_boundary(jnp.asarray(x), 7)
  got = tnum.mirror_boundary(_t(x), 7)
  np.testing.assert_array_equal(got.numpy(), _np(want))


def _slice_args(seed, b, gh, gw, gd, no, ni, h, w, offset=True):
  rng = np.random.RandomState(seed)
  ni1 = ni + (1 if offset else 0)
  grid = rng.randn(b, gh, gw, gd, no, ni1).astype(np.float32)
  guide = rng.rand(b, h, w).astype(np.float32)
  image = rng.rand(b, h, w, ni).astype(np.float32)
  return grid, guide, image


SLICE_CASES = [
    # (b, gh, gw, gd, no, ni, h, w): the kernel-gate geometries of the JAX
    # package, plus an odd frame against an odd grid.
    (1, 4, 4, 8, 3, 3, 64, 130),
    (2, 3, 5, 4, 3, 3, 37, 129),
    (1, 16, 16, 8, 3, 3, 130, 257),
    (1, 32, 32, 16, 3, 3, 140, 160),
    (2, 10, 6, 8, 3, 3, 101, 60),
]


@pytest.mark.parametrize('case', SLICE_CASES)
def test_slice_apply_matches_jax_reference(case):
  grid, guide, image = _slice_args(0, *case)
  want = jax_slice_apply(jnp.asarray(grid), jnp.asarray(guide),
                         jnp.asarray(image), backend='reference')
  got = slice_ops.bilateral_slice_apply(_t(grid), _t(guide), _t(image))
  np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL)


def test_slice_apply_no_offset_and_packed():
  grid, guide, image = _slice_args(1, 1, 4, 4, 5, 2, 3, 40, 129,
                                   offset=False)
  want = jax_slice_apply(jnp.asarray(grid), jnp.asarray(guide),
                         jnp.asarray(image), has_offset=False,
                         backend='reference')
  packed = grid.reshape(grid.shape[:4] + (-1,))
  got = slice_ops.bilateral_slice_apply(_t(packed), _t(guide), _t(image),
                                        has_offset=False)
  np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL)


def test_plain_slice_and_out_of_range_guide():
  rng = np.random.RandomState(2)
  grid = rng.randn(2, 4, 4, 8, 6).astype(np.float32)
  guide = (rng.rand(2, 48, 130) * 3 - 1).astype(np.float32)  # clamps
  want = jax_slice(jnp.asarray(grid), jnp.asarray(guide),
                   backend='reference')
  got = slice_ops.bilateral_slice(_t(grid), _t(guide))
  np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL)


def _curves_params(seed):
  """A curves guide away from its identity init, as the JAX tuple."""
  rng = np.random.RandomState(seed)
  ccm_ext = np.vstack([np.eye(3) + 0.2 * rng.randn(3, 3),
                       0.05 * rng.randn(1, 3)]).astype(np.float32)
  shifts = np.tile(np.linspace(0, 1, 16, endpoint=False), (3, 1))
  shifts = shifts + 0.01 * rng.randn(3, 16)
  slopes = np.abs(rng.randn(3, 16)) * 0.3
  slopes[:, 0] = 1.0
  curves = np.vstack([shifts, slopes]).astype(np.float32)
  mix = np.vstack([np.full((3, 1), 1 / 3) + 0.05 * rng.randn(3, 1),
                   [[0.02]]]).astype(np.float32)
  return ccm_ext, curves, mix


def _fused_inputs(seed, b, h, w, gh=16, gw=16, gd=8, u8=False):
  rng = np.random.RandomState(seed)
  grid5 = (0.5 * rng.randn(b, gh, gw, gd, 12)).astype(np.float32)
  for i in range(3):  # near-identity affine, so clipping is not total
    grid5[..., i * 4 + i] += 1.0
  if u8:
    frame = rng.randint(0, 256, (b, h, w, 3)).astype(np.uint8)
  else:
    frame = rng.rand(b, h, w, 3).astype(np.float32)
  return grid5, frame, _curves_params(seed)


def _jax_enhance_fused(grid5, frame, gparams, **kw):
  out_cf = pk.enhance_fused(jnp.asarray(grid5),
                            jnp.asarray(frame.transpose(0, 3, 1, 2)),
                            gparams, 'curves', 3, 3, True, interpret=True,
                            **kw)
  return _np(out_cf).transpose(0, 2, 3, 1)


@pytest.mark.parametrize('clip', [False, True])
def test_enhance_fused_plain_matches_jax_f32(clip):
  grid5, frame, gparams = _fused_inputs(3, 2, 40, 136)
  want = _jax_enhance_fused(grid5, frame, gparams, clip_output=clip)
  got = fused.enhance_fused(_t(grid5), _t(frame),
                            fused.pack_curves_params(*gparams),
                            clip_output=clip)
  assert got.dtype == torch.float32 and got.shape == frame.shape
  np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
  if clip:
    assert got.min() >= 0 and got.max() <= 1


def test_enhance_fused_plain_matches_jax_u8():
  grid5, frame, gparams = _fused_inputs(4, 1, 64, 136, u8=True)
  want = _jax_enhance_fused(grid5, frame, gparams, clip_output=True,
                            u8_output=True)
  got = fused.enhance_fused(_t(grid5), _t(frame),
                            fused.pack_curves_params(*gparams),
                            clip_output=True, u8_output=True)
  assert got.dtype == torch.uint8 and want.dtype == np.uint8
  diff = got.numpy().astype(int) - want.astype(int)
  assert np.abs(diff).max() <= 1
  assert (diff != 0).mean() < 0.01


def test_curves_guide_matches_jax_guide():
  """The guide alone, against the Flax CurveGuide's math (einsum form)."""
  from hdrnet_tpu.models.guides import CurveGuide as JaxCurveGuide
  _, frame, (ccm_ext, curves, mix) = _fused_inputs(5, 2, 33, 47)
  params = {'ccm': ccm_ext[:3], 'ccm_bias': ccm_ext[3],
            'shifts': curves[:3], 'slopes': curves[3:],
            'channel_mixing_w': mix[:3], 'channel_mixing_b': mix[3]}
  want = JaxCurveGuide().apply({'params': params}, jnp.asarray(frame))
  got = fused.curves_guide(_t(frame), _t(ccm_ext), _t(curves[:3]),
                           _t(curves[3:]), _t(mix.reshape(-1)))
  np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL)


def test_enhance_fused_rejects_bad_arguments():
  grid5, frame, gparams = _fused_inputs(6, 1, 20, 24)
  params = fused.pack_curves_params(*gparams)
  with pytest.raises(ValueError, match='clip'):
    fused.enhance_fused(_t(grid5), _t(frame), params, u8_output=True)
  with pytest.raises(ValueError, match='grid'):
    fused.enhance_fused(_t(grid5[..., :8]), _t(frame), params)
  with pytest.raises(ValueError, match='batch'):
    fused.enhance_fused(_t(np.concatenate([grid5, grid5])), _t(frame),
                        params)


DS_SIZES = [(1, 270, 480, 32), (2, 135, 240, 64), (2, 101, 61, 16)]


@pytest.mark.parametrize('size', DS_SIZES)
def test_nearest_lowres_plain_matches_table(size):
  b, h, w, s = size
  rng = np.random.RandomState(7)
  iy, ix = jax_nearest_indices(h, s), jax_nearest_indices(w, s)
  x = rng.rand(b, h, w, 3).astype(np.float32)
  got = downsample.nearest_lowres(_t(x), s)
  want = x[:, iy][:, :, ix].transpose(0, 3, 1, 2)
  np.testing.assert_array_equal(got.numpy(), want)
  x8 = rng.randint(0, 256, (b, h, w, 3)).astype(np.uint8)
  got8 = downsample.nearest_lowres(_t(x8), s)
  want8 = x8[:, iy][:, :, ix].transpose(0, 3, 1, 2).astype(np.float32) / 255
  assert got8.dtype == torch.float32
  np.testing.assert_array_equal(got8.numpy(), want8)


@pytest.mark.parametrize('size', DS_SIZES[:2])
def test_nearest_lowres_plain_matches_jax_kernel(size):
  b, h, w, s = size
  rng = np.random.RandomState(8)
  x = rng.rand(b, h, w, 3).astype(np.float32)
  want = nearest_lowres_cf(jnp.asarray(x.transpose(0, 3, 1, 2)), s,
                           interpret=True)
  got = downsample.nearest_lowres(_t(x), s)
  np.testing.assert_array_equal(got.numpy(), _np(want))
  x8 = rng.randint(0, 256, (b, h, w, 3)).astype(np.uint8)
  want8 = nearest_lowres_cf(jnp.asarray(x8.transpose(0, 3, 1, 2)), s,
                            interpret=True)
  got8 = downsample.nearest_lowres(_t(x8), s)
  # XLA strength-reduces the /255 to a multiply: 1 ulp.
  np.testing.assert_allclose(got8.numpy(), _np(want8), atol=1e-7)


@pytest.mark.parametrize('size', DS_SIZES + [(3, 135, 240, 64),
                                  (1, 10, 7, 32), (2, 77, 301, 40)])
def test_k2_library_call_matches_plain_and_jax(size):
  """The yardstick of K2's library_ms, one aten::index call with the floor
  tables, computes K2's f32 function exactly: the plain version's and
  the JAX kernel's (interpret mode) bits, at the JAX cases and odd sizes
  (s above H and W, rows of 301 values)."""
  from hdrnet_torch.scripts.time_kernels import k2_library
  b, h, w, s = size
  x = np.random.RandomState(11).rand(b, h, w, 3).astype(np.float32)
  got = k2_library(_t(x), s)
  assert got.shape == (b, 3, s, s)
  np.testing.assert_array_equal(
      got.numpy(), downsample.nearest_lowres_plain(_t(x), s).numpy())
  want = nearest_lowres_cf(jnp.asarray(x.transpose(0, 3, 1, 2)), s,
                           interpret=True)
  np.testing.assert_array_equal(got.numpy(), _np(want))


def test_resize_nearest_matches_jax():
  rng = np.random.RandomState(9)
  x = rng.rand(2, 37, 53, 3).astype(np.float32)
  want = jax_resize_nearest(jnp.asarray(x), (16, 24))
  got = resize.resize_nearest(_t(x), (16, 24))
  np.testing.assert_array_equal(got.numpy(), _np(want))
  for n_in, n_out in [(2160, 256), (3840, 256), (101, 16), (7, 7)]:
    np.testing.assert_array_equal(
        resize.nearest_index_tensor(n_in, n_out, torch.device('cpu')).numpy(),
        jax_nearest_indices(n_in, n_out))


def test_cpu_wrappers_do_not_launch():
  grid5, frame, gparams = _fused_inputs(10, 1, 20, 24)
  k1, k2 = fused.launches, downsample.launches
  fused.enhance_fused(_t(grid5), _t(frame), fused.pack_curves_params(*gparams))
  downsample.nearest_lowres(_t(frame), 8)
  assert (fused.launches, downsample.launches) == (k1, k2)


def test_slice_ops_refuse_cuda_tensors():
  """The slice ops run a kernel on CUDA tensors and the plain version on
  CPU ones; tensors split across devices, or on any other device, are
  refused rather than moved."""
  meta = torch.empty((1, 2, 2, 2, 3, 4), device='meta')
  with pytest.raises(ValueError, match='different devices'):
    slice_ops.bilateral_slice_apply(meta, torch.empty((1, 4, 4)),
                                    torch.empty((1, 4, 4, 3)))
  with pytest.raises(ValueError, match='unsupported device'):
    slice_ops.bilateral_slice_apply(
        meta, torch.empty((1, 4, 4), device='meta'),
        torch.empty((1, 4, 4, 3), device='meta'))


def test_build_finds_nvcc_from_cuda_home_first(tmp_path, monkeypatch):
  from hdrnet_torch.ops import _build
  nvcc = tmp_path / 'bin' / 'nvcc'
  nvcc.parent.mkdir()
  nvcc.write_text('')
  monkeypatch.setenv('CUDA_HOME', str(tmp_path))
  assert _build.find_nvcc() == str(nvcc)
  assert len(_build._source_hash()) == 16
  assert {p.name for p in _build._sources()} == {'downsample.cu',
                                                 'downsample_onehot.cu',
                                                 'fused_slice_apply.cu',
                                                 'slice_apply.cu'}
