"""numpy versions of the host input pipeline's image operations.

The JAX package runs these in a small C++ library (``libhdrnet_io.so``,
``hdrnet_tpu/native/hdrnet_io.cc``). The port computes them in numpy with
the library's arithmetic:

* ``to_float``, ``resize_nearest`` and ``crop_flip_rot`` give the
  library's bits: a float32 reciprocal of the white level times the
  value; float64 nearest tables ``floor(dst * in / out)``; pure index
  permutations.
* ``resize_bilinear`` and ``gaussian_blur`` follow its float32 formulas
  and summation order. The library is built with ``-O3 -march=native``,
  and the compiler contracts each ``a * b + c`` of those loops into one
  fused multiply-add, rounded once; here each is computed in float64 (the
  product of two float32 values is exact there) and rounded to float32,
  which gives the same value but in the rare case of a double rounding.
  The blur's Gaussian taps are ``exp`` in float64 rounded to float32 (the
  C library's ``expf`` is within about half an ulp).

All images are HWC.
"""

from __future__ import annotations

import numpy as np


def to_float(img, white_level):
  """uint8/uint16/float HWC image -> float32 in [0, 1]: x * (1 / white)
  with the reciprocal rounded to float32 first."""
  if img.dtype in (np.float32, np.float64):
    return np.ascontiguousarray(img, np.float32)
  inv = np.float32(1.0) / np.float32(white_level)
  return np.ascontiguousarray(img).astype(np.float32) * inv


def _fma(a, b, c):
  """float32 a * b + c with one rounding, as a fused multiply-add."""
  return (a.astype(np.float64) * b.astype(np.float64)
          + c.astype(np.float64)).astype(np.float32)


def _nearest_table(n_in, n_out):
  return np.minimum((np.arange(n_out) * (n_in / n_out)).astype(np.int64),
                    n_in - 1)


def resize_nearest(img, size):
  """Legacy-TF nearest resize, ``src = floor(dst * in / out)`` in float64,
  of an HWC image of any dtype."""
  oh, ow = size
  ih, iw, _ = img.shape
  if (ih, iw) == (oh, ow):
    return img
  iy, ix = _nearest_table(ih, oh), _nearest_table(iw, ow)
  return np.ascontiguousarray(img[iy][:, ix])


def resize_bilinear(img, size):
  """Legacy-TF bilinear resize (``align_corners=False``, ``src = dst * in /
  out``) of a float32 HWC image: ``a + (b - a) * f`` along x on two rows,
  then the same along y."""
  oh, ow = size
  ih, iw, _ = img.shape
  if (ih, iw) == (oh, ow):
    return img
  img = np.ascontiguousarray(img, np.float32)
  fy = np.arange(oh) * (ih / oh)
  fx = np.arange(ow) * (iw / ow)
  y0 = np.minimum(fy.astype(np.int64), ih - 1)
  x0 = fx.astype(np.int64)
  wy = (fy - fy.astype(np.int64)).astype(np.float32)[:, None, None]
  wx = (fx - x0).astype(np.float32)[None, :, None]
  y1 = np.minimum(y0 + 1, ih - 1)
  x1 = np.minimum(x0 + 1, iw - 1)
  x0 = np.minimum(x0, iw - 1)
  r0, r1 = img[y0], img[y1]
  top = _fma(r0[:, x1] - r0[:, x0], wx, r0[:, x0])
  bot = _fma(r1[:, x1] - r1[:, x0], wx, r1[:, x0])
  return _fma(bot - top, wy, top)


def crop_flip_rot(img, y0, x0, ch, cw, fliplr=False, flipud=False,
                  rot_k=0):
  """Crop (y0, x0, ch, cw), then the flips, then ``np.rot90(k)``, of an
  HWC image of any dtype."""
  x = img[y0:y0 + ch, x0:x0 + cw]
  if fliplr:
    x = x[:, ::-1]
  if flipud:
    x = x[::-1]
  return np.ascontiguousarray(np.rot90(x, rot_k % 4))


def _reflect(i, n):
  """Symmetric boundary: -1 reads 0, n reads n - 1."""
  i = np.abs(i + 0.5) - 0.5
  period = 2 * n
  i = np.mod(i, period)
  return np.where(i >= n, period - 1 - i, i).astype(np.int64)


def gaussian_blur(img, sigma):
  """Separable Gaussian blur of a float32 HWC image with a symmetric
  boundary, radius max(1, int(3 sigma + 0.5)): horizontal pass, then
  vertical, each tap added in order as a fused multiply-add."""
  ih, iw, _ = img.shape
  img = np.ascontiguousarray(img, np.float32)
  sigma = np.float32(sigma)
  radius = max(1, int(sigma * np.float32(3.0) + np.float32(0.5)))
  d = np.arange(-radius, radius + 1).astype(np.float32)
  arg = np.float32(-0.5) * d * d / (sigma * sigma)
  kern = np.exp(arg.astype(np.float64)).astype(np.float32)
  total = np.float32(0.0)
  for k in kern:
    total = np.float32(total + k)
  kern = kern / total
  taps = np.arange(-radius, radius + 1)
  cols = _reflect(np.arange(iw)[:, None] + taps, iw)
  tmp = _fma(kern[0], img[:, cols[:, 0]], np.float32(0.0))
  for i in range(1, 2 * radius + 1):
    tmp = _fma(kern[i], img[:, cols[:, i]], tmp)
  rows = _reflect(np.arange(ih)[:, None] + taps, ih)
  out = kern[0] * tmp[rows[:, 0]]
  for i in range(1, 2 * radius + 1):
    out = _fma(kern[i], tmp[rows[:, i]], out)
  return out
