"""Image helper library (the port's own copy of ``hdrnet_tpu.utils.image``;
reference: hdrnet/image.py:15-138).

Color-space matrices, range/type conversions (including the reference's
idiosyncratic white levels: uint16->float divides by 32767, int16 by
65535 — hdrnet/image.py:61-74, kept verbatim for dataset parity),
grayscale conversions, resize and file IO — numpy throughout, with PIL
instead of skimage. The resizes are ``hdrnet_torch.data.hostops``'s,
numpy versions of the JAX package's C++ ones, bit for bit on the tests.
"""

from __future__ import annotations

import numpy as np

from hdrnet_torch.data import hostops
from hdrnet_torch.data import images as _io

# BT.709 luma with unit-difference chroma (the reference's convention,
# image.py:22-27) and the CIE RGB->XYZ matrix.
M_RGB2YUV = np.array([
    [0.2126390, 0.7151688, 0.0721923],
    [0.2126390 - 1.0, 0.7151688, 0.0721923],
    [0.2126390, 0.7151688, 0.0721923 - 1.0]])
M_YUV2RGB = np.linalg.inv(M_RGB2YUV)
M_RGB2XYZ = np.array([[0.412453, 0.357580, 0.180423],
                      [0.212671, 0.715160, 0.072169],
                      [0.019334, 0.119193, 0.950227]])
M_XYZ2RGB = np.linalg.inv(M_RGB2XYZ)


# ----- Range transformations -----------------------------------------------

def clamp(image, mini=0.0, maxi=1.0):
  return np.clip(image, mini, maxi)


def normalize(im):
  im = np.asarray(im, np.float32)
  mini, maxi = float(im.min()), float(im.max())
  rng = maxi - mini
  out = im - mini
  return out / rng if rng > 0 else out


# ----- Type transformations -------------------------------------------------

def uint8_to_float(image):
  return image.astype(np.float32) / 255.0


def float_to_uint8(image):
  return (clamp(image) * 255).astype(np.uint8)


def uint16_to_float(image):
  """NB: HDR+ white level 32767, not 65535 (image.py:61-62)."""
  return image.astype(np.float32) / 32767.0


def int16_to_float(image):
  return image.astype(np.float32) / 65535.0


def float_to_int16(image):
  return (image * 65535.0).astype(np.int16)


def float_to_uint16(image):
  return (image * 32767.0).astype(np.uint16)


# ----- Color transformations -------------------------------------------------

def rgb_to_yuv(im):
  return np.einsum('...c,dc->...d', im, M_RGB2YUV)


def yuv_to_rgb(im):
  return np.einsum('...c,dc->...d', im, M_YUV2RGB)


def rgb_to_xyz(im):
  return np.einsum('...c,dc->...d', im, M_RGB2XYZ)


def xyz_to_rgb(im):
  return np.einsum('...c,dc->...d', im, M_XYZ2RGB)


def yuv_to_gray(im):
  return im[:, :, 0]


def rgb_to_gray(im):
  return rgb_to_yuv(im)[:, :, 0]


def gray_to_rgb(im):
  return np.repeat(im[:, :, None], 3, axis=2)


# ----- Geometry / IO ---------------------------------------------------------

def resize(im, size, method='bilinear'):
  im = np.asarray(im, np.float32)
  if method == 'nearest':
    return hostops.resize_nearest(im, size)
  return hostops.resize_bilinear(im, size)


imread = _io.imread
imread_float = _io.imread_float
imwrite = _io.imwrite
