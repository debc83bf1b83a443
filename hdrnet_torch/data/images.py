"""Image file IO with bit-depth detection.

The port's own copy of ``hdrnet_tpu.data.images``. Replaces the
reference's libmagic sniffing + TF decode ops (data_pipeline.py:202-232):
PIL reports the true bit depth directly, and the white level follows the
same rule (16-bit -> 65535, else 255). PIL is imported inside the
functions that use it, so the module imports without it.
"""

from __future__ import annotations

import os

import numpy as np

from hdrnet_torch.data import hostops

_SIXTEEN_BIT_MODES = ('I;16', 'I;16B', 'I;16L', 'I;16N', 'I')


def white_level_of(path):
  """White level by on-disk bit depth (data_pipeline.py:202-213)."""
  from PIL import Image
  with Image.open(path) as im:
    return 65535.0 if im.mode in _SIXTEEN_BIT_MODES else 255.0


def imread(path, dtype=None):
  """Reads an image as HWC numpy, preserving 16-bit depth; drops alpha."""
  from PIL import Image
  with Image.open(path) as im:
    if im.mode in _SIXTEEN_BIT_MODES:
      arr = np.asarray(im, np.uint16)
    elif im.mode in ('RGB', 'RGBA', 'L'):
      if im.mode == 'RGBA':
        im = im.convert('RGB')
      arr = np.asarray(im, np.uint8)
    else:
      arr = np.asarray(im.convert('RGB'), np.uint8)
  if arr.ndim == 2:
    arr = np.repeat(arr[:, :, None], 3, axis=2)
  if arr.shape[-1] == 4:
    arr = arr[..., :3]
  if dtype is not None:
    arr = arr.astype(dtype)
  return arr


def imread_float(path):
  """Reads and normalizes by the file's white level -> float32 [0,1]."""
  arr = imread(path)
  white = 65535.0 if arr.dtype == np.uint16 else 255.0
  return hostops.to_float(arr, white)


def imwrite(path, img):
  """Saves a float [0,1] or uint8 HWC image as png/jpg."""
  from PIL import Image
  os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
  if img.dtype != np.uint8:
    img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
  Image.fromarray(img).save(path)
