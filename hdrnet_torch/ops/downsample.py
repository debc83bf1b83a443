"""Nearest-neighbour preview downsample (serving hot path), kernel K2.

``nearest_lowres(frame, s)`` cuts the (B, C, s, s) float32 preview that
the coefficient CNN consumes from an NHWC frame (float32, or uint8
normalized by /255), with the legacy TF1 table ``src = floor(dst*in/out)``
of :mod:`hdrnet_torch.ops.resize`. It matches
``hdrnet_tpu.ops.downsample.nearest_lowres_cf`` on the channel-first frame
bit for bit at float32.

On a CUDA tensor it launches the hand-written kernel in
``csrc/downsample.cu``; on a CPU tensor it runs ``nearest_lowres_plain``,
the same function in plain PyTorch.
"""

from __future__ import annotations

import torch

from hdrnet_torch.ops import _build
from hdrnet_torch.ops.resize import nearest_index_tensor

# Kernel launches by nearest_lowres (never by the plain version).
launches = 0


def to_unit(x):
  """float32 frame as is; uint8 divided by 255 with IEEE division (a
  device tensor divisor: a Python scalar divisor may become a multiply by
  the reciprocal)."""
  if x.dtype == torch.uint8:
    return x.to(torch.float32) / torch.tensor(255.0, device=x.device)
  return x


def _check(frame, s):
  if frame.ndim != 4:
    raise ValueError(f'frame must be (B, H, W, C), got {tuple(frame.shape)}')
  if frame.dtype not in (torch.float32, torch.uint8):
    raise TypeError(f'frame must be float32 or uint8, got {frame.dtype}')
  if s <= 0:
    raise ValueError(f'preview size must be positive, got {s}')


def nearest_lowres_plain(frame, s):
  """(B, H, W, C) float32 or uint8 -> (B, C, s, s) float32, plain torch."""
  _check(frame, s)
  _, h, w, _ = frame.shape
  iy = nearest_index_tensor(h, s, frame.device)
  ix = nearest_index_tensor(w, s, frame.device)
  low = torch.index_select(torch.index_select(frame, 1, iy), 2, ix)
  return to_unit(low).permute(0, 3, 1, 2).contiguous()


def nearest_lowres(frame, s):
  """(B, H, W, C) float32 or uint8 -> (B, C, s, s) float32 preview.

  CUDA tensor: kernel K2. CPU tensor: the plain version.
  """
  global launches
  _check(frame, s)
  if frame.device.type == 'cpu':
    return nearest_lowres_plain(frame, s)
  if frame.device.type != 'cuda':
    raise ValueError(f'unsupported device {frame.device}')
  if not frame.is_contiguous():
    raise ValueError('frame must be contiguous')
  b, h, w, c = frame.shape
  iy = nearest_index_tensor(h, s, frame.device)
  ix = nearest_index_tensor(w, s, frame.device)
  out = torch.empty((b, c, s, s), dtype=torch.float32, device=frame.device)
  lib = _build.library().lib
  with torch.cuda.device(frame.device):
    stream = torch.cuda.current_stream(frame.device).cuda_stream
    err = lib.hdrnet_nearest_lowres(
        frame.data_ptr(), int(frame.dtype == torch.uint8), iy.data_ptr(),
        ix.data_ptr(), out.data_ptr(), b, h, w, c, s, stream)
  _build.check(err, 'hdrnet_nearest_lowres')
  launches += 1
  return out
