"""The Gaussian pyramid's level work on the serving route: kernels
``pyramid_down`` and ``pyramid_up_add`` (``csrc/pyramid_levels.cu``).

``pyramid_down`` builds one level of ``HDRNetGaussianPyrNN``'s pyramid: the
bilinear (align_corners) resize of an NHWC frame, float32 or uint8 (v /
255), to half its extents. ``pyramid_up_add`` is one step of the levels'
coarse-to-fine sum: the coarser sum resized onto the finer level, plus
that level's output, then optionally the clip to [0, 1] and the uint8
requantize trunc(v * 255 + 0.5). Both are bit for bit the ATen chain that
``models.hdrnet.gaussian_pyramid``, ``upsample_add``, ``torch.clamp`` and
``requantize`` compute, with ``ops.resize``'s float64 tap tables.

On a CUDA tensor the wrappers launch the kernels; on a CPU tensor, and
under ``torch.export`` (which records the resizes as
``hdrnet::resize_bilinear``), they run the plain versions (``*_plain``),
which are that chain. The training path (autograd, bands) keeps
``ops.resize``.
"""

from __future__ import annotations

import torch

from hdrnet_torch.ops import _build
from hdrnet_torch.ops.downsample import to_unit
from hdrnet_torch.ops.resize import linear_tap_tensors, resize_bilinear
from hdrnet_torch.utils.timing import span

N_CHANNELS = 3


def requantize(out):
  """A [0, 1] float32 image to uint8 as trunc(v * 255 + 0.5): two
  roundings (the product, then the sum), then truncation."""
  return (out * 255.0 + 0.5).to(torch.int32).to(torch.uint8)


def pyramid_down_plain(frame):
  """``pyramid_down`` in torch: ``to_unit``, then the bilinear
  (align_corners) resize to (H // 2, W // 2)."""
  x = to_unit(frame)
  return resize_bilinear(x, (x.shape[1] // 2, x.shape[2] // 2),
                         align_corners=True)


def pyramid_up_add_plain(current, level_out, clip_output=False,
                         u8_output=False):
  """``pyramid_up_add`` in torch: ``upsample_add``'s resize and add, the
  clamp, ``requantize``."""
  out = resize_bilinear(current, level_out.shape[1:3],
                        align_corners=True) + level_out
  if clip_output:
    out = torch.clamp(out, 0.0, 1.0)
  return requantize(out) if u8_output else out


def _check_image(name, x, dtypes):
  """A contiguous (B, H, W, 3) image of `dtypes` whose rows the kernels'
  32-bit index reaches; raises otherwise."""
  if x.ndim != 4 or x.shape[-1] != N_CHANNELS:
    raise ValueError(f'{name} must be (B, H, W, {N_CHANNELS}), got '
                     f'{tuple(x.shape)}')
  if x.dtype not in dtypes:
    raise TypeError(f'{name} must be {" or ".join(map(str, dtypes))}, got '
                    f'{x.dtype}')
  if not x.is_contiguous():
    raise ValueError(f'{name} must be contiguous')
  if x.shape[2] * N_CHANNELS >= 2**31:
    raise ValueError(f'a row of {x.shape[2]} pixels exceeds the kernels\' '
                     f'32-bit index')


def _taps(h_in, w_in, h_out, w_out, device):
  """(i0, i1, frac) of the rows, then of the columns: ``ops.resize``'s
  cached device tables of the align_corners resize. The caller holds them
  until its launch."""
  return [t for n_in, n_out in ((h_in, h_out), (w_in, w_out))
          for t in linear_tap_tensors(n_in, n_out, True, device)[:3]]


def pyramid_down(frame):
  """One level of the Gaussian pyramid: (B, H, W, 3) float32, or uint8
  (divided by 255), -> (B, H // 2, W // 2, 3) float32, the bilinear
  (align_corners) resize. CUDA tensors: the kernel; CPU tensors and
  ``torch.export``: ``pyramid_down_plain``."""
  if torch.compiler.is_compiling():
    return pyramid_down_plain(frame)
  _check_image('frame', frame, (torch.float32, torch.uint8))
  if not _build.on_card('pyramid_down', frame):
    return pyramid_down_plain(frame)
  b, h, w, _ = frame.shape
  out = torch.empty((b, h // 2, w // 2, N_CHANNELS), dtype=torch.float32,
                    device=frame.device)
  if out.numel() == 0:
    return out
  taps = _taps(h, w, h // 2, w // 2, frame.device)
  _build.launch('hdrnet_pyramid_down', frame.device, frame.data_ptr(),
                int(frame.dtype == torch.uint8),
                *(t.data_ptr() for t in taps), out.data_ptr(), b, h, w,
                h // 2, w // 2)
  return out


def pyramid_up_add(current, level_out, clip_output=False, u8_output=False):
  """One coarse-to-fine step: `current` (B, H // 2, W // 2, 3) resized
  bilinearly (align_corners) onto `level_out`'s (B, H, W, 3), plus
  `level_out`, both float32; then, with `clip_output`, clipped to [0, 1],
  and with `u8_output` (which needs the clip) requantized to uint8 as
  trunc(v * 255 + 0.5). CUDA tensors: the kernel; CPU tensors and
  ``torch.export``: ``pyramid_up_add_plain``."""
  if torch.compiler.is_compiling():
    return pyramid_up_add_plain(current, level_out, clip_output, u8_output)
  _check_image('current', current, (torch.float32,))
  _check_image('level_out', level_out, (torch.float32,))
  b, h, w, _ = level_out.shape
  if current.shape[:3] != (b, h // 2, w // 2):
    raise ValueError(f'current must be level_out\'s next level (B, H // 2, '
                     f'W // 2, 3) = {(b, h // 2, w // 2, N_CHANNELS)}, got '
                     f'{tuple(current.shape)}')
  if u8_output and not clip_output:
    raise ValueError('u8 output requires clip_output=True')
  with span('hdrnet.model.levels'):
    if not _build.on_card('pyramid_up_add', current, level_out):
      return pyramid_up_add_plain(current, level_out, clip_output, u8_output)
    out = torch.empty(level_out.shape,
                      dtype=torch.uint8 if u8_output else torch.float32,
                      device=level_out.device)
    if out.numel() == 0:
      return out
    taps = _taps(h // 2, w // 2, h, w, level_out.device)
    _build.launch('hdrnet_pyramid_up_add', level_out.device,
                  current.data_ptr(), level_out.data_ptr(),
                  *(t.data_ptr() for t in taps), out.data_ptr(),
                  int(clip_output), int(u8_output), b, h // 2, w // 2, h, w)
    return out


def gaussian_levels(frame, n_scales, down):
  """[frame, frame / 2, ...]: the pyramid's `n_scales` levels, finest
  first, each `down` (``pyramid_down`` or ``pyramid_down_plain``) of the
  one before (the frame as it is, the others float32), under one
  ``hdrnet.model.levels`` span as ``gaussian_pyramid`` opens."""
  levels = [frame]
  with span('hdrnet.model.levels'):
    for _ in range(n_scales - 1):
      levels.append(down(levels[-1]))
  return levels
