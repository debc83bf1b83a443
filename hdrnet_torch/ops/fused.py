"""Fused guide + bilateral slice + affine apply: kernels K1, K6 and K7.

``enhance_fused`` is the serving op of the HDRNet models: from an NHWC
frame and the packed bilateral grid it computes the guide per pixel,
slices the grid trilinearly at it, applies the 3x4 affine, and
optionally clips and requantizes to uint8. It has the semantics of
``hdrnet_tpu.ops.pallas.enhance_fused`` on NHWC frames instead of
channel-first ones, in its two guide modes: ``'curves'`` (K1, the
``HDRNetCurves`` guide) and ``'nn'`` (K6, the pointwise MLP guide of
``HDRNetPointwiseNNGuide`` and of each ``HDRNetGaussianPyrNN`` level,
with its batch norm folded into the first layer). Both take K7's
arguments: a pixel offset and a total extent, for a band of a larger
frame whose pixels must take the taps of the whole frame.

On a CUDA tensor it launches the hand-written kernel in
``csrc/fused_slice_apply.cu``; on a CPU tensor it runs
``enhance_fused_plain``: the guide in torch, the forward of
:mod:`hdrnet_torch.ops.reference`, then the affine, clip and quantize.
The op is also registered as ``hdrnet::enhance_fused``, which
``torch.export`` records in a graph: its implementation is the same
device-picked route.
"""

from __future__ import annotations

from typing import Optional

import torch

from hdrnet_torch.ops import _build
from hdrnet_torch.ops import reference as ref
from hdrnet_torch.ops.downsample import to_unit
from hdrnet_torch.utils.timing import span

N_IN = 3
N_OUT = 3
N_PTS = 16
N_CHANNELS = N_OUT * (N_IN + 1)  # packed grid channels
# Packed guide parameters: ccm_ext (4, 3) | shifts (3, 16) | slopes (3, 16)
# | mix (4,), the layout csrc/fused_slice_apply.cu reads.
N_PARAMS = (N_IN + 1) * N_IN + 2 * N_IN * N_PTS + N_IN + 1
# The NN guide's width bound: its (N_IN + 2) * gc + 1 packed parameters
# are staged in the kernel's static shared memory (kMaxGC there).
MAX_GUIDE_COMPLEXITY = 64
GUIDE_MODES = ('curves', 'nn')


def pack_curves_params(ccm_ext, curves, mix):
  """Packs the curves guide's parameters into one (112,) float32 vector.

  ccm_ext (n_in+1, n_in): color matrix with the bias as its last row;
  curves (2*n_in, n_pts): knot shifts rows, then slope rows;
  mix (n_in+1, 1): channel-mix weights with the bias last.
  (The tuple ``hdrnet_tpu.inference._curves_guide_params`` returns.)
  """
  parts = [torch.as_tensor(a, dtype=torch.float32).reshape(-1)
           for a in (ccm_ext, curves, mix)]
  packed = torch.cat(parts).contiguous()
  if packed.numel() != N_PARAMS:
    raise ValueError(f'curves params pack to {packed.numel()} values, '
                     f'expected {N_PARAMS}')
  return packed


def _unpack(params):
  n, p = N_IN, N_PTS
  ccm_ext = params[:(n + 1) * n].reshape(n + 1, n)
  curves = params[(n + 1) * n:(n + 1) * n + 2 * n * p].reshape(2 * n, p)
  mix = params[(n + 1) * n + 2 * n * p:]
  return ccm_ext, curves[:n], curves[n:], mix


class _Clip01(torch.autograd.Function):
  """clip(x, 0, 1) with JAX's gradient: 1 inside, 0.5 at exactly 0 or 1
  (``jnp.clip`` is min(max(x, 0), 1), and JAX splits a tie's gradient
  between the two arguments), 0 outside. ``torch.clamp`` passes 1 at the
  ties."""

  @staticmethod
  def forward(ctx, x):
    ctx.save_for_backward(x)
    return torch.clamp(x, 0.0, 1.0)

  @staticmethod
  def backward(ctx, g):
    (x,) = ctx.saved_tensors
    inside = ((x > 0.0) & (x < 1.0)).to(g.dtype)
    tie = ((x == 0.0) | (x == 1.0)).to(g.dtype)
    return g * (inside + 0.5 * tie)


def curves_guide(img, ccm_ext, shifts, slopes, mix):
  """(..., n) float32 image -> (...) guide in [0, 1], in the literal relu
  form: color matrix + bias, a sum of shifted ReLUs over the knots of each
  channel, channel mix + bias, clip. Elementwise products only, so no
  TF32 matmul on the card. The gradients at ties are JAX's: the knot
  ReLUs pass 0 at 0, the final clip 0.5 at 0 and 1.

  ccm_ext (n+1, n) with the bias last; shifts, slopes (n, n_pts);
  mix (n+1,) with the bias last.
  """
  n = img.shape[-1]
  acc = None
  for c in range(n):
    g = ccm_ext[n, c] + img[..., 0] * ccm_ext[0, c]
    for j in range(1, n):
      g = g + img[..., j] * ccm_ext[j, c]
    cur = torch.zeros_like(g)
    for k in range(shifts.shape[1]):
      cur = cur + slopes[c, k] * torch.relu(g - shifts[c, k])
    term = cur * mix[c]
    acc = term if acc is None else acc + term
  return _Clip01.apply(acc + mix[n])


def pack_nn_params(w1_ext, w2_ext):
  """Packs the NN guide's parameters into one ((n_in+2)*gc + 1,) float32
  vector: w1_ext (n_in+1, gc) row-major (conv1 with the batch norm
  folded in, the bias as its last row), then w2_ext (gc+1,) (conv2, the
  bias last). (The tuple ``hdrnet_tpu.inference._nn_guide_params``
  returns.)"""
  w1_ext = torch.as_tensor(w1_ext, dtype=torch.float32)
  w2_ext = torch.as_tensor(w2_ext, dtype=torch.float32).reshape(-1)
  if w1_ext.ndim != 2 or w1_ext.shape[0] != N_IN + 1:
    raise ValueError(f'w1_ext must be ({N_IN + 1}, gc), got '
                     f'{tuple(w1_ext.shape)}')
  if w2_ext.numel() != w1_ext.shape[1] + 1:
    raise ValueError(f'w2_ext must hold gc + 1 = {w1_ext.shape[1] + 1} '
                     f'values, got {w2_ext.numel()}')
  return torch.cat([w1_ext.reshape(-1), w2_ext]).contiguous()


def nn_guide_complexity(params):
  """gc of a packed NN-guide vector; raises on a length no gc gives, or
  a gc above MAX_GUIDE_COMPLEXITY."""
  n = params.numel()
  gc, rem = divmod(n - 1, N_IN + 2)
  if rem or gc < 1:
    raise ValueError(f'NN guide params must pack (n_in+2)*gc + 1 values, '
                     f'got {n}')
  if gc > MAX_GUIDE_COMPLEXITY:
    raise ValueError(f'guide complexity {gc} > {MAX_GUIDE_COMPLEXITY}, the '
                     'kernel\'s shared-memory bound')
  return gc


def _unpack_nn(params):
  gc = nn_guide_complexity(params)
  w1_ext = params[:(N_IN + 1) * gc].reshape(N_IN + 1, gc)
  return w1_ext, params[(N_IN + 1) * gc:]


def nn_guide(img, w1_ext, w2_ext):
  """(..., n) float32 image -> (...) guide in (0, 1): the pointwise MLP
  sigmoid(w2 . relu(W1^T x + b1) + b2), with the batch norm already
  folded into W1 and b1.

  w1_ext (n+1, gc) with the bias last; w2_ext (gc+1,) with the bias
  last. Elementwise, one hidden unit at a time, summed in the kernel's
  order (a bias first, then the terms), and the sigmoid in float64
  rounded to float32: each pixel's guide is computed alike whatever the
  frame's extent, so a band's guide is the same rows of the whole
  frame's bit for bit. (A matrix product may sum in another order for
  another number of rows, and a float32 sigmoid may round the last
  elements of a tensor, outside the vector loop, another way.) No TF32
  matmul runs on the card.
  """
  n = img.shape[-1]
  w2_ext = w2_ext.reshape(-1)
  gc = w1_ext.shape[1]
  acc = w2_ext[gc]
  for k in range(gc):
    h = w1_ext[n, k] + img[..., 0] * w1_ext[0, k]
    for j in range(1, n):
      h = h + img[..., j] * w1_ext[j, k]
    acc = acc + torch.relu(h) * w2_ext[k]
  return torch.sigmoid(acc.double()).float()


def _check(grid5, frame, params, clip_output, u8_output, guide_mode):
  if u8_output and not clip_output:
    raise ValueError('u8 output requires clip_output=True')
  if grid5.ndim != 5 or grid5.shape[-1] != N_CHANNELS:
    raise ValueError(f'grid must be (B, gh, gw, gd, {N_CHANNELS}), got '
                     f'{tuple(grid5.shape)}')
  if frame.ndim != 4 or frame.shape[-1] != N_IN:
    raise ValueError(f'frame must be (B, H, W, {N_IN}), got '
                     f'{tuple(frame.shape)}')
  if grid5.shape[0] != frame.shape[0]:
    raise ValueError(f'batch mismatch: grid {grid5.shape[0]}, frame '
                     f'{frame.shape[0]}')
  if grid5.dtype != torch.float32 or params.dtype != torch.float32:
    raise TypeError('grid and params must be float32')
  if frame.dtype not in (torch.float32, torch.uint8):
    raise TypeError(f'frame must be float32 or uint8, got {frame.dtype}')
  if guide_mode not in GUIDE_MODES:
    raise ValueError(f'guide_mode must be one of {GUIDE_MODES}, got '
                     f'{guide_mode!r}')
  if params.ndim != 1:
    raise ValueError(f'params must be a packed vector, got '
                     f'{tuple(params.shape)}')
  if guide_mode == 'curves' and params.shape != (N_PARAMS,):
    raise ValueError(f'curves params must be packed ({N_PARAMS},), got '
                     f'{tuple(params.shape)}')
  if guide_mode == 'nn':
    nn_guide_complexity(params)


def _band(frame, y_offset, x_offset, h_total, w_total):
  """(y_offset, x_offset, h_total, w_total) of the frame as a band: the
  totals default to the frame's extents; raises unless the band lies in
  [0, h_total) x [0, w_total)."""
  _, h, w, _ = frame.shape
  h_total = h if h_total is None else h_total
  w_total = w if w_total is None else w_total
  for name, off, local, total in (('y', y_offset, h, h_total),
                                  ('x', x_offset, w, w_total)):
    if not 0 <= off <= total - local:
      raise ValueError(f'{name} band [{off}, {off + local}) outside '
                       f'[0, {total})')
  return int(y_offset), int(x_offset), int(h_total), int(w_total)


def enhance_fused_plain(grid5, frame, params, guide_mode='curves',
                        clip_output=False, u8_output=False, y_offset=0,
                        x_offset=0, h_total=None, w_total=None):
  """Plain-torch K1 (curves) and K6 (nn), with K7's band arguments:
  (B, gh, gw, gd, 12) grid, (B, H, W, 3) frame -> (B, H, W, 3) float32,
  or uint8 with ``u8_output``."""
  _check(grid5, frame, params, clip_output, u8_output, guide_mode)
  band = _band(frame, y_offset, x_offset, h_total, w_total)
  img = to_unit(frame)
  if guide_mode == 'curves':
    guide = curves_guide(img, *_unpack(params))
  else:
    guide = nn_guide(img, *_unpack_nn(params))
  b, gh, gw, gd, _ = grid5.shape
  grid6 = grid5.reshape(b, gh, gw, gd, N_OUT, N_IN + 1)
  out = ref.bilateral_slice_apply(grid6, guide, img, has_offset=True,
                                  band=band)
  if clip_output:
    out = torch.clamp(out, 0.0, 1.0)
  if u8_output:
    out = (out * 255.0 + 0.5).to(torch.int32).to(torch.uint8)
  return out


def enhance_fused(grid5, frame, params, guide_mode='curves',
                  clip_output=False, u8_output=False, y_offset=0, x_offset=0,
                  h_total=None, w_total=None):
  """Fused guide + slice + apply.

  grid5: (B, gh, gw, gd, 12) float32, the packed grid (channel
    i * 4 + j holds affine entry [i, j]; j = 3 is the offset).
  frame: (B, H, W, 3) float32, or uint8 (divided by 255 in the kernel).
  params: the packed guide parameters: (112,) float32 from
    ``pack_curves_params`` for ``guide_mode='curves'``; ((n_in+2)*gc + 1,)
    float32 from ``pack_nn_params`` for ``'nn'``, gc <=
    MAX_GUIDE_COMPLEXITY.
  clip_output: clip to [0, 1]. u8_output: requantize the clipped result
    to uint8 as trunc(v * 255 + 0.5); needs ``clip_output``.
  y_offset, x_offset, h_total, w_total (K7): the frame is the band of rows
    [y_offset, y_offset + H) and columns [x_offset, x_offset + W) of an
    h_total x w_total frame (by default the frame is whole): each pixel is
    sliced where the same pixel of the whole frame is, at the scales
    gh / h_total and gw / w_total.
  Returns (B, H, W, 3) float32 or uint8.

  CUDA tensors: kernel K1 (curves) or K6 (nn). CPU tensors:
  ``enhance_fused_plain``. Under ``torch.export`` the call is recorded as
  ``hdrnet::enhance_fused``.
  """
  if torch.compiler.is_compiling():
    return torch.ops.hdrnet.enhance_fused(
        grid5, frame, params, guide_mode, clip_output, u8_output, y_offset,
        x_offset, h_total, w_total)
  with span('hdrnet.ops.fused'):
    return _enhance_fused(grid5, frame, params, guide_mode, clip_output,
                          u8_output, y_offset, x_offset, h_total, w_total)


@torch.library.custom_op('hdrnet::enhance_fused', mutates_args=(),
                         device_types=('cpu', 'cuda'))
def _enhance_fused_op(grid5: torch.Tensor, frame: torch.Tensor,
                      params: torch.Tensor, guide_mode: str,
                      clip_output: bool, u8_output: bool, y_offset: int,
                      x_offset: int, h_total: Optional[int],
                      w_total: Optional[int]) -> torch.Tensor:
  return _enhance_fused(grid5, frame, params, guide_mode, clip_output,
                        u8_output, y_offset, x_offset, h_total, w_total)


@_enhance_fused_op.register_fake
def _(grid5, frame, params, guide_mode, clip_output, u8_output, *band):
  del band
  _check(grid5, frame, params, clip_output, u8_output, guide_mode)
  return frame.new_empty((*frame.shape[:3], N_OUT),
                         dtype=torch.uint8 if u8_output else torch.float32)


def _enhance_fused(grid5, frame, params, guide_mode, clip_output, u8_output,
                   y_offset, x_offset, h_total, w_total):
  _check(grid5, frame, params, clip_output, u8_output, guide_mode)
  y_off, x_off, h_total, w_total = _band(frame, y_offset, x_offset, h_total,
                                         w_total)
  if not _build.on_card('enhance_fused', grid5, frame, params):
    return enhance_fused_plain(grid5, frame, params, guide_mode, clip_output,
                               u8_output, y_off, x_off, h_total, w_total)
  if grid5.data_ptr() % 16:
    raise ValueError('grid must be 16-byte aligned (the kernel reads float4)')
  b, h, w, _ = frame.shape
  _, gh, gw, gd, _ = grid5.shape
  if w * N_IN >= 2**31:
    # Larger frames run in H-bands inside the launcher; a row must fit.
    raise ValueError(f'a row of {w} pixels exceeds the kernel\'s 32-bit '
                     f'index (W * {N_IN} < 2^31)')
  out = torch.empty((b, h, w, N_OUT),
                    dtype=torch.uint8 if u8_output else torch.float32,
                    device=frame.device)
  # The scales in double, rounded to float32 by ctypes: the same value a
  # whole frame of h_total x w_total gets, so its bands slice alike.
  band = (y_off, x_off, h_total, w_total, gh / h_total, gw / w_total)
  ptrs = (grid5.data_ptr(), frame.data_ptr(), int(frame.dtype == torch.uint8),
          params.data_ptr())
  if guide_mode == 'curves':
    _build.launch('hdrnet_enhance_fused', frame.device, *ptrs,
                  out.data_ptr(), int(u8_output), int(clip_output), b, h, w,
                  gh, gw, gd, *band)
  else:
    _build.launch('hdrnet_enhance_fused_nn', frame.device, *ptrs,
                  nn_guide_complexity(params), out.data_ptr(), int(u8_output),
                  int(clip_output), b, h, w, gh, gw, gd, *band)
  if (y_off, x_off, h_total, w_total) != (0, 0, h, w):
    _build.launches['enhance_fused_band'] += 1
  return out
