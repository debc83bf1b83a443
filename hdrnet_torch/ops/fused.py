"""Fused curves guide + bilateral slice + affine apply, kernel K1.

``enhance_fused`` is the serving op of ``HDRNetCurves``: from an NHWC
frame and the packed bilateral grid it computes the curves guide per
pixel, slices the grid trilinearly at it, applies the 3x4 affine, and
optionally clips and requantizes to uint8. It has the semantics of
``hdrnet_tpu.ops.pallas.enhance_fused`` in curves mode, on NHWC frames
instead of channel-first ones.

On a CUDA tensor it launches the hand-written kernel in
``csrc/fused_slice_apply.cu``; on a CPU tensor it runs
``enhance_fused_plain``: the guide in torch, the forward of
:mod:`hdrnet_torch.ops.reference`, then the affine, clip and quantize.
"""

from __future__ import annotations

import torch

from hdrnet_torch.ops import _build
from hdrnet_torch.ops import reference as ref
from hdrnet_torch.ops.downsample import to_unit

N_IN = 3
N_OUT = 3
N_PTS = 16
N_CHANNELS = N_OUT * (N_IN + 1)  # packed grid channels
# Packed guide parameters: ccm_ext (4, 3) | shifts (3, 16) | slopes (3, 16)
# | mix (4,), the layout csrc/fused_slice_apply.cu reads.
N_PARAMS = (N_IN + 1) * N_IN + 2 * N_IN * N_PTS + N_IN + 1

# Kernel launches by enhance_fused (never by the plain version).
launches = 0


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


def _check(grid5, frame, params, clip_output, u8_output):
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
  if params.shape != (N_PARAMS,):
    raise ValueError(f'params must be packed ({N_PARAMS},), got '
                     f'{tuple(params.shape)}')


def enhance_fused_plain(grid5, frame, params, clip_output=False,
                        u8_output=False):
  """Plain-torch K1: (B, gh, gw, gd, 12) grid, (B, H, W, 3) frame ->
  (B, H, W, 3) float32, or uint8 with ``u8_output``."""
  _check(grid5, frame, params, clip_output, u8_output)
  img = to_unit(frame)
  guide = curves_guide(img, *_unpack(params))
  b, gh, gw, gd, _ = grid5.shape
  grid6 = grid5.reshape(b, gh, gw, gd, N_OUT, N_IN + 1)
  out = ref.bilateral_slice_apply(grid6, guide, img, has_offset=True)
  if clip_output:
    out = torch.clamp(out, 0.0, 1.0)
  if u8_output:
    out = (out * 255.0 + 0.5).to(torch.int32).to(torch.uint8)
  return out


def enhance_fused(grid5, frame, params, clip_output=False, u8_output=False):
  """Fused guide + slice + apply.

  grid5: (B, gh, gw, gd, 12) float32, the packed grid (channel
    i * 4 + j holds affine entry [i, j]; j = 3 is the offset).
  frame: (B, H, W, 3) float32, or uint8 (divided by 255 in the kernel).
  params: (112,) float32 from ``pack_curves_params``.
  clip_output: clip to [0, 1]. u8_output: requantize the clipped result
    to uint8 as trunc(v * 255 + 0.5); needs ``clip_output``.
  Returns (B, H, W, 3) float32 or uint8.

  CUDA tensors: kernel K1. CPU tensors: ``enhance_fused_plain``.
  """
  global launches
  _check(grid5, frame, params, clip_output, u8_output)
  devices = {grid5.device, frame.device, params.device}
  if len(devices) != 1:
    raise ValueError(f'tensors on different devices: {devices}')
  if frame.device.type == 'cpu':
    return enhance_fused_plain(grid5, frame, params, clip_output, u8_output)
  if frame.device.type != 'cuda':
    raise ValueError(f'unsupported device {frame.device}')
  for name, t in (('grid', grid5), ('frame', frame), ('params', params)):
    if not t.is_contiguous():
      raise ValueError(f'{name} must be contiguous')
  if grid5.data_ptr() % 16:
    raise ValueError('grid must be 16-byte aligned (the kernel reads float4)')
  b, h, w, _ = frame.shape
  _, gh, gw, gd, _ = grid5.shape
  out = torch.empty((b, h, w, N_OUT),
                    dtype=torch.uint8 if u8_output else torch.float32,
                    device=frame.device)
  lib = _build.library().lib
  with torch.cuda.device(frame.device):
    stream = torch.cuda.current_stream(frame.device).cuda_stream
    err = lib.hdrnet_enhance_fused(
        grid5.data_ptr(), frame.data_ptr(), int(frame.dtype == torch.uint8),
        params.data_ptr(), out.data_ptr(), int(u8_output), int(clip_output),
        b, h, w, gh, gw, gd, gh / h, gw / w, stream)
  _build.check(err, 'hdrnet_enhance_fused')
  launches += 1
  return out
