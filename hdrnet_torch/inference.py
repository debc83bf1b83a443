"""Serving path of the HDRNet models (counterpart of
``hdrnet_tpu.inference.Enhancer``).

Per frame: cut the nearest preview from the frame (kernel K2,
``ops.downsample``), run the coefficient CNN on it (plain torch convs in
full float32), and do the guide, slice, affine apply and clip at full
resolution in one pass (``ops.fused``): kernel K1 for ``HDRNetCurves``'s
curves guide, K6 for ``HDRNetPointwiseNNGuide``'s NN guide. For
``HDRNetGaussianPyrNN`` the frame's bilinear pyramid is built in torch,
K6 runs once a level on its 3-output block of the grid, and the levels
are upsampled and added coarse to fine before one clip. On a CUDA device
the kernels run; on the CPU the same sequence runs their plain versions.
The device is given by the caller.

``ModelConfig`` (from the standard-library-only ``hdrnet_tpu.config``) is
re-exported here, so callers of the port need no ``hdrnet_tpu`` import.
"""

from __future__ import annotations

import collections
import contextlib

import numpy as np
import torch

from hdrnet_tpu.config import Config, ModelConfig
from hdrnet_torch.models import make_model
from hdrnet_torch.models.hdrnet import (HDRNetGaussianPyrNN, gaussian_pyramid,
                                        upsample_add)
from hdrnet_torch.ops.downsample import nearest_lowres, to_unit
from hdrnet_torch.ops.fused import enhance_fused
from hdrnet_torch.training.checkpoint import latest_checkpoint, load

__all__ = ['Enhancer', 'ModelConfig', 'SERVED_MODELS', 'full_float32']

SERVED_MODELS = ('HDRNetCurves', 'HDRNetPointwiseNNGuide',
                 'HDRNetGaussianPyrNN')


@contextlib.contextmanager
def full_float32():
  """TF32 off for cuDNN convs and cuBLAS matmuls inside the block.

  cuDNN runs float32 convs in TF32 by default; the JAX package computes
  the coefficient CNN in full float32, and a grid error is amplified
  about gd-fold through the guide's depth coordinate.
  """
  saved = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  try:
    yield
  finally:
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved


class Enhancer:
  """Serves full-resolution enhancement with one of ``SERVED_MODELS``.

  config: the ``ModelConfig``. state_dict: converted weights
  (``hdrnet_torch.convert``); without them the model is initialised from
  ``seed``. device: where the model lives and frames must be.
  """

  def __init__(self, config: ModelConfig, state_dict=None, *, device='cpu',
               seed=0):
    if config.model_name not in SERVED_MODELS:
      raise ValueError(f'the port serves {SERVED_MODELS}, got '
                       f'{config.model_name!r}')
    if (config.n_in, config.n_out) != (3, 3):
      raise ValueError('the fused kernel serves 3-channel in and out')
    self.model_cfg = config
    model = make_model(config, generator=torch.Generator().manual_seed(seed))
    if state_dict is not None:
      model.load_state_dict(state_dict)
    self.model = model.to(device).eval()
    self.device = next(self.model.parameters()).device
    self.pyramid = isinstance(model, HDRNetGaussianPyrNN)
    # Packed guide parameters, one vector a guide (BN folded for the NN
    # guides); for the pyramid one a level, finest first.
    if self.pyramid:
      self.guide_mode = 'nn'
      self.guide_params = [g.packed_params() for g in model.level_guides()]
    else:
      self.guide_mode = model.guide.guide_mode
      self.guide_params = model.guide.packed_params()

  @classmethod
  def from_checkpoint(cls, checkpoint_dir, device='cpu'):
    """Serves the newest step that ``hdrnet_torch.training`` saved in
    `checkpoint_dir`, with the architecture of its ``config.json``."""
    path = latest_checkpoint(checkpoint_dir)
    if path is None:
      raise FileNotFoundError(f'no checkpoint in {checkpoint_dir}')
    config = Config.load(checkpoint_dir)
    return cls(config.model, load(path)['model'], device=device)

  def _check_frame(self, frame):
    if frame.device != self.device:
      raise ValueError(f'frame on {frame.device}, model on {self.device}')

  @torch.no_grad()
  def _backbone_grid(self, lowres):
    """NCHW preview (b, n_in, s, s) -> rank-6 grid, in full float32."""
    with full_float32():
      return self.model.coefficients(lowres)

  def _fused_forward(self, lowres, frame, clip, u8_output=False):
    """Backbone on the NCHW preview, then K1 or K6 on the NHWC frame; for
    the pyramid, K6 on each level, the coarse-to-fine sum, then the clip
    (the levels are summed before it, so it cannot ride on the kernel)."""
    grid = self._backbone_grid(lowres)
    b, gh, gw, gd, _, ni1 = grid.shape
    if not self.pyramid:
      packed = grid.reshape(b, gh, gw, gd, -1)
      return enhance_fused(packed, frame, self.guide_params, self.guide_mode,
                           clip_output=clip, u8_output=u8_output)
    levels = gaussian_pyramid(frame, len(self.guide_params))
    current = None
    for il, (lvl, params) in enumerate(zip(levels[::-1],
                                           self.guide_params[::-1])):
      sub = grid[..., 3 * il:3 * (il + 1), :].reshape(b, gh, gw, gd, 3 * ni1)
      out = enhance_fused(sub.contiguous(), lvl.contiguous(), params, 'nn')
      current = out if current is None else upsample_add(current, out)
    return torch.clamp(current, 0.0, 1.0) if clip else current

  def __call__(self, lowres, fullres, clip=True):
    """Enhance with a given NHWC preview: (b, s, s, 3), (b, H, W, 3)."""
    self._check_frame(lowres)
    self._check_frame(fullres)
    return self._fused_forward(lowres.permute(0, 3, 1, 2), fullres, clip)

  def process(self, frame, clip=True):
    """Enhance one (B, H, W, 3) float32 frame end to end: preview
    downsample, coefficients, guide + slice + apply (per level for the
    pyramid)."""
    self._check_frame(frame)
    low = nearest_lowres(frame, self.model_cfg.net_input_size)
    return self._fused_forward(low, frame, clip)

  def make_stream_fn(self, full_shape):
    """uint8-in, uint8-out pipeline step for frames of `full_shape`
    (B, H, W, 3) on the device: K2 and K1 (K6) dequantize in the kernel
    and K1 (K6) requantizes the clipped result, so the frame stays uint8.
    The pyramid dequantizes the frame to float32, runs, clips and
    requantizes as trunc(x * 255 + 0.5) in torch, as the JAX package's
    fallback does."""
    full_shape = tuple(full_shape)
    s = self.model_cfg.net_input_size

    def fn(frame_u8):
      if tuple(frame_u8.shape) != full_shape or frame_u8.dtype != torch.uint8:
        raise ValueError(f'expected uint8 {full_shape}, got '
                         f'{frame_u8.dtype} {tuple(frame_u8.shape)}')
      self._check_frame(frame_u8)
      low = nearest_lowres(frame_u8, s)
      if not self.pyramid:
        return self._fused_forward(low, frame_u8, clip=True, u8_output=True)
      out = self._fused_forward(low, to_unit(frame_u8), clip=True)
      # Two roundings (the product, then the sum), then truncation.
      return (out * 255.0 + 0.5).to(torch.int32).to(torch.uint8)
    return fn

  def stream(self, frames, depth=2):
    """Enhance an iterable of uint8 numpy frames, yielding uint8 numpy
    frames in order.

    On a CUDA device, the upload of frame k+1 and the readback of frame
    k-depth are queued behind the kernels of frame k (pinned host
    buffers, non-blocking copies); the generator waits only on the
    oldest frame in flight.
    """
    cuda = self.device.type == 'cuda'
    fns = {}
    pending = collections.deque()
    for f in frames:
      if f.dtype != np.uint8:
        raise TypeError(f'stream() takes uint8 frames, got {f.dtype}')
      if f.shape not in fns:
        fns[f.shape] = self.make_stream_fn(f.shape)
      x = torch.from_numpy(np.ascontiguousarray(f))
      if cuda:
        x = x.pin_memory().to(self.device, non_blocking=True)
      out = fns[f.shape](x)
      if cuda:
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        pending.append((host, done))
      else:
        pending.append((out, None))
      if len(pending) > depth:
        yield _finish(*pending.popleft())
    while pending:
      yield _finish(*pending.popleft())


def _finish(out, done):
  if done is not None:
    done.synchronize()
  return out.numpy()
