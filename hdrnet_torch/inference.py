"""Serving path of the HDRNet models (counterpart of
``hdrnet_tpu.inference.Enhancer``).

Two routes. The fused route serves ``HDRNetCurves``,
``HDRNetPointwiseNNGuide`` and ``HDRNetGaussianPyrNN`` (those classes
exactly, at 3 channels in and out). Per frame: cut the nearest preview
from the frame (kernel K2, ``ops.downsample``), run the coefficient CNN
on it (plain torch convs in full float32, or a bfloat16 copy with
``coeff_bf16``), and do the guide, slice, affine apply and clip at full
resolution in one pass (``ops.fused``): kernel K1 for the curves guide,
K6 for the NN guide. For the pyramid the frame's bilinear pyramid is
built by kernel ``pyramid_down`` (``ops.levels``), K6 runs once a level on
its 3-output block of the grid (the finest straight from the frame,
uint8 or float32), and kernel ``pyramid_up_add`` sums the levels coarse
to fine, the last step with the clip (and, streaming, the requantize).
A giant frame can be cut into H-bands, one a device, each band running
K1 or K6 with K7's offset arguments (``enhance_sharded``).

The composite route serves every other model (the extended zoo, the
baselines, the style models at 6 channels): K2's preview, then the
model's own forward in full float32 with gradients off (its slice-apply
is kernel K3), then the clip, as the JAX package's composite path
serves them.

Frames of any size are served at their exact shape (``enhance_any``).
On a CUDA device the kernels run; on the CPU the same sequence runs
their plain versions. The device is CUDA unless the caller asks for the
CPU.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import functools
import logging

import numpy as np
import torch

from hdrnet_torch.config import Config, ModelConfig
from hdrnet_torch.models import make_model
from hdrnet_torch.models.hdrnet import (HDRNetCurves, HDRNetGaussianPyrNN,
                                        HDRNetPointwiseNNGuide)
from hdrnet_torch.ops.downsample import nearest_lowres, to_unit
from hdrnet_torch.ops.fused import enhance_fused
from hdrnet_torch.ops.graph import CapturedGraph
from hdrnet_torch.ops.levels import (gaussian_levels, pyramid_down,
                                     pyramid_up_add, requantize)
from hdrnet_torch.training.checkpoint import latest_checkpoint, load
from hdrnet_torch.utils.timing import span

__all__ = ['Enhancer', 'FUSED_MODELS', 'ModelConfig', 'full_float32',
           'resolve_device']

log = logging.getLogger('hdrnet_torch.inference')

# The classes the fused kernels serve, matched exactly: a subclass with
# another guide (HDRNet3x3NNGuide is an HDRNetCurves) takes the composite
# route.
FUSED_MODELS = (HDRNetCurves, HDRNetPointwiseNNGuide, HDRNetGaussianPyrNN)

# Frame shapes whose stream forward an Enhancer holds as a CUDA graph (the
# least recently used dropped), and shapes seen once that it remembers.
_GRAPH_SHAPES = 4
_SEEN_SHAPES = 64

# CUDA graphs captured and replayed by Enhancer.stream in this process.
graph_captures = 0
graph_replays = 0


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


def resolve_device(device):
  """``torch.device(device)``; raises if it is a CUDA device and CUDA is
  not available. The port's entry points run on the card unless the
  caller asks for the CPU, and never move to the CPU on their own."""
  device = torch.device(device)
  if device.type == 'cuda' and not torch.cuda.is_available():
    raise RuntimeError(f'device {device} asked for, but CUDA is not '
                       "available; pass device='cpu' to run on the CPU")
  return device


class Enhancer:
  """Serves full-resolution enhancement with any model of the registry.

  config: the ``ModelConfig``. state_dict: converted weights
  (``hdrnet_torch.convert``); without them the model is initialised from
  ``seed``. device: where the model lives and frames must be; CUDA by
  default (raises without it), ``'cpu'`` for the plain versions.
  coeff_bf16: run the fused route's coefficient backbone as a bfloat16
  copy on a bfloat16 preview, the grid cast back to float32 (serving
  only; the composite route stays float32 and logs a warning).

  ``fused`` and ``coeff_bf16`` say what the Enhancer runs: the fused
  route for the three classes of ``FUSED_MODELS`` at 3 channels in and
  out, the composite route otherwise.
  """

  def __init__(self, config: ModelConfig, state_dict=None, *, device='cuda',
               seed=0, coeff_bf16=False):
    device = resolve_device(device)
    self.model_cfg = config
    model = make_model(config, generator=torch.Generator().manual_seed(seed))
    if state_dict is not None:
      model.load_state_dict(state_dict)
    self.model = model.to(device).eval()
    self.device = next(self.model.parameters()).device
    self.fused = (type(model) in FUSED_MODELS
                  and (config.n_in, config.n_out) == (3, 3))
    if coeff_bf16 and not self.fused:
      log.warning('Enhancer: coeff_bf16 applies to the fused route only; '
                  '%s is served by the composite route in float32',
                  type(model).__name__)
    self.coeff_bf16 = bool(coeff_bf16) and self.fused
    # stream()'s graphs by frame shape (None: the shape runs eagerly), and
    # the shapes seen once.
    self._graphs = collections.OrderedDict()
    self._seen = collections.OrderedDict()
    if not self.fused:
      return
    self.pyramid = type(model) is HDRNetGaussianPyrNN
    # Packed guide parameters, one vector a guide (BN folded for the NN
    # guides); for the pyramid one a level, finest first.
    if self.pyramid:
      self.guide_mode = 'nn'
      self.guide_params = [g.packed_params() for g in model.level_guides()]
    else:
      self.guide_mode = model.guide.guide_mode
      self.guide_params = model.guide.packed_params()
    if self.coeff_bf16:
      # Every floating parameter and buffer cast, BN statistics included,
      # as the JAX package casts the backbone's variables.
      self.bf16_coefficients = copy.deepcopy(model.coefficients).to(
          torch.bfloat16)

  @classmethod
  def from_checkpoint(cls, checkpoint_dir, device='cuda', coeff_bf16=False):
    """Serves the newest step that ``hdrnet_torch.training`` saved in
    `checkpoint_dir`, with the architecture of its ``config.json``."""
    path = latest_checkpoint(checkpoint_dir)
    if path is None:
      raise FileNotFoundError(f'no checkpoint in {checkpoint_dir}')
    config = Config.load(checkpoint_dir)
    return cls(config.model, load(path)['model'], device=device,
               coeff_bf16=coeff_bf16)

  def _check_frame(self, frame):
    if frame.device != self.device:
      raise ValueError(f'frame on {frame.device}, model on {self.device}')

  def on_device(self, x):
    """A numpy array copied to the Enhancer's device; a tensor must be on
    it already."""
    if isinstance(x, np.ndarray):
      return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
    self._check_frame(x)
    return x

  @torch.no_grad()
  def _backbone_grid(self, lowres):
    """NCHW preview (b, n_in, s, s) -> rank-6 grid, in full float32, or
    with ``coeff_bf16`` through the bfloat16 backbone on a bfloat16
    preview, cast back to float32. The preview is made contiguous, so a
    permuted NHWC one takes the same convolution algorithms as K2's
    output."""
    if self.coeff_bf16:
      return self.bf16_coefficients(
          lowres.contiguous().to(torch.bfloat16)).to(torch.float32)
    with full_float32():
      return self.model.coefficients(lowres.contiguous())

  @torch.no_grad()
  def _composite_forward(self, lowres, fullres, clip):
    """The composite route: the model's forward on the NHWC preview and
    frame in full float32 (K3 for its slice-apply on the card), then the
    clip."""
    with full_float32():
      out = self.model(lowres, fullres)
    return torch.clamp(out, 0.0, 1.0) if clip else out

  def _fused_forward(self, lowres, frame, clip, u8_output=False):
    """Backbone on the NCHW preview, then ``_apply_grid`` with K1 or K6 on
    the whole frame."""
    return self._apply_grid(self._backbone_grid(lowres), frame,
                            enhance_fused, clip, u8_output)

  def _apply_grid(self, grid, frame, fused, clip, u8_output=False):
    """The rank-6 grid applied to the NHWC frame (float32, or uint8 divided
    by 255 in the kernels) by `fused`, ``enhance_fused`` or its banded form:
    K1 or K6, clipped if `clip` and requantized to uint8 with `u8_output`.
    For the pyramid: its levels (``pyramid_down``), K6 on each, and the
    coarse-to-fine sum (``pyramid_up_add``), whose last step clips and
    requantizes (the levels are summed before the clip, so it cannot ride
    on K6)."""
    b, gh, gw, gd, _, ni1 = grid.shape
    if not self.pyramid:
      packed = grid.reshape(b, gh, gw, gd, -1)
      return fused(packed, frame, self.guide_params, self.guide_mode,
                   clip_output=clip, u8_output=u8_output)
    levels = gaussian_levels(frame.contiguous(), len(self.guide_params),
                             pyramid_down)
    current = None
    for il, (lvl, params) in enumerate(zip(levels[::-1],
                                           self.guide_params[::-1])):
      sub = grid[..., 3 * il:3 * (il + 1), :].reshape(b, gh, gw, gd, 3 * ni1)
      last = il == len(levels) - 1
      ends = dict(clip_output=clip and last, u8_output=u8_output and last)
      if current is None:
        current = fused(sub.contiguous(), lvl, params, 'nn', **ends)
      else:
        current = pyramid_up_add(
            current, fused(sub.contiguous(), lvl, params, 'nn'), **ends)
    return current

  def __call__(self, lowres, fullres, clip=True):
    """Enhance with a given NHWC preview: (b, s, s, n_in), (b, H, W, n_in)."""
    self._check_frame(lowres)
    self._check_frame(fullres)
    with span('hdrnet.serve.forward'):
      if not self.fused:
        return self._composite_forward(lowres, fullres, clip)
      return self._fused_forward(lowres.permute(0, 3, 1, 2), fullres, clip)

  def enhance_any(self, lowres, fullres, clip=True):
    """Arbitrary-resolution serving (the reference run.py use case,
    bin/run.py:87-90): (b, s, s, 3) preview, (b, H, W, 3) frame of any H
    and W, as numpy arrays (copied to the Enhancer's device) or tensors
    already there. Returns the (b, H, W, 3) result on the device.

    H and W are runtime arguments of the kernels, so the exact shape is
    served for every model: no padding, no size buckets and nothing
    compiled per shape (the JAX package pads to a bucket and passes the
    true size, so that one Mosaic compile serves the bucket).
    """
    return self(self.on_device(lowres), self.on_device(fullres),
                clip=clip)

  def enhance_sharded(self, lowres, fullres, devices, clip=True):
    """Giant-frame serving, the frame cut into H-bands, one a device
    (counterpart of the JAX ``enhance_sharded`` over a mesh).

    lowres (b, s, s, 3), fullres (b, H, W, 3): numpy arrays or tensors on
    the Enhancer's device. devices: a sequence of CUDA devices, or of
    ``'cpu'`` only, in band order; a device may repeat (``[dev] * 4`` runs
    four bands on one card, one after the other). H must be divisible by
    len(devices) * 2**(levels - 1), as the JAX package requires.

    The backbone runs once, on the Enhancer's device; the grid and the
    guide parameters are copied to each device. Band i of n holds rows
    [i H/n, (i+1) H/n) and runs K1 or K6 with K7's arguments y_offset =
    i H/n and h_total = H, so every pixel is sliced as in the whole
    frame and the result is bit-identical to ``__call__``'s. The bands
    are gathered on ``devices[0]``, where the result is returned. The
    pyramid runs ``__call__``'s loop: its levels and coarse-to-fine sum
    on ``devices[0]`` over whole levels (what the JAX package gets from
    XLA's halo exchanges), each level's K6 band by band with that
    level's offsets. Copies between distinct cards are plain tensor
    copies; no test here runs more than one card.
    """
    if not self.fused:
      raise ValueError(
          f'enhance_sharded cuts the frame into bands for the fused '
          f'kernel, which does not serve {type(self.model).__name__} at '
          f'{self.model_cfg.n_in} -> {self.model_cfg.n_out} channels; use '
          f'process or enhance_any')
    devices = [torch.device(d) for d in devices]
    kinds = {d.type for d in devices}
    if not devices or len(kinds) != 1 or not kinds <= {'cpu', 'cuda'}:
      raise ValueError(f'devices must be all CUDA devices or all cpu, got '
                       f'{devices}')
    for d in devices:
      resolve_device(d)
    lowres, fullres = self.on_device(lowres), self.on_device(fullres)
    h = fullres.shape[1]
    n_levels = len(self.guide_params) if self.pyramid else 1
    if h % (len(devices) * 2 ** (n_levels - 1)):
      raise ValueError(f'height {h} is not divisible by {len(devices)} '
                       f'bands x 2^{n_levels - 1} pyramid halvings')
    grid = self._backbone_grid(lowres.permute(0, 3, 1, 2))
    return self._apply_grid(grid, fullres.to(devices[0]),
                            functools.partial(_banded, devices=devices), clip)

  def process(self, frame, clip=True):
    """Enhance one (B, H, W, n_in) float32 frame end to end: preview
    downsample, coefficients, guide + slice + apply (per level for the
    pyramid); on the composite route the model's forward on K2's
    preview."""
    self._check_frame(frame)
    with span('hdrnet.serve.forward'):
      low = nearest_lowres(frame, self.model_cfg.net_input_size)
      if not self.fused:
        return self._composite_forward(low.permute(0, 2, 3, 1), frame, clip)
      return self._fused_forward(low, frame, clip)

  def make_stream_fn(self, full_shape):
    """uint8-in, uint8-out pipeline step for frames of `full_shape`
    (B, H, W, n_in) on the device: on the fused route K2, K1 or K6 and the
    pyramid's level kernels dequantize in the kernel, and K1 (or the
    pyramid's last ``pyramid_up_add``) requantizes the clipped result as
    trunc(x * 255 + 0.5), so the frame stays uint8. The composite route
    dequantizes the frame to float32 (exact /255), runs, clips and
    requantizes in torch, as the JAX package's composite stream does."""
    full_shape = tuple(full_shape)
    s = self.model_cfg.net_input_size

    def fn(frame_u8):
      if tuple(frame_u8.shape) != full_shape or frame_u8.dtype != torch.uint8:
        raise ValueError(f'expected uint8 {full_shape}, got '
                         f'{frame_u8.dtype} {tuple(frame_u8.shape)}')
      self._check_frame(frame_u8)
      with span('hdrnet.serve.forward'):
        low = nearest_lowres(frame_u8, s)
        if self.fused:
          return self._fused_forward(low, frame_u8, clip=True,
                                     u8_output=True)
        return requantize(self._composite_forward(
            low.permute(0, 2, 3, 1), to_unit(frame_u8), clip=True))
    return fn

  def stream(self, frames, depth=2):
    """Enhance an iterable of uint8 numpy frames, yielding uint8 numpy
    frames in order.

    On a CUDA device, the upload of frame k+1 and the readback of frame
    k-depth are queued behind the kernels of frame k (pinned host
    buffers, non-blocking copies); the generator waits only on the
    oldest frame in flight. Each result is a fresh array of the caller's.

    On the fused route on a CUDA device, the forward (``make_stream_fn``'s
    function) of a frame shape seen before is replayed as one CUDA graph,
    captured at the shape's second frame and kept by the Enhancer for
    later streams (a few shapes); the first frame of a shape runs
    eagerly, as does a shape whose capture failed. The frame is uploaded
    into the graph's input and the result read back from its output, all
    on the current stream, so a frame's upload waits for the replay
    before it and a replay for the readback before it.

    With a profiler recording, a frame's phases are the spans
    ``hdrnet.stream.pin`` (the pageable-to-pinned copy), ``.upload``,
    ``hdrnet.serve.forward`` (around ``hdrnet.serve.replay`` where the
    graph runs), ``hdrnet.stream.readback`` and, where the oldest frame
    is waited for, ``hdrnet.stream.wait``; a capture is
    ``hdrnet.serve.capture``.
    """
    cuda = self.device.type == 'cuda'
    graphed = cuda and self.fused
    fns = {}
    pending = collections.deque()
    for f in frames:
      if f.dtype != np.uint8:
        raise TypeError(f'stream() takes uint8 frames, got {f.dtype}')
      if f.shape not in fns:
        fns[f.shape] = self.make_stream_fn(f.shape)
      if not cuda:
        pending.append((fns[f.shape](torch.from_numpy(
            np.ascontiguousarray(f))), None))
      else:
        with span('hdrnet.stream.pin'):
          x = torch.from_numpy(np.ascontiguousarray(f)).pin_memory()
        graph = self._stream_graph(f.shape, fns[f.shape]) if graphed else None
        if graph is None:
          with span('hdrnet.stream.upload'):
            x = x.to(self.device, non_blocking=True)
          out = fns[f.shape](x)
        else:
          with span('hdrnet.stream.upload'):
            graph.frame.copy_(x, non_blocking=True)
          with span('hdrnet.serve.forward'), span('hdrnet.serve.replay'):
            out = graph.replay()
        with span('hdrnet.stream.readback'):
          host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
          host.copy_(out, non_blocking=True)
          done = torch.cuda.Event()
          done.record()
        pending.append((host, done))
      if len(pending) > depth:
        yield _finish(*pending.popleft())
    while pending:
      yield _finish(*pending.popleft())

  def _stream_graph(self, shape, fn):
    """The captured forward `fn` of frames of `shape`, or None where the
    frame runs eagerly: the shape's first frame, whose eager run builds
    the tables and handles that a capture must find made, and a shape
    whose capture failed."""
    if shape in self._graphs:
      self._graphs.move_to_end(shape)
      return self._graphs[shape]
    if shape not in self._seen:
      self._seen[shape] = None
      if len(self._seen) > _SEEN_SHAPES:
        self._seen.popitem(last=False)
      return None
    del self._seen[shape]
    try:
      graph = _StreamGraph(fn, shape, self.device)
    except RuntimeError:
      log.warning('Enhancer.stream: capturing the forward of %s frames '
                  'as a CUDA graph failed; they run eagerly', shape,
                  exc_info=True)
      graph = None
    self._graphs[shape] = graph
    # The capture waited for the device, so no replay of a dropped graph
    # is in flight.
    if len(self._graphs) > _GRAPH_SHAPES:
      self._graphs.popitem(last=False)
    return graph


class _StreamGraph(CapturedGraph):
  """`fn` on a uint8 frame of `shape`, captured as a CUDA graph: the
  frame goes into ``frame``, and ``replay()`` runs the captured launches
  and returns the output, which the next replay overwrites. ``tables``
  keeps the cached device tables that the launches read."""

  def __init__(self, fn, shape, device):
    global graph_captures
    self.frame = torch.empty(shape, dtype=torch.uint8, device=device)
    with torch.no_grad():
      super().__init__(lambda: fn(self.frame), 'hdrnet.serve.capture')
    graph_captures += 1

  def replay(self):
    global graph_replays
    out = super().replay()
    graph_replays += 1
    return out


def _banded(packed, frame, params, mode, devices, **ends):
  """``enhance_fused`` (its keywords `ends`) on the len(devices) H-bands of
  `frame`, band i on devices[i] with y_offset = i * h_local and h_total =
  H; the bands concatenated on the frame's device. Each device gets one
  copy of the grid and the parameters, however often it repeats."""
  h = frame.shape[1]
  h_local = h // len(devices)
  copies = {}
  outs = []
  for i, dev in enumerate(devices):
    if dev not in copies:
      copies[dev] = (packed.to(dev).contiguous(), params.to(dev))
    grid_d, params_d = copies[dev]
    # A band of a batch of frames is not contiguous: copied here.
    band = frame[:, i * h_local:(i + 1) * h_local].to(dev).contiguous()
    out = enhance_fused(grid_d, band, params_d, mode, y_offset=i * h_local,
                        h_total=h, **ends)
    outs.append(out.to(frame.device))
  return torch.cat(outs, dim=1)


def _finish(out, done):
  with span('hdrnet.stream.wait'):
    if done is not None:
      done.synchronize()
    return out.numpy()
