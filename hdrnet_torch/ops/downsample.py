"""Nearest-neighbour preview downsample (serving hot path), kernel K2.

``nearest_lowres(frame, s)`` cuts the (B, C, s, s) float32 preview that
the coefficient CNN consumes from an NHWC frame (float32, or uint8
normalized by /255), with the legacy TF1 table ``src = floor(dst*in/out)``
of :mod:`hdrnet_torch.ops.resize`. It matches
``hdrnet_tpu.ops.downsample.nearest_lowres_cf`` on the channel-first frame
bit for bit at float32.

On a CUDA tensor it launches the hand-written kernel in
``csrc/downsample.cu``; on a CPU tensor it runs ``nearest_lowres_plain``,
the same function in plain PyTorch. The op is also registered as
``hdrnet::nearest_lowres``, which ``torch.export`` records in a graph:
its implementation is the same device-picked route.

``nearest_lowres_onehot(frame_cf, s, rows)`` is kernel K2x
(``csrc/downsample_onehot.cu``), the port of the round-4 experiment
``scripts/exp_downsample_v2.py:57,67,102`` (``make_v1``, ``make_v2``, its
``pallas_call``): the same function on a channel-first float32 frame,
computed by one-hot bf16 products on the tensor cores, the rows gathered
(``rows='gather'``, v1) or selected by a second one-hot product over each
slab (``rows='mma'``, v2). Its plain version is
``nearest_lowres_onehot_plain``. Only ``hdrnet_torch.scripts.
exp_downsample_v2`` runs it; serving runs K2.
"""

from __future__ import annotations

import math

import torch

from hdrnet_torch.ops import _build
from hdrnet_torch.ops.resize import (_nearest_indices, device_table_cache,
                                     nearest_index_tensor)
from hdrnet_torch.utils.timing import span

ONEHOT_ROWS = {'gather': 0, 'mma': 1}


def to_unit(x):
  """float32 frame as is; uint8 divided by 255 with IEEE division (a
  device tensor divisor: a Python scalar divisor may become a multiply by
  the reciprocal)."""
  if x.dtype == torch.uint8:
    return x.to(torch.float32) / _unit_divisor(x.device)
  return x


def _unit_divisor(device):
  """255 as a float32 tensor on `device`, made once a device: making one
  copies it from the host and waits, which a CUDA graph's capture
  refuses. While ``torch.export`` traces, a new tensor (the graph's own
  constant)."""
  if torch.compiler.is_compiling():
    return torch.tensor(255.0, device=device)
  return _cached_unit_divisor(device)


@device_table_cache(maxsize=8)
def _cached_unit_divisor(device):
  return torch.tensor(255.0, device=device)


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

  CUDA tensor: kernel K2. CPU tensor: the plain version. Under
  ``torch.export`` the call is recorded as ``hdrnet::nearest_lowres``.
  """
  if torch.compiler.is_compiling():
    return torch.ops.hdrnet.nearest_lowres(frame, s)
  with span('hdrnet.ops.preview'):
    return _nearest_lowres(frame, s)


@torch.library.custom_op('hdrnet::nearest_lowres', mutates_args=(),
                         device_types=('cpu', 'cuda'))
def _nearest_lowres_op(frame: torch.Tensor, s: int) -> torch.Tensor:
  return _nearest_lowres(frame, s)


@_nearest_lowres_op.register_fake
def _(frame, s):
  _check(frame, s)
  return frame.new_empty((frame.shape[0], frame.shape[3], s, s),
                         dtype=torch.float32)


@device_table_cache(maxsize=64)
def _k2_tables(h, w, s, device):
  """The row and column floor tables on `device` and their addresses, one
  cached lookup a call."""
  iy = nearest_index_tensor(h, s, device)
  ix = nearest_index_tensor(w, s, device)
  return iy, ix, iy.data_ptr(), ix.data_ptr()


def _nearest_lowres(frame, s):
  # The serving path calls this once a frame, and at 4K its kernel is
  # shorter than the call, so the host work is kept to the checks, one
  # table lookup, the output and the launch (scripts/time_kernels.py
  # reports the host microseconds a call).
  _check(frame, s)
  if not _build.on_card('nearest_lowres', frame):
    return nearest_lowres_plain(frame, s)
  dev = frame.device
  b, h, w, c = frame.shape
  _, _, iy, ix = _k2_tables(h, w, s, dev)
  out = torch.empty((b, c, s, s), dtype=torch.float32, device=dev)
  _build.launch('hdrnet_nearest_lowres', dev, frame.data_ptr(),
                int(frame.dtype == torch.uint8), iy, ix, out.data_ptr(), b,
                h, w, c, s)
  return out


# --- K2x: the one-hot downsample on the tensor cores ----------------------


def split3(x):
  """float32 x -> (hi, mid, lo) bf16 with hi + mid + lo == x exactly (the
  experiment's ``split3``: each part the round-to-nearest bf16 of what the
  parts before it leave)."""
  hi = x.to(torch.bfloat16)
  rem = x - hi.float()
  mid = rem.to(torch.bfloat16)
  lo = (rem - mid.float()).to(torch.bfloat16)
  return hi, mid, lo


def _onehot(src, n, device):
  """(n, len(src)) float32 with a 1 at [src[j], j]."""
  m = torch.zeros((n, len(src)), dtype=torch.float32, device=device)
  m[torch.as_tensor(src, device=device),
    torch.arange(len(src), device=device)] = 1.0
  return m


def _dot3(parts, px):
  """Sum over the parts of part @ px, float32, in the order (hi + mid) +
  lo (the experiment's ``dot3``)."""
  out = None
  for part in parts:
    d = part.float() @ px
    out = d if out is None else out + d
  return out


def _check_onehot(frame_cf, s, rows):
  if frame_cf.ndim != 4:
    raise ValueError(f'frame must be (B, C, H, W), got '
                     f'{tuple(frame_cf.shape)}')
  if frame_cf.dtype != torch.float32:
    raise TypeError(f'K2x takes float32 frames, got {frame_cf.dtype}')
  if rows not in ONEHOT_ROWS:
    raise ValueError(f'rows must be one of {tuple(ONEHOT_ROWS)}, got '
                     f'{rows!r}')
  if s <= 0:
    raise ValueError(f'preview size must be positive, got {s}')


def nearest_lowres_onehot_plain(frame_cf, s, rows='gather'):
  """Plain K2x: (B, C, H, W) float32 -> (B, C, s, s) float32, the bf16
  split and float32 one-hot products in plain torch, as the experiment's
  kernels compute them: v1 (``'gather'``) takes the sampled rows and
  selects columns by Px (W, s); v2 (``'mma'``) cuts the frame into its
  g = gcd(H, s) slabs of H / g rows, selects each slab's s / g rows by
  the one-hot Py, rounds the (exact) rows to bf16, then applies Px."""
  _check_onehot(frame_cf, s, rows)
  b, c, h, w = frame_cf.shape
  dev = frame_cf.device
  iy = _nearest_indices(h, s)
  px = _onehot(_nearest_indices(w, s), w, dev)
  if rows == 'gather':
    sel = torch.index_select(frame_cf, 2, torch.as_tensor(iy, device=dev))
    return _dot3(split3(sel), px)
  g = math.gcd(h, s)
  span, per = h // g, s // g
  py = _onehot(iy[:per], span, dev).t()  # (per, span)
  slabs = frame_cf.reshape(b, c * g, span, w)
  # Each part's selected rows are exact in float32, so exact in bf16.
  selected = [(py @ part.float()).to(torch.bfloat16)
              for part in split3(slabs)]
  return _dot3(selected, px).reshape(b, c, s, s)


def nearest_lowres_onehot(frame_cf, s, rows='gather'):
  """K2x: (B, C, H, W) float32 -> (B, C, s, s) float32 preview, bit for
  bit K2's, by one-hot bf16 products on the tensor cores.

  rows: ``'gather'`` reads the sampled rows (the experiment's v1);
  ``'mma'`` selects them by a one-hot product over the slab of source
  rows that holds each 16-row tile (v2). CUDA tensor: kernel K2x. CPU
  tensor: ``nearest_lowres_onehot_plain``. Float32 only, as the TPU
  kernel; raises on another dtype.
  """
  _check_onehot(frame_cf, s, rows)
  if not _build.on_card('nearest_lowres_onehot', frame_cf):
    return nearest_lowres_onehot_plain(frame_cf, s, rows)
  b, c, h, w = frame_cf.shape
  iy = nearest_index_tensor(h, s, frame_cf.device)
  ix = nearest_index_tensor(w, s, frame_cf.device)
  out = torch.empty((b, c, s, s), dtype=torch.float32, device=frame_cf.device)
  _build.launch('hdrnet_downsample_onehot', frame_cf.device,
                frame_cf.data_ptr(), iy.data_ptr(), ix.data_ptr(),
                out.data_ptr(), b * c, h, w, s, ONEHOT_ROWS[rows])
  return out
