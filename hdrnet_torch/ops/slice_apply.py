"""Slice-apply with an external guide and its backward passes: kernels
K3, K4 and K5, the training path of ``HDRNetCurves``.

  slice_apply_fwd(grid5, guide, image, has_offset)            K3
  slice_apply_pix_bwd(grid5, guide, image, ct, has_offset)    K4
  slice_apply_grid_bwd(grid_shape, guide, image, ct, ...)     K5

They have the semantics of ``hdrnet_tpu.ops.pallas.slice_apply_fwd``,
``slice_apply_pix_bwd`` and ``slice_apply_grid_bwd`` (the reference C++
op's forward and VJPs, ops/bilateral_slice_apply.cc), on the port's
channels-last layouts: packed grid (B, gh, gw, gd, C) with
C = n_out * ni_tot, guide (B, H, W), image (B, H, W, n_in), output and
cotangent (B, H, W, n_out). n_in = 0 with an offset is the plain
bilateral slice.

Each takes ``band=(y_off, h_total)``: the H rows are rows y_off ..
y_off + H - 1 of a frame of h_total rows (a rank's share of a frame cut
along H over a ``spatial`` mesh axis), and every pixel takes the taps it
has in the whole frame. K3 and K4 give the band's rows of the whole
frame's outputs, bit for bit; K5 gives the band's share of the whole
frame's grid cotangent (its own rows of the mirror-padded frame, plus the
frame's top or bottom mirror rows when it starts or ends the frame), so
the shares of the bands of a frame sum to it. None is the whole frame,
``(0, H)``.

On CUDA tensors (float32, contiguous) each launches its hand-written
kernel in ``csrc/slice_apply.cu``; on CPU tensors it runs its plain
version below, built on :mod:`hdrnet_torch.ops.reference`, which also
takes float64 (the finite-difference tests use it). The forward is also
registered as ``hdrnet::slice_apply_fwd``, which ``torch.export`` records
in a graph (a model's forward, exported for inference): its
implementation is the same device-picked route.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from hdrnet_torch.ops import _build
from hdrnet_torch.ops import reference as ref

# Dynamic shared memory one block may use on Hopper (sm_90).
_MAX_SMEM = 227 * 1024


def _ni_tot(n_in, has_offset):
  return n_in + 1 if has_offset else n_in


def _grid6(grid5, n_in, has_offset):
  b, gh, gw, gd, c = grid5.shape
  ni_tot = _ni_tot(n_in, has_offset)
  return grid5.reshape(b, gh, gw, gd, c // ni_tot, ni_tot)


def _check(grid_shape, guide, image, ct, has_offset):
  """Shapes and types; returns (n_in, n_out)."""
  if len(grid_shape) != 5:
    raise ValueError(f'grid must be (B, gh, gw, gd, C), got {grid_shape}')
  if guide.ndim != 3 or image.ndim != 4:
    raise ValueError(f'guide must be (B, H, W) and image (B, H, W, n_in), '
                     f'got {tuple(guide.shape)}, {tuple(image.shape)}')
  b, h, w = guide.shape
  n_in = image.shape[-1]
  ni_tot = _ni_tot(n_in, has_offset)
  if ni_tot == 0 or grid_shape[-1] % ni_tot:
    raise ValueError(f'grid channels {grid_shape[-1]} do not split into '
                     f'n_in + offset = {ni_tot}')
  n_out = grid_shape[-1] // ni_tot
  if tuple(image.shape[:3]) != (b, h, w) or grid_shape[0] != b:
    raise ValueError(f'batch or size mismatch: grid {grid_shape}, guide '
                     f'{tuple(guide.shape)}, image {tuple(image.shape)}')
  if ct is not None and tuple(ct.shape) != (b, h, w, n_out):
    raise ValueError(f'ct must be {(b, h, w, n_out)}, got '
                     f'{tuple(ct.shape)}')
  tensors = [guide, image] + ([] if ct is None else [ct])
  dtypes = {t.dtype for t in tensors}
  if len(dtypes) != 1 or not dtypes.pop().is_floating_point:
    raise TypeError('slice-apply takes tensors of one floating dtype')
  return n_in, n_out


def _float32(name, *tensors):
  """Raises unless the tensors are float32, the kernels' only dtype (the
  plain versions take any floating one)."""
  if any(t.dtype != torch.float32 for t in tensors):
    raise TypeError(f'{name}: the kernel takes float32 tensors')


def _band(band, h):
  """(y_off, h_total) of a band of h rows; None is the whole frame."""
  y_off, h_total = (0, h) if band is None else (int(v) for v in band)
  if y_off < 0 or y_off + h > h_total:
    raise ValueError(f'band rows {y_off}..{y_off + h - 1} outside a frame '
                     f'of {h_total} rows')
  return y_off, h_total


def _ref_band(band, h, w):
  """The reference's (y_off, x_off, h_total, w_total), or None."""
  if band is None:
    return None
  y_off, h_total = _band(band, h)
  return y_off, 0, h_total, w


# --- plain versions ---------------------------------------------------------


def slice_apply_fwd_plain(grid5, guide, image, has_offset=True, band=None):
  """Plain K3: (B, gh, gw, gd, C), (B, H, W), (B, H, W, n_in) ->
  (B, H, W, n_out)."""
  _check(tuple(grid5.shape), guide, image, None, has_offset)
  return ref.bilateral_slice_apply(_grid6(grid5, image.shape[-1], has_offset),
                                   guide, image, has_offset,
                                   _ref_band(band, *guide.shape[1:]))


def slice_apply_pix_bwd_plain(grid5, guide, image, ct, has_offset=True,
                              need_input=True, band=None):
  """Plain K4: (d_guide (B, H, W), d_image (B, H, W, n_in) or None)."""
  _check(tuple(grid5.shape), guide, image, ct, has_offset)
  grid6 = _grid6(grid5, image.shape[-1], has_offset)
  rb = _ref_band(band, *guide.shape[1:])
  d_guide = ref.bilateral_slice_apply_guide_vjp(grid6, guide, image, ct,
                                                has_offset, rb)
  d_image = (ref.bilateral_slice_apply_input_vjp(grid6, guide, ct, has_offset,
                                                 rb)
             if need_input else None)
  return d_guide, d_image


def slice_apply_grid_bwd_plain(grid_shape, guide, image, ct, has_offset=True,
                               band=None):
  """Plain K5: grid_shape (B, gh, gw, gd, C) -> its cotangent (the band's
  share of the frame's)."""
  grid_shape = tuple(grid_shape)
  n_in, n_out = _check(grid_shape, guide, image, ct, has_offset)
  b, gh, gw, gd, c = grid_shape
  d = ref.bilateral_slice_apply_grid_vjp(
      guide, image, ct, (gh, gw, gd, n_out, _ni_tot(n_in, has_offset)),
      has_offset, _ref_band(band, *guide.shape[1:]))
  return d.reshape(grid_shape)


# --- wrappers ----------------------------------------------------------------


def _dims(grid_shape, guide, image):
  b, h, w = guide.shape
  _, gh, gw, gd, _ = grid_shape
  return (b, h, w, gh, gw, gd, image.shape[-1])


def slice_apply_fwd(grid5, guide, image, has_offset=True, band=None):
  """Slice + affine apply with an external guide (no clip).

  CUDA tensors: kernel K3. CPU tensors: ``slice_apply_fwd_plain``.
  Under ``torch.export`` a whole frame's call is recorded as
  ``hdrnet::slice_apply_fwd``.
  """
  if torch.compiler.is_compiling() and band is None:
    return torch.ops.hdrnet.slice_apply_fwd(grid5, guide, image, has_offset)
  return _slice_apply_fwd(grid5, guide, image, has_offset, band)


@torch.library.custom_op('hdrnet::slice_apply_fwd', mutates_args=(),
                         device_types=('cpu', 'cuda'))
def _slice_apply_fwd_op(grid5: torch.Tensor, guide: torch.Tensor,
                        image: torch.Tensor, has_offset: bool) -> torch.Tensor:
  return _slice_apply_fwd(grid5, guide, image, has_offset)


@_slice_apply_fwd_op.register_fake
def _(grid5, guide, image, has_offset):
  _, n_out = _check(tuple(grid5.shape), guide, image, None, has_offset)
  return guide.new_empty((*guide.shape, n_out), dtype=torch.float32)


def _slice_apply_fwd(grid5, guide, image, has_offset, band=None):
  n_in, n_out = _check(tuple(grid5.shape), guide, image, None, has_offset)
  y_off, h_total = _band(band, guide.shape[1])
  if not _build.on_card('slice_apply_fwd', grid5, guide, image):
    return slice_apply_fwd_plain(grid5, guide, image, has_offset, band)
  _float32('slice_apply_fwd', grid5, guide, image)
  b, h, w, gh, gw, gd, _ = _dims(grid5.shape, guide, image)
  out = torch.empty((b, h, w, n_out), dtype=torch.float32,
                    device=guide.device)
  _build.launch('hdrnet_slice_apply_fwd', guide.device, grid5.data_ptr(),
                guide.data_ptr(), image.data_ptr(), out.data_ptr(), b, h, w,
                gh, gw, gd, n_in, n_out, int(has_offset), y_off, h_total,
                gh / h_total, gw / w)
  return out


def slice_apply_pix_bwd(grid5, guide, image, ct, has_offset=True,
                        need_input=True, band=None):
  """Guide and input cotangents of the slice-apply, from one gather.

  Returns (d_guide (B, H, W), d_image (B, H, W, n_in) or None when not
  ``need_input``). CUDA tensors: kernel K4. CPU tensors: the plain
  version.
  """
  n_in, n_out = _check(tuple(grid5.shape), guide, image, ct, has_offset)
  y_off, h_total = _band(band, guide.shape[1])
  if not _build.on_card('slice_apply_pix_bwd', grid5, guide, image, ct):
    return slice_apply_pix_bwd_plain(grid5, guide, image, ct, has_offset,
                                     need_input, band)
  _float32('slice_apply_pix_bwd', grid5, guide, image, ct)
  b, h, w, gh, gw, gd, _ = _dims(grid5.shape, guide, image)
  dev = guide.device
  d_guide = torch.empty((b, h, w), dtype=torch.float32, device=dev)
  d_image = (torch.empty((b, h, w, n_in), dtype=torch.float32, device=dev)
             if need_input else None)
  _build.launch('hdrnet_slice_apply_pix_bwd', dev, grid5.data_ptr(),
                guide.data_ptr(), image.data_ptr(), ct.data_ptr(),
                d_guide.data_ptr(),
                None if d_image is None else d_image.data_ptr(), b, h, w, gh,
                gw, gd, n_in, n_out, int(has_offset), y_off, h_total,
                gh / h_total, gw / w)
  if need_input:
    _build.launches['slice_apply_pix_bwd_image'] += 1
  return d_guide, d_image


def _pad_y(h, w, h_total, gh, gw):
  """The frame's mirror padding (rows, cols); raises for a band shorter
  than the rows, whose mirror rows it would have to read."""
  pad_y, pad_x = ref.pad_amounts(h_total, w, gh, gw)
  if h < pad_y:
    raise ValueError(
        f'grid_bwd: a band of {h} rows is shorter than the grid VJP\'s '
        f'mirror padding of {pad_y} rows (half a cell of {h_total} / {gh}): '
        'cut the frame into fewer bands')
  return pad_y, pad_x


def grid_bwd_plan(grid_shape, guide, band=None):
  """(strips, scratch floats, shared bytes) of K5 for a grid cotangent of
  `grid_shape` over `guide`'s frames (a band of them) on the card; raises
  where the kernel cannot run (a C above the block's 256 threads, or
  records and slots beyond a block's shared memory)."""
  b, h, w = guide.shape
  _, gh, gw, gd, c = grid_shape
  y_off, h_total = _band(band, h)
  pad_y, _ = _pad_y(h, w, h_total, gh, gw)
  return _grid_bwd_plan(guide.device, b, h, gh, gw, gd, c, y_off, h_total,
                        pad_y)


# A plan queries the card (occupancy, SM count): asked once a shape and
# band, since a train step calls K5 with the same shapes every step. The
# band sets the region rows a launch covers, so a band's plan is not a
# whole frame's of the same height.
@functools.lru_cache(maxsize=256)
def _grid_bwd_plan(device, b, h, gh, gw, gd, c, y_off, h_total, pad_y):
  strips, floats = ctypes.c_int(), ctypes.c_longlong()
  with torch.cuda.device(device):
    smem = _build.library().lib.hdrnet_slice_apply_grid_bwd_plan(
        b, h, gh, gw, gd, c, y_off, h_total, pad_y, ctypes.byref(strips),
        ctypes.byref(floats))
  if strips.value < 1 or smem > _MAX_SMEM:
    raise ValueError(f'grid_bwd: {c} channels x {gd} bins exceed one block '
                     f'(256 threads, {smem} bytes of shared memory)')
  return strips.value, floats.value, smem


def slice_apply_grid_bwd(grid_shape, guide, image, ct, has_offset=True,
                         band=None):
  """Grid cotangent (B, gh, gw, gd, C) of the slice-apply: the splat over
  the mirror-padded image with z-extreme depth weights forced to 1; for a
  band, its share of the frame's (a band shorter than the padding
  raises).

  Deterministic on the card: kernel K5 sums in a fixed order, so two runs
  give the same bits. It writes one partial (4 cells x gd x C floats)
  per block into a scratch tensor allocated here (``grid_bwd_plan``
  sizes it), then sums them. CPU tensors: the plain version.
  """
  grid_shape = tuple(int(d) for d in grid_shape)
  n_in, n_out = _check(grid_shape, guide, image, ct, has_offset)
  y_off, h_total = _band(band, guide.shape[1])
  if not _build.on_card('slice_apply_grid_bwd', guide, image, ct):
    return slice_apply_grid_bwd_plain(grid_shape, guide, image, ct,
                                      has_offset, band)
  _float32('slice_apply_grid_bwd', guide, image, ct)
  b, h, w, gh, gw, gd, _ = _dims(grid_shape, guide, image)
  strips, floats, _ = grid_bwd_plan(grid_shape, guide, band)
  pad_y, pad_x = _pad_y(h, w, h_total, gh, gw)
  dev = guide.device
  scratch = torch.empty((floats,), dtype=torch.float32, device=dev)
  out = torch.empty(grid_shape, dtype=torch.float32, device=dev)
  _build.launch('hdrnet_slice_apply_grid_bwd', dev, guide.data_ptr(),
                image.data_ptr(), ct.data_ptr(), scratch.data_ptr(),
                out.data_ptr(), b, h, w, gh, gw, gd, n_in, n_out,
                int(has_offset), y_off, h_total, gh / h_total, gw / w, pad_y,
                pad_x, strips)
  return out
