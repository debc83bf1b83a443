"""Plain PyTorch reference ops of the benchmarked HDRNet models.

Written from the HDRNet paper (Gharbi et al., SIGGRAPH 2017) and the
semantics of google/hdrnet's ops (``ops/bilateral_slice_apply.cc``), with
no kernel, no cache and no batching of its own. It imports nothing of the
program under test: it reads the weights by their state-dict names and
works out again everything the program derives from them (packed guide
vectors, the batch norm folded into the NN guide, preview tables, pyramid
taps).

  * coefficient backbone: splat convs, global path (2 convs, 3 FCs), local
    path, fusion, 1x1 prediction; SAME padding as XLA computes it;
  * guides: the curves guide (colour matrix, 16 shifted ReLUs a channel,
    channel mix, clip whose gradient is 0.5 at exactly 0 or 1, as JAX's
    ``jnp.clip``); the pointwise NN guide with its centre-only batch norm
    (batch statistics in training, running ones in serving);
  * trilinear slice + affine apply, with the reference C++ op's gradient
    (a splat over the mirror-padded image, the extreme depth weights
    forced to 1), which is not the derivative of the forward;
  * the legacy nearest preview table ``floor(dst * in / out)``, the
    bilinear pyramid (align_corners) and its upsample-add, u8
    requantization ``trunc(v * 255 + 0.5)``, the l2 loss and Adam.

Each model family composes these into its training forward and its
serving in ``portbench/models/<model_name>.py``.

Everything is float32. ``precision('tf32')`` rounds the operands of every
convolution and matrix product to TF32 (10 mantissa bits) and allows
TF32 on the card: the benchmark's control, the nearest precision below
the configurations' float32 with TF32 off.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

EPS = 1e-8          # the depth tent's smoothing (ops/numerics.h)
BN_EPS = 1e-3       # tf.contrib.layers.batch_norm
ADAM = (0.9, 0.999, 1e-8)

_MODE = {'tf32': False}


@contextlib.contextmanager
def precision(mode):
  """'f32': full float32 (TF32 off); 'tf32': the control."""
  if mode not in ('f32', 'tf32'):
    raise ValueError(f'precision must be f32 or tf32, got {mode!r}')
  saved = (_MODE['tf32'], torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
  tf32 = mode == 'tf32'
  _MODE['tf32'] = tf32
  torch.backends.cudnn.allow_tf32 = tf32
  torch.backends.cuda.matmul.allow_tf32 = tf32
  try:
    yield
  finally:
    (_MODE['tf32'], torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved


class _RoundTF32(torch.autograd.Function):
  """Round to nearest (ties away) on 10 mantissa bits; identity gradient
  rounded likewise, as TF32 products of the backward would see it."""

  @staticmethod
  def forward(ctx, x):
    return _tf32(x)

  @staticmethod
  def backward(ctx, g):
    return _tf32(g)


def _tf32(x):
  bits = x.contiguous().view(torch.int32)
  bits = (bits + 0x1000) & ~0x1FFF
  return bits.view(torch.float32)


def _op(x):
  return _RoundTF32.apply(x) if _MODE['tf32'] else x


# --- backbone -------------------------------------------------------------


def same_padding(size, k, stride):
  """(lo, hi) of XLA's SAME padding along one axis."""
  out = -(-size // stride)
  total = max((out - 1) * stride + k - size, 0)
  return total // 2, total - total // 2


def conv(x, weight, bias, stride):
  k = weight.shape[-1]
  top, bottom = same_padding(x.shape[-2], k, stride)
  left, right = same_padding(x.shape[-1], k, stride)
  x = F.pad(x, (left, right, top, bottom))
  return F.conv2d(_op(x), _op(weight), bias, stride=stride)


def linear(x, weight, bias):
  return _op(x) @ _op(weight).t() + bias


def backbone(sd, lowres, luma_bins):
  """NCHW preview (b, 3, s, s) -> grid (b, gh, gw, gd, n_out, 4)."""
  p = 'coefficients.'

  def w(name):
    return sd[p + name]

  def b(name):
    return sd.get(p + name)

  x = lowres
  i = 1
  while f'{p}splat_conv{i}.conv.weight' in sd:
    x = F.relu(conv(x, w(f'splat_conv{i}.conv.weight'),
                    b(f'splat_conv{i}.conv.bias'), 2))
    i += 1
  splat = x
  g = F.relu(conv(splat, w('global_conv1.conv.weight'),
                  b('global_conv1.conv.bias'), 2))
  g = F.relu(conv(g, w('global_conv2.conv.weight'),
                  b('global_conv2.conv.bias'), 2))
  g = g.permute(0, 2, 3, 1).reshape(g.shape[0], -1)  # NHWC flatten
  g = F.relu(linear(g, w('global_fc1.fc.weight'), b('global_fc1.fc.bias')))
  g = F.relu(linear(g, w('global_fc2.fc.weight'), b('global_fc2.fc.bias')))
  g = linear(g, w('global_fc3.fc.weight'), b('global_fc3.fc.bias'))
  loc = F.relu(conv(splat, w('local_conv1.conv.weight'),
                    b('local_conv1.conv.bias'), 1))
  loc = conv(loc, w('local_conv2.conv.weight'), None, 1)
  fused = F.relu(loc + g[:, :, None, None])
  y = conv(fused, w('prediction_conv.conv.weight'),
           b('prediction_conv.conv.bias'), 1).permute(0, 2, 3, 1)
  bsz, gh, gw, c = y.shape
  n_out = c // (4 * luma_bins)
  # Conv channel (j * n_out + i) * gd + k holds grid entry [k, i, j].
  y = y.reshape(bsz, gh, gw, 4, n_out, luma_bins)
  return y.permute(0, 1, 2, 5, 4, 3)


# --- guides ---------------------------------------------------------------


class _ClipJax(torch.autograd.Function):
  """clip(x, 0, 1) whose gradient is 1 inside, 0.5 at exactly 0 or 1."""

  @staticmethod
  def forward(ctx, x):
    ctx.save_for_backward(x)
    return torch.clamp(x, 0.0, 1.0)

  @staticmethod
  def backward(ctx, g):
    (x,) = ctx.saved_tensors
    inside = ((x > 0) & (x < 1)).to(g.dtype)
    tie = ((x == 0) | (x == 1)).to(g.dtype)
    return g * (inside + 0.5 * tie)


def curves_guide(sd, img, p='guide.'):
  """(..., 3) image -> (...) guide: per channel c, g_c = bias_c +
  sum_j img_j ccm[j, c], then sum_k slope[c, k] relu(g_c - shift[c, k]);
  the channels mixed with a bias; clipped to [0, 1]."""
  g = (img[..., :, None] * sd[p + 'ccm']).sum(-2) + sd[p + 'ccm_bias']
  curve = (sd[p + 'slopes'] * F.relu(g[..., None] - sd[p + 'shifts'])).sum(-1)
  mix = (curve * sd[p + 'channel_mixing_w'][:, 0]).sum(-1)
  return _ClipJax.apply(mix + sd[p + 'channel_mixing_b'][0])


def nn_guide(sd, img, p, training):
  """(..., 3) image -> (...) guide: 1x1 conv to gc features, centre-only
  batch norm (batch statistics over every pixel in training, the running
  ones in serving), ReLU, 1x1 conv with a bias, sigmoid."""
  n = img.shape[-1]
  w1 = sd[p + 'conv1.conv.weight'].reshape(-1, n)
  h = linear(img.reshape(-1, n), w1, 0.0)
  if training:
    mean = h.mean(0)
    var = torch.clamp((h * h).mean(0) - mean * mean, min=0.0)
  else:
    mean = sd[p + 'conv1.bn.running_mean']
    var = sd[p + 'conv1.bn.running_var']
  h = (h - mean) * torch.rsqrt(var + BN_EPS) + sd[p + 'conv1.bn.bias']
  w2 = sd[p + 'conv2.conv.weight'].reshape(1, -1)
  g = linear(F.relu(h), w2, sd[p + 'conv2.conv.bias'])
  return torch.sigmoid(g).reshape(img.shape[:-1])


# --- slice + apply --------------------------------------------------------


def _lerp_weight(x, xs):
  return torch.clamp(1.0 - torch.abs(x - xs), min=0.0)


def _smoothed_weight(x, xs):
  return torch.clamp(1.0 - torch.sqrt((x - xs) ** 2 + EPS), min=0.0)


def _smoothed_weight_grad(x, xs):
  d = x - xs
  a = torch.sqrt(d * d + EPS)
  return torch.where(a > 1.0, torch.zeros_like(d), d / a)


def _spatial_taps(n, grid_n, device, offset=0, total=None):
  """Taps at floor(gf - 0.5) and +1 of gf = (x + 0.5) grid_n / total for
  the pixels offset .. offset + n - 1 of an axis of `total` pixels;
  weights at the unclamped taps, indices clamped."""
  scale = grid_n / (n if total is None else total)
  gf = (torch.arange(offset, offset + n, dtype=torch.float32, device=device)
        + 0.5) * scale
  i0 = torch.floor(gf - 0.5).long()
  w0 = _lerp_weight(i0.float() + 0.5, gf)
  w1 = _lerp_weight(i0.float() + 1.5, gf)
  return (w0, w1, i0.clamp(0, grid_n - 1), (i0 + 1).clamp(0, grid_n - 1))


def _depth_taps(guide, gd, weight=_smoothed_weight):
  gzf = guide * gd
  z0 = torch.floor(gzf - 0.5).long()
  return (weight(z0.float() + 0.5, gzf), weight(z0.float() + 1.5, gzf),
          z0.clamp(0, gd - 1), (z0 + 1).clamp(0, gd - 1))


def _slice(grid5, guide, zw, y_offset=0, h_total=None):
  """Trilinear slice of (b, gh, gw, gd, C) at the guide-driven depth taps
  zw = (w0, w1, c0, c1); the guide's rows are rows y_offset .. of a frame
  of h_total rows. -> (b, h, w, C)."""
  b, gh, gw, _, _ = grid5.shape
  _, h, w = guide.shape
  dev = guide.device
  wy0, wy1, y0, y1 = _spatial_taps(h, gh, dev, y_offset, h_total)
  wx0, wx1, x0, x1 = _spatial_taps(w, gw, dev)
  zw0, zw1, z0, z1 = zw
  bi = torch.arange(b, device=dev)[:, None, None]
  out = 0.0
  for wy, yy in ((wy0, y0), (wy1, y1)):
    for wx, xx in ((wx0, x0), (wx1, x1)):
      for wz, zz in ((zw0, z0), (zw1, z1)):
        corner = grid5[bi, yy[None, :, None], xx[None, None, :], zz]
        wgt = wy[None, :, None] * wx[None, None, :] * wz
        out = out + wgt[..., None] * corner
  return out


def _with_ones(image):
  return torch.cat([image, torch.ones_like(image[..., :1])], -1)


def slice_apply_plain(grid6, guide, image, y_offset=0, h_total=None):
  """grid (b, gh, gw, gd, no, 4), guide (b, h, w), image (b, h, w, 3)
  -> (b, h, w, no): the sliced affine applied to [image, 1]."""
  b, gh, gw, gd, no, ni = grid6.shape
  sliced = _slice(grid6.reshape(b, gh, gw, gd, no * ni), guide,
                  _depth_taps(guide, gd), y_offset, h_total)
  sliced = sliced.reshape(guide.shape + (no, ni))
  return (sliced * _with_ones(image)[..., None, :]).sum(-1)


def _mirror(x, n):
  x = torch.where(x < 0, -x - 1, x)
  return torch.where(x >= n, 2 * n - 1 - x, x)


def grid_vjp(guide, image, ct, grid_shape):
  """The reference op's grid cotangent: over the image mirror-padded by
  half a cell, sum of wy wx wz[k] ct_i [image, 1]_j, the depth weight
  forced to 1 for cell 0 below bin 0 and cell gd - 1 above bin gd - 1."""
  gh, gw, gd, no, ni = grid_shape
  b, h, w = guide.shape
  dev = guide.device
  py, px = math.ceil(0.5 * h / gh), math.ceil(0.5 * w / gw)
  ys = torch.arange(-py, h + py, device=dev)
  xs = torch.arange(-px, w + px, device=dev)
  iy, ix = _mirror(ys, h), _mirror(xs, w)

  def weights(coords, n, grid_n):
    gf = (coords.float() + 0.5) * (grid_n / n)
    cells = torch.arange(grid_n, dtype=torch.float32, device=dev) + 0.5
    return _lerp_weight(cells[None, :], gf[:, None])

  wy, wx = weights(ys, h, gh), weights(xs, w, gw)
  gpad = guide.index_select(1, iy).index_select(2, ix)
  gzf = gpad * gd
  cells = torch.arange(gd, dtype=torch.float32, device=dev) + 0.5
  wz = _smoothed_weight(cells, gzf[..., None])
  k = torch.arange(gd, device=dev)
  force = (((gzf < 0.5)[..., None] & (k == 0))
           | ((gzf > gd - 0.5)[..., None] & (k == gd - 1)))
  wz = torch.where(force, torch.ones_like(wz), wz)
  f = ct[..., :, None] * _with_ones(image)[..., None, :]
  f = f.index_select(1, iy).index_select(2, ix).reshape(
      b, len(ys), len(xs), no * ni)
  out = []
  for kk in range(gd):
    t = torch.einsum('xb,nyxc->nybc', _op(wx), _op(wz[..., kk, None] * f))
    out.append(torch.einsum('ya,nybc->nabc', _op(wy), _op(t)))
  return torch.stack(out, 3).reshape(b, gh, gw, gd, no, ni)


def guide_vjp(grid6, guide, image, ct):
  """The reference op's guide cotangent: the slice re-interpolated with
  the depth weights' derivative gd * d(weight)/d(guide position)."""
  b, gh, gw, gd, no, ni = grid6.shape
  w0, w1, c0, c1 = _depth_taps(guide, gd, _smoothed_weight_grad)
  sliced = _slice(grid6.reshape(b, gh, gw, gd, no * ni), guide,
                  (gd * w0, gd * w1, c0, c1)).reshape(guide.shape + (no, ni))
  return ((sliced * _with_ones(image)[..., None, :]).sum(-1) * ct).sum(-1)


class _SliceApply(torch.autograd.Function):
  """slice_apply_plain whose gradient is the reference op's (grid and
  guide; the image is data)."""

  @staticmethod
  def forward(ctx, grid6, guide, image):
    ctx.save_for_backward(grid6, guide, image)
    return slice_apply_plain(grid6, guide, image)

  @staticmethod
  def backward(ctx, ct):
    grid6, guide, image = ctx.saved_tensors
    return (grid_vjp(guide, image, ct, grid6.shape[1:]),
            guide_vjp(grid6, guide, image, ct), None)


def slice_apply(grid6, guide, image):
  """slice_apply_plain, differentiable by the reference op's gradient."""
  return _SliceApply.apply(grid6, guide, image)


# --- resizes --------------------------------------------------------------


def nearest_indices(n_in, n_out):
  """The legacy TF1 nearest table floor(dst * in / out), clipped."""
  idx = np.floor(np.arange(n_out) * (n_in / n_out)).astype(np.int64)
  return np.clip(idx, 0, n_in - 1)


def preview(x, s):
  """(b, H, W, C) -> (b, s, s, C) by the nearest table."""
  dev = x.device
  iy = torch.as_tensor(nearest_indices(x.shape[1], s), device=dev)
  ix = torch.as_tensor(nearest_indices(x.shape[2], s), device=dev)
  return x.index_select(1, iy).index_select(2, ix)


def _linear_taps(n_in, n_out):
  """align_corners taps in float64: i0, i1 and the float32 fraction."""
  src = np.arange(n_out) * ((n_in - 1) / max(n_out - 1, 1))
  i0 = np.floor(src).astype(np.int64)
  frac = (src - i0).astype(np.float32)
  return np.clip(i0, 0, n_in - 1), np.clip(i0 + 1, 0, n_in - 1), frac


def resize_bilinear(x, size):
  """(b, H, W, C) -> (b, h, w, C), align_corners, a + (b - a) frac, rows
  then columns."""
  for dim, n_out in ((1, size[0]), (2, size[1])):
    i0, i1, frac = _linear_taps(x.shape[dim], n_out)
    dev = x.device
    a = x.index_select(dim, torch.as_tensor(i0, device=dev))
    c = x.index_select(dim, torch.as_tensor(i1, device=dev))
    shape = [1, 1, 1, 1]
    shape[dim] = n_out
    x = a + (c - a) * torch.as_tensor(frac, device=dev).reshape(shape)
  return x


def pyramid(x, n):
  levels = [x]
  for _ in range(n - 1):
    h, w = levels[-1].shape[1:3]
    levels.append(resize_bilinear(levels[-1], (h // 2, w // 2)))
  return levels


def level_guide_names(sd):
  n = 0
  while f'guide_level_{n}.conv1.conv.weight' in sd:
    n += 1
  return [f'guide_level_{i}.' for i in range(n)]


# --- serving ---------------------------------------------------------------


def to_unit(frame_u8):
  return frame_u8.to(torch.float32) / 255.0


def quantize(v):
  """[0, 1] -> uint8 codes trunc(v * 255 + 0.5)."""
  return (v * 255.0 + 0.5).to(torch.int32).to(torch.uint8)


def preview_grid(sd, img, model):
  """The grid of a (1, H, W, 3) frame in [0, 1]: its nearest preview at
  the configuration's ``net_input_size`` through the backbone."""
  low = preview(img, model['net_input_size']).permute(0, 3, 1, 2)
  return backbone(sd, low, model['luma_bins'])


def blocks(grid6, img, guide_fn, sd, block_rows):
  """Slice + apply of `img` in blocks of rows, each block's guide from
  guide_fn(sd, rows)."""
  h = img.shape[1]
  out = []
  for lo in range(0, h, block_rows):
    rows = img[:, lo:lo + block_rows]
    out.append(slice_apply_plain(grid6, guide_fn(sd, rows), rows, lo, h))
  return torch.cat(out, 1)


# --- training -------------------------------------------------------------


def is_buffer(name):
  return name.endswith(('running_mean', 'running_var'))


def l2_loss(target, out):
  return torch.mean(torch.square(target - out))


def adam_update(p, g, m, v, t, lr):
  """One Adam update (b1 0.9, b2 0.999, eps 1e-8) of p in place; m and
  v are the moments, t the update's count from 1."""
  b1, b2, eps = ADAM
  m.mul_(b1).add_(g, alpha=1 - b1)
  v.mul_(b2).addcmul_(g, g, value=1 - b2)
  step = lr / (1 - b1 ** t)
  denom = v.sqrt() / math.sqrt(1 - b2 ** t) + eps
  p.addcdiv_(m, denom, value=-step)


def train_steps(sd, forward, batches, lr, loss_fn=l2_loss):
  """Adam steps from `sd`, one a batch ({lowres_input, image_input,
  image_output} in [0, 1]), through forward(sd, lowres, fullres). Returns (losses, the first step's gradients,
  the parameters after the last step), the gradients and parameters as
  {name: tensor} over the trainable leaves."""
  params = {k: v.detach().clone() for k, v in sd.items() if not is_buffer(k)}
  buffers = {k: v for k, v in sd.items() if is_buffer(k)}
  moments = {k: (torch.zeros_like(v), torch.zeros_like(v))
             for k, v in params.items()}
  losses, grads1 = [], None
  for t, batch in enumerate(batches, 1):
    leaves = {k: v.requires_grad_(True) for k, v in params.items()}
    out = forward({**leaves, **buffers}, batch['lowres_input'],
                  batch['image_input'])
    loss = loss_fn(batch['image_output'], out)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    losses.append(loss.item())
    if grads1 is None:
      grads1 = {k: g.detach() for k, g in zip(leaves, grads)}
    with torch.no_grad():
      for (k, p), g in zip(leaves.items(), grads):
        adam_update(p, g, *moments[k], t, lr)
    params = {k: p.detach() for k, p in leaves.items()}
    del out, loss, grads
  return losses, grads1, params
