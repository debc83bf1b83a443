"""HDRNetFeaturesPyrNN3 (google/hdrnet ``scripts/ll_strong/
train_fpyrnn3_cm2.sh``): a bilinear pyramid of three levels; on each a
full-resolution feature tower (``features_{l}``: 3x3 convs 3 -> 16 -> 16
with ReLU, then a linear 3x3 conv to 4 x channel_multiplier features) and
a pointwise NN guide on the level's image (``guide_level_{l}``); one
block of the grid a level, 3 outputs x (features + offset) inputs, sliced
by the level's guide and applied to its features; the levels summed
coarse to fine by upsample-adds. Served by the composite route: the
model's forward in float32 (no fused kernel takes features), then the
clip.

The layer equations are those of the repo's JAX package
(``hdrnet_tpu/models/extended.py``), which google/hdrnet's current
``hdrnet/models.py`` no longer holds. This file follows them with no
departure. What ``portbench.reference.plain`` lacks for this family is
here: the backbone's grid read as 4 x channel_multiplier + 1 inputs a
level (``plain.backbone`` reads 4), the tower, and the slice-apply's
gradient with respect to the image it is applied to (here the learned
features), d_image[j] = sum_i ct[i] A[i, j] over the sliced affine A, as
the reference op (``ops/bilateral_slice_apply.cc``) defines it.

The ``train`` driver counts one image (it passes no batch size), so the
counts below count a step of the published batch, ``BATCH``.
"""

import torch
import torch.nn.functional as F

from portbench import counts
from portbench.reference import plain

LEVELS = 3
FUSED_U8 = False
BATCH = 4  # train_fpyrnn3_cm2.sh's --batch_size
TOWER_WIDTH = 16


def n_features(model):
  return 4 * model['channel_multiplier']


def kernel_ops(model):
  """float32 operations a pixel of K3, K4 (both cotangents) and K5 at
  C = 3 (n_features + 1) grid channels (27 at cm 2), counted as
  ``counts`` counts them at C = 12: K3 the taps and weights (55), 8
  corners x C FMA, the 3 x n_features affine; K4 the taps and weights
  with their derivatives (68), 8 corners x C FMA, the (C + 3)-FMA
  contraction into d_guide and the 3 x n_features FMA of d_image; K5 a
  mirror-padded pixel: the C products, the weights (30) and 4 cells x 2
  bins x C FMA."""
  nf = n_features(model)
  c = 3 * (nf + 1)
  return {'K3': 55 + 16 * c + 2 * 3 * nf,
          'K4': 68 + 16 * c + 2 * (c + 3) + 2 * 3 * nf,
          'K5': 30 + 17 * c}


def guide_ops(model):
  return counts.nn_guide_ops(model['guide_complexity'])


def guide_params(model):
  """The first 1x1 conv, the folded batch norm's scale and shift, the
  second conv and its bias (the guide reads the level's 3 channels)."""
  return (counts.N_IN + 2) * model['guide_complexity'] + 1


# --- the plain reference --------------------------------------------------


def backbone(sd, lowres, model):
  """NCHW preview (b, 3, s, s) -> grid (b, gh, gw, gd, 3 LEVELS,
  n_features + 1): ``plain.backbone`` with the prediction read as
  n_features + 1 inputs a level."""
  p = 'coefficients.'

  def w(name):
    return sd[p + name]

  def b(name):
    return sd.get(p + name)

  x = lowres
  i = 1
  while f'{p}splat_conv{i}.conv.weight' in sd:
    x = F.relu(plain.conv(x, w(f'splat_conv{i}.conv.weight'),
                          b(f'splat_conv{i}.conv.bias'), 2))
    i += 1
  splat = x
  g = F.relu(plain.conv(splat, w('global_conv1.conv.weight'),
                        b('global_conv1.conv.bias'), 2))
  g = F.relu(plain.conv(g, w('global_conv2.conv.weight'),
                        b('global_conv2.conv.bias'), 2))
  g = g.permute(0, 2, 3, 1).reshape(g.shape[0], -1)  # NHWC flatten
  g = F.relu(plain.linear(g, w('global_fc1.fc.weight'),
                          b('global_fc1.fc.bias')))
  g = F.relu(plain.linear(g, w('global_fc2.fc.weight'),
                          b('global_fc2.fc.bias')))
  g = plain.linear(g, w('global_fc3.fc.weight'), b('global_fc3.fc.bias'))
  loc = F.relu(plain.conv(splat, w('local_conv1.conv.weight'),
                          b('local_conv1.conv.bias'), 1))
  loc = plain.conv(loc, w('local_conv2.conv.weight'), None, 1)
  fused = F.relu(loc + g[:, :, None, None])
  y = plain.conv(fused, w('prediction_conv.conv.weight'),
                 b('prediction_conv.conv.bias'), 1).permute(0, 2, 3, 1)
  bsz, gh, gw, _ = y.shape
  gd, ni = model['luma_bins'], n_features(model) + 1
  # Conv channel (j * n_out + i) * gd + k holds grid entry [k, i, j].
  y = y.reshape(bsz, gh, gw, ni, 3 * LEVELS, gd)
  return y.permute(0, 1, 2, 5, 4, 3)


def tower(sd, img, p):
  """(b, h, w, 3) level -> (b, h, w, n_features): SAME 3x3 convs with a
  bias, ReLU after each but the last."""
  x = img.permute(0, 3, 1, 2)
  i = 1
  while f'{p}conv{i + 1}.conv.weight' in sd:
    x = F.relu(plain.conv(x, sd[f'{p}conv{i}.conv.weight'],
                          sd[f'{p}conv{i}.conv.bias'], 1))
    i += 1
  x = plain.conv(x, sd[f'{p}conv{i}.conv.weight'],
                 sd[f'{p}conv{i}.conv.bias'], 1)
  return x.permute(0, 2, 3, 1)


def image_vjp(grid6, guide, ct):
  """The reference op's image cotangent: the sliced affine A (b, h, w,
  no, ni) transposed onto ct, d_image[j] = sum_i ct[i] A[i, j], over the
  inputs (the offset column left out)."""
  b, gh, gw, gd, no, ni = grid6.shape
  sliced = plain._slice(grid6.reshape(b, gh, gw, gd, no * ni), guide,
                        plain._depth_taps(guide, gd))
  sliced = sliced.reshape(guide.shape + (no, ni))
  return (sliced[..., :ni - 1] * ct[..., :, None]).sum(-2)


class _SliceApplyFeatures(torch.autograd.Function):
  """``plain.slice_apply_plain`` whose gradient is the reference op's with
  respect to the grid, the guide and the image (the features)."""

  @staticmethod
  def forward(ctx, grid6, guide, image):
    ctx.save_for_backward(grid6, guide, image)
    return plain.slice_apply_plain(grid6, guide, image)

  @staticmethod
  def backward(ctx, ct):
    grid6, guide, image = ctx.saved_tensors
    return (plain.grid_vjp(guide, image, ct, grid6.shape[1:]),
            plain.guide_vjp(grid6, guide, image, ct),
            image_vjp(grid6, guide, ct))


def slice_apply(grid6, guide, image):
  return _SliceApplyFeatures.apply(grid6, guide, image)


def _levels(sd, grid, img, slice_level):
  """Each level's features and guide, sliced by slice_level(grid block,
  guide name, level, features), coarsest first, each upsampled onto the
  next and added."""
  names = plain.level_guide_names(sd)
  out = None
  levels = plain.pyramid(img, len(names))
  for il in range(len(names)):
    l = len(names) - 1 - il  # finest first in the names and levels
    feats = tower(sd, levels[l], f'features_{l}.')
    lvl = slice_level(grid[..., 3 * il:3 * il + 3, :], names[l], levels[l],
                      feats)
    out = lvl if out is None else (
        plain.resize_bilinear(out, lvl.shape[1:3]) + lvl)
  return out


def forward_train(sd, model, lowres, fullres):
  """Training forward (no clip), differentiable through the weights; the
  guides' batch norm on batch statistics."""
  grid = backbone(sd, lowres.permute(0, 3, 1, 2), model)
  return _levels(sd, grid, fullres, lambda g, name, level, feats:
                 slice_apply(g, plain.nn_guide(sd, level, name, True), feats))


@torch.no_grad()
def serve(sd, model, frame_u8, block_rows=540):
  """(1, H, W, 3) uint8 frame -> (1, H, W, 3) float32 result in [0, 1],
  the composite route: the nearest preview, the backbone, then on each
  level its tower (whole), its guide on running statistics and the slice
  + apply in blocks of rows, summed coarse to fine; clip. (The stream
  requantizes it as trunc(v * 255 + 0.5).)"""
  img = plain.to_unit(frame_u8)
  low = plain.preview(img, model['net_input_size']).permute(0, 3, 1, 2)
  grid = backbone(sd, low, model)

  def slice_level(g, name, level, feats):
    h = level.shape[1]
    out = []
    for lo in range(0, h, block_rows):
      rows = level[:, lo:lo + block_rows]
      guide = plain.nn_guide(sd, rows, name, False)
      out.append(plain.slice_apply_plain(
          g, guide, feats[:, lo:lo + block_rows], lo, h))
    return torch.cat(out, 1)
  return torch.clamp(_levels(sd, grid, img, slice_level), 0.0, 1.0)


# --- counts of a step of BATCH images -------------------------------------


def tower_ops(model):
  """Forward operations of one tower an output pixel: 2 x 9 x Cin x Cout
  a conv."""
  widths = [counts.N_IN, TOWER_WIDTH, TOWER_WIDTH, n_features(model)]
  return sum(2 * 9 * a * b for a, b in zip(widths, widths[1:]))


def backbone_ops(model):
  """``counts.backbone_ops`` of one preview, its 1x1 prediction widened
  from 4 to n_features + 1 inputs a level."""
  sb, gd = model['spatial_bin'], model['luma_bins']
  cm = model['channel_multiplier']
  extra = gd * 3 * LEVELS * (n_features(model) + 1 - (counts.N_IN + 1))
  return (counts.backbone_ops.__wrapped__(model)
          + 2 * sb * sb * 8 * cm * gd * extra)


def train_step_ops(model, size):
  """Forward and backward (twice the forward) of a step of BATCH images:
  ``counts.forward_ops`` with this family's slice-apply (K3 at C = 27 in
  place of 3 -> 3) and each level's tower."""
  px = sum(a * b for a, b in counts.levels(model, size, size))
  forward = (counts.forward_ops(model, size, size, serving=False)
             + px * (tower_ops(model) + kernel_ops(model)['K3']
                     - counts.SLICE_APPLY_OPS))
  return 3 * BATCH * forward


def slice_apply_bound_s(model, size):
  """Summed bounds of a step's slice-apply kernels at each level, BATCH
  images: K3 (grid, guide, features in; output out), K4 with both
  cotangents (grid, guide, features, cotangent in; d_guide, d_features
  out) and K5 (guide, features, cotangent in; the grid cotangent out,
  every mirror-padded pixel splatted)."""
  sb, gd = model['spatial_bin'], model['luma_bins']
  nf = n_features(model)
  c = 3 * (nf + 1)
  ops = kernel_ops(model)
  gb = BATCH * sb * sb * gd * c * 4
  total = 0.0
  for n, _ in counts.levels(model, size, size):
    px = BATCH * n * n
    pad = -(-n // (2 * sb))
    padded = BATCH * (n + 2 * pad) ** 2
    total += counts.bound_s(gb + px * (1 + nf + 3) * 4, px * ops['K3'])
    total += counts.bound_s(gb + px * (1 + nf + 3 + 1 + nf) * 4, px * ops['K4'])
    total += counts.bound_s(gb + px * (1 + nf + 3) * 4, padded * ops['K5'])
  return total
