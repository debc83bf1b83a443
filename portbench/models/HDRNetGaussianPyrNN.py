"""HDRNetGaussianPyrNN (google/hdrnet ``hdrnet/models.py``): a bilinear
pyramid of three levels, each sliced by its own pointwise NN guide and
grid block, summed coarse to fine by upsample-adds; served in float32
levels (the fused kernel, K6, a level)."""

import functools

import torch

from portbench import counts
from portbench.reference import plain

LEVELS = 3
FUSED_U8 = False


def guide_ops(model):
  return counts.nn_guide_ops(model['guide_complexity'])


def guide_params(model):
  """The first 1x1 conv, the folded batch norm's scale and shift, the
  second conv and its bias."""
  return (counts.N_IN + 2) * model['guide_complexity'] + 1


def _levels(sd, model, grid, img, slice_level):
  """Slices each level with its guide and grid block, coarsest first,
  each upsampled onto the next and added."""
  names = plain.level_guide_names(sd)
  out = None
  for il, (name, level) in enumerate(zip(names[::-1],
                                         plain.pyramid(img, len(names))[::-1])):
    lvl = slice_level(grid[..., 3 * il:3 * il + 3, :], name, level)
    out = lvl if out is None else (
        plain.resize_bilinear(out, lvl.shape[1:3]) + lvl)
  return out


def forward_train(sd, model, lowres, fullres):
  """Training forward (no clip), differentiable through the weights; the
  guides' batch norm on batch statistics."""
  grid = plain.backbone(sd, lowres.permute(0, 3, 1, 2), model['luma_bins'])
  return _levels(sd, model, grid, fullres, lambda g, name, level:
                 plain.slice_apply(g, plain.nn_guide(sd, level, name, True),
                                   level))


@torch.no_grad()
def serve(sd, model, frame_u8, block_rows=540):
  """(1, H, W, 3) uint8 frame -> (1, H, W, 3) float32 result in [0, 1]:
  preview, backbone, then each level's guide (running statistics) and
  slice + apply in blocks of rows, summed coarse to fine; clip."""
  img = plain.to_unit(frame_u8)
  grid = plain.preview_grid(sd, img, model)

  def slice_level(g, name, level):
    guide = functools.partial(plain.nn_guide, p=name, training=False)
    return plain.blocks(g, level, guide, sd, block_rows)
  return torch.clamp(_levels(sd, model, grid, img, slice_level), 0.0, 1.0)
