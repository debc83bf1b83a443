"""HDRNetCurves (google/hdrnet ``hdrnet/models.py``): one level sliced by
the curves guide; serving's fused kernel (K1) reads and writes the uint8
frame."""

import torch

from portbench import counts
from portbench.reference import plain

LEVELS = 1
FUSED_U8 = True


def guide_ops(model):
  return counts.CURVES_GUIDE_OPS


def guide_params(model):
  """The colour matrix and its bias, 16 shifts and slopes a channel, the
  channel mix and its bias."""
  n = counts.N_IN
  return (n + 1) * n + 2 * n * 16 + n + 1


def forward_train(sd, model, lowres, fullres):
  """Training forward (no clip), differentiable through the weights."""
  grid = plain.backbone(sd, lowres.permute(0, 3, 1, 2), model['luma_bins'])
  return plain.slice_apply(grid, plain.curves_guide(sd, fullres), fullres)


@torch.no_grad()
def serve(sd, model, frame_u8, block_rows=540):
  """(1, H, W, 3) uint8 frame -> (1, H, W, 3) float32 result in [0, 1]:
  preview, backbone, guide, slice + apply in blocks of rows, clip."""
  img = plain.to_unit(frame_u8)
  grid = plain.preview_grid(sd, img, model)
  return torch.clamp(plain.blocks(grid, img, plain.curves_guide, sd,
                                  block_rows), 0.0, 1.0)
