"""HDRNetStack (google/hdrnet ``scripts/ll/train_stack.sh``): two chained
pointwise-NN-guide HDRNets, ``stage0`` and ``stage1``, each with its own
coefficient backbone, NN guide and grid. Stage 0 enhances the input;
stage 1 enhances stage 0's full-resolution output, its preview the
nearest resize of that output to the net input size. Neither the model
nor this reference clips between the stages or at the end of training;
serving clips the last output. Served by the composite route: the
model's forward in float32 (no fused kernel chains two stages), then the
clip.

The layer equations are those of the repo's JAX package
(``hdrnet_tpu/models/extended.py``, ``HDRNetStack``), which google/
hdrnet's current ``hdrnet/models.py`` no longer holds. This file follows
them with one departure of no effect: the JAX model also resizes the last
stage's output into a preview that nothing reads; this reference does
not. Each stage is ``plain.backbone``, ``plain.nn_guide`` and a slice-
apply over the stage's own leaves (the state dict's ``stage{s}.`` names
with that prefix stripped). Stage 1's slice-apply is the one with the
reference op's gradient with respect to the image
(``HDRNetFeaturesPyrNN3.slice_apply``: d_image[j] = sum_i ct[i] A[i, j]),
since its image is stage 0's output: stage 0 learns only through it, the
stage 1 guide's input gradient and the nearest preview's.
"""

import functools

import torch

from portbench import counts
from portbench.models import HDRNetFeaturesPyrNN3
from portbench.reference import plain

LEVELS = 1
FUSED_U8 = False
N_STAGES = 2
GUIDE = 'guide.'


def guide_ops(model):
  return counts.nn_guide_ops(model['guide_complexity'])


def guide_params(model):
  """The first 1x1 conv, the folded batch norm's scale and shift, the
  second conv and its bias."""
  return (counts.N_IN + 2) * model['guide_complexity'] + 1


# --- the plain reference --------------------------------------------------


def stage_params(sd, s):
  """Stage s's leaves under the names of one HDRNet (``coefficients.*``,
  ``guide.*``): a view of `sd`, the same tensors."""
  p = f'stage{s}.'
  return {k[len(p):]: v for k, v in sd.items() if k.startswith(p)}


def _grid(ssd, model, lowres):
  return plain.backbone(ssd, lowres.permute(0, 3, 1, 2), model['luma_bins'])


def forward_train(sd, model, lowres, fullres):
  """Training forward (no clip), differentiable through the weights of
  both stages; the guides' batch norm on batch statistics."""
  out = fullres
  for s in range(N_STAGES):
    ssd = stage_params(sd, s)
    if s > 0:
      lowres = plain.preview(out, model['net_input_size'])
    # Stage 0's image is the input (data); a later stage's is learned.
    slice_apply = (plain.slice_apply if s == 0
                   else HDRNetFeaturesPyrNN3.slice_apply)
    out = slice_apply(_grid(ssd, model, lowres),
                      plain.nn_guide(ssd, out, GUIDE, True), out)
  return out


@torch.no_grad()
def serve(sd, model, frame_u8, block_rows=540):
  """(1, H, W, 3) uint8 frame -> (1, H, W, 3) float32 result in [0, 1],
  the composite route: the frame's nearest preview, then each stage (its
  backbone whole, its guide on running statistics and the slice + apply
  in blocks of rows; a later stage's preview from the whole frame of the
  stage before); the clip. (The stream requantizes it as trunc(v * 255 +
  0.5).)"""
  out = plain.to_unit(frame_u8)
  guide = functools.partial(plain.nn_guide, p=GUIDE, training=False)
  for s in range(N_STAGES):
    ssd = stage_params(sd, s)
    grid = _grid(ssd, model, plain.preview(out, model['net_input_size']))
    out = plain.blocks(grid, out, guide, ssd, block_rows)
  return torch.clamp(out, 0.0, 1.0)


# --- counts of a step ------------------------------------------------------


def train_step_ops(model, size):
  """Forward and backward (twice the forward) of one image: each stage's
  backbone and, a full-resolution pixel, its NN guide and slice-apply;
  the l2 loss. The nearest preview moves values and counts none."""
  px = size * size
  stage = counts.backbone_ops(model) + px * (guide_ops(model)
                                             + counts.SLICE_APPLY_OPS)
  return 3 * (N_STAGES * stage + 3 * counts.N_IN * px)


def slice_apply_bound_s(model, size):
  """Summed bounds of a step's slice-apply kernels: K3 a stage (grid,
  guide, image in; output out); K4 of stage 0 with the guide's cotangent
  only (grid, guide, image, cotangent in; d_guide out), of every later
  stage with both (d_guide and d_image out, and the image's 3 x 3 FMA a
  pixel more); K5 a stage (guide, image, cotangent in; the grid
  cotangent out, every mirror-padded pixel splatted)."""
  sb, n = model['spatial_bin'], size
  gb = counts.grid_bytes(model)
  px = n * n
  pad = -(-n // (2 * sb))
  padded = (n + 2 * pad) ** 2
  io = counts.N_IN
  total = 0.0
  for s in range(N_STAGES):
    total += counts.bound_s(gb + px * (1 + 2 * io) * 4,
                            px * counts.SLICE_APPLY_OPS)
    if s == 0:
      total += counts.bound_s(gb + px * (2 + 2 * io) * 4,
                              px * counts.K4_GUIDE_OPS)
    else:
      total += counts.bound_s(gb + px * (2 + 3 * io) * 4,
                              px * (counts.K4_GUIDE_OPS + 2 * io * io))
    total += counts.bound_s(gb + px * (1 + 2 * io) * 4,
                            padded * counts.K5_OPS)
  return total
