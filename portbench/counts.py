"""The work of a frame or a training step, counted from shapes.

Frozen here so that the yardstick does not move with the program. The
per-pixel operation counts and the bound arithmetic are those the port's
bring-up derived from its kernels' code (``chip_smoke.py``'s
``CURVES_GUIDE_OPS``, ``SLICE_APPLY_OPS``, ``K4_GUIDE_OPS``, ``K5_OPS``,
``_nn_guide_ops``, ``_bound``, ``_fused_bound``, ``_slice_bounds``); they
count the function's work, whatever implements it:

  * bytes: each input read once, each output written once, at the H100
    SXM's 3.35 TB/s;
  * operations (an FMA counts two) at 67 TFLOP/s, the float32 rate
    outside the tensor cores: the configurations compute in float32 with
    TF32 off;
  * a convolution 2 k^2 Cin Cout operations an output pixel, a dense
    layer 2 in out; a bilinear resize 3 operations (a + (b - a) f) an
    output value a pass, rows then columns; a backward pass twice its
    forward.

What differs between model families (levels, guide, how the frame is
served) comes from the family's file, ``portbench/models/<model_name>.py``;
a family may replace any of the functions marked ``per_model`` below with
its own of the same name there.
"""

from __future__ import annotations

import functools
import math

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# float32 operations a pixel: the curves guide 3 x (3 FMA + 16 x (sub,
# max, FMA) + FMA) + add + clip; slice + apply: the y and x taps (14 each),
# the depth taps (15), 12 corner weights, 8 corners x 12 FMA, the 3 x 3
# FMA affine and the clip; K4 with the guide's cotangent only: the taps and
# weights with their depth derivatives (68), 8 corners x 12 FMA and the
# 15-FMA contraction; K5 a mirror-padded pixel: the C = 12 products, the
# weights (30) and 4 cells x 2 depth bins x 12 FMA.
CURVES_GUIDE_OPS = 219
SLICE_APPLY_OPS = 271
K4_GUIDE_OPS = 290
K5_OPS = 234
N_IN = 3


def nn_guide_ops(gc):
  """gc x (3 FMA, max, FMA) + the sigmoid (4)."""
  return 9 * gc + 4


def bound_s(n_bytes, n_ops):
  """The least time the card could take for the work."""
  return max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S)


def spec(model):
  """The model family's file."""
  from portbench import models
  return models.load(model['model_name'])


def per_model(fn):
  """`fn`, unless the model's family defines its own of that name."""
  @functools.wraps(fn)
  def dispatch(model, *args):
    return getattr(spec(model), fn.__name__, fn)(model, *args)
  return dispatch


def levels(model, h, w):
  """The (h, w) of each level the model slices, finest first."""
  return [(h >> i, w >> i) for i in range(spec(model).LEVELS)]


def grid_bytes(model):
  """One level's packed grid: 16 x 16 x gd x 3 outputs x 4 inputs."""
  sb = model['spatial_bin']
  return sb * sb * model['luma_bins'] * 3 * (N_IN + 1) * 4


@per_model
def backbone_ops(model):
  """Forward operations of the coefficient backbone on one preview."""
  s, sb = model['net_input_size'], model['spatial_bin']
  gd, cm = model['luma_bins'], model['channel_multiplier']
  n_out = 3 * spec(model).LEVELS

  def conv(side_out, k, cin, cout):
    return 2 * side_out * side_out * k * k * cin * cout

  ops, ch, side = 0, N_IN, s
  for i in range(int(math.log2(s / sb))):
    side = -(-side // 2)
    out = cm * 2 ** i * gd
    ops += conv(side, 3, ch, out)
    ch = out
  g1 = -(-sb // 2)
  g2 = -(-g1 // 2)
  ops += conv(g1, 3, ch, 8 * cm * gd) + conv(g2, 3, 8 * cm * gd, 8 * cm * gd)
  fc = [8 * cm * gd * g2 * g2, 32 * cm * gd, 16 * cm * gd, 8 * cm * gd]
  ops += sum(2 * a * b for a, b in zip(fc, fc[1:]))
  ops += conv(sb, 3, ch, 8 * cm * gd) + conv(sb, 3, 8 * cm * gd, 8 * cm * gd)
  ops += conv(sb, 1, 8 * cm * gd, gd * n_out * (N_IN + 1))
  return ops


def resize_ops(h_in, w_in, h_out, w_out, c=N_IN):
  return 3 * c * (h_out * w_in + h_out * w_out)


def forward_ops(model, h, w, serving):
  """A frame's (serving) or a training image's forward operations."""
  lv = levels(model, h, w)
  ops = backbone_ops(model)
  per_pixel = spec(model).guide_ops(model) + SLICE_APPLY_OPS
  ops += sum(per_pixel * a * b for a, b in lv)
  for (ha, wa), (hb, wb) in zip(lv, lv[1:]):
    ops += resize_ops(ha, wa, hb, wb)           # the level below
    ops += resize_ops(hb, wb, ha, wa) + N_IN * ha * wa  # upsample-add
  if serving and not spec(model).FUSED_U8:
    ops += 3 * N_IN * h * w  # dequantize, requantize (clip counted)
  if not serving:
    ops += 3 * N_IN * h * w  # the l2 loss
  return ops


@per_model
def serve_frame_ops(model, h, w):
  return forward_ops(model, h, w, serving=True)


@per_model
def train_step_ops(model, size):
  """Forward and backward (twice the forward) of one image."""
  return 3 * forward_ops(model, size, size, serving=False)


@per_model
def fused_bound_s(model, h, w):
  """Summed bounds of a frame's fused guide + slice + apply launches, one
  a level: on the uint8 frame to uint8 where the family serves so (K1),
  else on float32 levels (K6)."""
  fam = spec(model)
  total = 0.0
  for a, b in levels(model, h, w):
    px = a * b
    io = px * N_IN * (1 if fam.FUSED_U8 else 4)
    total += bound_s(2 * io + grid_bytes(model) + 4 * fam.guide_params(model),
                     px * (fam.guide_ops(model) + SLICE_APPLY_OPS))
  return total


@per_model
def slice_apply_bound_s(model, size):
  """Summed bounds of a training step's slice-apply kernels at each level:
  K3 (grid, guide, image in; output out), K4 with the guide's cotangent
  only (grid, guide, image, cotangent in; d_guide out) and K5 (guide,
  image, cotangent in; the grid cotangent out, every mirror-padded pixel
  splatted)."""
  sb = model['spatial_bin']
  gb = grid_bytes(model)
  total = 0.0
  for n, _ in levels(model, size, size):
    px = n * n
    pad = -(-n // (2 * sb))
    padded = (n + 2 * pad) ** 2
    total += bound_s(gb + px * (1 + 2 * N_IN) * 4, px * SLICE_APPLY_OPS)
    total += bound_s(gb + px * (2 + 2 * N_IN) * 4, px * K4_GUIDE_OPS)
    total += bound_s(gb + px * (1 + 2 * N_IN) * 4, padded * K5_OPS)
  return total
