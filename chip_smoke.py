#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It builds the
hand-written kernels from ``hdrnet_torch/csrc`` (into
``build/hdrnet_torch/``) and checks each against its plain PyTorch version
on the card. Serving: it drives ``Enhancer.process`` and
``Enhancer.stream`` of the default ``HDRNetCurves`` (256^2 preview,
l8/s16, seeded weights) on 4K frames (kernels K2, K1), then those of
``HDRNetPointwiseNNGuide`` (K2, K6) and ``HDRNetGaussianPyrNN`` (K2, one
K6 a pyramid level) at the same widths with gc 16 and perturbed guide
batch-norm statistics. Training: it holds the CUDA path's gradients of
one 2048^2 step of ``HDRNetCurves`` and of ``HDRNetGaussianPyrNN`` to the
plain versions', then trains ``HDRNetCurves`` at the width of
``scripts/ll/train_std.sh`` (l8/s16/cm1, 256^2 preview, 2048^2, batch 1,
Adam 1e-4) for 30 steps and ``HDRNetGaussianPyrNN`` at that of
``scripts/ll/train_gpyrnn.sh`` (the same widths) for 20 (kernels K3, K4,
K5), saving, restoring and serving each checkpoint. The launch counters
show that each path ran its kernels; CUDA events time the kernels, the
serving paths and the train steps.

Any frame size and giant frames: it holds K7 (the offset and
total-extent arguments of K1 and K6) to its plain version on 4K bands
and the bands to the whole-frame kernel bit for bit; serves one
4320x7680 frame through ``Enhancer.enhance_sharded`` in four H-bands on
the card for all three models (bit-identical to ``process``, within
K1_TOL of the same bands on the plain versions, 4 K1, 4 K6 and 12 K6
launches), timed in turns with ``process``, and times K7 on those 8K
bands in turns with the whole-frame kernel; serves four photo
sizes through ``bin/run.py``'s per-image function
(``Enhancer.enhance_any``) for all three models against the plain chain;
and holds K2 to its plain version at the JAX row-gather variant's cases
(K2g).

The last TPU kernel and the tools: K2x, the one-hot preview downsample
on the tensor cores, through its main path, the port's experiment script
``hdrnet_torch/scripts/exp_downsample_v2.py``, then both row modes bit
for bit against their plain versions and K2 at 4K b=1 and b=4 and on
both copy routes at small sizes, timed in CUDA graphs in turns with K2;
K2, K2g and K2x are timed as kernels (CUDA graphs: an eager call of the
wrapper is longer than the kernel), beside one ``aten::index`` call of
the same function and the K2 wrapper's host microseconds a call;
``bin/export.py``'s ``main`` on a seeded ``HDRNetCurves``
and a seeded ``HDRNetGaussianPyrNN`` checkpoint (every ``.pt2`` reloaded
and bit-identical to the eager Enhancer, ``serve_any_fn`` at two more
sizes, the kernels' launches counted), and the host cost of a registered
``hdrnet::`` op call against a direct one; ``bin/fit_grid.py``'s
``fit_pair`` at 1024^2 on the card, and at 256^2 on the card against the
CPU.

The extended zoo and the baselines (the composite route: the model's
forward, whose slice-apply is K3, and K4 and K5 in training):
``scripts/ll_strong/train_fpyrnn3_cm2.sh``'s ``HDRNetFeaturesPyrNN3``
(cm 2, 1024^2, b=4; K3/K4/K5 at n_in 8, C = 27, K4 with the features'
cotangent) trains 10 steps, its first step's gradients held to the
plain path's, resumes bit for bit, and serves 4K frames through
``Enhancer.process`` and ``make_stream_fn`` against the plain chain;
each of the other 13 new models takes one step at its script's widths
(the size cut to 512^2 b=1) and serves one 1080p frame, both held to the
plain path; K3/K4/K5 are held and timed at the fpyrnn3_cm2 shapes (C =
27, b=4, 1024^2, 512^2, 256^2). The bfloat16 coefficient backbone
(``Enhancer(coeff_bf16=True)``) of ``HDRNetCurves`` and
``HDRNetPointwiseNNGuide`` serves 4K frames in turns with float32,
against it.

The redesigned kernels (K5 as regions of row strips with a fixed-order
sum of partials; K1/K6/K7, K3 and K4 on 2D tiles with the tile's cells
staged in shared memory): K3, K4 and K5 also at n_in = 8 and under a
grid whose tile windows K3/K4 read from device memory, against their
plain versions, and K3, K4 and K5 timed at the pyramid's three level
sizes (2048^2, 1024^2, 512^2), K5 with its scratch memory. The K3, K4
and K5 rows count their launches on every path that runs them: the
curves and pyramid train steps, evaluate, export and fit_grid.

The quality workload, ``scripts/ll/quality_run.sh``'s path: the
local-Laplacian set built on the card at 1024^2 by
``hdrnet_torch.scripts.make_ll_dataset`` (16 train and 4 test images;
the first held to the same functions on the CPU), ``HDRNetCurves``
trained through ``bin/train.py``'s ``main`` with its flags and
``--device_data`` for QUALITY_STEPS steps from device memory (the
device route asserted, one gathered batch held bit for bit to the
CPU), a step timed with and without ``--device_data``
in turns, ``bin/evaluate.py`` (training graph: K3; serving: K1) at step
0 and at the end, whose PSNR must rise, and ``bin/fit_grid.py`` on the
test split; then the usm workload (targets synthesized on the card
held to the host pipeline's, ``make_usm_dataset``) and the
style-transfer one (``make_st_dataset``, ``StyleTransferCurves`` at
n_in 6) with ``--device_data``.

Training on a ('data', 'spatial') mesh (``hdrnet_torch.parallel.mesh``;
the halos of the resizes and k x k convs exchanged by
``hdrnet_torch.parallel.halo``), on the quality workload's set: K3, K4
and K5 on 2 and 4 H-bands of its 1024^2 b=4 frames and on the 4 uneven
bands of a pyramid level (270x480 b=4) (their band arguments: K3's and
K4's bands bit for bit the whole's rows, K5's shares summed to the
whole's, each band against its plain version; timed over 4 bands in
turns with the whole); ``bin/train.py``'s ``main`` on four gloo ranks
sharing the card (NCCL refuses two ranks on one device) at (4, 1), (2,
2) twice and (1, 4) for ``HDRNetCurves``, at (2, 2) for
``HDRNetPointwiseNNGuide``, at (4, 1), (2, 2) and (1, 4) for
``HDRNetGaussianPyrNN`` and ``HDRNetFeaturesPyrNN3`` (cm 2), and one step
of each other model of the registry at (1, 4) on a seeded 256^2 b=4
batch, each held to the (1, 1) run of this process and its ranks to
each other bit for bit, the two (2, 2) runs bit for bit under
cudnn.deterministic;
a step on one NCCL rank under torchrun in turns with the step with no
process group; and ``python -m torch.distributed.run --nproc_per_node 1
-m hdrnet_torch.bin.train ... --mesh_shape 1 1`` on NCCL. The ranks are
this script in its worker mode (``chip_smoke.py --mesh_worker SPEC``,
started by torchrun), with the kernels built by this process first.

The quality-triage tools: ``hdrnet_torch.scripts.guide_stats`` and
``diagnose_pyramid`` on the pyramid checkpoint of the 2048^2 training
phase over two images of the quality set (their K3 launches counted),
held to the same runs with ``--device cpu``.

The native deployment path (``hdrnet_torch/native``): the ``hdrnet::``
op library (the kernel-backed ops and ``hdrnet::resize_bilinear`` in
C++) and the C++ runner built with g++; a seeded ``HDRNetCurves``
exported by ``bin/export.py``'s ``main`` with ``--aoti`` at 1080p, and
``HDRNetPointwiseNNGuide``'s ``serve_fn``, ``HDRNetGaussianPyrNN``'s
``enhance_fn``, ``serve_fn``, ``stream_fn`` and ``serve_any_fn`` and
``HDRNetFeaturesPyrNN3``'s (cm 2) ``stream_fn`` compiled the same way;
each AOTInductor package served by ``aoti_serve`` in a subprocess with
no Python in it, the two ``serve_any_fn`` packages at 723x1085 and
2160x3840 through ``--dim``, held to the eager Enhancer, its op
library's launches of K1, K2, K3 and K6 and calls of the resize checked
against the graph's own nodes and the launches added to the kernels
line; the pyramid's package refused without the op library; the
runner's ``serve_fn`` and ``serve_any_fn`` timed in turns with the
Python ``load_artifact`` graph's.

Each phase prints one line and raises on failure. The last three lines
are the card's name and power limit as nvidia-smi gives them, a JSON
object describing each kernel (its launches on the path that runs it,
its error, its time, its plain version's, and the least time the card
could take for its work, from its bytes at 3.35 TB/s and its float32
operations at 67 TFLOP/s; K2x computes K2's function and takes its
bound, with the floors of its two formulations, their bf16 tensor-core
operations at 989 TFLOP/s, beside it; ``library_ms`` for K2, K2g and
K2x), and ``{"ok": true, "device":
...}``. Without
a CUDA device, or outside a checkout, it fails before printing any
result. It imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import signal
import subprocess
import sys
import time

import numpy as np
import torch

UHD = (2160, 3840)
FHD = (1080, 1920)
EIGHT_K = (4320, 7680)  # 4320 = 4 bands x 4 (the pyramid's two halvings)
PHOTO_SIZES = ((3024, 4032), (4032, 3024), (1365, 2047), (723, 1085))
TRAIN_HW = (2048, 2048)
K1_TOL = 1e-4      # float32 sums in another order, FMA contraction
IDENTITY_TOL = 2e-4  # the smoothed depth tent's own deficit, 1 - sqrt(1e-8)
U8_MAX_SHARE = 0.01  # uint8: at most 1 code on fewer than 1% of values
K3_TOL = 1e-4      # as K1; also K4's input cotangent
K4_GUIDE_REL = 1e-4  # of max(1, max |want|): the guide cotangent carries gd
K5_REL = 2e-4      # of max(1, max |want|): sums over ~66k pixels a cell,
                   # the JAX package's gate for its own splat kernel
GRAD_REL = 1e-4    # model gradients, of each leaf's max |g|
# One step after a restore vs one step of the original, both with cuDNN's
# deterministic algorithms: the restore is exact, so the bits must match.
# (cuDNN's default weight-gradient algorithms for the backbone's convs sum
# in no fixed order, about 1e-6 apart from run to run after Adam.)
RESUME_TOL = 0.0
TRAIN_STEPS = 30
PYR_TRAIN_STEPS = 20
NN = 'HDRNetPointwiseNNGuide'
PYR = 'HDRNetGaussianPyrNN'

# The extended zoo: scripts/ll_strong/train_fpyrnn3_cm2.sh trained at its
# size; the other new models at their scripts' widths (the default
# ModelConfig: l8/s16/cm1, 256^2, gc 16, depth 5 and width 32 for the
# baselines; 6 input channels for the style models) and one step at a
# size cut to ZOO_CUT_HW, b=1. (model, n_in, script, slice-applies a
# forward).
FPYR = 'HDRNetFeaturesPyrNN3'
ZOO_TRAIN_HW = (1024, 1024)
ZOO_TRAIN_B = 4
ZOO_STEPS = 10
ZOO_CUT_HW = (512, 512)
ZOO_OTHERS = [
    ('UNet', 3, 'scripts/ll/train_unet.sh', 0),
    ('DilatedConvolutions', 3, 'scripts/ll/train_dilated.sh', 0),
    ('HDRNetGaussianPyr', 3, 'scripts/ll/train_gpyr.sh', 3),
    ('HDRNet3x3NNGuide', 3, 'scripts/ll/train_3x3nn_guide.sh', 1),
    ('HDRNetStack', 3, 'scripts/ll/train_stack.sh', 2),
    ('HDRNetFullresFeatures', 3,
     'scripts/ll_strong/train_fullres_features.sh', 1),
    ('HDRNetFullresFeaturesMultiscale', 3,
     'scripts/ll_strong/train_fullres_features_ms.sh', 1),
    ('HDRNetFullresFeaturesWithGuide', 3,
     'scripts/ll_strong/train_fullres_features_w_guide.sh', 1),
    ('HDRNetFeaturesPyrNN', 3, 'scripts/ll_strong/train_fpyrnn.sh', 3),
    ('HDRNetFeaturesPyrNN2', 3, 'scripts/ll_strong/train_fpyrnn2.sh', 3),
    ('HDRNetFeaturesPyrSimpleGuideNN', 3,
     'scripts/ll_strong/train_fpyr_simple_guide.sh', 3),
    ('StyleTransferNN', 6, 'scripts/st/nst_nn.sh', 1),
    ('StyleTransferCurves', 6, 'scripts/st/nst_curves.sh', 1),
]
# HDRNetStack's guides: the first stage's gradient passes through the
# whole second stage, where float32 rounding grows
# (tests/test_torch_zoo_train.py measures up to 1.9e-4 of the leaf's max
# against the JAX step on the CPU); the second stage's conv2 bias, one
# entry summed over 262144 pixels of terms of both signs, differed from
# the plain path's by 3.3e-4 of its value on an NVIDIA H100 80GB HBM3
# (700 W) in this script's run. Held to 1e-3; every other leaf to
# GRAD_REL.
STACK_GUIDE_REL = 1e-3
# The bfloat16 backbone against float32 at the default widths:
# tests/test_torch_zoo_tools.py measured on the CPU (540x960, seeds
# 0-2, both models) max abs 2.07e-2 to 3.06e-2 and PSNR 47.97 to 50.25
# dB, and holds them to these limits.
BF16_MAX_ABS = 6e-2
BF16_MIN_PSNR = 44.0

# The quality workload, scripts/ll/quality_run.sh, at its widths and size
# (HDRNetCurves l8/s16/cm1, 256^2 preview, gc 16, 1024^2, b=4) with its
# flags; cut for the time limit: 16 train and 4 test images (it builds
# 220 and 24), QUALITY_STEPS steps (it trains 120000), fit_grid --limit 4
# (it fits 8). The usm workload (scripts/usm/train_std.sh) and the style
# transfer one (scripts/st/nst_curves.sh, 512^2 crops) on the same images,
# SIDE_STEPS steps each.
QUALITY_DIR = 'build/chip_smoke_quality'
QUALITY_SIZE = 1024
QUALITY_IMAGES = (16, 4)
QUALITY_STEPS = 1500
QUALITY_FLAGS = [
    '--batch_size', '4', '--output_resolution', '1024', '1024',
    '--fliplr', '--flipud', '--rotate', '--norandom_crop',
    '--cache_images', '--device_normalize', '--device_data',
    '--learning_rate', '1e-4', '--lr_schedule', 'cosine', '--lr_end', '1e-6',
    '--lr_warmup_steps', '500']
USM_FLAGS = [
    '--data_pipeline', 'UnsharpMaskDataPipeline', '--blur_sigma', '4',
    '--sharpen', '1', '--learning_rate', '1e-4', '--batch_size', '1',
    '--model_name', 'HDRNetCurves', '--nobatch_norm',
    '--output_resolution', '1024', '1024', '--device_data']
ST_FLAGS = [
    '--data_pipeline', 'StyleTransferDataPipeline', '--learning_rate', '1e-4',
    '--batch_size', '4', '--model_name', 'StyleTransferCurves',
    '--nobatch_norm', '--output_resolution', '512', '512', '--random_crop',
    '--luma_bins', '8', '--spatial_bin', '16', '--device_data']
SIDE_STEPS = 10
# Steps a timing turn takes, and the first ones left out of its median
# (the host pipeline decodes every image once in its first epoch).
TURN_STEPS, TURN_WARMUP = 60, 20
# The generator on the card against the same function on the CPU, before
# quantization (CUDA's pow, cos and division by a scalar round otherwise;
# the operator gets the same luminance and remap gammas on both, since
# its remap amplifies an ulp there), the JAX test's operator tolerance;
# the PNGs to U8_MAX_SHARE.
LL_TOL = 1e-4
# The JAX package's trained number, for its scale only: 220 images,
# 120000 steps (results/round4_quality.json).
JAX_QUALITY_PSNR = 29.95

# The ('data', 'spatial') mesh phase: the quality workload's widths and
# set, at its peak lr held constant (its schedule warms up from 0 over 500
# steps, which would leave a few steps nothing to compare), MESH_STEPS
# steps a run, on four gloo ranks sharing the card (NCCL refuses two ranks
# on one device) and on one NCCL rank under torchrun; the (1, 1)
# reference in this process, with no process group. A layout is held to
# it at tests/test_parallel.py's tolerances (the JAX package's (4, 2)
# against (8, 1)); the band kernels at 1024^2 b=4 to the whole frame.
MESH_DIR = 'build/chip_smoke_mesh'
MESH_FLAGS = QUALITY_FLAGS[:QUALITY_FLAGS.index('--learning_rate')] + [
    '--learning_rate', '1e-4']
MESH_STEPS, MESH_WARMUP = 6, 2
MESH_LAYOUTS = [('curves_4x1', 'HDRNetCurves', (4, 1)),
                ('curves_2x2', 'HDRNetCurves', (2, 2)),
                ('curves_2x2_again', 'HDRNetCurves', (2, 2)),
                ('curves_1x4', 'HDRNetCurves', (1, 4)),
                ('nn_2x2', NN, (2, 2)),
                ('pyr_4x1', PYR, (4, 1)), ('pyr_2x2', PYR, (2, 2)),
                ('pyr_1x4', PYR, (1, 4)),
                ('fpyr_4x1', FPYR, (4, 1)), ('fpyr_2x2', FPYR, (2, 2)),
                ('fpyr_1x4', FPYR, (1, 4))]
# Each mesh model's flags beyond MESH_FLAGS (FPYR: train_fpyrnn3_cm2.sh's)
# and its slice-applies a step (one K3, K4 and K5 each).
MESH_MODEL_FLAGS = {FPYR: ['--channel_multiplier', '2', '--nobatch_norm']}
MESH_SLICES = {'HDRNetCurves': 1, NN: 1, PYR: 3, FPYR: 3}
# The other 13 models (ZOO_OTHERS, their scripts' widths): one step each
# on a seeded MESH_ZOO_B x MESH_ZOO_HW batch made on the card, at
# MESH_ZOO_LAYOUT on the same ranks, against the step of this process. A
# first Adam step moves no parameter by more than its lr, whatever the
# gradient, so the gradients it stepped with (summed over the mesh) are
# held too, to MESH_GRAD_REL of each leaf's max |g| (measured at most
# 2.04e-4, HDRNetFeaturesPyrNN2's coarsest guide: float32 sums of a
# 16-row band's pixels in another order).
MESH_ZOO_HW, MESH_ZOO_B, MESH_ZOO_LAYOUT = (256, 256), 4, (1, 4)
MESH_PARAM_RTOL, MESH_PARAM_ATOL = 1e-3, 2e-4
MESH_GRAD_REL = 1e-3
MESH_LOSS_RTOL = 1e-5
BAND_SHARE_REL = 1e-5  # K5's band shares summed, of the frame's max
# A pyramid level cut unevenly: the third level of a 1080x1920 frame, whose
# 270 rows a (1, 4) mesh cuts into bands of 67, 68, 67 and 68.
LEVEL_HW = (270, 480)
# FPYR cm 2's slice-apply on the bands of its 512^2 level at (1, 4): its
# 4 * cm learned features (n_in 8, C = 27), b=4, as the mesh runs give it.
FPYR_LEVEL_HW, FPYR_FEATURES = (512, 512), 8
MESH_TIMEOUT_S = 300

# The least time the card could take (H100 SXM data sheet at 700 W): the
# larger of the bytes a kernel must move over the memory rate and its
# float32 operations over the non-tensor float32 rate.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# float32 operations a pixel (an FMA counts two), from the kernels' code:
# curves guide 3 x (3 FMA + 16 x (sub, max, FMA) + FMA) + add + clip; NN
# guide gc x (3 FMA, max, FMA) + the sigmoid (4); slice + apply: the y and
# x taps (14 each), the depth taps (15), 12 corner weights, 8 corners x
# 12 FMA, the 3 x 3 FMA affine and the clip; K4 with the guide's
# cotangent only (the training path): the taps and weights with their
# depth derivatives (68), 8 corners x 12 FMA, and the 15-FMA contraction
# into d_guide; K5, a padded pixel: the C = 12 products, the weights (30)
# and 4 cells x 2 depth bins x 12 FMA.
CURVES_GUIDE_OPS = 219
SLICE_APPLY_OPS = 271
K4_GUIDE_OPS = 290
K5_OPS = 234


def _tally_slice(slice_launches, k3, k4=0, k5=0):
  """Adds one path's K3, K4 and K5 launches, counted between a reset of
  the wrappers' counters and their read, to the run's tally (the kernels
  line's launches of those rows)."""
  for key, n in (('K3', k3), ('K4', k4), ('K5', k5)):
    slice_launches[key] += n


def _nn_guide_ops(gc):
  return 9 * gc + 4


def _bound(n_bytes, n_ops, ops_per_s=F32_OPS_PER_S):
  """(ms, 'bytes' or 'operations'): the least time for the work."""
  t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
  t_ops = n_ops / ops_per_s * 1e3
  return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def _nbytes(*tensors):
  return sum(t.numel() * t.element_size() for t in tensors)


def _fused_bound(grid, frame, params, guide_ops, out_u8=False, reads=1):
  """Bound of K1/K6/K7 on this frame: the frame read once, the grid and
  parameters `reads` times (once a band), the output written once."""
  out_bytes = frame.numel() * (1 if out_u8 else 4)
  pixels = frame.numel() // 3
  return _bound(_nbytes(frame) + reads * _nbytes(grid, params) + out_bytes,
                pixels * (guide_ops + SLICE_APPLY_OPS))


def _nvidia_smi():
  out = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=True, timeout=60).stdout
  return out.strip().splitlines()[0].strip()


def _kernel_label(mangled):
  """'name<args>' of a mangled kernel name: float and uint8 arguments as
  f32 and u8, a class argument (the guide functor) by its own name."""
  k = re.search(r'([a-z][a-z_]*_kernel)(I\w*)?', mangled)
  if not k:
    return mangled
  rest, i, args = k.group(2) or '', 1, []
  while i < len(rest) and rest[i] != 'E':
    if rest[i] in 'fhix':
      args.append({'f': 'f32', 'h': 'u8', 'i': 'i32', 'x': 'i64'}[rest[i]])
      i += 1
    elif rest.startswith(('Li', 'Lb'), i):  # int or bool: L{i,b}<value>E
      n = re.match(r'L[ib](-?\d+)E', rest[i:])
      if not n:
        return mangled
      args.append(n.group(1))
      i += len(n.group())
    elif rest[i] == 'N':  # nested name: S_ (substitution) and <len><id>
      i += 1
      while i < len(rest) and rest[i] != 'E':
        if rest.startswith('S_', i):
          i += 2
          continue
        n = re.match(r'\d+', rest[i:])
        if not n:
          return mangled
        i += len(n.group())
        args.append(rest[i:i + int(n.group())])
        i += int(n.group())
      i += 1
    else:
      return mangled
  return f'{k.group(1)}<{",".join(args)}>' if args else k.group(1)


def _ptxas_summary(log):
  """Registers, shared memory and spills per kernel from -Xptxas -v."""
  rows = []
  for line in log.splitlines():
    m = re.search(r"Compiling entry function '(\w+)'", line)
    if m:
      rows.append({'kernel': _kernel_label(m.group(1))})
      continue
    if not rows:
      continue
    m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads', line)
    if m:
      rows[-1]['spill_bytes'] = int(m.group(1)) + int(m.group(2))
    m = re.search(r'Used (\d+) registers', line)
    if m:
      rows[-1]['registers'] = int(m.group(1))
      m = re.search(r'(\d+) bytes smem', line)
      rows[-1]['smem_bytes'] = int(m.group(1)) if m else 0
  if not rows:
    raise RuntimeError('no ptxas resource report in the build log')
  return rows


def _time_ms(fn, iters, warmup=3):
  """Mean device time of fn() in ms, by CUDA events around `iters` calls."""
  for _ in range(warmup):
    fn()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  torch.cuda.synchronize()
  start.record()
  for _ in range(iters):
    fn()
  end.record()
  end.synchronize()
  return start.elapsed_time(end) / iters


def _host_us(fn, n=2000):
  """Host microseconds a call of an eager function: `n` calls back to
  back between two synchronizations."""
  for _ in range(20):
    fn()
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  for _ in range(n):
    fn()
  torch.cuda.synchronize()
  return (time.perf_counter() - t0) / n * 1e6


def _u8_check(got, want, what):
  diff = (got.int() - want.int()).abs()
  worst, share = int(diff.max()), float((diff != 0).float().mean())
  if worst > 1 or share >= U8_MAX_SHARE:
    raise AssertionError(f'{what}: max {worst} codes, {share:.4%} differ')
  return worst, share


def _max_err(got, want, tol, what):
  err = float((got - want).abs().max())
  if not err <= tol:  # also catches NaN
    raise AssertionError(f'{what}: max abs err {err:.3e} > {tol:.0e}')
  return err


def _identity_grid(b, dev):
  grid = torch.zeros((b, 16, 16, 8, 12), device=dev)
  for i in range(3):
    grid[..., i * 4 + i] = 1.0
  return grid


def _scaled_err(got, want, rel, what):
  """Max abs error, held to `rel` of max(1, max |want|)."""
  scale = max(1.0, float(want.abs().max()))
  err = float((got - want).abs().max())
  if not err <= rel * scale:  # also catches NaN
    raise AssertionError(f'{what}: max abs err {err:.3e} > {rel:.0e} * '
                         f'{scale:.3e}')
  return err


def _train_inputs(gen, b, hw, n_in, dev, n_out=3, grid=(16, 16, 8)):
  """Packed grid, guide with exact 0s and 1s and a band outside [0, 1],
  image, output cotangent; all float32 on the card."""
  gh, gw, gd = grid
  c = n_out * (n_in + 1)
  g5 = torch.randn((b, gh, gw, gd, c), generator=gen, device=dev)
  guide = torch.rand((b, *hw), generator=gen, device=dev) * 1.2 - 0.1
  guide[:, :3] = 0.0
  guide[:, 3:6] = 1.0
  image = torch.rand((b, *hw, n_in), generator=gen, device=dev)
  ct = torch.randn((b, *hw, n_out), generator=gen, device=dev)
  return g5, guide, image, ct


def _slice_bounds(n, grid_shape=(1, 16, 16, 8, 12), n_in=3, n_out=3):
  """Bounds of K3, K4 (the guide's cotangent only) and K5 at n x n, b=1:
  each input read once, each output written once; K5 also splats every
  padded pixel."""
  _, gh, gw, _, _ = grid_shape
  grid_bytes = 4 * int(np.prod(grid_shape))
  pixels = n * n
  pad_y, pad_x = -(-n // (2 * gh)), -(-n // (2 * gw))
  padded = (n + 2 * pad_y) * (n + 2 * pad_x)
  return {
      # grid, guide, image in; output out.
      'K3': _bound(grid_bytes + pixels * (1 + n_in + n_out) * 4,
                   pixels * SLICE_APPLY_OPS),
      # grid, guide, image, ct in; d_guide out.
      'K4': _bound(grid_bytes + pixels * (1 + n_in + n_out + 1) * 4,
                   pixels * K4_GUIDE_OPS),
      # guide, image, ct in; the grid cotangent out.
      'K5': _bound(grid_bytes + pixels * (1 + n_in + n_out) * 4,
                   padded * K5_OPS),
  }


def _slice_levels(gen, dev, tag):
  """K3, K4 (the guide's cotangent only, as training runs it) and K5 at
  the pyramid's three level sizes, b=1, n_in = n_out = 3: CUDA events
  around 50 wrapper calls, and the device time of a call in a CUDA graph
  of 20 (no host gaps: at the small levels a launch is shorter than a
  wrapper call), with each bound; K5's blocks, its scratch and the memory
  one call allocates (scratch and output)."""
  from hdrnet_torch.ops import slice_apply as sa
  from hdrnet_torch.utils.timing import graph_ms
  levels = {'K3': {}, 'K4': {}, 'K5': {}}
  for n in TRAIN_HW[0], TRAIN_HW[0] // 2, TRAIN_HW[0] // 4:
    g5, guide, image, ct = _train_inputs(gen, 1, (n, n), 3, dev)
    calls = {
        'K3': lambda: sa.slice_apply_fwd(g5, guide, image),
        'K4': lambda: sa.slice_apply_pix_bwd(g5, guide, image, ct,
                                             need_input=False),
        'K5': lambda: sa.slice_apply_grid_bwd(g5.shape, guide, image, ct)}
    bounds = _slice_bounds(n, tuple(g5.shape))
    for kid, call in calls.items():
      levels[kid][f'{n}^2'] = {
          'ms': _time_ms(call, 50), 'graph_ms': graph_ms(call),
          'bound_ms': bounds[kid][0], 'bound_by': bounds[kid][1]}
    strips, floats, smem = sa.grid_bwd_plan(g5.shape, guide)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    calls['K5']()
    torch.cuda.synchronize()
    levels['K5'][f'{n}^2'].update({
        'strips': strips,
        'blocks': (g5.shape[1] + 1) * (g5.shape[2] + 1) * strips,
        'shared_bytes': smem, 'scratch_bytes': floats * 4,
        'peak_bytes_a_call': torch.cuda.max_memory_allocated() - before})
    del g5, guide, image, ct, calls
  for kid, by_size in levels.items():
    print(f'timing {tag}: {kid} at the pyramid\'s levels, b=1: '
          + '; '.join(f'{k} {v["ms"]:.4f} ms (graph {v["graph_ms"]:.4f}, '
                      f'bound {v["bound_ms"]:.4f})'
                      for k, v in by_size.items()), flush=True)
  print('K5 at the levels: ' + '; '.join(
      f'{k} {v["blocks"]} blocks, scratch {v["scratch_bytes"]} B, a call '
      f'allocates {v["peak_bytes_a_call"]} B'
      for k, v in levels['K5'].items()), flush=True)
  return levels


# (b, (h, w), grid, input channel counts) at which K3, K4 and K5 are held
# to their plain versions: the training shape, an odd one and one whose
# tile windows K3/K4 read from device memory, each with 3 input channels,
# none (the plain slice) and 8 (the zoo's feature models); then the
# quality workload's shapes (K5's plan is keyed on the batch, size and
# channels): its 1024^2 b=4 steps, the usm steps, evaluate and fit_grid at
# 1024^2 b=1, and the style-transfer steps at 512^2 b=4, n_in 6.
TRAIN_KERNEL_CASES = [
    (1, TRAIN_HW, (16, 16, 8), (3, 0, 8)),
    (2, (101, 60), (16, 16, 8), (3, 0, 8)),
    (1, (20, 70), (128, 128, 8), (3, 0, 8)),
    (4, (1024, 1024), (16, 16, 8), (3,)),
    (1, (1024, 1024), (16, 16, 8), (3,)),
    (4, (512, 512), (16, 16, 8), (6,)),
]


def _check_train_kernels(gen, dev, full_float32):
  """K3, K4 and K5 against their plain versions (under full float32) at
  TRAIN_KERNEL_CASES (n_in 8: K3 and K4's looped path, K5's C = 27); K5
  twice must give the same bits, and K4 without the input's cotangent the
  same d_guide bits."""
  from hdrnet_torch.ops import slice_apply as sa
  errs = {'K3': 0.0, 'K4': 0.0, 'K5': 0.0}
  for b, hw, grid, n_ins in TRAIN_KERNEL_CASES:
    for n_in in n_ins:
      g5, guide, image, ct = _train_inputs(gen, b, hw, n_in, dev,
                                           n_out=3 if n_in else 12, grid=grid)
      what = f'b={b} {hw} grid {grid} n_in={n_in}'
      with full_float32():
        out = sa.slice_apply_fwd(g5, guide, image)
        errs['K3'] = max(errs['K3'], _max_err(
            out, sa.slice_apply_fwd_plain(g5, guide, image), K3_TOL,
            f'K3 {what}'))
        d_grid = sa.slice_apply_grid_bwd(g5.shape, guide, image, ct)
        again = sa.slice_apply_grid_bwd(g5.shape, guide, image, ct)
        if not torch.equal(d_grid, again):
          raise AssertionError(f'K5 {what}: two runs differ')
        errs['K5'] = max(errs['K5'], _scaled_err(
            d_grid, sa.slice_apply_grid_bwd_plain(g5.shape, guide, image,
                                                  ct), K5_REL, f'K5 {what}'))
        if n_in:
          d_guide, d_image = sa.slice_apply_pix_bwd(g5, guide, image, ct)
          dg_only, _ = sa.slice_apply_pix_bwd(g5, guide, image, ct,
                                              need_input=False)
          if not torch.equal(dg_only, d_guide):
            raise AssertionError(f'K4 {what}: d_guide differs without '
                                 f'd_image')
          want_dg, want_di = sa.slice_apply_pix_bwd_plain(g5, guide, image,
                                                          ct)
          errs['K4'] = max(
              errs['K4'],
              _scaled_err(d_guide, want_dg, K4_GUIDE_REL, f'K4 guide {what}'),
              _max_err(d_image, want_di, K3_TOL, f'K4 input {what}'))
  torch.cuda.synchronize()
  print(f'K3/K4/K5 vs plain: max abs err K3 {errs["K3"]:.3e} (<= '
        f'{K3_TOL:.0e}), K4 {errs["K4"]:.3e} (guide <= {K4_GUIDE_REL:.0e} '
        f'of its max, input <= {K3_TOL:.0e}), K5 {errs["K5"]:.3e} (<= '
        f'{K5_REL:.0e} of its max), at 2048^2 b=1, 101x60 b=2 and 20x70 '
        f'under a 128x128x8 grid (K3/K4 windows in device memory), n_in 3, '
        f'0 and 8, and the quality workload\'s 1024^2 b=4 and b=1 (n_in 3) '
        f'and 512^2 b=4 (n_in 6); K5 bit-identical across runs, K4\'s '
        f'd_guide the same bits without d_image', flush=True)
  return errs


@contextlib.contextmanager
def _plain_slice_apply_ops():
  """Inside the block the slice-apply op of every model (forward and
  both backward passes) runs the plain versions of K3, K4 and K5, and the
  Enhancer's preview the plain version of K2; for comparison only."""
  import hdrnet_torch.inference as inference
  from hdrnet_torch.ops import downsample
  from hdrnet_torch.ops import slice_apply as sa
  saved = (sa.slice_apply_fwd, sa.slice_apply_pix_bwd,
           sa.slice_apply_grid_bwd, inference.nearest_lowres)
  sa.slice_apply_fwd = sa.slice_apply_fwd_plain
  sa.slice_apply_pix_bwd = sa.slice_apply_pix_bwd_plain
  sa.slice_apply_grid_bwd = sa.slice_apply_grid_bwd_plain
  inference.nearest_lowres = downsample.nearest_lowres_plain
  try:
    yield
  finally:
    (sa.slice_apply_fwd, sa.slice_apply_pix_bwd, sa.slice_apply_grid_bwd,
     inference.nearest_lowres) = saved


def _train_batches(n, cfg, seed=7, b=1):
  """n in-memory uint8 batches of b images, shaped like the pipeline's:
  seeded frames of cfg.n_in channels, their target clip(1.3 x) of the
  first three, and both cut to the preview by the legacy nearest
  table."""
  from hdrnet_torch.ops.resize import _nearest_indices
  rng = np.random.RandomState(seed)
  h, w = cfg.output_resolution
  s = cfg.net_input_size
  iy, ix = _nearest_indices(h, s), _nearest_indices(w, s)
  out = []
  for _ in range(n):
    full = rng.randint(0, 256, (b, h, w, cfg.n_in)).astype(np.uint8)
    target = np.clip(full[..., :3].astype(np.float32) * 1.3, 0,
                     255).astype(np.uint8)
    out.append({'lowres_input': np.ascontiguousarray(full[:, iy][:, :, ix]),
                'lowres_output': np.ascontiguousarray(target[:, iy][:, :, ix]),
                'image_input': full, 'image_output': target})
  return out


def _check_model_gradients(dev, full_float32, model_name='HDRNetCurves'):
  """Every parameter gradient of one 2048^2 step of the model at the
  default widths on the CUDA path against the same step on the plain
  versions."""
  from hdrnet_torch.config import ModelConfig
  from hdrnet_torch.models import make_model
  from hdrnet_torch.training import metrics, step
  cfg = ModelConfig(model_name=model_name, output_resolution=list(TRAIN_HW))
  model = make_model(cfg, generator=torch.Generator().manual_seed(11)).to(dev)
  batch = step.normalize_batch(step.to_device(_train_batches(1, cfg)[0], dev))
  params = list(model.parameters())

  def grads():
    with full_float32():
      out = model(batch['lowres_input'], batch['image_input'])
      loss = metrics.l2_loss(batch['image_output'], out)
      return loss.detach(), torch.autograd.grad(loss, params)

  loss, got = grads()
  with _plain_slice_apply_ops():
    want_loss, want = grads()
  worst = 0.0
  for (name, _), g, w in zip(model.named_parameters(), got, want):
    scale = float(w.abs().max())
    err = float((g - w).abs().max())
    if not err <= GRAD_REL * scale:
      raise AssertionError(f'gradient of {name}: {err:.3e} > {GRAD_REL:.0e}'
                           f' * {scale:.3e}')
    worst = max(worst, err / max(scale, 1e-30))
  if abs(float(loss) - float(want_loss)) > 1e-6 * abs(float(want_loss)):
    raise AssertionError(f'loss {float(loss)} vs plain {float(want_loss)}')
  print(f'gradient end to end: {model_name} at the default widths, 2048^2 '
        f'batch, {len(params)} leaves, worst |g - g_plain| / max|g_plain| '
        f'{worst:.3e} (<= {GRAD_REL:.0e}); loss {float(loss):.6f} vs plain '
        f'{float(want_loss):.6f}', flush=True)
  return worst


@contextlib.contextmanager
def _cudnn_deterministic():
  saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
  torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
      True, False)
  try:
    yield
  finally:
    (torch.backends.cudnn.deterministic,
     torch.backends.cudnn.benchmark) = saved


def _check_resume(cfg, state, fresh, batch, train_step, ckpt_dir, what):
  """Saves `state` and `cfg` to ckpt_dir (left there), restores them into
  fresh(99), and takes one step of each on `batch` under
  cudnn.deterministic: the losses and every parameter must agree bit for
  bit (RESUME_TOL). Returns the largest difference."""
  import shutil
  from hdrnet_torch.training.checkpoint import Checkpointer
  shutil.rmtree(ckpt_dir, ignore_errors=True)
  cfg.save(ckpt_dir)
  Checkpointer(ckpt_dir).save(state.step, state)
  restored = Checkpointer(ckpt_dir).restore(fresh(99))
  with _cudnn_deterministic():
    _, m_a = train_step(state, batch)
    _, m_b = train_step(restored, batch)
  err = abs(float(m_a['loss']) - float(m_b['loss']))
  for a, b in zip(state.model.parameters(), restored.model.parameters()):
    err = max(err, float((a - b).detach().abs().max()))
  if not err <= RESUME_TOL:
    raise AssertionError(f'{what} resume: max diff {err:.3e}, not '
                         f'bit-identical')
  return err


def _train_full_width(dev, tag, enh_cls, slice_launches,
                      model_name='HDRNetCurves', steps=TRAIN_STEPS,
                      keep=None):
  """The model and optimizer of scripts/ll/train_std.sh (HDRNetCurves) or
  train_gpyrnn.sh (HDRNetGaussianPyrNN): `steps` steps with one K3, K4
  and K5 a slice-apply (three a step for the pyramid), save, restore, one
  more step each way, evaluate the checkpoint through bin/evaluate.py's
  functions (training graph and serving path), serve it at 4K, and move
  it to `keep` (else remove it). Returns the timings; the K3/K4/K5
  launches go into slice_launches."""
  import shutil
  from hdrnet_torch.config import Config, DataConfig, ModelConfig, TrainConfig
  from hdrnet_torch.models import make_model
  from hdrnet_torch.ops import downsample, fused
  from hdrnet_torch.ops import slice_apply as sa
  from hdrnet_torch.training import loop, step
  per_step = 3 if model_name == PYR else 1
  cfg = Config(
      model=ModelConfig(model_name=model_name, net_input_size=256,
                        output_resolution=list(TRAIN_HW), luma_bins=8,
                        spatial_bin=16, channel_multiplier=1,
                        batch_norm=False),
      data=DataConfig(batch_size=1, output_resolution=list(TRAIN_HW)),
      train=TrainConfig(learning_rate=1e-4))

  def fresh(seed):
    model = make_model(cfg.model, generator=torch.Generator().manual_seed(
        seed)).to(dev)
    return step.create_state(model, loop.make_optimizer(model, cfg.train))

  host = _train_batches(4, cfg.model)
  train_step = step.make_train_step()
  state = fresh(1234)
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  sa.fwd_launches = sa.pix_bwd_launches = sa.grid_bwd_launches = 0
  losses, emas = [], []
  t0 = time.perf_counter()
  for i in range(steps):
    state, m = train_step(state, step.to_device(host[i % 4], dev))
    losses.append(m['loss'])
    emas.append(m['ema_loss'])
  torch.cuda.synchronize()
  first_s = time.perf_counter() - t0
  launches = {'K3': sa.fwd_launches, 'K4': sa.pix_bwd_launches,
              'K5': sa.grid_bwd_launches}
  peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
  n = steps * per_step
  if launches != {'K3': n, 'K4': n, 'K5': n}:
    raise AssertionError(f'launches over {steps} steps: {launches}')
  _tally_slice(slice_launches, n, n, n)
  losses = [float(x) for x in losses]
  ema = float(emas[-1])
  if not all(np.isfinite(losses)) or not ema < losses[0]:
    raise AssertionError(f'training: losses {losses}, ema {ema}')

  # Save, restore into a fresh state, one more step each way.
  ckpt_dir = 'build/chip_smoke_ckpt'
  resume_err = _check_resume(cfg, state, fresh, step.to_device(host[0], dev),
                             train_step, ckpt_dir, model_name)

  # Evaluate the checkpoint as bin/evaluate.py does, on the four batches:
  # the training graph (one K3 a slice-apply) and the serving path (one
  # K1, or three K6), counts reset just before each; the PSNRs agree.
  from hdrnet_torch.bin import evaluate
  from hdrnet_torch.training.checkpoint import latest_checkpoint, load
  weights = load(latest_checkpoint(ckpt_dir))['model']
  psnrs, eval_launches = {}, {}
  for serving in (False, True):
    fwd = evaluate.make_forward(cfg.model, weights, dev, serving)
    torch.cuda.synchronize()
    sa.fwd_launches = fused.launches = fused.nn_launches = 0
    psnrs[serving] = [evaluate.evaluate_batch(fwd, b, dev)[0] for b in host]
    torch.cuda.synchronize()
    eval_launches[serving] = (sa.fwd_launches, fused.launches,
                              fused.nn_launches)
  want = {False: (4 * per_step, 0, 0),
          True: (0, 0, 12) if model_name == PYR else (0, 4, 0)}
  if eval_launches != want:
    raise AssertionError(f'evaluate launches (K3, K1, K6) {eval_launches}; '
                         f'expected {want}')
  _tally_slice(slice_launches, eval_launches[False][0])
  eval_rel = max(abs(a - b) / abs(b) for a, b in zip(psnrs[True],
                                                     psnrs[False]))
  if not (np.isfinite(psnrs[False]).all() and eval_rel <= 1e-5):
    raise AssertionError(f'evaluate PSNRs: serving {psnrs[True]}, training '
                         f'graph {psnrs[False]}')

  # Serve the checkpoint: one K2, and one K1 (three K6 for the pyramid)
  # for a 4K frame.
  enh = enh_cls.from_checkpoint(ckpt_dir, device=dev)
  x = torch.rand((1, *UHD, 3), device=dev)
  downsample.launches = fused.launches = fused.nn_launches = 0
  out = enh.process(x)
  torch.cuda.synchronize()
  want = (1, 0, 3) if model_name == PYR else (1, 1, 0)
  if (downsample.launches, fused.launches, fused.nn_launches) != want:
    raise AssertionError(f'serving the checkpoint: launches K2 '
                         f'{downsample.launches}, K1 {fused.launches}, K6 '
                         f'{fused.nn_launches}; expected {want}')
  if out.shape != x.shape or not torch.isfinite(out).all():
    raise AssertionError('serving the checkpoint: output malformed')
  if keep is None:
    shutil.rmtree(ckpt_dir, ignore_errors=True)
  else:
    shutil.rmtree(keep, ignore_errors=True)
    os.makedirs(os.path.dirname(keep), exist_ok=True)
    shutil.move(ckpt_dir, keep)
  print(f'training {model_name} at full width (l8/s16/cm1, 256^2, 2048^2, '
        f'b=1, Adam 1e-4): {steps} steps, loss step 1 {losses[0]:.6f} -> '
        f'step {steps} {losses[-1]:.6f}, EMA {ema:.6f}; launches '
        f'{launches}; resume max diff {resume_err:.3e} (bit-identical under '
        f'cudnn.deterministic); bin/evaluate.py on 4 batches: PSNR '
        f'{np.mean(psnrs[False]):.4f} dB (training graph) vs '
        f'{np.mean(psnrs[True]):.4f} dB (serving), worst rel diff '
        f'{eval_rel:.2e} (<= 1e-5), launches (K3, K1, K6) {eval_launches}; '
        f'checkpoint served at 4K through '
        f'{"K2 + 3 K6" if model_name == PYR else "K2 + K1"}; '
        f'{steps / first_s:.2f} steps/s over the first {steps} (allocator '
        f'and cuDNN warm-up included); peak memory allocated '
        f'{peak_mib:.1f} MiB {tag}', flush=True)

  # Steady-state step rate and memory.
  batches = [step.to_device(b, dev) for b in host]
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  n = 20
  t0 = time.perf_counter()
  for i in range(n):
    state, m = train_step(state, batches[i % 4])
  torch.cuda.synchronize()
  step_ms = (time.perf_counter() - t0) * 1e3 / n
  steady_peak = torch.cuda.max_memory_allocated() / 2 ** 20
  return step_ms, peak_mib, steady_peak


def _nn_enhancer(enh_cls, name, dev, seed):
  """An Enhancer of an NN-guide model at the default widths (gc 16), with
  seeded weights and perturbed guide batch-norm statistics, so that the
  fold into the kernel's parameters is exercised."""
  from hdrnet_torch.config import ModelConfig
  from hdrnet_torch.models import make_model
  cfg = ModelConfig(model_name=name)
  state = make_model(cfg, generator=torch.Generator().manual_seed(
      seed)).state_dict()
  gen = torch.Generator().manual_seed(seed + 1)
  for k, v in state.items():
    if k.startswith('guide') and '.bn.' in k:
      if k.endswith('running_var'):
        state[k] = 0.5 + 1.5 * torch.rand(v.shape, generator=gen)
      else:
        state[k] = 0.1 * torch.randn(v.shape, generator=gen)
  return enh_cls(cfg, state, device=dev, seed=seed)


@contextlib.contextmanager
def _plain_serving(full_float32):
  """Inside the block the Enhancer's entry points and bin/run.py's
  per-image function run the plain versions of K2 and K1/K6/K7 (in full
  float32), for comparison only."""
  import hdrnet_torch.inference as inference
  from hdrnet_torch.bin import run
  from hdrnet_torch.ops import downsample, fused

  def plain(*args, **kw):
    with full_float32():
      return fused.enhance_fused_plain(*args, **kw)

  saved = (inference.enhance_fused, inference.nearest_lowres,
           run.nearest_lowres)
  inference.enhance_fused = plain
  inference.nearest_lowres = downsample.nearest_lowres_plain
  run.nearest_lowres = downsample.nearest_lowres_plain
  try:
    yield
  finally:
    (inference.enhance_fused, inference.nearest_lowres,
     run.nearest_lowres) = saved


def _check_k7(cases, x, x8, full_float32):
  """K7 at 4K, for each (grid, u8 grid, params, mode): the four H-bands
  and a band with a column offset against the plain version with the
  same offsets (K1_TOL), the bands against the whole-frame kernel (bit
  for bit), and one u8 -> u8 band (1 code on < 1%, and bit for bit
  against the whole frame). Returns the max error and the u8 stats."""
  from hdrnet_torch.ops import fused
  h, w = x.shape[1:3]
  hl = h // 4
  err, u8_stats = 0.0, []

  def plain(*args, **kw):
    with full_float32():
      return fused.enhance_fused_plain(*args, **kw)

  def same(got, want, what):
    diff = float((got.float() - want.float()).abs().max())
    if diff != 0.0:
      raise AssertionError(f'{what}: {diff} from the whole-frame kernel')

  for grid, grid8, params, mode in cases:
    whole = fused.enhance_fused(grid, x, params, mode, clip_output=True)
    bands = []
    for i in range(4):
      band = x[:, i * hl:(i + 1) * hl]
      kw = dict(clip_output=True, y_offset=i * hl, h_total=h)
      got = fused.enhance_fused(grid, band, params, mode, **kw)
      err = max(err, _max_err(got, plain(grid, band, params, mode, **kw),
                              K1_TOL, f'K7 {mode} band {i}'))
      bands.append(got)
    same(torch.cat(bands, 1), whole, f'K7 {mode} four bands')
    y0, x0, cw = h // 3, 2 * w // 5, w // 4
    tile = x[:, y0:y0 + hl, x0:x0 + cw].contiguous()
    kw = dict(clip_output=True, y_offset=y0, x_offset=x0, h_total=h,
              w_total=w)
    got = fused.enhance_fused(grid, tile, params, mode, **kw)
    err = max(err, _max_err(got, plain(grid, tile, params, mode, **kw),
                            K1_TOL, f'K7 {mode} tile'))
    same(got, whole[:, y0:y0 + hl, x0:x0 + cw], f'K7 {mode} tile')
    band8 = x8[:, hl:2 * hl]
    kw = dict(clip_output=True, u8_output=True, y_offset=hl, h_total=h)
    got = fused.enhance_fused(grid8, band8, params, mode, **kw)
    u8_stats.append(_u8_check(got, plain(grid8, band8, params, mode, **kw),
                              f'K7 {mode} u8 band'))
    whole8 = fused.enhance_fused(grid8, x8, params, mode, clip_output=True,
                                 u8_output=True)
    same(got, whole8[:, hl:2 * hl], f'K7 {mode} u8 band')
  torch.cuda.synchronize()
  print(f'K7 enhance_fused bands: max abs err {err:.3e} (<= {K1_TOL:.0e}) '
        f'vs plain at 4K f32, curves and NN gc 16, four {hl}-row H-bands '
        f'and a {hl}x{cw} tile at ({y0}, {x0}); bands and tile equal the '
        f'whole-frame kernel bit for bit; u8 band (max codes, share '
        f'differing) {u8_stats}, bit for bit against the whole frame',
        flush=True)
  return err

# bf16 tensor-core rate (H100 SXM data sheet at 700 W), for K2x's
# one-hot products; a wgmma m64n8k16 is 2 * 64 * 8 * 16 operations.
BF16_OPS_PER_S = 989e12
WGMMA_OPS = 2 * 64 * 8 * 16


def _k2x_work(b, h, w, s, rows):
  """(bytes, bf16 operations) of K2x as csrc/downsample_onehot.cu runs
  it: units of (plane, output rows, 64 source columns), a chunk no output
  samples skipped; v1 reads a unit's 64 sampled rows of its chunk and
  runs one m64n8k16 a part, K-step and 8 output columns; v2 reads the
  slab iy[first] .. iy[last] of its 8 output rows, one m64n8k16 a part and
  K-step of the slab (in stages of 64 rows), then one a part, K-step and
  64 output columns for the column product."""
  from hdrnet_torch.ops.resize import _nearest_indices
  iy, ix = _nearest_indices(h, s), _nearest_indices(w, s)
  chunks = []
  for c0 in range(0, w, 64):
    lo, hi = np.searchsorted(ix, [c0, c0 + 64])
    if hi > lo:
      cols = min(64, w - c0)
      chunks.append((cols, -(-cols // 16), int(hi - lo)))
  planes = 3 * b
  n_bytes = planes * s * s * 4
  ops = 0
  if rows == 'gather':
    for t in range(0, s, 64):
      n = min(64, s - t)
      for cols, steps, outs in chunks:
        n_bytes += planes * n * cols * 4
        ops += planes * -(-outs // 8) * steps * 3
  else:
    for t in range(0, s, 8):
      slab = int(iy[min(t + 8, s) - 1]) - int(iy[t]) + 1
      row_steps = sum(-(-min(64, slab - r) // 16) for r in range(0, slab, 64))
      for cols, steps, outs in chunks:
        n_bytes += planes * slab * cols * 4
        ops += planes * (row_steps + -(-outs // 64) * steps) * 3
  return n_bytes, ops * WGMMA_OPS


def _check_k2x(dev, tag):
  """K2x's main path, the port's downsample experiment (counts reset just
  before, read just after); both row modes at 4K b=1 and b=4 f32 bit for
  bit against their plain versions and K2; then each timed in CUDA graphs
  in turns with K2, beside one aten::index call of the same function.
  Returns (launches, max error, timings, the function's bound by batch,
  the formulations' floors by (batch, rows))."""
  from hdrnet_torch.ops import downsample
  from hdrnet_torch.scripts import exp_downsample_v2
  from hdrnet_torch.scripts.time_kernels import k2x_library
  from hdrnet_torch.utils.timing import graph_ms
  torch.cuda.synchronize()
  downsample.onehot_launches = 0
  results = exp_downsample_v2.main([])
  torch.cuda.synchronize()
  launches = downsample.onehot_launches
  if launches < 2 or any(r['max_diff'] != 0.0 for r in results):
    raise AssertionError(f'K2x experiment: {launches} launches, {results}')
  gen = torch.Generator(device=dev).manual_seed(77)
  times, err = {}, 0.0
  for b in (1, 4):
    cf = torch.rand((b, 3, *UHD), generator=gen, device=dev)
    nhwc = cf.permute(0, 2, 3, 1).contiguous()
    k2 = downsample.nearest_lowres(nhwc, 256)
    for rows in ('gather', 'mma'):
      got = downsample.nearest_lowres_onehot(cf, 256, rows)
      want = downsample.nearest_lowres_onehot_plain(cf, 256, rows)
      diffs = (float((got - want).abs().max()), float((got - k2).abs().max()))
      err = max(err, *diffs)
      if not (torch.equal(got, want) and torch.equal(got, k2)):
        raise AssertionError(f'K2x {rows} b={b}: max diff plain {diffs[0]}, '
                             f'K2 {diffs[1]}')
    v1 = lambda: downsample.nearest_lowres_onehot(cf, 256, 'gather')
    v2 = lambda: downsample.nearest_lowres_onehot(cf, 256, 'mma')
    k2_fn = lambda: downsample.nearest_lowres(nhwc, 256)
    turns = [graph_ms(f) for f in (k2_fn, v1, v2, v2, v1, k2_fn)]
    plain = [_time_ms(lambda r=r: downsample.nearest_lowres_onehot_plain(
        cf, 256, r), 5, warmup=1) for r in ('gather', 'mma')]
    if not torch.equal(k2x_library(cf, 256), k2):
      raise AssertionError(f'K2x b={b}: the aten::index call disagrees')
    times[b] = {'K2': (turns[0] + turns[5]) / 2,
                'gather': (turns[1] + turns[4]) / 2,
                'mma': (turns[2] + turns[3]) / 2,
                'plain_gather': plain[0], 'plain_mma': plain[1],
                'library': graph_ms(lambda: k2x_library(cf, 256)),
                'turns': turns}
    del cf, nhwc
  # The copy route for rows that are not 16-byte aligned (301 floats), and
  # the bulk route's masks (s < 64, ragged chunks), at small sizes.
  for b, h, w, s in ((2, 77, 301, 40), (2, 77, 300, 40), (1, 135, 241, 64)):
    cf = torch.rand((b, 3, h, w), generator=gen, device=dev)
    k2 = downsample.nearest_lowres(cf.permute(0, 2, 3, 1).contiguous(), s)
    for rows in ('gather', 'mma'):
      got = downsample.nearest_lowres_onehot(cf, s, rows)
      if not (torch.equal(got, downsample.nearest_lowres_onehot_plain(
          cf, s, rows)) and torch.equal(got, k2)):
        raise AssertionError(f'K2x {rows} b={b} {h}x{w} -> {s}: not bit for '
                             f'bit its plain version and K2')
  torch.cuda.synchronize()
  fn_bound = {b: _bound(b * 3 * 256 * 256 * (4 + 4) + 2 * 256 * 4, 0)[0]
              for b in (1, 4)}
  floors = {(b, r): _bound(*_k2x_work(b, *UHD, 256, r), BF16_OPS_PER_S)
            for b in (1, 4) for r in ('gather', 'mma')}
  print(f'K2x nearest_lowres_onehot (tensor-core one-hot products): the '
        f'experiment script ran {launches} K2x launches, max|diff| 0 for '
        f'v0/v1/v2; rows gather and mma bit-identical to their plain '
        f'versions and to K2 at 4K b=1 and b=4 f32 (max|diff| {err}) and '
        f'on both copy routes at 77x300, 77x301 -> 40 and 135x241 -> 64; '
        f'timing {tag} ms a call in CUDA graphs, '
        f'in turns K2 / v1 / v2 / v2 / v1 / K2: '
        + '; '.join(f'b={b} ' + ' / '.join(f'{t:.4f}' for t in
                                           times[b]['turns'])
                    for b in (1, 4))
        + '; one aten::index call '
        + ', '.join(f'b={b} {times[b]["library"]:.4f}' for b in (1, 4))
        + '; plain v1 / v2 '
        + '; '.join(f'b={b} {times[b]["plain_gather"]:.4f} / '
                    f'{times[b]["plain_mma"]:.4f}' for b in (1, 4))
        + '; bound of the function (K2\'s work) '
        + ', '.join(f'b={b} {fn_bound[b]:.5f}' for b in (1, 4))
        + ' ms; floors of the formulations '
        + ', '.join(f'{r} b={b} {floors[b, r][0]:.5f} ({floors[b, r][1]})'
                    for b in (1, 4) for r in ('gather', 'mma')) + ' ms',
        flush=True)
  return launches, err, times, fn_bound, floors


def _seeded_checkpoint(directory, model_name, seed, **widths):
  """A seeded model at the default widths (or `widths`) saved as training
  saves it."""
  import shutil
  from hdrnet_torch.config import Config, ModelConfig, TrainConfig
  from hdrnet_torch.models import make_model
  from hdrnet_torch.training import loop, step
  from hdrnet_torch.training.checkpoint import Checkpointer
  shutil.rmtree(directory, ignore_errors=True)
  cfg = Config(model=ModelConfig(model_name=model_name, **widths),
               train=TrainConfig())
  model = make_model(cfg.model, generator=torch.Generator().manual_seed(seed))
  cfg.save(directory)
  Checkpointer(directory).save(0, step.create_state(
      model, loop.make_optimizer(model, cfg.train)))


def _check_export(dev, tag, gen, slice_launches):
  """bin/export.py's main on a seeded HDRNetCurves and a seeded
  HDRNetGaussianPyrNN checkpoint at --fullres 1080 1920: every .pt2
  reloads and equals the eager Enhancer bit for bit, serve_any_fn at two
  other sizes too; the kernels' counters rise in the reloaded runs. Then
  one registered-op call against one direct call, host time."""
  import shutil
  from hdrnet_torch.bin import export
  from hdrnet_torch.inference import Enhancer, full_float32
  from hdrnet_torch.ops import downsample, fused
  from hdrnet_torch.ops import slice_apply as sa
  lines = []
  for seed, name in enumerate(('HDRNetCurves', PYR)):
    ckpt = f'build/chip_smoke_export_{name}'
    _seeded_checkpoint(ckpt, name, seed + 21)
    t0 = time.perf_counter()
    programs = export.main([ckpt, '--fullres', *map(str, FHD)])
    export_s = time.perf_counter() - t0
    enh = Enhancer.from_checkpoint(ckpt, device=dev)
    low = torch.rand((1, 256, 256, 3), generator=gen, device=dev)
    full = torch.rand((1, *FHD, 3), generator=gen, device=dev)
    full8 = (full * 255).to(torch.uint8)
    others = [torch.rand((1, *hw, 3), generator=gen, device=dev)
              for hw in ((723, 1085), UHD)]
    with torch.no_grad(), full_float32():
      grid = enh._backbone_grid(low.permute(0, 3, 1, 2))
      b, gh, gw, gd, no, ni = grid.shape
      calls = [
          ('coefficients_fn', (low,),
           grid.reshape(b, gh, gw, gd, no * ni)[0].permute(3, 2, 0, 1)),
          ('enhance_fn', (low, full), torch.clamp(enh.model(low, full), 0,
                                                  1)),
          ('serve_fn', (low, full), enh(low, full)),
          ('stream_fn', (full8,), enh.make_stream_fn(full8.shape)(full8)),
          ('serve_any_fn', (low, full), enh(low, full))]
      calls += [('serve_any_fn', (low, x), enh(low, x)) for x in others]
    torch.cuda.synchronize()
    downsample.launches = fused.launches = fused.nn_launches = 0
    sa.fwd_launches = 0
    for fn_name, args, want in calls:
      got = export.load_artifact(f'{ckpt}/{fn_name}.pt2')(*args)
      if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f'{name} {fn_name} {tuple(args[-1].shape)}: '
                             f'not bit-identical to the eager Enhancer')
    torch.cuda.synchronize()
    counts = {'K2': downsample.launches, 'K1': fused.launches,
              'K6': fused.nn_launches, 'K3': sa.fwd_launches}
    fused_per = 3 if name == PYR else 1
    expect = {'K2': 1, 'K1': 0 if name == PYR else 5,
              'K6': 5 * fused_per if name == PYR else 0,
              'K3': fused_per}
    if counts != expect:
      raise AssertionError(f'{name} reloaded graphs launched {counts}; '
                           f'expected {expect}')
    _tally_slice(slice_launches, counts['K3'])
    ops = {k: export.hdrnet_ops(p) for k, p in programs.items()}
    lines.append(f'{name}: 5 artifacts in {export_s:.1f} s, graphs call '
                 f'{json.dumps(ops)}; reloaded runs bit-identical (serve_any '
                 f'also at 723x1085 and 2160x3840), launches {counts}')
    del enh, calls, others
    shutil.rmtree(ckpt, ignore_errors=True)
  # One registered call against one direct call, host time a call, on K2
  # at 4K (its kernel is shorter than either call), in turns.
  x = torch.rand((1, *UHD, 3), generator=gen, device=dev)
  direct = lambda: downsample.nearest_lowres(x, 256)
  registered = lambda: torch.ops.hdrnet.nearest_lowres(x, 256)
  turns = [_host_us(f) for f in (direct, registered, registered, direct)]
  print(f'export (bin/export.py main, --fullres 1080 1920, seeded default '
        f'widths): ' + '; '.join(lines) + f'; timing {tag}: K2 through '
        f'hdrnet::nearest_lowres vs the direct call, host us a call in '
        f'turns direct / op / op / direct '
        f'{" / ".join(f"{t:.2f}" for t in turns)}', flush=True)
  return turns


NATIVE_DIR = 'build/chip_smoke_native'
NATIVE_BURN, NATIVE_ITERS = 3, 20
NATIVE_TIMEOUT_S = 300
# The op library's counters (hdrnet_ops.cc, resize_op.cc) by kernel; the
# bilinear resize is no kernel.
NATIVE_KERNELS = {'nearest_lowres': 'K2', 'enhance_fused_curves': 'K1',
                  'enhance_fused_nn': 'K6', 'slice_apply_fwd': 'K3',
                  'resize_bilinear': 'resize'}
# The sizes one serve_any_fn package serves: odd extents, and 4K.
NATIVE_ANY_SIZES = ((723, 1085), UHD)


def _graph_op_calls(program):
  """The op library's calls a run of `program`: its graph's hdrnet:: nodes
  counted by op, enhance_fused by its guide mode (the library's
  counters)."""
  calls = {}
  for node in program.graph.nodes:
    target = str(node.target)
    if node.op != 'call_function' or not target.startswith('hdrnet.'):
      continue
    op = target.split('.')[1]
    if op == 'enhance_fused':
      op = f'enhance_fused_{node.args[3]}'
    calls[op] = calls.get(op, 0) + 1
  return calls


def _write_inputs(prefix, tensors):
  """Each tensor as a raw file `prefix`.in<i>.bin; their paths."""
  paths = []
  for i, x in enumerate(tensors):
    paths.append(f'{prefix}.in{i}.bin')
    x.cpu().numpy().tofile(paths[-1])
  return paths


def _native_run(package, inputs, out_path, what, dims=None):
  """Runs the native runner on `package` with the op library, the inputs
  raw files and `dims` its --dim bindings; returns its report. Raises on a
  non-zero exit."""
  from hdrnet_torch import native
  cmd = native.serve_command(package, dims=dims, inputs=inputs,
                             output=out_path, burn=NATIVE_BURN,
                             iters=NATIVE_ITERS)
  proc = subprocess.run(cmd, capture_output=True, text=True,
                        timeout=NATIVE_TIMEOUT_S, check=False)
  if proc.returncode:
    raise AssertionError(f'aoti_serve {what}: exit {proc.returncode}: '
                         f'{proc.stderr[-2000:]}')
  return json.loads(proc.stdout.strip().splitlines()[-1])


def _native_serving(dev, tag):
  """The native deployment path (hdrnet_torch/native): the op library and
  the runner built; seeded checkpoints at the default widths exported at
  1080p with --aoti: HDRNetCurves by bin/export.py's main (coefficients_fn,
  enhance_fn, serve_fn, stream_fn and serve_any_fn, H and W dynamic),
  HDRNetPointwiseNNGuide's serve_fn, HDRNetGaussianPyrNN's enhance_fn,
  serve_fn, stream_fn and serve_any_fn, and train_fpyrnn3_cm2.sh's
  HDRNetFeaturesPyrNN3 (cm 2) stream_fn, by export_function. Each package
  served by aoti_serve in a subprocess (no Python in it) on seeded inputs,
  the two serve_any_fn packages at 723x1085 and 2160x3840 (--dim), and held
  to the eager Enhancer (float32 within K1_TOL, uint8 within one code on
  fewer than 1% of values; Inductor may order the glue around the kernels
  another way); the op library's calls checked against the graph's own
  hdrnet:: nodes times the runs (hdrnet::resize_bilinear included); the
  pyramid's package without the op library refused naming the resize; the
  runner's forward against the Python load_artifact graph in turns for
  the serve_fn and serve_any_fn cases. Returns {kernel id: launches in the
  runner}."""
  import shutil
  from hdrnet_torch import native
  from hdrnet_torch.bin import export
  from hdrnet_torch.inference import Enhancer, full_float32
  phase_t0 = time.perf_counter()
  t0 = time.perf_counter()
  built = native.build()
  print(f'native build: op library {built[native.OPS_LIBRARY].seconds:.1f} '
        f's, runner {built[native.RUNNER].seconds:.1f} s (g++, together; '
        f'{time.perf_counter() - t0:.1f} s with the kernels\' library)',
        flush=True)
  shutil.rmtree(NATIVE_DIR, ignore_errors=True)
  curves_dir = f'{NATIVE_DIR}/HDRNetCurves'
  _seeded_checkpoint(curves_dir, 'HDRNetCurves', 31)
  t0 = time.perf_counter()
  programs = {('HDRNetCurves', k): p for k, p in export.main(
      [curves_dir, '--fullres', *map(str, FHD), '--aoti']).items()}
  export_s = {'HDRNetCurves': time.perf_counter() - t0}
  enhancers = {'HDRNetCurves': Enhancer.from_checkpoint(curves_dir,
                                                        device=dev)}
  for model, seed, names, widths in (
      (NN, 32, ('serve_fn',), {}),
      (PYR, 33, ('enhance_fn', 'serve_fn', 'stream_fn', 'serve_any_fn'), {}),
      (FPYR, 34, ('stream_fn',), {'channel_multiplier': 2})):
    directory = f'{NATIVE_DIR}/{model}'
    _seeded_checkpoint(directory, model, seed, **widths)
    enh = enhancers[model] = Enhancer.from_checkpoint(directory, device=dev)
    fns = export.serving_functions(enh, FHD)
    t0 = time.perf_counter()
    for name in names:
      fn, example, dynamic = fns[name]
      programs[model, name] = export.export_function(
          enh, name, fn, example, dynamic, directory, aoti=True)
    export_s[model] = time.perf_counter() - t0

  rng = np.random.RandomState(11)
  low = torch.from_numpy(rng.rand(1, 256, 256, 3).astype(np.float32)).to(dev)
  full = torch.from_numpy(rng.rand(1, *FHD, 3).astype(np.float32)).to(dev)
  full8 = torch.from_numpy(
      rng.randint(0, 256, (1, *FHD, 3)).astype(np.uint8)).to(dev)
  anys = [torch.from_numpy(rng.rand(1, *hw, 3).astype(np.float32)).to(dev)
          for hw in NATIVE_ANY_SIZES]
  curves, pyr = enhancers['HDRNetCurves'], enhancers[PYR]
  # (model, function, inputs, eager output, --dim bindings, timed in turns)
  with torch.no_grad(), full_float32():
    cases = [
        ('HDRNetCurves', 'coefficients_fn', (low,),
         export.coefficients_function(curves)(low), None, False),
        ('HDRNetCurves', 'enhance_fn', (low, full),
         curves._composite_forward(low, full, clip=True), None, False),
        ('HDRNetCurves', 'serve_fn', (low, full), curves(low, full), None,
         True),
        ('HDRNetCurves', 'stream_fn', (full8,),
         curves.make_stream_fn(full8.shape)(full8), None, False),
        (NN, 'serve_fn', (low, full), enhancers[NN](low, full), None, False),
        (PYR, 'enhance_fn', (low, full),
         pyr._composite_forward(low, full, clip=True), None, False),
        (PYR, 'serve_fn', (low, full), pyr(low, full), None, True),
        (PYR, 'stream_fn', (full8,), pyr.make_stream_fn(full8.shape)(full8),
         None, False),
        (FPYR, 'stream_fn', (full8,),
         enhancers[FPYR].make_stream_fn(full8.shape)(full8), None, False)]
    cases += [(model, 'serve_any_fn', (low, x), enhancers[model](low, x),
               {'H': x.shape[1], 'W': x.shape[2]}, True)
              for model in ('HDRNetCurves', PYR) for x in anys]
  torch.cuda.synchronize()
  runs = NATIVE_BURN + NATIVE_ITERS
  launches = {k: 0 for k in NATIVE_KERNELS.values()}
  lines, timed = [], []
  for i, (model, name, args, want, dims, turns) in enumerate(cases):
    directory = f'{NATIVE_DIR}/{model}'
    package = f'{directory}/{name}.aoti.pt2'
    out_path = f'{directory}/{name}.{i}.out.bin'
    what = f'{model} {name} {"x".join(map(str, args[-1].shape[1:3]))}'
    inputs = _write_inputs(f'{directory}/{name}.{i}', args)
    report = _native_run(package, inputs, out_path, what, dims)
    if report['shapes'] != {'inputs': [list(a.shape) for a in args],
                            'output': list(want.shape)}:
      raise AssertionError(f'aoti_serve {what}: served {report["shapes"]}')
    got = torch.from_numpy(np.fromfile(out_path, dtype=np.uint8 if
                                       want.dtype == torch.uint8 else
                                       np.float32).reshape(want.shape))
    want = want.cpu()
    if want.dtype == torch.uint8:
      worst, share = _u8_check(got, want, f'aoti_serve {what}')
      err = f'u8 max {worst} codes, {int((got != want).sum())} values differ '
      err += f'({share:.4%})'
    else:
      err = f'max abs err {_max_err(got, want, K1_TOL, what):.3e}'
    calls = report['hdrnet_op_calls']
    per_run = _graph_op_calls(programs[model, name])
    expect = {k: per_run.get(k, 0) * runs for k in NATIVE_KERNELS}
    if calls != expect:
      raise AssertionError(f'aoti_serve {what}: op calls {calls}; expected '
                           f'{expect} (the graph\'s {per_run} a run)')
    for k, n in calls.items():
      launches[NATIVE_KERNELS[k]] += n
    if turns:
      timed.append((what, f'{directory}/{name}.pt2', args, package, inputs,
                    dims))
    lines.append(f'{what}: {err} vs the eager Enhancer, op calls '
                 f'{ {k: v for k, v in calls.items() if v} }, load '
                 f'{report["compile_ms"]:.1f} ms, upload '
                 f'{report["upload_ms"]:.3f} ms, forward '
                 f'{report["forward_ms_per_iter"]:.4f} ms a run, readback '
                 f'{report["readback_ms"]:.3f} ms')
  del cases, got, want
  # No fallback: the pyramid's package without the op library is refused,
  # naming the first op it calls.
  bare = subprocess.run([str(native.runner().path),
                         f'{NATIVE_DIR}/{PYR}/serve_fn.aoti.pt2'],
                        capture_output=True, text=True,
                        timeout=NATIVE_TIMEOUT_S, check=False)
  if bare.returncode != 1 or ('calls the op hdrnet::resize_bilinear'
                              not in bare.stderr):
    raise AssertionError(f'{PYR} serve_fn without the op library: exit '
                         f'{bare.returncode}: {bare.stderr[-2000:]}')
  print(f'native serving (bin/export.py --aoti at 1080x1920, seeded default '
        f'widths, fpyrnn3 cm 2; export s {json.dumps(export_s)}; aoti_serve '
        f'with libhdrnet_ops.so, burn {NATIVE_BURN}, {NATIVE_ITERS} runs): '
        + '; '.join(lines) + f'; launches in the runner {launches}; the '
        f'pyramid\'s serve_fn without the op library exits 1 naming '
        f'hdrnet::resize_bilinear', flush=True)

  # The runner's forward in turns with the Python artifact's, each by the
  # host clock over NATIVE_ITERS runs ended by a synchronize.
  timings = {}
  for what, pt2, args, package, inputs, dims in timed:
    served = export.load_artifact(pt2)

    def python_ms():
      for _ in range(NATIVE_BURN):
        served(*args)
      torch.cuda.synchronize()
      t = time.perf_counter()
      for _ in range(NATIVE_ITERS):
        served(*args)
      torch.cuda.synchronize()
      return (time.perf_counter() - t) * 1e3 / NATIVE_ITERS

    def runner_ms():
      return _native_run(package, inputs, f'{package}.turn.bin',
                         f'{what} turn', dims)['forward_ms_per_iter']

    timings[what] = [python_ms(), runner_ms(), runner_ms(), python_ms()]
    del served
  print(f'timing {tag}: ms a run in turns Python load_artifact / aoti_serve '
        f'/ aoti_serve / Python (host clock over {NATIVE_ITERS} runs, '
        f'synchronized): ' + '; '.join(
            f'{what} {" / ".join(f"{t:.4f}" for t in ts)}'
            for what, ts in timings.items())
        + f'; the native phase took {time.perf_counter() - phase_t0:.1f} s',
        flush=True)
  del enhancers, low, full, full8, anys
  shutil.rmtree(NATIVE_DIR, ignore_errors=True)
  return launches


TRIAGE_DIR = 'build/chip_smoke_triage'
TRIAGE_LIMIT = 2
TRIAGE_PSNR_REL = 1e-5  # as evaluate's serving path against its graph


def _hold_triage(got, want, tol, where):
  """Holds two triage records to each other: integers and strings exactly,
  each float within tol(key, value)."""
  if sorted(got) != sorted(want):
    raise AssertionError(f'{where}: fields {sorted(got)} vs {sorted(want)}')
  for key, w in want.items():
    g = got[key]
    if isinstance(w, list):
      for i, (gi, wi) in enumerate(zip(g, w, strict=True)):
        _hold_triage(gi, wi, tol, f'{where}.{key}[{i}]')
    elif isinstance(w, dict):
      _hold_triage(g, w, tol, f'{where}.{key}')
    elif isinstance(w, float):
      if not abs(g - w) <= tol(key, w):
        raise AssertionError(f'{where}.{key}: card {g} vs CPU {w} (tol '
                             f'{tol(key, w)})')
    elif key != 'checkpoint' and g != w:
      raise AssertionError(f'{where}.{key}: card {g} vs CPU {w}')


def _psnrs(record):
  """Every PSNR value (not a drop) in a triage report."""
  if isinstance(record, list):
    return [v for r in record for v in _psnrs(r)]
  if isinstance(record, dict):
    return [v for k, r in record.items()
            for v in ([r] if 'psnr' in k and 'drop' not in k and
                      isinstance(r, float) else _psnrs(r))]
  return []


def _triage_tol(cpu_report):
  """tol(key, value) of the card's triage floats against `cpu_report`'s:
  the guides' statistics (torch ops on both) within one rounding step of
  guide_stats (4 decimals; 2 for the range in bins) plus 1e-5,
  diagnose_pyramid's unrounded ones within 1e-5; a level's output RMS (K3
  against its plain version) within K1_TOL; a PSNR within
  TRIAGE_PSNR_REL of itself, a drop (the difference of two PSNRs) within
  that of the report's largest PSNR twice."""
  largest = max(map(abs, _psnrs(cpu_report)), default=0.0)

  def tol(key, value):
    if key in ('p01', 'p99', 'std'):
      return 1e-4 + 1e-5
    if key == 'effective_range_bins':
      return 1e-2 + 1e-5
    if key == 'out_rms':
      return K1_TOL
    if 'drop' in key:
      return 2 * TRIAGE_PSNR_REL * largest
    if 'psnr' in key:
      return TRIAGE_PSNR_REL * abs(value)
    return 1e-5
  return tol


def _triage_tools(dev, tag, pyr_ckpt, data, slice_launches):
  """The quality-triage tools (M10) on the card: hdrnet_torch.scripts.
  guide_stats and diagnose_pyramid on the 2048^2 pyramid checkpoint of
  the training phase, over two images of the quality set (--limit 2; its
  data config set to the set's 1024^2, since the eval pipeline crops each
  image to it), their K3 launches counted (3 a forward; diagnose_pyramid
  18 an image: the forward, the reconstruction, each level's output and
  the three ablations); then both with --device cpu, held to the card's
  (_triage_tol)."""
  import shutil
  from hdrnet_torch.config import Config
  from hdrnet_torch.ops import slice_apply as sa
  from hdrnet_torch.scripts import diagnose_pyramid, guide_stats
  cfg = Config.load(pyr_ckpt)
  cfg.data.output_resolution = [QUALITY_SIZE, QUALITY_SIZE]
  cfg.save(pyr_ckpt)
  reports, seconds = {}, {}
  for device in ('cuda', 'cpu'):
    for tool in (guide_stats, diagnose_pyramid):
      name = tool.__name__.rsplit('.', 1)[1]
      if device == 'cuda':
        torch.cuda.synchronize()
        sa.fwd_launches = 0
      t0 = time.perf_counter()
      # The tools' own per-image lines and summary go to a log file.
      with open(f'{TRIAGE_DIR}/{name}.log', 'a') as log, \
          contextlib.redirect_stdout(log):
        reports[device, name] = tool.main(
            [pyr_ckpt, data, '--limit', str(TRIAGE_LIMIT), '--device',
             device, '--json', f'{TRIAGE_DIR}/{name}.{device}.json'])
      seconds[f'{name} {device}'] = round(time.perf_counter() - t0, 2)
      if device == 'cuda':
        torch.cuda.synchronize()
        want = TRIAGE_LIMIT * (18 if name == 'diagnose_pyramid' else 3)
        if sa.fwd_launches != want:
          raise AssertionError(f'{name} on the card: {sa.fwd_launches} K3 '
                               f'launches; expected {want}')
        _tally_slice(slice_launches, want)
  for name in ('guide_stats', 'diagnose_pyramid'):
    _hold_triage(reports['cuda', name], reports['cpu', name],
                 _triage_tol(reports['cpu', name]), name)
  stats = reports['cuda', 'guide_stats']
  diag = reports['cuda', 'diagnose_pyramid']['summary']
  print(f'triage tools ({PYR} checkpoint of the 2048^2 phase, step '
        f'{stats["step"]}, {TRIAGE_LIMIT} quality-set images at '
        f'{QUALITY_SIZE}^2): guide_stats {json.dumps(stats["guides"])}; '
        f'diagnose_pyramid mean PSNR {diag["mean_psnr"]:.4f} dB, levels '
        f'{json.dumps(diag["levels"])}; the card\'s reports held to '
        f'--device cpu (integers exact, guides one rounding step + 1e-5, '
        f'RMS {K1_TOL:.0e}, PSNR {TRIAGE_PSNR_REL:.0e} rel); seconds '
        f'{json.dumps(seconds)} {tag}', flush=True)
  shutil.rmtree(TRIAGE_DIR, ignore_errors=True)


def _fit_grads(fit_grid, pair, where):
  """The first step's gradients of the curves-guide fit computed on
  `where`, by leaf ('grid', then the guide's parameters), copied to the
  CPU."""
  from hdrnet_torch.inference import full_float32
  grid, gmod, loss_fn = fit_grid.fit_problem(*pair, guide='curves',
                                             device=where)
  with full_float32():
    loss_fn().backward()
  leaves = [('grid', grid)] + list(gmod.named_parameters())
  return {k: p.grad.detach().cpu() for k, p in leaves}


def _check_fit_grid(dev, tag, slice_launches):
  """bin/fit_grid.py's fit_pair on the card: 50 steps with the curves
  guide on a seeded 1024^2 pair (PSNR above identity, K3/K4/K5 launched,
  ms a step). At 256^2, the card against the CPU: the first step's
  gradients with the curves guide (the grid's through K3 and K5, the
  guide's through K4) within 1e-4 of each leaf's max |g|, and the entries
  of another sign counted; 20 steps with the luma guide, PSNRs within
  1e-3 dB. The curves fits drift apart over the steps; beside that drift
  the phase prints how far the CPU's own fit moves when the guide's
  initial parameters move by one float32 ulp."""
  from hdrnet_torch.bin import fit_grid
  from hdrnet_torch.models.guides import CurveGuide
  from hdrnet_torch.ops import slice_apply as sa
  rng = np.random.RandomState(31)

  def pair(n):
    inp = rng.rand(n, n, 3).astype(np.float32)
    return inp, np.clip(1.1 * inp ** 0.7, 0.0, 1.0).astype(np.float32)

  inp, tgt = pair(1024)
  identity = fit_grid.psnr_of(((inp - tgt) ** 2).mean())
  fit_grid.fit_pair(inp, tgt, steps=2, guide='curves', device=dev)  # warm
  torch.cuda.synchronize()
  sa.fwd_launches = sa.pix_bwd_launches = sa.grid_bwd_launches = 0
  t0 = time.perf_counter()
  psnr, _ = fit_grid.fit_pair(inp, tgt, steps=50, guide='curves', device=dev)
  torch.cuda.synchronize()
  step_ms = (time.perf_counter() - t0) * 1e3 / 50
  counts = (sa.fwd_launches, sa.pix_bwd_launches, sa.grid_bwd_launches)
  if counts != (51, 50, 50) or not psnr > identity:
    raise AssertionError(f'fit_grid 1024^2: launches (K3, K4, K5) {counts}, '
                         f'PSNR {psnr} vs identity {identity}')
  _tally_slice(slice_launches, *counts)
  small = pair(256)
  sa.fwd_launches = sa.pix_bwd_launches = sa.grid_bwd_launches = 0
  card, cpu = (_fit_grads(fit_grid, small, w) for w in (dev, 'cpu'))
  counts_256 = (sa.fwd_launches, sa.pix_bwd_launches, sa.grid_bwd_launches)
  if counts_256 != (1, 1, 1):
    raise AssertionError(f'fit_grid gradients: launches (K3, K4, K5) '
                         f'{counts_256} on the card')
  _tally_slice(slice_launches, *counts_256)
  grad_err, flips = {}, {}
  for k in card:
    want, got = cpu[k], card[k]
    grad_err[k] = float((got - want).abs().max() / want.abs().max())
    flips[k] = int((torch.sign(got) != torch.sign(want)).sum())
  init = {k: v.numpy() for k, v in CurveGuide(
      generator=torch.Generator().manual_seed(0)).state_dict().items()}
  ulp = {k: np.nextafter(v, np.float32(np.inf)) for k, v in init.items()}
  runs = {('luma', 20, 'card'): (dev, None),
          ('luma', 20, 'cpu'): ('cpu', None)}
  for n in (1, 5, 20):
    runs.update({('curves', n, 'card'): (dev, None),
                 ('curves', n, 'cpu'): ('cpu', None),
                 ('curves', n, 'ulp'): ('cpu', ulp)})
  psnrs = {k: fit_grid.fit_pair(*small, steps=k[1], guide=k[0],
                                guide_params=p, device=w)[0]
           for k, (w, p) in runs.items()}
  luma_diff = abs(psnrs['luma', 20, 'card'] - psnrs['luma', 20, 'cpu'])
  drift = {n: [abs(psnrs['curves', n, w] - psnrs['curves', n, 'cpu'])
               for w in ('card', 'ulp')] for n in (1, 5, 20)}
  if not (max(grad_err.values()) <= 1e-4 and luma_diff <= 1e-3):
    raise AssertionError(f'fit_grid 256^2 card vs cpu: gradients {grad_err}, '
                         f'luma PSNR |diff| {luma_diff}')
  print(f'fit_grid (curves guide, 16x16x8 grid, Adam 3e-3): 1024^2 50 steps '
        f'PSNR {identity:.4f} dB (identity) -> {psnr:.4f} dB, launches (K3, '
        f'K4, K5) {counts}; timing {tag} {step_ms:.4f} ms a step (host clock, '
        f'synchronized); 256^2 card vs cpu: first-step gradients with the '
        f'curves guide, max|diff| over the leaf\'s max |g| '
        f'{json.dumps(grad_err)} (<= 1e-4), entries of another sign '
        f'{json.dumps(flips)}; luma guide 20 steps card '
        f'{psnrs["luma", 20, "card"]:.6f} dB vs cpu '
        f'{psnrs["luma", 20, "cpu"]:.6f} dB (|diff| {luma_diff:.2e} <= '
        f'1e-3); curves guide PSNR |diff| after 1 / 5 / 20 steps, card vs '
        f'cpu ' + ' / '.join(f'{a:.2e}' for a, _ in drift.values())
        + ' dB, cpu vs cpu from a guide init one ulp up '
        + ' / '.join(f'{b:.2e}' for _, b in drift.values()) + ' dB',
        flush=True)
  return step_ms


# --- the extended zoo and the baselines -------------------------------------


@contextlib.contextmanager
def _k4_input_flags():
  """The need_input argument of every K4 call inside the block, in a
  list: whether the call also gave the input's cotangent (the wrapper
  still counts its own launches)."""
  from hdrnet_torch.ops import slice_apply as sa
  kernel, flags = sa.slice_apply_pix_bwd, []

  def spy(*args, need_input=True, **kw):
    flags.append(need_input)
    return kernel(*args, need_input=need_input, **kw)
  sa.slice_apply_pix_bwd = spy
  try:
    yield flags
  finally:
    sa.slice_apply_pix_bwd = kernel


def _reset_slice_counts():
  from hdrnet_torch.ops import slice_apply as sa
  sa.fwd_launches = sa.pix_bwd_launches = sa.grid_bwd_launches = 0


def _slice_counts():
  from hdrnet_torch.ops import slice_apply as sa
  return {'K3': sa.fwd_launches, 'K4': sa.pix_bwd_launches,
          'K5': sa.grid_bwd_launches}


def _plain_first_grads(cfg, seed, batch, dev, full_float32):
  """(loss, {name: gradient}) of the l2 loss of one normalized batch
  through a fresh model of `cfg` from `seed` in training mode, on the
  plain versions of the slice-apply, in full float32: the first step's
  gradients on the plain path."""
  from hdrnet_torch.models import make_model
  from hdrnet_torch.training import metrics
  model = make_model(cfg, generator=torch.Generator().manual_seed(
      seed)).to(dev).train()
  names, params = zip(*model.named_parameters())
  with _plain_slice_apply_ops(), full_float32():
    out = model(batch['lowres_input'], batch['image_input'])
    loss = metrics.l2_loss(batch['image_output'], out)
    grads = torch.autograd.grad(loss, params)
  return float(loss.detach()), dict(zip(names, grads))


def _hold_grads(model, want, what):
  """Every parameter's gradient after a step against the plain path's,
  GRAD_REL of the leaf's max |g| (STACK_GUIDE_REL for the stack's
  guides). Returns (the worst ratio err / max, the failures)."""
  worst, failures = 0.0, []
  for name, p in model.named_parameters():
    w = want[name]
    scale = float(w.abs().max())
    err = float((p.grad - w).abs().max())
    rel = (STACK_GUIDE_REL if name.startswith(('stage0.guide.',
                                               'stage1.guide.'))
           else GRAD_REL)
    if not err <= rel * scale:  # also catches NaN
      failures.append(f'{what}: gradient of {name}: {err:.3e} > {rel:.0e} '
                      f'* {scale:.3e}')
    worst = max(worst, err / max(scale, 1e-30))
  return worst, failures


def _device_breakdown(fn):
  """(busy ms, [(kernel name, ms, calls)] largest first) of the device
  work of one fn() call, from torch.profiler's CUDA kernel events after
  one unprofiled warm-up call; busy is 0.0 if the profiler sees no
  device time."""
  from torch.profiler import ProfilerActivity, profile
  fn()
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    fn()
    torch.cuda.synchronize()
  rows = sorted(((e.key[:70], e.device_time_total / 1e3, e.count)
                 for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and e.device_time_total > 0), key=lambda r: -r[1])
  return sum(r[1] for r in rows), rows


def _print_breakdown(what, tag, wall_ms, fn):
  busy, rows = _device_breakdown(fn)
  if not busy:
    print(f'profile {what}: the profiler saw no device time', flush=True)
    return
  top = '; '.join(f'{name} {ms:.3f} ms x{n}' for name, ms, n in rows[:8])
  print(f'profile {tag} {what}: device busy {busy:.3f} ms of {wall_ms:.3f} '
        f'ms (idle share {max(0.0, 1 - busy / wall_ms):.2f}), '
        f'{sum(r[2] for r in rows)} kernels; largest: {top}', flush=True)


def _zoo_train_full_width(dev, tag, slice_launches, full_float32):
  """scripts/ll_strong/train_fpyrnn3_cm2.sh's model and optimizer
  (HDRNetFeaturesPyrNN3, cm 2, l8/s16, 256^2 preview, 1024^2, b=4, no BN,
  Adam 1e-4) on seeded uint8 batches: the first step's every gradient
  against the plain path, ZOO_STEPS steps with three K3, three K4 (each
  with the features' cotangent) and three K5 a step, the step time (host
  clock, synchronized after each step) and peak memory, then a save,
  restore and one more step each way, bit for bit. Returns the model's
  config, its trained weights and the numbers."""
  import shutil
  from hdrnet_torch.config import Config, DataConfig, ModelConfig, TrainConfig
  from hdrnet_torch.models import make_model
  from hdrnet_torch.training import loop, step
  cfg = Config(
      model=ModelConfig(model_name=FPYR, net_input_size=256,
                        output_resolution=list(ZOO_TRAIN_HW), luma_bins=8,
                        spatial_bin=16, channel_multiplier=2,
                        batch_norm=False),
      data=DataConfig(batch_size=ZOO_TRAIN_B,
                      output_resolution=list(ZOO_TRAIN_HW)),
      train=TrainConfig(learning_rate=1e-4))
  seed = 2024

  def fresh(s):
    model = make_model(cfg.model, generator=torch.Generator().manual_seed(
        s)).to(dev)
    return step.create_state(model, loop.make_optimizer(model, cfg.train))

  host = _train_batches(4, cfg.model, b=ZOO_TRAIN_B)
  want_loss, want_grads = _plain_first_grads(
      cfg.model, seed, step.normalize_batch(step.to_device(host[0], dev)),
      dev, full_float32)
  train_step = step.make_train_step()
  state = fresh(seed)
  torch.cuda.synchronize()
  torch.cuda.empty_cache()
  torch.cuda.reset_peak_memory_stats()
  _reset_slice_counts()
  step_ms, losses = [], []
  with _k4_input_flags() as flags:
    for i in range(ZOO_STEPS):
      t0 = time.perf_counter()
      state, m = train_step(state, step.to_device(host[i % 4], dev))
      torch.cuda.synchronize()
      step_ms.append((time.perf_counter() - t0) * 1e3)
      losses.append(float(m['loss']))
      if i == 0:
        grad_worst, failures = _hold_grads(state.model, want_grads,
                                           f'{FPYR} first step')
        if failures:
          raise AssertionError('; '.join(failures))
        if abs(losses[0] - want_loss) > 1e-5 * abs(want_loss):
          raise AssertionError(f'{FPYR} first loss {losses[0]} vs plain '
                               f'{want_loss}')
  peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
  launches = _slice_counts()
  n = 3 * ZOO_STEPS
  if launches != {'K3': n, 'K4': n, 'K5': n} or flags != [True] * n:
    raise AssertionError(f'{FPYR} launches over {ZOO_STEPS} steps '
                         f'{launches}, K4 with the input cotangent '
                         f'{sum(flags)} of {len(flags)}; expected {n} each')
  _tally_slice(slice_launches, n, n, n)
  if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
    raise AssertionError(f'{FPYR} training: losses {losses}')

  ckpt_dir = 'build/chip_smoke_zoo_ckpt'
  _reset_slice_counts()
  resume_err = _check_resume(cfg, state, fresh, step.to_device(host[0], dev),
                             train_step, ckpt_dir, FPYR)
  _tally_slice(slice_launches, *_slice_counts().values())
  shutil.rmtree(ckpt_dir, ignore_errors=True)
  steady = sorted(step_ms[2:])[len(step_ms[2:]) // 2]
  print(f'zoo training {FPYR} at full width (train_fpyrnn3_cm2.sh: cm 2, '
        f'l8/s16, 256^2, {ZOO_TRAIN_HW[0]}^2, b={ZOO_TRAIN_B}, Adam 1e-4; '
        f'C = 27, n_in 8 a level): first-step gradients worst '
        f'{grad_worst:.3e} of the leaf max vs plain (<= {GRAD_REL:.0e}); '
        f'{ZOO_STEPS} steps, loss {losses[0]:.6f} -> {losses[-1]:.6f}; '
        f'launches {launches}, every K4 with the features\' cotangent; '
        f'resume max diff {resume_err:.3e} (bit-identical under '
        f'cudnn.deterministic); timing {tag}: step 1 {step_ms[0]:.2f} ms, '
        f'median of steps 3-{ZOO_STEPS} {steady:.4f} ms (host clock, '
        f'synchronized); peak memory allocated {peak_mib:.1f} MiB',
        flush=True)
  batch = step.to_device(host[1], dev)
  _reset_slice_counts()
  _print_breakdown(f'{FPYR} train step', tag, steady,
                   lambda: train_step(state, batch))
  _tally_slice(slice_launches, *_slice_counts().values())
  weights = {k: v.detach().clone() for k, v in
             state.model.state_dict().items()}
  return cfg.model, weights, {'step_ms': steady, 'first_step_ms': step_ms[0],
                              'peak_mib': peak_mib, 'grad_worst': grad_worst}


def _zoo_serve_4k(dev, tag, model_cfg, weights, slice_launches, full_float32):
  """The trained fpyrnn3_cm2 model through the composite route at 4K:
  Enhancer.process on two f32 frames (b=1) and make_stream_fn on two u8
  frames, one K2 and three K3 a frame and no K1 or K6, held to the plain
  chain (K1_TOL; u8 1 code on < 1%); then the time of a frame."""
  from hdrnet_torch.inference import Enhancer
  from hdrnet_torch.ops import downsample, fused
  enh = Enhancer(model_cfg, weights, device=dev)
  if enh.fused:
    raise AssertionError(f'{FPYR} took the fused route')
  gen = torch.Generator(device=dev).manual_seed(77)
  frames = [torch.rand((1, *UHD, 3), generator=gen, device=dev)
            for _ in range(2)]
  frames_u8 = [(torch.rand((1, *UHD, 3), generator=gen, device=dev) * 255)
               .to(torch.uint8) for _ in range(2)]
  fn = enh.make_stream_fn((1, *UHD, 3))
  torch.cuda.synchronize()
  _reset_slice_counts()
  downsample.launches = fused.launches = fused.nn_launches = 0
  outs = [enh.process(f) for f in frames]
  outs_u8 = [fn(f) for f in frames_u8]
  torch.cuda.synchronize()
  counts = {'K2': downsample.launches, 'K1': fused.launches,
            'K6': fused.nn_launches, **_slice_counts()}
  want = {'K2': 4, 'K1': 0, 'K6': 0, 'K3': 12, 'K4': 0, 'K5': 0}
  if counts != want:
    raise AssertionError(f'{FPYR} composite serving launches {counts}; '
                         f'expected {want}')
  _tally_slice(slice_launches, counts['K3'])
  with _plain_slice_apply_ops():
    wants = [enh.process(f) for f in frames]
    wants_u8 = [fn(f) for f in frames_u8]
  err = 0.0
  for out, w in zip(outs, wants):
    if out.shape != (1, *UHD, 3) or not torch.isfinite(out).all():
      raise AssertionError(f'{FPYR} composite process output malformed')
    err = max(err, _max_err(out, w, K1_TOL, f'{FPYR} composite process'))
  u8 = [_u8_check(o, w, f'{FPYR} composite stream')
        for o, w in zip(outs_u8, wants_u8)]
  del outs, wants, outs_u8, wants_u8
  proc_ms = _time_ms(lambda: enh.process(frames[0]), 10)
  stream_ms = _time_ms(lambda: fn(frames_u8[0]), 10)
  _reset_slice_counts()
  _print_breakdown(f'{FPYR} composite 4K frame', tag, proc_ms,
                   lambda: enh.process(frames[0]))
  _tally_slice(slice_launches, _slice_counts()['K3'])
  print(f'zoo serving {FPYR} (cm 2) through the composite route at 4K: '
        f'process x2 f32 max abs err {err:.3e} (<= {K1_TOL:.0e}) vs the '
        f'plain chain; stream fn x2 u8 worst {max(u8)}; launches {counts}; '
        f'timing {tag}: process {proc_ms:.4f} ms/frame, stream fn '
        f'{stream_ms:.4f} ms/frame (device-resident u8)', flush=True)
  return {'process_ms': proc_ms, 'stream_ms': stream_ms, 'err': err}


def _zoo_others(dev, tag, slice_launches, full_float32):
  """Each other new model at its script's widths (ZOO_OTHERS), the
  resolution cut to ZOO_CUT_HW at b=1: one train step whose every
  gradient is held to the plain path's, its K3/K4/K5 launches counted,
  then one 1080p frame served (composite route) against the plain chain.
  Returns {model: (step ms, frame ms)} (host clock, synchronized; the
  first call at a shape, warm-up included)."""
  from hdrnet_torch.config import ModelConfig, TrainConfig
  from hdrnet_torch.inference import Enhancer
  from hdrnet_torch.models import make_model
  from hdrnet_torch.ops import downsample, fused
  from hdrnet_torch.training import loop, step
  gen = torch.Generator(device=dev).manual_seed(78)
  results, grad_worst, failures = {}, {}, []
  worst = {'grad': 0.0, 'serve': 0.0}
  for name, n_in, script, n_slices in ZOO_OTHERS:
    cfg = ModelConfig(model_name=name, n_in=n_in,
                      output_resolution=list(ZOO_CUT_HW))
    seed = 300 + len(results)
    batch = _train_batches(1, cfg, seed=seed)[0]
    _, want_grads = _plain_first_grads(
        cfg, seed, step.normalize_batch(step.to_device(batch, dev)), dev,
        full_float32)
    model = make_model(cfg, generator=torch.Generator().manual_seed(
        seed)).to(dev)
    state = step.create_state(model, loop.make_optimizer(
        model, TrainConfig(learning_rate=1e-4)))
    torch.cuda.synchronize()
    _reset_slice_counts()
    t0 = time.perf_counter()
    state, m = step.make_train_step()(state, step.to_device(batch, dev))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    counts = _slice_counts()
    if counts != {'K3': n_slices, 'K4': n_slices, 'K5': n_slices}:
      raise AssertionError(f'{name} train step launches {counts}; expected '
                           f'{n_slices} each')
    _tally_slice(slice_launches, *counts.values())
    grad_worst[name], failed = _hold_grads(model, want_grads,
                                           f'{name} step')
    failures += failed
    worst['grad'] = max(worst['grad'], grad_worst[name])
    enh = Enhancer(cfg, model.state_dict(), device=dev)
    x = torch.rand((1, *FHD, n_in), generator=gen, device=dev)
    torch.cuda.synchronize()
    _reset_slice_counts()
    downsample.launches = fused.launches = fused.nn_launches = 0
    t0 = time.perf_counter()
    out = enh.process(x)
    torch.cuda.synchronize()
    frame_ms = (time.perf_counter() - t0) * 1e3
    served = (downsample.launches, fused.launches + fused.nn_launches,
              _slice_counts()['K3'])
    if enh.fused or served != (1, 0, n_slices):
      raise AssertionError(f'{name} serving (K2, K1 + K6, K3) {served}, '
                           f'fused {enh.fused}; expected (1, 0, '
                           f'{n_slices}), composite')
    _tally_slice(slice_launches, n_slices)
    with _plain_slice_apply_ops():
      want = enh.process(x)
    if out.shape != (1, *FHD, 3) or not torch.isfinite(out).all():
      raise AssertionError(f'{name} 1080p output malformed')
    err = float((out - want).abs().max())
    if not err <= K1_TOL:
      failures.append(f'{name} 1080p vs plain: max abs err {err:.3e}')
    worst['serve'] = max(worst['serve'], err)
    results[name] = (step_ms, frame_ms)
    del model, state, enh, want_grads, x, out, want
    torch.cuda.empty_cache()
  print('zoo gradients, worst |g - g_plain| / max|g_plain| a model: '
        + json.dumps({k: float(f'{v:.3e}') for k, v in grad_worst.items()}),
        flush=True)
  if failures:
    raise AssertionError('; '.join(failures))
  print(f'zoo, the other {len(ZOO_OTHERS)} new models at their scripts\' '
        f'widths, one train step at {ZOO_CUT_HW[0]}^2 b=1 (cut from the '
        f'scripts\' 2048^2 b=1, 1024^2 b=4 and 512^2 b=4) and one 1080p '
        f'frame: every gradient worst {worst["grad"]:.3e} of the leaf max '
        f'vs plain (<= {GRAD_REL:.0e}; the stack\'s guides <= '
        f'{STACK_GUIDE_REL:.0e}), 1080p max abs err '
        f'{worst["serve"]:.3e} (<= {K1_TOL:.0e}) vs the plain chain; '
        f'timing {tag} (step ms, frame ms; first call at the shape, '
        f'host clock): {json.dumps(results)}', flush=True)
  return results


def _bf16_serving(dev, tag, x4k):
  """The bfloat16 backbone (Enhancer(coeff_bf16=True)) of HDRNetCurves and
  HDRNetPointwiseNNGuide at the default widths, seeded, at 4K f32 b=1,
  in turns with float32: the max abs difference and the PSNR of bf16
  against f32 (limits BF16_MAX_ABS and BF16_MIN_PSNR, from
  tests/test_torch_zoo_tools.py's measurement on the CPU), and the ms
  of a frame and of the backbone alone; still one K2 and one K1 or K6 a
  frame."""
  from hdrnet_torch.inference import Enhancer, ModelConfig
  from hdrnet_torch.ops import downsample, fused
  results = {}
  for name in ('HDRNetCurves', NN):
    f32 = Enhancer(ModelConfig(model_name=name), device=dev, seed=5)
    bf16 = Enhancer(ModelConfig(model_name=name), f32.model.state_dict(),
                    device=dev, coeff_bf16=True)
    if not (bf16.fused and bf16.coeff_bf16):
      raise AssertionError(f'{name}: the bf16 backbone is not on')
    torch.cuda.synchronize()
    downsample.launches = fused.launches = fused.nn_launches = 0
    got = bf16.process(x4k)
    torch.cuda.synchronize()
    if (downsample.launches, fused.launches + fused.nn_launches) != (1, 1):
      raise AssertionError(f'{name} bf16 launches K2 {downsample.launches}, '
                           f'K1 + K6 {fused.launches + fused.nn_launches}')
    want = f32.process(x4k)
    diff = float((got - want).abs().max())
    psnr = float(10 * torch.log10(1.0 / ((got - want) ** 2).mean()))
    if not (diff <= BF16_MAX_ABS and psnr >= BF16_MIN_PSNR):
      raise AssertionError(f'{name} bf16 vs f32: max abs {diff:.3e}, PSNR '
                           f'{psnr:.2f} dB')
    low = downsample.nearest_lowres(x4k, 256)
    turns = [_time_ms(lambda: f32.process(x4k), 30),
             _time_ms(lambda: bf16.process(x4k), 30),
             _time_ms(lambda: bf16.process(x4k), 30),
             _time_ms(lambda: f32.process(x4k), 30)]
    bb = [_time_ms(lambda: f32._backbone_grid(low), 30),
          _time_ms(lambda: bf16._backbone_grid(low), 30),
          _time_ms(lambda: bf16._backbone_grid(low), 30),
          _time_ms(lambda: f32._backbone_grid(low), 30)]
    results[name] = {'max_abs': diff, 'psnr_db': psnr, 'process_ms': turns,
                     'backbone_ms': bb}
    print(f'bf16 backbone {name} at 4K f32 b=1 (default widths, seeded): '
          f'vs float32 max abs {diff:.3e} (<= {BF16_MAX_ABS:.0e}), PSNR '
          f'{psnr:.2f} dB (>= {BF16_MIN_PSNR:.0f}); timing {tag}, in turns '
          f'f32 / bf16 / bf16 / f32: process '
          f'{" / ".join(f"{t:.4f}" for t in turns)} ms, backbone '
          f'{" / ".join(f"{t:.4f}" for t in bb)} ms', flush=True)
  return results


def _zoo_slice_ops(c, n_in, n_out):
  """float32 operations a pixel of K3, K4 (both cotangents) and K5 at C
  grid channels, counted as SLICE_APPLY_OPS, K4_GUIDE_OPS and K5_OPS are
  for C = 12: K3 the taps and weights (55), 8 corners x C FMA, the
  n_out x n_in affine; K4 the taps and weights with their derivatives
  (68), 8 corners x C FMA, the (C + 3)-FMA contraction into d_guide and
  the n_out x n_in FMA of d_image; K5 the C products, the weights (30)
  and 4 cells x 2 bins x C FMA."""
  return {'K3': 55 + 16 * c + 2 * n_out * n_in,
          'K4': 68 + 16 * c + 2 * (c + 3) + 2 * n_out * n_in,
          'K5': 30 + 17 * c}


def _zoo_slice_levels(gen, dev, tag, full_float32):
  """K3, K4 (both cotangents, as the feature models' steps run it) and K5
  at the train_fpyrnn3_cm2.sh shapes: C = 27 (n_in 8, n_out 3), b=4,
  grid 16x16x8, at 1024^2, 512^2 and 256^2 (the three pyramid levels):
  held to the plain versions once, then the device time of a call (CUDA
  events around 20 calls, and in a CUDA graph), its bound, and the plain
  version's time; K5's plan."""
  from hdrnet_torch.ops import slice_apply as sa
  from hdrnet_torch.utils.timing import graph_ms
  levels = {'K3': {}, 'K4': {}, 'K5': {}}
  n_in, n_out, b = 8, 3, ZOO_TRAIN_B
  for n in ZOO_TRAIN_HW[0], ZOO_TRAIN_HW[0] // 2, ZOO_TRAIN_HW[0] // 4:
    g5, guide, image, ct = _train_inputs(gen, b, (n, n), n_in, dev)
    c = g5.shape[-1]
    calls = {
        'K3': (lambda: sa.slice_apply_fwd(g5, guide, image),
               lambda: sa.slice_apply_fwd_plain(g5, guide, image)),
        'K4': (lambda: sa.slice_apply_pix_bwd(g5, guide, image, ct),
               lambda: sa.slice_apply_pix_bwd_plain(g5, guide, image, ct)),
        'K5': (lambda: sa.slice_apply_grid_bwd(g5.shape, guide, image, ct),
               lambda: sa.slice_apply_grid_bwd_plain(g5.shape, guide, image,
                                                     ct))}
    with full_float32():
      got = {k: kern() for k, (kern, _) in calls.items()}
      want = {k: plain() for k, (_, plain) in calls.items()}
    what = f'C={c} {n}^2 b={b}'
    errs = {'K3': _max_err(got['K3'], want['K3'], K3_TOL, f'K3 {what}'),
            'K4': max(_scaled_err(got['K4'][0], want['K4'][0], K4_GUIDE_REL,
                                  f'K4 guide {what}'),
                      _max_err(got['K4'][1], want['K4'][1], K3_TOL,
                               f'K4 input {what}')),
            'K5': _scaled_err(got['K5'], want['K5'], K5_REL, f'K5 {what}')}
    del got, want
    pixels, grid_bytes = b * n * n, _nbytes(g5)
    ops = _zoo_slice_ops(c, n_in, n_out)
    pad_y, pad_x = -(-n // (2 * 16)), -(-n // (2 * 16))
    padded = b * (n + 2 * pad_y) * (n + 2 * pad_x)
    bounds = {
        # grid, guide, image in; output out.
        'K3': _bound(grid_bytes + pixels * (1 + n_in + n_out) * 4,
                     pixels * ops['K3']),
        # grid, guide, image, ct in; d_guide and d_image out.
        'K4': _bound(grid_bytes + pixels * (1 + n_in + n_out + 1 + n_in) * 4,
                     pixels * ops['K4']),
        # guide, image, ct in; the grid cotangent out.
        'K5': _bound(grid_bytes + pixels * (1 + n_in + n_out) * 4,
                     padded * ops['K5'])}
    for kid, (kern, plain) in calls.items():
      with full_float32():
        plain_ms = _time_ms(plain, 3, warmup=1)
      levels[kid][f'fpyrnn3_cm2 C={c} {n}^2 b={b}'] = {
          'ms': _time_ms(kern, 20), 'graph_ms': graph_ms(kern),
          'plain_ms': plain_ms, 'bound_ms': bounds[kid][0],
          'bound_by': bounds[kid][1], 'max_abs_err': errs[kid]}
    strips, floats, smem = sa.grid_bwd_plan(g5.shape, guide)
    levels['K5'][f'fpyrnn3_cm2 C={c} {n}^2 b={b}'].update({
        'strips': strips, 'shared_bytes': smem, 'scratch_bytes': floats * 4})
    del g5, guide, image, ct, calls
    torch.cuda.empty_cache()
  for kid, by_shape in levels.items():
    print(f'timing {tag}: {kid} at the fpyrnn3_cm2 levels: ' + '; '.join(
        f'{k} {v["ms"]:.4f} ms (graph {v["graph_ms"]:.4f}, plain '
        f'{v["plain_ms"]:.4f}, bound {v["bound_ms"]:.4f} {v["bound_by"]}, '
        f'err {v["max_abs_err"]:.2e})' for k, v in by_shape.items()),
        flush=True)
  print('K5 plans at C = 27: ' + '; '.join(
      f'{k} {v["strips"]} strips, {v["shared_bytes"]} B shared, scratch '
      f'{v["scratch_bytes"]} B' for k, v in levels['K5'].items()),
      flush=True)
  return levels


# --- the quality workload: dataset generators and device-resident data --------

@contextlib.contextmanager
def _step_clock():
  """Inside the block every train step that training.loop makes records
  time.perf_counter() when it returns, into the list yielded."""
  from hdrnet_torch.training import loop
  clock, make = [], loop.make_train_step

  def timed_make(**kwargs):
    train_step = make(**kwargs)

    def timed(state, *batch_and_band):
      out = train_step(state, *batch_and_band)
      clock.append(time.perf_counter())
      return out
    return timed

  loop.make_train_step = timed_make
  try:
    yield clock
  finally:
    loop.make_train_step = make


def _step_ms(clock, warmup):
  """Median host-clock spacing of a train() call's steps after `warmup`
  steps, in ms (the loop's runahead bound paces the host by the device
  once steady)."""
  return float(np.median(np.diff(clock[warmup:]))) * 1e3


def _launch_counts():
  from hdrnet_torch.ops import downsample, fused
  return {'K1': fused.launches, 'K2': downsample.launches, **_slice_counts()}


def _reset_launch_counts():
  from hdrnet_torch.ops import downsample, fused
  fused.launches = fused.nn_launches = fused.band_launches = 0
  downsample.launches = 0
  _reset_slice_counts()


def _counted(fn):
  """(fn(), the kernels' launches during it), the counts reset just
  before and read just after."""
  torch.cuda.synchronize()
  _reset_launch_counts()
  out = fn()
  torch.cuda.synchronize()
  return out, _launch_counts()


def _expect_launches(got, want, what):
  got = {k: v for k, v in got.items() if v}
  if got != want:
    raise AssertionError(f'{what}: launches {got}; expected {want}')


def _check_ll_generator(dev, tag, data):
  """scripts/make_ll_dataset.py's counterpart on the card at the quality
  workload's size: the train and test splits, ms an image of the
  synthesis and of the operator, and the first training image held to
  the same functions on the CPU (float values, then the PNG files)."""
  from hdrnet_torch.data import images
  from hdrnet_torch.scripts import make_ll_dataset as ll
  n_train, n_test = QUALITY_IMAGES
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  ll.main([data, '--n_train', str(n_train), '--n_test', str(n_test),
           '--size', str(QUALITY_SIZE), '--device', str(dev)])
  build_s = time.perf_counter() - t0
  op = dict(sigma=0.35, alpha=0.2, levels=5)  # make_ll_dataset's defaults
  rng = np.random.RandomState(99)
  synth_ms = _time_ms(lambda: ll.synth_photo(rng, QUALITY_SIZE, dev), 5,
                      warmup=1)
  img = ll.synth_photo(np.random.RandomState(0), QUALITY_SIZE, dev)
  op_ms = _time_ms(lambda: ll.enhance(img, **op), 5, warmup=1)
  img_cpu = ll.synth_photo(np.random.RandomState(0), QUALITY_SIZE, 'cpu')
  synth_err = _max_err(img.cpu(), img_cpu, LL_TOL, 'll synthesis card vs cpu')
  tgt = ll.enhance(img, **op).cpu()
  op_err = _max_err(tgt, ll.enhance(img.cpu(), **op), LL_TOL,
                    'll operator card vs cpu')
  tgt_cpu = ll.enhance(img_cpu, **op)
  files = [_u8_check(
      torch.from_numpy(np.array(images.imread(
          f'{data}/train/{sub}/im0000.png'))),
      torch.from_numpy(ll.to_u8(want)), f'll {sub} PNG card vs cpu')
      for sub, want in (('input', img_cpu), ('output', tgt_cpu))]
  mean_change = float((tgt - img.cpu()).abs().mean())
  if not 1e-3 < mean_change < 0.2:
    raise AssertionError(f'll operator: mean |target - input| '
                         f'{mean_change}')
  print(f'make_ll_dataset on the card: {n_train} + {n_test} images at '
        f'{QUALITY_SIZE}^2 (cut from 220 + 24) in {build_s:.2f} s with the '
        f'PNG files; timing {tag} synthesis {synth_ms:.4f} ms an image, '
        f'operator (8 gammas, 5 levels) {op_ms:.4f} ms an image (events); '
        f'first train image vs the CPU: synthesis max abs err '
        f'{synth_err:.3e}, operator on the same input {op_err:.3e} (<= '
        f'{LL_TOL:.0e}); PNGs of the card\'s build vs the CPU\'s (max '
        f'codes, share differing) input {files[0]}, target {files[1]}; '
        f'mean |target - input| {mean_change:.4f}', flush=True)


def _check_device_batch(dev, data, args, full_float32):
  """The quality run's first batch gathered and augmented on the card
  (the training loop's augment_batch) against the same on the CPU, bit
  for bit, then the first step's every gradient on it (the run's model
  from its seed) against the plain path, GRAD_REL of each leaf's max.
  Returns the batch's parameters and the worst gradient ratio. (uint16
  data on the card: tests/test_torch_cuda.py.)"""
  from hdrnet_torch.bin import train
  from hdrnet_torch.data import make_pipeline
  from hdrnet_torch.data.device import (DeviceDataset, load_pairs,
                                        make_device_augment)
  from hdrnet_torch.models import make_model
  from hdrnet_torch.training import loop, metrics, step
  cfg = train.config_from_args(train.build_parser().parse_args(args))
  pairs = load_pairs(make_pipeline(f'{data}/train', cfg.data))
  aug = make_device_augment(cfg.data.output_resolution,
                            cfg.data.net_input_size, cfg.data.rotate)
  sets = [DeviceDataset(pairs, cfg.data, d) for d in (dev, 'cpu')]
  params = next(sets[0].param_stream(cfg.train.seed, cfg.data.batch_size))
  got, want = (loop.augment_batch(aug, s.inputs, s.outputs, params)
               for s in sets)
  for k in want:
    if not torch.equal(got[k].cpu(), want[k]):
      raise AssertionError(f'device batch {k}: card and cpu differ')
  del sets, want
  batch = step.normalize_batch(got)
  seed = cfg.train.seed
  want_loss, want_grads = _plain_first_grads(cfg.model, seed, batch, dev,
                                             full_float32)
  model = make_model(cfg.model, generator=torch.Generator().manual_seed(
      seed)).to(dev).train()
  with full_float32():
    loss = metrics.l2_loss(batch['image_output'],
                           model(batch['lowres_input'], batch['image_input']))
    loss.backward()
  worst, failures = _hold_grads(model, want_grads, 'quality run first step')
  if abs(float(loss) - want_loss) > 1e-5 * abs(want_loss):
    failures.append(f'quality run first loss {float(loss)} vs plain '
                    f'{want_loss}')
  if failures:
    raise AssertionError('; '.join(failures))
  return params, worst


def _check_usm(dev, data, root):
  """The usm workload on the built train split: targets synthesized on
  the card against the host pipeline's (two images), SIDE_STEPS steps
  with --device_data (the route asserted), and make_usm_dataset on the
  test split (its mean identity PSNR)."""
  from hdrnet_torch.bin import train
  from hdrnet_torch.data import make_pipeline
  from hdrnet_torch.data.device import load_usm_dataset
  from hdrnet_torch.scripts import make_usm_dataset
  cfg = train.config_from_args(train.build_parser().parse_args(
      ['unused', f'{data}/train', *USM_FLAGS]))
  pipe = make_pipeline(f'{data}/train', cfg.data)
  dds = load_usm_dataset(pipe, cfg.data, dev)
  worst = 0
  for i in range(2):
    _, host = pipe._load(pipe.specs[i], None)
    want = np.floor(host * 255.0 + 0.5).astype(np.int64)
    d = np.abs(dds.outputs[i].cpu().numpy().astype(np.int64) - want)
    worst = max(worst, int(d.max()))
  if worst > 1:
    raise AssertionError(f'usm targets card vs host: {worst} codes')
  del dds
  state, counts = _counted(lambda: train.main(
      [f'{root}/usm', f'{data}/train', '--eval_data_dir', f'{data}/test',
       *USM_FLAGS, '--max_steps', str(SIDE_STEPS)]))
  if (state.data_route, state.eval_data_route) != ('device', 'device'):
    raise AssertionError(f'usm: routes {state.data_route}, '
                         f'{state.eval_data_route}')
  _expect_launches(counts, {k: SIDE_STEPS for k in ('K3', 'K4', 'K5')},
                   'usm training')
  identity = make_usm_dataset.main([f'{data}/test', f'{root}/data_usm/test',
                                    '--blur_sigma', '4', '--sharpen', '1'])
  print(f'usm (blur 4, sharpen 1) on the built train split: targets '
        f'synthesized on the card vs the host pipeline\'s, max {worst} code '
        f'(<= 1); {SIDE_STEPS} steps with --device_data, route '
        f'{state.data_route} (eval {state.eval_data_route}), resident '
        f'{state.resident_bytes / 1e6:.1f} MB, EMA loss '
        f'{float(state.ema_loss):.6f}; launches {counts}; make_usm_dataset '
        f'on the test split: mean identity PSNR {identity:.4f} dB', flush=True)
  return counts


def _check_st(dev, data, root):
  """The style-transfer workload on the built tree: make_st_dataset, the
  resident 6-channel samples on the card equal to the CPU loader's, and
  SIDE_STEPS steps of nst_curves.sh's StyleTransferCurves with
  --device_data (K3/K4/K5 at n_in 6)."""
  from hdrnet_torch.bin import train
  from hdrnet_torch.data import make_pipeline
  from hdrnet_torch.data.device import load_st_dataset
  from hdrnet_torch.scripts import make_st_dataset
  st = f'{root}/data_st/train'
  make_st_dataset.main([f'{data}/train', st])
  cfg = train.config_from_args(train.build_parser().parse_args(
      ['unused', st, *ST_FLAGS]))
  pipe = make_pipeline(st, cfg.data)
  card, cpu = (load_st_dataset(pipe, cfg.data, d) for d in (dev, 'cpu'))
  if not (torch.equal(card.inputs.cpu(), cpu.inputs)
          and torch.equal(card.outputs.cpu(), cpu.outputs)):
    raise AssertionError('style transfer: resident samples differ from the '
                         'cpu loader\'s')
  shape = tuple(card.inputs.shape)
  del card, cpu
  state, counts = _counted(lambda: train.main(
      [f'{root}/st', st, *ST_FLAGS, '--max_steps', str(SIDE_STEPS)]))
  if state.data_route != 'device':
    raise AssertionError(f'style transfer: route {state.data_route}')
  _expect_launches(counts, {k: SIDE_STEPS for k in ('K3', 'K4', 'K5')},
                   'style transfer training')
  print(f'style transfer (nst_curves.sh: StyleTransferCurves, 512^2 random '
        f'crops, b=4) on make_st_dataset\'s tree: resident samples {shape} '
        f'uint8, equal to the cpu loader\'s; {SIDE_STEPS} steps with '
        f'--device_data, route {state.data_route}, EMA loss '
        f'{float(state.ema_loss):.6f}; launches {counts}', flush=True)
  return counts


def _quality_workload(dev, tag, slice_launches, full_float32):
  """scripts/ll/quality_run.sh's path on the card: build the
  local-Laplacian set, train HDRNetCurves with --device_data from device
  memory (the route asserted; one gathered batch held to the CPU and the
  first step's gradients on it to the plain path), time
  a step with and without --device_data in turns, evaluate step 0 and
  step QUALITY_STEPS (training graph and serving path) and fit the
  per-image oracle grids; then the usm and style-transfer workloads.
  Adds the K3/K4/K5 launches to slice_launches and returns the K1
  launches; leaves the set in QUALITY_DIR for the mesh phase."""
  import shutil
  from hdrnet_torch.bin import evaluate, fit_grid, train
  shutil.rmtree(QUALITY_DIR, ignore_errors=True)
  root, data = QUALITY_DIR, f'{QUALITY_DIR}/data_ll'
  _check_ll_generator(dev, tag, data)

  # Train: the step-0 checkpoint (the same seed's initial weights; the
  # schedule's length given, as max_steps is 0), then the run.
  n = QUALITY_STEPS
  train.main([f'{root}/ckpt_0', f'{data}/train', *QUALITY_FLAGS,
              '--max_steps', '0', '--lr_decay_steps', str(n)])
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  t0 = time.perf_counter()
  with _step_clock() as clock:
    state, counts = _counted(lambda: train.main(
        [f'{root}/ckpt', f'{data}/train', '--eval_data_dir', f'{data}/test',
         *QUALITY_FLAGS, '--max_steps', str(n)]))
  train_s = time.perf_counter() - t0
  peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
  if (state.step, state.data_route, state.eval_data_route) != (
      n, 'device', 'device'):
    raise AssertionError(f'quality run: step {state.step}, routes '
                         f'{state.data_route}, {state.eval_data_route}')
  _expect_launches(counts, {k: n for k in ('K3', 'K4', 'K5')},
                   'quality training')
  totals = dict(counts)
  params, grad_worst = _check_device_batch(dev, data, [
      'unused', f'{data}/train', *QUALITY_FLAGS], full_float32)
  print(f'quality run (scripts/ll/quality_run.sh: HDRNetCurves l8/s16/cm1, '
        f'256^2, gc 16, 1024^2 b=4, cosine 1e-4 -> 1e-6, warmup 500) '
        f'{n} steps with --device_data in {train_s:.2f} s: route '
        f'{state.data_route} (eval {state.eval_data_route}); resident '
        f'{state.resident_bytes / 1e6:.1f} MB (train split); peak memory '
        f'allocated {peak_mib:.1f} MiB; {_step_ms(clock, 100):.4f} ms a step '
        f'(median after 100); EMA loss {float(state.ema_loss):.6f}, PSNR '
        f'{float(state.ema_psnr):.4f} dB; launches {counts}; the first '
        f'batch (idx {params["idx"].tolist()}, fliplr '
        f'{params["fliplr"].tolist()}, flipud {params["flipud"].tolist()}, '
        f'rot_k {params["rot_k"].tolist()}) gathered on the card bit for bit '
        f'with the cpu; the first step\'s gradients on it worst '
        f'{grad_worst:.3e} of the leaf max vs plain (<= {GRAD_REL:.0e}) '
        f'{tag}', flush=True)

  # The device-resident step against the host pipeline's, in turns.
  base = [f for f in QUALITY_FLAGS if f != '--device_data']
  turns = []
  for device_data in (True, False, False, True):
    shutil.rmtree(f'{root}/turn', ignore_errors=True)
    flag = '--device_data' if device_data else '--nodevice_data'
    with _step_clock() as clock:
      st, counts = _counted(lambda: train.main(
          [f'{root}/turn', f'{data}/train', *base, flag,
           '--max_steps', str(TURN_STEPS)]))
    if st.data_route != ('device' if device_data else 'host'):
      raise AssertionError(f'timing turn {flag}: route {st.data_route}')
    for k in ('K3', 'K4', 'K5'):
      totals[k] += counts[k]
    turns.append(_step_ms(clock, TURN_WARMUP))
  print(f'timing {tag}: quality run step (1024^2 b=4), median of steps '
        f'{TURN_WARMUP + 1}-{TURN_STEPS} (host clock), in turns device data '
        f'/ host pipeline / host pipeline / device data: '
        f'{" / ".join(f"{t:.4f}" for t in turns)} ms', flush=True)

  # Evaluate step 0 and step n (training graph: K3; serving: K1, on the
  # pipeline's own nearest preview, so no K2), then the per-image oracle.
  n_test = QUALITY_IMAGES[1]
  psnr = {}
  for label, ckpt in (('0', f'{root}/ckpt_0'), (str(n), f'{root}/ckpt')):
    for serving in (False, True):
      res, counts = _counted(lambda: evaluate.main(
          [ckpt, f'{data}/test'] + (['--serving'] if serving else [])))
      _expect_launches(counts, {'K1' if serving else 'K3': n_test},
                       f'evaluate step {label}')
      for k in counts:
        totals[k] += counts[k]
      psnr[label, serving] = res['mean_psnr_db']
  oracle, counts = _counted(lambda: fit_grid.main([f'{data}/test',
                                                   '--limit', '4']))
  # fit_grid's default: 400 steps and one more forward a fit; the luma
  # guide is fixed, so no guide cotangent (K4).
  steps = 400 * n_test
  _expect_launches(counts, {'K3': steps + n_test, 'K5': steps}, 'fit_grid')
  for k in ('K3', 'K4', 'K5'):
    totals[k] += counts[k]
  for serving in (False, True):
    a, b = psnr['0', serving], psnr[str(n), serving]
    if not (np.isfinite(b) and b > a):
      raise AssertionError(f'evaluate (serving {serving}): PSNR at step {n} '
                           f'{b} not above step 0 {a}')
  print(f'quality run evaluated on the {n_test} test images: PSNR step 0 '
        f'{psnr["0", False]:.4f} dB (serving {psnr["0", True]:.4f}), step '
        f'{n} {psnr[str(n), False]:.4f} dB (serving '
        f'{psnr[str(n), True]:.4f}); fit_grid oracle (luma guide, 400 '
        f'steps) {oracle["mean_oracle_psnr"]:.4f} dB, identity '
        f'{oracle["mean_identity_psnr"]:.4f} dB. Not comparable with the '
        f'JAX package\'s {JAX_QUALITY_PSNR} dB (220 images, 120000 steps). '
        f'launches {totals}', flush=True)

  for counts in (_check_usm(dev, data, root),
                 _check_st(dev, data, root)):
    for k in ('K3', 'K4', 'K5'):
      totals[k] += counts[k]
  _tally_slice(slice_launches, totals['K3'], totals['K4'], totals['K5'])
  return totals['K1']


def _hold_bands(g5, guide, image, ct, bounds, what, full_float32):
  """K3, K4 and K5 on the H-bands `bounds` ([(lo, hi)]) of a frame (or a
  pyramid level) against the whole one: K3's output and K4's cotangents
  bit-identical to its rows, K5 bit-identical across runs and its shares
  summed within BAND_SHARE_REL of the whole grid cotangent; each band
  against its plain version. Returns (max abs errs, the shares' error)."""
  from hdrnet_torch.ops import slice_apply as sa
  h = guide.shape[1]
  whole_out = sa.slice_apply_fwd(g5, guide, image)
  whole_dg, whole_di = sa.slice_apply_pix_bwd(g5, guide, image, ct)
  whole_grid = sa.slice_apply_grid_bwd(g5.shape, guide, image, ct)
  errs = {'K3': 0.0, 'K4': 0.0, 'K5': 0.0}
  total = torch.zeros_like(whole_grid)
  for lo, hi in bounds:
    rows, band = slice(lo, hi), (lo, h)
    gb, ib, cb = (t[:, rows].contiguous() for t in (guide, image, ct))
    where = f'{what}, band {band} of {len(bounds)}'
    out = sa.slice_apply_fwd(g5, gb, ib, band=band)
    dg, di = sa.slice_apply_pix_bwd(g5, gb, ib, cb, band=band)
    dg_only, _ = sa.slice_apply_pix_bwd(g5, gb, ib, cb, need_input=False,
                                        band=band)
    share = sa.slice_apply_grid_bwd(g5.shape, gb, ib, cb, band=band)
    for got, want, name in ((out, whole_out[:, rows], 'K3'),
                            (dg, whole_dg[:, rows], 'K4 guide'),
                            (dg_only, whole_dg[:, rows], 'K4 guide only'),
                            (di, whole_di[:, rows], 'K4 input')):
      if not torch.equal(got, want):
        raise AssertionError(f'{name} {where}: not bit-identical to the '
                             f'whole one\'s rows')
    if not torch.equal(share, sa.slice_apply_grid_bwd(
        g5.shape, gb, ib, cb, band=band)):
      raise AssertionError(f'K5 {where}: two runs differ')
    with full_float32():
      errs['K3'] = max(errs['K3'], _max_err(
          out, sa.slice_apply_fwd_plain(g5, gb, ib, band=band), K3_TOL,
          f'K3 {where} vs plain'))
      want_dg, want_di = sa.slice_apply_pix_bwd_plain(g5, gb, ib, cb,
                                                      band=band)
      errs['K4'] = max(errs['K4'], _scaled_err(
          dg, want_dg, K4_GUIDE_REL, f'K4 guide {where} vs plain'), _max_err(
              di, want_di, K3_TOL, f'K4 input {where} vs plain'))
      errs['K5'] = max(errs['K5'], _scaled_err(
          share, sa.slice_apply_grid_bwd_plain(g5.shape, gb, ib, cb,
                                               band=band), K3_TOL,
          f'K5 {where} vs plain'))
    total += share
  return errs, _scaled_err(total, whole_grid, BAND_SHARE_REL,
                           f'K5 shares of {what} vs the whole')


def _time_bands(g5, guide, image, ct, bounds):
  """Each of K3, K4 (the guide's cotangent only) and K5 over `bounds`'s
  bands in turns with the whole frame: events (whole / bands / bands /
  whole) and graphs (the device time, no host gaps between the bands'
  calls)."""
  from hdrnet_torch.ops import slice_apply as sa
  from hdrnet_torch.utils.timing import graph_ms
  h = guide.shape[1]
  bands = [((lo, h), [t[:, lo:hi].contiguous() for t in (guide, image, ct)])
           for lo, hi in bounds]
  calls = {
      'K3': (lambda: sa.slice_apply_fwd(g5, guide, image),
             lambda: [sa.slice_apply_fwd(g5, b[0], b[1], band=band)
                      for band, b in bands]),
      'K4': (lambda: sa.slice_apply_pix_bwd(g5, guide, image, ct,
                                            need_input=False),
             lambda: [sa.slice_apply_pix_bwd(g5, *b, need_input=False,
                                             band=band)
                      for band, b in bands]),
      'K5': (lambda: sa.slice_apply_grid_bwd(g5.shape, guide, image, ct),
             lambda: [sa.slice_apply_grid_bwd(g5.shape, *b, band=band)
                      for band, b in bands]),
  }
  times = {}
  for k, (whole, banded) in calls.items():
    turns = [_time_ms(whole, 20), _time_ms(banded, 20), _time_ms(banded, 20),
             _time_ms(whole, 20)]
    times[k] = {'whole_ms': (turns[0] + turns[3]) / 2,
                'bands_ms': (turns[1] + turns[2]) / 2, 'turns': turns,
                'whole_graph_ms': graph_ms(whole),
                'bands_graph_ms': graph_ms(banded)}
  torch.cuda.synchronize()
  return times


def _band_kernels(gen, dev, tag, full_float32):
  """K3, K4 and K5 on H-bands (``_hold_bands``): of a 1024^2 b=4 frame
  (the quality workload's) in 2 and 4 equal bands, of a pyramid level
  cut unevenly, LEVEL_HW b=4 (a 1080p frame's third level) in the four
  bands of a (1, 4) mesh, and of FPYR cm 2's FPYR_LEVEL_HW level (n_in 8,
  C = 27: K4's d_image of the learned features) in four; the first two
  timed over 4 bands in turns with the whole (``_time_bands``).
  Comparison launches: none counts. Returns the times,
  {label: {kernel: times}}."""
  from hdrnet_torch.parallel import halo
  h = QUALITY_SIZE
  g5, guide, image, ct = _train_inputs(gen, 4, (h, h), 3, dev)
  errs, share_err = {}, {}
  for n in (2, 4):
    errs[n], share_err[n] = _hold_bands(g5, guide, image, ct,
                                        halo.split(h, n), f'{h}^2',
                                        full_float32)
  times = {f'{h}^2 b=4, 4 bands': _time_bands(g5, guide, image, ct,
                                              halo.split(h, 4))}
  lg5, lguide, limage, lct = _train_inputs(gen, 4, LEVEL_HW, 3, dev)
  level_bounds = halo.split(LEVEL_HW[0], 4)
  errs['level'], share_err['level'] = _hold_bands(
      lg5, lguide, limage, lct, level_bounds, 'the level', full_float32)
  level_key = (f'{LEVEL_HW[0]}x{LEVEL_HW[1]} b=4 (a 1080p frame\'s third '
               f'pyramid level), 4 bands of '
               f'{[hi - lo for lo, hi in level_bounds]} rows')
  times[level_key] = _time_bands(lg5, lguide, limage, lct, level_bounds)
  del lg5, lguide, limage, lct
  fh = FPYR_LEVEL_HW[0]
  errs['fpyr'], share_err['fpyr'] = _hold_bands(
      *_train_inputs(gen, 4, FPYR_LEVEL_HW, FPYR_FEATURES, dev),
      halo.split(fh, 4), f'{FPYR} cm 2\'s {fh}^2 level', full_float32)
  worst = {k: max(e[k] for e in errs.values()) for k in ('K3', 'K4', 'K5')}
  print(f'band kernels at {h}^2 b=4 (the quality run\'s frames; K4 with and '
        f'without the input\'s cotangent), 2 and 4 H-bands, and on '
        f'{level_key}: K3 and K4 bit-identical to the whole\'s rows, K5 '
        f'bit-identical across runs and its shares summed within '
        f'{share_err[2]:.3e} (2 bands), {share_err[4]:.3e} (4), '
        f'{share_err["level"]:.3e} (the level) and {share_err["fpyr"]:.3e} '
        f'({FPYR} cm 2\'s {fh}^2 b=4 level at n_in {FPYR_FEATURES}, C = '
        f'{3 * (FPYR_FEATURES + 1)}, 4 bands) of the whole\'s (<= '
        f'{BAND_SHARE_REL:.0e} of its max); against the plain bands max abs '
        f'err K3 {worst["K3"]:.3e}, K4 {worst["K4"]:.3e}, K5 '
        f'{worst["K5"]:.3e} (<= {K3_TOL:.0e}, K4 guide and K5 of their max); '
        f'timing {tag}, whole / 4 bands / 4 bands / whole (events; graphs '
        f'whole, 4 bands): ' + ' | '.join(
            f'{label}: ' + '; '.join(
                f'{k} {" / ".join(f"{t:.4f}" for t in v["turns"])} ms '
                f'({v["whole_graph_ms"]:.4f}, {v["bands_graph_ms"]:.4f})'
                for k, v in kt.items()) for label, kt in times.items()),
        flush=True)
  return times


def _run_ranks(nproc, args, what):
  """torchrun (standalone, nproc ranks on this machine) of `args`, in a
  process group of its own that is killed whole at MESH_TIMEOUT_S;
  raises on a nonzero exit. Returns the ranks' output."""
  cmd = [sys.executable, '-m', 'torch.distributed.run', '--standalone',
         '--nproc_per_node', str(nproc), *args]
  env = dict(os.environ, PYTHONPATH=os.getcwd())
  proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True, env=env,
                          start_new_session=True)
  try:
    out, _ = proc.communicate(timeout=MESH_TIMEOUT_S)
  except subprocess.TimeoutExpired:
    os.killpg(proc.pid, signal.SIGKILL)
    proc.communicate()
    raise AssertionError(f'{what}: no end in {MESH_TIMEOUT_S} s') from None
  if proc.returncode:
    raise AssertionError(f'{what}: rc {proc.returncode}\n{out[-6000:]}')
  return out


def _mesh_runs(nproc, backend, runs, what, zoo=()):
  """Runs `runs` ((name, bin/train.py argv, deterministic, warmup)) and
  then `zoo` ((name, ``_zoo_mesh_step``'s name, n_in and seed, mesh
  shape)) on nproc ranks of `backend` (None: NCCL) through this script's
  worker mode; returns each run's ranks' results."""
  spec = {'backend': backend, 'runs': [
      {'argv': argv, 'deterministic': det, 'warmup': warmup,
       'out': f'{MESH_DIR}/{name}'} for name, argv, det, warmup in runs] + [
           {'zoo': {'name': model, 'n_in': n_in, 'seed': seed,
                    'mesh': mesh}, 'out': f'{MESH_DIR}/{name}'}
           for name, model, n_in, seed, mesh in zoo]}
  path = f'{MESH_DIR}/{what.replace(" ", "_")}.json'
  with open(path, 'w') as f:
    json.dump(spec, f)
  _run_ranks(nproc, [os.path.abspath(__file__), '--mesh_worker', path], what)
  return {name: [torch.load(f'{MESH_DIR}/{name}.rank{r}.pt',
                            weights_only=True) for r in range(nproc)]
          for name, *_ in (*runs, *zoo)}


def _zoo_mesh_step(name, n_in, seed, dev, mesh=None):
  """One train step of `name` at its script's widths (ZOO_OTHERS) on a
  seeded MESH_ZOO_B x MESH_ZOO_HW batch made on the card, under
  cudnn.deterministic; on a mesh, this rank's share and band. Returns
  (state dict on the CPU, loss, the gradients Adam stepped with (summed
  over the mesh) on the CPU, the kernels' launches)."""
  from hdrnet_torch.config import ModelConfig, TrainConfig
  from hdrnet_torch.models import make_model
  from hdrnet_torch.parallel import mesh as pm
  from hdrnet_torch.training import loop, step
  cfg = ModelConfig(model_name=name, n_in=n_in,
                    output_resolution=list(MESH_ZOO_HW))
  gen = torch.Generator(device=dev).manual_seed(seed)
  b, s = MESH_ZOO_B, cfg.net_input_size
  full = torch.rand((b, *MESH_ZOO_HW, n_in), generator=gen, device=dev)
  low = torch.rand((b, s, s, n_in), generator=gen, device=dev)
  batch = {'lowres_input': low, 'lowres_output': low[..., :3],
           'image_input': full,
           'image_output': (full[..., :3] * 1.3).clamp(0.0, 1.0)}
  model = make_model(cfg, generator=torch.Generator().manual_seed(
      seed)).to(dev)
  pm.replicate(model, mesh)
  state = step.create_state(model, loop.make_optimizer(
      model, TrainConfig(learning_rate=1e-4)))
  share, band = pm.shard_batch(mesh, batch)
  train_step = step.make_train_step(mesh=mesh)
  with _cudnn_deterministic():
    (state, m), counts = _counted(lambda: train_step(state, share, band))
  return ({k: v.cpu() for k, v in model.state_dict().items()},
          float(m['loss']),
          {k: p.grad.cpu() for k, p in model.named_parameters()}, counts)


def _mesh_worker(path):
  """One rank of the mesh phase (``chip_smoke.py --mesh_worker SPEC``,
  under torchrun): joins the process group, runs each of the spec's
  runs (bin/train.py's main with the step clock on, or one
  ``_zoo_mesh_step``) with the launch counts reset before and read after,
  and writes what this rank ended with."""
  import torch.distributed as dist
  from hdrnet_torch.bin import train
  from hdrnet_torch.parallel import mesh as pm
  with open(path) as f:
    spec = json.load(f)
  dev = pm.initialize_distributed(spec['backend'])
  rank = dist.get_rank()
  meshes = {}
  for run in spec['runs']:
    if 'zoo' in run:
      shape = tuple(run['zoo']['mesh'])
      if shape not in meshes:
        meshes[shape] = pm.make_mesh(shape)
      sd, loss, grads, counts = _zoo_mesh_step(run['zoo']['name'],
                                               run['zoo']['n_in'],
                                               run['zoo']['seed'], dev,
                                               meshes[shape])
      result = {'state_dict': sd, 'ema_loss': loss, 'grads': grads,
                'step': 1, 'step_ms': None}
    else:
      guard = (_cudnn_deterministic() if run['deterministic']
               else contextlib.nullcontext())
      with guard, _step_clock() as clock:
        state, counts = _counted(lambda: train.main(run['argv']))
      result = {'state_dict': {k: v.cpu() for k, v in
                               state.model.state_dict().items()},
                'ema_loss': float(state.ema_loss), 'step': state.step,
                'step_ms': _step_ms(clock, run['warmup'])}
    torch.save({**result, 'launches': counts,
                'backend': dist.get_backend()}, f'{run["out"]}.rank{rank}.pt')
  dist.destroy_process_group()
  return 0


def _hold_layout(got, want, what, steps=MESH_STEPS):
  """A mesh run's ranks against each other (bit for bit) and rank 0
  against the (1, 1) run: parameters and statistics to MESH_PARAM_RTOL /
  MESH_PARAM_ATOL. Returns the worst parameter error over its
  tolerance and that parameter's name."""
  for r, res in enumerate(got[1:], 1):
    for k, v in res['state_dict'].items():
      if not torch.equal(v, got[0]['state_dict'][k]):
        raise AssertionError(f'{what}: rank {r} differs from rank 0 at {k}')
  if got[0]['step'] != steps:
    raise AssertionError(f'{what}: step {got[0]["step"]}')
  worst = (0.0, None)
  for k, v in want.items():
    g = got[0]['state_dict'][k]
    err = float(((g - v).abs() / (MESH_PARAM_ATOL + MESH_PARAM_RTOL *
                                  v.abs())).max())
    if not err <= 1.0:
      raise AssertionError(f'{what}: {k} beyond rtol {MESH_PARAM_RTOL} / '
                           f'atol {MESH_PARAM_ATOL} of the (1, 1) run '
                           f'({err:.3f} of it)')
    if err >= worst[0]:
      worst = (err, k)
  return worst


def _hold_mesh_grads(got, want, what):
  """A zoo mesh run's gradients (rank 0's; the ranks' parameters are
  bit-identical) against the (1, 1) run's: MESH_GRAD_REL of each leaf's
  max |g|. Returns the worst error over that max and its parameter."""
  worst = (0.0, None)
  for k, w in want.items():
    err = float((got[0]['grads'][k] - w).abs().max())
    rel = err / max(float(w.abs().max()), 1e-30)
    if not rel <= MESH_GRAD_REL:  # also catches NaN
      raise AssertionError(f'{what}: gradient of {k} {rel:.3e} of its max '
                           f'from the (1, 1) run\'s (> {MESH_GRAD_REL:.0e})')
    if rel >= worst[0]:
      worst = (rel, k)
  return worst


def _mesh_phase(dev, tag, data, slice_launches, gen, full_float32):
  """Mesh training on the card (hdrnet_torch.parallel.mesh): the band
  kernels; the quality workload's model on four gloo ranks at (4, 1),
  (2, 2) twice and (1, 4), and the NN guide at (2, 2), each held to the
  (1, 1) run of this process (no process group) and its ranks to each
  other; the two (2, 2) runs bit for bit under cudnn.deterministic; a
  step on one NCCL rank under torchrun against the step with no process
  group, in turns; bin/train.py itself under torchrun on NCCL. Adds the
  K3/K4/K5 launches to slice_launches; returns the band times."""
  import shutil
  from hdrnet_torch.bin import train
  shutil.rmtree(MESH_DIR, ignore_errors=True)
  os.makedirs(MESH_DIR)
  t_phase = time.perf_counter()
  band_times = _band_kernels(gen, dev, tag, full_float32)

  def argv(name, model, steps, mesh=None):
    return ([f'{MESH_DIR}/{name}', f'{data}/train', *MESH_FLAGS,
             *MESH_MODEL_FLAGS.get(model, []), '--model_name', model,
             '--max_steps', str(steps)]
            + ([] if mesh is None else ['--mesh_shape', *map(str, mesh)]))

  slices = {**MESH_SLICES, **{name: n for name, _, _, n in ZOO_OTHERS}}

  def per_run(model, steps=MESH_STEPS):
    n = steps * slices[model]
    return {k: n for k in ('K3', 'K4', 'K5')} if n else {}

  refs = {}
  with _cudnn_deterministic():
    for model in MESH_SLICES:
      state, counts = _counted(lambda: train.main(argv(f'ref_{model}', model,
                                                       MESH_STEPS)))
      _expect_launches(counts, per_run(model), f'(1, 1) {model}')
      _tally_slice(slice_launches, *(counts[k] for k in ('K3', 'K4', 'K5')))
      refs[model] = ({k: v.cpu() for k, v in
                      state.model.state_dict().items()},
                     float(state.ema_loss))
  zoo = [(f'zoo_{name}', name, n_in, 500 + i, MESH_ZOO_LAYOUT)
         for i, (name, n_in, _, _) in enumerate(ZOO_OTHERS)]
  zoo_grads, grad_worst = {}, {}
  for run, name, n_in, seed, _ in zoo:
    sd, loss, zoo_grads[run], counts = _zoo_mesh_step(name, n_in, seed, dev)
    _expect_launches(counts, per_run(name, 1), f'(1, 1) {name}')
    _tally_slice(slice_launches, *(counts[k] for k in ('K3', 'K4', 'K5')))
    refs[run] = (sd, loss)
  t_ranks = time.perf_counter()
  results = _mesh_runs(4, 'gloo', [
      (name, argv(name, model, MESH_STEPS, mesh), True, MESH_WARMUP)
      for name, model, mesh in MESH_LAYOUTS], 'gloo mesh', zoo)
  t_ranks = time.perf_counter() - t_ranks
  worst, losses = {}, {}
  for name, model, steps in ([(n, m, MESH_STEPS) for n, m, _ in MESH_LAYOUTS]
                             + [(n, m, 1) for n, m, *_ in zoo]):
    got = results[name]
    for r, res in enumerate(got):
      _expect_launches(res['launches'], per_run(model, steps),
                       f'{name} rank {r}')
      _tally_slice(slice_launches,
                   *(res['launches'][k] for k in ('K3', 'K4', 'K5')))
      if res['backend'] != 'gloo':
        raise AssertionError(f'{name}: backend {res["backend"]}')
    want_sd, want_loss = refs[name if steps == 1 else model]
    worst[name] = _hold_layout(got, want_sd, name, steps)
    if name in zoo_grads:
      grad_worst[name] = _hold_mesh_grads(got, zoo_grads[name], name)
    loss = got[0]['ema_loss']
    if not abs(loss - want_loss) <= MESH_LOSS_RTOL * abs(want_loss):
      raise AssertionError(f'{name}: loss {loss} vs the (1, 1) run\'s '
                           f'{want_loss}')
    losses[name] = loss
  a, b = results['curves_2x2'][0], results['curves_2x2_again'][0]
  for k, v in a['state_dict'].items():
    if not torch.equal(v, b['state_dict'][k]):
      raise AssertionError(f'two (2, 2) runs differ at {k}')
  if a['ema_loss'] != b['ema_loss']:
    raise AssertionError('two (2, 2) runs: EMA losses differ')
  step_ms = {name: results[name][0]['step_ms']
             for name in ('curves_2x2_again', 'pyr_2x2', 'pyr_1x4',
                          'fpyr_2x2', 'fpyr_1x4')}
  print(f'mesh training on one card (four gloo ranks; quality_run.sh\'s '
        f'widths and set, 1024^2 b=4, Adam 1e-4 constant, {MESH_STEPS} '
        f'steps, cudnn.deterministic; curves, the NN guide, the pyramid and '
        f'{FPYR} cm 2, the last two with their levels\' halos exchanged; '
        f'then the other {len(zoo)} models one step each at '
        f'{MESH_ZOO_LAYOUT}, {MESH_ZOO_HW[0]}^2 b={MESH_ZOO_B}): every '
        f'layout\'s ranks bit-identical, held to the (1, 1) run of this '
        f'process (params rtol {MESH_PARAM_RTOL:.0e} / atol '
        f'{MESH_PARAM_ATOL:.0e}, worst share of it and its parameter '
        f'{json.dumps({k: [round(v, 4), p] for k, (v, p) in worst.items()})};'
        f' the zoo\'s gradients summed over the mesh, of each leaf\'s max '
        f'|g| (<= {MESH_GRAD_REL:.0e}), worst and its parameter '
        f'{json.dumps({k: [v, p] for k, (v, p) in grad_worst.items()})};'
        f' loss '
        f'(EMA over the runs) rtol {MESH_LOSS_RTOL:.0e}: '
        f'{json.dumps(losses)} vs (1, 1) '
        f'{json.dumps({k: v[1] for k, v in refs.items()})}); the two (2, 2) '
        f'curves runs bit-identical; timing {tag}: gloo steps '
        f'{json.dumps({k: round(v, 4) for k, v in step_ms.items()})} ms '
        f'(host clock, median after {MESH_WARMUP}; gloo reduces through the '
        f'host: no speed figure); the ranks\' launch {t_ranks:.1f} s; '
        f'launches a rank a run: K3, K4, K5 each {MESH_STEPS} x the '
        f'slice-applies of a step {json.dumps(slices)}', flush=True)

  # One NCCL rank under torchrun against no process group, in turns: no
  # group / NCCL / NCCL / no group, the two NCCL runs in one launch.
  def no_group(name):
    with _step_clock() as clock:
      _, counts = _counted(lambda: train.main(argv(name, 'HDRNetCurves',
                                                   TURN_STEPS)))
    return {'launches': counts, 'step_ms': _step_ms(clock, TURN_WARMUP),
            'backend': None}

  first = no_group('turn0')
  nccl = _mesh_runs(1, None, [
      (name, argv(name, 'HDRNetCurves', TURN_STEPS, (1, 1)), False,
       TURN_WARMUP) for name in ('turn1', 'turn2')], 'nccl turns')
  turn_results = [first, nccl['turn1'][0], nccl['turn2'][0],
                  no_group('turn3')]
  for i, res in enumerate(turn_results):
    _expect_launches(res['launches'],
                     {k: TURN_STEPS for k in ('K3', 'K4', 'K5')},
                     f'timing turn {i}')
    _tally_slice(slice_launches,
                 *(res['launches'][k] for k in ('K3', 'K4', 'K5')))
  turns = [res['step_ms'] for res in turn_results]
  backends = [res['backend'] for res in turn_results]
  if backends != [None, 'nccl', 'nccl', None]:
    raise AssertionError(f'torchrun world of one: backends {backends}')
  out = _run_ranks(1, ['-m', 'hdrnet_torch.bin.train',
                       *argv('cli', 'HDRNetCurves', 2, (1, 1))],
                   'torchrun bin/train.py')
  if 'over nccl' not in out or not os.path.isfile(f'{MESH_DIR}/cli/'
                                                  'ckpt_2.pt'):
    raise AssertionError(f'torchrun bin/train.py: no NCCL mesh run or no '
                         f'step-2 checkpoint\n{out[-3000:]}')
  print(f'timing {tag}: quality run step (1024^2 b=4), median of steps '
        f'{TURN_WARMUP + 1}-{TURN_STEPS} (host clock), in turns no process '
        f'group / torchrun NCCL world 1 mesh (1, 1) / NCCL / no group: '
        f'{" / ".join(f"{t:.4f}" for t in turns)} ms; python -m '
        f'torch.distributed.run --nproc_per_node 1 -m hdrnet_torch.bin.train '
        f'--mesh_shape 1 1 trained 2 steps over NCCL; mesh phase '
        f'{time.perf_counter() - t_phase:.1f} s', flush=True)
  shutil.rmtree(MESH_DIR, ignore_errors=True)
  return band_times


def main():
  if not torch.cuda.is_available():
    print('chip_smoke: no CUDA device; this check runs on the GPU only',
          file=sys.stderr)
    return 1
  if sys.argv[1:2] == ['--mesh_worker']:
    return _mesh_worker(sys.argv[2])
  from hdrnet_torch.inference import Enhancer, ModelConfig, full_float32
  from hdrnet_torch.ops import _build, downsample, fused
  from hdrnet_torch.scripts.time_kernels import k2_library
  from hdrnet_torch.utils.timing import graph_ms

  dev = torch.device('cuda', 0)
  gen = torch.Generator(device=dev).manual_seed(1234)

  def frame(b, hw, u8=False):
    x = torch.rand((b, *hw, 3), generator=gen, device=dev)
    return (x * 255).to(torch.uint8) if u8 else x

  # 1. Device.
  smi = _nvidia_smi()
  tag = f'[{smi}]'
  print(f'device: {smi}; torch {torch.__version__}, CUDA '
        f'{torch.version.cuda}, {torch.cuda.get_device_name(0)}, '
        f'{torch.cuda.device_count()} visible', flush=True)

  # 2. Build.
  t0 = time.perf_counter()
  kl = _build.library()
  print(f'build: {kl.seconds:.1f} s nvcc ({time.perf_counter() - t0:.1f} s '
        f'with load) -> {kl.path.name}; ptxas: '
        f'{json.dumps(_ptxas_summary(kl.log))}', flush=True)

  # 3. K2 against its plain version: bit-exact.
  k2_err = 0.0
  for b, hw, u8 in [(1, UHD, False), (1, UHD, True), (2, FHD, False),
                    (2, FHD, True)]:
    x = frame(b, hw, u8)
    got = downsample.nearest_lowres(x, 256)
    want = downsample.nearest_lowres_plain(x, 256)
    if got.shape != (b, 3, 256, 256):
      raise AssertionError(f'K2 shape {tuple(got.shape)}')
    k2_err = max(k2_err, _max_err(got, want, 0.0, f'K2 b={b} {hw} u8={u8}'))
  print(f'K2 nearest_lowres: max abs err {k2_err} vs plain (bit-exact) at 4K '
        f'f32/u8 b=1, 1080p f32/u8 b=2', flush=True)

  # 4. K1 against its plain version, on grids from the default model's
  # seeded backbone.
  enh = Enhancer(ModelConfig(), device=dev, seed=0)
  params = enh.guide_params

  def backbone_grid(x):
    grid = enh._backbone_grid(downsample.nearest_lowres_plain(x, 256))
    b, gh, gw, gd, no, ni = grid.shape
    return grid.reshape(b, gh, gw, gd, no * ni)

  def plain_k1(*args, **kw):
    with full_float32():
      return fused.enhance_fused_plain(*args, **kw)

  x4k = frame(1, UHD)
  g4k = backbone_grid(x4k)
  k1_err = 0.0
  for clip in (False, True):
    got = fused.enhance_fused(g4k, x4k, params, clip_output=clip)
    want = plain_k1(g4k, x4k, params, clip_output=clip)
    k1_err = max(k1_err, _max_err(got, want, K1_TOL, f'K1 4K clip={clip}'))
  in_range = float(((want > 0) & (want < 1)).float().mean())
  x4k8 = frame(1, UHD, u8=True)
  g4k8 = backbone_grid(x4k8)
  u8_stats = []
  for grid in (g4k8, 0.05 * g4k8 + _identity_grid(1, dev)):
    got = fused.enhance_fused(grid, x4k8, params, clip_output=True,
                              u8_output=True)
    want = plain_k1(grid, x4k8, params, clip_output=True, u8_output=True)
    u8_stats.append(_u8_check(got, want, 'K1 4K u8'))
  for b, hw in [(1, (101, 60)), (2, (101, 60)), (2, FHD)]:
    x = frame(b, hw)
    grid = backbone_grid(x)
    got = fused.enhance_fused(grid, x, params, clip_output=True)
    want = plain_k1(grid, x, params, clip_output=True)
    k1_err = max(k1_err, _max_err(got, want, K1_TOL, f'K1 b={b} {hw}'))
  print(f'K1 enhance_fused: max abs err {k1_err:.3e} (<= {K1_TOL:.0e}) at 4K '
        f'f32 clip off/on, 101x60 b=1/2, 1080p b=2; {in_range:.1%} of 4K '
        f'outputs inside (0, 1); u8 (max codes, share differing) backbone '
        f'grid {u8_stats[0]}, near-identity grid {u8_stats[1]}', flush=True)

  # 5. Known answer: an identity grid returns the frame.
  got = fused.enhance_fused(_identity_grid(1, dev), x4k, params)
  id_err = _max_err(got, x4k, IDENTITY_TOL, 'K1 identity grid')
  print(f'known answer: identity grid at 4K, max |out - in| {id_err:.3e} '
        f'(<= {IDENTITY_TOL:.0e})', flush=True)

  # 6. End to end through the entry points a user calls; the launch
  # counters are reset just before and read just after.
  frames = [frame(1, UHD) for _ in range(3)]
  rng = np.random.RandomState(5)
  frames_u8 = [rng.randint(0, 256, (1, *UHD, 3), dtype=np.uint8)
               for _ in range(8)]
  for i, f in enumerate(frames_u8):  # tag each frame: order mistakes show
    f[0, :64, :64] = 30 * i
  torch.cuda.synchronize()
  downsample.launches = fused.launches = 0
  outs = [enh.process(f) for f in frames]
  torch.cuda.synchronize()
  after_process = (downsample.launches, fused.launches)
  outs_u8 = list(enh.stream(frames_u8))
  launches = {'K2': downsample.launches, 'K1': fused.launches}
  if after_process != (3, 3) or launches != {'K2': 11, 'K1': 11}:
    raise AssertionError(f'launches: process {after_process}, after stream '
                         f'{launches}; expected one K2 and one K1 a frame')
  e2e_err = 0.0
  for f, out in zip(frames, outs):
    grid = backbone_grid(f)
    want = plain_k1(grid, f, params, clip_output=True)
    if out.shape != f.shape or not torch.isfinite(out).all():
      raise AssertionError('process output malformed')
    e2e_err = max(e2e_err, _max_err(out, want, K1_TOL, 'process'))
  if len(outs_u8) != len(frames_u8):
    raise AssertionError('stream dropped frames')
  stream_stats = []
  for f, out in zip(frames_u8, outs_u8):
    x = torch.from_numpy(f).to(dev)
    want = plain_k1(backbone_grid(x), x, params, clip_output=True,
                    u8_output=True)
    stream_stats.append(_u8_check(torch.from_numpy(out).to(dev), want,
                                  'stream'))
  print(f'end to end: process x3 at 4K f32 max abs err {e2e_err:.3e} vs the '
        f'plain chain; stream x8 at 4K u8 in order, worst '
        f'{max(stream_stats)}; launches {launches}', flush=True)

  # 7. Timing (CUDA events; host clock for the stream with transfers).
  torch.cuda.reset_peak_memory_stats()
  held_mib = torch.cuda.memory_allocated() / 2 ** 20  # this script's data
  proc_ms = _time_ms(lambda: enh.process(x4k), 50)
  stream_fn = enh.make_stream_fn((1, *UHD, 3))
  x4k8 = torch.from_numpy(frames_u8[0]).to(dev)
  stream_fn_ms = _time_ms(lambda: stream_fn(x4k8), 50)
  t0 = time.perf_counter()
  n_streamed = len(list(enh.stream(frames_u8 * 3)))
  stream_s = time.perf_counter() - t0
  peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
  low = downsample.nearest_lowres(x4k, 256)
  backbone_ms = _time_ms(lambda: enh._backbone_grid(low), 50)
  print(f'timing {tag}: process 4K f32 {proc_ms:.4f} ms/frame '
        f'({1e3 / proc_ms:.1f} fps; backbone alone {backbone_ms:.4f} ms); '
        f'stream fn 4K u8 device-resident {stream_fn_ms:.4f} ms/frame; '
        f'stream() with host transfers {n_streamed / stream_s:.1f} fps '
        f'({n_streamed} frames); peak memory allocated {peak_mib:.1f} MiB, '
        f'{peak_mib - held_mib:.1f} MiB above the {held_mib:.1f} MiB of test '
        f'data held',
        flush=True)
  times = {}
  for name, kernel, plain, args, kw in [
      ('K1 f32', fused.enhance_fused, plain_k1, (g4k, x4k, params),
       {'clip_output': True}),
      ('K1 u8', fused.enhance_fused, plain_k1, (g4k8, x4k8, params),
       {'clip_output': True, 'u8_output': True})]:
    plain_ms = _time_ms(lambda: plain(*args, **kw), 5, warmup=1)
    kernel_ms = _time_ms(lambda: kernel(*args, **kw), 100)
    times[name] = (kernel_ms, plain_ms)
    print(f'timing {tag}: {name} 4K kernel {kernel_ms:.4f} ms, plain '
          f'{plain_ms:.4f} ms', flush=True)
  # K2: its kernel is shorter than an eager call of its wrapper, so events
  # around eager calls time the wrapper. The kernel's time is a CUDA
  # graph's; the wrapper's is its own figure, host microseconds a call.
  # Beside them one aten::index call that computes its f32 function.
  library_ms, k2_host_us = {}, {}
  for name, x in (('K2 f32', x4k), ('K2 u8', x4k8)):
    plain_ms = _time_ms(lambda: downsample.nearest_lowres_plain(x, 256), 5,
                        warmup=1)
    kernel_ms = graph_ms(lambda: downsample.nearest_lowres(x, 256))
    k2_host_us[name] = _host_us(lambda: downsample.nearest_lowres(x, 256))
    times[name] = (kernel_ms, plain_ms)
  library_ms['K2'] = graph_ms(lambda: k2_library(x4k, 256))
  print(f'timing {tag}: K2 4K b=1 kernel (graph) f32 '
        f'{times["K2 f32"][0]:.4f} ms, u8 {times["K2 u8"][0]:.4f} ms; plain '
        f'{times["K2 f32"][1]:.4f} / {times["K2 u8"][1]:.4f} ms; the '
        f'wrapper, host us a call, {k2_host_us["K2 f32"]:.2f} / '
        f'{k2_host_us["K2 u8"]:.2f}; one aten::index call (f32; u8 has '
        f'none: a gather and a division) {library_ms["K2"]:.4f} ms',
        flush=True)

  # 8. K6 against its plain version at 4K: the NN-guide model's gc-16
  # guide (BN folded) and an odd gc, f32 clip off and on, u8, on the
  # model's backbone grid and a near-identity grid.
  nn_enh = _nn_enhancer(Enhancer, NN, dev, seed=1)
  nn_params = nn_enh.guide_params

  def nn_grid(x):
    grid = nn_enh._backbone_grid(downsample.nearest_lowres_plain(x, 256))
    b, gh, gw, gd, no, ni = grid.shape
    return grid.reshape(b, gh, gw, gd, no * ni)

  def plain_k6(*args, **kw):
    with full_float32():
      return fused.enhance_fused_plain(*args, 'nn', **kw)

  odd_gc = 7
  pgen = torch.Generator().manual_seed(9)
  odd_params = fused.pack_nn_params(
      0.8 * torch.randn(4, odd_gc, generator=pgen),
      0.8 * torch.randn(odd_gc + 1, generator=pgen)).to(dev)
  gn4k = nn_grid(x4k)
  k6_err = 0.0
  for p, what in ((nn_params, 'gc 16'), (odd_params, f'gc {odd_gc}')):
    for clip in (False, True):
      got = fused.enhance_fused(gn4k, x4k, p, 'nn', clip_output=clip)
      want = plain_k6(gn4k, x4k, p, clip_output=clip)
      k6_err = max(k6_err, _max_err(got, want, K1_TOL,
                                    f'K6 4K {what} clip={clip}'))
  gn4k8 = nn_grid(x4k8)
  k6_u8 = []
  for grid in (gn4k8, 0.05 * gn4k8 + _identity_grid(1, dev)):
    got = fused.enhance_fused(grid, x4k8, nn_params, 'nn', clip_output=True,
                              u8_output=True)
    want = plain_k6(grid, x4k8, nn_params, clip_output=True, u8_output=True)
    k6_u8.append(_u8_check(got, want, 'K6 4K u8'))
  got = fused.enhance_fused(_identity_grid(1, dev), x4k, nn_params, 'nn')
  k6_id = _max_err(got, x4k, IDENTITY_TOL, 'K6 identity grid')
  with torch.no_grad(), full_float32():
    g = nn_enh.model.guide(x4k)
  print(f'K6 enhance_fused nn: max abs err {k6_err:.3e} (<= {K1_TOL:.0e}) at '
        f'4K f32 clip off/on, gc 16 and {odd_gc}; u8 (max codes, share '
        f'differing) backbone grid {k6_u8[0]}, near-identity grid '
        f'{k6_u8[1]}; identity grid max |out - in| {k6_id:.3e} (<= '
        f'{IDENTITY_TOL:.0e}); gc-16 guide in [{float(g.min()):.4f}, '
        f'{float(g.max()):.4f}], std {float(g.std()):.4f}', flush=True)

  # 9. HDRNetPointwiseNNGuide end to end, counts reset just before.
  torch.cuda.synchronize()
  downsample.launches = fused.launches = fused.nn_launches = 0
  nn_outs = [nn_enh.process(f) for f in frames]
  torch.cuda.synchronize()
  after_process = (downsample.launches, fused.launches, fused.nn_launches)
  nn_outs_u8 = list(nn_enh.stream(frames_u8))
  nn_launches = {'K2': downsample.launches, 'K1': fused.launches,
                 'K6': fused.nn_launches}
  if after_process != (3, 0, 3) or nn_launches != {'K2': 11, 'K1': 0,
                                                   'K6': 11}:
    raise AssertionError(f'{NN} launches: process {after_process}, after '
                         f'stream {nn_launches}; expected one K2 and one K6 '
                         f'a frame')
  with _plain_serving(full_float32):
    want_outs = [nn_enh.process(f) for f in frames]
    want_u8 = list(nn_enh.stream(frames_u8))
  nn_err = 0.0
  for f, out, want in zip(frames, nn_outs, want_outs):
    if out.shape != f.shape or not torch.isfinite(out).all():
      raise AssertionError(f'{NN} process output malformed')
    nn_err = max(nn_err, _max_err(out, want, K1_TOL, f'{NN} process'))
  if len(nn_outs_u8) != len(frames_u8):
    raise AssertionError(f'{NN} stream dropped frames')
  nn_stream = [_u8_check(torch.from_numpy(a), torch.from_numpy(b),
                         f'{NN} stream') for a, b in zip(nn_outs_u8, want_u8)]
  print(f'end to end {NN} (256^2, l8/s16/cm1, gc 16): process x3 at 4K f32 '
        f'max abs err {nn_err:.3e} vs the plain chain; stream x8 at 4K u8 '
        f'in order, worst {max(nn_stream)}; launches {nn_launches}',
        flush=True)

  # 10. HDRNetGaussianPyrNN end to end: K2, the bilinear pyramid
  # 2160x3840 -> 1080x1920 -> 540x960, one K6 a level, upsample-add, clip.
  pyr_enh = _nn_enhancer(Enhancer, PYR, dev, seed=2)
  pyr_frames_u8 = frames_u8[:4]
  torch.cuda.synchronize()
  downsample.launches = fused.launches = fused.nn_launches = 0
  pyr_outs = [pyr_enh.process(f) for f in frames[:2]]
  torch.cuda.synchronize()
  after_process = (downsample.launches, fused.launches, fused.nn_launches)
  pyr_outs_u8 = list(pyr_enh.stream(pyr_frames_u8))
  pyr_launches = {'K2': downsample.launches, 'K1': fused.launches,
                  'K6': fused.nn_launches}
  if after_process != (2, 0, 6) or pyr_launches != {'K2': 6, 'K1': 0,
                                                    'K6': 18}:
    raise AssertionError(f'{PYR} launches: process {after_process}, after '
                         f'stream {pyr_launches}; expected one K2 and three '
                         f'K6 a frame')
  with _plain_serving(full_float32):
    want_outs = [pyr_enh.process(f) for f in frames[:2]]
    want_u8 = list(pyr_enh.stream(pyr_frames_u8))
  pyr_err = 0.0
  for f, out, want in zip(frames, pyr_outs, want_outs):
    if out.shape != f.shape or not torch.isfinite(out).all():
      raise AssertionError(f'{PYR} process output malformed')
    pyr_err = max(pyr_err, _max_err(out, want, K1_TOL, f'{PYR} process'))
  if len(pyr_outs_u8) != len(pyr_frames_u8):
    raise AssertionError(f'{PYR} stream dropped frames')
  pyr_stream = [_u8_check(torch.from_numpy(a), torch.from_numpy(b),
                          f'{PYR} stream')
                for a, b in zip(pyr_outs_u8, want_u8)]
  print(f'end to end {PYR} (256^2, l8/s16/cm1, gc 16, levels 2160x3840 -> '
        f'1080x1920 -> 540x960): process x2 at 4K f32 max abs err '
        f'{pyr_err:.3e} vs the plain chain; stream x4 at 4K u8 in order, '
        f'worst {max(pyr_stream)}; launches {pyr_launches}', flush=True)

  # 11. Timing of K6 and of the two new serving paths.
  for name, args, kw in [
      ('K6 f32', (gn4k, x4k, nn_params), {'clip_output': True}),
      ('K6 u8', (gn4k8, x4k8, nn_params),
       {'clip_output': True, 'u8_output': True})]:
    plain_ms = _time_ms(lambda: plain_k6(*args, **kw), 5, warmup=1)
    kernel_ms = _time_ms(lambda: fused.enhance_fused(*args, 'nn', **kw), 100)
    times[name] = (kernel_ms, plain_ms)
    print(f'timing {tag}: {name} 4K gc 16 kernel {kernel_ms:.4f} ms, plain '
          f'{plain_ms:.4f} ms', flush=True)
  nn_proc_ms = _time_ms(lambda: nn_enh.process(x4k), 30)
  pyr_proc_ms = _time_ms(lambda: pyr_enh.process(x4k), 30)
  print(f'timing {tag}: process 4K f32 {NN} {nn_proc_ms:.4f} ms/frame '
        f'({1e3 / nn_proc_ms:.1f} fps); {PYR} {pyr_proc_ms:.4f} ms/frame '
        f'({1e3 / pyr_proc_ms:.1f} fps)', flush=True)
  del frames, nn_outs, pyr_outs, want_outs
  torch.cuda.empty_cache()

  # 12. K7 against its plain version at 4K: H-bands and a tile, curves
  # (K1) and NN (K6, gc 16), f32 and one u8 band.
  k7_err = _check_k7([(g4k, g4k8, params, 'curves'),
                      (gn4k, gn4k8, nn_params, 'nn')], x4k, x4k8,
                     full_float32)

  # 13. enhance_sharded: one 8K frame in four H-bands on this card, all
  # three models, against process on the same frame (bit for bit) and
  # against the same bands on the plain versions; the counts reset just
  # before each and read just after; then the two timed in turns.
  x8k = frame(1, EIGHT_K)
  low8k = downsample.nearest_lowres(x8k, 256).permute(0, 2, 3, 1)
  bands = [dev] * 4
  k7_launches = 0
  sharded_err = 0.0
  for name, e in (('HDRNetCurves', enh), (NN, nn_enh), (PYR, pyr_enh)):
    want = e.process(x8k)
    torch.cuda.synchronize()
    downsample.launches = fused.launches = fused.nn_launches = 0
    fused.band_launches = 0
    got = e.enhance_sharded(low8k, x8k, bands)
    torch.cuda.synchronize()
    counts = (fused.launches, fused.nn_launches, fused.band_launches)
    k7_launches += fused.band_launches
    expect = {'HDRNetCurves': (4, 0, 4), NN: (0, 4, 4), PYR: (0, 12, 12)}
    if counts != expect[name] or downsample.launches:
      raise AssertionError(f'{name} enhance_sharded launches (K1, K6, K7) '
                           f'{counts}, K2 {downsample.launches}; expected '
                           f'{expect[name]} and no K2')
    if got.shape != x8k.shape or not torch.equal(got, want):
      raise AssertionError(f'{name} enhance_sharded: not bit-identical to '
                           f'process, max diff '
                           f'{float((got - want).abs().max())}')
    with _plain_serving(full_float32):
      want = e.enhance_sharded(low8k, x8k, bands)
    err = _max_err(got, want, K1_TOL, f'{name} enhance_sharded vs plain')
    sharded_err = max(sharded_err, err)
    del got, want

    def sharded():
      low = downsample.nearest_lowres(x8k, 256).permute(0, 2, 3, 1)
      return e.enhance_sharded(low, x8k, bands)
    turns = [_time_ms(lambda: e.process(x8k), 10), _time_ms(sharded, 10),
             _time_ms(sharded, 10), _time_ms(lambda: e.process(x8k), 10)]
    print(f'enhance_sharded {name} at 8K f32 (4320x7680, four bands on '
          f'one card): bit-identical to process; max abs err {err:.3e} (<= '
          f'{K1_TOL:.0e}) vs the plain bands; launches (K1, K6, K7) '
          f'{counts}; timing {tag}, in turns process / sharded / sharded / '
          f'process: {" / ".join(f"{t:.4f}" for t in turns)} ms',
          flush=True)

  # K7's time on the bands counted above: the four 1080-row bands of the
  # 8K frame, each mode in turns with the whole frame in one kernel. The
  # NN mode's (16 of the 20 launches) goes into the kernels line.
  h8 = EIGHT_K[0] // 4
  k7_turns = {}
  for mode, grid8k, p in (('curves', backbone_grid(x8k), params),
                          ('nn', nn_grid(x8k), nn_params)):

    def four_bands(fn, grid8k=grid8k, p=p, mode=mode):
      return lambda: [fn(grid8k, x8k[:, i * h8:(i + 1) * h8], p, mode,
                         clip_output=True, y_offset=i * h8,
                         h_total=EIGHT_K[0]) for i in range(4)]

    def whole(grid8k=grid8k, p=p, mode=mode):
      return fused.enhance_fused(grid8k, x8k, p, mode, clip_output=True)
    k7_turns[mode] = [_time_ms(whole, 50),
                      _time_ms(four_bands(fused.enhance_fused), 50),
                      _time_ms(four_bands(fused.enhance_fused), 50),
                      _time_ms(whole, 50)]
  k7_plain_ms = _time_ms(four_bands(plain_k1), 2, warmup=1)
  times['K7'] = ((k7_turns['nn'][1] + k7_turns['nn'][2]) / 2, k7_plain_ms)
  k7_bound = _fused_bound(grid8k, x8k, nn_params, _nn_guide_ops(
      fused.nn_guide_complexity(nn_params)), reads=4)
  print(f'timing {tag}: K7 four {h8}-row bands of an 8K f32 frame, in turns '
        f'whole frame / bands / bands / whole frame: curves '
        f'{" / ".join(f"{t:.4f}" for t in k7_turns["curves"])} ms; NN gc 16 '
        f'{" / ".join(f"{t:.4f}" for t in k7_turns["nn"])} ms; plain NN '
        f'bands {k7_plain_ms:.4f} ms; bound of the NN bands '
        f'{k7_bound[0]:.4f} ms ({k7_bound[1]})', flush=True)
  # A band of a batch of frames is not contiguous, so enhance_sharded
  # copies it: the cost of the four band copies of a b=2 8K frame.
  x8k2 = frame(2, EIGHT_K)
  h8 = EIGHT_K[0] // 4
  copy_ms = _time_ms(lambda: [x8k2[:, i * h8:(i + 1) * h8].contiguous()
                              for i in range(4)], 10)
  print(f'timing {tag}: the four band copies of a b=2 8K f32 frame '
        f'({_nbytes(x8k2) / 1e6:.1f} MB) {copy_ms:.4f} ms', flush=True)
  del x8k, low8k, x8k2
  torch.cuda.empty_cache()

  # 14. enhance_any through bin/run.py's per-image function: four photo
  # sizes for each model, the counts reset just before and read just
  # after, against the plain chain; then the time of each.
  from hdrnet_torch.bin import run as run_cli
  photos = [frame(1, hw)[0] for hw in PHOTO_SIZES]
  photos[-1] = photos[-1].cpu().numpy()  # a host array, as main reads
  torch.cuda.synchronize()
  downsample.launches = fused.launches = fused.nn_launches = 0
  fused.band_launches = 0
  any_outs = {name: [run_cli.enhance_image(e, p)[0] for p in photos]
              for name, e in (('HDRNetCurves', enh), (NN, nn_enh),
                              (PYR, pyr_enh))}
  torch.cuda.synchronize()
  any_launches = {'K2': downsample.launches, 'K1': fused.launches,
                  'K6': fused.nn_launches, 'K7': fused.band_launches}
  if any_launches != {'K2': 12, 'K1': 4, 'K6': 16, 'K7': 0}:
    raise AssertionError(f'enhance_any launches {any_launches}; expected '
                         f'one K2 a photo, one K1 or K6 a photo (three '
                         f'for the pyramid)')
  any_err, any_ms = 0.0, {}
  for name, e in (('HDRNetCurves', enh), (NN, nn_enh), (PYR, pyr_enh)):
    with _plain_serving(full_float32):
      wants = [run_cli.enhance_image(e, p)[0] for p in photos]
    for hw, got, want in zip(PHOTO_SIZES, any_outs[name], wants):
      if got.shape != (1, *hw, 3) or not torch.isfinite(got).all():
        raise AssertionError(f'{name} enhance_any {hw}: output malformed')
      any_err = max(any_err, _max_err(got, want, K1_TOL,
                                      f'{name} enhance_any {hw}'))
    any_ms[name] = [_time_ms(lambda: run_cli.enhance_image(e, p), 10)
                    for p in photos]
  del any_outs, wants
  print(f'enhance_any through bin/run.py at {PHOTO_SIZES}, three models: '
        f'exact shapes, max abs err {any_err:.3e} (<= {K1_TOL:.0e}) vs the '
        f'plain chain; launches {any_launches}; timing {tag} ms a photo '
        f'(preview, backbone, kernels): {json.dumps(any_ms)}', flush=True)

  # 15. K2g: the JAX row-gather variant's cases on K2's kernel, bit-exact.
  k2g_err = 0.0
  for b, hw, s_out, u8 in [(3, (135, 240), 64, False),
                           (3, (135, 240), 64, True), (4, UHD, 256, False)]:
    x = frame(b, hw, u8)
    k2g_err = max(k2g_err, _max_err(downsample.nearest_lowres(x, s_out),
                                    downsample.nearest_lowres_plain(x, s_out),
                                    0.0, f'K2g b={b} {hw} u8={u8}'))
  x4k_b4 = x
  k2g_ms = graph_ms(lambda: downsample.nearest_lowres(x4k_b4, 256))
  k2g_plain_ms = _time_ms(
      lambda: downsample.nearest_lowres_plain(x4k_b4, 256), 20)
  library_ms['K2g'] = graph_ms(lambda: k2_library(x4k_b4, 256))
  times['K2g'] = (k2g_ms, k2g_plain_ms)
  print(f'K2g (K2 at the gather cases): max abs err {k2g_err} vs plain at '
        f'b=3 135x240 -> 64 f32/u8 and 4K b=4 -> 256 f32; timing {tag}: 4K '
        f'b=4 kernel (graph) {k2g_ms:.4f} ms, plain {k2g_plain_ms:.4f} ms, '
        f'one aten::index call {library_ms["K2g"]:.4f} ms',
        flush=True)
  del x, x4k_b4
  torch.cuda.empty_cache()

  # 16. Training: K3/K4/K5 vs plain, gradients end to end, then the
  # training paths at full width, their counts reset just before each.
  from hdrnet_torch.ops import slice_apply as sa
  train_errs = _check_train_kernels(gen, dev, full_float32)
  _check_model_gradients(dev, full_float32)
  _check_model_gradients(dev, full_float32, PYR)
  # K3/K4/K5 launches on every path that runs them (the kernels line).
  slice_launches = {'K3': 0, 'K4': 0, 'K5': 0}
  step_ms, peak_mib, steady_peak = _train_full_width(dev, tag, Enhancer,
                                                     slice_launches)
  pyr_step_ms, _, pyr_peak = _train_full_width(
      dev, tag, Enhancer, slice_launches, PYR, PYR_TRAIN_STEPS,
      keep=f'{TRIAGE_DIR}/pyr_2048')
  print(f'timing {tag}: {PYR} train step at full width {pyr_step_ms:.4f} ms '
        f'({1e3 / pyr_step_ms:.2f} steps/s, host clock over 20 steps); '
        f'peak memory allocated during those steps {pyr_peak:.1f} MiB',
        flush=True)

  # 17. Training timing: the kernels at 2048^2 b=1 against their plain
  # versions, and their share of a train step.
  g5, guide, image, ct = _train_inputs(gen, 1, TRAIN_HW, 3, dev)
  for name, kernel, plain, args in [
      ('K3', sa.slice_apply_fwd, sa.slice_apply_fwd_plain,
       (g5, guide, image)),
      ('K4', lambda *a: sa.slice_apply_pix_bwd(*a, need_input=False),
       lambda *a: sa.slice_apply_pix_bwd_plain(*a, need_input=False),
       (g5, guide, image, ct)),
      ('K5', lambda *a: sa.slice_apply_grid_bwd(g5.shape, *a),
       lambda *a: sa.slice_apply_grid_bwd_plain(g5.shape, *a),
       (guide, image, ct))]:
    with full_float32():
      plain_ms = _time_ms(lambda: plain(*args), 5, warmup=1)
    kernel_ms = _time_ms(lambda: kernel(*args), 50)
    times[name] = (kernel_ms, plain_ms)
    print(f'timing {tag}: {name} 2048^2 b=1 kernel {kernel_ms:.4f} ms, plain '
          f'{plain_ms:.4f} ms', flush=True)
  slice_levels = _slice_levels(gen, dev, tag)
  share = sum(times[k][0] for k in ('K3', 'K4', 'K5')) / step_ms
  print(f'timing {tag}: train step at full width {step_ms:.4f} ms '
        f'({1e3 / step_ms:.2f} steps/s, host clock over 20 steps); K3+K4+K5 '
        f'{share:.1%} of a step; peak memory allocated during those steps '
        f'{steady_peak:.1f} MiB', flush=True)

  # 18. K2x, the export tool and fit_grid.
  k2x_launches, k2x_err, k2x_times, k2x_bound, k2x_floors = _check_k2x(
      dev, tag)
  times['K2x'] = (k2x_times[1]['gather'], k2x_times[1]['plain_gather'])
  library_ms['K2x'] = k2x_times[1]['library']
  _check_export(dev, tag, gen, slice_launches)
  _check_fit_grid(dev, tag, slice_launches)

  # 19. The extended zoo and the baselines: train_fpyrnn3_cm2.sh's model
  # trained at full width and served at 4K through the composite route
  # (K3/K4/K5 at n_in 8, C = 27), the other new models one step and one
  # 1080p frame each, then K3/K4/K5 timed at the fpyrnn3_cm2 shapes; the
  # counts reset just before each path and read just after.
  zoo_cfg, zoo_weights, _ = _zoo_train_full_width(dev, tag, slice_launches,
                                                  full_float32)
  _zoo_serve_4k(dev, tag, zoo_cfg, zoo_weights, slice_launches,
                full_float32)
  del zoo_weights
  torch.cuda.empty_cache()
  _zoo_others(dev, tag, slice_launches, full_float32)
  zoo_levels = _zoo_slice_levels(gen, dev, tag, full_float32)

  # 20. The bfloat16 coefficient backbone on the fused route.
  _bf16_serving(dev, tag, x4k)
  torch.cuda.empty_cache()

  # 21. The quality workload (scripts/ll/quality_run.sh) on the card: the
  # dataset built there, training from device memory, evaluate and
  # fit_grid; the usm and style-transfer workloads. Its evaluate calls
  # add to the K1 row.
  quality = _quality_workload(dev, tag, slice_launches, full_float32)
  launches['K1'] += quality

  # 22. Mesh training on the quality workload's set: the band kernels,
  # four gloo ranks on the card, one NCCL rank under torchrun.
  band_times = _mesh_phase(dev, tag, f'{QUALITY_DIR}/data_ll',
                           slice_launches, gen, full_float32)

  # 23. The quality-triage tools on the pyramid checkpoint of phase 16,
  # over the quality set's test images.
  _triage_tools(dev, tag, f'{TRIAGE_DIR}/pyr_2048',
                f'{QUALITY_DIR}/data_ll/test', slice_launches)
  import shutil
  shutil.rmtree(QUALITY_DIR, ignore_errors=True)

  # 24. The native deployment path: AOTInductor packages served by the C++
  # runner, whose op library launches K1, K2, K3 and K6 (and calls the
  # bilinear resize); its counts start at 0 in the runner's process and
  # are read from its report.
  native = _native_serving(dev, tag)
  launches['K1'] += native['K1']
  launches['K2'] += native['K2']
  _tally_slice(slice_launches, native['K3'])
  print(f'K3/K4/K5 launches on the paths (train steps, evaluate, export, '
        f'fit_grid, the zoo\'s steps and frames, the quality, usm and '
        f'style-transfer workloads, the mesh runs of every rank, the triage '
        f'tools, the native runner): {slice_launches}; K1 and K2 with the quality run\'s '
        f'evaluate (K1 only) and the native runner: {launches}', flush=True)

  # The least time each kernel could take at the shapes it was timed at.
  k1_bound = _fused_bound(g4k, x4k, params, CURVES_GUIDE_OPS)
  gc = fused.nn_guide_complexity(nn_params)
  k6_bound = _fused_bound(gn4k, x4k, nn_params, _nn_guide_ops(gc))
  bounds = {
      'K1': k1_bound, 'K6': k6_bound, 'K7': k7_bound,
      # K2 reads only the sampled pixels and writes the preview.
      'K2': _bound(3 * 256 * 256 * (4 + 4) + 2 * 256 * 4, 0),
      # K2x computes K2's function: its bound is K2's work at 4K b=1. The
      # floor of its own formulation (rows='gather': the sampled rows read
      # whole, the one-hot products) goes beside it.
      'K2x': (k2x_bound[1], 'bytes'),
      'K2g': _bound(4 * 3 * 256 * 256 * (4 + 4) + 2 * 256 * 4, 0),
      # K3, K4 (d_guide only, as timed) and K5 at 2048^2.
      **_slice_bounds(TRAIN_HW[0], tuple(g5.shape)),
  }
  rows = [
      ('K1', 'K1 enhance_fused (curves guide + slice + apply)',
       'hdrnet_torch/csrc/fused_slice_apply.cu',
       'hdrnet_tpu/ops/pallas.py:635', launches['K1'], k1_err, 'K1 f32'),
      ('K6', 'K6 enhance_fused nn (NN guide + slice + apply)',
       'hdrnet_torch/csrc/fused_slice_apply.cu',
       'hdrnet_tpu/ops/pallas.py:529',
       nn_launches['K6'] + pyr_launches['K6'] + native['K6'], k6_err,
       'K6 f32'),
      ('K7', 'K7 enhance_fused band (offset and total extent of K1/K6; '
       'timed on four 1080-row NN gc-16 bands of an 8K frame)',
       'hdrnet_torch/csrc/fused_slice_apply.cu',
       'hdrnet_tpu/ops/pallas.py:446', k7_launches,
       max(k7_err, sharded_err), 'K7'),
      ('K2', 'K2 nearest_lowres (preview downsample; ms in a CUDA graph, '
       '4K b=1 f32)',
       'hdrnet_torch/csrc/downsample.cu', 'hdrnet_tpu/ops/downsample.py:75',
       launches['K2'], k2_err, 'K2 f32'),
      ('K2g', 'K2g nearest_lowres gather variant (K2\'s kernel; ms in a '
       'CUDA graph, 4K b=4 f32)',
       'hdrnet_torch/csrc/downsample.cu',
       'hdrnet_tpu/ops/downsample.py:177', any_launches['K2'], k2g_err,
       'K2g'),
      ('K2x', 'K2x nearest_lowres_onehot (one-hot bf16 products on the '
       'tensor cores; ms in a CUDA graph, rows=\'gather\' at 4K b=1, '
       'rows=\'mma\' and b=4 in its phase line and under "graph_ms")',
       'hdrnet_torch/csrc/downsample_onehot.cu',
       'scripts/exp_downsample_v2.py:102', k2x_launches, k2x_err, 'K2x'),
      ('K3', 'K3 slice_apply_fwd (slice + apply, external guide; at 3 -> 3 '
       'K1\'s kernel with the guide loaded)',
       'hdrnet_torch/csrc/slice_apply.cu', 'hdrnet_tpu/ops/pallas.py:570',
       slice_launches['K3'], train_errs['K3'], 'K3'),
      ('K4', 'K4 slice_apply_pix_bwd (guide and input cotangents; timed '
       'with the guide\'s only, as the HDRNet models\' training runs it; '
       'the fpyrnn3_cm2 levels with both, as the feature models\' does)',
       'hdrnet_torch/csrc/slice_apply.cu', 'hdrnet_tpu/ops/pallas.py:694',
       slice_launches['K4'], train_errs['K4'], 'K4'),
      ('K5', 'K5 slice_apply_grid_bwd (grid cotangent, deterministic)',
       'hdrnet_torch/csrc/slice_apply.cu', 'hdrnet_tpu/ops/pallas.py:757',
       slice_launches['K5'], train_errs['K5'], 'K5'),
  ]
  # One aten::index call with the floor tables computes K2's f32 function
  # (K2g's, and K2x's on the channel-first frame): its graph time is their
  # library_ms. No single PyTorch call computes the others: grid_sample
  # has no smoothed depth tent, interpolate another nearest table.
  kernels = [{'name': name, 'route': 'cuda', 'source': source,
              'replaces': replaces, 'launches': n, 'max_abs_err': err,
              'ms': times[key][0], 'plain_ms': times[key][1],
              'bound_ms': bounds[kid][0], 'bound_by': bounds[kid][1],
              'library_ms': library_ms.get(kid)}
             for kid, name, source, replaces, n, err, key in rows]
  kernels[[r[0] for r in rows].index('K2')].update(
      library='aten::index, frame.permute(0, 3, 1, 2)[:, :, iy[:, None], '
      'ix], at f32; u8 has no single call (a gather and a division)',
      wrapper_host_us=k2_host_us)
  kernels[[r[0] for r in rows].index('K2g')]['library'] = (
      'aten::index, as K2, at 4K b=4 f32')
  kernels[[r[0] for r in rows].index('K2x')]['library'] = (
      'aten::index, frame_cf[:, :, iy[:, None], ix], 4K b=1')
  for kid in ('K3', 'K4', 'K5'):
    kernels[[r[0] for r in rows].index(kid)]['levels'] = {
        **slice_levels[kid], **zoo_levels[kid]}
    kernels[[r[0] for r in rows].index(kid)]['bands'] = {
        label: kt[kid] for label, kt in band_times.items()}
  kernels[[r[0] for r in rows].index('K2x')]['formulation_floor_ms'] = {
      f'{r} b={b}': k2x_floors[b, r][0] for b in (1, 4)
      for r in ('gather', 'mma')}
  kernels[[r[0] for r in rows].index('K2x')]['graph_ms'] = {
      f'{r} b={b}': k2x_times[b][r] for b in (1, 4)
      for r in ('gather', 'mma')}
  print(smi)
  print(json.dumps({'kernels': kernels}))
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}))
  return 0


if __name__ == '__main__':
  sys.exit(main())
