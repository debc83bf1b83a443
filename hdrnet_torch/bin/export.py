#!/usr/bin/env python
"""Export a trained model of the port for deployment (counterpart of
``hdrnet_tpu.bin.export``; reference: bin/freeze_graph.py and
bin/scripts/optimize_graph.sh).

Each function is traced by ``torch.export`` with the checkpoint's
weights and saved with ``torch.export.save`` as ``<name>.pt2``, beside a
``<name>.manifest.json`` with its input and output shapes and dtypes.
The graphs call the port's kernels as the registered ``hdrnet::`` ops
(``hdrnet_torch.ops``), so a reloaded graph runs the same kernels as the
eager ``Enhancer``. Produces in the output directory:

  * ``coefficients_fn`` -- lowres (1, S, S, n_in) -> the packed grid in
    the reference's deployment layout (c, gd, gh, gw)
    (freeze_graph.py:69-75); not for a model with no top-level grid (the
    baselines, ``HDRNetStack``);
  * ``enhance_fn`` -- (lowres, fullres) -> the model's forward, clipped;
  * ``serve_fn`` -- (lowres, fullres) -> the fused serving path
    (``Enhancer.__call__``), for the models of the fused route only;
  * ``stream_fn`` -- a uint8 (1, H, W, n_in) frame -> uint8, preview
    downsample, enhancement and requantization on the device
    (``Enhancer.make_stream_fn``);
  * ``serve_any_fn`` -- ``serve_fn`` with H and W as ``torch.export.Dim``s
    (``MIN_SIDE`` to ``MAX_SIDE``): one graph serves every frame size (the
    JAX package's padded bucket with a traced true size); the fused route
    only;
  * ``guide_*.bin`` -- the guide parameters as raw little-endian float32,
    byte for byte the JAX package's dumps (batch norm folded into conv1
    for the NN guides, freeze_graph.py:127-184), for the reference
    renderer (benchmark/src/renderer.cc:197-224).

A manifest writes a dynamic dimension as its ``Dim``'s name and records
its range under ``"dims"`` (``{"H": {"min": 8, "max": 16384}}``, the
exported program's range constraints).

With ``--aoti``, every graph is also compiled ahead of time by
AOTInductor (``torch._inductor.aoti_compile_and_package``, for
``--device``, under ``full_float32()``) into ``<name>.aoti.pt2``, which
the native runner ``hdrnet_torch/native/aoti_serve.cc`` serves with no
Python in the process: the port's counterpart of the ``.mlir``
StableHLO and ``compile_options.pb`` that the JAX export writes for its
``pjrt_serve``. The manifest records the package and its device under
``"aoti"``. ``serve_any_fn``'s package keeps H and W dynamic (the runner
binds them with ``--dim H=.. --dim W=..``, one size a run). A package
names the ``hdrnet::`` ops its graph calls, and the runner finds them
registered in C++ by its op library (``native/hdrnet_ops.cc`` and
``native/resize_op.cc``): ``nearest_lowres``, ``enhance_fused``,
``slice_apply_fwd`` and ``resize_bilinear``, which the pyramid and the
multiscale zoo models call.

A graph does not carry torch's TF32 switches, and torch's default runs
float32 cuDNN convolutions in TF32 (``cudnn.allow_tf32 = True``), which
moves the grid by ~1e-3 and the output about gd-fold more. So each
manifest records the precision the graph must run at, under
``"precision"``: ``{"cudnn_allow_tf32": false, "matmul_allow_tf32":
false}``, the switches the Enhancer runs under (``full_float32``). To run
an artifact: ``import hdrnet_torch.ops`` (which registers the ops),
``torch.export.load(path).module()``, and call it with gradients off and
the manifest's switches set. ``load_artifact`` does all three.

  python -m hdrnet_torch.bin.export ckpt/ [--output_dir out/]
      [--fullres 1080 1920] [--device cuda] [--aoti]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os

import numpy as np
import torch

import hdrnet_torch.ops  # noqa: F401  (registers the hdrnet:: ops)
from hdrnet_torch import native
from hdrnet_torch.inference import Enhancer, full_float32
from hdrnet_torch.models import require_top_level_grid
from hdrnet_torch.models.layers import BN_EPS

log = logging.getLogger('hdrnet_torch.export')

# The frame heights and widths serve_any_fn takes (the pyramid halves
# the frame twice).
MIN_SIDE, MAX_SIDE = 8, 16384
# The TF32 switches every graph must run with: full float32, as
# inference.full_float32 sets them.
PRECISION = {'cudnn_allow_tf32': False, 'matmul_allow_tf32': False}


def _save_bin(arr, path):
  np.ascontiguousarray(arr, dtype='<f4').tofile(path)
  log.info('wrote %s %s', path, tuple(np.asarray(arr).shape))


def _np(t):
  return t.detach().cpu().numpy()


def dump_guide_params(state_dict, model_name, out_dir):
  """Raw .bin guide dumps of a port ``state_dict``, computed in numpy as
  ``hdrnet_tpu.bin.export.dump_guide_params`` computes them from the Flax
  variables (freeze_graph.py:106-184 layouts), so the bytes are the same.
  """
  sd = {k: _np(v) for k, v in state_dict.items()}
  if model_name == 'HDRNetCurves':
    ccm34 = np.vstack([sd['guide.ccm'], sd['guide.ccm_bias'][None, :]])
    _save_bin(ccm34.T, os.path.join(out_dir, 'guide_ccm_f32_3x4.bin'))
    # The reference stores (npts, nchans), the transpose of its squeezed
    # (1, 1, nchans, npts) variables; these are (nchans, npts).
    _save_bin(sd['guide.shifts'],
              os.path.join(out_dir, 'guide_shifts_f32_16x3.bin'))
    _save_bin(sd['guide.slopes'],
              os.path.join(out_dir, 'guide_slopes_f32_16x3.bin'))
    mix = np.append(sd['guide.channel_mixing_w'].ravel(),
                    sd['guide.channel_mixing_b'].ravel())
    _save_bin(mix, os.path.join(out_dir, 'guide_mix_matrix_f32_1x4.bin'))
    return

  def dump_nn_guide(key, prefix):
    # Fold the center-only BN into conv1: w' = w / sqrt(var + eps),
    # b' = beta - mean / sqrt(var + eps) (freeze_graph.py:141-142). The
    # conv kernels OIHW -> the Flax HWIO, squeezed: (n_in, gc) and (gc,).
    w = np.squeeze(sd[f'{key}.conv1.conv.weight'].transpose(2, 3, 1, 0))
    beta = sd[f'{key}.conv1.bn.bias']
    mean = sd[f'{key}.conv1.bn.running_mean']
    var = sd[f'{key}.conv1.bn.running_var']
    scale = 1.0 / np.sqrt(var + BN_EPS)
    w = w * scale
    b = beta - mean * scale
    conv1 = np.vstack([w, b[None, :]])
    _save_bin(conv1.T, os.path.join(out_dir, f'{prefix}conv1.bin'))
    w2 = np.squeeze(sd[f'{key}.conv2.conv.weight'].transpose(2, 3, 1, 0))
    b2 = sd[f'{key}.conv2.conv.bias'].ravel()
    _save_bin(np.append(w2, b2), os.path.join(out_dir, f'{prefix}conv2.bin'))

  if model_name == 'HDRNetPointwiseNNGuide':
    dump_nn_guide('guide', 'guide_')
  elif model_name == 'HDRNetGaussianPyrNN':
    for lvl in range(3):
      dump_nn_guide(f'guide_level_{lvl}', f'guide_level{lvl}_')
  else:
    log.info('no guide dump defined for %s', model_name)


class _Function(torch.nn.Module):
  """One function of the Enhancer as a module for ``torch.export``; the
  model is a submodule, so its weights are the program's parameters."""

  def __init__(self, enh, fn):
    super().__init__()
    self.model = enh.model
    self.fn = fn

  def forward(self, *args):
    return self.fn(*args)


def coefficients_function(enh):
  """lowres (1, S, S, n_in) -> the packed grid in the deployment layout
  (c, gd, gh, gw) (freeze_graph.py:69-75); ValueError, with the reason,
  for a model with no top-level grid."""
  require_top_level_grid(enh.model, 'coefficients_fn exports the grid')

  def coefficients_fn(lowres):
    grid = enh._backbone_grid(lowres.permute(0, 3, 1, 2))
    b, gh, gw, gd, no, ni = grid.shape
    packed = grid.reshape(b, gh, gw, gd, no * ni)[0]
    # (gh, gw, gd, c) -> (c, gd, gh, gw).
    return packed.permute(3, 2, 0, 1)
  return coefficients_fn


def serving_functions(enh, fullres):
  """{name: (function, example inputs, dynamic shapes or None)} of the
  Enhancer `enh`, with a full resolution of `fullres` (H, W).
  ``enhance_fn`` and ``stream_fn`` for every model; ``coefficients_fn``
  for a model with a top-level grid; ``serve_fn`` and ``serve_any_fn``
  on the fused route only (elsewhere they would be ``enhance_fn``), as
  the JAX export writes them. What is left out is logged."""
  cfg = enh.model_cfg
  s, n_in = cfg.net_input_size, cfg.n_in
  h, w = fullres
  dev = enh.device
  low = torch.zeros((1, s, s, n_in), device=dev)
  full = torch.zeros((1, h, w, n_in), device=dev)
  full_u8 = torch.zeros((1, h, w, n_in), dtype=torch.uint8, device=dev)

  def enhance_fn(lowres, fullres):
    return enh._composite_forward(lowres, fullres, clip=True)

  def serve_fn(lowres, fullres):
    return enh(lowres, fullres, clip=True)

  fns = {}
  try:
    fns['coefficients_fn'] = (coefficients_function(enh), (low,), None)
  except ValueError as e:
    log.info('coefficients_fn not written: %s', e)
  fns['enhance_fn'] = (enhance_fn, (low, full), None)
  fns['stream_fn'] = (enh.make_stream_fn((1, h, w, n_in)), (full_u8,), None)
  if enh.fused:
    side = dict(min=MIN_SIDE, max=MAX_SIDE)
    any_hw = {1: torch.export.Dim('H', **side),
              2: torch.export.Dim('W', **side)}
    fns['serve_fn'] = (serve_fn, (low, full), None)
    fns['serve_any_fn'] = (serve_fn, (low, full), (None, any_hw))
  else:
    log.info('%s is served by the composite route: no fused serving '
             'function, serve_fn and serve_any_fn not written',
             type(enh.model).__name__)
  return fns


def _avals(nodes, names):
  """[{shape, dtype}] of graph nodes; a symbolic dimension is written as
  the name of its ``Dim``."""
  return [{'shape': [d if isinstance(d, int) else names.get(str(d), str(d))
                     for d in n.meta['val'].shape],
           'dtype': str(n.meta['val'].dtype).replace('torch.', '')}
          for n in nodes]


def aoti_package(program, name, out_dir, device):
  """Compiles `program` with AOTInductor for `device` under full float32
  into ``<name>.aoti.pt2``; returns the manifest's ``"aoti"`` record."""
  from torch._inductor import aoti_compile_and_package, config
  path = os.path.join(out_dir, f'{name}.aoti.pt2')
  # Inductor builds the package's C++ wrapper with OpenMP: with the g++
  # that builds the native runner, not a compiler named by CXX that may
  # lack OpenMP.
  with full_float32(), config.patch({'cpp.cxx': (None, native.cxx())}):
    aoti_compile_and_package(program, package_path=path)
  return {'package': os.path.basename(path),
          'device': torch.device(device).type}


def export_function(enh, name, fn, example, dynamic, out_dir, aoti=False):
  """Traces `fn` on `example`, saves ``<name>.pt2`` and its manifest (with
  `aoti`, also ``<name>.aoti.pt2``); returns the ExportedProgram."""
  module = _Function(enh, fn).eval()
  with torch.no_grad():
    # The module takes *args: its dynamic shapes nest one level deeper.
    program = torch.export.export(
        module, example,
        dynamic_shapes=None if dynamic is None else (dynamic,))
  path = os.path.join(out_dir, f'{name}.pt2')
  torch.export.save(program, path)
  graph = program.graph
  inputs = [n for n in graph.nodes if n.op == 'placeholder'
            and n.name in program.graph_signature.user_inputs]
  names = {}
  for node, spec in zip(inputs, dynamic or ()):
    for axis, dim in (spec or {}).items():
      names[str(node.meta['val'].shape[axis])] = dim.__name__
  manifest = {'name': name, 'inputs': _avals(inputs, names),
              'outputs': _avals(graph.output_node().args[0], names)}
  if names:
    manifest['dims'] = {names[str(sym)]: {'min': int(r.lower),
                                          'max': int(r.upper)}
                        for sym, r in program.range_constraints.items()
                        if str(sym) in names}
  manifest['precision'] = PRECISION
  if aoti:
    manifest['aoti'] = aoti_package(program, name, out_dir, enh.device)
  with open(os.path.join(out_dir, f'{name}.manifest.json'), 'w') as f:
    json.dump(manifest, f, indent=2)
  log.info('wrote %s{.pt2,%s.manifest.json} (out %s)',
           os.path.join(out_dir, name),
           '.aoti.pt2,' if 'aoti' in manifest else '', manifest['outputs'])
  return program


def hdrnet_ops(program):
  """The ``hdrnet::`` ops a program's graph calls, by name."""
  return sorted({str(n.target) for n in program.graph.nodes
                 if n.op == 'call_function'
                 and str(n.target).startswith('hdrnet.')})


@contextlib.contextmanager
def _precision(switches):
  """torch's TF32 switches set to a manifest's ``precision`` inside the
  block, restored after it."""
  saved = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
  torch.backends.cudnn.allow_tf32 = switches['cudnn_allow_tf32']
  torch.backends.cuda.matmul.allow_tf32 = switches['matmul_allow_tf32']
  try:
    yield
  finally:
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved


def load_artifact(path):
  """A saved artifact as a function: the graph's module, called with
  gradients off and the TF32 switches its manifest records (beside it, as
  ``<name>.manifest.json``)."""
  manifest_path = os.path.splitext(path)[0] + '.manifest.json'
  with open(manifest_path) as f:
    manifest = json.load(f)
  if 'precision' not in manifest:
    raise ValueError(f'{manifest_path} records no precision')
  switches = manifest['precision']
  module = torch.export.load(path).module()

  def run(*args):
    with torch.no_grad(), _precision(switches):
      return module(*args)
  return run


def main(argv=None):
  logging.basicConfig(
      format='%(asctime)s [%(process)d] %(levelname)s %(filename)s:'
             '%(lineno)s | %(message)s', level=logging.INFO)
  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument('checkpoint_dir')
  parser.add_argument('--output_dir', default=None,
                      help='defaults to checkpoint_dir')
  parser.add_argument('--fullres', type=int, nargs=2, default=[1080, 1920],
                      help='static full resolution of enhance_fn, serve_fn '
                           'and stream_fn (serve_any_fn is traced at it)')
  parser.add_argument('--device', default='cuda',
                      help="torch device the graphs run on ('cpu' for the "
                           'plain versions of the kernels)')
  parser.add_argument('--aoti', action='store_true',
                      help='also compile each graph with AOTInductor into '
                           '<name>.aoti.pt2 for the native runner '
                           '(hdrnet_torch/native)')
  args = parser.parse_args(argv)
  out_dir = args.output_dir or args.checkpoint_dir
  os.makedirs(out_dir, exist_ok=True)

  enh = Enhancer.from_checkpoint(args.checkpoint_dir, device=args.device)
  programs = {}
  for name, (fn, example, dynamic) in serving_functions(
      enh, args.fullres).items():
    programs[name] = export_function(enh, name, fn, example, dynamic,
                                     out_dir, aoti=args.aoti)
    log.info('%s calls %s', name, hdrnet_ops(programs[name]))
  dump_guide_params(enh.model.state_dict(), enh.model_cfg.model_name,
                    out_dir)
  return programs


if __name__ == '__main__':
  main()
