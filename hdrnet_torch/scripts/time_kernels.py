#!/usr/bin/env python
"""Times this tree's K3, K4, K5, fused K1/K6/K7 and preview K2/K2x
kernels in turns with a baseline tree's, on one CUDA card, at the shapes
the port's paths run.

  python -m hdrnet_torch.scripts.time_kernels --baseline_csrc DIR \
      [--cases slice fused downsample]

DIR is another checkout's ``hdrnet_torch/csrc`` (for example the parent
commit unpacked with ``git archive`` into the gitignored ``build/``); it
is built beside this tree's kernels into ``build/hdrnet_torch_baseline``.
Both libraries are called through their C launchers, with the same
inputs, in turns baseline / this tree / this tree / baseline. A turn is
the device time a call of a CUDA graph holding ``ITERS`` calls (graph
replay: no host gaps between launches), timed with CUDA events. Both
trees must export this tree's launchers (``_build._SIGNATURES``).

Cases, each at 2048^2, 1024^2 and 512^2, b=1 (the curves step and the
pyramid's three levels), with a 16x16x8 grid: K3 at n_in = n_out = 3,
at n_in = 0 (the plain slice of C = 12 channels) and at n_in = 8 (C =
27); K4 at 3 -> 3 with the guide cotangent only (the training path) and
with the input's too, at n_in = 0 (C = 12) and at n_in = 8 with both;
K5 at 3 -> 3. Then K1 (curves guide) and K6 (NN guide, gc 16) at 4K
b=1, f32 -> f32 clipped and u8 -> u8; K7, the four 1080-row bands of an
8K f32 frame in each mode. The preview (``downsample``): K2 at 4K b=1
and K2g (K2's kernel at b=4), f32 and u8, and K2x in both row modes
(v1 ``gather``, v2 ``mma``) on the channel-first 4K frame at b=1 and
b=4, each to a 256^2 preview; beside each f32 case the device time of
its one-PyTorch-call yardstick (``k2_library``, ``k2x_library``: one
``aten::index`` with the floor tables; u8 has none, as it needs a gather
and a division), timed the same way, and the host microseconds a call
of the eager ``nearest_lowres`` wrapper at 4K, this tree's in turns with
the baseline tree's ``hdrnet_torch/ops/downsample.py`` where DIR has one
beside it (both launch this tree's kernel: the difference is the
wrapper's own host work).
Each case also reports the largest difference between the two trees'
outputs. ``--cases`` picks the groups (all three by default). Prints the
card's name and power limit, then one JSON object.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import importlib.util
import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from hdrnet_torch.ops import _build
from hdrnet_torch.ops import reference as ref
from hdrnet_torch.ops.resize import nearest_index_tensor
from hdrnet_torch.utils.timing import graph_ms

ITERS = 20
UHD = (2160, 3840)
EIGHT_K = (4320, 7680)
SIZES = (2048, 1024, 512)
GRID = (16, 16, 8)
PREVIEW = 256
CASES = ('slice', 'fused', 'downsample')

_FUSED = ('hdrnet_enhance_fused', 'hdrnet_enhance_fused_nn')


def load(csrc, build_root):
  """The kernels of `csrc` built into `build_root`."""
  return _build.load_library(csrc, build_root).lib


def _stream():
  return torch.cuda.current_stream().cuda_stream


def k5_call(lib, guide, image, ct, grid_shape):
  """A function that launches `lib`'s K5 once on these inputs (scratch
  and output allocated once, outside), and the output tensor."""
  b, h, w = guide.shape
  _, gh, gw, gd, c = grid_shape
  n_in, n_out = image.shape[-1], ct.shape[-1]
  pad_y, pad_x = ref.pad_amounts(h, w, gh, gw)
  out = torch.empty(grid_shape, device=guide.device)
  dims = (b, h, w, gh, gw, gd, n_in, n_out, 1, 0, h, gh / h, gw / w, pad_y,
          pad_x)
  ptrs = (guide.data_ptr(), image.data_ptr(), ct.data_ptr())
  strips, floats = ctypes.c_int(), ctypes.c_longlong()
  lib.hdrnet_slice_apply_grid_bwd_plan(b, h, gh, gw, gd, c, 0, h, pad_y,
                                       ctypes.byref(strips),
                                       ctypes.byref(floats))
  scratch = torch.empty((floats.value,), device=guide.device)

  def call():
    _build.check(lib.hdrnet_slice_apply_grid_bwd(
        *ptrs, scratch.data_ptr(), out.data_ptr(), *dims, strips.value,
        _stream()), 'K5')
  call.scratch_bytes = floats.value * 4
  return call, out


def k3_call(lib, grid, guide, image):
  """A function that launches `lib`'s K3 once (output allocated once),
  and the output."""
  b, h, w = guide.shape
  _, gh, gw, gd, c = grid.shape
  n_in = image.shape[-1]
  n_out = c // (n_in + 1)
  out = torch.empty((b, h, w, n_out), device=guide.device)
  args = (grid.data_ptr(), guide.data_ptr(), image.data_ptr(),
          out.data_ptr(), b, h, w, gh, gw, gd, n_in, n_out, 1, 0, h, gh / h,
          gw / w)

  def call():
    _build.check(lib.hdrnet_slice_apply_fwd(*args, _stream()), 'K3')
  return call, out


def k4_call(lib, grid, guide, image, ct, need_input):
  """A function that launches `lib`'s K4 once, and its outputs: (d_guide,)
  or (d_guide, d_image)."""
  b, h, w = guide.shape
  _, gh, gw, gd, _ = grid.shape
  n_in, n_out = image.shape[-1], ct.shape[-1]
  d_guide = torch.empty((b, h, w), device=guide.device)
  d_image = (torch.empty((b, h, w, n_in), device=guide.device)
             if need_input else None)
  args = (grid.data_ptr(), guide.data_ptr(), image.data_ptr(), ct.data_ptr(),
          d_guide.data_ptr(), None if d_image is None else d_image.data_ptr(),
          b, h, w, gh, gw, gd, n_in, n_out, 1, 0, h, gh / h, gw / w)

  def call():
    _build.check(lib.hdrnet_slice_apply_pix_bwd(*args, _stream()), 'K4')
  return call, (d_guide,) if d_image is None else (d_guide, d_image)


def fused_call(lib, grid, frame, params, mode, u8_out, bands=1):
  """A function that launches `lib`'s K1 (curves) or K6 (nn) on the frame,
  or on its `bands` H-bands with K7's offsets, and the output."""
  b, h, w, _ = frame.shape
  _, gh, gw, gd, _ = grid.shape
  out = torch.empty(frame.shape, device=frame.device,
                    dtype=torch.uint8 if u8_out else torch.float32)
  u8_in = int(frame.dtype == torch.uint8)
  hb = h // bands
  gc = (params.numel() - 1) // 5
  launches = []
  for i in range(bands):
    band, out_band = frame[:, i * hb:(i + 1) * hb], out[:, i * hb:(i + 1) * hb]
    geo = (b, hb, w, gh, gw, gd, i * hb, 0, h, w, gh / h, gw / w)
    if mode == 'curves':
      args = (grid.data_ptr(), band.data_ptr(), u8_in, params.data_ptr(),
              out_band.data_ptr(), int(u8_out), 1, *geo)
    else:
      args = (grid.data_ptr(), band.data_ptr(), u8_in, params.data_ptr(), gc,
              out_band.data_ptr(), int(u8_out), 1, *geo)
    launches.append(args)
  fn = getattr(lib, _FUSED[mode == 'nn'])

  def call():
    for args in launches:
      _build.check(fn(*args, _stream()), mode)
  return call, out


@functools.lru_cache(maxsize=16)
def _index_tables(h, w, s, device):
  """The floor tables of ``nearest_index_tensor`` as int64 (once, cached),
  shaped to broadcast: rows (s, 1), columns (s,)."""
  return (nearest_index_tensor(h, s, device).long()[:, None],
          nearest_index_tensor(w, s, device).long())


def k2_library(frame, s):
  """K2's function at float32 as one PyTorch call: (B, H, W, C) ->
  (B, C, s, s) by one ``aten::index`` with the float64 floor tables. The
  yardstick of the kernel's ``library_ms``; the port never calls it.
  There is none for uint8, which needs a gather and a division."""
  iy, ix = _index_tables(frame.shape[1], frame.shape[2], s, frame.device)
  return frame.permute(0, 3, 1, 2)[:, :, iy, ix]


def k2x_library(frame_cf, s):
  """K2x's function as one PyTorch call: (B, C, H, W) float32 -> (B, C,
  s, s), one ``aten::index`` (the yardstick; the port never calls it)."""
  iy, ix = _index_tables(frame_cf.shape[2], frame_cf.shape[3], s,
                         frame_cf.device)
  return frame_cf[:, :, iy, ix]


def k2_call(lib, frame, s):
  """A function that launches `lib`'s K2 once on the NHWC frame (output
  allocated once), and the output."""
  b, h, w, c = frame.shape
  iy = nearest_index_tensor(h, s, frame.device)
  ix = nearest_index_tensor(w, s, frame.device)
  out = torch.empty((b, c, s, s), device=frame.device)
  args = (frame.data_ptr(), int(frame.dtype == torch.uint8), iy.data_ptr(),
          ix.data_ptr(), out.data_ptr(), b, h, w, c, s)

  def call():
    _build.check(lib.hdrnet_nearest_lowres(*args, _stream()), 'K2')
  return call, out


def k2x_call(lib, frame_cf, s, rows):
  """A function that launches `lib`'s K2x once on the channel-first frame
  (rows 0: v1 gather, 1: v2 mma), and the output."""
  b, c, h, w = frame_cf.shape
  iy = nearest_index_tensor(h, s, frame_cf.device)
  ix = nearest_index_tensor(w, s, frame_cf.device)
  out = torch.empty((b, c, s, s), device=frame_cf.device)
  args = (frame_cf.data_ptr(), iy.data_ptr(), ix.data_ptr(), out.data_ptr(),
          b * c, h, w, s, rows)

  def call():
    _build.check(lib.hdrnet_downsample_onehot(*args, _stream()), 'K2x')
  return call, out


def wrapper_host_us(fn, n=2000):
  """Host microseconds a call of an eager wrapper: `n` calls back to back
  between two synchronizations (the device keeps up when its kernel is
  shorter than the call)."""
  for _ in range(20):
    fn()
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  for _ in range(n):
    fn()
  torch.cuda.synchronize()
  return (time.perf_counter() - t0) / n * 1e6


def baseline_wrapper(csrc):
  """The baseline checkout's ``ops/downsample.py`` (beside its csrc) as a
  module of its own, or None; it imports this tree's package."""
  path = Path(csrc).resolve().parent / 'ops' / 'downsample.py'
  if not path.is_file():
    return None
  spec = importlib.util.spec_from_file_location('baseline_downsample', path)
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module


def _flat(out):
  """An output, or a tuple of outputs, as one float tensor."""
  if isinstance(out, tuple):
    return torch.cat([t.float().reshape(-1) for t in out])
  return out.float()


def _turns(base, cur):
  """baseline, this tree, this tree, baseline."""
  return [graph_ms(f, ITERS) for f in (base, cur, cur, base)]


def _seeded_params(dev):
  """Realistic guide parameters: the seeded default curves model's, and
  the NN model's (gc 16) with perturbed batch-norm statistics folded."""
  from hdrnet_torch.config import ModelConfig
  from hdrnet_torch.inference import Enhancer
  from hdrnet_torch.models import make_model
  curves = Enhancer(ModelConfig(), device=dev, seed=0).guide_params
  cfg = ModelConfig(model_name='HDRNetPointwiseNNGuide')
  state = make_model(cfg, generator=torch.Generator().manual_seed(1)
                     ).state_dict()
  gen = torch.Generator().manual_seed(2)
  for k, v in state.items():
    if k.startswith('guide') and k.endswith('running_var'):
      state[k] = 0.5 + 1.5 * torch.rand(v.shape, generator=gen)
    elif k.startswith('guide') and '.bn.' in k:
      state[k] = 0.1 * torch.randn(v.shape, generator=gen)
  nn = Enhancer(cfg, state, device=dev, seed=1).guide_params
  return {'curves': curves, 'nn': nn}


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  parser.add_argument('--baseline_csrc', required=True,
                      help="another tree's hdrnet_torch/csrc")
  parser.add_argument('--cases', nargs='+', choices=CASES, default=CASES,
                      help='groups of cases to time')
  args = parser.parse_args(argv)
  if not torch.cuda.is_available():
    raise SystemExit('time_kernels: needs a CUDA device')
  dev = torch.device('cuda', 0)
  smi = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=True, timeout=60).stdout.strip()
  root = _build.BUILD_ROOT
  cur = load(_build.CSRC, root)
  base = load(Path(args.baseline_csrc).resolve(),
              root.parent / 'hdrnet_torch_baseline')
  rng = np.random.RandomState(0)
  results = {}

  def put(name, base_fn, cur_fn, base_out, cur_out, extra=None):
    turns = _turns(base_fn, cur_fn)
    torch.cuda.synchronize()
    diff = float((_flat(cur_out) - _flat(base_out)).abs().max())
    scale = float(_flat(base_out).abs().max())
    results[name] = {'baseline_ms': (turns[0] + turns[3]) / 2,
                     'ms': (turns[1] + turns[2]) / 2, 'turns': turns,
                     'max_abs_diff': diff, 'baseline_max_abs': scale,
                     **(extra or {})}
    print(f'{name}: turns baseline / this / this / baseline '
          f'{" / ".join(f"{t:.4f}" for t in turns)} ms; max |diff| {diff:.3e} '
          f'(of {scale:.3e})', flush=True)

  gh, gw, gd = GRID
  for n in SIZES if 'slice' in args.cases else ():
    t = lambda *s: torch.from_numpy(rng.rand(*s).astype(np.float32)).to(dev)
    tn = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32)).to(
        dev)
    guide, image, image8 = t(1, n, n), t(1, n, n, 3), t(1, n, n, 8)
    empty = image[..., :0].contiguous()
    ct, ct12 = tn(1, n, n, 3), tn(1, n, n, 12)
    shape = (1, gh, gw, gd, 12)
    grid, grid27 = tn(*shape), tn(1, gh, gw, gd, 27)
    for name, make in (
        ('K3 3->3', lambda lib: k3_call(lib, grid, guide, image)),
        ('K3 n_in=0 C=12', lambda lib: k3_call(lib, grid, guide, empty)),
        ('K3 n_in=8 C=27', lambda lib: k3_call(lib, grid27, guide, image8)),
        ('K4 d_guide only',
         lambda lib: k4_call(lib, grid, guide, image, ct, False)),
        ('K4 d_guide and d_image',
         lambda lib: k4_call(lib, grid, guide, image, ct, True)),
        ('K4 n_in=0 C=12',
         lambda lib: k4_call(lib, grid, guide, empty, ct12, False)),
        ('K4 n_in=8 C=27 d_guide and d_image',
         lambda lib: k4_call(lib, grid27, guide, image8, ct, True))):
      base_fn, base_out = make(base)
      cur_fn, cur_out = make(cur)
      put(f'{name} {n}^2', base_fn, cur_fn, base_out, cur_out)
    base_fn, base_out = k5_call(base, guide, image, ct, shape)
    cur_fn, cur_out = k5_call(cur, guide, image, ct, shape)
    put(f'K5 {n}^2', base_fn, cur_fn, base_out, cur_out,
        {'scratch_bytes': cur_fn.scratch_bytes})
    del guide, image, image8, empty, ct, ct12, grid, grid27

  if 'downsample' in args.cases:
    _downsample_cases(base, cur, rng, dev, put, results,
                      baseline_wrapper(args.baseline_csrc))
  if 'fused' in args.cases:
    _fused_cases(base, cur, rng, dev, put)
  print(smi)
  print(json.dumps({'device': smi, 'iters_a_graph': ITERS,
                    'cases': results}))
  return results


def _downsample_cases(base, cur, rng, dev, put, results, base_wrapper):
  """K2 and K2g (f32, u8), then K2x v1 and v2, at 4K b=1 and b=4 -> 256,
  each beside its one-call yardstick; the eager wrapper's host cost. The
  function is exact: the trees' outputs must agree bit for bit, and at
  f32 with the yardstick's."""
  from hdrnet_torch.ops import downsample

  def exact(name, out, want):
    torch.cuda.synchronize()
    if results[name]['max_abs_diff'] != 0.0 or not torch.equal(out, want):
      raise AssertionError(f'{name}: the trees or the yardstick disagree')

  for b in (1, 4):
    frame = torch.from_numpy(rng.rand(b, *UHD, 3).astype(np.float32)).to(dev)
    for x, what in ((frame, 'f32'), ((frame * 255).to(torch.uint8), 'u8')):
      b_fn, b_out = k2_call(base, x, PREVIEW)
      c_fn, c_out = k2_call(cur, x, PREVIEW)
      extra = None
      if what == 'f32':
        extra = {'library_ms': graph_ms(lambda: k2_library(x, PREVIEW),
                                        ITERS)}
      name = f'{"K2" if b == 1 else "K2g"} 4K b={b} {what}'
      put(name, b_fn, c_fn, b_out, c_out, extra)
      exact(name, c_out, k2_library(x, PREVIEW) if what == 'f32' else
            downsample.nearest_lowres_plain(x, PREVIEW))
    if b == 1:
      this = lambda: downsample.nearest_lowres(frame, PREVIEW)
      case = results['K2 4K b=1 f32']
      if base_wrapper is None:
        case['wrapper_host_us'] = wrapper_host_us(this)
      else:
        other = lambda: base_wrapper.nearest_lowres(frame, PREVIEW)
        turns = [wrapper_host_us(f) for f in (other, this, this, other)]
        case.update(wrapper_host_us=(turns[1] + turns[2]) / 2,
                    baseline_wrapper_host_us=(turns[0] + turns[3]) / 2,
                    wrapper_turns=turns)
        print(f'K2 wrapper at 4K, host us a call, turns baseline / this / '
              f'this / baseline {" / ".join(f"{t:.2f}" for t in turns)}',
              flush=True)
    cf = frame.permute(0, 3, 1, 2).contiguous()
    del frame
    library_ms = graph_ms(lambda: k2x_library(cf, PREVIEW), ITERS)
    for rows, what in ((0, 'v1 gather'), (1, 'v2 mma')):
      b_fn, b_out = k2x_call(base, cf, PREVIEW, rows)
      c_fn, c_out = k2x_call(cur, cf, PREVIEW, rows)
      put(f'K2x {what} 4K b={b}', b_fn, c_fn, b_out, c_out,
          {'library_ms': library_ms})
      exact(f'K2x {what} 4K b={b}', c_out, k2x_library(cf, PREVIEW))
    del cf


def _fused_cases(base, cur, rng, dev, put):
  """K1 and K6 at 4K (f32, u8), K7 on the four 1080-row bands of 8K."""
  gh, gw, gd = GRID
  params = _seeded_params(dev)
  frame = torch.from_numpy(rng.rand(1, *UHD, 3).astype(np.float32)).to(dev)
  frame8 = (frame * 255).to(torch.uint8)
  grid = 0.5 * rng.randn(1, gh, gw, gd, 12)
  for i in range(3):
    grid[..., i * 4 + i] += 1.0
  grid = torch.from_numpy(grid.astype(np.float32)).to(dev)
  for mode, kid in (('curves', 'K1'), ('nn', 'K6')):
    for x, u8, what in ((frame, False, 'f32'), (frame8, True, 'u8')):
      b_fn, b_out = fused_call(base, grid, x, params[mode], mode, u8)
      c_fn, c_out = fused_call(cur, grid, x, params[mode], mode, u8)
      put(f'{kid} 4K {what}', b_fn, c_fn, b_out, c_out)
  del frame, frame8
  frame = torch.from_numpy(rng.rand(1, *EIGHT_K, 3).astype(np.float32)).to(
      dev)
  for mode in ('nn', 'curves'):
    b_fn, b_out = fused_call(base, grid, frame, params[mode], mode, False, 4)
    c_fn, c_out = fused_call(cur, grid, frame, params[mode], mode, False, 4)
    put(f'K7 four 1080-row 8K bands {mode}', b_fn, c_fn, b_out, c_out)


if __name__ == '__main__':
  main()
