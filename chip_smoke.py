#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It builds the
hand-written kernels of the serving path from ``hdrnet_torch/csrc`` (into
``build/hdrnet_torch/``), checks each against its plain PyTorch version on
the card, drives ``Enhancer.process`` and ``Enhancer.stream`` of the
default ``HDRNetCurves`` (256^2 preview, l8/s16, seeded weights) on 4K
frames, shows through the launch counters that both paths ran the
kernels, and times the kernels and the serving path with CUDA events.

Each phase prints one line and raises on failure. The last three lines
are the card's name and power limit as nvidia-smi gives them, a JSON
object describing each kernel, and ``{"ok": true, "device": ...}``.
Without a CUDA device, or outside a checkout, it fails before printing
any result. It imports nothing of JAX.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

UHD = (2160, 3840)
FHD = (1080, 1920)
K1_TOL = 1e-4      # float32 sums in another order, FMA contraction
IDENTITY_TOL = 2e-4  # the smoothed depth tent's own deficit, 1 - sqrt(1e-8)
U8_MAX_SHARE = 0.01  # uint8: at most 1 code on fewer than 1% of values


def _nvidia_smi():
  out = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=True, timeout=60).stdout
  return out.strip().splitlines()[0].strip()


def _ptxas_summary(log):
  """Registers, shared memory and spills per kernel from -Xptxas -v."""
  rows = []
  for line in log.splitlines():
    m = re.search(r"Compiling entry function '(\w+)'", line)
    if m:
      k = re.search(r'([a-z_]+_kernel)I(\w+?)E', m.group(1))
      types = {'f': 'f32', 'h': 'u8'}
      name = (f'{k.group(1)}<{",".join(types.get(t, t) for t in k.group(2))}>'
              if k else m.group(1))
      rows.append({'kernel': name})
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


def main():
  if not torch.cuda.is_available():
    print('chip_smoke: no CUDA device; this check runs on the GPU only',
          file=sys.stderr)
    return 1
  from hdrnet_torch.inference import Enhancer, ModelConfig, full_float32
  from hdrnet_torch.ops import _build, downsample, fused

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
       {'clip_output': True, 'u8_output': True}),
      ('K2 f32', downsample.nearest_lowres, downsample.nearest_lowres_plain,
       (x4k, 256), {}),
      ('K2 u8', downsample.nearest_lowres, downsample.nearest_lowres_plain,
       (x4k8, 256), {})]:
    plain_ms = _time_ms(lambda: plain(*args, **kw), 5, warmup=1)
    kernel_ms = _time_ms(lambda: kernel(*args, **kw), 100)
    times[name] = (kernel_ms, plain_ms)
    print(f'timing {tag}: {name} 4K kernel {kernel_ms:.4f} ms, plain '
          f'{plain_ms:.4f} ms', flush=True)

  kernels = [
      {'name': 'K1 enhance_fused (curves guide + slice + apply)',
       'route': 'cuda', 'source': 'hdrnet_torch/csrc/fused_slice_apply.cu',
       'replaces': 'hdrnet_tpu/ops/pallas.py:635',
       'launches': launches['K1'], 'max_abs_err': k1_err,
       'ms': times['K1 f32'][0], 'plain_ms': times['K1 f32'][1]},
      {'name': 'K2 nearest_lowres (preview downsample)', 'route': 'cuda',
       'source': 'hdrnet_torch/csrc/downsample.cu',
       'replaces': 'hdrnet_tpu/ops/downsample.py:75',
       'launches': launches['K2'], 'max_abs_err': k2_err,
       'ms': times['K2 f32'][0], 'plain_ms': times['K2 f32'][1]},
  ]
  print(smi)
  print(json.dumps({'kernels': kernels}))
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}))
  return 0


if __name__ == '__main__':
  sys.exit(main())
