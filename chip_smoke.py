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

Each phase prints one line and raises on failure. The last three lines
are the card's name and power limit as nvidia-smi gives them, a JSON
object describing each kernel, and ``{"ok": true, "device": ...}``.
Without a CUDA device, or outside a checkout, it fails before printing
any result. It imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

UHD = (2160, 3840)
FHD = (1080, 1920)
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
    if rest[i] in 'fh':
      args.append({'f': 'f32', 'h': 'u8'}[rest[i]])
      i += 1
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


def _check_train_kernels(gen, dev, full_float32):
  """K3, K4 and K5 against their plain versions (under full float32) at
  the training shape and an odd one; K5 twice must give the same bits."""
  from hdrnet_torch.ops import slice_apply as sa
  errs = {'K3': 0.0, 'K4': 0.0, 'K5': 0.0}
  for b, hw in [(1, TRAIN_HW), (2, (101, 60))]:
    for n_in in (3, 0):
      g5, guide, image, ct = _train_inputs(gen, b, hw, n_in, dev,
                                           n_out=3 if n_in else 12)
      what = f'b={b} {hw} n_in={n_in}'
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
        f'{K5_REL:.0e} of its max), at 2048^2 b=1 and 101x60 b=2, n_in 3 '
        f'and 0; K5 bit-identical across runs', flush=True)
  return errs


class _PlainSliceApply(torch.autograd.Function):
  """The slice-apply op on the plain versions, for comparison only."""

  @staticmethod
  def forward(ctx, grid5, guide, image):
    from hdrnet_torch.ops import slice_apply as sa
    ctx.save_for_backward(grid5, guide, image)
    return sa.slice_apply_fwd_plain(grid5, guide, image)

  @staticmethod
  def backward(ctx, ct):
    from hdrnet_torch.ops import slice_apply as sa
    grid5, guide, image = ctx.saved_tensors
    ct = ct.contiguous()
    d_guide, _ = sa.slice_apply_pix_bwd_plain(grid5, guide, image, ct,
                                              need_input=False)
    d_grid = sa.slice_apply_grid_bwd_plain(grid5.shape, guide, image, ct)
    return d_grid, d_guide, None


def _plain_slice_apply(grid, guide, image, has_offset=True):
  assert has_offset
  return _PlainSliceApply.apply(grid.reshape(grid.shape[:4] + (-1,)),
                                guide, image)


def _train_batches(n, cfg, seed=7):
  """n in-memory uint8 batches of one image, shaped like the pipeline's:
  a seeded frame, its target clip(1.3 x), and both cut to the preview by
  the legacy nearest table."""
  from hdrnet_torch.ops.resize import _nearest_indices
  rng = np.random.RandomState(seed)
  h, w = cfg.output_resolution
  s = cfg.net_input_size
  iy, ix = _nearest_indices(h, s), _nearest_indices(w, s)
  out = []
  for _ in range(n):
    full = rng.randint(0, 256, (1, h, w, 3)).astype(np.uint8)
    target = np.clip(full.astype(np.float32) * 1.3, 0, 255).astype(np.uint8)
    out.append({'lowres_input': np.ascontiguousarray(full[:, iy][:, :, ix]),
                'lowres_output': np.ascontiguousarray(target[:, iy][:, :, ix]),
                'image_input': full, 'image_output': target})
  return out


def _check_model_gradients(dev, full_float32, model_name='HDRNetCurves'):
  """Every parameter gradient of one 2048^2 step of the model at the
  default widths on the CUDA path against the same step on the plain
  versions."""
  import hdrnet_torch.models.hdrnet as hdrnet_module
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
  kernel_op = hdrnet_module.bilateral_slice_apply
  hdrnet_module.bilateral_slice_apply = _plain_slice_apply
  try:
    want_loss, want = grads()
  finally:
    hdrnet_module.bilateral_slice_apply = kernel_op
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


def _train_full_width(dev, tag, enh_cls, model_name='HDRNetCurves',
                      steps=TRAIN_STEPS):
  """The model and optimizer of scripts/ll/train_std.sh (HDRNetCurves) or
  train_gpyrnn.sh (HDRNetGaussianPyrNN): `steps` steps with one K3, K4
  and K5 a slice-apply (three a step for the pyramid), save, restore, one
  more step each way, serve the checkpoint at 4K. Returns the launch
  counts and timings."""
  import shutil
  from hdrnet_torch.config import Config, DataConfig, ModelConfig, TrainConfig
  from hdrnet_torch.models import make_model
  from hdrnet_torch.ops import downsample, fused
  from hdrnet_torch.ops import slice_apply as sa
  from hdrnet_torch.training import loop, step
  from hdrnet_torch.training.checkpoint import Checkpointer
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
  losses = [float(x) for x in losses]
  ema = float(emas[-1])
  if not all(np.isfinite(losses)) or not ema < losses[0]:
    raise AssertionError(f'training: losses {losses}, ema {ema}')

  # Save, restore into a fresh state, one more step each way.
  ckpt_dir = 'build/chip_smoke_ckpt'
  shutil.rmtree(ckpt_dir, ignore_errors=True)
  cfg.save(ckpt_dir)
  Checkpointer(ckpt_dir).save(state.step, state)
  restored = Checkpointer(ckpt_dir).restore(fresh(99))
  batch = step.to_device(host[0], dev)
  with _cudnn_deterministic():
    _, m_a = train_step(state, batch)
    _, m_b = train_step(restored, batch)
  resume_err = abs(float(m_a['loss']) - float(m_b['loss']))
  for a, b in zip(state.model.parameters(), restored.model.parameters()):
    resume_err = max(resume_err, float((a - b).detach().abs().max()))
  if not resume_err <= RESUME_TOL:
    raise AssertionError(f'resume: max diff {resume_err:.3e}, not '
                         f'bit-identical')

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
  shutil.rmtree(ckpt_dir, ignore_errors=True)
  print(f'training {model_name} at full width (l8/s16/cm1, 256^2, 2048^2, '
        f'b=1, Adam 1e-4): {steps} steps, loss step 1 {losses[0]:.6f} -> '
        f'step {steps} {losses[-1]:.6f}, EMA {ema:.6f}; launches '
        f'{launches}; resume max diff {resume_err:.3e} (bit-identical under '
        f'cudnn.deterministic); checkpoint served at 4K through '
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
  return launches, step_ms, peak_mib, steady_peak


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
  """Inside the block the Enhancer's entry points run the plain versions
  of K2 and K1/K6 (in full float32), for comparison only."""
  import hdrnet_torch.inference as inference
  from hdrnet_torch.ops import downsample, fused

  def plain(*args, **kw):
    with full_float32():
      return fused.enhance_fused_plain(*args, **kw)

  saved = inference.enhance_fused, inference.nearest_lowres
  inference.enhance_fused = plain
  inference.nearest_lowres = downsample.nearest_lowres_plain
  try:
    yield
  finally:
    inference.enhance_fused, inference.nearest_lowres = saved


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

  # 12. Training: K3/K4/K5 vs plain, gradients end to end, then the
  # training paths at full width, their counts reset just before each.
  from hdrnet_torch.ops import slice_apply as sa
  train_errs = _check_train_kernels(gen, dev, full_float32)
  _check_model_gradients(dev, full_float32)
  _check_model_gradients(dev, full_float32, PYR)
  train_launches, step_ms, peak_mib, steady_peak = _train_full_width(
      dev, tag, Enhancer)
  pyr_train_launches, pyr_step_ms, _, pyr_peak = _train_full_width(
      dev, tag, Enhancer, PYR, PYR_TRAIN_STEPS)
  print(f'timing {tag}: {PYR} train step at full width {pyr_step_ms:.4f} ms '
        f'({1e3 / pyr_step_ms:.2f} steps/s, host clock over 20 steps); '
        f'peak memory allocated during those steps {pyr_peak:.1f} MiB',
        flush=True)

  # 13. Training timing: the kernels at 2048^2 b=1 against their plain
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
  share = sum(times[k][0] for k in ('K3', 'K4', 'K5')) / step_ms
  print(f'timing {tag}: train step at full width {step_ms:.4f} ms '
        f'({1e3 / step_ms:.2f} steps/s, host clock over 20 steps); K3+K4+K5 '
        f'{share:.1%} of a step; peak memory allocated during those steps '
        f'{steady_peak:.1f} MiB', flush=True)

  kernels = [
      {'name': 'K1 enhance_fused (curves guide + slice + apply)',
       'route': 'cuda', 'source': 'hdrnet_torch/csrc/fused_slice_apply.cu',
       'replaces': 'hdrnet_tpu/ops/pallas.py:635',
       'launches': launches['K1'], 'max_abs_err': k1_err,
       'ms': times['K1 f32'][0], 'plain_ms': times['K1 f32'][1]},
      {'name': 'K6 enhance_fused nn (NN guide + slice + apply)',
       'route': 'cuda', 'source': 'hdrnet_torch/csrc/fused_slice_apply.cu',
       'replaces': 'hdrnet_tpu/ops/pallas.py:529',
       'launches': nn_launches['K6'] + pyr_launches['K6'],
       'max_abs_err': k6_err, 'ms': times['K6 f32'][0],
       'plain_ms': times['K6 f32'][1]},
      {'name': 'K2 nearest_lowres (preview downsample)', 'route': 'cuda',
       'source': 'hdrnet_torch/csrc/downsample.cu',
       'replaces': 'hdrnet_tpu/ops/downsample.py:75',
       'launches': launches['K2'], 'max_abs_err': k2_err,
       'ms': times['K2 f32'][0], 'plain_ms': times['K2 f32'][1]},
      {'name': 'K3 slice_apply_fwd (slice + apply, external guide)',
       'route': 'cuda', 'source': 'hdrnet_torch/csrc/slice_apply.cu',
       'replaces': 'hdrnet_tpu/ops/pallas.py:570',
       'launches': train_launches['K3'], 'max_abs_err': train_errs['K3'],
       'ms': times['K3'][0], 'plain_ms': times['K3'][1]},
      {'name': 'K4 slice_apply_pix_bwd (guide and input cotangents)',
       'route': 'cuda', 'source': 'hdrnet_torch/csrc/slice_apply.cu',
       'replaces': 'hdrnet_tpu/ops/pallas.py:694',
       'launches': train_launches['K4'], 'max_abs_err': train_errs['K4'],
       'ms': times['K4'][0], 'plain_ms': times['K4'][1]},
      {'name': 'K5 slice_apply_grid_bwd (grid cotangent, deterministic)',
       'route': 'cuda', 'source': 'hdrnet_torch/csrc/slice_apply.cu',
       'replaces': 'hdrnet_tpu/ops/pallas.py:757',
       'launches': train_launches['K5'], 'max_abs_err': train_errs['K5'],
       'ms': times['K5'][0], 'plain_ms': times['K5'][1]},
  ]
  print(smi)
  print(json.dumps({'kernels': kernels}))
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}))
  return 0


if __name__ == '__main__':
  sys.exit(main())
