"""The port's named spans (``hdrnet_torch.utils.timing.span``): which
``hdrnet.*`` ranges each route records under ``torch.profiler``, how
they nest, that no profiler op runs or is exported without a profiler,
and ``train()``'s ``profile_dir`` trace.

The CPU cases run the plain versions of the kernels; the cases marked
``gpu`` check the stream's copy, wait and replay spans and K4's launch
counters on the card (run with
``python -m pytest --noconftest -m gpu tests/test_torch_spans.py``).
This file imports no JAX.
"""

import collections
import json
import logging
import os

import numpy as np
import pytest
import torch
from PIL import Image
from torch.profiler import ProfilerActivity, profile

from hdrnet_torch.bin import export
from hdrnet_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from hdrnet_torch.data.device import DeviceDataset, make_device_augment
from hdrnet_torch.inference import Enhancer
from hdrnet_torch.models import make_model
from hdrnet_torch.ops import _build, slice_apply
from hdrnet_torch.training import loop
from hdrnet_torch.training.step import create_state, make_train_step
from hdrnet_torch.utils import timing

SMALL = dict(net_input_size=32, spatial_bin=8, luma_bins=4,
             guide_complexity=4)
FRAMES = 3


def _cfg(name):
  return ModelConfig(model_name=name, **SMALL)


def _frames(n=FRAMES, h=40, w=56):
  rng = np.random.RandomState(0)
  return [rng.randint(0, 256, (1, h, w, 3)).astype(np.uint8)
          for _ in range(n)]


def _spans(prof):
  """{name: [(start, end)]} of the hdrnet.* ranges on the host, in ns."""
  out = collections.defaultdict(list)
  for e in prof.profiler.kineto_results.events():
    if (e.name().startswith('hdrnet.')
        and e.device_type() == torch.autograd.DeviceType.CPU):
      out[e.name()].append((e.start_ns(), e.start_ns() + e.duration_ns()))
  return out


def _counts(spans):
  return {k: len(v) for k, v in spans.items()}


def _inside(spans, child, parent):
  """Every `child` span lies inside some `parent` span."""
  return all(any(ps <= cs and ce <= pe for ps, pe in spans[parent])
             for cs, ce in spans[child])


def _profile(fn):
  with profile(activities=[ProfilerActivity.CPU]) as prof:
    fn()
  return _spans(prof)


@pytest.mark.parametrize('name,fused', [('HDRNetCurves', 1),
                                        ('HDRNetGaussianPyrNN', 3)])
def test_stream_records_the_serving_spans(name, fused):
  enh = Enhancer(_cfg(name), device='cpu')
  frames = _frames()
  spans = _profile(lambda: list(enh.stream(iter(frames))))
  want = {'hdrnet.serve.forward': FRAMES, 'hdrnet.ops.preview': FRAMES,
          'hdrnet.model.backbone': FRAMES, 'hdrnet.ops.fused': fused * FRAMES,
          'hdrnet.stream.wait': FRAMES}
  if fused > 1:  # the pyramid: its levels and two upsample-adds a frame
    want['hdrnet.model.levels'] = 3 * FRAMES
  assert _counts(spans) == want
  for child in ('hdrnet.ops.preview', 'hdrnet.model.backbone',
                'hdrnet.ops.fused') + (('hdrnet.model.levels',)
                                       if fused > 1 else ()):
    assert _inside(spans, child, 'hdrnet.serve.forward'), child


@pytest.mark.parametrize('route', ['process', 'enhance_any'])
def test_fused_routes_record_their_spans(route):
  enh = Enhancer(_cfg('HDRNetCurves'), device='cpu')
  frame = torch.rand(1, 40, 56, 3)
  if route == 'process':
    spans = _profile(lambda: enh.process(frame))
  else:
    low = torch.rand(1, 32, 32, 3)
    spans = _profile(lambda: enh.enhance_any(low.numpy(), frame.numpy()))
  preview = {'hdrnet.ops.preview': 1} if route == 'process' else {}
  assert _counts(spans) == {'hdrnet.serve.forward': 1,
                            'hdrnet.model.backbone': 1,
                            'hdrnet.ops.fused': 1, **preview}
  assert _inside(spans, 'hdrnet.ops.fused', 'hdrnet.serve.forward')


def test_composite_route_records_its_spans():
  enh = Enhancer(_cfg('HDRNet3x3NNGuide'), device='cpu')
  assert not enh.fused
  spans = _profile(lambda: list(enh.stream(iter(_frames(2)))))
  assert _counts(spans) == {
      'hdrnet.serve.forward': 2, 'hdrnet.ops.preview': 2,
      'hdrnet.model.backbone': 2, 'hdrnet.model.guide': 2,
      'hdrnet.ops.slice_apply': 2, 'hdrnet.stream.wait': 2}
  for child in ('hdrnet.model.guide', 'hdrnet.ops.slice_apply',
                'hdrnet.model.backbone'):
    assert _inside(spans, child, 'hdrnet.serve.forward'), child


def _train_setup(name='HDRNetGaussianPyrNN', crop=48, device='cpu'):
  torch.manual_seed(0)
  net = make_model(_cfg(name)).to(device)
  tc = TrainConfig(learning_rate=1e-3)
  state = create_state(net, loop.make_optimizer(net, tc))
  cfg = DataConfig(batch_size=1, output_resolution=[crop, crop],
                   net_input_size=SMALL['net_input_size'])
  gen = torch.Generator().manual_seed(1)
  pairs = tuple(torch.randint(0, 256, (2, 56, 56, 3), generator=gen,
                              dtype=torch.uint8) for _ in range(2))
  dds = DeviceDataset(None, cfg, device, arrays=tuple(
      p.to(device) for p in pairs))
  augment = make_device_augment(cfg.output_resolution, cfg.net_input_size,
                                cfg.rotate)
  draws = dds.param_stream(7, cfg.batch_size)

  def feed():
    return loop.augment_batch(augment, dds.inputs, dds.outputs, next(draws))
  return state, feed


def test_train_step_records_its_phases():
  state, feed = _train_setup()
  step = make_train_step()
  spans = _profile(lambda: step(state, feed()))
  phases = ['hdrnet.train.forward', 'hdrnet.train.backward',
            'hdrnet.train.optimizer', 'hdrnet.train.metrics']
  assert _counts(spans) == {
      'hdrnet.data.augment': 1, **{p: 1 for p in phases},
      'hdrnet.model.backbone': 1, 'hdrnet.model.levels': 3,
      'hdrnet.model.guide': 3, 'hdrnet.ops.slice_apply': 3}
  # The phases follow one another, after the batch's augment.
  order = [spans[p][0] for p in ['hdrnet.data.augment'] + phases]
  assert all(a[1] <= b[0] for a, b in zip(order, order[1:]))
  for child in ('hdrnet.model.backbone', 'hdrnet.model.levels',
                'hdrnet.model.guide', 'hdrnet.ops.slice_apply'):
    assert _inside(spans, child, 'hdrnet.train.forward'), child


def test_feature_towers_record_their_span():
  """One ``hdrnet.model.features`` a level's tower, inside the step's
  forward."""
  state, feed = _train_setup('HDRNetFeaturesPyrNN3')
  spans = _profile(lambda: make_train_step()(state, feed()))
  counts = _counts(spans)
  assert counts['hdrnet.model.features'] == 3
  assert counts['hdrnet.ops.slice_apply'] == 3
  assert _inside(spans, 'hdrnet.model.features', 'hdrnet.train.forward')


@pytest.mark.parametrize('name,image', [('HDRNetFeaturesPyrNN3', 3),
                                        ('HDRNetGaussianPyrNN', 0)])
def test_k4_gives_the_image_cotangent_only_to_learned_features(
    name, image, monkeypatch):
  """K4 is asked for the image's cotangent once a level where the image
  is learned (the towers' features), never where it is the frame; on the
  CPU the plain versions run and no launch is counted."""
  whole = slice_apply.slice_apply_pix_bwd
  asked = []

  def spy(*args, **kwargs):
    asked.append(kwargs['need_input'])
    return whole(*args, **kwargs)
  monkeypatch.setattr(slice_apply, 'slice_apply_pix_bwd', spy)
  state, feed = _train_setup(name)
  before = _build.launches.copy()
  make_train_step()(state, feed())
  assert len(asked) == 3 and sum(asked) == image
  assert _build.launches == before


def test_stack_records_a_span_a_stage():
  """``HDRNetStack``: one ``hdrnet.model.stage`` a stage and one
  ``hdrnet.model.stage_preview`` between them, in the step's forward; the
  preview follows the first stage and precedes the second."""
  state, feed = _train_setup('HDRNetStack')
  spans = _profile(lambda: make_train_step()(state, feed()))
  counts = _counts(spans)
  assert counts['hdrnet.model.stage'] == 2
  assert counts['hdrnet.model.stage_preview'] == 1
  assert counts['hdrnet.model.backbone'] == 2
  assert counts['hdrnet.ops.slice_apply'] == 2
  for child in ('hdrnet.model.stage', 'hdrnet.model.stage_preview'):
    assert _inside(spans, child, 'hdrnet.train.forward'), child
  assert _inside(spans, 'hdrnet.model.backbone', 'hdrnet.model.stage')
  first, second = sorted(spans['hdrnet.model.stage'])
  (preview,) = spans['hdrnet.model.stage_preview']
  assert first[1] <= preview[0] and preview[1] <= second[0]


def test_k4_gives_the_image_cotangent_to_the_second_stage_only(monkeypatch):
  """In ``HDRNetStack`` K4 runs once a stage and is asked for the image's
  cotangent once a step: the second stage's image is the first stage's
  output; the first stage's is the frame."""
  whole = slice_apply.slice_apply_pix_bwd
  asked = []

  def spy(*args, **kwargs):
    asked.append(kwargs['need_input'])
    return whole(*args, **kwargs)
  monkeypatch.setattr(slice_apply, 'slice_apply_pix_bwd', spy)
  state, feed = _train_setup('HDRNetStack')
  make_train_step()(state, feed())
  assert sorted(asked) == [False, True]


def test_no_profiler_enters_no_range(monkeypatch):
  """With no profiler running a span is the one shared null context: the
  stream, the composite route and a train step run with
  ``record_function`` made to raise."""
  def refuse(name):
    raise AssertionError(f'record_function({name!r}) with no profiler')
  monkeypatch.setattr(timing, 'record_function', refuse)
  assert timing.span('hdrnet.x') is timing.span('hdrnet.y')
  for name in ('HDRNetGaussianPyrNN', 'HDRNet3x3NNGuide'):
    enh = Enhancer(_cfg(name), device='cpu')
    assert len(list(enh.stream(iter(_frames(2))))) == 2
  state, feed = _train_setup()
  make_train_step()(state, feed())
  assert state.step == 1


def test_span_is_null_inside_a_compiled_graph(monkeypatch):
  with profile(activities=[ProfilerActivity.CPU]):
    assert timing.span('hdrnet.x') is not timing.span('hdrnet.y')
    monkeypatch.setattr(torch.compiler, 'is_compiling', lambda: True)
    assert timing.span('hdrnet.x') is timing.span('hdrnet.y')


@pytest.mark.parametrize('name', ['HDRNetCurves', 'HDRNetGaussianPyrNN'])
def test_export_under_a_profiler_holds_no_profiler_op(name, tmp_path):
  """Exported while a profiler records, ``stream_fn`` and ``serve_fn``
  hold no profiler op and reload bit for bit with the eager Enhancer."""
  enh = Enhancer(_cfg(name), device='cpu')
  h, w = 40, 56
  fns = export.serving_functions(enh, (h, w))
  frame_u8 = torch.from_numpy(_frames(1, h, w)[0])
  low, full = torch.rand(1, 32, 32, 3), torch.rand(1, h, w, 3)
  cases = {'stream_fn': ((frame_u8,),
                         enh.make_stream_fn(frame_u8.shape)(frame_u8)),
           'serve_fn': ((low, full), enh(low, full))}
  for fn_name, (args, want) in cases.items():
    fn, example, dynamic = fns[fn_name]
    with profile(activities=[ProfilerActivity.CPU]):
      program = export.export_function(enh, fn_name, fn, example, dynamic,
                                       str(tmp_path))
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == 'call_function']
    assert not [t for t in targets if 'profiler' in t], fn_name
    got = export.load_artifact(str(tmp_path / f'{fn_name}.pt2'))(*args)
    assert got.dtype == want.dtype and torch.equal(got, want), fn_name


def _loop_config(max_steps, profile_dir=None):
  return Config(
      model=ModelConfig(model_name='HDRNetCurves', net_input_size=32,
                        spatial_bin=8, luma_bins=4),
      data=DataConfig(batch_size=2, output_resolution=[64, 64],
                      net_input_size=32, data_threads=1, device_data=True,
                      device_normalize=True),
      train=TrainConfig(learning_rate=3e-3, max_steps=max_steps,
                        log_interval=9999, summary_interval=9999,
                        checkpoint_interval=9999, eval_interval=9999,
                        profile_dir=profile_dir))


@pytest.fixture()
def dataset(tmp_path):
  """Four 80x96 PNG pairs, each target its input brightened by 1.3."""
  rng = np.random.RandomState(0)
  os.makedirs(tmp_path / 'input')
  os.makedirs(tmp_path / 'output')
  names = []
  for i in range(4):
    im = (rng.rand(80, 96, 3) * 255).astype(np.uint8)
    out = np.clip(im.astype(np.float32) * 1.3, 0, 255).astype(np.uint8)
    Image.fromarray(im).save(tmp_path / 'input' / f'im{i}.png')
    Image.fromarray(out).save(tmp_path / 'output' / f'im{i}.png')
    names.append(f'im{i}.png')
  (tmp_path / 'filelist.txt').write_text('\n'.join(names))
  return tmp_path


def test_profile_dir_trace_shows_the_step_phases(dataset, tmp_path):
  trace_dir = tmp_path / 'trace'
  state = loop.train(_loop_config(15, str(trace_dir)), str(tmp_path / 'c'),
                     str(dataset), device='cpu')
  assert (state.step, state.data_route) == (15, 'device')
  with open(trace_dir / 'train_steps_10_15.json') as f:
    names = collections.Counter(e.get('name') for e in json.load(f)[
        'traceEvents'])
  for phase in ('forward', 'backward', 'optimizer', 'metrics'):
    assert names[f'hdrnet.train.{phase}'] == 5, phase
  assert names['hdrnet.data.augment'] >= 4


def test_profile_dir_warns_when_restored_past_its_steps(dataset, tmp_path,
                                                        caplog):
  ckpt = str(tmp_path / 'c')
  loop.train(_loop_config(11), ckpt, str(dataset), device='cpu')
  trace_dir = tmp_path / 'trace'
  with caplog.at_level(logging.WARNING, logger='hdrnet_torch.train'):
    state = loop.train(_loop_config(12, str(trace_dir)), ckpt, str(dataset),
                       device='cpu')
  assert state.step == 12
  assert not trace_dir.exists()
  warned = [r for r in caplog.records if r.levelno == logging.WARNING
            and 'profile_dir' in r.getMessage()]
  assert len(warned) == 1 and 'step 11' in warned[0].getMessage()


@pytest.mark.gpu
def test_stream_spans_on_the_card():
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA device: run on the card with `python -m '
                'pytest --noconftest -m gpu tests/test_torch_spans.py`')
  enh = Enhancer(_cfg('HDRNetCurves'), device='cuda')
  frames = _frames(4, 64, 96)
  list(enh.stream(iter(frames)))  # builds the kernels, captures the graph
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    outs = list(enh.stream(iter(frames)))
  torch.cuda.synchronize()
  spans = _spans(prof)
  # Every frame replays the graph, which opens no span inside it; the
  # device rows still name its kernels, K1 once a frame.
  for name in ('hdrnet.stream.pin', 'hdrnet.stream.upload',
               'hdrnet.stream.readback', 'hdrnet.stream.wait',
               'hdrnet.serve.forward', 'hdrnet.serve.replay'):
    assert len(spans[name]) == len(frames), name
  assert _inside(spans, 'hdrnet.serve.replay', 'hdrnet.serve.forward')
  assert 'hdrnet.ops.fused' not in spans
  k1 = [e for e in prof.profiler.kineto_results.events()
        if e.device_type() == torch.autograd.DeviceType.CUDA
        and 'enhance_fused_kernel' in e.name()]
  assert len(k1) == len(frames)
  assert len(outs) == len(frames) and outs[0].dtype == np.uint8


@pytest.mark.gpu
@pytest.mark.parametrize('name,image', [('HDRNetFeaturesPyrNN3', 3),
                                        ('HDRNetGaussianPyrNN', 0)])
def test_k4_image_launches_on_the_card(name, image):
  """K4 launches that give the image's cotangent
  (``'slice_apply_pix_bwd_image'``): 3 a step where the towers learn, 0
  in the pyramid of the frame; K4 launches 3 a step in both."""
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA device: run on the card with `python -m '
                'pytest --noconftest -m gpu tests/test_torch_spans.py`')
  state, feed = _train_setup(name, device='cuda')
  step = make_train_step()
  state, _ = step(state, feed())  # builds the kernels
  before = _build.launches.copy()
  for _ in range(2):
    state, _ = step(state, feed())
  torch.cuda.synchronize()
  moved = _build.launches - before
  assert (moved['hdrnet_slice_apply_pix_bwd'],
          moved['slice_apply_pix_bwd_image']) == (6, 2 * image)


@pytest.mark.gpu
def test_k4_image_launches_of_the_stack_on_the_card():
  """``HDRNetStack``'s K4 launches on the card: 2 a step, 1 of them
  with the image's cotangent (``'slice_apply_pix_bwd_image'``), through
  the step's graph replays too."""
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA device: run on the card with `python -m '
                'pytest --noconftest -m gpu tests/test_torch_spans.py`')
  state, feed = _train_setup('HDRNetStack', device='cuda')
  step = make_train_step()
  state, _ = step(state, feed())  # builds the kernels
  before = _build.launches.copy()
  for _ in range(3):
    state, _ = step(state, feed())
  torch.cuda.synchronize()
  moved = _build.launches - before
  assert (moved['hdrnet_slice_apply_pix_bwd'],
          moved['slice_apply_pix_bwd_image']) == (6, 3)
