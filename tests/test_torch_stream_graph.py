"""``Enhancer.stream``'s CUDA graphs, the parts a CPU can check: the CPU
stream never captures and matches ``make_stream_fn`` frame for frame;
which frames of a shape capture, how many shapes an Enhancer keeps and
what a failed capture leaves (the capture replaced by a stand-in);
``holding_tables``, which keeps the device tables a capture read; and
``to_unit``'s cached divisor. The graphs themselves run on the card:
``tests/test_torch_cuda.py``. This file imports no JAX.
"""

import logging

import numpy as np
import pytest
import torch

from hdrnet_torch import inference
from hdrnet_torch.inference import Enhancer, ModelConfig
from hdrnet_torch.ops import downsample, resize

SMALL = dict(net_input_size=32, spatial_bin=8, luma_bins=4,
             guide_complexity=4)


def _frames(n, h=40, w=56, seed=0):
  rng = np.random.RandomState(seed)
  return [rng.randint(0, 256, (1, h, w, 3)).astype(np.uint8)
          for _ in range(n)]


@pytest.mark.parametrize('name', ['HDRNetCurves', 'HDRNetGaussianPyrNN'])
def test_cpu_stream_never_captures(name):
  enh = Enhancer(ModelConfig(model_name=name, **SMALL), device='cpu')
  frames = _frames(3) + _frames(2, 48, 40)
  captures, replays = inference.graph_captures, inference.graph_replays
  for _ in range(2):
    outs = list(enh.stream(iter(frames)))
    for f, out in zip(frames, outs):
      want = enh.make_stream_fn(f.shape)(torch.from_numpy(f)).numpy()
      assert np.array_equal(out, want)
  assert (inference.graph_captures, inference.graph_replays) == (captures,
                                                                 replays)
  assert not enh._graphs


class _Capture:
  """Stands in for ``inference._StreamGraph``: records what it captured,
  or raises like a failed capture."""
  made = []
  fail = False

  def __init__(self, fn, shape, device):
    if _Capture.fail:
      raise RuntimeError('operation not permitted when stream is capturing')
    self.fn, self.shape, self.device = fn, shape, device
    _Capture.made.append(shape)


@pytest.fixture
def capture(monkeypatch):
  monkeypatch.setattr(inference, '_StreamGraph', _Capture)
  monkeypatch.setattr(_Capture, 'made', [])
  monkeypatch.setattr(_Capture, 'fail', False)
  return _Capture


def _enhancer():
  return Enhancer(ModelConfig(**SMALL), device='cpu')


def test_second_frame_of_a_shape_captures(capture):
  enh = _enhancer()
  a, b = (1, 40, 56, 3), (1, 48, 40, 3)
  fn = object()
  assert enh._stream_graph(a, fn) is None  # the shape's first frame
  assert enh._stream_graph(b, fn) is None
  graph = enh._stream_graph(a, fn)
  assert isinstance(graph, _Capture) and graph.fn is fn
  assert enh._stream_graph(a, fn) is graph  # replayed, not captured again
  assert capture.made == [a]
  assert enh._stream_graph(b, fn) is not None
  assert capture.made == [a, b]


def test_an_enhancer_keeps_a_few_shapes(capture):
  enh = _enhancer()
  shapes = [(1, 8 * (i + 1), 16, 3) for i in range(inference._GRAPH_SHAPES
                                                  + 1)]
  for s in shapes:
    enh._stream_graph(s, None)
    enh._stream_graph(s, None)
  assert capture.made == shapes
  # The least recently used was dropped: its next frame runs eagerly and
  # the one after captures it again; the others still replay.
  assert list(enh._graphs) == shapes[1:]
  for s in shapes[1:]:
    enh._stream_graph(s, None)
  assert enh._stream_graph(shapes[0], None) is None
  assert enh._stream_graph(shapes[0], None) is not None
  assert capture.made == shapes + [shapes[0]]


def test_shapes_seen_once_are_forgotten_in_turn(capture):
  enh = _enhancer()
  first = (1, 8, 8, 3)
  enh._stream_graph(first, None)
  for i in range(inference._SEEN_SHAPES):
    enh._stream_graph((1, 16, 8 + i, 3), None)
  assert enh._stream_graph(first, None) is None  # forgotten: seen anew
  assert capture.made == []


def test_failed_capture_runs_the_shape_eagerly(capture, caplog):
  enh = _enhancer()
  shape = (1, 40, 56, 3)
  capture.fail = True
  enh._stream_graph(shape, None)
  with caplog.at_level(logging.WARNING, logger='hdrnet_torch.inference'):
    assert enh._stream_graph(shape, None) is None
  warned = [r for r in caplog.records if 'CUDA graph' in r.getMessage()]
  assert len(warned) == 1
  capture.fail = False
  caplog.clear()
  for _ in range(3):  # not tried again
    assert enh._stream_graph(shape, None) is None
  assert capture.made == [] and not caplog.records


def test_holding_tables_keeps_what_the_caches_hand_out():
  dev = torch.device('cpu')
  iy = resize.nearest_index_tensor(1000, 17, dev)  # cached before
  with resize.holding_tables() as held:
    hit = resize.nearest_index_tensor(1000, 17, dev)
    taps = resize.linear_tap_tensors(1000, 17, True, dev)
    k2 = downsample._k2_tables(1000, 999, 17, dev)
  assert hit is iy
  assert held[0] is iy and held[1] is taps and held[-1] is k2
  n = len(held)
  resize.nearest_index_tensor(1000, 17, dev)
  assert len(held) == n  # nothing held outside the block
  resize.nearest_index_tensor.cache_clear()
  assert resize.nearest_index_tensor(1000, 17, dev) is not iy


def test_to_unit_divides_by_255_with_a_cached_divisor():
  x = torch.from_numpy(np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1))
  got = downsample.to_unit(x)
  want = np.arange(256, dtype=np.float32) / np.float32(255)
  assert np.array_equal(got.numpy().ravel(), want)
  assert downsample._unit_divisor(x.device) is downsample._unit_divisor(
      x.device)
  f = torch.rand(1, 4, 4, 3)
  assert downsample.to_unit(f) is f
