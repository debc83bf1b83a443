"""Device-resident dataset: the whole training set lives in device memory
(counterpart of ``hdrnet_tpu.data.device``).

HDRNet datasets are small (hundreds of photos) and a step's compute is
small too, so the host input pipeline (decode, augment, the batch copy)
can take much of a step. This module uploads every decoded sample once,
in its raw dtype (a 220-image 1024^2 uint8 set is about 1.4 GB), and
runs the reference's augmentation chain (crop -> fliplr/flipud -> rot90
-> nearest lowres, data_pipeline.py:126-171) on the device as index
gathers. The host's work a step is drawing a few integers.

Every sample must decode to one common (H, W, C) shape, and rotation
needs a square crop; the training loop falls back to the host pipeline
otherwise. The flips and rotations are index gathers (and a transposed
gather), not ``torch.flip``/``torch.rot90``, which have no uint16 kernel
on the CPU; CUDA has no uint16 indexing kernel, so uint16 data is
gathered through an int16 view of its bits.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from hdrnet_torch.data import hostops, images

log = logging.getLogger('hdrnet_torch.data')


def _nearest_indices(src, dst):
  """Legacy-TF nearest indices, floor(dst * src / dst_len) in float64."""
  return np.minimum((np.arange(dst) * (src / dst)).astype(np.int64),
                    src - 1)


def _bits(x):
  """`x`, or the int16 view of a uint16 tensor (same bits; indexing and
  concatenation have kernels for it everywhere)."""
  return x.view(torch.int16) if x.dtype == torch.uint16 else x


def _unbits(x, dtype):
  return x.view(torch.uint16) if dtype == torch.uint16 else x


def _upload(a, device):
  """numpy (N, H, W, C) array -> contiguous tensor on `device`, in its
  dtype."""
  return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def make_device_augment(output_resolution, net_input_size, rotate):
  """Returns augment(inputs, outputs, params) -> batch dict.

  inputs/outputs: (B, H, W, C) raw-dtype tensors on one device (a
  gathered batch; a sequence of (H, W, C) tensors also works). params:
  dict of (B,) host integer arrays {y0, x0, fliplr, flipud, rot_k}. For
  each sample: the (oh, ow) crop at (y0, x0), then fliplr, then flipud,
  then ``rot90(rot_k)`` (the host pipeline's order), then the nearest
  lowres preview. The result keeps the raw dtype: the train step's
  ``normalize_batch`` divides by the dtype's white level. The samples
  are looped over on the host, so choosing a rotation costs no device
  synchronization.
  """
  oh, ow = output_resolution
  if rotate and oh != ow:
    raise ValueError('device augmentation with rotation needs square '
                     f'output_resolution, got {output_resolution}')
  low_iy = _nearest_indices(oh, net_input_size)
  low_ix = _nearest_indices(ow, net_input_size)
  tables = {}

  def index(dev):
    """Per device: arange(oh), arange(ow) and the preview tables."""
    if dev not in tables:
      tables[dev] = [torch.arange(n, device=dev) for n in (oh, ow)] + [
          torch.from_numpy(t).to(dev) for t in (low_iy, low_ix)]
    return tables[dev]

  def crop_index(dev, y0, x0, fl, fu, k):
    """(row, column) index tensors whose gather is the transformed crop:
    the flips reverse an axis; ``np.rot90(c, k)[i, j]`` is c[j, W-1-i]
    (k=1), c[H-1-i, W-1-j] (k=2), c[H-1-j, i] (k=3), a gather with the
    index axes exchanged."""
    ar_h, ar_w = index(dev)[:2]
    rows, cols = y0 + ar_h, x0 + ar_w
    rows_rev, cols_rev = (y0 + oh - 1) - ar_h, (x0 + ow - 1) - ar_w
    if fl:
      cols, cols_rev = cols_rev, cols
    if fu:
      rows, rows_rev = rows_rev, rows
    k = k % 4 if rotate else 0
    if k == 0:
      return rows[:, None], cols[None, :]
    if k == 1:
      return rows[None, :], cols_rev[:, None]
    if k == 2:
      return rows_rev[:, None], cols_rev[None, :]
    return rows_rev[None, :], cols[:, None]

  def augment(inputs, outputs, params):
    dtypes = {'input': inputs[0].dtype, 'output': outputs[0].dtype}
    out = {'image_input': [], 'lowres_input': [], 'image_output': [],
           'lowres_output': []}
    for b in range(len(params['y0'])):
      dev = inputs[b].device
      ri, ci = crop_index(dev, *(int(params[k][b]) for k in (
          'y0', 'x0', 'fliplr', 'flipud', 'rot_k')))
      liy, lix = index(dev)[2:]
      for side, x in (('input', inputs[b]), ('output', outputs[b])):
        full = _bits(x)[ri, ci]
        out['image_' + side].append(full)
        out['lowres_' + side].append(full[liy[:, None], lix[None, :]])
    return {k: _unbits(torch.stack(v), dtypes[k.split('_')[1]])
            for k, v in out.items()}

  return augment


class DeviceDataset:
  """Uploads a decoded dataset once; draws each step's augmentation
  parameters.

  `pairs` is a list of (input_array, output_array) raw-dtype numpy
  samples of one common shape; or pass pairs=None and (N, H, W, C)
  tensors on `device` as `arrays=(inputs, outputs)` (the synthetic
  pipelines build their targets on the device). ``nbytes`` is the
  resident size.
  """

  def __init__(self, pairs, cfg, device, arrays=None):
    if arrays is not None:
      if pairs is not None:
        raise TypeError('pass pairs or arrays, not both')
      self.inputs, self.outputs = arrays
    else:
      shapes = {(a.shape, b.shape) for a, b in pairs}
      if len(shapes) != 1:
        raise ValueError(f'device dataset needs uniform shapes, got '
                         f'{sorted(shapes)[:3]}...')
      self.inputs = _upload(np.stack([a for a, _ in pairs]), device)
      self.outputs = _upload(np.stack([b for _, b in pairs]), device)
    if self.inputs.dtype != self.outputs.dtype:
      # A mixed-depth pair would be divided by the wrong white level;
      # the host pipeline normalizes each file by its own.
      names = [str(t.dtype).replace('torch.', '')
               for t in (self.inputs, self.outputs)]
      raise ValueError(
          f'device dataset needs matching input/output dtypes, got '
          f'{names[0]} vs {names[1]}; use the host pipeline '
          f'(--nodevice_data) for mixed-depth datasets')
    self.nsamples = int(self.inputs.shape[0])
    self.cfg = cfg
    h, w = self.inputs.shape[1:3]
    oh, ow = cfg.output_resolution
    if h < oh or w < ow:
      raise ValueError(f'images {h}x{w} smaller than crop {oh}x{ow}')
    self._max_y0 = h - oh
    self._max_x0 = w - ow
    if cfg.rotate and oh != ow:
      raise ValueError('rotation needs square output_resolution')
    self.nbytes = sum(t.numel() * t.element_size()
                      for t in (self.inputs, self.outputs))
    log.info('device dataset: %d samples x %s resident (%.2f GB on %s)',
             self.nsamples, tuple(self.inputs.shape[1:]), self.nbytes / 1e9,
             self.inputs.device)

  def param_stream(self, seed, batch_size):
    """Infinite epochs of shuffled sample indices and augmentation draws:
    one shuffled permutation an epoch, each sample once an epoch (the
    host pipeline's contract), with the JAX package's draws for a
    seed."""
    rng = np.random.RandomState(seed)
    cfg = self.cfg
    order = np.arange(self.nsamples)
    pending = []
    while True:
      if cfg.shuffle:
        rng.shuffle(order)
      pending.extend(order.tolist())
      while len(pending) >= batch_size:
        idx = np.asarray(pending[:batch_size], np.int32)
        del pending[:batch_size]
        bs = batch_size
        if cfg.random_crop:
          y0 = rng.randint(0, self._max_y0 + 1, bs)
          x0 = rng.randint(0, self._max_x0 + 1, bs)
        else:
          y0 = np.full(bs, self._max_y0 // 2)
          x0 = np.full(bs, self._max_x0 // 2)
        yield {
            'idx': idx,
            'y0': y0.astype(np.int32),
            'x0': x0.astype(np.int32),
            'fliplr': (cfg.fliplr * rng.randint(0, 2, bs)).astype(np.int32),
            'flipud': (cfg.flipud * rng.randint(0, 2, bs)).astype(np.int32),
            'rot_k': (rng.randint(0, 4, bs) if cfg.rotate
                      else np.zeros(bs)).astype(np.int32),
        }


def load_pairs(pipeline):
  """Decodes every sample of an ImageFilesDataPipeline raw (no crop or
  augmentation: that happens on the device)."""
  return [(pipeline._read_raw(in_path), pipeline._read_raw(out_path))
          for in_path, out_path in pipeline.specs]


def _gauss_taps(sigma):
  """The native library's float32 blur taps (``hdrnet_io.cc:217-224``):
  radius int(3 sigma + 0.5) (at least 1), a normalized float32
  Gaussian."""
  radius = max(1, int(sigma * 3.0 + 0.5))
  d = np.arange(-radius, radius + 1, dtype=np.float32)
  kern = np.exp(-0.5 * d * d / np.float32(sigma * sigma),
                dtype=np.float32)
  return radius, kern / kern.sum()


def _symmetric_table(n, radius):
  """Source index of each padded position under numpy's 'symmetric'
  boundary (-1 reads 0), also for a radius larger than `n`."""
  return np.pad(np.arange(n), radius, mode='symmetric')


def make_usm_synth(blur_sigma, sharpen):
  """(..., H, W, C) raw-dtype tensor -> same-dtype unsharp target.

  The device counterpart of ``UnsharpMaskDataPipeline._load`` and the
  file writer: normalize by the dtype's white level, a separable
  Gaussian blur with the native taps and numpy's symmetric boundary
  (``F.pad``'s reflect skips the edge sample), each pass summing the
  taps in order; target = clip(x + sharpen (x - blur), 0, 1),
  requantized round-half-up at the input's white level and dtype (a
  16-bit set keeps 16-bit targets, so input and target share a white
  level). The float32 sums run in another order than the host blur's,
  so a target can differ from the file path's by one quantum at a tie.
  """
  radius, kern = _gauss_taps(blur_sigma)

  def blur1d(x, dim, taps):
    n = x.shape[dim]
    table = torch.from_numpy(_symmetric_table(n, radius)).to(x.device)
    pad = x.index_select(dim, table)
    out = 0
    for i in range(2 * radius + 1):
      out = out + taps[i] * pad.narrow(dim, i, n)
    return out

  def synth(raw):
    white = {torch.uint8: 255.0, torch.uint16: 65535.0}.get(raw.dtype, 1.0)
    x = raw.to(torch.float32) / white if white != 1.0 else raw
    taps = torch.from_numpy(kern).to(x.device)
    blur = blur1d(blur1d(x, -2, taps), -3, taps)
    target = torch.clamp(x + sharpen * (x - blur), 0.0, 1.0)
    if white == 1.0:
      return target.to(raw.dtype)
    return (target * white + 0.5).to(raw.dtype)

  return synth


def load_st_dataset(pipeline, cfg, device):
  """Device-resident StyleTransferDataPipeline: each (input x style)
  spec becomes one resident sample whose 6 input channels are the uint8
  photo and the bilinear-resized style exemplar requantized to uint8
  (the host path keeps the exemplar in float, so the resident copy is
  within 1/510 of it; the exemplar is a conditioning signal, not a
  regression target). Outputs are the per-style target files."""
  ins, outs = [], []
  exemplars = {}
  for in_path, model_path, out_path in pipeline.specs:
    inp = images.imread(in_path)
    out = images.imread(out_path)
    if inp.dtype != np.uint8 or out.dtype != np.uint8:
      raise ValueError('device st dataset supports uint8 sources only; '
                       'use the host pipeline for 16-bit data')
    key = (model_path, inp.shape[:2])
    if key not in exemplars:
      mdl = images.imread_float(model_path)
      mdl = hostops.resize_bilinear(mdl, inp.shape[:2])
      exemplars[key] = (np.clip(mdl, 0.0, 1.0) * 255.0 + 0.5).astype(
          np.uint8)
    ins.append(np.concatenate([inp, exemplars[key]], axis=-1))
    outs.append(out)
  shapes = {a.shape for a in ins}
  if len(shapes) != 1:
    raise ValueError(f'device dataset needs uniform shapes, got '
                     f'{sorted(shapes)[:3]}...')
  return DeviceDataset(None, cfg, device,
                       arrays=(_upload(np.stack(ins), device),
                               _upload(np.stack(outs), device)))


def load_usm_dataset(pipeline, cfg, device):
  """Device-resident UnsharpMaskDataPipeline: the raw inputs decoded
  once and uploaded, every target synthesized on the device once,
  16 images a chunk."""
  raws = [images.imread(p) for p in pipeline._sample_paths()]
  shapes = {a.shape for a in raws}
  if len(shapes) != 1:
    raise ValueError(f'device dataset needs uniform shapes, got '
                     f'{sorted(shapes)[:3]}...')
  ins = _upload(np.stack(raws), device)
  synth = make_usm_synth(cfg.blur_sigma, cfg.sharpen)
  outs = torch.cat([synth(ins[i:i + 16]) for i in range(0, len(raws), 16)])
  return DeviceDataset(None, cfg, device, arrays=(ins, outs))
