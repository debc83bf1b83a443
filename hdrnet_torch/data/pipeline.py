"""Input pipelines: decode -> normalize -> augment -> batch -> prefetch.

The port's own copy of ``hdrnet_tpu.data.pipeline``, a replacement for
the reference's TF1 queue-runner pipelines (data_pipeline.py:52-342):
plain Python iterators over numpy, with the image operations in numpy
(:mod:`hdrnet_torch.data.hostops`) and background worker threads
standing in for queue runners (`nthreads`/`--data_threads`). The JAX
package's device-prefetch wrapper is not copied: the port's training
loop makes its own pinned, non-blocking copies
(``hdrnet_torch.training.step.to_device``).

Sample dict keys match the reference (data_pipeline.py:100-101,237-241):
  lowres_input, lowres_output, image_input, image_output
with lowres = net_input_size**2 nearest-resampled
(data_pipeline.py:165-169).

Pipelines:
  ImageFilesDataPipeline   filelist.txt + input/ + output/ dirs,
                           8/16-bit autodetect (dp.py:174-241)
  HDRpDataPipeline         record shards, white levels 32767/255
                           (dp.py:244-287)
  StyleTransferDataPipeline  (input x target) cross product, 6-channel
                           inputs (dp.py:290-342)
  UnsharpMaskDataPipeline  synthetic target = input + sharpen *
                           (input - gaussian_blur(input, sigma))
                           (capability referenced by scripts/usm/*.sh)
"""

from __future__ import annotations

import glob
import os
import queue
import random
import threading

import numpy as np

from hdrnet_torch.config import DataConfig
from hdrnet_torch.data import hostops, images


def _as_float01(arr):
  """Raw decoded image -> float32 [0,1] by its OWN dtype white level."""
  if arr.dtype in (np.float32, np.float64):
    return np.asarray(arr, np.float32)
  white = 65535.0 if arr.dtype == np.uint16 else 255.0
  return hostops.to_float(arr, white)


def _stack_batch(samples):
  """Stacks per-key; mixed storage depths across samples fall back to
  the float path (np.stack would silently promote a uint8 sample into a
  uint16 batch and the on-device normalize would then scale it by the
  wrong white level)."""
  batch = {}
  for k in samples[0]:
    arrs = [s[k] for s in samples]
    if len({a.dtype for a in arrs}) > 1:
      arrs = [_as_float01(a) for a in arrs]
    batch[k] = np.stack(arrs)
  return batch


class _WorkerFailure:
  """Sentinel carrying a worker exception to the consuming thread."""

  def __init__(self, spec, exc):
    self.spec, self.exc = spec, exc


def check_dir(dirname):
  """Validates the filelist.txt + input/ + output/ layout
  (data_pipeline.py:36-49)."""
  if not os.path.isdir(dirname):
    raise ValueError(f'data dir {dirname} does not exist')
  names = os.listdir(dirname)
  for required in ('filelist.txt', 'input', 'output'):
    if required not in names:
      raise ValueError(f'data dir {dirname} missing {required!r}')


class DataPipeline:
  """Base: augmentation, batching, threaded prefetch.

  Subclasses implement `_sample_paths()` -> list of per-sample specs and
  `_load(spec, rng)` -> dict with float32 'image_input'/'image_output'
  (full, pre-crop resolution).
  """

  def __init__(self, path, config: DataConfig = None, **overrides):
    cfg = config or DataConfig()
    for k, v in overrides.items():
      setattr(cfg, k, v)
    self.cfg = cfg
    # Reference workloads address datasets by their filelist
    # (scripts/ll/train_std.sh passes .../train/filelist.txt); accept
    # both that and the dataset directory itself.
    if os.path.basename(path) == 'filelist.txt':
      path = os.path.dirname(path) or '.'
    self.path = path
    self.specs = self._sample_paths()
    if not self.specs:
      raise ValueError(f'no samples found under {path}')
    self.nsamples = len(self.specs)
    self._epoch = 0

  # ----- subclass hooks ---------------------------------------------

  def _sample_paths(self):
    raise NotImplementedError

  def _load(self, spec, rng):
    raise NotImplementedError

  # ----- augmentation (reference order: data_pipeline.py:126-171) ----

  def _augment(self, inp, out, rng):
    cfg = self.cfg
    oh, ow = cfg.output_resolution
    both = np.concatenate([inp, out], axis=-1)
    h, w = both.shape[:2]

    fliplr = cfg.fliplr and rng.rand() < 0.5
    flipud = cfg.flipud and rng.rand() < 0.5
    rot_k = int(rng.randint(4)) if cfg.rotate else 0
    # The reference transforms the full frame and then crops
    # (data_pipeline.py:129-158); cropping a window in the *source*
    # frame and transforming only it is identical for center crops and
    # identically distributed for uniform random crops — and one pass
    # over the window instead of a full-frame rotate.
    ch, cw = (ow, oh) if rot_k % 2 else (oh, ow)
    if h < ch or w < cw:
      raise ValueError(
          f'image {h}x{w} smaller than crop {ch}x{cw} '
          f'(output_resolution {oh}x{ow}, rot_k={rot_k})')
    if cfg.random_crop:
      y0 = int(rng.randint(h - ch + 1))
      x0 = int(rng.randint(w - cw + 1))
    else:
      y0 = (h - ch) // 2
      x0 = (w - cw) // 2
    full = hostops.crop_flip_rot(both, y0, x0, ch, cw, fliplr, flipud,
                                rot_k)
    assert full.shape[:2] == (oh, ow), full.shape
    low = hostops.resize_nearest(
        full, (cfg.net_input_size, cfg.net_input_size))
    return {
        'image_input': full[:, :, :inp.shape[-1]],
        'image_output': full[:, :, inp.shape[-1]:],
        'lowres_input': low[:, :, :inp.shape[-1]],
        'lowres_output': low[:, :, inp.shape[-1]:],
    }

  # ----- iteration ---------------------------------------------------

  def _sample_iter(self, seed):
    rng = np.random.RandomState(seed)
    order = list(range(self.nsamples))
    while True:
      if self.cfg.shuffle:
        rng.shuffle(order)
      for i in order:
        inp, out = self._load(self.specs[i], rng)
        yield self._augment(inp, out, rng)

  def batches(self, seed=0):
    """Infinite iterator of stacked numpy batches."""
    it = self._sample_iter(seed)
    bs = self.cfg.batch_size
    while True:
      yield _stack_batch([next(it) for _ in range(bs)])

  def prefetching_batches(self, seed=0, capacity=4):
    """batches() with `data_threads` workers sharing one epoch order.

    Sample-level parallelism like the reference's queue runners
    (data_pipeline.py:107-124): a single feeder thread emits one
    shuffled permutation of sample indices per epoch, `data_threads`
    workers load+augment them concurrently, and batches are stacked
    from the shared sample stream. The feeder waits for each epoch to
    be fully produced before starting the next, so every sample
    appears exactly once per epoch across all workers — N workers do
    NOT see N duplicate shuffled streams.
    """
    n_workers = max(1, int(self.cfg.data_threads))
    bs = self.cfg.batch_size
    idx_q = queue.Queue(maxsize=2 * n_workers + bs)
    sample_q = queue.Queue(maxsize=max(capacity * bs, n_workers + 1))
    stop = threading.Event()
    produced = [0]
    produced_cv = threading.Condition()

    def feeder():
      rng = np.random.RandomState(seed)
      order = list(range(self.nsamples))
      target = 0
      while not stop.is_set():
        if self.cfg.shuffle:
          rng.shuffle(order)
        for i in order:
          while not stop.is_set():
            try:
              idx_q.put(i, timeout=0.1)
              break
            except queue.Full:
              continue
          if stop.is_set():
            return
        # Epoch barrier: don't feed epoch k+1 until epoch k is fully
        # produced, so the consumed stream is exactly epoch-partitioned.
        target += self.nsamples
        with produced_cv:
          while produced[0] < target and not stop.is_set():
            produced_cv.wait(timeout=0.1)

    def worker(wid):
      rng = np.random.RandomState(seed * 1000003 + wid + 1)
      while not stop.is_set():
        try:
          i = idx_q.get(timeout=0.1)
        except queue.Empty:
          continue
        try:
          inp, out = self._load(self.specs[i], rng)
          sample = self._augment(inp, out, rng)
        except Exception as e:  # propagate: a silently dead worker
          # would stall the epoch barrier and hang training forever.
          sample = _WorkerFailure(self.specs[i], e)
        while not stop.is_set():
          try:
            sample_q.put(sample, timeout=0.1)
            break
          except queue.Full:
            continue
        with produced_cv:
          produced[0] += 1
          produced_cv.notify()

    threads = [threading.Thread(target=feeder, daemon=True)]
    threads += [threading.Thread(target=worker, args=(w,), daemon=True)
                for w in range(n_workers)]
    for t in threads:
      t.start()
    try:
      while True:
        samples = []
        for _ in range(bs):
          s = sample_q.get()
          if isinstance(s, _WorkerFailure):
            raise RuntimeError(
                f'data worker failed on sample {s.spec}') from s.exc
          samples.append(s)
        yield _stack_batch(samples)
    finally:
      stop.set()


class ImageFilesDataPipeline(DataPipeline):
  """filelist.txt + input/ + output/ paired images
  (data_pipeline.py:174-241)."""

  def _sample_paths(self):
    dirname = os.path.dirname(self.path) if self.path.endswith('.txt') \
        else self.path
    flist_path = self.path if self.path.endswith('.txt') \
        else os.path.join(self.path, 'filelist.txt')
    check_dir(dirname)
    with open(flist_path) as f:
      names = [l.strip() for l in f if l.strip()]
    return [(os.path.join(dirname, 'input', n),
             os.path.join(dirname, 'output', n)) for n in names]

  def _load(self, spec, rng):
    del rng
    in_path, out_path = spec
    inp, out = self._read(in_path), self._read(out_path)
    if inp.dtype != out.dtype:  # mixed storage depths: float path
      inp, out = self._to_float(inp), self._to_float(out)
    return inp, out

  @staticmethod
  def _to_float(arr):
    return _as_float01(arr)

  def _read(self, path):
    """Decoded image: raw dtype when device_normalize (the train step
    divides by the dtype white level on the device), float32 otherwise."""
    raw = self._read_raw(path)
    if self.cfg.device_normalize:
      return raw
    return self._to_float(raw)

  def _read_raw(self, path):
    if not self.cfg.cache_images:
      return images.imread(path)
    cache = self.__dict__.setdefault('_img_cache', {})
    hit = cache.get(path)
    if hit is None:
      # Cache the raw dtype (1/4 the RAM of f32).
      cache[path] = hit = images.imread(path)
    return hit


class HDRpDataPipeline(DataPipeline):
  """Record shards of (image_input uint16-ish, image_output uint8-ish)
  with HDR+ white levels: input 32767, output 255
  (data_pipeline.py:267-269)."""

  INPUT_WHITE_LEVEL = 32767.0
  OUTPUT_WHITE_LEVEL = 255.0

  def _sample_paths(self):
    if os.path.isdir(self.path):
      pattern = os.path.join(self.path, '*.npz')
    elif self.path.endswith('.txt'):
      root = os.path.dirname(os.path.abspath(self.path))
      with open(self.path) as f:
        return [[os.path.join(root, l.strip())] for l in f if l.strip()]
    else:
      pattern = self.path
    self._reader = None
    return [[p] for p in sorted(glob.glob(pattern))]

  def _shard_samples(self, shard):
    from hdrnet_torch.data.records import ShardReader
    return ShardReader([shard])

  def _load(self, spec, rng):
    reader = self._shard_samples(spec[0])
    samples = list(reader)
    s = samples[int(rng.randint(len(samples)))]
    in_wl = self.cfg.input_white_level or self.INPUT_WHITE_LEVEL
    out_wl = self.cfg.output_white_level or self.OUTPUT_WHITE_LEVEL
    return (hostops.to_float(s['image_input'], in_wl),
            hostops.to_float(s['image_output'], out_wl))


class StyleTransferDataPipeline(DataPipeline):
  """(input x style-target) cross product; the style image is
  concatenated to the input -> 6-channel inputs
  (data_pipeline.py:290-342)."""

  def _sample_paths(self):
    with open(os.path.join(self.path, 'filelist.txt')) as f:
      flist = [l.strip() for l in f if l.strip()]
    with open(os.path.join(self.path, 'targets.txt')) as f:
      tlist = [l.strip() for l in f if l.strip()]
    specs = []
    for fname in flist:
      for t in tlist:
        specs.append((os.path.join(self.path, 'input', fname),
                      os.path.join(self.path, 'input', t + '.png'),
                      os.path.join(self.path, 'output', t, fname)))
    return specs

  def _load(self, spec, rng):
    del rng
    in_path, model_path, out_path = spec
    inp = images.imread_float(in_path)
    mdl = images.imread_float(model_path)
    out = images.imread_float(out_path)
    mdl = hostops.resize_bilinear(mdl, inp.shape[:2])
    return np.concatenate([inp, mdl], axis=-1), out


class UnsharpMaskDataPipeline(DataPipeline):
  """Synthetic operator: target = input + sharpen * (input - blur).

  The reference's scripts train a 'usm' operator with --blur_sigma /
  --sharpen flags (scripts/usm/*.sh); its pipeline class predates the
  published snapshot, so the target is synthesized here on the fly.
  Data layout: any directory of images, or filelist.txt + input/.
  """

  def _sample_paths(self):
    if os.path.isfile(os.path.join(self.path, 'filelist.txt')):
      with open(os.path.join(self.path, 'filelist.txt')) as f:
        names = [l.strip() for l in f if l.strip()]
      return [os.path.join(self.path, 'input', n) for n in names]
    exts = ('.png', '.jpg', '.jpeg', '.tif', '.tiff')
    return sorted(os.path.join(self.path, n) for n in os.listdir(self.path)
                  if n.lower().endswith(exts))

  def _load(self, spec, rng):
    del rng
    raw = images.imread(spec)
    white = 65535.0 if raw.dtype == np.uint16 else 255.0
    inp = hostops.to_float(raw, white)
    blurred = hostops.gaussian_blur(inp, self.cfg.blur_sigma)
    target = np.clip(inp + self.cfg.sharpen * (inp - blurred), 0.0, 1.0)
    # Round-half-up at the source white level: the device-resident
    # path (device.make_usm_synth) and the materialized-file path
    # (scripts/make_usm_dataset.py) both store quantized targets, so
    # quantize here too — all three USM paths train on identical data
    # and a silent host fallback no longer changes the targets.
    target = np.floor(target * white + 0.5) / white
    return inp, target.astype(np.float32)


PIPELINES = {
    'ImageFilesDataPipeline': ImageFilesDataPipeline,
    'HDRpDataPipeline': HDRpDataPipeline,
    'StyleTransferDataPipeline': StyleTransferDataPipeline,
    'UnsharpMaskDataPipeline': UnsharpMaskDataPipeline,
}


def make_pipeline(path, cfg: DataConfig):
  try:
    cls = PIPELINES[cfg.pipeline]
  except KeyError:
    raise ValueError(
        f'unknown pipeline {cfg.pipeline!r}; choices: {sorted(PIPELINES)}')
  return cls(path, cfg)

