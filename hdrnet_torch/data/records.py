"""Self-describing record shards (the port's own copy of
``hdrnet_tpu.data.records``: the reference's RecordWriter/Reader,
data_pipeline.py:363-531, rebuilt without TFRecords).

Format: one ``.npz`` file per shard holding ``{i:05d}.{feature}`` arrays
— shapes and dtypes are self-describing by construction, replacing the
reference's `_sz`/`_dtype` feature triplets and its
read-one-record-in-a-throwaway-session shape bootstrap
(data_pipeline.py:453-475).

`convert_tfrecords` ingests the reference's actual HDR+ .tfrecords
(uint16 mosaics, TYPEMAP at data_pipeline.py:349-361) when tensorflow
is importable, so existing datasets migrate losslessly.
"""

from __future__ import annotations

import glob
import os

import numpy as np

FEATURES = ('image_input', 'image_output')


class ShardWriter:
  """Accumulates samples (dicts of numpy arrays) into .npz shards."""

  def __init__(self, output_dir, records_per_file=500, prefix=''):
    self.output_dir = output_dir
    self.records_per_file = records_per_file
    self.prefix = prefix
    self.written = 0
    self.n_files = 0
    self._buf = []
    os.makedirs(output_dir, exist_ok=True)

  def write(self, sample):
    self._buf.append(dict(sample))
    self.written += 1
    if len(self._buf) >= self.records_per_file:
      self._flush()
    return self._next_name()

  def _next_name(self):
    return os.path.join(self.output_dir,
                        f'{self.prefix}{self.n_files + 1:06d}.npz')

  def _flush(self):
    if not self._buf:
      return
    arrays = {}
    for i, sample in enumerate(self._buf):
      for k, v in sample.items():
        arrays[f'{i:05d}.{k}'] = np.asarray(v)
    self.n_files += 1
    path = os.path.join(self.output_dir,
                        f'{self.prefix}{self.n_files:06d}.npz')
    np.savez(path, **arrays)
    self._buf = []

  def close(self):
    self._flush()

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    self.close()


class ShardReader:
  """Iterates samples from .npz shards; knows shapes/dtypes up front."""

  def __init__(self, filenames):
    if isinstance(filenames, str):
      filenames = sorted(glob.glob(filenames))
    self.filenames = list(filenames)
    assert self.filenames, 'no record shards found'
    # Bootstrap shapes/dtypes from the first sample of the first shard.
    first = self._load_shard(self.filenames[0])
    self.shapes = {k: v.shape for k, v in first[0].items()}
    self.dtypes = {k: v.dtype for k, v in first[0].items()}

  @staticmethod
  def _load_shard(path):
    with np.load(path) as z:
      samples = {}
      for key in z.files:
        idx, name = key.split('.', 1)
        samples.setdefault(int(idx), {})[name] = z[key]
    return [samples[i] for i in sorted(samples)]

  def __iter__(self):
    for path in self.filenames:
      yield from self._load_shard(path)

  def __len__(self):
    return sum(len(self._load_shard(p)) for p in self.filenames)


def convert_tfrecords(tfrecord_paths, output_dir, records_per_file=500):
  """Migrates reference-format .tfrecords into .npz shards.

  Requires tensorflow (an optional dependency, imported only here).
  The reference serialized each feature as raw bytes + `_sz` (shape) +
  `_dtype` (TYPEMAP index) int64 features (data_pipeline.py:400-404).
  """
  import tensorflow as tf  # gated import

  reverse_typemap = {0: np.uint8, 1: np.int16, 2: np.float32, 3: np.int32}
  writer = ShardWriter(output_dir, records_per_file)
  n = 0
  for path in tfrecord_paths:
    for raw in tf.compat.v1.io.tf_record_iterator(path):
      ex = tf.train.Example()
      ex.ParseFromString(raw)
      feat = ex.features.feature
      sample = {}
      for name in FEATURES:
        data = feat[name].bytes_list.value[0]
        shape = tuple(feat[name + '_sz'].int64_list.value)
        dtype = reverse_typemap[feat[name + '_dtype'].int64_list.value[0]]
        sample[name] = np.frombuffer(data, dtype=dtype).reshape(shape)
      writer.write(sample)
      n += 1
  writer.close()
  return n
