"""Dataset metadata bookkeeping (the port's own copy of
``hdrnet_tpu.utils.metadata``; reference: hdrnet/metadata.py:21-45).

nsamples.json + timestamps.json next to a dataset directory.
"""

from __future__ import annotations

import json
import os


def write_dataset_meta(path, nsamples, fname_to_timestamp_map):
  with open(os.path.join(path, 'nsamples.json'), 'w') as f:
    json.dump({'nsamples': nsamples}, f, indent=2)
  with open(os.path.join(path, 'timestamps.json'), 'w') as f:
    json.dump(fname_to_timestamp_map, f, indent=2, sort_keys=True)


def get_dataset_meta(path):
  with open(os.path.join(path, 'nsamples.json')) as f:
    meta = json.load(f)
  with open(os.path.join(path, 'timestamps.json')) as f:
    timestamps = json.load(f)
  return meta, timestamps
