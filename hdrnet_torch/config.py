"""Typed configuration for models, data, and training.

The port's own copy of ``hdrnet_tpu.config`` (standard library only): the
same dataclasses, defaults and JSON schema, so a ``config.json`` written
by either package loads in the other field for field. Replaces the
reference's argparse-group-as-schema pattern (bin/train.py:224-244) and
its graph-collection persistence (bin/train.py:61-63): configs are
dataclasses serialized to JSON next to every checkpoint, so the serving
and evaluation tools rebuild the right architecture with no flags.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional


@dataclasses.dataclass
class ModelConfig:
  """Architecture hyperparameters (reference: bin/train.py:224-236)."""
  model_name: str = 'HDRNetCurves'
  net_input_size: int = 256
  output_resolution: List[int] = dataclasses.field(
      default_factory=lambda: [512, 512])
  luma_bins: int = 8
  spatial_bin: int = 16
  channel_multiplier: int = 1
  guide_complexity: int = 16
  batch_norm: bool = False
  # Input/output channel counts (3 each for photos; style transfer
  # concatenates the style target into the input).
  n_in: int = 3
  n_out: int = 3
  # Baseline-model knobs (UNet / DilatedConvolutions,
  # cf. scripts/ll/train_unet.sh --depth/--width).
  depth: int = 5
  width: int = 32

  @property
  def grid_height(self):
    return self.spatial_bin

  @property
  def grid_width(self):
    return self.spatial_bin


@dataclasses.dataclass
class DataConfig:
  """Data pipeline settings (reference: bin/train.py:211-221)."""
  pipeline: str = 'ImageFilesDataPipeline'
  batch_size: int = 16
  output_resolution: List[int] = dataclasses.field(
      default_factory=lambda: [512, 512])
  net_input_size: int = 256
  fliplr: bool = False
  flipud: bool = False
  rotate: bool = False
  random_crop: bool = True
  shuffle: bool = True
  data_threads: int = 2
  # Keep decoded (raw-dtype) images resident after first read — turns a
  # PNG-decode-bound host (one core feeding a fast chip) into augment-
  # only work. Off by default: matches the reference's re-decode
  # behavior and caps memory on big datasets.
  cache_images: bool = False
  # Ship batches to the device in their storage dtype (uint8/uint16)
  # and normalize to [0, 1] inside the jitted step (training.step.
  # normalize_batch). Augmentation is index-only, so it runs on raw
  # bytes: 4x (uint8) less host memcpy and host->device transfer than
  # the float pipeline. ImageFilesDataPipeline only (HDR+ records use
  # non-dtype white levels and stay on the float path).
  device_normalize: bool = False
  # Keep the ENTIRE decoded dataset resident in device memory and run
  # the augmentation chain on the device, as index gathers
  # (data/device.py): a step's host work drops to a few integer draws.
  # Needs uniform image shapes and a dataset that fits device memory;
  # implies normalize-on-device. ImageFilesDataPipeline,
  # UnsharpMaskDataPipeline (targets synthesized on the device at
  # upload, data/device.py load_usm_dataset) and
  # StyleTransferDataPipeline; other pipelines and non-uniform datasets
  # fall back to the host pipeline.
  device_data: bool = False
  # UnsharpMask synthetic pipeline knobs (scripts/usm/*.sh).
  blur_sigma: float = 4.0
  sharpen: float = 1.0
  # HDR+ white levels (data_pipeline.py:267-269).
  input_white_level: Optional[float] = None
  output_white_level: Optional[float] = None


@dataclasses.dataclass
class TrainConfig:
  """Optimization + bookkeeping (reference: bin/train.py:197-204)."""
  learning_rate: float = 1e-4
  # Learning-rate schedule. 'constant' is the reference behavior (Adam
  # at a fixed lr forever, bin/train.py:108,199); 'cosine' decays from
  # learning_rate to lr_end over lr_decay_steps (default: max_steps)
  # after lr_warmup_steps of linear warmup — a beyond-reference knob
  # that squeezes out the last dB once the fixed-lr curve plateaus.
  lr_schedule: str = 'constant'
  lr_decay_steps: Optional[int] = None
  lr_end: float = 0.0
  lr_warmup_steps: int = 0
  # Multiply the guide modules' learning rate (diagnosis: the curve
  # guide's dynamic range collapses early under the full lr, costing
  # ~1.5 dB of grid depth resolution — PARITY.md "Quality parity").
  # 1.0 = reference behavior (single global lr).
  guide_lr_scale: float = 1.0
  # Guide-range regularizer weight (0 = off, reference behavior). When
  # on, adds guide_reg * mean(relu(guide_reg_target - std(guide))^2)
  # to the loss, where std is the per-image pixel std of each sown
  # guide map. Direct counter to the diagnosed collapse failure mode
  # (results/QUALITY.md "guide collapse"): a guide whose std falls
  # under the target pays a smooth hinge penalty, so shrinking the
  # guide's dynamic range stops being the early local optimum.
  guide_reg: float = 0.0
  guide_reg_target: float = 0.2
  log_interval: int = 1          # seconds
  summary_interval: int = 120    # seconds
  checkpoint_interval: int = 600  # seconds
  eval_interval: int = 3600      # seconds
  max_steps: Optional[int] = None
  seed: int = 1234
  # Parallelism: devices along the (data, spatial) mesh axes; None = auto.
  mesh_shape: Optional[List[int]] = None
  # Write a profiler trace of steps 10-15 here (the reference's
  # --profiling flag existed but was never consumed, bin/train.py:207;
  # this one works).
  profile_dir: Optional[str] = None


@dataclasses.dataclass
class Config:
  model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
  data: DataConfig = dataclasses.field(default_factory=DataConfig)
  train: TrainConfig = dataclasses.field(default_factory=TrainConfig)

  def to_json(self):
    return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

  @classmethod
  def from_json(cls, s):
    raw = json.loads(s)
    return cls(model=ModelConfig(**raw.get('model', {})),
               data=DataConfig(**raw.get('data', {})),
               train=TrainConfig(**raw.get('train', {})))

  def save(self, checkpoint_dir):
    os.makedirs(checkpoint_dir, exist_ok=True)
    with open(os.path.join(checkpoint_dir, 'config.json'), 'w') as f:
      f.write(self.to_json())

  @classmethod
  def load(cls, checkpoint_dir):
    with open(os.path.join(checkpoint_dir, 'config.json')) as f:
      return cls.from_json(f.read())
