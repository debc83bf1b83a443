#!/usr/bin/env python
"""Train a model with the PyTorch / CUDA port.

The flags and the ``Config`` they build are those of
``hdrnet_tpu.bin.train`` (CLI parity with the reference
bin/train.py:187-246); the model names are the port's. Trains on
``--device``: CUDA by default, and it raises without a CUDA device;
``--device cpu`` trains on the plain versions of the kernels.

Under torchrun (RANK and WORLD_SIZE set) each process joins the process
group (NCCL on CUDA, gloo with ``--device cpu``) and trains on the
('data', 'spatial') mesh of ``--mesh_shape d s``, as the JAX CLI's flag
lays out its devices; by default every rank on 'data'
(``hdrnet_torch.training.loop``).

``main`` returns the final ``TrainState``; its ``data_route`` says
whether ``--device_data`` took the device-resident route.

Examples:
  python -m hdrnet_torch.bin.train ckpt/ data/train/filelist.txt \\
      --model_name HDRNetCurves --batch_size 1 --nobatch_norm \\
      --output_resolution 2048 2048
  python -m torch.distributed.run --nproc_per_node 4 \\
      -m hdrnet_torch.bin.train ckpt/ data/train --batch_size 4 \\
      --output_resolution 1024 1024 --mesh_shape 2 2
"""

from __future__ import annotations

import argparse
import logging
import os

from hdrnet_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from hdrnet_torch.data import PIPELINES
from hdrnet_torch.models import MODELS


def build_parser():
  p = argparse.ArgumentParser(description=__doc__)
  req = p.add_argument_group('required')
  req.add_argument('checkpoint_dir', help='directory to save checkpoints')
  req.add_argument('data_dir', help='training images / records')
  req.add_argument('--eval_data_dir', default=None,
                   help='validation data directory')

  t = p.add_argument_group('training')
  t.add_argument('--learning_rate', default=1e-4, type=float)
  t.add_argument('--lr_schedule', default='constant',
                 choices=['constant', 'cosine'],
                 help='constant = reference behavior; cosine decays to '
                      '--lr_end over --lr_decay_steps (default max_steps)')
  t.add_argument('--lr_decay_steps', default=None, type=int)
  t.add_argument('--lr_end', default=0.0, type=float)
  t.add_argument('--lr_warmup_steps', default=0, type=int)
  t.add_argument('--guide_lr_scale', default=1.0, type=float,
                 help='multiply the guide modules\' lr (1.0 = reference '
                      'behavior)')
  t.add_argument('--guide_reg', default=0.0, type=float,
                 help='guide-range regularizer weight (0 = off)')
  t.add_argument('--guide_reg_target', default=0.2, type=float)
  t.add_argument('--max_steps', default=None, type=int)
  t.add_argument('--log_interval', type=float, default=1,
                 help='seconds between log lines')
  t.add_argument('--summary_interval', type=float, default=120)
  t.add_argument('--checkpoint_interval', type=float, default=600)
  t.add_argument('--eval_interval', type=float, default=3600)
  t.add_argument('--seed', type=int, default=1234)
  t.add_argument('--mesh_shape', type=int, nargs=2, default=None,
                 help='(data, spatial) mesh of the torchrun ranks; default '
                      'all ranks on data')
  t.add_argument('--profile_dir', default=None,
                 help='write a torch.profiler Chrome trace of steps 10-15 '
                      'here; its hdrnet.train.* ranges are the phases of '
                      'a step (forward, backward, optimizer, metrics)')
  t.add_argument('--device', default='cuda',
                 help="torch device to train on ('cpu' for the plain "
                      'versions of the kernels)')

  d = p.add_argument_group('data pipeline')
  d.add_argument('--batch_size', default=16, type=int)
  d.add_argument('--data_threads', default=2, type=int)
  d.add_argument('--data_pipeline', default='ImageFilesDataPipeline',
                 choices=sorted(PIPELINES))
  for flag in ('rotate', 'flipud', 'fliplr', 'random_crop',
               'cache_images', 'device_normalize', 'device_data'):
    d.add_argument(f'--{flag}', dest=flag, action='store_true')
    d.add_argument(f'--no{flag}', dest=flag, action='store_false')
  d.add_argument('--blur_sigma', type=float, default=4.0,
                 help='unsharp-mask pipeline blur sigma')
  d.add_argument('--sharpen', type=float, default=1.0,
                 help='unsharp-mask pipeline strength')

  m = p.add_argument_group('model_params')
  m.add_argument('--model_name', default='HDRNetCurves',
                 choices=sorted(MODELS))
  m.add_argument('--net_input_size', default=256, type=int)
  m.add_argument('--output_resolution', default=[512, 512], type=int,
                 nargs=2)
  m.add_argument('--batch_norm', dest='batch_norm', action='store_true')
  m.add_argument('--nobatch_norm', dest='batch_norm', action='store_false')
  m.add_argument('--channel_multiplier', default=1, type=int)
  m.add_argument('--guide_complexity', default=16, type=int)
  m.add_argument('--luma_bins', default=8, type=int)
  m.add_argument('--spatial_bin', default=16, type=int)
  m.add_argument('--depth', default=5, type=int, help='baseline models')
  m.add_argument('--width', default=32, type=int, help='baseline models')

  p.set_defaults(rotate=False, flipud=False, fliplr=False,
                 random_crop=True, cache_images=False,
                 device_normalize=False, device_data=False,
                 batch_norm=False)
  return p


def config_from_args(args):
  """The Config of the parsed flags (``hdrnet_tpu.bin.train``'s mapping)."""
  n_in = 6 if args.data_pipeline == 'StyleTransferDataPipeline' else 3
  return Config(
      model=ModelConfig(
          model_name=args.model_name,
          net_input_size=args.net_input_size,
          output_resolution=list(args.output_resolution),
          luma_bins=args.luma_bins,
          spatial_bin=args.spatial_bin,
          channel_multiplier=args.channel_multiplier,
          guide_complexity=args.guide_complexity,
          batch_norm=args.batch_norm,
          n_in=n_in,
          depth=args.depth,
          width=args.width),
      data=DataConfig(
          pipeline=args.data_pipeline,
          batch_size=args.batch_size,
          output_resolution=list(args.output_resolution),
          net_input_size=args.net_input_size,
          fliplr=args.fliplr,
          flipud=args.flipud,
          rotate=args.rotate,
          random_crop=args.random_crop,
          cache_images=args.cache_images,
          device_normalize=args.device_normalize,
          device_data=args.device_data,
          data_threads=args.data_threads,
          blur_sigma=args.blur_sigma,
          sharpen=args.sharpen),
      train=TrainConfig(
          learning_rate=args.learning_rate,
          lr_schedule=args.lr_schedule,
          lr_decay_steps=args.lr_decay_steps,
          lr_end=args.lr_end,
          lr_warmup_steps=args.lr_warmup_steps,
          guide_lr_scale=args.guide_lr_scale,
          guide_reg=args.guide_reg,
          guide_reg_target=args.guide_reg_target,
          log_interval=args.log_interval,
          summary_interval=args.summary_interval,
          checkpoint_interval=args.checkpoint_interval,
          eval_interval=args.eval_interval,
          max_steps=args.max_steps,
          seed=args.seed,
          mesh_shape=args.mesh_shape,
          profile_dir=args.profile_dir))


def main(argv=None):
  logging.basicConfig(
      format='%(asctime)s [%(process)d] %(levelname)s %(filename)s:'
             '%(lineno)s | %(message)s', level=logging.INFO)
  args = build_parser().parse_args(argv)
  from hdrnet_torch.training.loop import train
  if 'RANK' in os.environ and 'WORLD_SIZE' in os.environ:
    from hdrnet_torch.parallel.mesh import initialize_distributed
    import torch
    initialize_distributed(
        'gloo' if torch.device(args.device).type == 'cpu' else None)
  return train(config_from_args(args), args.checkpoint_dir, args.data_dir,
               eval_data_dir=args.eval_data_dir, device=args.device)


if __name__ == '__main__':
  main()
