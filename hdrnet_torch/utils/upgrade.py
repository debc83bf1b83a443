"""Checkpoint migration: reference TF checkpoints -> the port.

The port's own copy of ``hdrnet_tpu.utils.upgrade``'s name map (TF1
variable names, scopes from the reference's models.py:46-196 and
layers.py:25-93), going straight to the port's ``state_dict``: a user of
the reference brings a trained model across without JAX.

TF stores conv kernels HWIO and dense kernels (in, out); the port's
``nn.Conv2d`` and ``nn.Linear`` weights are OIHW and (out, in), so those
are transposed. The prediction head's grid packing is reproduced by
``CoefficientBackbone`` (channel (j*n_out+i)*gd+k -> grid[..., k, i, j],
models.py:134-138), so nothing else is permuted.

Use ``load_tf_checkpoint`` (needs tensorflow) or pass any
{tf_name: ndarray} dict to ``tf_vars_to_torch``;
``import_tf_checkpoint`` writes a checkpoint of the port that
``Enhancer.from_checkpoint`` serves.

  python -m hdrnet_torch.utils.upgrade tf_ckpt/ out_ckpt/ [--model_name ...]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def load_tf_checkpoint(path):
  """Reads a TF checkpoint into {variable_name: np.ndarray}."""
  try:
    import tensorflow as tf  # gated: only this reader needs it
  except ImportError as e:
    raise ImportError(
        'reading a TF checkpoint needs tensorflow, which is not installed; '
        'read the variables elsewhere and pass a {name: array} dict to '
        'tf_vars_to_torch') from e
  reader = tf.train.load_checkpoint(path)
  return {name: reader.get_tensor(name)
          for name in reader.get_variable_to_shape_map()}


def _conv_kernel(a):
  return a.transpose(3, 2, 0, 1)  # HWIO -> OIHW


def _fc_kernel(a):
  return a.T  # (in, out) -> (out, in)


def _layer_entries(tf_scope, key, layer, batch_norm):
  """Mapping rows for one conv (layer 'conv') or fc ('fc') block."""
  kernel = _conv_kernel if layer == 'conv' else _fc_kernel
  rows = [(f'{tf_scope}/weights', f'{key}.{layer}.weight', kernel)]
  if batch_norm:
    rows += [(f'{tf_scope}/BatchNorm/beta', f'{key}.bn.bias', None),
             (f'{tf_scope}/BatchNorm/moving_mean', f'{key}.bn.running_mean',
              None),
             (f'{tf_scope}/BatchNorm/moving_variance',
              f'{key}.bn.running_var', None)]
  else:
    rows.append((f'{tf_scope}/biases', f'{key}.{layer}.bias', None))
  return rows


def build_name_map(config):
  """[(tf_name, state_dict key, transform)] for a ModelConfig; transform
  is None or a callable(np.ndarray)."""
  bn = config.batch_norm
  n_ds = int(np.log2(config.net_input_size / config.spatial_bin))
  p = 'inference/coefficients'
  c = 'coefficients'
  rows = []
  for i in range(1, n_ds + 1):
    rows += _layer_entries(f'{p}/splat/conv{i}', f'{c}.splat_conv{i}', 'conv',
                           bn and i > 1)
  for i in (1, 2):
    rows += _layer_entries(f'{p}/global/conv{i}', f'{c}.global_conv{i}',
                           'conv', bn)
  rows += _layer_entries(f'{p}/global/fc1', f'{c}.global_fc1', 'fc', bn)
  rows += _layer_entries(f'{p}/global/fc2', f'{c}.global_fc2', 'fc', bn)
  rows += _layer_entries(f'{p}/global/fc3', f'{c}.global_fc3', 'fc', False)
  rows += _layer_entries(f'{p}/local/conv1', f'{c}.local_conv1', 'conv', bn)
  # local conv2 is linear and bias-free (models.py:116-117)
  rows.append((f'{p}/local/conv2/weights', f'{c}.local_conv2.conv.weight',
               _conv_kernel))
  rows += _layer_entries(f'{p}/prediction/conv1', f'{c}.prediction_conv',
                         'conv', False)

  g = 'inference/guide'
  if config.model_name == 'HDRNetCurves':
    nch = config.n_in
    npts = 16
    rows += [
        (f'{g}/ccm', 'guide.ccm', None),
        (f'{g}/ccm_bias', 'guide.ccm_bias', None),
        # TF stores shifts (1,1,nchans,npts) and slopes (1,1,1,nchans,
        # npts) (models.py:164-173); the port's are (nchans, npts).
        (f'{g}/shifts', 'guide.shifts', lambda a: a.reshape(nch, npts)),
        (f'{g}/slopes', 'guide.slopes', lambda a: a.reshape(nch, npts)),
        (f'{g}/channel_mixing/weights', 'guide.channel_mixing_w',
         lambda a: a.reshape(nch, 1)),
        (f'{g}/channel_mixing/biases', 'guide.channel_mixing_b', None),
    ]
  elif config.model_name == 'HDRNetPointwiseNNGuide':
    rows += (_layer_entries(f'{g}/conv1', 'guide.conv1', 'conv', True) +
             _layer_entries(f'{g}/conv2', 'guide.conv2', 'conv', False))
  elif config.model_name == 'HDRNetGaussianPyrNN':
    for lvl in range(3):
      key = f'guide_level_{lvl}'
      rows += (_layer_entries(f'{g}/level_{lvl}/conv1', f'{key}.conv1',
                              'conv', True) +
               _layer_entries(f'{g}/level_{lvl}/conv2', f'{key}.conv2',
                              'conv', False))
  return rows


def tf_vars_to_torch(tf_vars, config, strict=True):
  """Converts {tf_name: array} into a ``state_dict`` of the port's model.

  Unknown reference names are ignored; missing expected names raise when
  strict.
  """
  out = {}
  missing = []
  for tf_name, key, transform in build_name_map(config):
    if tf_name not in tf_vars:
      missing.append(tf_name)
      continue
    arr = np.asarray(tf_vars[tf_name], np.float32)
    if transform is not None:
      arr = transform(arr)
    out[key] = torch.tensor(arr)
  if strict and missing:
    raise KeyError(f'checkpoint is missing {len(missing)} variables, '
                   f'e.g. {missing[:4]}')
  return out


def import_tf_checkpoint(tf_ckpt_path, output_dir, config):
  """Full migration: TF checkpoint -> a port checkpoint (step 0) +
  config.json in `output_dir`. Returns the train state."""
  from hdrnet_torch.models import make_model
  from hdrnet_torch.training.checkpoint import Checkpointer
  from hdrnet_torch.training.loop import make_optimizer
  from hdrnet_torch.training.step import create_state

  state_dict = tf_vars_to_torch(load_tf_checkpoint(tf_ckpt_path),
                                config.model)
  model = make_model(config.model)
  # Raises on a missing or unexpected key and on a shape that does not
  # match the model of this config.
  model.load_state_dict(state_dict, strict=True)
  # The optimizer state comes from the config's own optimizer, as a
  # restore builds it.
  state = create_state(model, make_optimizer(model, config.train))
  config.save(output_dir)
  Checkpointer(output_dir).save(0, state)
  return state


def main(argv=None):
  """CLI: upgrade <tf_ckpt_dir_or_prefix> <output_dir> [--model_name ...]

  Flag defaults match the reference training defaults; pass the same
  model flags the checkpoint was trained with (the reference embeds
  them in its metagraph, which is not parsed here).
  """
  from hdrnet_torch.config import Config, ModelConfig

  p = argparse.ArgumentParser(description=main.__doc__)
  p.add_argument('tf_checkpoint')
  p.add_argument('output_dir')
  p.add_argument('--model_name', default='HDRNetCurves')
  p.add_argument('--luma_bins', type=int, default=8)
  p.add_argument('--spatial_bin', type=int, default=16)
  p.add_argument('--channel_multiplier', type=int, default=1)
  p.add_argument('--guide_complexity', type=int, default=16)
  p.add_argument('--batch_norm', action='store_true')
  args = p.parse_args(argv)
  config = Config(model=ModelConfig(
      model_name=args.model_name, luma_bins=args.luma_bins,
      spatial_bin=args.spatial_bin,
      channel_multiplier=args.channel_multiplier,
      guide_complexity=args.guide_complexity,
      batch_norm=args.batch_norm))
  state = import_tf_checkpoint(args.tf_checkpoint, args.output_dir, config)
  n = sum(t.numel() for t in state.model.parameters())
  print(f'imported {n} parameters -> {args.output_dir}')


if __name__ == '__main__':
  main()
