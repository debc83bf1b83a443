"""Flax variables -> the port's ``state_dict``.

Takes the ``{'params': ..., 'batch_stats': ...}`` tree of an
``hdrnet_tpu`` model as nested mappings of array-likes (numpy arrays, or
anything ``np.asarray`` accepts) and returns a ``state_dict`` for the
port's module of the same architecture. The port's submodules carry the
Flax module names, so the mapping is by name with these layout changes:

  * conv kernels HWIO -> OIHW ``weight``;
  * ``Dense`` kernels (in, out) -> (out, in) ``weight``;
  * batch stats ``mean`` / ``var`` -> ``running_mean`` / ``running_var``;
  * every other leaf (biases, BN shifts, guide parameters) as is.

The global FC's input order needs no permutation: the port flattens its
NCHW activations in NHWC order, as the Flax model does.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

_STAT_NAMES = {'mean': 'running_mean', 'var': 'running_var'}


def _param_leaf(name, value):
  if name == 'kernel' and value.ndim == 4:  # HWIO -> OIHW
    return 'weight', value.transpose(3, 2, 0, 1)
  if name == 'kernel' and value.ndim == 2:  # (in, out) -> (out, in)
    return 'weight', value.T
  if name == 'kernel':
    raise ValueError(f'unexpected kernel rank {value.ndim}')
  return name, value


def _walk(tree, prefix, leaf_fn, out):
  for name, value in tree.items():
    if isinstance(value, Mapping):
      _walk(value, f'{prefix}{name}.', leaf_fn, out)
    else:
      key, arr = leaf_fn(name, np.asarray(value, dtype=np.float32))
      out[prefix + key] = torch.from_numpy(np.array(arr, order='C'))


def convert_flax_variables(variables):
  """{'params': tree, 'batch_stats': tree?} -> torch state_dict."""
  state = {}
  _walk(variables['params'], '', _param_leaf, state)
  stats = variables.get('batch_stats') or {}
  _walk(stats, '', lambda n, v: (_STAT_NAMES[n], v), state)
  return state
