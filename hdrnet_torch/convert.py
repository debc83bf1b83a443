"""Flax variables -> the port's ``state_dict``; an optax Adam state -> the
port's ``torch.optim.Adam`` state dict.

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

``convert_optax_adam_state`` maps the optimizer state of an
``hdrnet_tpu`` checkpoint (what ``hdrnet_tpu.training.loop.make_tx``
builds: ``optax.adam`` with a constant lr or a schedule, or for
``guide_lr_scale`` != 1 the ``multi_transform`` of a 'guide' and a
'rest' partition) onto the optimizer that
``hdrnet_torch.training.loop.make_optimizer`` builds: each Adam state's
moments ``mu`` / ``nu`` become ``exp_avg`` / ``exp_avg_sq``, renamed and
laid out as the parameters are, and its ``count`` each parameter's
``step``. Parameters are matched by name. The optax states are read by
their fields (``count``, ``mu``, ``nu``; ``inner_states``,
``inner_state``), so nothing here imports optax:
``scripts/convert_jax_checkpoint.py`` restores the orbax checkpoint where
JAX is installed and calls these functions.
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


def _states(tree, partition=None):
  """[(partition, state)] of every optax state with a ``count`` (Adam's
  ``count, mu, nu``; a schedule's ``count``) in an optax state tree of
  named tuples; `partition` is the ``multi_transform`` label it sits
  under, or None."""
  fields = getattr(tree, '_fields', ())
  if 'count' in fields:
    return [(partition, tree)]
  if 'inner_states' in fields:  # multi_transform's partitions
    return [s for label, inner in tree.inner_states.items()
            for s in _states(inner, label)]
  if isinstance(tree, (tuple, list)):  # chains, masked and empty states
    return [s for inner in tree for s in _states(inner, partition)]
  return []


def _unmasked(tree):
  """A moment tree without optax's ``MaskedNode`` subtrees (the leaves of
  another partition, empty tuples)."""
  out = {}
  for name, value in tree.items():
    if isinstance(value, Mapping):
      value = _unmasked(value)
      if value:
        out[name] = value
    elif not (isinstance(value, tuple) and not value):
      out[name] = value
  return out


def convert_optax_adam_state(opt_state, model, optimizer, step=None):
  """An optax Adam state tree (numpy leaves) -> ``optimizer.state_dict()``
  form for `optimizer`, a ``torch.optim.Adam`` over `model`'s parameters
  (``training.loop.make_optimizer``), to load with its
  ``load_state_dict``.

  Raises ValueError where the trees do not match by name: a parameter
  with no moments or with two, moments of no parameter, a shape that
  differs, or a parameter of the 'guide' partition outside the param
  group with the guide's lr scale (or one of 'rest' inside it). With
  `step`, every count in the tree (Adam's and the schedule's) must equal
  it: the port evaluates the schedule at the train state's step.
  """
  states = _states(opt_state)
  adam = [(p, st) for p, st in states if 'mu' in st._fields]
  if not adam:
    raise ValueError('no Adam state (count, mu, nu) in the optax state')
  counts = sorted({int(np.asarray(st.count)) for _, st in states})
  if step is not None and counts != [step]:
    raise ValueError(f'optax counts {counts} are not the step {step}')
  moments = {}
  for partition, st in adam:
    mu = convert_flax_variables({'params': _unmasked(st.mu)})
    nu = convert_flax_variables({'params': _unmasked(st.nu)})
    if mu.keys() != nu.keys():
      raise ValueError(f'mu and nu of {partition!r} name other parameters')
    count = float(np.asarray(st.count))
    for name in mu:
      if name in moments:
        raise ValueError(f'{name} has two Adam states')
      moments[name] = (partition, count, mu[name], nu[name])

  names = {id(p): name for name, p in model.named_parameters()}
  state, index = {}, 0
  for g, group in enumerate(optimizer.param_groups):
    scaled = group.get('lr_scale', 1.0) != 1.0
    for p in group['params']:
      name = names[id(p)]
      if name not in moments:
        raise ValueError(f'no Adam moments for {name}')
      partition, count, exp_avg, exp_avg_sq = moments.pop(name)
      if partition is not None and (partition == 'guide') != scaled:
        raise ValueError(f'{name}: optax partition {partition!r}, but '
                         f'param group {g} (lr_scale '
                         f'{group.get("lr_scale", 1.0)})')
      if tuple(exp_avg.shape) != tuple(p.shape):
        raise ValueError(f'{name}: moments {tuple(exp_avg.shape)}, '
                         f'parameter {tuple(p.shape)}')
      state[index] = {'step': torch.tensor(count, dtype=torch.float32),
                      'exp_avg': exp_avg, 'exp_avg_sq': exp_avg_sq}
      index += 1
  if moments:
    raise ValueError(f'Adam moments of no parameter: {sorted(moments)}')
  return {'state': state,
          'param_groups': optimizer.state_dict()['param_groups']}
