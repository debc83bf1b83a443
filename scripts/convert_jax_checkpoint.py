#!/usr/bin/env python
"""Converts a checkpoint that ``hdrnet_tpu`` trained (orbax) into one that
``hdrnet_torch`` serves and resumes.

  python scripts/convert_jax_checkpoint.py <jax_ckpt_dir> <out_dir>
      [--step N]

Run it once, where JAX is installed: it imports ``hdrnet_tpu``, JAX,
orbax and optax, which the port does not (the port's package imports
nothing of them, so this converter lives outside it). It

  * restores step N (by default the latest) with ``hdrnet_tpu``'s own
    ``Checkpointer`` and ``abstract_state`` template, as
    ``hdrnet_tpu/inference.py`` does, with ``make_tx(config.train)``, so
    a cosine schedule's and ``guide_lr_scale``'s optimizer states
    restore;
  * maps ``params`` and ``batch_stats`` through
    ``hdrnet_torch.convert.convert_flax_variables`` and the Adam state
    through ``convert_optax_adam_state``, onto the optimizer that
    ``hdrnet_torch.training.loop.make_optimizer`` builds, by name;
  * copies ``config.json`` (the port's ``Config`` reads the same schema);
  * writes ``ckpt_<step>.pt`` in ``hdrnet_torch.training.checkpoint``'s
    format: ``{step, model, optimizer, ema_loss, ema_psnr}``.

``Enhancer.from_checkpoint``, ``bin/run.py``, ``bin/export.py`` and
``bin/train.py`` (to resume) then take `out_dir` as they take a
checkpoint of the port's own training.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from hdrnet_tpu.config import Config as JaxConfig  # noqa: E402
from hdrnet_tpu.models import make_model as jax_make_model  # noqa: E402
from hdrnet_tpu.training import checkpoint as jax_checkpoint  # noqa: E402
from hdrnet_tpu.training.loop import make_tx  # noqa: E402
from hdrnet_tpu.training.step import abstract_state  # noqa: E402

from hdrnet_torch.config import Config  # noqa: E402
from hdrnet_torch.convert import (convert_flax_variables,  # noqa: E402
                                  convert_optax_adam_state)
from hdrnet_torch.models import make_model  # noqa: E402
from hdrnet_torch.training import loop, step  # noqa: E402
from hdrnet_torch.training.checkpoint import (Checkpointer,  # noqa: E402
                                              checkpoint_path)


def restore_jax_state(jax_dir, step_no=None):
  """(step, TrainState with numpy leaves) of `jax_dir`: step `step_no`, or
  the latest."""
  full_cfg = JaxConfig.load(jax_dir)
  cfg = full_cfg.model
  s = cfg.net_input_size
  template = abstract_state(
      jax_make_model(cfg), make_tx(full_cfg.train), jax.random.PRNGKey(0),
      jnp.zeros((1, s, s, cfg.n_in), jnp.float32),
      jnp.zeros((1, 64, 64, cfg.n_in), jnp.float32))
  ckpt = jax_checkpoint.Checkpointer(jax_dir)
  step_no = ckpt.latest_step() if step_no is None else int(step_no)
  if step_no is None:
    raise FileNotFoundError(f'no checkpoint in {jax_dir}')
  if step_no not in ckpt.manager.all_steps():
    raise FileNotFoundError(f'no step {step_no} in {jax_dir} (steps: '
                            f'{sorted(ckpt.manager.all_steps())})')
  restore_args = jax.tree_util.tree_map(
      lambda _: ocp.RestoreArgs(restore_type=np.ndarray), template)
  state = ckpt.manager.restore(
      step_no, args=ocp.args.PyTreeRestore(item=template,
                                           restore_args=restore_args))
  return step_no, state


def convert(jax_dir, out_dir, step_no=None):
  """Writes the port's checkpoint of `jax_dir`'s step into `out_dir`;
  returns the path of the written ``ckpt_<step>.pt``."""
  step_no, jstate = restore_jax_state(jax_dir, step_no)
  if int(jstate.step) != step_no:
    raise ValueError(f'{jax_dir}: step {step_no} holds a state at step '
                     f'{int(jstate.step)}')
  cfg = Config.load(jax_dir)
  variables = {'params': jstate.params}
  if jstate.batch_stats:
    variables['batch_stats'] = jstate.batch_stats
  model = make_model(cfg.model)
  model.load_state_dict(convert_flax_variables(variables))
  optimizer = loop.make_optimizer(model, cfg.train)
  optimizer.load_state_dict(convert_optax_adam_state(
      jstate.opt_state, model, optimizer, step=step_no))
  state = step.create_state(model, optimizer)
  state.step = step_no
  state.ema_loss = torch.tensor(float(jstate.ema_loss), dtype=torch.float32)
  state.ema_psnr = torch.tensor(float(jstate.ema_psnr), dtype=torch.float32)
  os.makedirs(out_dir, exist_ok=True)
  shutil.copyfile(os.path.join(jax_dir, 'config.json'),
                  os.path.join(out_dir, 'config.json'))
  Checkpointer(out_dir).save(step_no, state)
  return checkpoint_path(out_dir, step_no)


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument('jax_ckpt_dir')
  parser.add_argument('out_dir')
  parser.add_argument('--step', type=int, default=None,
                      help='the step to convert (default: the latest)')
  args = parser.parse_args(argv)
  path = convert(args.jax_ckpt_dir, args.out_dir, args.step)
  print(f'wrote {path}')
  return path


if __name__ == '__main__':
  main()
