"""Checkpoints written by ``hdrnet_tpu``'s own training code, for the tests
of ``scripts/convert_jax_checkpoint.py``: a Flax model trained a few Adam
steps (``make_tx``, the jitted train step) on numpy-seeded batches and
saved by the JAX package's orbax ``Checkpointer`` beside its
``config.json``; and the converter loaded from its file.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np

from hdrnet_tpu.models import make_model as jax_make_model
from hdrnet_tpu.training import step as jax_step
from hdrnet_tpu.training.checkpoint import Checkpointer as JaxCheckpointer
from hdrnet_tpu.training.loop import make_tx

REPO = pathlib.Path(__file__).resolve().parents[1]
CONVERTER = REPO / 'scripts' / 'convert_jax_checkpoint.py'


def converter():
  """scripts/convert_jax_checkpoint.py as a module."""
  spec = importlib.util.spec_from_file_location('convert_jax_checkpoint',
                                                CONVERTER)
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module


def batch(seed, b=2, s=32, hw=64):
  """A uint8 batch: random frames, the target brightened 1.3x, the
  previews every (hw / s)-th pixel."""
  rng = np.random.RandomState(seed)
  full = rng.randint(0, 256, (b, hw, hw, 3)).astype(np.uint8)
  target = np.clip(full.astype(np.float32) * 1.3, 0, 255).astype(np.uint8)
  k = hw // s
  return {'lowres_input': np.ascontiguousarray(full[:, ::k, ::k]),
          'lowres_output': np.ascontiguousarray(target[:, ::k, ::k]),
          'image_input': full, 'image_output': target}


def write(directory, config, steps=3, keep=(2, 3), seed=0):
  """Trains `config`'s model `steps` jitted JAX steps (a batch a step,
  seeded 100 + step) from its Flax init and saves the steps in `keep`
  with ``hdrnet_tpu``'s Checkpointer, the config beside them. Returns the
  last TrainState."""
  s = config.model.net_input_size
  model = jax_make_model(config.model)
  tx = make_tx(config.train)
  first = batch(100, s=s)
  state = jax_step.create_state(
      model, tx, jax.random.PRNGKey(seed),
      jnp.asarray(first['lowres_input'], jnp.float32) / 255,
      jnp.asarray(first['image_input'], jnp.float32) / 255)
  train_step = jax.jit(jax_step.make_train_step(model, tx))
  ckpt = JaxCheckpointer(str(directory))
  for i in range(steps):
    b = batch(100 + i, s=s)
    state, _ = train_step(state, {k: jnp.asarray(v) for k, v in b.items()})
    if i + 1 in keep:
      ckpt.save(i + 1, state)
  ckpt.wait()
  config.save(str(directory))
  return state
