"""One training step of each model of the extended zoo and the baselines
on the CPU against the JAX step, and the guide regularizer's refusal.

The JAX step (``hdrnet_tpu.training.step.make_train_step``, its
gradients kept by an optax transform in front of Adam) and the port's
step (``hdrnet_torch.training.step``) take one Adam step from the same
weights on the same seeded uint8 batch. Tolerances are those of
``tests/test_torch_nn_models.py``: loss and psnr 1e-5 relative; every
parameter's gradient 1e-4 of that leaf's largest |g| (the gradients
reach the feature towers through the slice-apply's input cotangent;
HDRNetStack's first-stage guide at a measured 4e-4, see
``tests/zoo_parity.py``); parameters after the step within 1e-2 * lr
where the gradient is not negligible; batch-norm statistics 1e-6; psnr
also 1e-5 dB absolute. ``batch_norm`` is off, as there (the NN guides'
BN runs in training mode whatever it says).
"""

import numpy as np
import pytest

from hdrnet_tpu.config import TrainConfig

from hdrnet_torch.training import loop, step

from zoo_parity import (check_one_train_step, flax_variables, port_model,
                        small_cfg, train_batch)


# (model, guide_reg, guide_lr_scale): the feature pyramid with the guide
# regularizer over its three level guides, the guided feature model and
# the stack with a scaled guide learning rate, the two baselines; the
# other nine new models in tests/test_torch_zoo_train_variants.py.
CASES = [
    ('HDRNetFeaturesPyrNN', 0.5, 1.0),
    ('HDRNetFullresFeaturesWithGuide', 0.5, 0.1),
    ('HDRNetStack', 0.0, 0.1),
    ('UNet', 0.0, 1.0),
    ('DilatedConvolutions', 0.0, 1.0),
]


@pytest.mark.parametrize('name,guide_reg,guide_lr_scale', CASES)
def test_one_train_step_matches_jax(name, guide_reg, guide_lr_scale):
  check_one_train_step(name, guide_reg, guide_lr_scale)


@pytest.mark.parametrize('name', ['UNet', 'DilatedConvolutions',
                                  'HDRNetGaussianPyr', 'HDRNetStack'])
def test_guide_reg_refuses_a_model_without_guide_maps(name):
  """These models sow no guide map at top level: the JAX step fails
  there with a KeyError, the port's raises a ValueError naming the model
  (and makes up no regularizer); with guide_reg 0 they train."""
  cfg = small_cfg(name)
  port = port_model(name, flax_variables(name))
  batch = step.to_device(train_batch(cfg, 2, b=1, hw=(24, 32)), 'cpu')
  state = step.create_state(port, loop.make_optimizer(port, TrainConfig()))
  with pytest.raises(ValueError, match=name):
    step.make_train_step(guide_reg=0.5)(state, batch)
  state, m = step.make_train_step()(state, batch)
  assert state.step == 1 and np.isfinite(float(m['loss']))
