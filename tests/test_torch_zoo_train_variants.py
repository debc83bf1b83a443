"""One training step of each of the other nine new models of the
extended zoo on the CPU against the JAX step, as
``tests/test_torch_zoo_train.py`` takes it (same tolerances; the step
is ``tests/zoo_parity.py``'s ``check_one_train_step``).
"""

import pytest

from zoo_parity import check_one_train_step

# (model, guide_reg, guide_lr_scale): the guide regularizer on a model of
# each guide kind (3x3 NN, simple, curves), a scaled guide learning rate
# on the curves pyramid.
CASES = [
    ('HDRNetGaussianPyr', 0.0, 0.1),
    ('HDRNet3x3NNGuide', 0.5, 1.0),
    ('HDRNetFullresFeatures', 0.0, 1.0),
    ('HDRNetFullresFeaturesMultiscale', 0.0, 1.0),
    ('HDRNetFeaturesPyrNN2', 0.0, 1.0),
    ('HDRNetFeaturesPyrNN3', 0.0, 1.0),
    ('HDRNetFeaturesPyrSimpleGuideNN', 0.5, 1.0),
    ('StyleTransferNN', 0.0, 1.0),
    ('StyleTransferCurves', 0.5, 1.0),
]


@pytest.mark.parametrize('name,guide_reg,guide_lr_scale', CASES)
def test_one_train_step_matches_jax(name, guide_reg, guide_lr_scale):
  check_one_train_step(name, guide_reg, guide_lr_scale)
