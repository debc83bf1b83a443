"""Model registry: the 17 models of ``hdrnet_tpu.models.MODELS`` under the
same names (the three HDRNet models, the two baselines and the extended
zoo)."""

from hdrnet_torch.models.baselines import DilatedConvolutions, UNet
from hdrnet_torch.models.extended import EXTENDED_MODELS
from hdrnet_torch.models.hdrnet import (CoefficientBackbone, HDRNetCurves,
                                        HDRNetGaussianPyrNN,
                                        HDRNetPointwiseNNGuide)

MODELS = {
    'HDRNetCurves': HDRNetCurves,
    'HDRNetPointwiseNNGuide': HDRNetPointwiseNNGuide,
    'HDRNetGaussianPyrNN': HDRNetGaussianPyrNN,
    'UNet': UNet,
    'DilatedConvolutions': DilatedConvolutions,
    **EXTENDED_MODELS,
}

__all__ = list(MODELS) + ['MODELS', 'CoefficientBackbone', 'make_model',
                          'register', 'require_top_level_grid']


def make_model(cfg, generator=None):
  """Instantiates a model from a ModelConfig by its model_name."""
  try:
    cls = MODELS[cfg.model_name]
  except KeyError:
    raise ValueError(
        f'unknown model {cfg.model_name!r}; choices: {sorted(MODELS)}'
    ) from None
  return cls(cfg, generator=generator)


def register(name, cls):
  """Extension hook for new model families: ``make_model`` builds `cls`
  for a ModelConfig whose model_name is `name`."""
  MODELS[name] = cls


def require_top_level_grid(model, what):
  """Raises ValueError, with the reason, unless `model` has a coefficient
  backbone of its own and so a top-level grid ('bilateral_coefficients'):
  the baselines have none and ``HDRNetStack``'s are its stages'. `what`
  names the caller's use of the grid. (The JAX tools fail there with a
  KeyError.)"""
  if not isinstance(getattr(model, 'coefficients', None),
                    CoefficientBackbone):
    raise ValueError(
        f'{what}: {type(model).__name__} has no top-level coefficient grid '
        f'(a baseline has no grid; HDRNetStack has one a stage)')
