"""Model registry. Ported so far: ``HDRNetCurves``."""

from hdrnet_torch.models.hdrnet import CoefficientBackbone, HDRNetCurves

MODELS = {
    'HDRNetCurves': HDRNetCurves,
}

__all__ = list(MODELS) + ['MODELS', 'CoefficientBackbone', 'make_model']


def make_model(cfg, generator=None):
  """Instantiates a model from a ModelConfig by its model_name."""
  try:
    cls = MODELS[cfg.model_name]
  except KeyError:
    raise ValueError(
        f'unknown model {cfg.model_name!r}; ported so far: {sorted(MODELS)}'
    ) from None
  return cls(cfg, generator=generator)
