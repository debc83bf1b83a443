"""The configuration dataclasses, shared with the JAX package.

``hdrnet_tpu.config`` is standard-library only; the port re-exports it so
that its callers (``chip_smoke.py`` among them) need no ``hdrnet_tpu``
import, and a ``config.json`` written by either package loads in both.
"""

from hdrnet_tpu.config import Config, DataConfig, ModelConfig, TrainConfig

__all__ = ['Config', 'DataConfig', 'ModelConfig', 'TrainConfig']
