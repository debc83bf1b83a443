"""``hdrnet_torch.models.register``, the extension hook for new model
families (``hdrnet_tpu.models.register``'s counterpart): a registered
class is built by ``make_model`` and trained by ``training.loop.train``
from a Config that names it, on the CPU.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from hdrnet_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from hdrnet_torch.models import MODELS, HDRNetCurves, make_model, register
from hdrnet_torch.training import loop

NAME = 'RegisteredCurves'
SMALL = dict(net_input_size=32, spatial_bin=8, luma_bins=4,
             output_resolution=[64, 64])


class RegisteredCurves(HDRNetCurves):
  """A new family: the curves model with its output halved."""

  def forward(self, lowres, fullres, **kw):
    return 0.5 * super().forward(lowres, fullres, **kw)


@pytest.fixture()
def registered():
  register(NAME, RegisteredCurves)
  try:
    yield
  finally:
    # The registry is the package's: other tests hold it to the JAX one.
    MODELS.pop(NAME, None)


def test_register_adds_to_make_model(registered):
  cfg = ModelConfig(model_name=NAME, **SMALL)
  model = make_model(cfg, generator=torch.Generator().manual_seed(0))
  assert type(model) is RegisteredCurves
  base = make_model(ModelConfig(**SMALL),
                    generator=torch.Generator().manual_seed(0))
  model.load_state_dict(base.state_dict())
  low, full = torch.rand(1, 32, 32, 3), torch.rand(1, 40, 48, 3)
  with torch.no_grad():
    np.testing.assert_allclose(model(low, full).numpy(),
                               0.5 * base(low, full).numpy(), rtol=0,
                               atol=1e-7)


def test_unregistered_name_is_refused():
  with pytest.raises(ValueError, match='unknown model'):
    make_model(ModelConfig(model_name=NAME, **SMALL))


def test_registered_model_trains_a_step(registered, tmp_path):
  rng = np.random.RandomState(0)
  data = tmp_path / 'data'
  names = []
  for sub in ('input', 'output'):
    os.makedirs(data / sub)
  for i in range(2):
    im = (rng.rand(80, 96, 3) * 255).astype(np.uint8)
    out = np.clip(im.astype(np.float32) * 1.3, 0, 255).astype(np.uint8)
    Image.fromarray(im).save(data / 'input' / f'im{i}.png')
    Image.fromarray(out).save(data / 'output' / f'im{i}.png')
    names.append(f'im{i}.png')
  (data / 'filelist.txt').write_text('\n'.join(names))
  cfg = Config(
      model=ModelConfig(model_name=NAME, **SMALL),
      data=DataConfig(batch_size=2, output_resolution=[64, 64],
                      net_input_size=32, data_threads=1),
      train=TrainConfig(learning_rate=1e-3, max_steps=1, log_interval=9999,
                        summary_interval=9999, checkpoint_interval=9999))
  ckpt = tmp_path / 'ckpt'
  state = loop.train(cfg, str(ckpt), str(data), device='cpu')
  assert state.step == 1 and type(state.model) is RegisteredCurves
  assert np.isfinite(float(state.ema_loss))
  assert Config.load(str(ckpt)).model.model_name == NAME
  assert sorted(os.listdir(ckpt)) == ['ckpt_1.pt', 'config.json',
                                      'summaries.jsonl']
