"""One file a model family, found by the configuration's ``model_name``:
``portbench/models/<model_name>.py``. Each holds what the yardstick needs
of that family and nothing of the program:

  * ``LEVELS``: the levels it slices, finest first, each half the last;
  * ``FUSED_U8``: whether serving's fused kernel reads and writes the
    uint8 frame (else the frame is dequantized and requantized around
    float32 levels);
  * ``guide_ops(model)``, ``guide_params(model)``: its guide's float32
    operations a pixel and its packed parameters;
  * ``forward_train(sd, model, lowres, fullres)`` and
    ``serve(sd, model, frame_u8)``: its plain reference, built from
    ``portbench.reference.plain``.

A family whose work differs in kind from the HDRNet composition in
``portbench.counts`` defines that function of ``counts`` in its file too
(``backbone_ops``, ``serve_frame_ops``, ``train_step_ops``,
``fused_bound_s``, ``slice_apply_bound_s``), and it is used instead.
"""

import importlib

REQUIRED = ('LEVELS', 'FUSED_U8', 'guide_ops', 'guide_params',
            'forward_train', 'serve')


def load(model_name):
  return importlib.import_module(f'portbench.models.{model_name}')
