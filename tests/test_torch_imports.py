"""hdrnet_torch never imports JAX.

The machine with the card has no JAX, so the port must import and serve
without it: no module under ``hdrnet_torch/`` may import jax, flax,
optax, or any ``hdrnet_tpu`` module but the standard-library-only
``hdrnet_tpu.config``.
"""

import ast
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = REPO / 'hdrnet_torch'
FORBIDDEN_ROOTS = ('jax', 'jaxlib', 'flax', 'optax')


def _imported_modules(path):
  tree = ast.parse(path.read_text(), filename=str(path))
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      for alias in node.names:
        yield alias.name
    elif isinstance(node, ast.ImportFrom) and node.level == 0:
      if node.module == 'hdrnet_tpu':  # from hdrnet_tpu import x
        for alias in node.names:
          yield f'hdrnet_tpu.{alias.name}'
      else:
        yield node.module


def test_no_jax_imports_in_package():
  files = sorted(PACKAGE.rglob('*.py')) + [REPO / 'chip_smoke.py']
  assert len(files) >= 10, files
  bad = []
  for path in files:
    for mod in _imported_modules(path):
      root = mod.split('.')[0]
      if root in FORBIDDEN_ROOTS or (root == 'hdrnet_tpu'
                                     and mod != 'hdrnet_tpu.config'):
        bad.append(f'{path.relative_to(REPO)}: {mod}')
  assert not bad, bad


_BLOCKED_RUN = f'''
import sys

class RefuseJax:
  def find_spec(self, name, path=None, target=None):
    if name.split('.')[0] in {FORBIDDEN_ROOTS!r}:
      raise ImportError('import of ' + name + ' refused')
    return None

sys.meta_path.insert(0, RefuseJax())

import importlib, pkgutil
import hdrnet_torch
for mod in pkgutil.walk_packages(hdrnet_torch.__path__, 'hdrnet_torch.'):
  importlib.import_module(mod.name)

import torch
from hdrnet_tpu.config import ModelConfig
from hdrnet_torch.inference import Enhancer

enh = Enhancer(ModelConfig(net_input_size=64, spatial_bin=8, luma_bins=4),
               device='cpu')
out = enh.process(torch.rand(1, 40, 48, 3))
assert out.shape == (1, 40, 48, 3), out.shape
loaded = sorted(m for m in sys.modules
                if m.split('.')[0] in {FORBIDDEN_ROOTS!r})
assert not loaded, loaded
print('served without jax')
'''


def test_package_serves_with_jax_refused():
  proc = subprocess.run([sys.executable, '-c', _BLOCKED_RUN], cwd=REPO,
                        capture_output=True, text=True, timeout=300,
                        check=False)
  assert proc.returncode == 0, proc.stdout + proc.stderr
  assert 'served without jax' in proc.stdout
