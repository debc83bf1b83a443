"""The port's last kernel K2x and its tools vs the JAX package, on the CPU.

* K2x (``nearest_lowres_onehot``): its plain version, in both row modes,
  bit for bit ``hdrnet_tpu.ops.downsample.nearest_lowres_cf(...,
  variant='xla')``; the torch bf16 split bit for bit jnp's ``astype``
  chain. (The JAX experiment script itself is not imported: at import it
  points JAX's compilation cache into the checkout.)
* ``bin/export.py``: every ``.pt2`` reloads and is bit-identical to the
  eager port (``--device cpu``, a 48x64 frame, tiny widths); the
  coefficients are within 1e-5 of the Flax model's
  ``bilateral_coefficients`` in the deployment layout, ``serve_fn`` and
  ``enhance_fn`` within 1e-4 of the JAX functions of the same names (the
  JAX package's GPU-kernel gate); the guide ``.bin`` files are
  byte-identical to ``hdrnet_tpu.bin.export.dump_guide_params``.
* ``bin/fit_grid.py``: 5 Adam steps at 48x64 with 4x4x8 grids, luma and
  curves guides (the Flax ``PRNGKey(0)`` init fed to both): the grid
  within 1e-4 of JAX's ``fit_pair`` and the PSNR within 1e-3 dB (float32
  sums in another order, through five Adam steps).
* ``bin/viz_activations.py``: the same names as Flax's
  ``capture_intermediates`` and values within 1e-4 of each tensor's max.
* ``utils/upgrade.py``: a synthetic TF checkpoint built from JAX's
  ``build_name_map`` converts to exactly
  ``convert_flax_variables(tf_vars_to_flax(...))``.
* ``bin/compare_baselines.py`` and ``utils/{image,metadata}.py``: the
  same output as the JAX package's.
"""

import contextlib
import dataclasses
import functools
import io
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hdrnet_tpu.bin import compare_baselines as jax_compare
from hdrnet_tpu.bin import export as jax_export
from hdrnet_tpu.bin import fit_grid as jax_fit
from hdrnet_tpu.config import ModelConfig as JaxModelConfig
from hdrnet_tpu.inference import Enhancer as JaxEnhancer
from hdrnet_tpu.models import make_model as jax_make_model
from hdrnet_tpu.models.guides import CurveGuide as JaxCurveGuide
from hdrnet_tpu.ops.downsample import nearest_lowres_cf
from hdrnet_tpu.utils import image as jax_image
from hdrnet_tpu.utils import metadata as jax_metadata
from hdrnet_tpu.utils import upgrade as jax_upgrade

from hdrnet_torch.bin import compare_baselines, export, fit_grid
from hdrnet_torch.bin import viz_activations
from hdrnet_torch.config import Config, ModelConfig, TrainConfig
from hdrnet_torch.convert import convert_flax_variables
from hdrnet_torch.data import images
from hdrnet_torch.inference import Enhancer
from hdrnet_torch.models import make_model
from hdrnet_torch.ops import _build, downsample
from hdrnet_torch.scripts import exp_downsample_v2
from hdrnet_torch.training import loop, step
from hdrnet_torch.training.checkpoint import Checkpointer
from hdrnet_torch.utils import image, metadata, upgrade

MODELS = ['HDRNetCurves', 'HDRNetPointwiseNNGuide', 'HDRNetGaussianPyrNN']
FULLRES = (48, 64)


# --- K2x ---------------------------------------------------------------------


@pytest.mark.parametrize('rows', ['gather', 'mma'])
@pytest.mark.parametrize('b,h,w,s', [(1, 2160, 3840, 256), (3, 135, 240, 64),
                                     (1, 101, 60, 32)])
def test_onehot_plain_matches_jax_xla(b, h, w, s, rows):
  x = np.random.RandomState(0).rand(b, 3, h, w).astype(np.float32)
  want = np.asarray(nearest_lowres_cf(jnp.asarray(x), s, variant='xla'))
  got = downsample.nearest_lowres_onehot(torch.from_numpy(x), s, rows)
  assert got.shape == (b, 3, s, s) and got.dtype == torch.float32
  np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize('b,h,w,s', [(3, 135, 240, 64), (1, 101, 60, 32),
                                     (1, 10, 7, 32), (2, 77, 301, 40),
                                     (1, 64, 4096, 16)])
def test_k2x_library_call_matches_plain_and_jax(b, h, w, s):
  """The yardstick of K2x's library_ms, one aten::index call on the
  channel-first frame, computes its function exactly: both row modes'
  plain versions and JAX's ``nearest_lowres_cf`` bit for bit."""
  from hdrnet_torch.scripts.time_kernels import k2x_library
  x = np.random.RandomState(3).rand(b, 3, h, w).astype(np.float32)
  got = k2x_library(torch.from_numpy(x), s)
  assert got.shape == (b, 3, s, s)
  for rows in ('gather', 'mma'):
    want = downsample.nearest_lowres_onehot_plain(torch.from_numpy(x), s,
                                                  rows)
    assert torch.equal(got, want)
  np.testing.assert_array_equal(
      got.numpy(), np.asarray(nearest_lowres_cf(jnp.asarray(x), s,
                                                variant='xla')))


def test_split3_matches_jnp_astype_chain():
  """The experiment's split3, written out in jnp: bit for bit, and the
  parts add back to the value."""
  rng = np.random.RandomState(2)
  x = np.concatenate([rng.rand(4096), rng.randn(4096) * 1e3,
                      rng.rand(4096) * 1e-6]).astype(np.float32)
  xj = jnp.asarray(x)
  hi = xj.astype(jnp.bfloat16)
  rem = xj - hi.astype(jnp.float32)
  mid = rem.astype(jnp.bfloat16)
  lo = (rem - mid.astype(jnp.float32)).astype(jnp.bfloat16)
  parts = downsample.split3(torch.from_numpy(x))
  for got, want in zip(parts, (hi, mid, lo)):
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
  total = (parts[0].float() + parts[1].float()) + parts[2].float()
  np.testing.assert_array_equal(total.numpy(), x)


def test_onehot_rejects_what_the_kernel_does_not_take():
  x = torch.rand(1, 3, 20, 30)
  with pytest.raises(TypeError):
    downsample.nearest_lowres_onehot(x.double(), 8)
  with pytest.raises(TypeError):
    downsample.nearest_lowres_onehot((x * 255).to(torch.uint8), 8)
  with pytest.raises(ValueError):
    downsample.nearest_lowres_onehot(x, 8, rows='vpu')
  with pytest.raises(ValueError):
    downsample.nearest_lowres_onehot(x[0], 8)
  before = _build.launches.copy()
  downsample.nearest_lowres_onehot(x, 8, 'mma')
  assert _build.launches == before  # the plain version ran


def test_downsample_experiment_script_on_cpu(capsys):
  results = exp_downsample_v2.main(['--device', 'cpu'])  # 4K -> 256
  assert [r['name'] for r in results] == [
      'v0 K2 gather', 'v1 onehot gather-rows', 'v2 onehot mma-rows']
  assert all(r['max_diff'] == 0.0 and r['ms_per_frame'] == {}
             for r in results)
  assert capsys.readouterr().out.count('max|diff|=0.00e+00') == 3


# --- export ------------------------------------------------------------------


def _jax_cfg(name):
  return JaxModelConfig(model_name=name, net_input_size=64, spatial_bin=8,
                        luma_bins=4, guide_complexity=4)


def _port_cfg(name):
  return ModelConfig(**dataclasses.asdict(_jax_cfg(name)))


@functools.lru_cache(maxsize=None)
def _flax(name):
  """The Flax model and its variables (jitted init) with random BN shifts
  and statistics, so that the NN guides' BN fold is exercised."""
  rng = np.random.RandomState(0)
  model = jax_make_model(_jax_cfg(name))
  init = jax.jit(functools.partial(model.init, train=True))
  variables = init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                   jnp.zeros((1, 16, 16, 3)))

  def perturb(path, x):
    x = np.array(x)
    names = [getattr(p, 'key', '') for p in path]
    if 'bn' not in names:
      return x
    if names[-1] == 'var':
      return rng.uniform(0.5, 2.0, x.shape).astype(np.float32)
    return (0.1 * rng.randn(*x.shape)).astype(np.float32)
  return model, jax.tree_util.tree_map_with_path(perturb, dict(variables))


def _write_checkpoint(name, directory):
  """A port checkpoint of the Flax variables, as ``train`` saves one."""
  cfg = Config(model=_port_cfg(name), train=TrainConfig())
  model = make_model(cfg.model)
  model.load_state_dict(convert_flax_variables(_flax(name)[1]))
  state = step.create_state(model, loop.make_optimizer(model, cfg.train))
  cfg.save(str(directory))
  Checkpointer(str(directory)).save(0, state)


@pytest.fixture(scope='module', params=MODELS)
def exported(request, tmp_path_factory):
  name = request.param
  ckpt = tmp_path_factory.mktemp(f'ckpt_{name}')
  _write_checkpoint(name, ckpt)
  programs = export.main([str(ckpt), '--fullres', *map(str, FULLRES),
                          '--device', 'cpu'])
  return name, ckpt, programs


def _inputs(seed=1):
  rng = np.random.RandomState(seed)
  low = rng.rand(1, 64, 64, 3).astype(np.float32)
  full = rng.rand(1, *FULLRES, 3).astype(np.float32)
  full8 = rng.randint(0, 256, (1, *FULLRES, 3)).astype(np.uint8)
  return low, full, full8


def test_export_reloads_bit_identical_to_eager(exported):
  name, ckpt, programs = exported
  enh = Enhancer.from_checkpoint(str(ckpt), device='cpu')
  low, full, full8 = map(torch.from_numpy, _inputs())
  odd = torch.rand(1, 37, 90, 3)
  with torch.no_grad():
    grid = enh._backbone_grid(low.permute(0, 3, 1, 2))
    b, gh, gw, gd, no, ni = grid.shape
    eager = {
        'coefficients_fn': (
            (low,), grid.reshape(b, gh, gw, gd, no * ni)[0].permute(
                3, 2, 0, 1)),
        'enhance_fn': ((low, full), torch.clamp(enh.model(low, full), 0, 1)),
        'serve_fn': ((low, full), enh(low, full)),
        'stream_fn': ((full8,), enh.make_stream_fn(full8.shape)(full8)),
        'serve_any_fn': ((low, odd), enh(low, odd)),
    }
  kernels = {'coefficients_fn': [],
             'enhance_fn': ['hdrnet.slice_apply_fwd.default'],
             'serve_fn': ['hdrnet.enhance_fused.default'],
             'stream_fn': ['hdrnet.enhance_fused.default',
                           'hdrnet.nearest_lowres.default'],
             'serve_any_fn': ['hdrnet.enhance_fused.default']}
  assert sorted(programs) == sorted(eager)
  for fn_name, (args, want) in eager.items():
    ops = export.hdrnet_ops(programs[fn_name])
    if name == 'HDRNetGaussianPyrNN' and fn_name != 'coefficients_fn':
      ops.remove('hdrnet.resize_bilinear.default')
    assert ops == kernels[fn_name], (fn_name, ops)
    got = export.load_artifact(os.path.join(ckpt, f'{fn_name}.pt2'))(*args)
    assert got.dtype == want.dtype and torch.equal(got, want), fn_name
    with open(os.path.join(ckpt, f'{fn_name}.manifest.json')) as f:
      manifest = json.load(f)
    assert manifest['name'] == fn_name
    assert [i['shape'] for i in manifest['inputs']] == [
        list(a.shape) if fn_name != 'serve_any_fn' or i == 0
        else [1, 'H', 'W', 3] for i, a in enumerate(args)]
    assert manifest['outputs'][0]['dtype'] == str(want.dtype)[6:]


def test_export_manifest_records_full_float32(exported, tmp_path,
                                              monkeypatch):
  """F2: each manifest records the TF32 switches its graph must run with
  (off: full float32, as the Enhancer runs), and load_artifact sets them
  around the call, whatever the caller's, and restores the caller's; a
  manifest without the record is refused."""
  _, ckpt, programs = exported
  for fn_name in programs:
    with open(os.path.join(ckpt, f'{fn_name}.manifest.json')) as f:
      assert json.load(f)['precision'] == {'cudnn_allow_tf32': False,
                                           'matmul_allow_tf32': False}
  seen = []

  class Program:
    def module(self):
      return lambda *a: seen.append((torch.backends.cudnn.allow_tf32,
                                     torch.backends.cuda.matmul.allow_tf32))
  monkeypatch.setattr(torch.export, 'load', lambda path: Program())
  monkeypatch.setattr(torch.backends.cudnn, 'allow_tf32', True)
  monkeypatch.setattr(torch.backends.cuda.matmul, 'allow_tf32', True)
  export.load_artifact(os.path.join(ckpt, 'serve_fn.pt2'))()
  assert seen == [(False, False)]
  assert torch.backends.cudnn.allow_tf32
  assert torch.backends.cuda.matmul.allow_tf32
  with open(os.path.join(ckpt, 'serve_fn.manifest.json')) as f:
    manifest = json.load(f)
  del manifest['precision']
  with open(tmp_path / 'old.manifest.json', 'w') as f:
    json.dump(manifest, f)
  with pytest.raises(ValueError, match='precision'):
    export.load_artifact(str(tmp_path / 'old.pt2'))


def test_export_matches_jax(exported):
  name, ckpt, _ = exported
  model, variables = _flax(name)
  low, full, _ = _inputs()
  s = 64
  _, inter = model.apply(variables, low, low[:, :s, :s],
                         mutable=['intermediates'])
  grid = np.asarray(inter['intermediates']['bilateral_coefficients'][0])
  b, gh, gw, gd, no, ni = grid.shape
  want = np.transpose(grid.reshape(b, gh, gw, gd, no * ni)[0], (3, 2, 0, 1))
  got = export.load_artifact(os.path.join(ckpt, 'coefficients_fn.pt2'))(
      torch.from_numpy(low))
  np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
  jax_enh = JaxEnhancer(config=_jax_cfg(name), variables=variables,
                        interpret=True)
  wants = {
      'serve_fn': jax_enh._forward(jnp.asarray(low), jnp.asarray(full),
                                   clip=True),
      'enhance_fn': jnp.clip(model.apply(variables, low, full), 0.0, 1.0)}
  for fn_name, want in wants.items():
    got = export.load_artifact(os.path.join(ckpt, f'{fn_name}.pt2'))(
        torch.from_numpy(low), torch.from_numpy(full))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


def test_guide_bins_byte_identical_to_jax(exported, tmp_path):
  name, ckpt, _ = exported
  variables = _flax(name)[1]
  jax_export.dump_guide_params(variables['params'],
                               variables.get('batch_stats', {}), name,
                               str(tmp_path))
  want = sorted(p for p in os.listdir(tmp_path) if p.endswith('.bin'))
  got = sorted(p for p in os.listdir(ckpt) if p.endswith('.bin'))
  assert got == want and want
  for fname in want:
    with open(tmp_path / fname, 'rb') as f, open(ckpt / fname, 'rb') as g:
      assert f.read() == g.read(), fname


# --- fit_grid ----------------------------------------------------------------


def _pair(seed=0, hw=FULLRES):
  rng = np.random.RandomState(seed)
  inp = rng.rand(*hw, 3).astype(np.float32)
  tgt = np.clip(1.1 * inp ** 0.7, 0.0, 1.0).astype(np.float32)
  return inp, tgt


@pytest.mark.parametrize('guide', ['luma', 'curves'])
def test_fit_pair_matches_jax(guide):
  inp, tgt = _pair()
  kw = dict(gh=4, gw=4, gd=8, steps=5, guide=guide)
  want_psnr, want = jax_fit.fit_pair(inp, tgt, **kw)
  init = None
  if guide == 'curves':
    init = JaxCurveGuide().init(jax.random.PRNGKey(0),
                                jnp.asarray(inp)[None])['params']
    init = {k: np.asarray(v) for k, v in init.items()}
  psnr, got = fit_grid.fit_pair(inp, tgt, guide_params=init, device='cpu',
                                **kw)
  np.testing.assert_allclose(got['grid'].numpy(), np.asarray(want['grid']),
                             rtol=0, atol=1e-4)
  assert abs(psnr - want_psnr) <= 1e-3
  identity = fit_grid.psnr_of(((inp - tgt) ** 2).mean())
  assert psnr > identity


@pytest.mark.parametrize('guide', ['luma', 'curves'])
def test_fit_problem_gradients_match_jax(guide):
  """The first step's gradients against jax.grad of the JAX fit's loss:
  the grid's within 1e-5 of its max |g| (measured 2.0e-7); the curves
  guide's within 1e-3 (measured 1.8e-4: each is a sum over every pixel
  that cancels to ~1e-4 in magnitude, and autograd of the port's guide
  orders it otherwise than JAX's autodiff of the Flax one)."""
  from hdrnet_tpu.ops import bilateral_slice_apply as jax_slice_apply
  inp, tgt = _pair(1)
  grid0 = np.zeros((1, 4, 4, 8, 3, 4), np.float32)
  for i in range(3):
    grid0[..., i, i] = 1.0
  params = {'grid': jnp.asarray(grid0)}
  luma = jnp.asarray(inp) @ jnp.asarray(fit_grid._LUMA, jnp.float32)
  guide_of = lambda p: luma
  init = None
  if guide == 'curves':
    gmod = JaxCurveGuide()
    params['guide'] = gmod.init(jax.random.PRNGKey(0),
                                jnp.asarray(inp)[None])['params']
    guide_of = lambda p: gmod.apply({'params': p['guide']}, inp[None])[0]
    init = {k: np.asarray(v) for k, v in params['guide'].items()}

  def loss_fn(p):
    out = jax_slice_apply(p['grid'], guide_of(p)[None], inp[None])
    return jnp.mean((out[0] - tgt) ** 2)
  want = jax.grad(loss_fn)(params)
  grid, gmod_t, loss = fit_grid.fit_problem(
      inp, tgt, gh=4, gw=4, gd=8, guide=guide, guide_params=init,
      device='cpu')
  loss().backward()
  got = {'grid': grid.grad}
  if gmod_t is not None:
    got.update((f'guide.{k}', p.grad) for k, p in gmod_t.named_parameters())
  flat = {'grid': want['grid']}
  flat.update((f'guide.{k}', v) for k, v in want.get('guide', {}).items())
  assert sorted(got) == sorted(flat)
  for k, w in flat.items():
    w = np.asarray(w)
    rel = 1e-5 if k == 'grid' else 1e-3
    np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                               atol=rel * float(np.abs(w).max()), err_msg=k)


def test_fit_grid_main_on_files(tmp_path, capsys):
  data = tmp_path / 'data'
  names = ['a.png', 'b.png']
  for i, n in enumerate(names):
    inp, tgt = _pair(seed=i, hw=(24, 40))
    images.imwrite(str(data / 'input' / n), inp)
    images.imwrite(str(data / 'output' / n), tgt)
  (data / 'filelist.txt').write_text('\n'.join(names) + '\n')
  out = tmp_path / 'r.json'
  summary = fit_grid.main([str(data), '--steps', '20', '--spatial_bin', '4',
                           '--luma_bins', '4', '--json', str(out),
                           '--device', 'cpu'])
  assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == \
      summary == json.loads(out.read_text())
  assert summary['n_images'] == 2
  assert summary['mean_oracle_psnr'] > summary['mean_identity_psnr']


# --- viz_activations ---------------------------------------------------------


@pytest.mark.parametrize('name', MODELS)
def test_capture_activations_match_flax(name):
  model, variables = _flax(name)
  low, full, _ = _inputs(3)
  _, captured = model.apply(
      variables, low, full, mutable=['intermediates'],
      capture_intermediates=lambda mdl, _: mdl.name is not None)
  want = {}
  for path, act in jax.tree_util.tree_flatten_with_path(
      captured['intermediates'])[0]:
    if act.ndim == 4:
      key = '_'.join(getattr(k, 'key', str(k)) for k in path)
      want[key.replace('__call__', 'out').strip('_')] = np.asarray(act)
  port = make_model(_port_cfg(name))
  port.load_state_dict(convert_flax_variables(variables))
  got = viz_activations.capture_activations(
      port.eval(), torch.from_numpy(low), torch.from_numpy(full))
  assert sorted(got) == sorted(want)
  for key, act in want.items():
    scale = max(float(np.abs(act).max()), 1e-30)
    np.testing.assert_allclose(got[key], act, rtol=0, atol=1e-4 * scale,
                               err_msg=key)


def test_viz_main_writes_the_mosaics(tmp_path):
  name = 'HDRNetGaussianPyrNN'
  _write_checkpoint(name, tmp_path / 'ckpt')
  im = tmp_path / 'im.png'
  images.imwrite(str(im), np.random.RandomState(4).rand(40, 52, 3))
  acts = viz_activations.main([str(tmp_path / 'ckpt'), str(im),
                               str(tmp_path / 'viz'), '--device', 'cpu'])
  written = sorted(os.listdir(tmp_path / 'viz'))
  assert written == sorted([f'{k}.png' for k in acts] + ['splat_conv1.png'])
  mosaic = viz_activations.tile_channels(acts['multiscale_[1]'][0])
  assert mosaic.shape == (2 * 20, 2 * 26)


# --- upgrade -----------------------------------------------------------------


def _tf_vars(name, bn):
  """A synthetic reference TF checkpoint of the Flax init, through the
  JAX package's name map (the TF shapes of the guide's curves)."""
  cfg = dataclasses.replace(_jax_cfg(name), batch_norm=bn)
  model = jax_make_model(cfg)
  variables = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                         jnp.zeros((1, 16, 16, 3)), train=True)
  tf_vars = {}
  for tf_name, path, transform in jax_upgrade.build_name_map(cfg):
    arr = np.asarray(functools.reduce(lambda n, k: n[k], path, variables))
    if transform is not None:
      if 'shifts' in tf_name:
        arr = arr.reshape(1, 1, *arr.shape)
      elif 'slopes' in tf_name:
        arr = arr.reshape(1, 1, 1, *arr.shape)
      elif 'channel_mixing/weights' in tf_name:
        arr = arr.reshape(1, 1, arr.shape[0], 1)
    tf_vars[tf_name] = arr
  return cfg, tf_vars


@pytest.mark.parametrize('bn', [False, True])
@pytest.mark.parametrize('name', MODELS)
def test_tf_vars_to_torch_matches_jax_route(name, bn):
  cfg, tf_vars = _tf_vars(name, bn)
  want = convert_flax_variables(jax_upgrade.tf_vars_to_flax(tf_vars, cfg))
  got = upgrade.tf_vars_to_torch(tf_vars, ModelConfig(
      **dataclasses.asdict(cfg)))
  assert sorted(got) == sorted(want)
  for key in want:
    assert torch.equal(got[key], want[key]), key
  model = make_model(ModelConfig(**dataclasses.asdict(cfg)))
  assert sorted(model.state_dict()) == sorted(got)


def test_import_tf_checkpoint_serves(tmp_path, monkeypatch):
  cfg, tf_vars = _tf_vars('HDRNetPointwiseNNGuide', False)
  monkeypatch.setattr(upgrade, 'load_tf_checkpoint', lambda path: tf_vars)
  config = Config(model=ModelConfig(**dataclasses.asdict(cfg)))
  upgrade.import_tf_checkpoint('unused', str(tmp_path), config)
  enh = Enhancer.from_checkpoint(str(tmp_path), device='cpu')
  want = convert_flax_variables(jax_upgrade.tf_vars_to_flax(tf_vars, cfg))
  for key, value in enh.model.state_dict().items():
    assert torch.equal(value, want[key]), key
  with pytest.raises(KeyError):
    upgrade.tf_vars_to_torch({}, config.model)
  assert upgrade.tf_vars_to_torch({}, config.model, strict=False) == {}


def test_load_tf_checkpoint_without_tensorflow(monkeypatch):
  monkeypatch.setitem(sys.modules, 'tensorflow', None)
  with pytest.raises(ImportError, match='needs tensorflow'):
    upgrade.load_tf_checkpoint('unused')


# --- compare_baselines, utils ------------------------------------------------


def test_compare_baselines_matches_jax(tmp_path):
  ckpt = tmp_path / 'std'
  ckpt.mkdir()
  (ckpt / 'summaries.jsonl').write_text(
      '\n'.join(json.dumps(r) for r in [{'step': 1, 'loss': 0.1},
                                        {'step': 2, 'eval_psnr': 27.5},
                                        {'step': 3, 'psnr': 28.25}]) + '\n')
  bench = tmp_path / 'bench.json'
  bench.write_text('{"noise": 1}\n' + json.dumps(
      {'detail': {'stage_ms': {'end_to_end_4k': 2.5}}}) + '\n')
  outs = []
  for mod, fig in ((jax_compare, 'jax.png'), (compare_baselines, 'port.png')):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
      mod.main([str(tmp_path / fig), '--run', f'std:{ckpt}:{bench}',
                '--run', f'nobench:{ckpt}', '--point', 'manual:30.0:7.0'])
    outs.append(buf.getvalue().replace('jax.png', 'port.png'))
  assert outs[0] == outs[1]
  assert 'std' in outs[1] and '28.25' in outs[1] and '2.500' in outs[1]


def test_utils_match_jax(tmp_path):
  rng = np.random.RandomState(5)
  im = rng.rand(9, 11, 3).astype(np.float32)
  for fn in ('rgb_to_yuv', 'yuv_to_rgb', 'rgb_to_xyz', 'xyz_to_rgb',
             'rgb_to_gray', 'normalize', 'float_to_uint8', 'clamp',
             'float_to_int16', 'float_to_uint16'):
    np.testing.assert_array_equal(getattr(image, fn)(im),
                                  getattr(jax_image, fn)(im), err_msg=fn)
  u8 = (im * 255).astype(np.uint8)
  u16 = (im * 65535).astype(np.uint16)
  np.testing.assert_array_equal(image.uint8_to_float(u8),
                                jax_image.uint8_to_float(u8))
  np.testing.assert_array_equal(image.uint16_to_float(u16),
                                jax_image.uint16_to_float(u16))
  np.testing.assert_array_equal(image.gray_to_rgb(im[..., 0]),
                                jax_image.gray_to_rgb(im[..., 0]))
  for method in ('nearest', 'bilinear'):
    np.testing.assert_array_equal(image.resize(im, (5, 17), method),
                                  jax_image.resize(im, (5, 17), method))
  metadata.write_dataset_meta(str(tmp_path), 42, {'a.png': 123})
  assert metadata.get_dataset_meta(str(tmp_path)) == \
      jax_metadata.get_dataset_meta(str(tmp_path)) == (
          {'nsamples': 42}, {'a.png': 123})
