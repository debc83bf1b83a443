"""One rank of the port's mesh tests (tests/test_torch_mesh_train.py).

Run as ``python tests/torch_mesh_worker.py RANK WORLD PORT WORK_DIR``:
joins a gloo process group on localhost with JAX and ``hdrnet_tpu``
refused at import, then runs the jobs of ``WORK_DIR/jobs.json`` in order,
each on every rank of the group, and writes what each rank ends with to
``WORK_DIR/<job>.rank<RANK>.pt``. A job is one train step of a model
(``step``), ``train()`` over a directory of PNGs (``train``), a
``train()`` that must raise ValueError (``refuse``), or the halo exchange
and the frame-wide row gather on a seeded frame, forward and backward
(``halo``).
"""

import json
import os
import sys

import numpy as np

FORBIDDEN_ROOTS = ('jax', 'jaxlib', 'flax', 'optax', 'hdrnet_tpu')


class _RefuseJax:

  def find_spec(self, name, path=None, target=None):
    if name.split('.')[0] in FORBIDDEN_ROOTS:
      raise ImportError(f'import of {name} refused')
    return None


sys.meta_path.insert(0, _RefuseJax())

import torch  # noqa: E402

from hdrnet_torch.config import Config, ModelConfig, TrainConfig  # noqa: E402
from hdrnet_torch.models import make_model  # noqa: E402
from hdrnet_torch.parallel import halo  # noqa: E402
from hdrnet_torch.parallel import mesh as pm  # noqa: E402
from hdrnet_torch.training import loop, step  # noqa: E402


def run_step(job, work):
  """One train step on the mesh from the job's weights and global batch
  (``<job>.in.pt``, written by the test): what the rank ends with, and
  the gradients the optimizer stepped with (summed over the mesh)."""
  inputs = torch.load(os.path.join(work, job['name'] + '.in.pt'),
                      weights_only=True)
  cfg = ModelConfig(**job['model'])
  tc = TrainConfig(**job['train'])
  mesh = pm.make_mesh(job['mesh_shape'])
  model = make_model(cfg).to(inputs['batch']['image_input'].dtype)
  model.load_state_dict(inputs['state_dict'])
  pm.replicate(model, mesh)
  state = step.create_state(model, loop.make_optimizer(model, tc))
  share, band = pm.shard_batch(mesh, inputs['batch'])
  train_step = step.make_train_step(guide_reg=tc.guide_reg,
                                    guide_reg_target=tc.guide_reg_target,
                                    mesh=mesh)
  state, m = train_step(state, share, band)
  groups = (mesh.data_group, mesh.spatial_group, mesh.group)
  return {'state_dict': model.state_dict(),
          'grads': {k: p.grad for k, p in model.named_parameters()},
          'metrics': {k: float(v) for k, v in m.items()},
          'coords': mesh.coords,
          'band': None if band is None else tuple(band),
          'groups': [torch.distributed.get_process_group_ranks(g)
                     for g in groups]}


def run_train(job, work):
  """``train()`` (to the job's max_steps, resuming its directory's
  checkpoint if there is one)."""
  cfg = Config.from_json(json.dumps(job['config']))
  state = loop.train(cfg, os.path.join(work, job['ckpt']), job['data'],
                     device='cpu')
  return {'state_dict': state.model.state_dict(), 'step': state.step,
          'ema_loss': float(state.ema_loss),
          'optimizer': state.optimizer.state_dict()}


def run_refuse(job, work):
  """``train()`` on a layout it must refuse: the error's type and
  message."""
  try:
    run_train(job, work)
  except ValueError as e:
    return {'error': type(e).__name__, 'message': str(e)}
  return {'error': None, 'message': ''}


def halo_frame(n, seed):
  """The seeded frame (2, n, 3) of a ``halo`` case, float64."""
  return torch.from_numpy(np.random.RandomState(seed).randn(2, n, 3))


def halo_cotangent(shape, rank, seed):
  """Rank `rank`'s seeded cotangent of a ``halo`` case's output."""
  return torch.from_numpy(np.random.RandomState(1000 * seed + rank).randn(
      *shape))


def run_halo(job, work):
  """For each case (n, reach, rows): this rank's band of a frame of n rows
  on the spatial group, exchanged for every band's rows widened by
  `reach` on both sides (clipped to the frame), and `rows` of the frame
  gathered; each output's backward with a seeded cotangent a rank. The
  outputs and the band's gradients."""
  del work
  mesh = pm.make_mesh(job['mesh_shape'])
  out = []
  for seed, (n, reach, rows) in enumerate(job['cases']):
    band = halo.Band(mesh.coords[1], mesh.spatial, n, mesh.spatial_group)
    x = halo_frame(n, seed)[:, band.rows].clone().requires_grad_(True)
    needs = [(lo - reach, hi + reach) for lo, hi in band.bounds()]
    y = halo.exchange(x, band, needs, 1)
    y.backward(halo_cotangent(y.shape, band.index, seed))
    x2 = x.detach().clone().requires_grad_(True)
    g = halo.gather_rows(x2, band, rows, 1)
    g.backward(halo_cotangent(g.shape, band.index, seed + 100))
    out.append({'band': (band.lo, band.hi), 'exchanged': y.detach(),
                'exchange_grad': x.grad, 'gathered': g.detach(),
                'gather_grad': x2.grad})
  return {'cases': out}


RUNS = {'step': run_step, 'train': run_train, 'refuse': run_refuse,
        'halo': run_halo}


def main():
  rank, world, port, work = sys.argv[1:5]
  os.environ.update(RANK=rank, LOCAL_RANK=rank, WORLD_SIZE=world,
                    MASTER_ADDR='localhost', MASTER_PORT=port)
  torch.set_num_threads(1)
  device = pm.initialize_distributed()
  assert device.type == 'cpu', device
  with open(os.path.join(work, 'jobs.json')) as f:
    jobs = json.load(f)
  for job in jobs:
    out = RUNS[job['kind']](job, work)
    torch.save(out, os.path.join(work, f'{job["name"]}.rank{rank}.pt'))
  loaded = sorted(m for m in sys.modules
                  if m.split('.')[0] in FORBIDDEN_ROOTS)
  assert not loaded, loaded
  torch.distributed.destroy_process_group()
  print(f'rank {rank} done')


if __name__ == '__main__':
  main()
