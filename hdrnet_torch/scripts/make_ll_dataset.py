#!/usr/bin/env python
"""Procedural local-Laplacian dataset, built on the card (counterpart of
``scripts/make_ll_dataset.py``, the quality workload's data).

Photo-like images (a gradient background, soft- and hard-edged ellipse
regions, multi-octave value-noise texture) and their targets: the fast
local Laplacian filter (Paris et al. 2011, Aubry et al. 2014) in
detail-enhancement mode on the luminance, with additive luma transfer
back to RGB.

It holds to the JAX script's jitted path (``make_jax_synth`` and
``make_jax_enhance``), not to its float64 numpy fallback: numpy's
``RandomState(seed)`` draws every random number in the same order, so a
``(seed, size)`` pair names the same dataset in both packages; the
images are assembled and the operator runs in float32 torch on
``--device`` (CUDA by default), with the remap gammas as a batch
dimension. Files are written as ``(x * 255 + 0.5)`` uint8 PNGs in the
``filelist.txt + input/ + output/`` layout under ``OUT/train`` and
``OUT/test`` (the test split's seed is ``seed + 10007``).

  python -m hdrnet_torch.scripts.make_ll_dataset data_ll --n_train 220 \\
      --n_test 24 --size 1024 [--device cuda]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from hdrnet_torch.inference import resolve_device

_K5 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)
_LUMA = (0.299, 0.587, 0.114)
_N_ELL_MAX = 14
_OCTAVES = 5


def _blur1d(x, dim):
  """5-tap Burt-Adelson blur along `dim` with the JAX script's reflect
  boundary (``xp[2:0:-1]`` before, ``xp[-2:-4:-1]`` after), the taps
  summed in order."""
  n = x.shape[dim]
  pad = torch.cat([x.narrow(dim, 2, 1), x.narrow(dim, 1, 1), x,
                   x.narrow(dim, n - 2, 1), x.narrow(dim, n - 3, 1)], dim)
  out = 0
  for i, w in enumerate(_K5):
    out = out + w * pad.narrow(dim, i, n)
  return out


def blur(x):
  """Separable blur of the last two dims (rows, then columns)."""
  return _blur1d(_blur1d(x, -2), -1)


def pyr_down(x):
  return blur(x)[..., ::2, ::2]


def pyr_up(x, shape):
  z = x.new_zeros(shape)
  z[..., ::2, ::2] = x
  return 4.0 * blur(z)


def gaussian_pyramid(x, levels):
  gp = [x]
  for _ in range(levels):
    gp.append(pyr_down(gp[-1]))
  return gp


def laplacian_pyramid(x, levels):
  gp = gaussian_pyramid(x, levels)
  return [gp[l] - pyr_up(gp[l + 1], gp[l].shape) for l in range(levels)]


def _linspace(start, stop, num, device):
  """``jnp.linspace``'s float32 values, start * (1 - s) + stop * s with
  s = i / (num - 1) and exactly `stop` last, computed by numpy on the
  host: CUDA divides a tensor by a scalar as a product with the
  reciprocal, which can round s one ulp away, and a remap gamma one ulp
  off moves the operator's output near it (see ``luminance``)."""
  step = np.arange(num - 1, dtype=np.float32) / np.float32(num - 1)
  head = np.float32(start) * (1 - step) + np.float32(stop) * step
  return torch.from_numpy(np.append(head, np.float32(stop))).to(device)


def _remap(i, g, sigma, alpha, beta):
  """Paris et al.'s pointwise remap: the |d| <= sigma band is detail
  (boosted for alpha < 1), beyond it edge (kept for beta = 1)."""
  d = i - g
  ad = torch.abs(d)
  detail = sigma * (torch.clamp(ad, min=1e-12) / sigma) ** alpha
  edge = beta * (ad - sigma) + sigma
  return g + torch.sign(d) * torch.where(ad <= sigma, detail, edge)


def local_laplacian(y, n_gammas=8, sigma=0.3, alpha=0.5, beta=1.0,
                    levels=5):
  """Fast local Laplacian of a float32 (H, W) luminance: the Laplacian
  pyramids of `n_gammas` remapped copies (one batch), their
  coefficients interpolated per pixel at the Gaussian pyramid's
  intensity."""
  gp = gaussian_pyramid(y, levels)
  gs = _linspace(0.0, 1.0, n_gammas, y.device)[:, None, None]
  lps = laplacian_pyramid(_remap(y[None], gs, sigma, alpha, beta), levels)
  out = gp[levels]
  for l in reversed(range(levels)):
    t = torch.clamp(gp[l], 0.0, 1.0) * (n_gammas - 1)
    k0 = torch.clamp(torch.floor(t).to(torch.int64), 0, n_gammas - 2)
    f = t - k0
    a = torch.gather(lps[l], 0, k0[None])[0]
    b = torch.gather(lps[l], 0, (k0 + 1)[None])[0]
    out = pyr_up(out, gp[l].shape) + a * (1.0 - f) + b * f
  return out


def luminance(rgb):
  """``rgb @ [0.299, 0.587, 0.114]`` (float32 weights) of a float32
  (..., 3) image, rounded once: the products are exact in float64 and
  summed there in a fixed order, so every device gives the same bits.
  The operator needs that: its remap ``(|d| / sigma) ** alpha`` has an
  unbounded slope at d = 0, so a float32 product summed in another order
  (or in TF32 on the card), which moves a luminance near a remap gamma by
  an ulp, moves the target by orders of magnitude more."""
  x = rgb.to(torch.float64)
  w = [float(np.float32(c)) for c in _LUMA]
  return (x[..., 0] * w[0] + x[..., 1] * w[1] + x[..., 2] * w[2]).to(
      torch.float32)


def enhance(rgb, **kw):
  """Detail-enhanced float32 (H, W, 3) RGB: the operator on the
  luminance, additive luma transfer."""
  y = luminance(rgb)
  y2 = local_laplacian(y, **kw)
  return torch.clamp(rgb + (y2 - y)[:, :, None], 0.0, 1.0)


def _octave_cells(size):
  return [min(size, 4 * 2 ** o) for o in range(_OCTAVES)]


def _draw(rng, size):
  """Every random number of one image, in the JAX script's order."""
  ang = rng.rand() * 2 * np.pi
  c0, c1 = rng.rand(3) * 0.6 + 0.2, rng.rand(3) * 0.6 + 0.2
  n_ell = int(rng.randint(6, 14))
  assert n_ell <= _N_ELL_MAX
  ell = np.zeros((n_ell, 9))
  for e in range(n_ell):
    cy, cx = rng.rand(2) * size
    ry, rx = (0.05 + 0.25 * rng.rand(2)) * size
    th = rng.rand() * np.pi
    sharp = 10 ** rng.uniform(0.3, 2.5)
    color = rng.rand(3) * 0.8 + 0.1
    ell[e] = [cy, cx, ry, rx, th, sharp, *color]
  tex_amp = 0.1 + 0.2 * rng.rand()
  cells = _octave_cells(size)
  tex_coarse = [rng.rand(c + 1, c + 1) for c in cells]
  region_coarse = [rng.rand(c + 1, c + 1) for c in cells[:2]]
  chan_amp = 0.5 + 0.5 * rng.rand(3)
  gamma = rng.uniform(0.8, 1.2)
  return dict(ang=ang, c0=c0, c1=c1, ell=ell, tex_amp=tex_amp,
              tex_coarse=tex_coarse, region_coarse=region_coarse,
              chan_amp=chan_amp, gamma=gamma)


def _value_noise(coarse_list, size, persistence=0.55):
  """Multi-octave bilinear value noise in [0, 1] from float32 coarse
  lattices of (cells + 1)^2 values."""
  dev = coarse_list[0].device
  acc = torch.zeros((size, size), device=dev)
  amp, total = 1.0, 0.0
  for coarse in coarse_list:
    cells = coarse.shape[0] - 1
    idx = _linspace(0.0, float(cells), size, dev)
    i0 = torch.clamp(idx.to(torch.int64), max=cells - 1)
    f = idx - i0
    rows0 = coarse.index_select(0, i0)
    top = (rows0.index_select(1, i0) * (1 - f)[None, :] +
           rows0.index_select(1, i0 + 1) * f[None, :])
    rows1 = coarse.index_select(0, i0 + 1)
    bot = (rows1.index_select(1, i0) * (1 - f)[None, :] +
           rows1.index_select(1, i0 + 1) * f[None, :])
    acc = acc + amp * (top * (1 - f)[:, None] + bot * f[:, None])
    total += amp
    amp *= persistence
  return acc / total


def synth_photo(rng, size, device='cuda'):
  """A photo-like float32 (size, size, 3) image in [0, 1] on `device`,
  drawn from `rng` (numpy RandomState) as the JAX script's jitted path
  draws it."""
  p = _draw(rng, size)
  dev = resolve_device(device)

  def f32(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)

  r = torch.arange(size, dtype=torch.float32, device=dev) / size
  yy, xx = r[:, None], r[None, :]
  ang = f32(p['ang'])
  ramp = torch.cos(ang) * xx + torch.sin(ang) * yy
  ramp = (ramp - ramp.min()) / ((ramp.max() - ramp.min()) + 1e-8)
  img = ramp[:, :, None] * f32(p['c0']) + (1 - ramp[:, :, None]) * f32(p['c1'])

  for e in f32(p['ell']):
    cy, cx, ry, rx, th, sharp = e[:6]
    dy, dx = yy * size - cy, xx * size - cx
    u = (torch.cos(th) * dx + torch.sin(th) * dy) / rx
    v = (-torch.sin(th) * dx + torch.cos(th) * dy) / ry
    d = torch.sqrt(u * u + v * v)
    mask = torch.sigmoid(-torch.clamp((d - 1.0) * sharp, -30, 30))
    img = img * (1 - mask[:, :, None]) + mask[:, :, None] * e[6:9]

  tex = _value_noise([f32(c) for c in p['tex_coarse']], size) - 0.5
  region = _value_noise([f32(c) for c in p['region_coarse']], size)
  img = img + (f32(p['tex_amp']) * tex * region)[:, :, None] * f32(
      p['chan_amp'])
  return torch.clamp(img, 0.0, 1.0) ** f32(p['gamma'])


def to_u8(x):
  """float [0, 1] image -> uint8 numpy, ``(x * 255 + 0.5)`` truncated."""
  return (x * 255 + 0.5).to(torch.uint8).cpu().numpy()


def write_split(root, n, size, seed, op_kwargs, device='cuda'):
  from PIL import Image
  os.makedirs(os.path.join(root, 'input'), exist_ok=True)
  os.makedirs(os.path.join(root, 'output'), exist_ok=True)
  rng = np.random.RandomState(seed)
  names = []
  for i in range(n):
    name = f'im{i:04d}.png'
    img = synth_photo(rng, size, device)
    tgt = enhance(img, **op_kwargs)
    Image.fromarray(to_u8(img)).save(os.path.join(root, 'input', name))
    Image.fromarray(to_u8(tgt)).save(os.path.join(root, 'output', name))
    names.append(name)
    if (i + 1) % 20 == 0:
      print(f'{root}: {i + 1}/{n}')
  with open(os.path.join(root, 'filelist.txt'), 'w') as f:
    f.write('\n'.join(names) + '\n')


def main(argv=None):
  p = argparse.ArgumentParser(description=__doc__)
  p.add_argument('out')
  p.add_argument('--n_train', type=int, default=220)
  p.add_argument('--n_test', type=int, default=24)
  p.add_argument('--size', type=int, default=1024)
  p.add_argument('--seed', type=int, default=0)
  p.add_argument('--sigma', type=float, default=0.35)
  p.add_argument('--alpha', type=float, default=0.2)
  p.add_argument('--levels', type=int, default=5)
  p.add_argument('--device', default='cuda',
                 help="torch device ('cpu' to build on the CPU)")
  args = p.parse_args(argv)
  device = resolve_device(args.device)
  op = dict(sigma=args.sigma, alpha=args.alpha, levels=args.levels)
  write_split(os.path.join(args.out, 'train'), args.n_train, args.size,
              args.seed, op, device)
  write_split(os.path.join(args.out, 'test'), args.n_test, args.size,
              args.seed + 10007, op, device)
  print('done')


if __name__ == '__main__':
  main()
