"""Weights, frames and training pairs made from the run's seed.

Everything is drawn on the run's device with one ``torch.Generator`` a
kind of input, in a few large calls, in float32 (the type the
configurations serve and train in). The same seed gives the same inputs
on every run; sizes and counts never depend on the seed.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def sub_seed(seed, tag):
  """A 63-bit seed for one kind of input, from the run's seed (any
  integer) and a tag, so that the kinds draw independently."""
  words = [ord(c) for c in tag]
  ss = np.random.SeedSequence([int(seed) % 2**64, *words])
  return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed, tag, device):
  return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def _mean(rule, name, shape, luma_bins, device):
  """The value around which a leaf is drawn: a number, or a structure
  the configuration names (``init`` in its file)."""
  mean = rule.get('mean', 0.0)
  if not isinstance(mean, str):
    return torch.full(shape, float(mean), device=device)
  if mean == 'eye':
    return torch.eye(shape[0], shape[1], device=device)
  if mean == 'knots':  # knots at k / n over [0, 1), one row a channel
    n = shape[-1]
    return (torch.arange(n, device=device) / n).expand(shape).clone()
  if mean == 'first':  # an identity ramp: the first knot's slope 1
    out = torch.zeros(shape, device=device)
    out[..., 0] = 1.0
    return out
  if mean == 'identity_finest':
    # The prediction conv's bias: channel (j * n_out + i) * gd + k is the
    # grid's affine entry [i, j] at depth k. 1 on the diagonal of the
    # last three outputs (the finest level of a pyramid; all of curves'),
    # so the grid starts near the identity, as trained grids are.
    gd = luma_bins
    n_out = shape[0] // (4 * gd)
    out = torch.zeros(shape, device=device)
    for j in range(3):
      i = n_out - 3 + j
      out[(j * n_out + i) * gd:(j * n_out + i + 1) * gd] = 1.0
    return out
  raise ValueError(f'{name}: unknown init mean {mean!r}')


def make_state_dict(shapes, init, luma_bins, seed, device):
  """{name: float32 tensor} for the leaves `shapes` ({name: shape}), from
  one normal draw. A leaf whose name ends in a key of `init` takes that
  rule ({'mean': number or structure, 'std': s, 'he': scale,
  'positive': bool, which draws mean * exp(std z)}); other weights of two or more dimensions take He's
  normal (std sqrt(2 / fan_in)), other leaves N(0, 0.02)."""
  total = sum(int(np.prod(s)) for s in shapes.values())
  z = torch.randn(total, generator=generator(seed, 'weights', device),
                  device=device)
  out, at = {}, 0
  for name, shape in shapes.items():
    n = int(np.prod(shape))
    zi = z[at:at + n].reshape(shape)
    at += n
    rule = next((r for k, r in init.items() if name.endswith(k)), None)
    if rule is None:
      rule = ({'he': 1.0} if len(shape) >= 2 and name.endswith('weight')
              else {'std': 0.02})
    if 'he' in rule:
      fan_in = int(np.prod(shape[1:]))
      std = rule['he'] * (2.0 / fan_in) ** 0.5
    else:
      std = rule['std']
    mean = _mean(rule, name, shape, luma_bins, device)
    value = (mean * torch.exp(std * zi) if rule.get('positive')
             else mean + std * zi)
    out[name] = value.contiguous()
  return out


def weights(run, net):
  """The run's weights: every leaf of the configuration's model, by the
  names and shapes of `net`'s state dict (the program's model), drawn on
  the run's device from the seed and the configuration's ``init``."""
  shapes = {k: tuple(v.shape) for k, v in net.state_dict().items()}
  return make_state_dict(shapes, run.config['init'], run.model['luma_bins'],
                         run.seed, run.device)


def _photo_like(gen, n, h, w, device):
  """(n, h, w, 3) float32 in [0, 1]: smooth colour gradients (a coarse
  random field upsampled), a finer texture, and pixel noise."""
  x = torch.zeros((n, 3, h, w), device=device)
  for cells, amp in (((4, 6), 1.0), ((24, 40), 0.25)):
    field = torch.rand((n, 3, *cells), generator=gen, device=device)
    x += amp * F.interpolate(field, size=(h, w), mode='bicubic',
                             align_corners=False)
  x = x / 1.25 + 0.02 * torch.randn((n, 3, h, w), generator=gen,
                                    device=device)
  return x.clamp(0.0, 1.0).permute(0, 2, 3, 1)


def _to_u8(x):
  return (x * 255.0 + 0.5).to(torch.uint8).contiguous()


def stream_frames(seed, n, h, w, device):
  """The client's pool: n (1, h, w, 3) uint8 numpy frames, made on the
  device and copied to pageable host memory, as a decoder hands them."""
  gen = generator(seed, 'frames', device)
  frames = _to_u8(_photo_like(gen, n, h, w, device)).cpu().numpy()
  return [frames[i:i + 1] for i in range(n)]


def train_pairs(seed, n, size, device):
  """n (size, size, 3) uint8 input / target pairs on the device, stacked:
  photo-like inputs; each target a fixed tone operator of its input (a
  per-channel gamma, a near-identity colour matrix and a local-contrast
  lift), drawn from the seed."""
  gen = generator(seed, 'pairs', device)
  x = torch.cat([_photo_like(gen, 1, size, size, device) for _ in range(n)])
  gamma = 0.7 + 0.3 * torch.rand(3, generator=gen, device=device)
  ccm = torch.eye(3, device=device) + 0.1 * torch.randn(
      (3, 3), generator=gen, device=device)
  y = torch.pow(x.clamp_min(1e-6), gamma) @ ccm
  blur = F.avg_pool2d(y.permute(0, 3, 1, 2), 31, 1, 15,
                      count_include_pad=False).permute(0, 2, 3, 1)
  y = y + 0.5 * (y - blur)
  return _to_u8(x), _to_u8(y.clamp(0.0, 1.0))
