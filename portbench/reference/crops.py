"""The training cells' batches, worked out again from the raw pairs.

The draws follow the device data route's contract for a seed (one
shuffled permutation an epoch, then a crop corner a sample and the two
flip draws, which the cells' configuration switches off): the same
``numpy.random.RandomState`` calls in the same order. A batch is the
crop of each drawn sample and its nearest preview, uint8.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.plain import nearest_indices


def draws(seed, n_samples, max_y0, max_x0, batch_size):
  """Yields (indices, y0, x0) of each batch: shuffle, no flips, no
  rotation, random crops."""
  rng = np.random.RandomState(seed)
  order = np.arange(n_samples)
  pending = []
  while True:
    rng.shuffle(order)
    pending.extend(order.tolist())
    while len(pending) >= batch_size:
      idx = pending[:batch_size]
      del pending[:batch_size]
      y0 = rng.randint(0, max_y0 + 1, batch_size)
      x0 = rng.randint(0, max_x0 + 1, batch_size)
      rng.randint(0, 2, batch_size)  # fliplr's draw, off
      rng.randint(0, 2, batch_size)  # flipud's draw, off
      yield idx, y0, x0


def batches(pairs, seed, crop, s, batch_size, n):
  """The first n batches of uint8 (lowres_input, image_input,
  image_output) from the (N, H, W, 3) input and target tensors."""
  ins, outs = pairs
  _, h, w, _ = ins.shape
  dev = ins.device
  iy = torch.as_tensor(nearest_indices(crop, s), device=dev)
  out = []
  stream = draws(seed, len(ins), h - crop, w - crop, batch_size)
  for _ in range(n):
    idx, y0, x0 = next(stream)
    full_in = torch.stack([ins[i, a:a + crop, b:b + crop]
                           for i, a, b in zip(idx, y0, x0)])
    full_out = torch.stack([outs[i, a:a + crop, b:b + crop]
                            for i, a, b in zip(idx, y0, x0)])
    out.append({'lowres_input': full_in[:, iy][:, :, iy],
                'image_input': full_in, 'image_output': full_out})
  return out
