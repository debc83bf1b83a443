"""Loss and quality metrics (counterpart of ``hdrnet_tpu.training.metrics``,
reference: hdrnet/metrics.py:21-33).

With a mesh (``hdrnet_torch.parallel.mesh``) each rank holds a share of
the batch (its rows, and of full-resolution images its H-band), and the
metrics are those of the global batch.
"""

from __future__ import annotations

import math

import torch

from hdrnet_torch.parallel.collectives import all_reduce_sum_


def l2_loss(target, prediction, mesh=None):
  """Mean squared error over all elements. With a mesh, this rank's part
  of the global mean: its squared-error sum over the global count (every
  share holds as many elements), so the parts of the ranks sum to the
  mean and their gradients sum to its gradient."""
  sq = torch.square(target - prediction)
  if mesh is None:
    return torch.mean(sq)
  return torch.sum(sq) / (sq.numel() * mesh.size)


def psnr(target, prediction, mesh=None):
  """Batch-mean PSNR: mean over images of -10*log10(per-image MSE). With
  a mesh (outside autograd), each image's squared-error sum is summed
  over 'spatial' before the log, and the images' PSNRs over 'data'."""
  sq = torch.square(target - prediction).reshape(target.shape[0], -1)
  if mesh is None:
    per_image_mse = sq.mean(dim=1)
  else:
    sums = all_reduce_sum_(sq.sum(dim=1), mesh.spatial_group)
    per_image_mse = sums / (sq.shape[1] * mesh.spatial)
  per_image = (-10.0 / math.log(10.0)) * torch.log(per_image_mse)
  if mesh is None:
    return torch.mean(per_image)
  return all_reduce_sum_(per_image.sum(), mesh.data_group) / (
      per_image.numel() * mesh.data)
