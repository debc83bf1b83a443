"""Loss and quality metrics (counterpart of ``hdrnet_tpu.training.metrics``,
reference: hdrnet/metrics.py:21-33)."""

from __future__ import annotations

import math

import torch


def l2_loss(target, prediction):
  """Mean squared error over all elements."""
  return torch.mean(torch.square(target - prediction))


def psnr(target, prediction):
  """Batch-mean PSNR: mean over images of -10*log10(per-image MSE)."""
  sq = torch.square(target - prediction).reshape(target.shape[0], -1)
  per_image_mse = sq.mean(dim=1)
  return torch.mean((-10.0 / math.log(10.0)) * torch.log(per_image_mse))
