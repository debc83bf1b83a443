"""The collectives of mesh training, on ``torch.distributed``.

Only ``all_reduce`` and ``broadcast``: gloo runs both on CUDA tensors, so
one code path serves NCCL across cards, gloo on the CPU, and several gloo
ranks sharing one card. Every reduction is a sum.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class _AllReduce(torch.autograd.Function):
  """y = sum over the group of x; the cotangent of x is the sum over the
  group of the cotangents of y (every rank's y depends on every rank's x
  with derivative 1)."""

  @staticmethod
  def forward(ctx, x, group):
    ctx.group = group
    y = x.clone()
    dist.all_reduce(y, group=group)
    return y

  @staticmethod
  def backward(ctx, ct):
    ct = ct.clone()
    dist.all_reduce(ct, group=ctx.group)
    return ct, None


def all_reduce(x, group):
  """The sum of `x` over `group`, differentiable (a new tensor)."""
  return _AllReduce.apply(x, group)


def all_reduce_sum_(x, group):
  """Sums `x` over `group` in place, outside autograd; returns it."""
  dist.all_reduce(x, group=group)
  return x


def all_reduce_grads(params, group):
  """Sums the gradients of `params` over `group` in place, as one flat
  all-reduce. Every rank holds the same parameters, so the gradients that
  exist are the same list on every rank."""
  grads = [p.grad for p in params if p.grad is not None]
  if not grads:
    return
  flat = torch.cat([g.reshape(-1) for g in grads])
  dist.all_reduce(flat, group=group)
  offset = 0
  for g in grads:
    n = g.numel()
    g.copy_(flat[offset:offset + n].view_as(g))
    offset += n


def broadcast_(tensors, src, group):
  """Copies rank `src`'s `tensors` (a global rank) into every rank's, in
  place."""
  for t in tensors:
    dist.broadcast(t, src=src, group=group)
