"""Kernels, copies and sets that ran on the card, a frame of the traced
stretch."""


def read(s):
  return s.launches_per_iteration()
