"""``train.image_cotangent_ms_per_step`` by hand on synthetic stretches,
with the kernel names as the profiler records them on the card: it sums
K4's launches that write the image's cotangent
(``pix_bwd_fixed_kernel<true, …>``), none of those that write d_guide
only (``<false, …>``) or of the generic kernel, and reads nothing where
no such launch ran (the pyramid of the frame, the curves model)."""

import pytest

from portbench import trace
from portbench.harness import read_layer_metric

A = trace.Activity
NAME = 'train.image_cotangent_ms_per_step'
SIG = ('(float const*, float const*, float const*, float const*, float*, '
       'float*, int, int, int, int, int, int, int, float, float)')


def _k4(need_input, staged):
  flags = ', '.join('true' if f else 'false' for f in (need_input, staged))
  return f'void (anonymous namespace)::pix_bwd_fixed_kernel<{flags}>{SIG}'


def _summary(device, steps=2):
  return trace.Summary(0.0, 1000.0, steps, device, [], {})


def test_reads_only_the_image_cotangent_launches():
  dev = [A(_k4(False, True), 0, 60, 'kernel'),       # stage 1: d_guide
         A(_k4(True, True), 100, 190, 'kernel'),     # stage 2: both
         A(_k4(False, True), 300, 360, 'kernel'),
         A(_k4(True, False), 400, 500, 'kernel'),    # window from memory
         A('void (anonymous namespace)::pix_bwd_kernel<false, true>'
           '((anonymous namespace)::Channels, ...)', 600, 700, 'kernel'),
         A('void (anonymous namespace)::pix_bwd_kernel<true, true>'
           '((anonymous namespace)::Channels, ...)', 700, 720, 'kernel'),
         A('Memset (Device)', 800, 810, 'memset')]
  # (90 + 100) us over 2 steps.
  assert read_layer_metric(NAME, _summary(dev)) == pytest.approx(0.095)


def test_nothing_to_read_without_such_a_launch():
  dev = [A(_k4(False, True), 0, 60, 'kernel'),
         A(_k4(False, False), 100, 160, 'kernel')]
  assert read_layer_metric(NAME, _summary(dev)) is None
  assert read_layer_metric(NAME, _summary([])) is None
